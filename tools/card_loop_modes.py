"""Loop closing in the descriptor modes on the card: chip_smoke.py phase
16b's drive in binned, gather and exact.

    python3 tools/card_loop_modes.py [--modes binned,gather,exact] [--out FILE]
                                     [--save-closure DIR]

On the card only. Renders phase 7's room once (chip_smoke.render_room, 740
frames) and drives each mode through chip_smoke.run_loop_room with
chip_smoke.LOOP_CONFIG (loop closure with the shipped vocabulary,
synchronous, chunks of 16), the launch counters reset before each drive
and read after it. Each mode is held to its JAX CPU run on the same frames
(chip_smoke.JAX_BRIEF_LOOP_REF, from `tools/jax_brief_reference.py
--loop`) as phase 16b holds binned: >= 90% tracked, the map finite after
every correction, closures within 1 of JAX's and >= 1 where JAX has one
(where JAX closes none, tracked and finite only), no ATE bound; the FAST
kernels on every extraction and the patch kernel in binned only, the dense
Hamming kernel in BoW verify once a closure is accepted. Prints a line per
mode and one JSON object last (--out writes it too); exits 1 when a check
fails. ~6 min on the card. Every verdict that named a candidate is kept
as (k_new, candidate, n_matches, n_inliers, accepted) beside JAX's accepted
closures.

`--modes polar` drives phase 7 itself (held to chip_smoke.JAX_LOOP_REF
with its ATE bound).

--save-closure DIR: for each mode, the map just before the first accepted
closure is applied, and before the verdicts of the keyframes where JAX's
run closed, saved with chip_smoke.save_closure_states
(`DIR/port_<mode>_k<k_new>_{map,verdict,engine}.npz`, the engine file
the tracker's host state), for `tools/jax_closure_reference.py --apply`
and `--track-on` to apply and track on from on the CPU in both packages.
The save wraps LoopCloser.apply outside the timed loop calls
(run_loop_room's hook); its seconds are the third entry of each `saved`
item, and the mode's frames/s includes them.

--track-on N (with --save-closure): from each mode's first accepted
closure, chip_smoke.run_track_on_phase on the card (phase 7c's drives: the
verdict applied afresh, N frames or to the room's end with loop closing
off, twice, the drives equal bit for bit, then under each of
chip_smoke.TRACK_MOVES: kf_t one ulp further from zero, the undistortion
grid one ulp further from and nearer to zero; polar, phase 7's state, is
held to chip_smoke.JAX_TRACK_ON_REF as phase 7c holds it), its per-frame
records written to `DIR/port_<mode>_k<k_new>_track_card.json` for
`--track-on` to hold against the CPU drives. ~40 s a mode.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def main(argv=None) -> int:
    import chip_smoke as smoke

    p = argparse.ArgumentParser()
    p.add_argument("--modes", default=",".join(smoke.BRIEF_MODES))
    p.add_argument("--out", default="")
    p.add_argument("--save-closure", default="")
    p.add_argument("--track-on", type=int, default=-1,
                   help="frames to track on from the first saved closure (0: to the end)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("card_loop_modes: no CUDA device; this tool runs only on the card",
              file=sys.stderr)
        return 2
    import lpslam_tpu_torch  # noqa: F401  (sets full-fp32 matmul precision)
    from lpslam_tpu_torch import _cuda
    from lpslam_tpu_torch.loop.detector import LoopCloser
    from lpslam_tpu_torch.mapstore.checkpoint import save_map

    device = torch.device("cuda")
    card = smoke.card_line()
    print(card, flush=True)
    _cuda.load_libraries(["patch.cu", "fast_nms.cu", "hamming.cu"])
    t0 = time.perf_counter()
    raw, gt, K, grid = smoke.render_room()
    print(f"rendered the {len(raw)}-frame room in {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"card": card, "modes": {}}
    for mode in args.modes.split(","):
        t0 = time.perf_counter()
        # polar is phase 7: its JAX run and ATE bound
        ref = smoke.JAX_LOOP_REF if mode == "polar" else smoke.JAX_BRIEF_LOOP_REF[mode]
        saved = []

        def save_closures(tracker, mode=mode, ref=ref):
            os.makedirs(args.save_closure, exist_ok=True)
            out, undo = smoke.save_closure_states(
                LoopCloser, args.save_closure, f"port_{mode}", gt, save_map,
                lambda x: x.detach().cpu().numpy(), at={c[0] for c in ref["closures"]},
                tracker_of=lambda: tracker, room={"kind": "loop", "frames": len(raw)})
            saved[:] = [out]
            return undo

        res, tracker, _, _ = smoke.run_loop_room(
            device, raw, gt, K, grid, config=dict(smoke.LOOP_CONFIG, brief_mode=mode),
            ref=None if mode == "polar" else ref,
            hook=save_closures if args.save_closure else None)
        del tracker
        saved = saved[0] if saved else []
        res["saved"] = saved
        res["seconds"] = time.perf_counter() - t0
        res["jax_cpu"] = ref
        first = next((base for base, ok, _ in saved if ok), None)
        if args.track_on >= 0 and first is not None:
            t1 = time.perf_counter()
            track, drives = smoke.run_track_on_phase(
                device, first, smoke.room_frames_on(device, raw, grid), gt,
                n=args.track_on or len(raw),
                ref=smoke.JAX_TRACK_ON_REF if mode == "polar" else None,
                moved=smoke.moved_room_frames(device, raw, grid))
            with open(first + "_track_card.json", "w") as f:
                json.dump({"card": card, "result": track, "drives": drives}, f)
            track["seconds_all"] = time.perf_counter() - t1
            res["track_on"] = track
            res["checks_failed"] += [f"track on: {c}" for c in track["checks_failed"]]
            print(f"{mode} track on from {track['closure']} at frame {track['start_frame']}: "
                  f"{track['frames']} frames, two drives equal {track['same']}, {track['tracked']} "
                  f"tracked, keyframes {track['keyframes_inserted']}, error by 100 frames "
                  f"{track['err_by_100_frames']} from {track['bins_from_frame']}, spread per "
                  f"window under {track['moves']} {track['spread_per_window']}, against JAX "
                  f"{track.get('vs_jax')} (the kf_t move alone: {track.get('vs_jax_kf_t_only')}), "
                  f"frames/s {track['fps']}, launches "
                  f"{track['launches'][0]}, {track['seconds_all']:.1f} s", flush=True)
        out["modes"][mode] = res
        print(f"{mode}: {res['frames']} frames, {res['tracked']} tracked (JAX CPU "
              f"{ref['tracked']}), {res['keyframes']} keyframes, closures "
              f"{res['closures']} (JAX CPU {ref['closures']}), verdicts {res['verdicts']}, ATE {res['ate_m_sim3']:.4f} m "
              f"Sim3 (JAX CPU {ref['ate_m_sim3']}), {res['fps']:.2f} frames/s, launches "
              f"{res['launches']}, dense Hamming in BoW verify "
              f"{res['verify_hamming_launches']}, failed {res['checks_failed']}; "
              f"{res['seconds']:.1f} s, on {card}", flush=True)
    out["ok"] = not any(r["checks_failed"] for r in out["modes"].values())
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
