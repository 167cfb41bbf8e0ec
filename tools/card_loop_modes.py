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

--save-closure DIR: for each mode, the map just before the first accepted
closure is applied, and before the verdicts of the keyframes where JAX's
run closed, saved with chip_smoke.save_closure_states
(`DIR/port_<mode>_k<k_new>_{map,verdict}.npz`), for
`tools/jax_closure_reference.py --apply` to apply on the CPU in both
packages.
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
        saved, undo = [], (lambda: None)
        if args.save_closure:
            os.makedirs(args.save_closure, exist_ok=True)
            saved, undo = smoke.save_closure_states(
                LoopCloser, args.save_closure, f"port_{mode}", gt, save_map,
                lambda x: x.detach().cpu().numpy(),
                at={c[0] for c in smoke.JAX_BRIEF_LOOP_REF[mode]["closures"]})
        try:
            res, tracker, _, _ = smoke.run_loop_room(
                device, raw, gt, K, grid, config=dict(smoke.LOOP_CONFIG, brief_mode=mode),
                ref=smoke.JAX_BRIEF_LOOP_REF[mode])
        finally:
            undo()
        del tracker
        res["saved"] = saved
        res["seconds"] = time.perf_counter() - t0
        ref = res["jax_cpu"] = smoke.JAX_BRIEF_LOOP_REF[mode]
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
