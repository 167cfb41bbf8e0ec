"""Scaling of the keyframe-sharded global BA (port of
lpslam_tpu/eval/scaling.py).

    python -m lpslam_tpu_torch.eval.scaling [--keyframes 256] [--landmarks 16384]
        [--obs 512] [--devices 1,2,4,8] [--device cuda|cpu] [--shared-card]
        [--model] [--json-out SCALING.json]

Builds one global-BA problem (the JAX tool's, from the same numpy draws) and
times ``dist.sharded_map.sharded_global_ba_problem`` in a world of each
size, one world of spawned processes per size (``dist.mesh.run_world``;
best of ``--repeats`` runs, each between two barriers and synchronized).

- On the card (the default) a world is NCCL with one rank per card; a size
  above the card count gets JAX's "only n devices" row, unless
  ``--shared-card`` runs it as gloo processes sharing the cards. Such times
  measure ranks contending for one card, not scaling: solution identity
  with the first world is what they show.
- With ``--device cpu`` the worlds are gloo processes sharing this host's
  cores, so again solution identity, not time, is the signal.

``--model`` measures the compute term in a world of one at C, C/2, C/4 and
C/8 keyframes (the per-rank share of a world of 1, 2, 4, 8) and the latency
of an all-reduce of one float there, and combines them with the analytic
wire volume of ``comm_model`` over a link bandwidth that defaults to the
H100's NVLink 4 datasheet figure (a datasheet number, not a measurement).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# fourth-generation NVLink of the H100 SXM: 900 GB/s per GPU, both directions
# together, so 450 GB/s each way (NVIDIA H100 Tensor Core GPU datasheet)
NVLINK4_GBS = 450.0
NVLINK4_SOURCE = ("datasheet, not a measurement: NVIDIA H100 SXM, fourth-generation "
                  "NVLink, 900 GB/s per GPU in both directions together, 450 GB/s each way")


def build_problem(C: int, Pn: int, N: int, seed: int = 0, device="cuda"):
    """The JAX tool's problem: C cameras on a loop around Pn landmarks, N
    observation slots each, 0.4 px noise, perturbed poses and points, on
    ``device`` (the card unless the caller passes "cpu"; no card raises)."""
    from ..backend.ba import BAProblem
    from ..geometry.se3 import se3_exp
    from ..pipeline.manager import require_device

    device = require_device(device)

    rng = np.random.default_rng(seed)
    pts = np.stack(
        [rng.uniform(-3, 3, Pn), rng.uniform(-2, 2, Pn), rng.uniform(4, 9, Pn)], -1
    ).astype(np.float32)
    xis = np.asarray([[2.0 * np.sin(2 * np.pi * c / C), 0.3 * np.sin(4 * np.pi * c / C),
                       2.0 * (1 - np.cos(2 * np.pi * c / C)), 0.05 * np.sin(2 * np.pi * c / C),
                       2 * np.pi * c / C * 0.1, 0.0] for c in range(C)], np.float32)
    T = se3_exp(torch.from_numpy(xis))
    Rg, tg = T.R.numpy(), T.t.numpy()
    olm = np.full((C, N), -1, np.int32)
    ouv = np.zeros((C, N, 2), np.float32)
    for c in range(C):
        p_c = pts @ Rg[c].T + tg[c]
        uv = np.stack([460 * p_c[:, 0] / p_c[:, 2] + 376, 460 * p_c[:, 1] / p_c[:, 2] + 240], -1)
        vis = np.flatnonzero(p_c[:, 2] > 0.5)
        sel = rng.permutation(vis)[: min(N, len(vis))]
        olm[c, : len(sel)] = sel
        ouv[c, : len(sel)] = uv[sel] + rng.normal(0, 0.4, (len(sel), 2))
    fixed = np.zeros((C,), bool)
    fixed[:2] = True
    arrays = dict(
        cam_R=Rg, cam_t=tg + rng.normal(0, 0.02, tg.shape).astype(np.float32),
        points=pts + rng.normal(0, 0.02, pts.shape).astype(np.float32),
        obs_lm=olm, obs_uv=ouv, obs_sigma2=np.ones((C, N), np.float32), cam_fixed=fixed,
        point_valid=np.ones((Pn,), bool))
    return BAProblem(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})


def comm_model(Pn: int, iters: int, cg_iters: int, n_hosts: int, t_compute_1dev_s: float,
               *, latency_us: float, link_gbs: float = NVLINK4_GBS) -> dict:
    """Analytic communication and time model of the keyframe-sharded global
    BA. Wire volume per LM iteration (dist/sharded_map.py): the all-reduce
    of Hpp (P,3,3) + bp (P,3) + the cost before the CG solve, one (P,3)
    vector and two scalars per CG step, one (P,3) vector for the
    back-substitution; a ring all-reduce moves 2(n-1)/n of the payload per
    rank. Compute shards linearly along the keyframe axis; no overlap of
    compute and communication is assumed."""
    f4 = 4
    bytes_per_lm = (Pn * 9 + Pn * 3) * f4 + cg_iters * Pn * 3 * f4 + Pn * 3 * f4
    colls_per_lm = 3 + 3 * cg_iters + 1
    total_bytes = iters * bytes_per_lm
    wire = total_bytes * 2.0 * (n_hosts - 1) / max(n_hosts, 1)
    t_comm = wire / (link_gbs * 1e9) + iters * colls_per_lm * latency_us * 1e-6
    t_comp = t_compute_1dev_s / n_hosts
    t_total = t_comp + t_comm
    speedup = t_compute_1dev_s / t_total
    return {
        "hosts": n_hosts,
        "wire_MB_per_device": round(wire / 1e6, 3),
        "t_compute_s": round(t_comp, 5),
        "t_comm_s": round(t_comm, 5),
        "t_total_s": round(t_total, 5),
        "speedup": round(speedup, 3),
        "efficiency": round(speedup / n_hosts, 3),
    }


def _camera(device):
    from ..geometry.camera import PinholeCamera

    return PinholeCamera.make(460.0, 460.0, 376.0, 240.0, device)


def _synchronize(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    if mesh.device_mesh is not None:
        torch.distributed.barrier()


def _best_time(mesh, prob, cam, iters, cg_iters, repeats):
    """Best of `repeats` synchronized solves after one warm-up: (s, result)."""
    from ..dist.sharded_map import sharded_global_ba_problem

    best, res = float("inf"), None
    for i in range(repeats + 1):
        _synchronize(mesh)
        t0 = time.perf_counter()
        res = sharded_global_ba_problem(prob, cam, mesh=mesh, iters=iters, cg_iters=cg_iters)
        _synchronize(mesh)
        if i:
            best = min(best, time.perf_counter() - t0)
    return best, res


def _time_world(mesh, C, Pn, N, iters, cg_iters, repeats):
    """One world's row: the best time and the replicated solution."""
    prob = build_problem(C, Pn, N, device=mesh.device)
    best, res = _best_time(mesh, prob, _camera(mesh.device), iters, cg_iters, repeats)
    return dict(time_s=best, initial_cost=float(res.initial_cost),
                final_cost=float(res.final_cost), cam_t=res.cam_t[:C].cpu().numpy())


def _model_world(mesh, C, Pn, N, iters, cg_iters, repeats, n_latency=200):
    """The compute term at C, C/2, C/4, C/8 keyframes in a world of one, and
    the mean latency of an all-reduce of one float32."""
    cam = _camera(mesh.device)
    compute = []
    for frac in (1, 2, 4, 8):
        Cn = max(C // frac, 4)
        best, _ = _best_time(mesh, build_problem(Cn, Pn, N, device=mesh.device), cam, iters,
                             cg_iters, repeats)
        compute.append((Cn, frac, best))
    x = torch.zeros(1, device=mesh.device)
    for _ in range(10):
        mesh.all_reduce(x)
    _synchronize(mesh)
    t0 = time.perf_counter()
    for _ in range(n_latency):
        mesh.all_reduce(x)
    _synchronize(mesh)
    return dict(compute=compute, latency_us=(time.perf_counter() - t0) / n_latency * 1e6,
                n_latency=n_latency)


def _device_kind(device: str) -> str:
    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def _problem(args) -> dict:
    return {"keyframes": args.keyframes, "landmarks": args.landmarks, "obs_per_kf": args.obs,
            "iters": args.iters, "cg_iters": args.cg_iters}


def _emit(out: dict, json_out) -> int:
    line = json.dumps(out)
    print(line)
    if json_out:
        with open(json_out, "w") as f:
            f.write(line + "\n")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--keyframes", type=int, default=256)
    p.add_argument("--landmarks", type=int, default=16384)
    p.add_argument("--obs", type=int, default=512)
    p.add_argument("--devices", default="1,2,4,8")
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--cg-iters", type=int, default=15)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--json-out")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--shared-card", action="store_true",
                   help="run worlds above the card count as gloo processes sharing the cards")
    p.add_argument("--model", action="store_true",
                   help="measure the compute term and the all-reduce latency in a world of "
                        "one and print the analytic multi-card model")
    p.add_argument("--link-gbs", type=float, default=NVLINK4_GBS,
                   help="all-reduce bandwidth per device, GB/s (default: " + NVLINK4_SOURCE + ")")
    p.add_argument("--latency-us", type=float, default=None,
                   help="collective latency, us (default: measured, --model)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("scaling: no CUDA card here; pass --device cpu")
    if args.model:
        return run_model(args)

    from ..dist.mesh import run_world

    cuda = args.device == "cuda"
    n_cards = torch.cuda.device_count() if cuda else 0
    sizes = [int(s) for s in args.devices.split(",")]
    rows, ref = [], None
    for n in sizes:
        shared = cuda and n > n_cards
        if shared and not args.shared_card:
            rows.append({"devices": n, "skipped": f"only {n_cards} devices"})
            continue
        backend = "nccl" if cuda and not shared else "gloo"
        out = run_world(_time_world, n, args.keyframes, args.landmarks, args.obs, args.iters,
                        args.cg_iters, args.repeats, backend=backend, device=args.device)[0]
        if ref is None:
            ref = out
        rows.append({
            "devices": n,
            "backend": backend,
            "shared_card": shared,
            "time_s": out["time_s"],
            "speedup": ref["time_s"] / out["time_s"],
            "efficiency": ref["time_s"] / out["time_s"] / (n / sizes[0]),
            "initial_cost": out["initial_cost"],
            "final_cost": out["final_cost"],
            "max_sol_diff_vs_1dev": float(np.max(np.abs(out["cam_t"] - ref["cam_t"]))),
        })
    if not cuda:
        note = ("gloo worlds of processes sharing this host's cores: timings do not "
                "measure real scaling; solution identity across world sizes is the "
                "correctness signal")
    elif any(r.get("shared_card") for r in rows):
        note = ("worlds above the card count ran as gloo processes sharing the card(s): "
                "their times measure a shared card, not scaling; solution identity is "
                "their signal")
    else:
        note = "real-device timings (NCCL, one rank per card)"
    return _emit({
        "problem": _problem(args),
        "platform": "gpu" if cuda else "cpu",
        "device_kind": _device_kind(args.device),
        "cards": n_cards,
        "virtual_devices": not cuda,
        "note": note,
        "rows": rows,
    }, args.json_out)


def run_model(args) -> int:
    """The measured compute term and all-reduce latency of a world of one,
    and the analytic communication model over them.

    The sharded solver's per-rank work is its keyframe share, so the full
    problem at C, C/2, C/4, C/8 keyframes on one card times the compute
    term a world of 1, 2, 4, 8 runs between collectives; their linearity
    tests t_comp(n) = t_comp(1)/n."""
    from ..dist.mesh import run_world

    cuda = args.device == "cuda"
    meas = run_world(_model_world, 1, args.keyframes, args.landmarks, args.obs, args.iters,
                     args.cg_iters, args.repeats, backend="nccl" if cuda else "gloo",
                     device=args.device)[0]
    t1 = meas["compute"][0][2]
    compute_rows = [{"keyframes_per_device": Cn, "hosts_equivalent": frac, "time_s": t,
                     "linear_prediction_s": t1 / frac, "linearity": (t1 / frac) / t}
                    for Cn, frac, t in meas["compute"]]
    if args.latency_us is not None:
        latency, latency_source = args.latency_us, "given (--latency-us)"
    else:
        latency = meas["latency_us"]
        latency_source = (f"measured: mean of {meas['n_latency']} all-reduces of one float32 "
                          f"in a world of one over {'nccl' if cuda else 'gloo'} on "
                          f"{_device_kind(args.device)}; a cross-card all-reduce costs more")
    model_rows = [comm_model(args.landmarks, args.iters, args.cg_iters, n, t1,
                             latency_us=latency, link_gbs=args.link_gbs) for n in (1, 2, 4, 8)]
    # the combined efficiency with the MEASURED per-rank compute share (which
    # keeps the landmark-side work that does not shard: the Amdahl term)
    measured = {r["hosts_equivalent"]: r["time_s"] for r in compute_rows}
    for row in model_rows:
        n = row["hosts"]
        row["efficiency_measured_compute"] = t1 / (n * (measured[n] + row["t_comm_s"]))
    return _emit({
        "problem": _problem(args),
        "platform": "gpu" if cuda else "cpu",
        "device_kind": _device_kind(args.device),
        "assumptions": {
            "allreduce_bw_GBs_per_device": args.link_gbs,
            "allreduce_bw_source": (NVLINK4_SOURCE if args.link_gbs == NVLINK4_GBS
                                    else "given (--link-gbs)"),
            "collective_latency_us": latency,
            "collective_latency_source": latency_source,
            "note": ("wire volume counted from dist/sharded_map.py's all-reduces: per LM "
                     "iteration Hpp (P,3,3) + bp (P,3) + cost, per CG step one (P,3) + 2 "
                     "scalars, one (P,3) back-substitution; ring all-reduce factor "
                     "2(n-1)/n; no compute/communication overlap"),
        },
        "measured_compute": compute_rows,
        "predicted": model_rows,
    }, args.json_out)


if __name__ == "__main__":
    sys.exit(main())
