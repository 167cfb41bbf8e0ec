"""The Hamming kernels of csrc/hamming.cu on one card: the dense matrix
beside an earlier version of it, and the fused projected matcher beside its
plain version.

    python3 tools/bench_hamming.py [--first-csrc DIR] [--ptxas]

Builds csrc/hamming.cu and, with `--first-csrc DIR`, the hamming.cu of an
earlier commit from DIR, e.g. after

    mkdir -p _parent && git archive <commit> lpslam_tpu_torch/csrc | tar -x -C _parent
    python3 tools/bench_hamming.py --first-csrc _parent/lpslam_tpu_torch/csrc

Each build's dense kernel is held bit-equal to the plain SWAR version at
4096 x 1200 (the tracker's matching size), then timed as chip_smoke.py
times a kernel alone (a CUDA graph of launches between two events, L2-warm
and cold), the builds in turns (earlier, shipped, shipped, earlier). The
fused matcher of each build that has one is held bit-equal to
match_projected_reference on chip_smoke.projected_cases and timed at 4096 x
1200 on its "random" case (queries near keypoints) at 25 px, in the same
turns, beside the plain version (the dense kernel and the torch sequence
the fused kernel replaces). `--ptxas` prints
each kernel's registers and shared memory. The last line is one JSON
object with every reading and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--first-csrc", type=Path, default=None)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_hamming: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from lpslam_tpu_torch import _cuda
    from lpslam_tpu_torch.kernels import match

    device = torch.device("cuda")
    card = smoke.card_line()
    print(card)
    sources = {"shipped": "hamming.cu"}
    if args.first_csrc is not None:
        sources["earlier"] = str((args.first_csrc / "hamming.cu").resolve())
    if args.ptxas:
        for name, src in sources.items():
            out = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS[:4], "-Xptxas", "-v", "-cubin",
                                  "-o", "/dev/null", str(_cuda.CSRC / src)],
                                 capture_output=True, text=True)
            print(f"ptxas {name} (rc {out.returncode}):\n{out.stderr}")
    _cuda.load_libraries(list(sources.values()))
    fns = {name: _cuda.entry(src, "lpslam_hamming", match._ARGTYPES)
           for name, src in sources.items()}

    rng = np.random.default_rng(3)

    def desc(n):
        return torch.from_numpy(rng.integers(0, 2**32, (n, 8), dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(device)

    na, nb = smoke.HAMMING_SIZE
    a, b = desc(na), desc(nb)
    want = match.hamming_matrix_reference(a, b)
    out = {"card": card, "dense": {}}

    def launch(fn, x):
        _cuda.launch(fn, device, x[0].data_ptr(), x[1].data_ptr(), x[2].data_ptr(),
                     x[0].shape[0], x[1].shape[0])

    for name, fn in fns.items():
        got = torch.empty_like(want)
        launch(fn, (a, b, got))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} dense kernel differs from the plain version")
    n_bytes = 4 * (na * 8 + nb * 8 + na * nb)
    bound, by = smoke.bound_of(n_bytes, smoke.hamming_operations(na, nb))
    order = ["earlier", "shipped", "shipped", "earlier"] if "earlier" in fns else ["shipped"]
    for name in order:
        warm, cold = smoke.device_times(lambda x, f=fns[name]: launch(f, x),
                                        lambda: (desc(na), desc(nb), torch.empty_like(want)),
                                        n_bytes)
        out["dense"].setdefault(name, []).append({"warm_ms": warm, "cold_ms": cold})
        print(f"dense {name} {na}x{nb}: {warm:.4f} ms L2-warm, {cold:.4f} ms cold, bound "
              f"{bound:.4f} ms ({by}), share {bound / warm:.2f}")
    out["dense_bound_ms"] = bound

    # the fused matcher of every build that has one (the shipped wrapper's
    # launch, on inputs that are already contiguous and aligned)
    fused = {name: _cuda.entry(src, "lpslam_match_projected", match._PROJECTED_ARGTYPES)
             for name, src in sources.items()
             if hasattr(_cuda.load_library(src), "lpslam_match_projected")}

    def launch_fused(fn, x, radius=25.0):
        nq, nk = x[0].shape[0], x[3].shape[0]
        idx = torch.empty(nq, dtype=torch.int64, device=device)
        ok = torch.empty(nq, dtype=torch.bool, device=device)
        _cuda.launch(fn, device, *(t.data_ptr() for t in x), idx.data_ptr(), ok.data_ptr(),
                     nq, nk, float(np.float32(radius * radius)), 80.0)
        return idx, ok

    cases = smoke.projected_cases(device)
    for name, fn in fused.items():
        for cname, cargs in cases.items():
            if cname == "views off alignment":
                continue                  # the wrapper copies these; the launch here does not
            r = 5.0 if cname == "window edge" else 25.0
            got = launch_fused(fn, cargs, r)
            ref = match.match_projected_reference(*cargs, r, 80)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                raise AssertionError(f"{name} fused matcher differs from its plain version "
                                     f"on {cname}")
    pargs = cases["random 4096x1200"]
    clock_hz = smoke.sm_clock_max_mhz() * 1e6
    pbound, pby, tested, inside = smoke.projected_bound(pargs, 25.0, clock_hz)
    set_bytes = sum(x.numel() * x.element_size() for x in pargs)
    out["projected"] = {"bound_ms": pbound, "bound_by": pby, "pairs_tested": tested,
                        "pairs_inside": inside}
    forder = [n for n in order if n in fused]
    for name in forder:
        warm, cold = smoke.device_times(lambda x, f=fused[name]: launch_fused(f, x),
                                        lambda: [x.clone() for x in pargs], set_bytes)
        out["projected"].setdefault(name, []).append({"warm_ms": warm, "cold_ms": cold})
        print(f"fused matcher {name} 4096x1200 at 25 px ({inside} of {tested} pairs inside): "
              f"{warm:.4f} ms L2-warm, {cold:.4f} ms cold, bound {pbound:.7f} ms ({pby})")
    # where the fused kernel's time goes: one block (16 queries), few
    # keypoints to stage (32), and the full problem, each alone on the device
    sweep = {}
    for nq, nk in ((16, 1200), (4096, 32), (512, 1200), (4096, 1200)):
        x = [pargs[0][:nq], pargs[1][:nq], pargs[2][:nq]] + [t[:nk].clone() for t in pargs[3:]]
        sweep[f"{nq}x{nk}"] = smoke.graph_ms([lambda x=x: launch_fused(fused["shipped"], x)] * 20)
    out["projected"]["shipped_sweep_warm_ms"] = sweep
    print("fused matcher alone, L2-warm: " + ", ".join(f"{k} {v:.4f} ms"
                                                       for k, v in sweep.items()))
    out["projected"]["plain_ms"] = smoke.cuda_ms(
        lambda: match.match_projected_reference(*pargs, 25.0, 80))
    out["projected"]["enqueue_us"] = smoke.enqueue_us(
        lambda: match.match_projected(*pargs, 25.0, 80))
    print(f"fused matcher: plain {out['projected']['plain_ms']:.4f} ms, wrapper "
          f"{out['projected']['enqueue_us']:.1f} us")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
