"""Device times of the hand-written CUDA kernels beside their first versions,
on one card.

    python3 tools/bench_torch_kernels.py [--first-csrc DIR] [--ptxas] [--sass DIR]

Builds csrc/patch.cu and csrc/fast_nms.cu and, with `--first-csrc DIR`, the
kernels' first versions from a directory that holds the csrc/ of the commit
before the redesign, e.g. after

    mkdir -p _parent && git archive <commit> lpslam_tpu_torch/csrc | tar -x -C _parent
    python3 tools/bench_torch_kernels.py --first-csrc _parent/lpslam_tpu_torch/csrc

(their FAST entry point takes the fixed ceiling as a float), all with
parallel nvcc. Every build is first held bit-equal to the plain PyTorch
version, then timed as chip_smoke.py times a kernel alone: a CUDA graph of
launches replayed between two events, on one input again (L2-warm) and
rotating over inputs that exceed the L2 (cold), at B = 16 on the three
pyramid levels of 480x640 and at B = 1 on level 0; the FAST kernels on
textured frames and, at level 0, on noise. The builds are timed in turns,
forward then backward, and both readings are printed. `--ptxas` prints the
registers and shared memory of the kernels, `--sass DIR` writes their SASS
into DIR. The last line is one JSON object with every reading and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

FIRST = "first version"
SHIPPED = "shipped"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--first-csrc", type=Path, default=None)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sass", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from lpslam_tpu_torch import _cuda
    from lpslam_tpu_torch.io.synthetic import make_texture
    from lpslam_tpu_torch.kernels import fast_nms, patch

    device = torch.device("cuda")
    card = chip_smoke.card_line()
    print(card)
    if args.ptxas or args.sass is not None:
        import tempfile

        for name in ("patch.cu", "fast_nms.cu"):
            with tempfile.TemporaryDirectory() as tmp:
                cubin = Path(tmp) / f"{name}.cubin"
                out = subprocess.run(
                    [_cuda._nvcc(), *_cuda.NVCC_FLAGS[:4], "-Xptxas", "-v", "-cubin",
                     "-o", str(cubin), str(_cuda.CSRC / name)],
                    capture_output=True, text=True)
                print(f"ptxas {name} (rc {out.returncode}):\n{out.stderr}")
                if args.sass is not None:
                    sass = subprocess.run(
                        [str(Path(_cuda._nvcc()).with_name("cuobjdump")), "-sass", str(cubin)],
                        capture_output=True, text=True)
                    args.sass.mkdir(parents=True, exist_ok=True)
                    (args.sass / f"{name}.sass").write_text(sass.stdout + sass.stderr)

    builds = [SHIPPED]
    sources = [patch.SOURCE, fast_nms.SOURCE]
    first_patch = first_score = None
    if args.first_csrc is not None:
        builds.append(FIRST)
        first = [str(args.first_csrc.resolve() / name) for name in sources]
        sources += first
    _cuda.load_libraries(sources)
    print(f"built {len(sources)} libraries")
    if args.first_csrc is not None:
        first_patch = _cuda.entry(
            first[0], "lpslam_extract_patches",
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        first_score = _cuda.entry(
            first[1], "lpslam_fast_nms_score",
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [ctypes.c_void_p])

    rng = np.random.default_rng(0)
    cases = [(chip_smoke.CHUNK, h, w, n) for h, w, n in chip_smoke.level_cases()]
    cases.append((1,) + chip_smoke.level_cases()[0])
    results = {"card": card, "patch": {}, "fast_nms_score": {}, "fast_lo_max": {}}

    def both_ways(names, measure):
        """measure(name) for each name, forward then backward."""
        out = {k: [] for k in names}
        for k in list(names) + list(names)[::-1]:
            out[k].append(measure(k))
        return out

    # ---- patch extraction
    for b, h, w, n in cases:
        def inputs():
            img = torch.from_numpy((rng.random((b, h, w)) * 255).astype(np.float32)).to(device)
            xy = torch.from_numpy(rng.uniform(-4, [w + 4, h + 4], (b, n, 2)).astype(np.float32))
            return img, xy.to(device), torch.empty((b, n, 1024), device=device)

        img, xy, _ = inputs()
        want = patch.extract_patches_reference(img, xy)
        n_bytes = chip_smoke.patch_bytes(img, xy)

        def launch_patches(k, img, xy, out):
            if k == FIRST:
                _cuda.launch(first_patch, img.device, img.data_ptr(), xy.data_ptr(),
                             out.data_ptr(), *img.shape, xy.shape[1])
            else:
                patch.launch_patches(img, xy, out)

        def measure(k):
            got = torch.empty_like(want)
            launch_patches(k, img, xy, got)
            if not torch.equal(got, want):
                raise AssertionError(f"patch build '{k}' differs at B={b} {h}x{w}")
            return chip_smoke.device_times(lambda x: launch_patches(k, *x), inputs, n_bytes)

        bound = chip_smoke.bound_of(n_bytes)[0]
        key = f"B={b} {h}x{w} N={n}"
        results["patch"][key] = {"bound_ms": bound, "warm_cold_ms": both_ways(builds, measure)}
        for k, v in results["patch"][key]["warm_cold_ms"].items():
            print(f"patch {key} [{k}]: warm {v[0][0]:.4f} / {v[1][0]:.4f} ms, cold "
                  f"{v[0][1]:.4f} / {v[1][1]:.4f} ms, bound {bound:.4f} ms")

    # ---- FAST+NMS score and max pass
    def launch_score(k, img, ceiling, out):
        if k == FIRST:
            _cuda.launch(first_score, img.device, img.data_ptr(), out.data_ptr(), *img.shape,
                         20.0, 7.0, fast_nms.LO_CEILING)
        else:
            fast_nms.launch_score(img, ceiling, out, 20.0, 7.0)

    fast_cases = [(b, h, w, "textured") for b, h, w, _ in cases]
    fast_cases.append((chip_smoke.CHUNK, 480, 640, "noise"))
    for b, h, w, kind in fast_cases:
        if kind == "textured":
            img = torch.from_numpy(np.ascontiguousarray(np.stack(
                [make_texture(h, w, seed=1 + i) for i in range(b)]))).to(device)
        else:
            img = torch.from_numpy((rng.random((b, h, w)) * 255).astype(np.float32)).to(device)
        ops_score, ops_max, counts = chip_smoke.fast_operations(img)
        fixed = torch.full((b,), fast_nms.LO_CEILING, device=device)
        want_fixed = fast_nms.fast_nms_score_reference(img)
        want_frame = fast_nms.fast_nms_score_reference(img, frame_ceiling=True)
        want_max = fast_nms.fast_lo_max_reference(img)
        frame = fast_nms.frame_lo_ceiling(want_max)
        key = f"B={b} {h}x{w} {kind}"

        def measure(k):
            got = torch.empty_like(img)
            launch_score(k, img, fixed, got)
            if not torch.equal(got, want_fixed):
                raise AssertionError(f"FAST build '{k}' differs at {key} (fixed ceiling)")
            if k != FIRST:
                launch_score(k, img, frame, got)
                if not torch.equal(got, want_frame):
                    raise AssertionError(f"FAST build '{k}' differs at {key} (frame ceiling)")
            return chip_smoke.device_times(
                lambda x: launch_score(k, x[0], fixed, x[1]),
                lambda: (img.clone(), torch.empty_like(img)), 8 * img.numel())

        def measure_max(_):
            got = torch.zeros(b, device=device)
            fast_nms.launch_lo_max(img, got, 7.0)
            if not torch.equal(got, want_max):
                raise AssertionError(f"max pass differs at {key}")
            return chip_smoke.device_times(
                lambda x: fast_nms.launch_lo_max(x[0], x[1], 7.0),
                lambda: (img.clone(), torch.zeros(b, device=device)), 4 * img.numel())

        bound, by = chip_smoke.bound_of(8 * img.numel(), ops_score)
        results["fast_nms_score"][key] = {
            "bound_ms": bound, "bound_by": by, "counts": counts,
            "warm_cold_ms": both_ways(builds, measure)}
        for k, v in results["fast_nms_score"][key]["warm_cold_ms"].items():
            print(f"fast_nms_score {key} [{k}]: warm {v[0][0]:.4f} / {v[1][0]:.4f} ms, cold "
                  f"{v[0][1]:.4f} / {v[1][1]:.4f} ms, bound {bound:.4f} ms ({by})")
        bound, by = chip_smoke.bound_of(4 * img.numel(), ops_max)
        results["fast_lo_max"][key] = {
            "bound_ms": bound, "bound_by": by, "warm_cold_ms": both_ways([SHIPPED], measure_max)}
        for k, v in results["fast_lo_max"][key]["warm_cold_ms"].items():
            print(f"fast_lo_max {key} [{k}]: warm {v[0][0]:.4f} / {v[1][0]:.4f} ms, cold "
                  f"{v[0][1]:.4f} / {v[1][1]:.4f} ms, bound {bound:.4f} ms ({by})")

    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
