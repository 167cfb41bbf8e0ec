"""Loop-candidate quality of vocabularies with the PyTorch port (the port of
tools/vocab_quality.py; on the card unless --device cpu): same-place
against different-place BoW similarity and top-1 retrieval.

    python3 tools/vocab_quality_torch.py [--vocab FILE ...] [--frames 640]
        [--keypoints 1200] [--radius 0.6] [--out FILE] [--device cuda]

Renders the room benchmark (io.benchmark.SyntheticBenchmark, seed 0, 480x640,
1.15 turns per 600 frames, so the orbit revisits its own path), extracts
ORB with the default extractor (kernels.orb.extract_orb, 3 levels) and, for
each vocabulary (the shipped lpslam_tpu/assets/orb_vocab.npz, read as data,
when none is given), reports as the JAX tool does:

- same-place similarity, mean and median: frame i against i + T, T the
  frames of one orbit (the camera is back where it was);
- different-place similarity: i against i + T/2 (the far side), every 7th i;
- separation = mean(same) / mean(different);
- top-1 retrieval: every 5th frame after the first orbit queries the first
  orbit's frames, correct when the best one lies within --radius m of the
  query's true position.

Numbers are printed unrounded, one JSON line per vocabulary on stderr and
one JSON object last (--out writes it too).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

SHIPPED_VOCAB = str(REPO / "lpslam_tpu" / "assets" / "orb_vocab.npz")


def room_frames(nf: int, h: int = 480, w: int = 640, turns: float = 0.0):
    """The benchmark's float32 frames, true positions and orbit period T
    (`turns` orbits in all; by default the JAX tool's 1.15 per 600 frames)."""
    from lpslam_tpu_torch.io.benchmark import SyntheticBenchmark

    turns = turns or 1.15 * nf / 600.0
    ds = SyntheticBenchmark(num_frames=nf, h=h, w=w, seed=0, turns=turns)
    images = np.stack([fr.image for fr in ds]).astype(np.float32)
    return images, ds.ground_truth().positions, int(round((nf - 1) / turns))


def extract(images, keypoints: int, device, batch: int = 16):
    """ORB on every frame: (F, N, 8) descriptors and (F, N) validity."""
    from lpslam_tpu_torch.kernels.orb import OrbParams, extract_orb

    params = OrbParams(num_keypoints=keypoints, num_levels=3)
    desc, valid = [], []
    for s in range(0, len(images), batch):
        f = extract_orb(torch.from_numpy(images[s:s + batch]).to(device), params)
        desc.append(f.desc)
        valid.append(f.valid)
    return torch.cat(desc), torch.cat(valid)


def quality(vocab, desc, valid, pos, T: int, radius: float) -> dict:
    """The JAX tool's scores for one vocabulary, unrounded."""
    from lpslam_tpu_torch.loop.vocab import bow_similarity, bow_vector

    nf = len(desc)
    vecs = torch.stack([bow_vector(vocab, d, v) for d, v in zip(desc, valid)])

    def scores(pairs):
        return np.asarray([float(bow_similarity(vecs[a], vecs[b][None])[0]) for a, b in pairs])

    s_same = scores([(i, i + T) for i in range(0, nf - T)])
    s_diff = scores([(i, i + T // 2) for i in range(0, nf - T // 2, 7)])
    db = vecs[:T]
    hits, n_q = 0, 0
    for q in range(T, nf, 5):
        cand = int(torch.argmax(bow_similarity(vecs[q], db)))
        n_q += 1
        hits += float(np.linalg.norm(pos[cand] - pos[q])) <= radius
    return {"words": int(vocab.words.shape[0]),
            "same_place_mean": float(s_same.mean()),
            "same_place_median": float(np.median(s_same)),
            "diff_place_mean": float(s_diff.mean()),
            "diff_place_median": float(np.median(s_diff)),
            "separation": float(s_same.mean() / max(s_diff.mean(), 1e-9)),
            "top1_retrieval_acc": hits / max(n_q, 1), "queries": n_q}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", action="append", default=[],
                    help="vocabulary file (repeatable)")
    ap.add_argument("--frames", type=int, default=640)
    ap.add_argument("--keypoints", type=int, default=1200)
    ap.add_argument("--radius", type=float, default=0.6,
                    help="true-position radius for a correct retrieval (m)")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("vocab_quality_torch: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    import lpslam_tpu_torch  # noqa: F401  (sets full-fp32 matmul precision)
    from lpslam_tpu_torch.loop.vocab import load_vocabulary

    vocabs = args.vocab or [SHIPPED_VOCAB]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    images, pos, T = room_frames(args.frames)
    render_s = time.perf_counter() - t0
    desc, valid = extract(images, args.keypoints, device)
    results = []
    for vp in vocabs:
        results.append({"vocab": vp, **quality(load_vocabulary(vp, device), desc, valid, pos,
                                               T, args.radius)})
        print(json.dumps(results[-1]), file=sys.stderr, flush=True)
    out = {"benchmark": f"room orbit, {args.frames} frames, period {T} frames; "
                        "same-place = i vs i+T, diff-place = i vs i+T/2",
           "descriptor": "current default extractor (polar-DFT BRIEF)",
           "platform": name, "radius_m": args.radius, "render_s": render_s,
           "seconds": time.perf_counter() - t0, "vocabularies": results}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
