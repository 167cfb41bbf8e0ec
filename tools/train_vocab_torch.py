"""Train a hierarchical ORB vocabulary on a synthetic corpus with the PyTorch
port (the port of tools/train_vocab.py; on the card unless --device cpu).

    python3 tools/train_vocab_torch.py [--out orb_vocab.npz] [--rooms 12]
        [--frames-per 24] [--tex-seqs 9] [--branching 32] [--depth 3]
        [--device cuda]

Corpus, as the JAX tool's: R rooms (io.benchmark.SyntheticBenchmark seeds
100 + r, one turn each, distinct plane textures and geometry) x F frames,
plus T procedural-texture sequences (io.synthetic.make_sequence seeds
500 + s, orbit / forward / pan in turn) x F frames, 640x480; ORB
(kernels.orb.extract_orb, 800 keypoints, 3 levels) on every frame, each frame
a document for idf. loop.vocab.train_vocabulary_tree trains the tree and
loop.vocab.save_vocabulary writes it in the JAX package's npz layout, so
either package loads it. Prints the corpus size and each level's open
nodes, leaves and seconds (synchronized with the card), then one JSON line
(words, descriptors, frames, seconds per stage, device). The default --out
is a file in the working directory; the shipped vocabulary under
lpslam_tpu/assets/ is never written.
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

SHIPPED_ASSETS = REPO / "lpslam_tpu" / "assets"
LEVELS = 3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def collect_corpus(rooms: int, frames_per: int, tex_seqs: int, keypoints: int = 800,
                   h: int = 480, w: int = 640, device="cuda", log=None):
    """(N, 8) int32 descriptors of every valid keypoint of the corpus and the
    (N,) frame each came from, on `device`; seconds spent rendering and
    extracting (synchronized)."""
    from lpslam_tpu_torch.io.benchmark import SyntheticBenchmark
    from lpslam_tpu_torch.io.synthetic import make_sequence
    from lpslam_tpu_torch.kernels.orb import OrbParams, extract_orb

    device = torch.device(device)
    params = OrbParams(num_keypoints=keypoints, num_levels=LEVELS)
    descs, docs = [], []
    secs = {"render_s": 0.0, "extract_s": 0.0}

    def add(images):
        _sync(device)
        t0 = time.perf_counter()
        f = extract_orb(torch.from_numpy(np.stack(images)).to(device, torch.float32), params)
        for d, v in zip(f.desc, f.valid):
            descs.append(d[v])
            docs.append(torch.full((int(v.sum()),), len(docs), dtype=torch.int64,
                                   device=device))
        _sync(device)
        secs["extract_s"] += time.perf_counter() - t0

    def rendered(frames):
        t0 = time.perf_counter()
        images = [np.asarray(img, np.float32) for img in frames]
        secs["render_s"] += time.perf_counter() - t0
        return images

    for r in range(rooms):
        ds = SyntheticBenchmark(num_frames=frames_per, h=h, w=w, seed=100 + r, turns=1.0)
        add(rendered(fr.image for fr in ds))
        if log:
            log(f"room {r + 1}/{rooms}: {sum(len(d) for d in descs)} descriptors")
    for s in range(tex_seqs):
        seq = make_sequence(num_frames=frames_per, h=h, w=w, seed=500 + s,
                            motion=("orbit", "forward", "pan")[s % 3])
        add(rendered(seq.images))
        if log:
            log(f"tex seq {s + 1}/{tex_seqs}: {sum(len(d) for d in descs)}")
    return torch.cat(descs), torch.cat(docs), secs


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="orb_vocab.npz")
    ap.add_argument("--rooms", type=int, default=12)
    ap.add_argument("--frames-per", type=int, default=24)
    ap.add_argument("--tex-seqs", type=int, default=9)
    ap.add_argument("--branching", type=int, default=32)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    out_path = Path(args.out if args.out.endswith(".npz") else args.out + ".npz").resolve()
    if SHIPPED_ASSETS.resolve() in out_path.parents:
        print(f"train_vocab_torch: refusing to write {out_path}: the shipped vocabulary "
              "is not retrained here", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("train_vocab_torch: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    import lpslam_tpu_torch  # noqa: F401  (sets full-fp32 matmul precision)
    from lpslam_tpu_torch.loop.vocab import save_vocabulary, train_vocabulary_tree

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    t0 = time.perf_counter()
    desc, docs, secs = collect_corpus(args.rooms, args.frames_per, args.tex_seqs,
                                      device=device, log=log)
    n_frames = int(docs.max()) + 1 if len(docs) else 0
    log(f"corpus: {len(desc)} descriptors from {n_frames} frames "
        f"({time.perf_counter() - t0:.1f} s)")
    levels = []
    _sync(device)
    t1 = time.perf_counter()

    def progress(level, n_nodes, n_leaves):
        _sync(device)
        levels.append({"level": level, "open_nodes": n_nodes, "leaves": n_leaves,
                       "seconds": time.perf_counter() - t1 - sum(x["seconds"] for x in levels)})
        log(f"level {level}: {n_nodes} open nodes, {n_leaves} leaves "
            f"({levels[-1]['seconds']:.2f} s)")

    vocab = train_vocabulary_tree(desc, branching=args.branching, depth=args.depth,
                                  doc_ids=docs.cpu().numpy(), progress=progress)
    _sync(device)
    train_s = time.perf_counter() - t1
    save_vocabulary(vocab, str(out_path))
    out = {"out": str(out_path), "words": int(vocab.words.shape[0]),
           "descriptors": int(len(desc)), "frames": n_frames,
           "branching": args.branching, "depth": args.depth, **secs, "train_s": train_s,
           "levels": levels, "total_s": time.perf_counter() - t0, "device": name}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
