"""Port parity, the vocabulary tools: tools/train_vocab_torch.py and
tools/vocab_quality_torch.py against the JAX package's tools/train_vocab.py
and tools/vocab_quality.py, on the CPU at a small size.

- vocab_quality_torch: its main() on 64 room frames at 120x160 (2.2 orbits,
  64 keypoints; the tool's rendering and extraction replaced by these) with
  the shipped vocabulary, beside tools/vocab_quality.py's
  scoring step for step in the JAX package (bow_vector, bow_similarity), both
  fed the same descriptors (the JAX extract_orb's, jit-ed per frame, on
  frames rendered once): the same queries and top-1 retrieval, similarities
  within 1e-6 (word assignment is integer and equal; only the float sums
  differ). The port's own extraction of those frames keeps JAX's keypoints
  and all but < 1% of its bits: the polar descriptor's ties are decided by
  rounding (tests/test_torch_orb.py), so the scores are compared on one set
  of descriptors.
- train_vocab_torch: 1 room x 4 frames and 1 texture sequence at 120x160,
  branching 4, depth 2, on the CPU: the corpus has JAX's keypoint count per
  frame and all but < 1% of its bits, the saved tree loads in both packages
  and assigns the same words; it refuses to write the shipped vocabulary's
  directory.
"""
import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpslam_tpu.kernels.orb import OrbParams as JOrbParams
from lpslam_tpu.kernels.orb import extract_orb as jextract_orb
from lpslam_tpu.loop import vocab as jvocab

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import train_vocab_torch  # noqa: E402
import vocab_quality_torch  # noqa: E402

torch.set_num_threads(1)

QUALITY_ARGS = dict(nf=64, h=120, w=160, turns=2.2)
KEYPOINTS = 64
RADIUS = 0.6


def jax_extract(images, keypoints):
    """tools/vocab_quality.py's extraction: the jit-ed extract_orb per frame."""
    params = JOrbParams(num_keypoints=keypoints, num_levels=3)
    ext = jax.jit(lambda im: jextract_orb(im, params))
    descs, valids = [], []
    for img in images:
        f = ext(jnp.asarray(img, jnp.float32))
        descs.append(np.asarray(f.desc))
        valids.append(np.asarray(f.valid))
    return np.stack(descs), np.stack(valids)


def bits_apart(ours, ref, valid) -> float:
    """Share of descriptor bits that differ over the valid keypoints."""
    a = np.unpackbits(np.ascontiguousarray(ours).view(np.uint8), axis=-1)
    b = np.unpackbits(np.ascontiguousarray(ref).view(np.uint8), axis=-1)
    return float((a[valid] != b[valid]).mean())


def jax_quality(vocab_path, descs, valids, pos, T, radius):
    """tools/vocab_quality.py's per-vocabulary scores, unrounded, on given
    descriptors."""
    nf = len(descs)
    vocab = jvocab.load_vocabulary(vocab_path)
    bow = jax.jit(lambda d, v: jvocab.bow_vector(vocab, d, v))
    vecs = np.stack([np.asarray(bow(d, v)) for d, v in zip(descs, valids)])

    def scores(pairs):
        return np.asarray([float(jvocab.bow_similarity(vecs[a], vecs[b][None])[0])
                           for a, b in pairs])

    s_same = scores([(i, i + T) for i in range(0, nf - T)])
    s_diff = scores([(i, i + T // 2) for i in range(0, nf - T // 2, 7)])
    db = vecs[:T]
    hits, n_q = 0, 0
    for q in range(T, nf, 5):
        cand = int(np.argmax(np.asarray(jvocab.bow_similarity(vecs[q], db))))
        n_q += 1
        hits += float(np.linalg.norm(pos[cand] - pos[q])) <= radius
    return {"words": int(vocab.words.shape[0]),
            "same_place_mean": float(s_same.mean()),
            "same_place_median": float(np.median(s_same)),
            "diff_place_mean": float(s_diff.mean()),
            "diff_place_median": float(np.median(s_diff)),
            "separation": float(s_same.mean() / max(s_diff.mean(), 1e-9)),
            "top1_retrieval_acc": hits / max(n_q, 1), "queries": n_q}


def test_vocab_quality_tool_matches_jax_on_the_same_frames(tmp_path, monkeypatch):
    images, pos, T = vocab_quality_torch.room_frames(
        QUALITY_ARGS["nf"], QUALITY_ARGS["h"], QUALITY_ARGS["w"], QUALITY_ARGS["turns"])
    assert 0 < T < QUALITY_ARGS["nf"] // 2
    descs, valids = jax_extract(images, KEYPOINTS)
    own_desc, own_valid = vocab_quality_torch.extract(images, KEYPOINTS, torch.device("cpu"))
    np.testing.assert_array_equal(own_valid.numpy(), valids)
    assert bits_apart(own_desc.numpy(), descs, valids) < 0.01
    monkeypatch.setattr(vocab_quality_torch, "room_frames", lambda *a: (images, pos, T))
    monkeypatch.setattr(vocab_quality_torch, "extract", lambda *a: (
        torch.from_numpy(descs.view(np.int32)), torch.from_numpy(valids)))
    out_file = tmp_path / "q.json"
    assert vocab_quality_torch.main([
        "--frames", str(QUALITY_ARGS["nf"]), "--keypoints", str(KEYPOINTS),
        "--radius", str(RADIUS), "--device", "cpu", "--out", str(out_file)]) == 0
    ours = json.loads(out_file.read_text())["vocabularies"][0]
    ref = jax_quality(vocab_quality_torch.SHIPPED_VOCAB, descs, valids, pos, T, RADIUS)
    assert ours["vocab"] == vocab_quality_torch.SHIPPED_VOCAB
    for k in ("words", "queries", "top1_retrieval_acc"):
        assert ours[k] == ref[k], k
    for k in ("same_place_mean", "same_place_median", "diff_place_mean",
              "diff_place_median"):
        assert abs(ours[k] - ref[k]) <= 1e-6, (k, ours[k], ref[k])
    assert ours["separation"] == pytest.approx(ref["separation"], rel=1e-5)
    assert ours["same_place_mean"] > ours["diff_place_mean"]


def test_train_vocab_tool_small_on_the_cpu(tmp_path, capsys, monkeypatch):
    args = dict(rooms=1, frames_per=4, tex_seqs=1, keypoints=128, h=120, w=160)
    desc, docs, _ = train_vocab_torch.collect_corpus(
        args["rooms"], args["frames_per"], args["tex_seqs"], args["keypoints"], args["h"],
        args["w"], device="cpu")
    # the same frames through the JAX extractor: its keypoints, all but ties
    # of its bits
    from lpslam_tpu_torch.io.benchmark import SyntheticBenchmark
    from lpslam_tpu_torch.io.synthetic import make_sequence

    frames = [fr.image for fr in SyntheticBenchmark(num_frames=4, h=120, w=160, seed=100,
                                                    turns=1.0)]
    frames += list(make_sequence(num_frames=4, h=120, w=160, seed=500, motion="orbit").images)
    ref, valid = jax_extract(frames, args["keypoints"])
    np.testing.assert_array_equal(np.bincount(docs.numpy()), valid.sum(1))
    ref = np.concatenate([r[v] for r, v in zip(ref, valid)])
    assert bits_apart(desc.numpy(), ref, np.ones(len(ref), bool)) < 0.01

    out = tmp_path / "vocab.npz"
    monkeypatch.setattr(train_vocab_torch, "collect_corpus", functools.partial(
        train_vocab_torch.collect_corpus, keypoints=args["keypoints"], h=args["h"],
        w=args["w"]))
    assert train_vocab_torch.main([
        "--rooms", "1", "--frames-per", "4", "--tex-seqs", "1", "--branching", "4",
        "--depth", "2", "--device", "cpu", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["descriptors"] == len(desc) and line["frames"] == 8
    assert 4 < line["words"] <= 16 and [lv["level"] for lv in line["levels"]] == [0, 1]
    # the tree crosses to the JAX package and assigns the same words there
    from lpslam_tpu_torch.loop.vocab import assign_words, load_vocabulary

    theirs = jvocab.load_vocabulary(str(out))
    ours = load_vocabulary(str(out), "cpu")
    assert theirs.words.shape[0] == line["words"]
    np.testing.assert_array_equal(
        assign_words(ours, desc).numpy(),
        np.asarray(jvocab.assign_words(theirs, jnp.asarray(desc.numpy().view(np.uint32)))))

    shipped = REPO / "lpslam_tpu" / "assets" / "refused.npz"
    assert train_vocab_torch.main(["--out", str(shipped), "--device", "cpu"]) == 2
    assert not shipped.exists()
