"""Port parity, vocabulary training: lpslam_tpu_torch/loop/vocab.py
(`train_vocabulary`, `train_vocabulary_tree`) against lpslam_tpu/loop/vocab.py
on the CPU, the same numpy descriptors through both.

- With the JAX package's initial draws fed in (`_kmajority_draw` /
  `_node_draw` replaced by jax.random's choice / uniform + top_k, since the
  draws themselves cannot be reproduced), the k-majority centres, the words
  and the tree's leaves are bit-equal; idf within 1 ulp of float32 (the log
  of the two libraries).
- With the port's own draws, outcomes only: the flat vocabulary has
  n_words words and uses about as many of them as JAX's (within 25%); the
  tree's leaf count is within 10% of JAX's.
- VSLAMTracker without a vocabulary file trains one lazily at 4 keyframes
  on a 36-frame orbit at the default loop gates: the same word count as
  JAX's, every keyframe in the BoW database, no closure in either package.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lpslam_tpu.loop import vocab as jvocab
from lpslam_tpu_torch.loop import vocab as tvocab

torch.set_num_threads(1)


def _clustered(n_protos=40, per=50, flip=0.03, seed=0):
    """(N, 8) uint32 descriptors around random prototypes, and a frame id
    per descriptor."""
    rng = np.random.default_rng(seed)
    protos = rng.integers(0, 2, (n_protos, 256))
    bits = np.repeat(protos, per, axis=0) ^ (rng.random((n_protos * per, 256)) < flip)
    desc = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little").view(np.uint32)
    return desc.reshape(-1, 8), rng.integers(0, 25, len(desc))


def _jax_flat_draw(n, n_words, seed, device):
    idx = jax.random.choice(jax.random.PRNGKey(seed), n, (n_words,), replace=False)
    return torch.from_numpy(np.asarray(idx, np.int64)).to(device)


def _jax_node_draw(weight, n_words, seed):
    w = jnp.asarray(weight.numpy())
    score = jax.random.uniform(jax.random.PRNGKey(seed), (w.shape[0],)) * (w > 0)
    return torch.from_numpy(np.asarray(jax.lax.top_k(score, n_words)[1], np.int64))


def _words(v):
    return np.asarray(v.words).view(np.uint32) if not isinstance(v.words, torch.Tensor) \
        else v.words.numpy().view(np.uint32)


@pytest.mark.parametrize("n_words,iters,seed", [(64, 6, 3), (128, 8, 0)])
def test_flat_training_with_jax_draw_is_bit_equal(monkeypatch, n_words, iters, seed):
    desc, _ = _clustered()
    ref = jvocab.train_vocabulary(desc, n_words=n_words, iters=iters, seed=seed)
    monkeypatch.setattr(tvocab, "_kmajority_draw", _jax_flat_draw)
    ours = tvocab.train_vocabulary(desc, n_words=n_words, iters=iters, seed=seed, device="cpu")
    np.testing.assert_array_equal(_words(ours), np.asarray(ref.words))
    np.testing.assert_array_equal(ours.words_pm1.numpy(), np.asarray(ref.words_pm1, np.float32))
    ulp = np.spacing(np.abs(np.asarray(ref.idf)))
    assert np.all(np.abs(ours.idf.numpy() - np.asarray(ref.idf)) <= ulp)
    # the port's centres are the unpacked words
    np.testing.assert_array_equal(tvocab._unpack_pm1(ours.words).numpy(),
                                  ours.words_pm1.numpy())


def test_tree_training_with_jax_draw_is_bit_equal(monkeypatch):
    desc, docs = _clustered(n_protos=30, per=40, seed=1)
    kw = dict(branching=4, depth=3, iters=5, seed=2, node_sample=512, doc_ids=docs)
    ref = jvocab.train_vocabulary_tree(desc, **kw)
    monkeypatch.setattr(tvocab, "_node_draw", _jax_node_draw)
    ours = tvocab.train_vocabulary_tree(desc, device="cpu", **kw)
    np.testing.assert_array_equal(_words(ours), np.asarray(ref.words))
    np.testing.assert_array_equal(ours.words_pm1.numpy(), np.asarray(ref.words_pm1, np.float32))
    np.testing.assert_array_equal(ours.idf.numpy(), np.asarray(ref.idf))


def test_own_draws_give_the_same_outcomes():
    desc, docs = _clustered(seed=4)
    ref = jvocab.train_vocabulary(desc, n_words=64, seed=1)
    ours = tvocab.train_vocabulary(desc, n_words=64, seed=1, device="cpu")
    assert ours.words.shape == (64, 8) and ours.words.dtype == torch.int32
    used_ref = len(np.unique(np.asarray(jvocab.assign_words(ref, jnp.asarray(desc)))))
    used = len(np.unique(tvocab.assign_words(
        ours, torch.from_numpy(desc.view(np.int32))).numpy()))
    assert abs(used - used_ref) <= 0.25 * used_ref, (used, used_ref)
    assert np.isfinite(ours.idf.numpy()).all() and (ours.idf.numpy() >= 0).all()

    kw = dict(branching=8, depth=2, iters=6, node_sample=1024, doc_ids=docs)
    tref = jvocab.train_vocabulary_tree(desc, **kw)
    tours = tvocab.train_vocabulary_tree(desc, device="cpu", **kw)
    assert abs(tours.words.shape[0] - tref.words.shape[0]) <= 0.1 * tref.words.shape[0]


def test_pack_bits_matches_jax():
    bits = np.random.default_rng(5).integers(0, 2, (17, 256))
    np.testing.assert_array_equal(
        tvocab._pack_bits(torch.from_numpy(bits)).numpy().view(np.uint32),
        np.asarray(jvocab._pack_bits(jnp.asarray(bits))))


def _lazy_session(pkg, seq, config):
    """A VSLAMTracker with no vocabulary file over the frames; returns the
    trained word count, keyframes in the BoW database and in the map, and
    the closures the loop closer accepted."""
    import chip_smoke

    if pkg == "jax":
        from lpslam_tpu.geometry import PinholeCamera
        from lpslam_tpu.loop.detector import LoopCloser
        from lpslam_tpu.pipeline.queues import CameraQueueEntry as Entry
        from lpslam_tpu.pipeline.trackers import VSLAMTracker as Tracker

        tr = Tracker(PinholeCamera.make(*(seq.K[i, j] for i, j in
                                          ((0, 0), (1, 1), (0, 2), (1, 2)))), dict(config))
    else:
        from lpslam_tpu_torch.geometry import PinholeCamera
        from lpslam_tpu_torch.loop.detector import LoopCloser
        from lpslam_tpu_torch.pipeline import VSLAMTracker as Tracker
        from lpslam_tpu_torch.pipeline.queues import CameraQueueEntry as Entry

        tr = Tracker(PinholeCamera.make(*(seq.K[i, j] for i, j in
                                          ((0, 0), (1, 1), (0, 2), (1, 2))), device="cpu"),
                     dict(config), device="cpu")
    verdicts, undo = chip_smoke.record_closures(LoopCloser)
    try:
        for t, img in enumerate(seq.images):
            tr.process_image(Entry(timestamp=t / 20.0, image=img))
        tr.flush()
    finally:
        undo()
        tr.stop()
    lc = tr.loop_closer
    return {"words": None if lc is None else int(lc.vocab.words.shape[0]),
            "db": None if lc is None else int(lc.n),
            "keyframes": tr.engine.n_keyframes,
            "closures": [v[:2] for v in verdicts if v[4]]}


def test_tracker_trains_lazily_like_jax():
    from lpslam_tpu.io.synthetic import make_sequence

    # a 36-frame orbit at the default loop gates, where neither package
    # accepts a closure (tests/test_torch_loop_slice.py relaxes the gates to
    # close one on its 48 frames)
    seq = make_sequence(num_frames=36, h=120, w=160, seed=1, motion="orbit", fx=115.0)
    config = {"mode": "mono", "keypoints": 256, "levels": 2, "max_keyframes": 16,
              "max_landmarks": 2048, "loop_closure": True, "loop_async": False,
              "chunk_size": 8, "loop_global_ba_iters": 2, "vocab_file": "/nonexistent/v"}
    ref = _lazy_session("jax", seq, config)
    ours = _lazy_session("torch", seq, config)
    assert ref["words"] is not None and ours["words"] == ref["words"], (ours, ref)
    assert ours["db"] == ours["keyframes"] and ref["db"] == ref["keyframes"], (ours, ref)
    assert abs(ours["keyframes"] - ref["keyframes"]) <= 1, (ours, ref)
    assert ours["closures"] == [] and ref["closures"] == [], (ours, ref)
