"""Bag-of-binary-words vocabulary, runtime half (port of
lpslam_tpu/loop/vocab.py).

A flat vocabulary of W binary words resident on the device: word assignment
is one ±1 product against all words (argmax similarity == argmin Hamming),
BoW vectors are dense (W,) tf-idf arrays, a database query is one matvec.

``words_pm1`` is kept as float32 ±1, not int8 as in JAX: the product then
runs as an fp32 matmul, which is exact because every partial sum is an
integer of magnitude <= 256 (TF32 is off, see ``lpslam_tpu_torch/__init__``).
``torch.argmax`` returns the first maximal index, as ``jnp.argmax`` does, so
tied similarities pick the same word. The tf counts are sums of ones, exact
in any order.

Vocabulary training (``train_vocabulary``, ``train_vocabulary_tree``) is not
ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.match import _unpack_pm1


class Vocabulary(NamedTuple):
    words: torch.Tensor      # (W, 8) int32 bit patterns of the uint32 words
    words_pm1: torch.Tensor  # (W, 256) float32 in {-1, +1}
    idf: torch.Tensor        # (W,) float32


def vocabulary_from_words(words, idf, device) -> Vocabulary:
    """Build a Vocabulary on `device` from numpy (W, 8) uint32 words and
    (W,) idf weights."""
    w = torch.from_numpy(np.array(words, np.uint32).view(np.int32)).to(device)
    return Vocabulary(
        words=w,
        words_pm1=_unpack_pm1(w),
        idf=torch.from_numpy(np.array(idf, np.float32)).to(device),
    )


def assign_words(vocab: Vocabulary, desc, valid=None):
    """(N, 8) descriptors -> (N,) int32 word ids; -1 where not valid."""
    sim = _unpack_pm1(desc) @ vocab.words_pm1.T
    ids = torch.argmax(sim, dim=1).to(torch.int32)
    if valid is not None:
        ids = torch.where(valid, ids, -1)
    return ids


def bow_vector(vocab: Vocabulary, desc, valid):
    """tf-idf BoW vector (W,) float32, L2-normalized."""
    ids = assign_words(vocab, desc, valid)
    W = vocab.words.shape[0]
    tf = torch.zeros((W,), dtype=torch.float32, device=desc.device)
    tf.index_add_(0, torch.clamp(ids, min=0).to(torch.int64), valid.to(torch.float32))
    v = tf * vocab.idf
    return v / torch.clamp(torch.linalg.norm(v), min=1e-9)


def bow_similarity(query_vec, db_vecs):
    """Cosine similarity of one query against a (K, W) database."""
    return db_vecs @ query_vec


def save_vocabulary(vocab: Vocabulary, path: str) -> None:
    """Write the words and idf in the JAX package's npz layout (uint32
    words), so vocabularies interchange between the packages."""
    np.savez_compressed(
        path if path.endswith(".npz") else path + ".npz",
        words=vocab.words.cpu().numpy().view(np.uint32),
        idf=vocab.idf.cpu().numpy(),
    )


def load_vocabulary(path: str, device) -> Vocabulary:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        return vocabulary_from_words(data["words"], data["idf"], device)
