"""Bag-of-binary-words vocabulary (port of lpslam_tpu/loop/vocab.py).

A flat vocabulary of W binary words resident on the device: word assignment
is one ±1 product against all words (argmax similarity == argmin Hamming),
BoW vectors are dense (W,) tf-idf arrays, a database query is one matvec.

``words_pm1`` is kept as float32 ±1, not int8 as in JAX: the product then
runs as an fp32 matmul, which is exact because every partial sum is an
integer of magnitude <= 256 (TF32 is off, see ``lpslam_tpu_torch/__init__``).
``torch.argmax`` returns the first maximal index, as ``jnp.argmax`` does, so
tied similarities pick the same word. The tf counts are sums of ones, exact
in any order.

Training is k-majority (binary k-means): assignment by the ±1 product,
centres by per-bit majority vote. ``train_vocabulary`` is flat (W words),
``train_vocabulary_tree`` hierarchical (branching**depth leaves, each node a
k-majority on a fixed-size sample). Each k-majority is an initial draw
(``_kmajority_draw`` / ``_node_draw``, from a ``torch.Generator`` seeded with
`seed` on the descriptors' device: the JAX package's ``jax.random`` draws
cannot be reproduced) and a deterministic core that takes the initial
indices. The core is exact: the similarities are integers of magnitude
<= 256 and the vote sums of ±1 are integers, so ``index_add_`` (atomics on
the card, any order) gives the one-hot product's sums bit for bit; a zero
vote becomes +1 and ``argmax`` takes the first maximum, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.match import BITS, _unpack_pm1


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


def _pack_bits(bits):
    """(N, 256) {0,1} -> (N, 8) int32 bit patterns of the uint32 words."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    w = (bits.reshape(-1, 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _kmajority_draw(n: int, n_words: int, seed: int, device):
    """Initial centres of a flat k-majority: n_words distinct rows of n."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return torch.randperm(n, generator=g, device=device)[:n_words]


def _node_draw(weight, n_words: int, seed: int):
    """Initial centres of a node's k-majority: the n_words rows of largest
    uniform score among the real (weight > 0) rows, ties to the lowest
    index."""
    g = torch.Generator(device=weight.device)
    g.manual_seed(int(seed))
    score = torch.rand(weight.shape[0], generator=g, device=weight.device) * (weight > 0)
    return torch.sort(score, descending=True, stable=True).indices[:n_words]


def _assign(desc_pm1, centers):
    return torch.argmax(desc_pm1 @ centers.T, dim=1)


def _kmajority_core(desc_pm1, init_idx, iters: int, weight=None):
    """Binary k-means from the rows `init_idx`: centres stay ±1 vectors,
    each update is the per-bit majority of its (weighted) members; a centre
    with no member keeps its bits."""
    centers = desc_pm1[init_idx]
    W = centers.shape[0]
    rows = desc_pm1 if weight is None else desc_pm1 * weight[:, None]
    w = (torch.ones(desc_pm1.shape[0], device=desc_pm1.device)
         if weight is None else weight)
    for _ in range(iters):
        assign = _assign(desc_pm1, centers)
        sums = torch.zeros_like(centers).index_add_(0, assign, rows)
        counts = torch.zeros(W, device=desc_pm1.device).index_add_(0, assign, w)
        new = torch.where(counts[:, None] > 0, torch.sign(sums), centers)
        centers = torch.where(new == 0, 1.0, new)
    return centers


def _kmajority(desc_pm1, n_words: int, iters: int, seed: int):
    init = _kmajority_draw(desc_pm1.shape[0], n_words, seed, desc_pm1.device)
    return _kmajority_core(desc_pm1, init, iters)


def _as_desc(descriptors, device):
    """(N, 8) descriptors as int32 bit patterns on a device: a tensor stays
    where it is, a numpy uint32/int32 array goes to `device`."""
    if isinstance(descriptors, torch.Tensor):
        return descriptors.to(torch.int32)
    a = np.ascontiguousarray(descriptors).astype(np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def train_vocabulary(descriptors, n_words: int = 1024, iters: int = 8, seed: int = 0,
                     device="cuda") -> Vocabulary:
    """(N, 8) training descriptors -> a flat Vocabulary of n_words words.

    A tensor trains on its own device; a numpy array on `device`. idf counts
    each training descriptor as one document."""
    desc = _as_desc(descriptors, device)
    pm1 = _unpack_pm1(desc)
    centers = _kmajority(pm1, n_words, iters, seed)
    assign = _assign(pm1, centers)
    df = torch.zeros(n_words, device=pm1.device).index_add_(
        0, assign, torch.ones(pm1.shape[0], device=pm1.device))
    n = desc.shape[0]
    idf = torch.log(torch.clamp(n / torch.clamp(df, min=1.0), min=1.0))
    return Vocabulary(words=_pack_bits(centers > 0), words_pm1=centers, idf=idf)


def train_vocabulary_tree(descriptors, branching: int = 32, depth: int = 3,
                          iters: int = 8, seed: int = 0, node_sample: int = 8192,
                          doc_ids=None, progress=None, device="cuda") -> Vocabulary:
    """Hierarchical k-majority to at most branching**depth leaves, flattened
    into one flat vocabulary (assignment stays one product over all words).

    Each node with >= 2 * branching descriptors runs a k-majority on a
    fixed-size sample of `node_sample` rows (drawn by numpy from `seed`, as
    the JAX package draws them), then every one of its descriptors goes to
    its nearest child; smaller nodes become leaves. A leaf's word is the
    per-bit majority of its members (a tie gives 0). doc_ids: (N,) frame of
    each descriptor, so idf counts frames; by default each descriptor is
    its own document. A tensor trains on its own device; a numpy array on
    `device`."""
    desc = _as_desc(descriptors, device)
    dev = desc.device
    n = desc.shape[0]
    rng = np.random.default_rng(seed)
    pm1_dev = _unpack_pm1(desc)
    pm1_all = pm1_dev.to(torch.int8).cpu().numpy()

    def sample_node(idx):
        """Fixed-size (node_sample,) rows of a node, and their weights."""
        take = idx if len(idx) <= node_sample else rng.choice(idx, node_sample, replace=False)
        pad = node_sample - len(take)
        w = np.ones(node_sample, np.float32)
        if pad:
            w[len(take):] = 0.0
            take = np.concatenate([take, np.full(pad, idx[0])])
        return take, w

    nodes = [np.arange(n)]
    leaves = []
    for level in range(depth):
        nxt = []
        for ni, idx in enumerate(nodes):
            if len(idx) < 2 * branching:
                leaves.append(idx)          # too small to split: a leaf
                continue
            take, w = sample_node(idx)
            w = torch.from_numpy(w).to(dev)
            centers = _kmajority_core(pm1_dev[torch.from_numpy(take).to(dev)],
                                      _node_draw(w, branching, seed + level * 131 + ni),
                                      iters, w)
            ass = _assign(pm1_dev[torch.from_numpy(idx).to(dev)], centers).cpu().numpy()
            for c in range(branching):
                child = idx[ass == c]
                if len(child) == 0:
                    continue
                (leaves if level == depth - 1 else nxt).append(child)
        nodes = nxt
        if progress:
            progress(level, len(nodes), len(leaves))
    leaves.extend(nodes)

    W = len(leaves)
    words_bits = np.zeros((W, BITS), np.uint8)
    df = np.zeros((W,), np.float64)
    docs = np.asarray(doc_ids) if doc_ids is not None else np.arange(n)
    n_docs = len(np.unique(docs))
    for wi, idx in enumerate(leaves):
        words_bits[wi] = pm1_all[idx].sum(axis=0) > 0
        df[wi] = len(np.unique(docs[idx]))
    idf = np.log(np.maximum(n_docs / np.maximum(df, 1.0), 1.0)).astype(np.float32)
    words = _pack_bits(torch.from_numpy(words_bits).to(dev))
    return Vocabulary(words=words, words_pm1=_unpack_pm1(words),
                      idf=torch.from_numpy(idf).to(dev))


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
