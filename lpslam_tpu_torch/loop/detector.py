"""Loop detection and closure (port of lpslam_tpu/loop/detector.py).

The keyframe BoW database is a device-resident (K, W) matrix (a query is
one matvec); verification is mutual-NN descriptor matching plus a robust
Umeyama Sim3 on 3D-3D landmark pairs; correction is a Sim3 pose graph over
all keyframes followed by landmark re-anchoring, and optionally global BA.

Covisibility counts are B Bᵀ of the (K, M) keyframe-landmark incidence
matrix, an fp32 matmul that is exact because TF32 is off and every count is
below 2**24. Most of the K² pair scores tie at -1, so the covisibility edges
are chosen with ``topk_stable`` (ties to the lowest index, as
``jax.lax.top_k``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.sim3 import Sim3, sim3_apply, sim3_compose, sim3_inverse
from ..kernels.fast import topk_stable
from ..kernels.match import match_mutual_nn
from ..mapstore.store import MapStore
from .pose_graph import PoseGraphProblem, optimize_pose_graph
from .sim3_solve import robust_sim3_from_matches
from .vocab import Vocabulary, bow_similarity, bow_vector


class LoopConfig(NamedTuple):
    """The JAX package's loop-closing gates (see its comments)."""

    min_score: float = 0.18
    min_gap: int = 8
    min_pair_matches: int = 30
    min_sim3_inliers: int = 15
    min_inlier_ratio: float = 0.4
    sim3_sigma: float = 0.1
    consistency: int = 3
    fix_scale: bool = False
    max_scale_drift: float = 0.12
    pose_graph_iters: int = 10
    global_ba_iters: int = 0


class LoopResult(NamedTuple):
    detected: bool
    candidate: int
    n_matches: int
    n_inliers: int


class LoopVerdict(NamedTuple):
    """Outcome of detect + geometric verification (no map mutation), which
    the asynchronous loop worker hands back for deferred application."""

    result: LoopResult
    k_new: int
    S_corr: object  # Sim3 correction (None unless result.detected)


def _index(x, dev):
    return torch.as_tensor(x, device=dev).reshape(1).to(torch.int64)


def correct_loop(m: MapStore, k_new, cand, corr_R, corr_t, corr_s,
                 iters: int = 10, min_shared: int = 30) -> MapStore:
    """Apply an accepted loop closure: Sim3 pose-graph optimization over
    sequential + covisibility + loop edges, then landmark re-anchoring.
    k_new and cand are ints or 0-d tensors; nothing is read back to the
    host."""
    K, N = m.kf_lm_idx.shape
    M = m.lm_pos.shape[0]
    dev = m.lm_pos.device
    nk = m.n_kf
    ids = torch.arange(K, device=dev)
    k_new = _index(k_new, dev)
    cand = _index(cand, dev)
    node_s = torch.ones((K,), dtype=torch.float32, device=dev)

    # edges, all static shapes: (K-1) sequential + (K-1) covisibility + 1 loop
    seq_i = ids[:-1]
    seq_j = ids[:-1] + 1
    seq_w = (ids[:-1] < nk - 1).to(torch.float32)

    valid = m.kf_kp_valid & (m.kf_lm_idx >= 0) & (ids[:, None] < nk)
    rows = ids[:, None].expand(K, N).reshape(-1)
    cols = torch.where(valid, m.kf_lm_idx, M).reshape(-1).to(torch.int64)
    B = torch.zeros((K, M + 1), dtype=torch.float32, device=dev)
    B.index_put_((rows, cols), torch.ones_like(rows, dtype=torch.float32))
    B = B[:, :M]
    shared = (B @ B.T).to(torch.int32)                              # (K, K)
    pair_ok = (
        (ids[None, :] > ids[:, None] + 1)   # skip self + sequential neighbours
        & (ids[None, :] < nk)
        & (shared >= min_shared)
    )
    score = torch.where(pair_ok, shared, -1).reshape(-1)
    top_v, top_idx = topk_stable(score, K - 1)
    has = top_v > 0
    cov_w = has.to(torch.float32)
    cov_i = torch.where(has, top_idx // K, 0)
    cov_j = torch.where(has, top_idx % K, 1)

    ei = torch.cat([seq_i, cov_i, cand])
    ej = torch.cat([seq_j, cov_j, k_new])
    ew = torch.cat([seq_w, cov_w, torch.tensor([2.0], device=dev)])

    # measurements from the current estimates (consistent edges); the loop
    # edge from the verified correction: S_loop = S_cand ∘ S_corr ∘ S_new⁻¹
    Sm = sim3_compose(
        Sim3(m.kf_R[ei[:-1]], m.kf_t[ei[:-1]], node_s[ei[:-1]]),
        sim3_inverse(Sim3(m.kf_R[ej[:-1]], m.kf_t[ej[:-1]], node_s[ej[:-1]])),
    )
    one = node_s[:1]
    S_corr = Sim3(corr_R[None], corr_t[None],
                  torch.as_tensor(corr_s, dtype=torch.float32, device=dev).reshape(1))
    S_loop = sim3_compose(
        Sim3(m.kf_R[cand], m.kf_t[cand], one),
        sim3_compose(S_corr, sim3_inverse(Sim3(m.kf_R[k_new], m.kf_t[k_new], one))),
    )
    fixed = (ids == 0) | (ids >= nk)   # gauge anchor + empty slots
    prob = PoseGraphProblem(
        node_R=m.kf_R, node_t=m.kf_t, node_s=node_s,
        edge_i=ei, edge_j=ej,
        edge_R=torch.cat([Sm.R, S_loop.R]),
        edge_t=torch.cat([Sm.t, S_loop.t]),
        edge_s=torch.cat([Sm.s, S_loop.s]),
        edge_weight=ew,
        node_fixed=fixed,
    )
    R2, t2, s2, _ = optimize_pose_graph(prob, iters=iters)

    # landmark re-anchoring through the world->kf Sim3 of the landmark's
    # first keyframe: p' = S_f_new⁻¹(S_f_old(p))
    f = torch.clamp(m.lm_first_kf, min=0).to(torch.int64)
    p_kf = sim3_apply(Sim3(m.kf_R[f], m.kf_t[f], torch.ones_like(s2[f])), m.lm_pos)
    p_corr = sim3_apply(sim3_inverse(Sim3(R2[f], t2[f], s2[f])), p_kf)
    lm_pos = torch.where(m.lm_valid[:, None], p_corr, m.lm_pos)
    # fold the scale into the SE3 keyframe poses: T = (R, t / s)
    return m._replace(kf_R=R2, kf_t=t2 / torch.clamp(s2[:, None], min=1e-9), lm_pos=lm_pos)


class LoopCloser:
    """Host-side loop closing over a MapStore, one per tracker; its BoW
    database lives on the vocabulary's device."""

    def __init__(self, vocab: Vocabulary, max_keyframes: int, cfg: LoopConfig = LoopConfig()):
        self.vocab = vocab
        self.cfg = cfg
        W = vocab.words.shape[0]
        self.db = torch.zeros((max_keyframes, W), dtype=torch.float32,
                              device=vocab.words.device)
        self.n = 0
        # candidate keyframe per recent verify (-1 = none), for the
        # consistency gate
        self._recent_cands: list = []

    def add_keyframe(self, m: MapStore, k: int):
        v = bow_vector(self.vocab, m.kf_desc[k], m.kf_kp_valid[k])
        self.db[k] = v
        self.n = max(self.n, k + 1)
        return v

    def remap(self, kf_order, n_kf: int):
        """Realign the database after a MapStore compaction: new row i comes
        from old row kf_order[i]; rows from n_kf on are zeroed."""
        order = torch.as_tensor(np.asarray(kf_order), dtype=torch.int64, device=self.db.device)
        db = self.db[order]
        rows = torch.arange(db.shape[0], device=db.device) < n_kf
        self.db = torch.where(rows[:, None], db, 0.0)
        self.n = min(self.n, int(n_kf))

    def detect(self, m: MapStore, k_new: int) -> int:
        """Candidate keyframe index, or -1."""
        scores = bow_similarity(self.db[k_new], self.db).cpu().numpy().copy()
        scores[max(0, k_new - self.cfg.min_gap):] = -1.0
        scores[self.n:] = -1.0
        cand = int(np.argmax(scores))
        if scores[cand] < self.cfg.min_score:
            return -1
        return cand

    def try_close(self, m: MapStore, k_new: int, cam=None) -> tuple:
        """Detect + verify + correct synchronously. Returns (possibly
        updated map, LoopResult). cam is needed only for global BA."""
        return self.apply(m, self.verify(m, k_new), cam=cam)

    def verify(self, m: MapStore, k_new: int) -> LoopVerdict:
        """Detect + consistency gate + geometric verification. Mutates only
        the closer's consistency history, never the map, so it can run on a
        map snapshot in a background worker."""
        cand = self.detect(m, k_new)
        self._recent_cands.append(cand)
        if len(self._recent_cands) > max(self.cfg.consistency, 1):
            self._recent_cands.pop(0)
        if cand < 0:
            return LoopVerdict(LoopResult(False, -1, 0, 0), k_new, None)

        recent = self._recent_cands[-self.cfg.consistency:]
        consistent = len(recent) >= self.cfg.consistency and all(
            c >= 0 and abs(c - cand) <= 4 for c in recent
        )
        if not consistent:
            return LoopVerdict(LoopResult(False, cand, 0, 0), k_new, None)

        idx, ok = match_mutual_nn(
            m.kf_desc[k_new], m.kf_desc[cand],
            m.kf_kp_valid[k_new], m.kf_kp_valid[cand],
            max_distance=60, ratio=0.9,
        )
        lm_new = m.kf_lm_idx[k_new]
        lm_old = m.kf_lm_idx[cand][idx]
        both = ok & (lm_new >= 0) & (lm_old >= 0)
        n_matches = int(torch.sum(both))
        if n_matches < self.cfg.min_pair_matches:
            return LoopVerdict(LoopResult(False, cand, n_matches, 0), k_new, None)

        src = m.lm_pos[torch.clamp(lm_new, min=0).to(torch.int64)]   # drifted
        dst = m.lm_pos[torch.clamp(lm_old, min=0).to(torch.int64)]   # anchored
        S_corr, inlier = robust_sim3_from_matches(src, dst, both, sigma=self.cfg.sim3_sigma)
        n_inl = int(torch.sum(inlier))
        if n_inl < max(self.cfg.min_sim3_inliers, int(self.cfg.min_inlier_ratio * n_matches)):
            return LoopVerdict(LoopResult(False, cand, n_matches, n_inl), k_new, None)

        if self.cfg.fix_scale:
            s = float(S_corr.s)
            if abs(np.log(max(s, 1e-9))) > self.cfg.max_scale_drift:
                # a metric map cannot have drifted in scale: the loop is bogus
                return LoopVerdict(LoopResult(False, cand, n_matches, n_inl), k_new, None)
            # rigid (scale-1) re-fit over the inliers
            wsel = inlier.to(torch.float32)[:, None]
            nw = torch.clamp(torch.sum(wsel), min=1.0)
            mu_s = torch.sum(src * wsel, 0) / nw
            mu_d = torch.sum(dst * wsel, 0) / nw
            S_corr = Sim3(S_corr.R, mu_d - S_corr.R @ mu_s, torch.ones_like(S_corr.s))

        self._recent_cands.clear()  # accepted: restart the consistency run
        return LoopVerdict(LoopResult(True, cand, n_matches, n_inl), k_new, S_corr)

    def apply(self, m: MapStore, verdict: LoopVerdict, cam=None) -> tuple:
        """Apply a verified closure to the (possibly newer) map: the pose
        graph and re-anchoring, then global BA when configured."""
        res = verdict.result
        if not res.detected:
            return m, res
        S = verdict.S_corr
        m = correct_loop(m, verdict.k_new, res.candidate, S.R, S.t, S.s,
                         iters=self.cfg.pose_graph_iters)
        if self.cfg.global_ba_iters > 0 and cam is not None:
            from ..backend.ba import global_ba

            m, _ = global_ba(m, cam, iters=self.cfg.global_ba_iters)
        return m, res
