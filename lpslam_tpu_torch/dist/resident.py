"""A MapStore kept resident across the mesh between operations (port of
lpslam_tpu/dist/resident.py).

- Every keyframe-axis leaf (``KF_LEAVES``) is split into trajectory-
  contiguous blocks: keyframe k lives on rank k // blk, blk = K / n. The
  landmark leaves and the counters are replicated (P x 3 floats against the
  K x N x ~50 B of observations).
- With a process group the leaves are DTensors (``Shard(0)`` or
  ``Replicate()`` on the mesh's DeviceMesh), the counterpart of JAX's
  NamedSharding; the solvers work on their ``to_local()`` blocks with
  explicit collectives. A world of one without a process group keeps plain
  tensors.
- The BoW database rows are sharded like the keyframes, so loop scoring
  reads rank-local rows.

Operations:
  insert_keyframe  the owner rank writes the slot; every rank bumps the
                   replicated observation counts
  local_ba         temporal-window BA with an explicit halo: one all-reduce
                   carries the w window rows, every rank solves the same
                   window problem (``backend.ba``'s local BA), and each
                   writes back only the rows it owns
  loop_scores      scoring on the sharded database
  global_ba        the keyframe-sharded Schur-CG of ``sharded_map`` on the
                   resident blocks, nothing re-laid out
"""
from __future__ import annotations

import torch

from ..backend.ba import _local_ba_impl
from ..geometry.camera import PinholeCamera
from ..mapstore.store import MapConfig, MapStore, empty_map, insert_keyframe_slots, set_row
from .mesh import Mesh
from .sharded_map import _bow_scores_local, _map_problem, _sgba_local

# MapStore leaves whose leading axis is the keyframe axis
KF_LEAVES = frozenset({
    "kf_R", "kf_t", "kf_valid", "kf_frame_id",
    "kf_uv", "kf_desc", "kf_kp_valid", "kf_lm_idx",
})
# the same in MapStore's field order: every rank must issue its collectives
# in one order, and a set's iteration order varies with the process's hash seed
_KF_ORDERED = tuple(f for f in MapStore._fields if f in KF_LEAVES)


def map_shardings(mesh: Mesh, axis: str = "kf") -> MapStore:
    """Per-leaf DTensor placements of a MapStore: the keyframe-axis leaves
    block-sharded along dim 0, everything else replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return MapStore(**{f: ((Shard(0),) if f in KF_LEAVES else (Replicate(),))
                       for f in MapStore._fields})


def _halo_window_ba(m: MapStore, cam: PinholeCamera, w: int, iters: int, mesh: Mesh):
    """Windowed local BA on this rank's resident block ``m`` (its keyframe
    leaves the block, the rest replicated). The only traffic is the halo:
    one all-reduce of the w window keyframes' rows, to which each rank adds
    the rows it owns and zeros elsewhere."""
    blk = m.kf_R.shape[0]
    dev = m.kf_R.device
    lo = mesh.rank * blk
    gids = torch.clamp(m.n_kf - w, min=0) + torch.arange(w, device=dev)
    loc = gids - lo
    mine = (loc >= 0) & (loc < blk)
    locc = torch.clamp(loc, 0, blk - 1)

    # every row is owned by exactly one rank and zero on the others, so one
    # int32 sum returns the owner's bits exactly: floats travel as their bit
    # patterns, and the ints need no shift
    leaves = (m.kf_R, m.kf_t, m.kf_uv, m.kf_kp_valid.to(torch.int32), m.kf_lm_idx)
    rows = [torch.where(mine.reshape((w,) + (1,) * (a.dim() - 1)), a[locc], 0) for a in leaves]
    flat = [(r.view(torch.int32) if r.is_floating_point() else r).reshape(w, -1) for r in rows]
    halo = mesh.all_reduce(torch.cat(flat, 1))
    win = []
    for r, part in zip(rows, torch.split(halo, [f.shape[1] for f in flat], 1)):
        part = part.contiguous()
        win.append((part.view(r.dtype) if r.is_floating_point() else part).reshape(r.shape))
    win_R, win_t, win_uv, win_kpv, win_lm = win

    # every rank solves the same window (its inputs are identical after the
    # halo), through the single-device local BA on a map of the w rows
    window = m._replace(kf_R=win_R, kf_t=win_t, kf_uv=win_uv, kf_kp_valid=win_kpv > 0,
                        kf_lm_idx=win_lm, kf_valid=None, kf_frame_id=None, kf_desc=None,
                        n_kf=torch.clamp(m.n_kf, max=w))
    solved, _ = _local_ba_impl(window, cam, w, iters)

    # write back only the rows this rank owns
    tgt = torch.where(mine & (gids < m.n_kf), locc, blk)
    kf_R = torch.cat([m.kf_R, m.kf_R[:1]])
    kf_t = torch.cat([m.kf_t, m.kf_t[:1]])
    kf_R[tgt] = solved.kf_R
    kf_t[tgt] = solved.kf_t
    return m._replace(kf_R=kf_R[:blk], kf_t=kf_t[:blk], lm_pos=solved.lm_pos)


class ResidentMap:
    """A MapStore resident across a mesh between operations. Every rank
    constructs it and calls its methods in the same order with the same
    arguments; ``m`` (and ``db``) hold the resident leaves."""

    def __init__(self, mesh: Mesh, cfg: MapConfig, vocab_words: int = 0,
                 axis: str = "kf", window: int = 6):
        if cfg.max_keyframes % mesh.size != 0:
            raise ValueError(
                f"max_keyframes ({cfg.max_keyframes}) must be divisible by the mesh "
                f"size ({mesh.size}) for block-contiguous residency")
        self.mesh = mesh
        self.axis = axis
        self.cfg = cfg
        self.window = window
        self._placements = (map_shardings(mesh, axis) if mesh.device_mesh is not None
                            else None)
        self.m = self._adopt(self._block(empty_map(cfg, mesh.device)))
        self.db = None
        if vocab_words:
            blk = cfg.max_keyframes // mesh.size
            self.db = self._wrap(torch.zeros((blk, vocab_words), dtype=torch.float32,
                                             device=mesh.device), sharded=True)

    # -- layout ---------------------------------------------------------------

    def _wrap(self, t, sharded: bool):
        if self.mesh.device_mesh is None:
            return t
        from torch.distributed.tensor import DTensor, Replicate, Shard

        return DTensor.from_local(t, self.mesh.device_mesh,
                                  [Shard(0) if sharded else Replicate()], run_check=False)

    @staticmethod
    def _unwrap(t):
        return t.to_local() if hasattr(t, "to_local") else t

    def _block(self, m: MapStore) -> MapStore:
        """This rank's view of a full MapStore: its block of every keyframe
        leaf, the rest as is."""
        sl = self.mesh.block(self.cfg.max_keyframes)
        return m._replace(**{f: getattr(m, f)[sl].contiguous() for f in _KF_ORDERED})

    def _adopt(self, local: MapStore) -> MapStore:
        return MapStore(**{f: self._wrap(getattr(local, f), f in KF_LEAVES)
                           for f in MapStore._fields})

    def _local(self) -> MapStore:
        return MapStore(*(self._unwrap(x) for x in self.m))

    def full_map(self) -> MapStore:
        """The whole MapStore on every rank (the keyframe blocks gathered)."""
        local = self._local()
        return local._replace(**{f: self.mesh.all_gather(getattr(local, f))
                                 for f in _KF_ORDERED})

    # -- operations -------------------------------------------------------------

    def put(self, m: MapStore, db=None) -> MapStore:
        """Adopt a whole MapStore (the same on every rank, e.g. a map loaded
        from disk or handed over from a single-card session), and with it
        its (K, words) BoW database if given: each rank keeps its block."""
        self.m = self._adopt(self._block(MapStore(*(x.to(self.mesh.device) for x in m))))
        if db is not None:
            sl = self.mesh.block(self.cfg.max_keyframes)
            self.db = self._wrap(db[sl].to(self.mesh.device, torch.float32).contiguous(),
                                 sharded=True)
        return self.m

    def insert_keyframe(self, R, t, uv, desc, kp_valid, lm_idx, frame_id, bow_vec=None):
        """Insert into slot n_kf: the owner rank takes the row (the others
        drop it), every rank bumps the landmarks' observation counts; the BoW
        row lands in the same block of the sharded database."""
        local = self._local()
        blk = local.kf_R.shape[0]
        k = local.n_kf
        lo = self.mesh.rank * blk
        kl = torch.where((k >= lo) & (k < lo + blk), k - lo, blk)   # blk: dropped
        lm_idx = torch.as_tensor(lm_idx, dtype=torch.int32, device=self.mesh.device)
        out = insert_keyframe_slots(local._replace(n_kf=kl), R, t, uv, desc, kp_valid,
                                    lm_idx, frame_id)
        self.m = self._adopt(out._replace(n_kf=k + 1))
        if self.db is not None and bow_vec is not None:
            self.db = self._wrap(set_row(self._unwrap(self.db), kl, bow_vec), sharded=True)
        return self.m

    def local_ba(self, cam: PinholeCamera, iters: int = 8) -> MapStore:
        self.m = self._adopt(_halo_window_ba(self._local(), cam, self.window, iters, self.mesh))
        return self.m

    def loop_scores(self, query):
        """BoW similarity of ``query`` against the sharded database rows,
        (K,) on every rank."""
        return _bow_scores_local(self._unwrap(self.db), query, self.mesh)

    def global_ba(self, cam: PinholeCamera, iters: int = 8, cg_iters: int = 15):
        """The keyframe-sharded Schur-CG over the resident blocks. Returns
        (m, BAResult): the result's camera fields are this rank's block
        (sharded like the map), its points and costs replicated."""
        local = self._local()
        res = _sgba_local(_map_problem(local, self.mesh.rank * local.kf_R.shape[0]), cam,
                          iters, cg_iters, self.mesh)
        self.m = self._adopt(local._replace(kf_R=res.cam_R, kf_t=res.cam_t,
                                            lm_pos=res.points))
        res = res._replace(**{f: self._wrap(getattr(res, f), sharded=True)
                              for f in ("cam_R", "cam_t", "obs_inlier")})
        return self.m, res

    # -- introspection ------------------------------------------------------------

    def residency_ok(self) -> bool:
        """True iff every keyframe leaf (and the database) is block-sharded
        on the mesh, one block per rank, and everything else is replicated
        whole on every rank."""
        if self._placements is None:
            return self.mesh.size == 1
        blk = self.cfg.max_keyframes // self.mesh.size
        leaves = [(getattr(self.m, f), getattr(self._placements, f), f in KF_LEAVES)
                  for f in MapStore._fields]
        if self.db is not None:
            leaves.append((self.db, self._placements.kf_R, True))
        for leaf, placements, sharded in leaves:
            if not hasattr(leaf, "placements") or tuple(leaf.placements) != placements:
                return False
            local = leaf.to_local()
            if sharded:
                if leaf.shape[0] != self.cfg.max_keyframes or local.shape[0] != blk:
                    return False
            elif local.shape != leaf.shape:
                return False
        return True
