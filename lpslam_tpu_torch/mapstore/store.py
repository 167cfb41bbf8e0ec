"""Fixed-capacity keyframe / landmark store (port of
lpslam_tpu/mapstore/store.py).

Structure-of-arrays tensors on one device; updates are functional (the
functions return a new MapStore and never write into their argument), so a
map that is still referenced — the async-mapping double buffer keeps one —
stays valid. JAX's ``.at[...].set(mode="drop")`` becomes a masked write at a
clamped index or a scratch row one past capacity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class MapConfig(NamedTuple):
    max_keyframes: int = 64
    max_landmarks: int = 8192
    num_keypoints: int = 512


class MapStore(NamedTuple):
    # landmarks
    lm_pos: torch.Tensor        # (M, 3) float32
    lm_desc: torch.Tensor       # (M, 8) int32 bit patterns
    lm_valid: torch.Tensor      # (M,) bool
    lm_n_obs: torch.Tensor      # (M,) int32
    lm_first_kf: torch.Tensor   # (M,) int32
    lm_n_visible: torch.Tensor  # (M,) int32
    lm_n_found: torch.Tensor    # (M,) int32
    # keyframes (Tcw)
    kf_R: torch.Tensor          # (K, 3, 3)
    kf_t: torch.Tensor          # (K, 3)
    kf_valid: torch.Tensor      # (K,) bool
    kf_frame_id: torch.Tensor   # (K,) int32
    kf_uv: torch.Tensor         # (K, N, 2) float32
    kf_desc: torch.Tensor       # (K, N, 8) int32
    kf_kp_valid: torch.Tensor   # (K, N) bool
    kf_lm_idx: torch.Tensor     # (K, N) int32, -1 = none
    # counters (0-d int32 tensors)
    n_kf: torch.Tensor
    n_lm: torch.Tensor


def empty_map(cfg: MapConfig, device) -> MapStore:
    M, K, N = cfg.max_landmarks, cfg.max_keyframes, cfg.num_keypoints
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return MapStore(
        lm_pos=torch.zeros((M, 3), **f32),
        lm_desc=torch.zeros((M, 8), **i32),
        lm_valid=torch.zeros((M,), dtype=torch.bool, device=device),
        lm_n_obs=torch.zeros((M,), **i32),
        lm_first_kf=torch.full((M,), -1, **i32),
        lm_n_visible=torch.zeros((M,), **i32),
        lm_n_found=torch.zeros((M,), **i32),
        kf_R=torch.eye(3, **f32).expand(K, 3, 3).clone(),
        kf_t=torch.zeros((K, 3), **f32),
        kf_valid=torch.zeros((K,), dtype=torch.bool, device=device),
        kf_frame_id=torch.full((K,), -1, **i32),
        kf_uv=torch.zeros((K, N, 2), **f32),
        kf_desc=torch.zeros((K, N, 8), **i32),
        kf_kp_valid=torch.zeros((K, N), dtype=torch.bool, device=device),
        kf_lm_idx=torch.full((K, N), -1, **i32),
        n_kf=torch.zeros((), **i32),
        n_lm=torch.zeros((), **i32),
    )


def set_row(arr, k, value):
    """Functional ``arr.at[k].set(value)`` for a 0-d index tensor k; an index
    past the end is dropped (JAX's out-of-bounds scatter rule)."""
    cap = arr.shape[0]
    kk = torch.clamp(k, max=cap - 1).reshape(1).to(torch.int64)
    value = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
    new = torch.where(k < cap, value, arr.index_select(0, kk)[0])
    out = arr.clone()
    out.index_copy_(0, kk, new.expand(arr.shape[1:])[None])
    return out


def scatter_drop(arr, idx, values):
    """Functional ``arr.at[idx].set(values, mode="drop")`` along dim 0: rows
    whose index is outside [0, len) are dropped (through a scratch row)."""
    cap = arr.shape[0]
    idx = idx.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < cap), idx, cap)
    buf = torch.cat([arr, arr[:1]], 0)
    values = torch.as_tensor(values, dtype=arr.dtype, device=arr.device)
    buf[idx] = values.expand(idx.shape + arr.shape[1:])
    return buf[:cap]


def insert_keyframe_slots(m: MapStore, R, t, uv, desc, kp_valid, lm_idx,
                          frame_id) -> MapStore:
    """Write a keyframe into slot n_kf and bump n_obs of its landmarks."""
    k = m.n_kf
    obs_bump = torch.zeros_like(m.lm_n_obs)
    obs_bump.index_add_(
        0, torch.clamp(lm_idx, min=0).to(torch.int64), (lm_idx >= 0).to(torch.int32)
    )
    return m._replace(
        kf_R=set_row(m.kf_R, k, R),
        kf_t=set_row(m.kf_t, k, t),
        kf_valid=set_row(m.kf_valid, k, True),
        kf_frame_id=set_row(m.kf_frame_id, k, frame_id),
        kf_uv=set_row(m.kf_uv, k, uv),
        kf_desc=set_row(m.kf_desc, k, desc),
        kf_kp_valid=set_row(m.kf_kp_valid, k, kp_valid),
        kf_lm_idx=set_row(m.kf_lm_idx, k, lm_idx),
        lm_n_obs=m.lm_n_obs + obs_bump,
        n_kf=m.n_kf + 1,
    )


class CompactResult(NamedTuple):
    map: MapStore
    kf_order: torch.Tensor     # (K,) new slot -> old slot
    lm_order: torch.Tensor     # (M,) new slot -> old slot
    n_kf_culled: torch.Tensor  # () int32


def _stable_partition(valid):
    """new -> old permutation putting valid entries first, order kept."""
    return torch.argsort((~valid).to(torch.int8), stable=True)


def cull_and_compact(m: MapStore, keep_latest: int = 3, redundancy: float = 0.9,
                     min_other_obs: int = 3, force_min_one: bool = False,
                     max_cull: int = 1, force_free: int = 0) -> CompactResult:
    """Cull redundant keyframes (one per pass, up to max_cull passes), drop
    orphaned landmarks, and compact the store; see the JAX docstring for the
    redundancy rule and the capacity escape hatches."""
    K, N = m.kf_lm_idx.shape
    M = m.lm_pos.shape[0]
    dev = m.lm_pos.device
    kf_ids = torch.arange(K, dtype=torch.int32, device=dev)
    lm_idx_c = torch.clamp(m.kf_lm_idx, min=0).to(torch.int64)
    lm_idx_flat = lm_idx_c.reshape(-1)
    protected = (kf_ids >= m.n_kf - keep_latest) | (kf_ids < 2)

    kf_valid, lm_n_obs = m.kf_valid, m.lm_n_obs
    n_culled = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(max_cull):
        has = (m.kf_lm_idx >= 0) & m.kf_kp_valid & kf_valid[:, None]
        red = has & (lm_n_obs[lm_idx_c] >= min_other_obs + 1)
        n_has = torch.sum(has, dim=1)
        frac = torch.sum(red, dim=1) / torch.clamp(n_has, min=1).to(torch.float32)
        cullable = kf_valid & ~protected & (n_has > 0)
        n_free = K - torch.sum(kf_valid.to(torch.int32))
        force = (n_free < force_free) | bool(i == 0 and force_min_one)
        score = torch.where(cullable & ((frac >= redundancy) | force), frac, -1.0)
        cull = (kf_ids == torch.argmax(score)) & (torch.amax(score) >= 0.0)
        dec = torch.zeros_like(lm_n_obs)
        dec.index_add_(0, lm_idx_flat, (has & cull[:, None]).to(torch.int32).reshape(-1))
        kf_valid = kf_valid & ~cull
        lm_n_obs = lm_n_obs - dec
        n_culled = n_culled + torch.sum(cull).to(torch.int32)
    lm_valid = m.lm_valid & (lm_n_obs > 0)

    # landmark compaction: stable partition valid-first + index remap
    lm_order = _stable_partition(lm_valid)
    lm_new_of = torch.where(
        lm_valid, torch.cumsum(lm_valid.to(torch.int32), 0) - 1, -1
    ).to(torch.int32)
    lm_valid_c = lm_valid[lm_order]
    keep = lm_valid_c[:, None]
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    lm_pos = torch.where(keep, m.lm_pos[lm_order], 0.0)
    lm_desc = torch.where(keep, m.lm_desc[lm_order], zero_i)
    lm_n_obs_c = torch.where(lm_valid_c, lm_n_obs[lm_order], zero_i)
    lm_first_kf = m.lm_first_kf[lm_order]
    lm_n_visible = torch.where(lm_valid_c, m.lm_n_visible[lm_order], zero_i)
    lm_n_found = torch.where(lm_valid_c, m.lm_n_found[lm_order], zero_i)
    n_lm = torch.sum(lm_valid).to(torch.int32)

    # keyframe compaction
    kf_order = _stable_partition(kf_valid)
    kf_new_of = torch.where(
        kf_valid, torch.cumsum(kf_valid.to(torch.int32), 0) - 1, -1
    ).to(torch.int32)
    kf_valid_c = kf_valid[kf_order]
    eye = torch.eye(3, dtype=m.kf_R.dtype, device=dev).expand(K, 3, 3)
    kf_R = torch.where(kf_valid_c[:, None, None], m.kf_R[kf_order], eye)
    kf_t = torch.where(kf_valid_c[:, None], m.kf_t[kf_order], 0.0)
    kf_frame_id = torch.where(kf_valid_c, m.kf_frame_id[kf_order], zero_i - 1)
    kf_uv = torch.where(kf_valid_c[:, None, None], m.kf_uv[kf_order], 0.0)
    kf_desc = torch.where(kf_valid_c[:, None, None], m.kf_desc[kf_order], zero_i)
    kf_kp_valid = m.kf_kp_valid[kf_order] & kf_valid_c[:, None]
    n_kf = torch.sum(kf_valid).to(torch.int32)

    old_lm = m.kf_lm_idx[kf_order]
    old_c = torch.clamp(old_lm, min=0).to(torch.int64)
    assoc = (old_lm >= 0) & lm_valid[old_c] & kf_valid_c[:, None]
    kf_lm_idx = torch.where(assoc, lm_new_of[old_c], zero_i - 1)

    # re-anchor landmarks whose first keyframe was culled to the nearest
    # surviving earlier keyframe (falling back to the first surviving one)
    last_valid_upto = torch.cummax(torch.where(kf_valid, kf_ids, -1), dim=0).values
    first_valid = torch.argmax(kf_valid.to(torch.int32))
    fk = torch.clamp(lm_first_kf, 0, K - 1).to(torch.int64)
    fk2 = torch.where(
        kf_valid[fk], fk, torch.maximum(last_valid_upto[fk].to(torch.int64), first_valid)
    )
    lm_first_kf = torch.where(lm_valid_c, kf_new_of[fk2], zero_i - 1)

    out = m._replace(
        lm_pos=lm_pos, lm_desc=lm_desc, lm_valid=lm_valid_c, lm_n_obs=lm_n_obs_c,
        lm_first_kf=lm_first_kf, lm_n_visible=lm_n_visible, lm_n_found=lm_n_found,
        kf_R=kf_R, kf_t=kf_t, kf_valid=kf_valid_c, kf_frame_id=kf_frame_id,
        kf_uv=kf_uv, kf_desc=kf_desc, kf_kp_valid=kf_kp_valid, kf_lm_idx=kf_lm_idx,
        n_kf=n_kf, n_lm=n_lm,
    )
    return CompactResult(out, kf_order, lm_order, n_culled)
