"""Carry state between the JAX package and the port as numpy arrays.

``*_from_numpy(d, device)`` take a dict of numpy arrays keyed by the
NamedTuple's field names (for a JAX NamedTuple ``t``:
``{k: np.asarray(v) for k, v in t._asdict().items()}``) and build the port's
NamedTuple on `device`. uint32 descriptor words are viewed as int32 bit
patterns. ``*_to_numpy`` go back, with descriptors viewed as uint32 again.
A vocabulary crosses as its words and idf; the port rebuilds its float32
``words_pm1`` from the words (JAX keeps int8), so it is not carried.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry.camera import PinholeCamera
from .geometry.se3 import SE3
from .geometry.sim3 import Sim3
from .kernels.orb import OrbFeatures
from .loop.vocab import Vocabulary, vocabulary_from_words
from .mapstore.store import MapStore

_DESC_FIELDS = ("lm_desc", "kf_desc", "desc")


def _to_tensor(arr, device):
    arr = np.asarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    elif arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def _from_numpy(cls, d, device):
    return cls(**{k: _to_tensor(d[k], device) for k in cls._fields if k in d})


def _to_numpy(t):
    out = {}
    for k, v in t._asdict().items():
        if v is None:
            continue
        a = v.detach().cpu().numpy()
        if k in _DESC_FIELDS:
            a = a.view(np.uint32)
        out[k] = a
    return out


def map_from_numpy(d: dict, device) -> MapStore:
    return _from_numpy(MapStore, d, device)


def map_to_numpy(m: MapStore) -> dict:
    return _to_numpy(m)


def feats_from_numpy(d: dict, device) -> OrbFeatures:
    return _from_numpy(OrbFeatures, d, device)


def feats_to_numpy(f: OrbFeatures) -> dict:
    return _to_numpy(f)


def se3_from_numpy(d: dict, device) -> SE3:
    return _from_numpy(SE3, d, device)


def se3_to_numpy(T: SE3) -> dict:
    return _to_numpy(T)


def camera_from_numpy(d: dict, device) -> PinholeCamera:
    return _from_numpy(PinholeCamera, d, device)


def camera_to_numpy(cam: PinholeCamera) -> dict:
    return _to_numpy(cam)


def sim3_from_numpy(d: dict, device) -> Sim3:
    return _from_numpy(Sim3, d, device)


def sim3_to_numpy(S: Sim3) -> dict:
    return _to_numpy(S)


def vocab_from_numpy(d: dict, device) -> Vocabulary:
    return vocabulary_from_words(d["words"], d["idf"], device)


def vocab_to_numpy(v: Vocabulary) -> dict:
    return {"words": v.words.cpu().numpy().view(np.uint32), "idf": v.idf.cpu().numpy()}
