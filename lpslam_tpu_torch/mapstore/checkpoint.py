"""Map persistence (port of lpslam_tpu/mapstore/checkpoint.py): the
MapStore's fields as one compressed npz, written atomically (a temporary
file, then a rename).

The keys and dtypes are the JAX package's: descriptors are written as uint32
words and read back as the port's int32 bit patterns, so a map file crosses
between the packages in both directions.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..convert import map_from_numpy, map_to_numpy
from .store import MapStore


def save_map(m: MapStore, path: str) -> None:
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **map_to_numpy(m))
    os.replace(tmp, path)


def load_map(path: str, device) -> Optional[MapStore]:
    """The map at `path` on `device`, or None when there is no such file."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as data:
        return map_from_numpy({k: data[k] for k in MapStore._fields}, device)
