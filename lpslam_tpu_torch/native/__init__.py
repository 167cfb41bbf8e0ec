"""Native runtime components (C++17, port of lpslam_tpu/native/), built with
g++ on first use, never at import.

The module ``lpslam_native`` (source ``csrc/native_module.cpp``) provides:
- BoundedQueue: a bounded queue that releases the GIL while it blocks
  (``pipeline/queues.py::NativeBoundedQueue`` wraps it);
- StreamWriter / StreamReader: the record stream's [u64 type][u64 size]
  [payload] framing (``io/lpslam_pb.py`` uses them);
- fast_detect: a host FAST-9/16 corner detector.

``get_native()`` returns the module, or None when it cannot be built; the
callers then fall back to their pure-Python equivalents, which write the
same bytes and keep the same queue semantics. A failed build is not silent:
the compiler's output stays in ``native_build_error()`` and is warned about
once. The library lands in ``lpslam_tpu_torch/_build/`` under a name that
carries a hash of its source and flags, as ``_cuda.py`` names its kernels.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
import time
import warnings
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "native_module.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_state = {"tried": False, "module": None, "error": None, "build_s": None}


def _lib_path() -> Path:
    include = sysconfig.get_paths()["include"]
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join((*CXX_FLAGS, include)).encode())
    return BUILD_DIR / f"lpslam_native_{digest.hexdigest()[:16]}.so"


def build_native() -> Optional[str]:
    """Compile the extension unless it is built already; return the .so
    path, or None with the reason kept for ``native_build_error()``."""
    so_path = _lib_path()
    if so_path.exists():
        return str(so_path)
    include = sysconfig.get_paths()["include"]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, f"-I{include}", str(SOURCE), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as exc:
        _state["error"] = f"{' '.join(cmd)}: {exc!r}"
        return None
    if res.returncode != 0:
        _state["error"] = f"{' '.join(cmd)} exited {res.returncode}:\n{res.stderr}"
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so_path)   # atomic: a concurrent build never loads a torn file
    _state["build_s"] = time.perf_counter() - t0
    return str(so_path)


def get_native():
    """The compiled ``lpslam_native`` module, or None (built and loaded once
    per process; a failure warns once and is not retried)."""
    with _lock:
        if _state["tried"]:
            return _state["module"]
        _state["tried"] = True
        so_path = build_native()
        if so_path is not None:
            spec = importlib.util.spec_from_file_location("lpslam_native", so_path)
            try:
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _state["module"] = mod
            except ImportError as exc:
                _state["error"] = f"loading {so_path}: {exc!r}"
        if _state["module"] is None:
            warnings.warn(
                "lpslam_tpu_torch.native: the native module is unavailable, the "
                f"pure-Python queue and stream framing run instead: {_state['error']}",
                RuntimeWarning, stacklevel=2)
        return _state["module"]


def native_build_error() -> Optional[str]:
    """Why the native module is unavailable (the compiler's stderr), or None."""
    return _state["error"]


def native_build_seconds() -> Optional[float]:
    """Seconds g++ took in this process, or None if nothing was compiled."""
    return _state["build_s"]
