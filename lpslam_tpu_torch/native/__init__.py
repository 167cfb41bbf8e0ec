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
carries a hash of its source and flags, as ``_cuda.py`` names its kernels;
``build_library`` does the same for the port's other C++ sources (the JPEG
codec of ``io/jpeg.py``).
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


def build_library(source: Path, stem: str, include: str = "") -> tuple:
    """Compile `source` with g++ (CXX_FLAGS, plus -I`include` when given)
    into ``_build/<stem>_<hash>.so`` unless that file exists; the hash
    covers the source, the flags and the include path. Returns (path, None,
    seconds g++ took or None when it was built earlier) or (None, the
    compiler's output, None). The file is renamed into place atomically, so
    a concurrent build never loads a torn one."""
    flags = (*CXX_FLAGS, *((f"-I{include}",) if include else ()))
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    so_path = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    if so_path.exists():
        return str(so_path), None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *flags, str(source), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return None, f"{' '.join(cmd)}: {exc!r}", None
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None, f"{' '.join(cmd)} exited {res.returncode}:\n{res.stderr}", None
    os.replace(tmp, so_path)
    return str(so_path), None, time.perf_counter() - t0


def build_native() -> Optional[str]:
    """Compile the extension unless it is built already; return the .so
    path, or None with the reason kept for ``native_build_error()``."""
    so_path, error, seconds = build_library(SOURCE, "lpslam_native",
                                            sysconfig.get_paths()["include"])
    if so_path is None:
        _state["error"] = error
    elif seconds is not None:
        _state["build_s"] = seconds
    return so_path


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
