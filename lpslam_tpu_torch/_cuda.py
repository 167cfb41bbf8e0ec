"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each kernel file exposes a plain C entry point. It is compiled with ``nvcc``
for ``sm_90a`` into ``lpslam_tpu_torch/_build/`` on first use and loaded with
ctypes; nothing is compiled when a module is imported. The library's name
carries a hash of its source and the flags, so an edited source is always
rebuilt. ``load_libraries`` builds several sources at once, one nvcc process
each. ``entry`` resolves a C entry point once per process and ``launch``
calls it on the tensor's device and PyTorch's current stream there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict = {}
_ENTRIES: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"


def load_libraries(sources) -> dict:
    """Compile each source (a file name under csrc/, or the path of a file
    elsewhere) not built yet — one nvcc process per source, all started
    together — and return {source: loaded library}. Raises if any nvcc
    fails."""
    todo = [s for s in sources if s not in _LIBS]
    jobs = []
    for source in todo:
        src = CSRC / source
        lib_path = _lib_path(src)
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, tmp, lib_path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, tmp, lib_path, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src.name}:\n{out}\n{err}")
        else:
            os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))
    for source in todo:
        _LIBS[source] = ctypes.CDLL(str(_lib_path(CSRC / source)))
    return {s: _LIBS[s] for s in sources}


def load_library(source) -> ctypes.CDLL:
    """Compile one source (once per process and source version) and return
    the loaded library. Raises if nvcc fails."""
    return load_libraries([source])[source]


def entry(source, name: str, argtypes):
    """The C entry point ``name`` of a source's library, returning int, with
    its argument types set; built, resolved and typed on the first call."""
    fn = _ENTRIES.get((source, name))
    if fn is None:
        fn = getattr(load_library(source), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[(source, name)] = fn
    return fn


def launch(fn, device, *args) -> None:
    """Call a kernel entry point with ``args`` and, last, PyTorch's current
    stream on ``device``; raise if it returns a CUDA error code. The device
    is made current for the call only where it is not already."""
    if device.index is None or device.index == torch.cuda.current_device():
        status = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(
            f"{fn.__name__}: CUDA error {status} on {torch.cuda.get_device_name(device)}")
