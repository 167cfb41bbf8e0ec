"""lpslam_tpu_torch — the PyTorch/CUDA port of lpslam_tpu for NVIDIA Hopper.

The package mirrors ``lpslam_tpu``'s layout and public names: each module
sits at the same relative path as the JAX function it ports
(``kernels/orb.py::extract_orb``, ``frontend/device_loop.py::ChunkedTracker``).
Tensors are plain torch tensors; the NamedTuples keep the JAX field names.
Every entry point takes an explicit ``device``; there is no global default.

Hand-written CUDA kernels live in ``csrc/`` and are compiled with ``nvcc`` on
first use into ``_build/`` (never at import). Each one has a plain PyTorch
version beside it, which runs only for tensors that lie on the CPU.

This package imports torch and numpy only — never jax, never lpslam_tpu.
"""

__version__ = "0.1.0"

import torch as _torch

# Full fp32 for every matmul and convolution. The JAX package records the map
# collapsing under reduced-mantissa matmuls (lpslam_tpu/__init__.py): geometry
# (triangulation, pose optimization, Schur blocks) needs the full 24 bits, so
# TF32 stays off on the GPU.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
