"""A one-axis device mesh over ``torch.distributed`` (port of
lpslam_tpu/dist/mesh.py), and a launcher that runs a function on a world of
spawned processes.

JAX drives a ``Mesh`` of devices from one process; here every rank is its
own process in a process group (NCCL on the card, gloo on the CPU). A
``Mesh`` wraps the ``DeviceMesh`` of ``init_device_mesh`` and its two
collectives: ``all_reduce`` (SUM, JAX's ``psum``) and ``all_gather`` (the
ranks' blocks concatenated along dim 0, what ``out_specs=P(axis)``
reassembles). With no process group initialized the mesh is a world of one
on the caller's device, and both collectives return their input.

``run_world(fn, n, *args)`` starts n processes (spawn), joins them in a
process group through a file in a temporary directory (so concurrent worlds
never race for a port), calls ``fn(mesh, *args)`` on each rank and returns
the ranks' results in rank order; fn must be importable by name and return
something picklable (numpy, not CUDA tensors).
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist


class Mesh:
    """A one-axis mesh: this process's rank and the world's size along it,
    the device its tensors live on, and the collectives over it."""

    def __init__(self, axis_name: str, device: torch.device, device_mesh=None):
        self.axis_names = (axis_name,)
        self.device = device
        self.device_mesh = device_mesh
        self.size = 1 if device_mesh is None else device_mesh.size()
        self.rank = 0 if device_mesh is None else device_mesh.get_local_rank()
        self._group = None if device_mesh is None else device_mesh.get_group()

    def all_reduce(self, x):
        """Sum of ``x`` over the ranks, in place; returns ``x``."""
        if self.device_mesh is not None:
            dist.all_reduce(x, group=self._group)
        return x

    def all_gather(self, x):
        """The ranks' ``x`` concatenated along dim 0, in rank order."""
        if self.device_mesh is None:
            return x
        if x.dtype == torch.bool:           # collectives move bytes, not bools
            return self.all_gather(x.to(torch.uint8)).bool()
        out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=self._group)
        return out

    def block(self, n: int) -> slice:
        """This rank's contiguous block of an axis of length n (n divisible
        by the mesh size)."""
        blk = n // self.size
        return slice(self.rank * blk, (self.rank + 1) * blk)


def _default_device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "obs",
              device=None) -> Mesh:
    """The mesh over the initialized process group (every rank of it), or a
    world of one when there is none. ``device`` defaults to this process's
    card, or the CPU where there is no card."""
    device = torch.device(device) if device is not None else _default_device()
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} needs a process group of that size "
                "(init_distributed, or run_world)")
        return Mesh(axis_name, device)
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"a mesh spans the whole world ({world} ranks), not {n_devices}")
    return Mesh(axis_name, device,
                init_device_mesh(device.type, (world,), mesh_dim_names=(axis_name,)))


def default_mesh() -> Mesh:
    return make_mesh()


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join this process to a world of ``num_processes`` ranks whose
    rendezvous is ``coordinator_address`` ("host:port"): NCCL with one card
    per rank where there are cards, gloo without. A no-op for one process."""
    if num_processes is None or num_processes <= 1:
        return
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            rank=process_id, world_size=num_processes)


def _rank_main(fn, rank, n, init_method, backend, device, args, out):
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            # one rank per card; ranks beyond the card count share cards
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=n)
        out.put((rank, True, fn(make_mesh(n, device=dev), *args)))
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, n: int, *args, backend: str = "gloo", device="cpu",
              timeout: float = 900.0) -> list:
    """``fn(mesh, *args)`` on every rank of a new world of ``n`` spawned
    processes; returns the ranks' results in rank order. A rank that raises
    makes this raise with its traceback; every process is stopped before
    this returns."""
    ctx = multiprocessing.get_context("spawn")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, n, init_method, backend, str(device), args, out))
            for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) < n:
                try:
                    rank, ok, val = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank of the world of {n} died: exit codes {dead}")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"the world of {n} ran over {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of a world of {n} failed:\n{val}")
                results[rank] = val
        finally:
            for p in procs:
                p.join(timeout=30.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10.0)
    return [results[r] for r in range(n)]
