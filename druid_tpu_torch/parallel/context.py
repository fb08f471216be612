"""The active device mesh of query execution.

The port's counterpart of the reference package's `parallel/context.py`.
The executor (and tests) install a mesh here; the engines then run an
eligible grouped aggregate as one sharded stacked run over it
(parallel/distributed.py) instead of per-segment runs merged on the host.

A mesh is process-local: a tuple of torch devices and the name of its one
axis, "seg". On CUDA it is the first n cards of this process; on the CPU it
is n shards of the one CPU device, the stand-in the tests use where the
reference's tests use XLA's virtual host devices. Across processes the
broker carries the combine (`initialize_multihost` joins the processes;
the mesh stays each process's own).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import ClassVar, Optional, Tuple

import torch

SEGMENT_AXIS = "seg"

_state = threading.local()


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices its shards run on, in shard order. Its one
    axis is SEGMENT_AXIS."""
    devices: Tuple[torch.device, ...]
    axis: ClassVar[str] = SEGMENT_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of `n_devices` shards. With `device` None or "cuda": the first
    n cards of torch.cuda.device_count() (all of them by default); raises
    where there is no card or fewer than n. With device="cpu": n shards of
    the CPU (1 by default), the tests' stand-in for several devices."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        return Mesh(tuple(torch.device("cpu") for _ in range(n)))
    if kind != "cuda":
        raise ValueError(f"unsupported mesh device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh needs a CUDA device; pass device='cpu' "
                           "for CPU shards")
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n < 1 or n > have:
        raise ValueError(f"a mesh of {n} cards asked for, {have} present")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def check_device(mesh: Optional[Mesh], device: torch.device) -> None:
    """Raise where a mesh's devices are of another type than the device an
    entry point runs on (a CUDA mesh on a device="cpu" executor, or a CPU
    mesh on a CUDA one)."""
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"{mesh} does not run on device {device}")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> int:
    """Join a multi-process job (torch.distributed.init_process_group):
    nccl where CUDA is present, else gloo; `coordinator_address` host:port
    (tcp://) or a full init URL (tcp://, file://); without one, torch's own
    env:// rendezvous. Idempotent; returns the world size. A mesh stays
    process-local: with a world larger than 1 the broker still carries the
    combine across processes."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend=backend, init_method=init, **kwargs)
    return dist.get_world_size()


def set_mesh(mesh: Optional[Mesh]) -> None:
    _state.mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Install `mesh` on this thread for the block (None: no mesh)."""
    prev = get_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
