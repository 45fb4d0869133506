"""The mesh: one controller over a tuple of devices.

Counterpart of presto_tpu/parallel/mesh.py (`make_mesh`, `WORKERS_AXIS`).
The reference's mesh is one process driving N devices through one SPMD
program (`jax.shard_map` over the "workers" axis). Here the same single
controller holds a tuple of `torch.device`s, one per worker: lowering
(exec/planner.py) runs every operator once per worker on that worker's
device, and an exchange (parallel/exchange.py) moves each worker's rows
to their receiver with `Tensor.to(device)`. Several workers may share
one device: `devices=("cuda:0",) * 4` puts four workers on one card,
which then runs the routing, packing and overflow of a four-worker
plan; `("cpu",) * 8` runs eight workers in the calling process. Across
several cards the same moves are peer copies.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

WORKERS_AXIS = "workers"

__all__ = ["Mesh", "make_mesh", "WORKERS_AXIS"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Worker w runs on `devices[w]`; `axis_name` names the one mesh
    axis, as the reference's."""
    devices: Tuple[torch.device, ...]
    axis_name: str = WORKERS_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device()
                         if torch.cuda.is_available() else 0)
    return d


def make_mesh(n: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `n` workers. Without `devices` it takes the first `n`
    CUDA devices (all of them when `n` is None) and raises when fewer
    exist; `devices` places worker w on `devices[w]` (a device may
    repeat). There is no fallback to the CPU or to fewer workers."""
    if devices is not None:
        devs = tuple(_device(d) for d in devices)
        if n is not None and n != len(devs):
            raise ValueError(f"make_mesh({n}) given {len(devs)} devices")
        if not devs:
            raise ValueError("make_mesh needs at least one device")
        for d in devs:
            if d.type == "cuda" and (not torch.cuda.is_available() or
                                     d.index >= torch.cuda.device_count()):
                raise RuntimeError(f"{d} is not available")
        return Mesh(devs)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n is None:
        n = count
    if n < 1 or n > count:
        raise RuntimeError(
            f"make_mesh({n}) needs {n} CUDA devices and {count} are "
            "available; pass devices= to place the workers (devices="
            "('cuda:0',) * 4 puts four workers on one card, ('cpu',) * 8 "
            "eight on the CPU)")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
