"""Device meshes (port of ``repro.launch.mesh``) and the mesh's collectives.

The reference's ``Mesh`` is JAX's single-controller mesh: one process
places slices on every device.  The port's counterpart is the same: a
``Mesh`` is an object array of ``torch.device``s shaped as the mesh, with
its axis names, and one process places shard ``s`` on
``mesh.devices.flat[s]``.  ``make_mesh`` spreads the shards round-robin
over the cards there are, so with fewer cards than shards several shards
share a card (``--mesh 8`` on one H100 puts all eight on ``cuda:0``, as
the reference's eight fake CPU devices share one CPU).

The collectives of the sharded Repository engine are explicit calls here,
each counted in ``collectives`` (the port has no HLO to count them in):

* ``all_reduce_sum`` — the one all-reduce of a sharded fuse or sketch:
  the S per-shard partials are brought to the mesh's first device and
  added in shard order, so the result repeats bit for bit;
* ``all_gather`` — a sharded row reassembled into ``[N]`` on the first
  device (at publish, and where a file's layout does not match the mesh).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

# collective name -> calls since the last reset_collectives()
collectives: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}
_COUNT_LOCK = threading.Lock()


def reset_collectives() -> None:
    with _COUNT_LOCK:
        for k in collectives:
            collectives[k] = 0


def count_collective(name: str) -> None:
    """Count one collective that happened outside this module (a sharded
    file put back together on the host counts as an ``all_gather``)."""
    with _COUNT_LOCK:
        collectives[name] += 1


class Mesh:
    """A named grid of devices: ``devices`` is an object array of
    ``torch.device`` shaped as the mesh, ``axis_names`` names its axes and
    ``shape`` maps each name to its extent (as JAX's ``Mesh.shape``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        kinds = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({dims}; {', '.join(kinds)})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cuda") -> Mesh:
    """A mesh of ``prod(shape)`` slots: slot ``i`` (row-major) is
    ``cuda:(i % torch.cuda.device_count())`` on ``device="cuda"`` (which
    raises without a card), or the CPU on ``device="cpu"``."""
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(tuple(axes)) or any(n < 1 for n in shape):
        raise ValueError(f"mesh shape {shape} does not fit axes {tuple(axes)}")
    dev = resolve_device(device)
    n = int(np.prod(shape))
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        slots = [torch.device("cuda", i % cards) for i in range(n)]
    elif dev.type == "cpu":
        slots = [torch.device("cpu")] * n
    else:
        raise ValueError(f"a mesh is made of CUDA cards or the CPU; got {dev}")
    grid = np.empty(n, dtype=object)
    grid[:] = slots
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's production layout: a 16 x 16 ("data", "model") grid,
    with a leading "pod" axis of 2 for the multi-pod variant."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_cold_mesh(*, contributors: int = 8, replicas: int = 2, model: int = 16,
                   multi_pod: bool = False, device="cuda") -> Mesh:
    """The ColD Fusion training mesh: (pod?) x contrib x replica x model."""
    shape: Tuple[int, ...] = (contributors, replicas, model)
    axes: Tuple[str, ...] = ("contrib", "replica", "model")
    if multi_pod:
        shape, axes = (2,) + shape, ("pod",) + axes
    return make_mesh(shape, axes, device=device)


def data_axes(mesh: Mesh) -> tuple:
    """Every batch-parallel axis present in a mesh (pod, data, contrib, replica)."""
    return tuple(a for a in ("pod", "data", "contrib", "replica") if a in mesh.axis_names)


def all_reduce_sum(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The sum of the S per-shard partials, on ``mesh.devices.flat[0]``,
    added in shard order (counted as one ``all_reduce``)."""
    if not parts:
        raise ValueError("all_reduce_sum of no partials")
    dev = mesh.devices.flat[0]
    out = parts[0].to(dev, copy=True)
    for p in parts[1:]:
        out += p.to(dev)
    count_collective("all_reduce")
    return out


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The S per-shard slices stacked ``[S, ...]`` on ``mesh.devices.flat[0]``
    (counted as one ``all_gather``)."""
    dev = mesh.devices.flat[0]
    out = torch.stack([p.to(dev) for p in parts])
    count_collective("all_gather")
    return out
