"""Placement of the Repository's block-cyclic flat rows on a mesh (port of
the flat-row half of ``repro.launch.sharding``).

A row laid out by ``utils.flat.ShardedFlatSpec`` over the mesh axes
``axes`` has S = ``axes_extent(mesh, axes)`` shards; shard ``s`` lives on
one device, the mesh slot whose linear index over ``axes`` (first axis
most significant, as the reference's ``shard_map`` numbers shards) is
``s`` and whose index on every other axis is 0.  In the port a staged row
is the list of its S ``[shard_len]`` slices, each on its shard's device,
and a staged cohort the list of S ``[K, shard_len]`` stacks.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh


def norm_axes(axes) -> Tuple[str, ...]:
    """A bare axis name or a sequence of names -> a tuple of names."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axes_extent(mesh: Mesh, axes) -> int:
    """The product of the extents of ``axes``: the shard count S of a flat
    row laid out over them."""
    shape = mesh.shape
    return int(np.prod([shape[a] for a in norm_axes(axes)], dtype=np.int64))


def flat_row_sharding(mesh: Mesh, axes) -> Tuple[torch.device, ...]:
    """The device of each shard of a row laid out over ``axes``, in shard
    order (where the reference's ``P(axes, None)`` places them)."""
    axes = norm_axes(axes)
    order = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    grid = np.transpose(mesh.devices, order + rest)
    grid = grid[(Ellipsis,) + (0,) * len(rest)] if rest else grid
    return tuple(grid.reshape(-1))


def place_shards(x, mesh: Mesh, axes, dim: int = 0) -> List[torch.Tensor]:
    """A sharded operand as its S per-shard tensors, each contiguous on its
    shard's device: a list or tuple is placed as it is, a tensor is split
    along its shard dim ``dim`` (the JAX package's ``[S, L]`` row or
    ``[K, S, L]`` stage).  A staged cohort's ``[K, shard_len]`` stacks sit
    where its rows' slices do, so no device holds more than ``K ·
    shard_len`` staged elements."""
    devices = flat_row_sharding(mesh, axes)
    if isinstance(x, torch.Tensor):
        if x.shape[dim] != len(devices):
            raise ValueError(f"shard dim {dim} of {tuple(x.shape)} != {len(devices)} shards")
        x = x.unbind(dim)
    if len(x) != len(devices):
        raise ValueError(f"{len(x)} shards for a {len(devices)}-shard layout")
    return [p.to(d).contiguous() for p, d in zip(x, devices)]


def stage_row_from_shards(mesh: Mesh, axes, n_shards: int, shard_len: int,
                          read_shard: Callable[[int], torch.Tensor]) -> List[torch.Tensor]:
    """Stage one row from a per-shard host reader (the sharded spill's
    reload path): ``read_shard(i)`` gives shard ``i``'s ``[shard_len]``
    host slice, which is copied to its device before the next is read, so
    the host never holds the whole ``[N]`` row."""
    devices = flat_row_sharding(mesh, axes)
    if len(devices) != n_shards:
        raise ValueError(f"{n_shards} shards for a {len(devices)}-shard layout")
    out = []
    for i, dev in enumerate(devices):
        part = torch.as_tensor(read_shard(i))
        if tuple(part.shape) != (shard_len,):
            raise ValueError(f"shard {i} has shape {tuple(part.shape)}, want ({shard_len},)")
        out.append(part.to(dev))
    return out
