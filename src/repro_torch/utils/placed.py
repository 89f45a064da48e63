"""Placed leaves: one tensor stored as blocks on the slots of a device grid
(the counterpart of a ``jax.Array`` sharded by a ``NamedSharding``).

A ``Layout`` holds a leaf's global shape, its spec over the grid's axes
(for each dim, the axes it is split over, first most significant, as JAX
numbers shards) and the grid: a ``launch.mesh.Mesh`` whose slot ``s`` is
``mesh.devices.flat[s]``.  Slot ``s`` holds the block whose index on each
dim is its linear index over that dim's axes.  A block that several slots
hold (a leaf replicated over an axis) is stored ONCE per device: slots
that share a card share the tensor, and an elementwise map over the leaf
computes it once.  ``Placed.blocks`` are those stored tensors, one per
(block, device) key in the order of the first slot that holds each.

This module knows nothing of collectives: ``launch.sharding.gather``
reads a placed leaf whole, counted; ``Placed.whole`` is the uncounted
assembly it is built on.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch


def spec_axes(entry) -> Tuple[str, ...]:
    """One spec entry (``None``, an axis name or a tuple of names) as a
    tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Layout:
    """Where the blocks of one placed leaf live (see the module docstring).
    Two layouts are equal when the shape, the spec and the grid's axes and
    devices are (not hashable)."""

    def __init__(self, shape: Sequence[int], spec: Sequence[Any], mesh):
        self.shape = tuple(int(n) for n in shape)
        spec = [spec_axes(e) for e in spec]
        if len(spec) > len(self.shape):
            raise ValueError(f"spec {spec} for a leaf of rank {len(self.shape)}")
        self.spec: Tuple[Tuple[str, ...], ...] = tuple(spec + [()] * (len(self.shape) - len(spec)))
        self.mesh = mesh
        grid = tuple(mesh.devices.shape)
        extent = dict(zip(mesh.axis_names, grid))
        self.splits = tuple(int(np.prod([extent[a] for a in e], dtype=np.int64)) for e in self.spec)
        for d, (n, k) in enumerate(zip(self.shape, self.splits)):
            if n % k:
                raise ValueError(f"dim {d} of {self.shape} does not split into {k} blocks")
        self.block_shape = tuple(n // k for n, k in zip(self.shape, self.splits))
        devices = tuple(mesh.devices.flat)
        keys, slot_key, firsts = {}, [], []
        for s in range(len(devices)):
            coord = dict(zip(mesh.axis_names, np.unravel_index(s, grid))) if grid else {}
            idx = []
            for e in self.spec:
                i = 0
                for a in e:
                    i = i * extent[a] + int(coord[a])
                idx.append(i)
            key = (tuple(idx), devices[s])
            if key not in keys:
                keys[key] = len(firsts)
                firsts.append(s)
            slot_key.append(keys[key])
        self.slot_key = tuple(slot_key)       # slot -> stored block
        self.first_slot = tuple(firsts)       # stored block -> its first slot
        self.block_index = tuple(k[0] for k in keys)
        self.devices = tuple(k[1] for k in keys)
        self._eq = (self.shape, self.spec, tuple(mesh.axis_names), devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, Layout) and (self is other or self._eq == other._eq)

    @property
    def n_slots(self) -> int:
        return len(self.slot_key)

    def slices(self, block_index) -> Tuple[slice, ...]:
        return tuple(slice(i * b, (i + 1) * b) for i, b in zip(block_index, self.block_shape))

    def logical_blocks(self) -> List[int]:
        """One stored block for each distinct block index (the first one
        stored), in order of first appearance: each logical block once."""
        seen, out = set(), []
        for u, idx in enumerate(self.block_index):
            if idx not in seen:
                seen.add(idx)
                out.append(u)
        return out

    def splits_over(self, axis) -> bool:
        """Whether any dim is split over ``axis`` (a name, or any name of a
        tuple of names)."""
        axes = set(spec_axes(axis))
        return any(axes & set(e) for e in self.spec)


class Placed:
    """A leaf stored as blocks on a grid's slots (see the module docstring)."""

    __slots__ = ("layout", "blocks")

    def __init__(self, layout: Layout, blocks: Sequence[torch.Tensor]):
        if len(blocks) != len(layout.first_slot):
            raise ValueError(f"{len(blocks)} blocks for a layout that stores "
                             f"{len(layout.first_slot)}")
        self.layout = layout
        self.blocks = list(blocks)

    @classmethod
    def split(cls, x: torch.Tensor, spec, mesh) -> "Placed":
        """``x`` split by ``spec`` onto ``mesh``'s slots, each block copied
        to its device once (contiguous)."""
        lay = Layout(x.shape, spec, mesh)
        if tuple(x.shape) != lay.shape:
            raise ValueError(f"shape {tuple(x.shape)} != {lay.shape}")
        blocks = [x[lay.slices(idx)].to(dev).contiguous()
                  for idx, dev in zip(lay.block_index, lay.devices)]
        return cls(lay, blocks)

    # -- reading ---------------------------------------------------------------------

    def block(self, s: int) -> torch.Tensor:
        """The block slot ``s`` holds."""
        return self.blocks[self.layout.slot_key[s]]

    def slot_blocks(self) -> List[torch.Tensor]:
        return [self.blocks[u] for u in self.layout.slot_key]

    def whole(self, device=None) -> torch.Tensor:
        """The leaf assembled on ``device`` (slot 0's by default), each
        logical block copied once; not counted as a collective."""
        lay = self.layout
        dev = torch.device(device) if device is not None else self.blocks[0].device
        out = torch.empty(lay.shape, dtype=self.dtype, device=dev)
        for u in lay.logical_blocks():
            out[lay.slices(lay.block_index[u])] = self.blocks[u].to(dev)
        return out

    # -- elementwise maps ------------------------------------------------------------------

    def map(self, fn: Callable, *rest: "Placed") -> "Placed":
        """``fn`` applied once to each stored block (with the same block of
        every leaf in ``rest``, placed alike)."""
        for r in rest:
            if not isinstance(r, Placed) or r.layout != self.layout:
                raise ValueError("Placed.map over leaves placed differently")
        return Placed(self.layout, [fn(b, *(r.blocks[u] for r in rest))
                                    for u, b in enumerate(self.blocks)])

    def with_blocks(self, blocks: Sequence[torch.Tensor]) -> "Placed":
        return Placed(self.layout, blocks)

    # -- tensor-like attributes -------------------------------------------------------------

    @property
    def shape(self) -> torch.Size:
        return torch.Size(self.layout.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def ndim(self) -> int:
        return len(self.layout.shape)

    def dim(self) -> int:
        return self.ndim

    def numel(self) -> int:
        return int(np.prod(self.layout.shape, dtype=np.int64))

    def element_size(self) -> int:
        return self.blocks[0].element_size()

    def is_floating_point(self) -> bool:
        return self.blocks[0].is_floating_point()

    def __repr__(self) -> str:
        spec = tuple(e[0] if len(e) == 1 else (e or None) for e in self.layout.spec)
        return (f"Placed(shape={self.layout.shape}, spec={spec}, dtype={self.dtype}, "
                f"{len(self.blocks)} stored blocks on {self.layout.n_slots} slots)")
