"""Device meshes (port of ``repro.launch.mesh``) and the mesh's collectives.

The reference's ``Mesh`` is JAX's single-controller mesh: one process
places slices on every device.  The port's counterpart is the same: a
``Mesh`` is an object array of ``torch.device``s shaped as the mesh, with
its axis names, and one process places shard ``s`` on
``mesh.devices.flat[s]``.  ``make_mesh`` spreads the shards round-robin
over the cards there are, so with fewer cards than shards several shards
share a card (``--mesh 8`` on one H100 puts all eight on ``cuda:0``, as
the reference's eight fake CPU devices share one CPU).

The collectives of the sharded engines are explicit calls here, each
counted in ``collectives`` and the bytes it carries between mesh slots in
``collective_bytes`` (the port has no HLO to count them in; a transfer
between two slots counts whether or not they share a card):

* ``all_reduce_sum`` — the one all-reduce of a sharded Repository fuse or
  sketch: the S per-shard partials are brought to the mesh's first device
  and added in shard order, so the result repeats bit for bit
  ((S - 1) partials' bytes);
* ``all_reduce_over`` — the one all-reduce of the mesh-level cohort fuse
  (``ops.cohort_fuse_sharded``) over the contributor axes: for each shard,
  the G contributor groups' partials are added in group order and the sum
  is copied back to every group (2 (G - 1) partials' bytes a shard);
  ``mean_over_groups`` makes the partials of a contributor mean and calls
  it, for the flat and the per-leaf fuse alike;
* ``all_gather`` — a sharded row reassembled into ``[N]`` on the first
  device (at publish, and where a file's layout does not match the mesh)
  ((S - 1) slices' bytes).

**Collectives over one named axis, or a tuple of axes,** run the
partitioned steps (``models.partitioned``).  Their operand is a list of
per-slot tensors, slot ``s`` on ``mesh.devices.flat[s]``; the axis splits
the slots into groups (one for each index of the other axes), and each
call acts on every group at once, as one ``psum`` over a named axis is one
collective in the reference's program.  A tuple of axes is one group of
their product's slots, ordered row-major over the tuple with its first name
major (as JAX numbers the blocks of a dim a tuple ``PartitionSpec`` entry
splits; ``Mesh.groups``, ``coord``, ``extent``).  Each call is counted
once, under its name and in ``collectives_by_axis`` under its axis (a
tuple under the tuple); the bytes are what a ring moves between the k
slots of a group, summed over every group, those of an axis no spec names
(replicated: its slots run the same program) included.  Sums are taken in
slot order on the group's first device, so a result repeats bit for bit.
Each is a ``torch.autograd.Function`` whose forward and backward are both
counted (Megatron's pairs):

* ``axis_all_reduce`` — the sum over the group on every slot (2 (k - 1)
  operands' bytes); its backward is the identity (a row-parallel output);
* ``axis_sum_grads`` — the identity, whose backward is that all-reduce
  (a column-parallel input);
* ``axis_all_gather`` — the group's blocks concatenated along ``dim`` on
  every slot (k (k - 1) blocks' bytes); its backward is a reduce-scatter;
* ``axis_reduce_scatter`` — the group's sum split along ``dim``, block
  ``i`` to the group's slot ``i`` ((k - 1) operands' bytes); its backward
  is an all-gather;
* ``axis_all_reduce_max`` — the maximum over the group, no gradient.

Two more carry a context-parallel forward's state along the sequence,
each counted under a kind of its own that appears in ``collectives`` from
its first call on:

* ``axis_send`` — each group's slot ``i`` hands its operand to slot
  ``i + 1`` (a collective permute, ``"permute"``; one operand's bytes a
  group); tracked (the train step's recurrent state), its backward hands
  the gradient back from slot ``i + 1`` to slot ``i``, one more permute;
* ``axis_broadcast`` — each group's slot ``i`` gives its operand to every
  slot of the group (``"broadcast"``; k - 1 operands' bytes a group; no
  gradient: the serving steps' cache).

Outside autograd (a gradient reduced after the backward), slots of one
group that share a device share the result tensor.  An axis of extent 1
is no collective: the operand comes back as it is, uncounted.

An active ``utils.op_counts.OpCounter`` sees each counted collective too.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils import op_counts
from repro_torch.utils.device import resolve_device
from repro_torch.utils.placed import spec_axes

Axis = Optional[object]   # an axis name, a tuple of names, or None


class _FromMesh:
    def __repr__(self) -> str:
        return "FROM_MESH"


# the default of the partitioned steps' ``data_axis`` and ``model_axis``: the
# axes read from the mesh's names (``models.partitioned.make_grid``)
FROM_MESH = _FromMesh()

# collective name -> calls, and bytes carried between mesh slots, since the
# last reset_collectives(); "permute" and "broadcast" join from their first call
BASE_KINDS = ("all_reduce", "all_gather", "reduce_scatter")
collectives: Dict[str, int] = dict.fromkeys(BASE_KINDS, 0)
collective_bytes: Dict[str, int] = dict.fromkeys(BASE_KINDS, 0)
# mesh axis -> calls over it (a call over several axes counts under each; a call
# over one group of a tuple of axes under the tuple)
collectives_by_axis: Dict[object, int] = {}
_COUNT_LOCK = threading.Lock()


def reset_collectives() -> None:
    with _COUNT_LOCK:
        for d in (collectives, collective_bytes):
            d.clear()
            d.update(dict.fromkeys(BASE_KINDS, 0))
        collectives_by_axis.clear()


def axis_key(axis):
    """The key of ``collectives_by_axis`` for an axis: its name, a tuple of
    names as the tuple (a one-name tuple as the name)."""
    axes = spec_axes(axis)
    return axes[0] if len(axes) == 1 else axes


def count_collective(name: str, nbytes: int = 0, axes: Sequence = ()) -> None:
    """Count one collective that carried ``nbytes`` between mesh slots (a
    sharded file put back together on the host counts as an
    ``all_gather``), over the mesh axes ``axes`` where they are known (an
    entry may be a tuple of axes: one group over their product)."""
    with _COUNT_LOCK:
        collectives[name] = collectives.get(name, 0) + 1
        collective_bytes[name] = collective_bytes.get(name, 0) + int(nbytes)
        for a in axes:
            a = axis_key(a)
            collectives_by_axis[a] = collectives_by_axis.get(a, 0) + 1
    op_counts.count_collective(name, int(nbytes), [axis_key(a) for a in axes])


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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

    def extent(self, axis) -> int:
        """An axis's extent, the product of a tuple's; 1 for ``None`` or an
        axis the mesh lacks."""
        n = 1
        for a in spec_axes(axis):
            n *= self.shape.get(a, 1)
        return n

    def coord(self, s: int, axis) -> int:
        """Slot ``s``'s index on ``axis`` (0 for ``None`` or an absent
        axis); over a tuple of axes, row-major with the first name major."""
        idx = np.unravel_index(s, self.devices.shape)
        c = 0
        for a in spec_axes(axis):
            if a in self.axis_names:
                i = self.axis_names.index(a)
                c = c * self.devices.shape[i] + int(idx[i])
        return c

    def groups(self, axis) -> List[List[int]]:
        """The slots of each group of ``axis`` (a name or a tuple of
        names): for each index of the other axes (row-major), the flat
        slots along ``axis`` in order (``coord``'s, row-major over a
        tuple)."""
        order = [self.axis_names.index(a) for a in spec_axes(axis)]
        rest = [i for i in range(self.devices.ndim) if i not in order]
        ids = np.transpose(np.arange(self.devices.size).reshape(self.devices.shape), rest + order)
        return [[int(s) for s in row] for row in ids.reshape(-1, self.extent(axis))]

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        kinds = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({dims}; {', '.join(kinds)})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cuda") -> Mesh:
    """A mesh of ``prod(shape)`` slots: slot ``i`` (row-major) is
    ``cuda:(i % torch.cuda.device_count())`` on ``device="cuda"`` (which
    raises without a card), the CPU on ``device="cpu"``, or the meta device
    on ``device="meta"`` (a dry run: shapes only)."""
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(tuple(axes)) or any(n < 1 for n in shape):
        raise ValueError(f"mesh shape {shape} does not fit axes {tuple(axes)}")
    dev = resolve_device(device)
    n = int(np.prod(shape))
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        slots = [torch.device("cuda", i % cards) for i in range(n)]
    elif dev.type in ("cpu", "meta"):
        slots = [torch.device(dev.type)] * n
    else:
        raise ValueError(f"a mesh is made of CUDA cards, the CPU or the meta device; got {dev}")
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
    count_collective("all_reduce", sum(_nbytes(p) for p in parts[1:]))
    return out


def all_reduce_over(parts: Sequence[Sequence[torch.Tensor]], axes: Sequence[str] = ()
                    ) -> List[List[torch.Tensor]]:
    """The all-reduce over one set of mesh axes (the reference's ``psum``):
    ``parts[g][s]`` is group ``g``'s partial for shard ``s``, on that
    group's device for the shard.  For each shard the G partials are added
    in group order on group 0's device, and the sum is copied back to each
    group's device (where two groups share a device they share the sum).
    Counted as one ``all_reduce`` whatever the shard count."""
    if not parts or not parts[0]:
        raise ValueError("all_reduce_over of no partials")
    if any(len(p) != len(parts[0]) for p in parts):
        raise ValueError("every group needs a partial for every shard")
    out: List[List[torch.Tensor]] = [[] for _ in parts]
    nbytes = 0
    for s in range(len(parts[0])):
        total = parts[0][s].clone()
        for g in range(1, len(parts)):
            total += parts[g][s].to(total.device)
        for g, row in enumerate(out):
            row.append(total.to(parts[g][s].device))
        nbytes += 2 * (len(parts) - 1) * _nbytes(total)
    count_collective("all_reduce", nbytes, axes)
    return out


def mean_over_groups(blocks: Sequence[Sequence[torch.Tensor]], groups: int,
                     axes: Sequence[str] = ()) -> List[List[torch.Tensor]]:
    """The f32 mean over C slabs held by ``groups`` contributor groups of
    C / G consecutive slabs: ``blocks[c][s]`` is slab ``c``'s block for
    shard ``s``, on its group's device.  Each group's partial is
    ``sum(its slabs) / C``, added in slab order, and one ``all_reduce_over``
    the groups completes the mean.  Returns G lists of S means, group
    ``g``'s on its devices."""
    C = len(blocks)
    per = C // groups
    parts = []
    for g in range(groups):
        row = []
        for s in range(len(blocks[0])):
            acc = blocks[g * per][s].float()
            for c in range(g * per + 1, (g + 1) * per):
                acc = acc + blocks[c][s].float()
            row.append(acc / C)
        parts.append(row)
    return all_reduce_over(parts, axes)


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh, device=None) -> torch.Tensor:
    """The S per-shard slices stacked ``[S, ...]`` on ``device``, the device
    of slice 0's slot (the mesh's first device by default), counted as one
    ``all_gather`` of the other S - 1 slices."""
    dev = torch.device(device) if device is not None else mesh.devices.flat[0]
    out = torch.stack([p.to(dev) for p in parts])
    count_collective("all_gather", sum(_nbytes(p) for p in parts[1:]))
    return out


# -- collectives over one named axis (the partitioned train step) ------------------------


def _group_sum(parts, group) -> torch.Tensor:
    """The group's operands added in slot order on its first slot's device
    (a missing gradient counts as zeros)."""
    live = [parts[s] for s in group if parts[s] is not None]
    total = live[0].clone()
    for p in live[1:]:
        total += p.to(total.device)
    return total


def _spread(total: torch.Tensor, group, devices, out, share: bool) -> None:
    """``total`` copied to each slot of ``group``; with ``share`` the slots
    on one device share one copy."""
    copies, kept = {}, False
    for s in group:
        dev = devices[s]
        if share and dev in copies:
            out[s] = copies[dev]
            continue
        if dev == total.device and not kept:
            t, kept = total, True
        else:
            t = total.to(dev, copy=True)
        copies[dev] = out[s] = t


@op_counts.collective_ops
def _reduce(parts, mesh: Mesh, axis: Axis, share: bool, *, count: bool = True):
    devices = list(mesh.devices.flat)
    out = [None] * len(parts)
    nbytes = 0
    for group in mesh.groups(axis):
        if all(parts[s] is None for s in group):
            continue
        total = _group_sum(parts, group)
        nbytes += 2 * (len(group) - 1) * _nbytes(total)
        _spread(total, group, devices, out, share)
    if count:
        count_collective("all_reduce", nbytes, (axis,))
    return out


@op_counts.collective_ops
def _gather(parts, mesh: Mesh, axis: Axis, dim: int, share: bool = False):
    """With ``share`` the slots of a group on one device share one copy."""
    devices = list(mesh.devices.flat)
    out = [None] * len(parts)
    nbytes = 0
    for group in mesh.groups(axis):
        copies = {}
        for s in group:
            if share and devices[s] in copies:
                out[s] = copies[devices[s]]
                continue
            out[s] = copies[devices[s]] = torch.cat([parts[g].to(devices[s]) for g in group],
                                                    dim)
        nbytes += (len(group) - 1) * sum(_nbytes(parts[g]) for g in group)
    count_collective("all_gather", nbytes, (axis,))
    return out


@op_counts.collective_ops
def _scatter(parts, mesh: Mesh, axis: Axis, dim: int):
    devices = list(mesh.devices.flat)
    out = [None] * len(parts)
    nbytes = 0
    for group in mesh.groups(axis):
        if all(parts[s] is None for s in group):
            continue
        total = _group_sum(parts, group)
        nbytes += (len(group) - 1) * _nbytes(total)
        for s, block in zip(group, total.chunk(len(group), dim)):
            out[s] = block.to(devices[s], copy=True).contiguous()
    count_collective("reduce_scatter", nbytes, (axis,))
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *parts):
        return tuple(_reduce(parts, mesh, axis, share=False))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + grads


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *parts):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(p.view_as(p) for p in parts)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(_reduce(grads, ctx.mesh, ctx.axis, share=False))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dim, *parts):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return tuple(_gather(parts, mesh, axis, dim))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(_scatter(grads, ctx.mesh, ctx.axis, ctx.dim))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dim, *parts):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        out = _scatter(parts, mesh, axis, dim)
        ctx.like = [(o.shape, o.dtype, o.device) for o in out]
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        grads = [g if g is not None else torch.zeros(shape, dtype=dtype, device=dev)
                 for g, (shape, dtype, dev) in zip(grads, ctx.like)]
        return (None, None, None) + tuple(_gather(grads, ctx.mesh, ctx.axis, ctx.dim))


def _trivial(mesh: Mesh, axis: Axis) -> bool:
    return mesh.extent(axis) == 1


def _tracked(parts) -> bool:
    return torch.is_grad_enabled() and any(p is not None and p.requires_grad for p in parts)


def axis_all_reduce(parts: Sequence[torch.Tensor], mesh: Mesh, axis: Axis
                    ) -> List[torch.Tensor]:
    """Each slot's operand replaced by the sum over its group of ``axis``
    (see the module docstring); the backward passes each slot its own
    gradient."""
    if _trivial(mesh, axis):
        return list(parts)
    if _tracked(parts):
        return list(_AllReduce.apply(mesh, axis, *parts))
    return _reduce(list(parts), mesh, axis, share=True)


def axis_sum_grads(parts: Sequence[torch.Tensor], mesh: Mesh, axis: Axis
                   ) -> List[torch.Tensor]:
    """The identity, whose backward all-reduces the slots' gradients over
    ``axis``: what a replicated input of a column-parallel product needs."""
    if _trivial(mesh, axis) or not _tracked(parts):
        return list(parts)
    return list(_SumGrads.apply(mesh, axis, *parts))


def axis_all_gather(parts: Sequence[torch.Tensor], mesh: Mesh, axis: Axis,
                    dim: int) -> List[torch.Tensor]:
    """Each slot gets its group's blocks concatenated along ``dim`` in slot
    order; the backward reduce-scatters the gradient back to the blocks.
    Untracked (serving), the slots of a group on one device share one
    copy: read it, never write it."""
    if _trivial(mesh, axis):
        return list(parts)
    if _tracked(parts):
        return list(_AllGather.apply(mesh, axis, dim, *parts))
    return _gather(list(parts), mesh, axis, dim, share=True)


def axis_reduce_scatter(parts: Sequence[torch.Tensor], mesh: Mesh, axis: Axis,
                        dim: int) -> List[torch.Tensor]:
    """The group's sum over ``axis`` split along ``dim``: slot ``i`` of
    each group keeps block ``i``; the backward all-gathers."""
    if _trivial(mesh, axis):
        return list(parts)
    if _tracked(parts):
        return list(_ReduceScatter.apply(mesh, axis, dim, *parts))
    return _scatter(list(parts), mesh, axis, dim)


@op_counts.collective_ops
def axis_all_reduce_max(parts: Sequence[torch.Tensor], mesh: Mesh, axis: Axis
                        ) -> List[torch.Tensor]:
    """The elementwise maximum over each group of ``axis`` on every slot,
    detached (a softmax's shift carries no gradient)."""
    if _trivial(mesh, axis):
        return [p.detach() for p in parts]
    devices = list(mesh.devices.flat)
    out = [None] * len(parts)
    nbytes = 0
    for group in mesh.groups(axis):
        total = parts[group[0]].detach().clone()
        for s in group[1:]:
            total = torch.maximum(total, parts[s].detach().to(total.device))
        nbytes += 2 * (len(group) - 1) * _nbytes(total)
        _spread(total, group, devices, out, share=True)
    count_collective("all_reduce", nbytes, (axis,))
    return out


@op_counts.collective_ops
def _permute(xs, devices, axis: Axis) -> List[torch.Tensor]:
    """Each of ``xs`` copied to its device in ``devices``: one
    ``"permute"`` over ``axis``, of their bytes."""
    count_collective("permute", sum(_nbytes(x) for x in xs), (axis,))
    return [x.to(dev, copy=True) for x, dev in zip(xs, devices)]


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, devices, *xs):
        ctx.axis, ctx.srcs = axis, [x.device for x in xs]
        return tuple(_permute(xs, devices, axis))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(_permute(grads, ctx.srcs, ctx.axis))


def axis_send(parts: Sequence[Optional[torch.Tensor]], mesh: Mesh, axis: Axis, src: int
              ) -> List[Optional[torch.Tensor]]:
    """Each group's slot ``src`` along ``axis`` hands its operand to slot
    ``src + 1``, on that slot's device: the returned list holds it there and
    None on every other slot.  One ``"permute"`` over ``axis``, one
    operand's bytes a group.  Where the operands are tracked (the train
    step), the backward hands each received gradient back to slot ``src``,
    one more permute; otherwise they are sent detached."""
    groups = mesh.groups(axis)
    xs = [parts[g[src]] for g in groups]
    dsts = [g[src + 1] for g in groups]
    devices = [mesh.devices.flat[d] for d in dsts]
    if _tracked(xs):
        sent = _Send.apply(axis, devices, *xs)
    else:
        sent = _permute([x.detach() for x in xs], devices, axis)
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for d, x in zip(dsts, sent):
        out[d] = x
    return out


@op_counts.collective_ops
def axis_broadcast(parts: Sequence[Optional[torch.Tensor]], mesh: Mesh, axis: Axis, src: int
                   ) -> List[torch.Tensor]:
    """Each group's slot ``src`` along ``axis`` gives its operand to every
    slot of the group (the slots on one device share one copy).  One
    ``"broadcast"`` over ``axis``, k - 1 operands' bytes a group; no
    gradient."""
    devices = list(mesh.devices.flat)
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    nbytes = 0
    for group in mesh.groups(axis):
        x = parts[group[src]].detach()
        _spread(x, group, devices, out, share=True)
        nbytes += (len(group) - 1) * _nbytes(x)
    count_collective("broadcast", nbytes, (axis,))
    return out
