"""Mesh-level ColD Fusion: the paper's schedule as a training strategy on a
device mesh (port of ``repro.core.distributed``).

The mesh is ("pod"?, "contrib", "replica", "model"), one process's grid of
devices (``launch.mesh``).  Every leaf of the training state gains a
leading contributor dim C (``stack_for_contributors``); placed by
``cold_shardings`` (``launch.sharding.device_put``), a stacked leaf is the
list of its C slabs, slab ``c`` on its contributor slot's replica x model
sub-grid: split into blocks over it (a ``utils.placed.Placed`` leaf) where
the sub-grid has several slots, whole on its one device where it has one;
the step counter stays one ``[C]`` tensor where slab 0 lives.

* ``make_cold_train_step``: the reference's ``jax.vmap`` of the ordinary
  train step becomes ``train.step.make_train_step`` applied to each slab
  — partitioned over its sub-grid (tensor parallel over ``model``, data
  parallel and FSDP over ``replica``) where it is placed in blocks, on its
  device where it is whole — the same numbers per slab, and no collective
  across contributors;
* ``make_fuse_step``: θ_c ← θ_c + α·(mean_c θ_c − θ_c) over the
  contributor dim, the only traffic that crosses the contributor axes:
  one all-reduce (``ops.cohort_fuse_sharded`` over one flat ``[C, N]``
  buffer laid out block-cyclically over the replica x model axes; one a
  leaf on the default per-leaf path) every H local steps, against a
  gradient all-reduce every step for synchronous data parallelism —
  2·P/H bytes a step against 2·P (``launch.mesh.collective_bytes`` counts
  them; ``collectives_by_axis`` counts the fuse's all-reduces under the
  contributor axes and every collective of a partitioned local step under
  ``replica`` or ``model``).

Every function also takes an unplaced stacked state (``[C, ...]`` tensors
on one device), as the reference's functions run without shardings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.step import make_train_step
from repro_torch.utils.flat import ShardedFlatSpec
from repro_torch.utils.placed import Placed
from repro_torch.utils.pytree import tree_leaves, tree_leaves_with_path, tree_map, \
    tree_map_with_name


@dataclass(frozen=True)
class ColdSchedule:
    """Hyper-parameters of the fuse.  The reference's dataclass also carries
    ``fusion_interval`` and ``reset_opt_on_fuse``, which no code of it
    reads: the caller runs H local steps between fuses and keeps or resets
    its optimizer state itself, so the port leaves both out."""

    alpha: float = 1.0  # damped-fusion coefficient (1.0 = paper)


def contrib_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in SH.CONTRIB_AXES if a in mesh.axis_names)


def num_contributors(mesh: Mesh) -> int:
    n = 1
    for a in contrib_axes_of(mesh):
        n *= mesh.shape[a]
    return n


def shard_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    """Axes the flat fuse buffer is block-cyclically sharded over (the
    non-contributor part of the ColD mesh)."""
    return tuple(a for a in ("replica", "model") if a in mesh.axis_names)


def stack_for_contributors(tree, n: int):
    """Broadcast a tree to a leading contributor dim of size ``n``: each
    tensor leaf becomes a ``[n, ...]`` copy, and a Python int (the
    optimizer's step) an ``[n]`` int32 tensor, as the reference's step is."""
    tensors = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    dev = tensors[0].device if tensors else torch.device("cpu")

    def stack(x):
        if isinstance(x, int):
            return torch.full((n,), x, dtype=torch.int32, device=dev)
        return x.unsqueeze(0).expand((n,) + tuple(x.shape)).clone()

    return tree_map(stack, tree)


def _slab_leaf(x, c: int):
    if isinstance(x, list):  # placed: the list of slabs
        return x[c]
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)[c]
    s = x[c]
    return int(s) if s.dim() == 0 and not s.is_floating_point() else s


def slab(tree, c: int):
    """Contributor ``c``'s slab of a stacked or placed tree (a view where
    the slab is a slice of a stacked tensor; an integer step as an int)."""
    return tree_map(lambda x: _slab_leaf(x, c), tree)


def _restack(like, slabs):
    """Per-slab trees put back in ``like``'s form: a placed leaf as the list
    of the slabs' leaves, a stacked one as one ``[C, ...]`` tensor on its
    device."""
    per_slab = [dict(tree_leaves_with_path(s)) for s in slabs]

    def build(name, leaf):
        vals = [p[name] for p in per_slab]
        if isinstance(leaf, list):
            return vals
        if not isinstance(vals[0], torch.Tensor):
            return torch.tensor(vals, dtype=leaf.dtype, device=leaf.device)
        return torch.stack([v.to(leaf.device) for v in vals])

    return tree_map_with_name(build, like)


def _n_slabs(tree) -> int:
    first = tree_leaves(tree)[0]
    return len(first) if isinstance(first, list) else first.shape[0]


def make_cold_train_step(cfg: ArchConfig, optimizer: Optimizer, *,
                         microbatches: int = 1) -> Callable:
    """The local step over the leading contributor dim: ``(state, batch)
    -> (state, metrics)`` with ``batch = {"tokens": [C, B_local, S], ...}``.
    Slab ``c`` takes ``make_train_step``'s step with its own batch: on its
    device where it is whole, partitioned over its contributor slot's
    replica x model sub-grid where it is placed in blocks (the collectives
    of that step run within the sub-grid).  The state comes back in the
    form it came in (placed or stacked) and each metric as a ``[C]`` tensor
    on slab 0's device.  No collective crosses the contributor axes: a
    contributor's gradients never leave its slot."""
    local = make_train_step(cfg, optimizer, microbatches=microbatches)

    def cold_step(state, batch):
        C = _n_slabs(state)
        outs, metrics = [], []
        for c in range(C):
            new, m = local(slab(state, c), slab(batch, c))
            outs.append(new)
            metrics.append(m)
        dev = metrics[0]["loss"].device
        return _restack(state, outs), {k: torch.stack([m[k].to(dev) for m in metrics])
                                       for k in metrics[0]}

    return cold_step


def make_fuse_step(cfg: ArchConfig, mesh: Mesh, schedule: ColdSchedule, *,
                   flat: bool = False) -> Callable:
    """The Repository collective over a stacked or placed params tree:
    θ_c ← θ_c + α·(mean_c θ_c − θ_c) for every slab ``c``.

    ``flat=True``, on a mesh with a contributor axis, fuses ONE flat f32
    buffer: each slab's leaves are flattened on its device (a slab placed
    in blocks is first gathered to its slot 0's device: one ``all_gather``
    a slab, within its replica x model slots), laid out block-cyclically
    over the replica x model axes (``ShardedFlatSpec``), fused by
    ``ops.cohort_fuse_sharded`` with one all-reduce over the contributor
    axes, then each slab's fused blocks are gathered back to its slot (one
    ``all_gather`` a slab) and split into leaves of their own dtypes, a
    placed slab's into its blocks again.

    ``flat=False`` (the default), and any mesh without a contributor axis,
    takes the per-leaf path: each leaf's mean over the contributor dim in
    f32 (one all-reduce a leaf when the slabs are placed over the
    contributor axes, its shards the leaf's stored blocks, so a block
    replicated over a card's slots is fused once; none for a stacked
    tensor on one device).  The
    reference defaults to the flat path; here its copies (stage, layout,
    gather, unshard) cost more than the per-leaf path's leaf-by-leaf
    traffic, at gemma3-1b's width 2-4x on one card and 2-9x with the slabs
    on two cards (PERF.md, phase 16).  ``cfg`` is unused, as in the
    reference."""
    del cfg
    alpha = float(schedule.alpha)
    contrib = contrib_axes_of(mesh)

    def leaf_fuse(x):
        if isinstance(x, list):
            G = num_contributors(mesh)
            if isinstance(x[0], Placed):
                keys = {xc.layout.slot_key for xc in x}
                if len(keys) != 1:
                    raise ValueError("slabs whose blocks share devices differently")
                means = M.mean_over_groups([xc.blocks for xc in x], G, contrib)
                return [xc.with_blocks([ops.relax(b, mu, alpha) for b, mu in
                                        zip(xc.blocks, means[c // (len(x) // G)])])
                        for c, xc in enumerate(x)]
            means = M.mean_over_groups([[xc] for xc in x], G, contrib)
            return [ops.relax(xc, means[c // (len(x) // G)][0], alpha)
                    for c, xc in enumerate(x)]
        mean = x.float().sum(0, keepdim=True) / x.shape[0]
        return ops.relax(x, mean, alpha).expand(x.shape).contiguous()

    def fuse_per_leaf(params):
        return tree_map(leaf_fuse, params)

    if not (flat and contrib):
        # no contributor axis (a plain data/model mesh): nothing to fuse over
        # a mesh dim; the per-leaf reduction handles any mesh
        return fuse_per_leaf
    shard_axes = shard_axes_of(mesh)
    n_shards = SH.axes_extent(mesh, shard_axes) if shard_axes else 1

    def fuse_flat(params):
        leaves = tree_leaves(params)
        names = [k for k, _ in tree_leaves_with_path(params)]
        C = _n_slabs(params)
        firsts = [_slab_leaf(x, 0) for x in leaves]
        shapes = [tuple(x.shape) for x in firsts]
        dtypes = [x.dtype for x in firsts]
        sizes = [x.numel() for x in firsts]
        sspec = ShardedFlatSpec.for_size(sum(sizes), n_shards)
        stage, homes = [], []
        for c in range(C):
            parts = [_slab_leaf(x, c) for x in leaves]
            placed = [p for p in parts if isinstance(p, Placed)]
            if placed:  # the slab's blocks gathered to its slot 0's device first
                M.count_collective("all_gather", sum(SH.gather_bytes(p) for p in placed),
                                   shard_axes)
                parts = [p.whole() if isinstance(p, Placed) else p for p in parts]
            homes.append(parts[0].device)
            row = torch.cat([p.reshape(-1).float() for p in parts])
            stage.append(sspec.shard(row))
            del row, parts
        fused = ops.cohort_fuse_sharded(stage, mesh=mesh, contrib_axes=contrib,
                                        shard_axes=shard_axes, alpha=alpha)
        del stage
        slabs = []
        for c in range(C):
            row = sspec.unshard(M.all_gather(fused[c], mesh, device=homes[c]))
            fused[c] = None
            outs, off = {}, 0
            for name, x, shape, dtype, n in zip(names, leaves, shapes, dtypes, sizes):
                v = row[off:off + n].view(shape).to(dtype)
                like = _slab_leaf(x, c)
                outs[name] = (Placed.split(v, like.layout.spec, like.layout.mesh)
                              if isinstance(like, Placed) else v)
                off += n
            del row
            slabs.append(outs)
        return _restack(params, slabs)

    return fuse_flat


def cold_shardings(mesh: Mesh, cfg: ArchConfig, state, batch):
    """The full (state, batch) ``NamedSharding`` trees, as the reference
    gives them to ``jax.jit``; ``launch.sharding.device_put`` places a
    stacked state and batch by them."""
    contrib = contrib_axes_of(mesh)
    contrib_spec: Tuple = (contrib if len(contrib) > 1 else contrib[0],)
    params_sh = SH.params_shardings(mesh, state["params"], cfg, data_axis="replica",
                                    model_axis="model", contrib_axes=contrib_spec)
    opt_sh = SH.opt_state_shardings(mesh, state["opt"], params_sh)
    batch_sh = SH.batch_shardings(mesh, batch, data_axis="replica", contrib_axes=contrib_spec)
    return {"params": params_sh, "opt": opt_sh}, batch_sh
