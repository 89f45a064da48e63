"""Mesh-level ColD Fusion: the paper's schedule as a training strategy on a
device mesh (port of ``repro.core.distributed``).

The mesh is ("pod"?, "contrib", "replica", "model"), one process's grid of
devices (``launch.mesh``).  Every leaf of the training state gains a
leading contributor dim C (``stack_for_contributors``); placed by
``cold_shardings`` (``launch.sharding.device_put``), a stacked leaf is the
list of its C slabs, slab ``c`` whole on the device of its contributor
slot, and the step counter stays one ``[C]`` tensor where slab 0 lives.

* ``make_cold_train_step``: the reference's ``jax.vmap`` of the ordinary
  train step becomes ``train.step.make_train_step`` applied to each slab
  on that slab's device — the same numbers per slab, and no collective
  across contributors;
* ``make_fuse_step``: θ_c ← θ_c + α·(mean_c θ_c − θ_c) over the
  contributor dim, the only traffic that crosses the contributor axes:
  one all-reduce (``ops.cohort_fuse_sharded`` over one flat ``[C, N]``
  buffer laid out block-cyclically over the replica x model axes; one a
  leaf on the default per-leaf path) every H local steps, against a
  gradient all-reduce every step for synchronous data parallelism —
  2·P/H bytes a step against 2·P (``launch.mesh.collective_bytes`` counts
  them).

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
    Slab ``c`` takes ``make_train_step``'s step on its own device with its
    own batch; the state comes back in the form it came in (placed or
    stacked) and each metric as a ``[C]`` tensor on slab 0's device.  No
    collective: a contributor's gradients never leave its slot."""
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
    buffer: each slab's leaves are flattened on its device, laid out
    block-cyclically over the replica x model axes (``ShardedFlatSpec``),
    fused by ``ops.cohort_fuse_sharded`` with one all-reduce over the
    contributor axes, then each slab's fused blocks are gathered back to
    its slot (one ``all_gather`` a slab, within its replica x model slots)
    and split into leaves of their own dtypes.

    ``flat=False`` (the default), and any mesh without a contributor axis,
    takes the per-leaf path: each leaf's mean over the contributor dim in
    f32 (one all-reduce a leaf when the slabs are placed over the
    contributor axes; none for a stacked tensor on one device).  The
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
            means = M.mean_over_groups([[xc] for xc in x], G)
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
        C = _n_slabs(params)
        firsts = [_slab_leaf(x, 0) for x in leaves]
        shapes = [x.shape for x in firsts]
        dtypes = [x.dtype for x in firsts]
        sizes = [x.numel() for x in firsts]
        sspec = ShardedFlatSpec.for_size(sum(sizes), n_shards)
        stage, homes = [], []
        for c in range(C):
            parts = [_slab_leaf(x, c) for x in leaves]
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
            outs, off = [], 0
            for shape, dtype, n in zip(shapes, dtypes, sizes):
                outs.append(row[off:off + n].view(shape).to(dtype))
                off += n
            slabs.append(dict(zip([k for k, _ in tree_leaves_with_path(params)], outs)))
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
