"""Optimizers and learning-rate schedules as plain functions over dict trees
(port of ``repro.optim.optimizers``; not ``torch.optim``, so each update is
the reference's to the operation): SGD (with momentum), AdamW and
Adafactor.  Each also updates a partitioned step's placed leaves
(``utils.placed.Placed``): SGD and AdamW block by block, Adafactor with
whole replicated statistics (``adafactor``).

``opt = make_optimizer(name, schedule)`` has ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; updates are added to
the params by the caller.  The learning rate is ``schedule(step)`` read
before the step count advances; AdamW's weight decay applies to every leaf
inside the update; every update is cast to the parameter dtype.  Scalars
the reference computes in f32 (bias corrections, Adafactor's decay) are
computed in f32 here too.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch import mesh as M
from repro_torch.utils import op_counts as _oc
from repro_torch.utils.placed import Layout, Placed
from repro_torch.utils.pytree import (tree_from_paths, tree_leaves, tree_leaves_with_path,
                                      tree_map)

Schedule = Callable[[int], float]


def constant_lr(lr: float) -> Schedule:
    return lambda step: lr


def linear_decay_lr(lr: float, decay_per_step: float, min_lr: float = 0.0) -> Schedule:
    """Paper App. B: linear decay."""
    return lambda step: max(lr * (1.0 - decay_per_step * step), min_lr)


def warmup_cosine_lr(lr: float, warmup: int, total: int, min_frac: float = 0.1) -> Schedule:
    def sched(step):
        if step < warmup:
            return lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return lr * (min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * prog)))

    return sched


def global_norm(tree, axes: Optional[Sequence] = None) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in f32, summed leaf by leaf in tree order.  A
    placed leaf (``utils.placed.Placed``) adds each logical block once, in
    block order, whatever the slots and devices that hold it; the partial
    sums meet on the first leaf's device, one all-reduce over the grid
    (``launch.mesh``) for the whole tree: over ``axes``, by default every
    axis of the grid (a partitioned step names its batch axes, a name or a
    tuple counted as one group, and its model axis, so that an axis it
    replicates is crossed by none)."""
    leaves = tree_leaves(tree)
    placed = [x for x in leaves if isinstance(x, Placed)]
    if not placed:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))
    dev = leaves[0].device
    total = None
    for x in leaves:
        parts = ([x.blocks[u] for u in x.layout.logical_blocks()] if isinstance(x, Placed)
                 else [x])
        for p in parts:
            sq = torch.sum(torch.square(p.float())).to(dev)
            total = sq if total is None else total + sq
    grid = placed[0].layout.mesh
    axes = grid.axis_names if axes is None else tuple(axes)
    k = int(np.prod([grid.extent(a) for a in axes]))
    M.count_collective("all_reduce", grid.devices.size // k * 2 * (k - 1) * 4, axes)
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float, axes: Optional[Sequence] = None):
    """Scale the whole tree by min(1, max_norm / (‖tree‖ + 1e-9)) (a placed
    tree block by block, the scale copied to each block's device);
    ``axes``: ``global_norm``'s."""
    g = global_norm(tree, axes)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(device=x.device, dtype=x.dtype), tree), g


@torch.no_grad()
def clipped_step(opt, params, opt_state, grads, max_norm: float = 1.0):
    """The reference's training step after the gradients: clip ``grads``
    (one per leaf of ``params``, in tree order) by global norm, take
    ``opt``'s update and add it to ``params`` in place.  Returns the new
    optimizer state."""
    paths = [path for path, _ in tree_leaves_with_path(params)]
    grad_tree, _ = clip_by_global_norm(tree_from_paths(zip(paths, grads)), max_norm)
    updates, opt_state = opt.update(grad_tree, opt_state, params)
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u)
    return opt_state


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)
    name: str = ""


def sgd(schedule: Schedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        state = {"step": 0}
        if momentum:
            state["mom"] = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params)
        return state

    def update(grads, state, params):
        lr = schedule(state["step"])
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g.float(), state["mom"], grads)
            upd = tree_map(lambda m, p: (-lr * m).to(p.dtype), mom, params)
            return upd, {"step": state["step"] + 1, "mom": mom}
        upd = tree_map(lambda g, p: (-lr * g.float()).to(p.dtype), grads, params)
        return upd, {"step": state["step"] + 1}

    return Optimizer(init, update, "sgd")


def adamw(schedule: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        zeros = lambda: tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params)
        return {"step": 0, "m": zeros(), "v": zeros()}

    def update(grads, state, params):
        step = state["step"] + 1
        lr = schedule(state["step"])
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state["v"], grads)
        # bias corrections in f32, as the reference computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))

        def upd(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.float()
            return (-lr * u).to(p.dtype)

        return tree_map(upd, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update, "adamw")


def _replicated_zeros(x: Placed, shape) -> Placed:
    """f32 zeros of ``shape`` replicated on ``x``'s grid (the spec ``P()``:
    one block a device)."""
    lay = Layout(shape, (), x.layout.mesh)
    return Placed(lay, [torch.zeros(shape, dtype=torch.float32, device=dev)
                        for dev in lay.devices])


def _stat(s) -> torch.Tensor:
    """A statistic's whole value: a tensor, or a replicated placed leaf's
    first block (every block holds the same)."""
    return s.blocks[0] if isinstance(s, Placed) else s


def _with_stat(s, value: torch.Tensor):
    """``value`` stored as ``s`` is: in place of a tensor, or copied to
    each device of a replicated placed leaf (once a device)."""
    if not isinstance(s, Placed):
        return value
    return s.with_blocks([value if dev == value.device else value.to(dev, copy=True)
                          for dev in s.layout.devices])


def _count_over(x: Placed, name: str, stat_bytes: int):
    """Count one ``name`` collective of a statistic over the axes that split
    placed leaf ``x`` (each group of slots those axes span), where any do."""
    lay = x.layout
    axes = tuple(a for a in lay.mesh.axis_names if lay.splits_over(a) and lay.mesh.extent(a) > 1)
    if not axes:
        return
    k = int(np.prod([lay.mesh.extent(a) for a in axes]))
    groups = lay.n_slots // k
    per = 2 * (k - 1) * stat_bytes if name == "all_reduce" else (k - 1) * stat_bytes
    M.count_collective(name, groups * per, axes)


def adafactor(schedule: Schedule, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern 2018), no momentum.
    A leaf of rank >= 2 keeps row and column means of g² (``vr`` over the
    last axis, ``vc`` over the one before) instead of the whole ``v``; each
    leaf's update is clipped to RMS ``clip_threshold``.

    Over a placed leaf (``utils.placed.Placed``) the statistics are whole
    and replicated, as the reference's ``opt_state_shardings`` places them
    (``P()``: no parameter matches ``v/<path>/vr``), one block a device.
    Each logical block of the gradient adds its partial row sums and
    column sums of g² into the whole ``vr``/``vc`` (one counted all-reduce
    each over the axes that split the leaf); a rank-1 leaf's g² is
    all-gathered whole (counted).  The statistics are blended once a leaf,
    not once a slot, and copied to each device; ``rfac``/``cfac`` are
    sliced to each block's rows and columns; the RMS clip sums u² over each
    logical block once, one counted all-reduce."""

    def factored(x):
        return x.ndim >= 2

    def init(params):
        def leaf_state(x):
            if factored(x):
                shapes = {"vr": x.shape[:-1], "vc": x.shape[:-2] + x.shape[-1:]}
            else:
                shapes = {"v": x.shape}
            if isinstance(x, Placed):
                return {k: _replicated_zeros(x, shape) for k, shape in shapes.items()}
            return {k: torch.zeros(shape, dtype=torch.float32, device=x.device)
                    for k, shape in shapes.items()}

        def walk(x):  # a placed leaf's state is whole, not mapped block by block
            return {k: walk(v) for k, v in x.items()} if isinstance(x, dict) else leaf_state(x)

        return {"step": 0, "v": walk(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr = schedule(state["step"])
        f32 = np.float32
        beta = f32(1) - (f32(step) + f32(1)) ** f32(-decay)
        keep, mix = float(beta), float(f32(1) - beta)

        def clip(u, rms):
            return u / torch.clamp(rms / clip_threshold, min=1.0)

        def upd(g, s, p):
            gf = g.float()
            g2 = torch.square(gf) + eps
            if factored(g):
                vr = keep * s["vr"] + mix * torch.mean(g2, dim=-1)
                vc = keep * s["vc"] + mix * torch.mean(g2, dim=-2)
                rfac = torch.rsqrt(vr / torch.mean(vr, dim=-1, keepdim=True) + eps)
                cfac = torch.rsqrt(vc + eps)
                u = gf * rfac[..., None] * cfac[..., None, :]
                new_s = {"vr": vr, "vc": vc}
            else:
                v = keep * s["v"] + mix * g2
                u = gf * torch.rsqrt(v + eps)
                new_s = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            return (-lr * clip(u, rms)).to(p.dtype), new_s

        def upd_placed(g: Placed, s, p: Placed):
            lay, shape = g.layout, tuple(g.shape)
            logical = lay.logical_blocks()
            dev = _stat(next(iter(s.values()))).device
            parts = {lay.block_index[u]: (lay.slices(lay.block_index[u]), g.blocks[u].float())
                     for u in logical}
            if factored(g):
                row, col = (torch.zeros(shape[:-1], device=dev),
                            torch.zeros(shape[:-2] + shape[-1:], device=dev))
                for sl, gf in parts.values():
                    g2 = torch.square(gf) + eps
                    row[sl[:-1]] += g2.sum(-1).to(dev)
                    col[sl[:-2] + sl[-1:]] += g2.sum(-2).to(dev)
                _count_over(g, "all_reduce", row.numel() * 4)
                _count_over(g, "all_reduce", col.numel() * 4)
                vr = keep * _stat(s["vr"]) + mix * (row / shape[-1])
                vc = keep * _stat(s["vc"]) + mix * (col / shape[-2])
                rfac = torch.rsqrt(vr / torch.mean(vr, dim=-1, keepdim=True) + eps)
                cfac = torch.rsqrt(vc + eps)
                new_s = {"vr": _with_stat(s["vr"], vr), "vc": _with_stat(s["vc"], vc)}

                def u_of(sl, gf):
                    return (gf * rfac[sl[:-1]][..., None].to(gf.device)
                            * cfac[sl[:-2] + sl[-1:]][..., None, :].to(gf.device))
            else:
                whole = torch.empty(shape, device=dev)
                for sl, gf in parts.values():
                    whole[sl] = (torch.square(gf) + eps).to(dev)
                with _oc.operand_split():   # the whole g², k - 1 of its k blocks a slot
                    _count_over(g, "all_gather", whole.numel() * 4)
                v = keep * _stat(s["v"]) + mix * whole
                new_s = {"v": _with_stat(s["v"], v)}

                def u_of(sl, gf):
                    return gf * torch.rsqrt(v[sl] + eps).to(gf.device)

            us = {idx: u_of(sl, gf) for idx, (sl, gf) in parts.items()}
            sq = sum(torch.sum(torch.square(u)).to(dev) for u in us.values())
            _count_over(g, "all_reduce", 4)
            rms = torch.sqrt(sq / g.numel() + eps)
            blocks = []
            for u, b in enumerate(p.blocks):
                x = us[lay.block_index[u]].to(b.device)
                blocks.append((-lr * clip(x, rms.to(b.device))).to(b.dtype))
            return p.with_blocks(blocks), new_s

        def walk(g, s, p):
            """(updates, new state) over one subtree; a tensor of the grads
            is a leaf, whose state is a dict of its own."""
            if not isinstance(g, dict):
                return upd_placed(g, s, p) if isinstance(g, Placed) else upd(g, s, p)
            pairs = {k: walk(g[k], s[k], p[k]) for k in g}
            return ({k: u for k, (u, _) in pairs.items()},
                    {k: ns for k, (_, ns) in pairs.items()})

        updates, new_v = walk(grads, state["v"], params)
        return updates, {"step": step, "v": new_v}

    return Optimizer(init, update, "adafactor")


def make_optimizer(name: str, schedule: Schedule, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(schedule, **kw)
    if name == "adamw":
        return adamw(schedule, **kw)
    if name == "adafactor":
        return adafactor(schedule, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
