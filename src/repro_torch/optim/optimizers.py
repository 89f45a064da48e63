"""AdamW and learning-rate schedules as plain functions over dict trees
(port of ``repro.optim.optimizers``; not ``torch.optim``, so the update is
the reference's to the operation).

``opt = adamw(schedule)`` has ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; updates are added to
the params by the caller.  The learning rate is ``schedule(step)`` read
before the step count advances; weight decay applies to every leaf inside
the update; the update is cast to the parameter dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

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


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in f32, summed leaf by leaf in tree order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """Scale the whole tree by min(1, max_norm / (‖tree‖ + 1e-9))."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), g


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
