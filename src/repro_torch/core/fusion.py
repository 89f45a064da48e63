"""Model fusion operators — the Repository's fuse step (paper §3), port of
``repro.core.fusion``.  Every operator here is one ``cold_fuse`` launch over
the whole flattened model (``kernels.ops.fuse_pytrees``):

* ``average``         — the paper's uniform (or weighted) parameter average;
* ``damped``          — θ + α·(average − θ), the §8 step-size lever;
* ``task_arithmetic`` — θ + λ·Σ_c (θ_c − θ) (Ilharco et al., 2022).

``fisher_weighted`` and ``ties`` are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.kernels import ops as _ops


def _check(models: Sequence):
    if not models:
        raise ValueError("fusion requires at least one model")


def _check_weights(models: Sequence, weights: Optional[Sequence[float]]):
    if weights is None:
        return
    if len(weights) != len(models):
        raise ValueError("len(weights) != len(models)")
    if float(sum(weights)) <= 0:
        raise ValueError("weights must sum to a positive value")


def average(models: Sequence, weights: Optional[Sequence[float]] = None):
    """Uniform (paper §3) or weighted parameter average."""
    _check(models)
    _check_weights(models, weights)
    # α=1 makes the fuse independent of the base operand: reuse models[0]
    fused, _ = _ops.fuse_pytrees(models[0], models, weights, 1.0)
    return fused


def damped(base, models: Sequence, alpha: float = 1.0,
           weights: Optional[Sequence[float]] = None):
    """θ' = θ + α·(average(models) − θ)."""
    _check(models)
    _check_weights(models, weights)
    fused, _ = _ops.fuse_pytrees(base, models, weights, float(alpha))
    return fused


def task_arithmetic(base, models: Sequence, lam: float = 1.0):
    """θ' = θ + λ·Σ_c (θ_c − θ) == θ + (λ·K)·(mean − θ): one kernel pass."""
    _check(models)
    fused, _ = _ops.fuse_pytrees(base, models, None, float(lam) * len(models))
    return fused


FUSION_OPS = {
    "average": lambda base, models, **kw: average(models, **kw),
    "damped": damped,
    "task_arithmetic": task_arithmetic,
}


def fuse(name: str, base, models: Sequence, **kw):
    """Dispatch by operator name."""
    try:
        op = FUSION_OPS[name]
    except KeyError:
        raise KeyError(f"unknown fusion op {name!r}; known: {sorted(FUSION_OPS)}") from None
    return op(base, models, **kw)
