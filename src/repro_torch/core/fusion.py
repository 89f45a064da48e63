"""Model fusion operators — the Repository's fuse step (paper §3), port of
``repro.core.fusion``.  Three operators are one ``cold_fuse`` launch over
the whole flattened model (``kernels.ops.fuse_pytrees``):

* ``average``         — the paper's uniform (or weighted) parameter average;
* ``damped``          — θ + α·(average − θ), the §8 step-size lever;
* ``task_arithmetic`` — θ + λ·Σ_c (θ_c − θ) (Ilharco et al., 2022).

Two are plain PyTorch per leaf, as in the reference (plain XLA there):

* ``fisher_weighted`` — per-parameter precision weighting (Matena & Raffel
  2021) with contributor-supplied diagonal Fishers;
* ``ties``            — TIES-merging (Yadav et al., 2023): trim each task
  delta to its largest magnitudes, elect a sign per parameter, average the
  survivors that agree with it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import ops as _ops
from repro_torch.utils.pytree import tree_map


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


def fisher_weighted(models: Sequence, fishers: Sequence, eps: float = 1e-8):
    """θ* = (Σ F_c ⊙ θ_c) / (Σ F_c + eps) per leaf, in f32, cast back to the
    leaf's dtype; ``fishers`` are diagonal Fisher (or any positive
    importance) trees shaped like the models."""
    _check(models)
    if len(fishers) != len(models):
        raise ValueError("need one fisher per model")

    def fuse(*leaves):
        n = len(leaves) // 2
        thetas, fs = leaves[:n], leaves[n:]
        num = sum(t.float() * f.float() for t, f in zip(thetas, fs))
        den = sum(f.float() for f in fs) + eps
        return (num / den).to(thetas[0].dtype)

    return tree_map(fuse, *(list(models) + list(fishers)))


def ties_threshold(magnitudes: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest of a flat tensor, exactly (a selection, no
    arithmetic): the least of ``topk``'s unsorted k values.  On the card
    ``topk`` selects with a radix select spread over many blocks; the
    alternative ``kthvalue(n - k + 1)`` gives the same value but runs one
    block per slice, and the whole leaf is one slice."""
    return torch.topk(magnitudes, k, sorted=False).values.min()


def ties_trim(delta: torch.Tensor, density: float) -> torch.Tensor:
    """Keep the ``max(1, int(density · numel))`` largest |δ| of one leaf's
    delta (``>=`` the threshold, so equal magnitudes all stay); zero the
    rest."""
    mag = torch.abs(delta)
    k = max(1, int(density * mag.numel()))
    return torch.where(mag >= ties_threshold(mag.reshape(-1), k), delta, 0.0)


def ties(base, models: Sequence, density: float = 0.2, lam: float = 1.0):
    """TIES-merging per leaf: trim each delta from the base to its top
    ``density`` fraction by magnitude, elect the sign of the trimmed sum
    (``sign(0) = 0``), average the trimmed deltas that agree with it (the
    count clamped at 1) and apply with scale λ.  Sums run in list order."""
    _check(models)

    def fuse(b, *ts):
        bf = b.float()
        trimmed = [ties_trim(t.float() - bf, density) for t in ts]
        sign = torch.sign(sum(trimmed))
        keep = [torch.where(torch.sign(d) == sign, d, 0.0) for d in trimmed]
        cnt = sum(torch.where(k != 0.0, 1.0, 0.0) for k in keep)
        merged = sum(keep) / torch.clamp(cnt, min=1.0)
        return (bf + lam * merged).to(b.dtype)

    return tree_map(fuse, base, *models)


def task_arithmetic(base, models: Sequence, lam: float = 1.0):
    """θ' = θ + λ·Σ_c (θ_c − θ) == θ + (λ·K)·(mean − θ): one kernel pass."""
    _check(models)
    fused, _ = _ops.fuse_pytrees(base, models, None, float(lam) * len(models))
    return fused


FUSION_OPS = {
    "average": lambda base, models, **kw: average(models, **kw),
    "damped": damped,
    "task_arithmetic": task_arithmetic,
    "ties": ties,
}


def fuse(name: str, base, models: Sequence, **kw):
    """Dispatch by operator name; ``"fisher"`` takes ``fishers=``."""
    if name == "fisher":
        return fisher_weighted(models, kw.pop("fishers"), **kw)
    try:
        op = FUSION_OPS[name]
    except KeyError:
        raise KeyError(f"unknown fusion op {name!r}; known: {sorted(FUSION_OPS)} + "
                       "['fisher']") from None
    return op(base, models, **kw)
