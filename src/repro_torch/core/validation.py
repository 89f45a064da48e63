"""Contribution screening — the paper's §9 mitigation (port of
``repro.core.validation``): reject non-finite, no-op, over-ceiling and
MAD-outlier contributions before fusing.

``screen_norms`` decides from precomputed diff norms: the fuse kernel emits
``sq_diff[k] = ‖θ_k − base‖²`` in the same pass that fuses, so the
Repository screens without re-reading a contribution.  A non-finite
contribution surfaces as a NaN/Inf norm.  ``screen_contributions`` is the
tree-level path that computes the norms itself.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.utils.pytree import tree_isfinite, tree_sq_norm, tree_sub


@dataclass
class ScreenReport:
    accepted: List[int] = field(default_factory=list)
    rejected: List[int] = field(default_factory=list)
    reasons: dict = field(default_factory=dict)
    diff_norms: List[float] = field(default_factory=list)


def diff_norm(base, model) -> float:
    return float(torch.sqrt(tree_sq_norm(tree_sub(model, base))))


def norms_from_sq(sq) -> List[float]:
    """``sq_diff [K]`` -> diff norms.  The sqrt runs in float64 on the host:
    squaring back and forth in f32 would cost precision exactly where the
    MAD cutoff is decided."""
    if isinstance(sq, torch.Tensor):
        sq = sq.detach().cpu().double().numpy()
    return np.sqrt(np.asarray(sq, np.float64)).tolist()


def screen_norms(
    norms: Sequence[float],
    *,
    mad_threshold: float = 5.0,
    max_norm: Optional[float] = None,
    allow_zero: bool = False,
) -> ScreenReport:
    """Reject non-finite, zero-diff (unless ``allow_zero``), over-ceiling,
    and ``mad_threshold``-sigma MAD outliers (cohort of >= 3 finite)."""
    report = ScreenReport()
    norms = [float(n) for n in norms]
    finite = [bool(np.isfinite(n)) for n in norms]
    report.diff_norms = norms

    arr = np.asarray([n for n, f in zip(norms, finite) if f])
    med = float(np.median(arr)) if arr.size else 0.0
    mad = float(np.median(np.abs(arr - med))) if arr.size else 0.0
    cutoff_hi = med + mad_threshold * max(mad, 1e-12 + 0.05 * med)

    for i, (n, f) in enumerate(zip(norms, finite)):
        if not f:
            report.rejected.append(i)
            report.reasons[i] = "non-finite parameters"
        elif not allow_zero and n == 0.0:
            report.rejected.append(i)
            report.reasons[i] = "zero diff (no-op contribution)"
        elif max_norm is not None and n > max_norm:
            report.rejected.append(i)
            report.reasons[i] = f"diff norm {n:.3g} exceeds ceiling {max_norm:.3g}"
        elif len(arr) >= 3 and n > cutoff_hi:
            report.rejected.append(i)
            report.reasons[i] = f"diff norm {n:.3g} is a MAD outlier (cutoff {cutoff_hi:.3g})"
        else:
            report.accepted.append(i)
    return report


def screen_contributions(
    base,
    models: Sequence,
    *,
    mad_threshold: float = 5.0,
    max_norm: Optional[float] = None,
    allow_zero: bool = False,
) -> ScreenReport:
    """Screen trees: computes each contribution's diff norm from the trees."""
    norms = [diff_norm(base, m) if tree_isfinite(m) else float("inf") for m in models]
    return screen_norms(
        norms, mad_threshold=mad_threshold, max_norm=max_norm, allow_zero=allow_zero)
