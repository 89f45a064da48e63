"""The central Repository (paper Fig. 1): a versioned base-model store that
accepts contributions, screens them (§9), fuses them (§3) and publishes the
next base.  Port of the in-memory, single-device flat engine of
``repro.core.repository``.

``upload`` folds each contribution into a flat ``[N]`` staging row at once
(the tree is released).  ``fuse_pending`` stacks the cohort to ``[K, N]`` and
screens + fuses it in ONE streaming pass: ``cold_fuse`` emits the fused row
and each contributor's ``sq_diff``; the §9 MAD screen runs on those norms,
and rejected contributors get weight 0 in a second pass over the
already-staged buffer (the kernel masks zero-weight rows by a select, so a
NaN row adds nothing).

The published base (``download()``) is a tree of views into the fused row,
which is also the ``base`` operand of the next fuse: callers must not update
it in place (``train.finetune`` clones what it trains).

Not ported yet: on-disk roots and spill, meshes, ``wait=False``, and the
per-leaf engine for ``fisher``/``ties``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core.validation import ScreenReport, norms_from_sq, screen_norms
from repro_torch.kernels import ops
from repro_torch.utils.flat import FlatSpec, StagedBuffer

# operators the flat engine covers
FLAT_OPS = ("average", "damped", "task_arithmetic")


@dataclass
class FusionRecord:
    iteration: int
    n_contributions: int
    n_accepted: int
    op: str
    diff_norms: List[float]
    wall_time: float


class Repository:
    def __init__(
        self,
        base_params,
        *,
        fusion_op: str = "average",
        fusion_kwargs: Optional[Dict[str, Any]] = None,
        screen: bool = True,
        mad_threshold: float = 5.0,
        keep_history: bool = False,
    ):
        if fusion_op not in FLAT_OPS:
            raise ValueError(f"fusion_op={fusion_op!r} is not ported; "
                             f"the port fuses {FLAT_OPS}")
        self.fusion_op = fusion_op
        self.fusion_kwargs = dict(fusion_kwargs or {})
        self.screen = screen
        self.mad_threshold = mad_threshold
        self.keep_history = keep_history
        self.iteration = 0
        self.history: List[FusionRecord] = []
        self._snapshots: List[Any] = []
        self._spec = FlatSpec.from_tree(base_params)
        self._base_flat = self._spec.flatten(base_params)
        self._base = self._spec.unflatten(self._base_flat)
        self._rows: List[torch.Tensor] = []
        self._weights: List[Optional[float]] = []

    def download(self):
        """Contributor pulls the current base model (Fig. 1, step 1): a
        tree of views into the published flat row — read-only by contract."""
        return self._base

    def upload(self, params, weight: Optional[float] = None) -> int:
        """Contributor pushes a finetuned body (Fig. 1, step 3), optionally
        with a contribution weight.  Returns the ticket id."""
        row = self._spec.flatten(params)
        if row.device != self._base_flat.device:
            raise ValueError(f"upload on {row.device}; the repository lives on "
                             f"{self._base_flat.device}")
        self._rows.append(row)
        self._weights.append(weight)
        return len(self._rows) - 1

    def fuse_pending(self) -> FusionRecord:
        """Screen + fuse the staged cohort into the new base (Fig. 1,
        step 4) and publish it."""
        if not self._rows:
            raise RuntimeError("no contributions to fuse")
        t0 = time.time()
        K = len(self._rows)
        stage = StagedBuffer.from_rows(self._rows)
        w = self._cohort_weights(K, self._weights)
        fused, sq = ops.fuse_flat(self._base_flat, stage, w, self._flat_alpha(K),
                                  donate=not self.screen)
        report: Optional[ScreenReport] = None
        n_accepted = K
        if self.screen:
            report = screen_norms(norms_from_sq(sq), mad_threshold=self.mad_threshold)
            n_accepted = len(report.accepted)
            if not report.accepted:
                raise RuntimeError(f"all contributions rejected: {report.reasons}")
            if report.rejected:
                w2 = w.clone()
                w2[report.rejected] = 0.0
                fused, _ = ops.fuse_flat(self._base_flat, stage, w2,
                                         self._flat_alpha(n_accepted), donate=True)
        # published from here on: a fuse that raised above left the cohort
        # staged, to be retried with the next uploads
        self._rows, self._weights = [], []
        del stage
        rec = FusionRecord(
            iteration=self.iteration,
            n_contributions=K,
            n_accepted=n_accepted,
            op=self.fusion_op,
            diff_norms=report.diff_norms if report else [],
            wall_time=time.time() - t0,
        )
        if self.keep_history:
            self._snapshots.append(self._base)
        self._base_flat = fused
        self._base = self._spec.unflatten(fused)
        self.history.append(rec)
        self.iteration += 1
        return rec

    def flush(self) -> Optional[FusionRecord]:
        """Quiesce: every fuse here is synchronous, so nothing is in flight;
        waits for the device and returns None."""
        if self._base_flat.is_cuda:
            torch.cuda.synchronize(self._base_flat.device)
        return None

    def snapshot(self, iteration: int):
        """The base published before fuse ``iteration`` (``keep_history``)."""
        return self._snapshots[iteration]

    def _cohort_weights(self, K: int, staged: Sequence[Optional[float]]) -> torch.Tensor:
        """Per-contributor weights (average/damped)."""
        dev = self._base_flat.device
        kw = self.fusion_kwargs
        if self.fusion_op in ("average", "damped"):
            if "weights" in kw:
                w = list(kw["weights"])
                if len(w) != K:
                    raise ValueError(f"len(fusion_kwargs['weights'])={len(w)} != K={K}")
                return torch.tensor(w, dtype=torch.float32, device=dev)
            if staged and all(x is not None for x in staged):
                return torch.tensor(list(staged), dtype=torch.float32, device=dev)
        return torch.ones((K,), dtype=torch.float32, device=dev)

    def _flat_alpha(self, n_effective: int) -> float:
        """The kernel's damping coefficient for the configured operator."""
        if self.fusion_op == "damped":
            return float(self.fusion_kwargs.get("alpha", 1.0))
        if self.fusion_op == "task_arithmetic":
            # θ + λ·Σ(θ_c − θ) == θ + (λ·K)·(mean − θ)
            return float(self.fusion_kwargs.get("lam", 1.0)) * n_effective
        return 1.0
