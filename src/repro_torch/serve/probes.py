"""Post-publish task probes: the forgetting regression gate's sensor (port
of ``repro.serve.probes``).

The §9 MAD screen and the novelty screen reject anomalous *rows*, but a
cohort of unremarkable rows can still publish a base that regresses earlier
tasks (paper §8 asks for "backtracking when a harmful update was done").
``ProbeSuite`` is the cheap, fixed, per-task measurement the service runs
after every publish; ``RegressionGate`` is its trip rule.

* **Architecture-agnostic**: each probe scores the flat ``[N]`` base
  directly.  Task ``k`` reads a fixed pseudo-random slice of the base as a
  linear readout ``W_k ∈ R^{M x C}`` over the synthetic suite's motif
  features, and its score is the classification loss of that readout on a
  frozen eval batch.
* **Deterministic**: batches, readout indices and signs are fixed by
  ``(seed, task id)`` with the reference's numpy draws, so both packages
  build the same probes and the same base always scores the same, which is
  what lets a restarted daemon replay a gate verdict.
* **Cheap**: the readout gather may run where the row lives (the card), so
  the gate reads ``M·C`` elements a task, never the whole row, and the rest
  is a ``[n, M] @ [M, C]`` product on the host.

``MultitaskEvals`` scores REAL task evals instead: the flat base is
unflattened into the encoder body and scored with ``classify``/``cls_loss``.
The probes are plain PyTorch and numpy, as in the reference (no Pallas
kernel there).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.synthetic import SyntheticSuite
from repro_torch.models import encoder as E
from repro_torch.train.losses import accuracy, cls_loss
from repro_torch.utils.device import resolve_device
from repro_torch.utils.flat import FlatSpec, dtype_of


class MultitaskEvals:
    """Real task evals for the regression gate: frozen ``train_multitask``
    format batches ``(task_id, x [n, T], y [n], n_cls)`` scored by running
    the encoder on ``device``.  ``heads`` maps ``task_id -> cls head``; the
    default heads come from a generator seeded ``seed * 997 + task_id``, as
    ``train_multitask`` draws them.  ``score`` is a deterministic function
    of the base."""

    def __init__(self, cfg, base_params, datasets: Sequence[Tuple[int, np.ndarray, np.ndarray, int]],
                 *, seed: int = 0, heads: Optional[Dict[int, Any]] = None, device="cuda"):
        if not datasets:
            raise ValueError("MultitaskEvals needs at least one eval dataset")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = FlatSpec.from_tree(base_params)
        self.seed = int(seed)
        self.heads: Dict[int, Any] = dict(heads) if heads else {}
        self._batches: List[Tuple[str, int, torch.Tensor, torch.Tensor]] = []
        for tid, x, y, n_cls in datasets:
            tid = int(tid)
            if tid not in self.heads:
                self.heads[tid] = E.init_cls_head(
                    cfg, torch.Generator().manual_seed(self.seed * 997 + tid), n_cls,
                    device=self.device)
            self._batches.append((f"task{tid:02d}", tid,
                                  torch.as_tensor(np.asarray(x), device=self.device),
                                  torch.as_tensor(np.asarray(y), device=self.device)))

    @property
    def size(self) -> int:
        """Flat base length this suite scores (``FlatSpec.size``)."""
        return self.spec.size

    @property
    def task_names(self) -> List[str]:
        return [name for name, *_ in self._batches]

    def _body(self, flat):
        row = flat if isinstance(flat, torch.Tensor) else torch.tensor(np.asarray(flat))
        return self.spec.unflatten(row.to(self.device, dtype_of(self.spec.dtype)))

    @torch.no_grad()
    def _per_task(self, flat, metric) -> Dict[str, float]:
        body = self._body(flat)
        return {name: float(metric(E.classify(self.cfg, body, self.heads[tid], x), y))
                for name, tid, x, y in self._batches}

    def score(self, flat) -> Dict[str, float]:
        """Per-task eval losses of a flat ``[N]`` base."""
        return self._per_task(flat, cls_loss)

    def accuracies(self, flat) -> Dict[str, float]:
        return self._per_task(flat, accuracy)


@dataclass
class ProbeReport:
    """One gate comparison: per-task (baseline, score) with the verdict."""

    ok: bool
    tolerance: float
    max_regressed: int
    regressed: List[str]                      # task names over tolerance
    deltas: Dict[str, float]                  # score - baseline, per task
    scores: Dict[str, float]
    baseline: Dict[str, float]

    @property
    def worst(self) -> float:
        """The largest per-task loss increase (negative = all improved)."""
        return max(self.deltas.values()) if self.deltas else 0.0

    def to_json(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "tolerance": self.tolerance,
            "regressed": list(self.regressed),
            "worst_delta": self.worst,
            "scores": dict(self.scores),
        }


class ProbeSuite:
    """Fixed per-task eval batches scoring a flat ``[N]`` base of length
    ``size``.  All randomness is consumed at construction.  ``suite=`` takes
    a ``MultitaskEvals`` to score real task evals instead."""

    def __init__(self, size: int, *, n_tasks: int = 4, n_examples: int = 32,
                 seq_len: int = 16, seed: int = 0, suite: Optional[Any] = None):
        if size <= 0:
            raise ValueError(f"flat base size must be positive, got {size}")
        if n_tasks < 1:
            raise ValueError(f"need at least one probe task, got {n_tasks}")
        self.size = int(size)
        self.n_examples = int(n_examples)
        self.seq_len = int(seq_len)
        self._evals: Optional[MultitaskEvals] = None
        self._tasks: List[Tuple[str, np.ndarray, torch.Tensor, np.ndarray, np.ndarray]] = []
        # the readout indices and signs on each device a row was scored on
        self._on_device: Dict[torch.device, List[Tuple[torch.Tensor, torch.Tensor]]] = {}
        if isinstance(suite, MultitaskEvals):
            if suite.size != self.size:
                raise ValueError(
                    f"MultitaskEvals scores a flat base of size {suite.size}, but the probe "
                    f"suite was asked for size {self.size}")
            self._evals = self.suite = suite
            self.n_tasks = len(suite.task_names)
            self.seed = suite.seed
            return
        self.n_tasks = int(n_tasks)
        self.seed = int(seed)
        self.suite = suite or SyntheticSuite(num_tasks=max(self.n_tasks, 1), seed=seed)
        if self.n_tasks > self.suite.num_tasks:
            raise ValueError(f"probe pool wants {self.n_tasks} tasks but the suite has "
                             f"{self.suite.num_tasks}")
        for t in range(self.n_tasks):
            spec = self.suite.tasks[t]
            ds = self.suite.dataset(t, 1, self.n_examples, self.seq_len, split_seed=self.seed)
            toks, labels = ds["x_test"], ds["y_test"]
            # motif features are model-independent: the score isolates what
            # the readout (a fixed slice of the base) does to the task
            feats = self.suite.phi[toks].mean(axis=1).astype(np.float32)
            rng = np.random.default_rng((self.seed, spec.seed, 11))
            m, c = self.suite.num_motifs, spec.num_classes
            idx = rng.integers(0, self.size, size=m * c)
            sign = rng.choice(np.asarray([-1.0, 1.0], np.float32), size=m * c)
            self._tasks.append((spec.name, feats, torch.from_numpy(labels), idx, sign))

    # -- scoring --------------------------------------------------------
    def _flat(self, base):
        """A flat ``[N]`` torch row (on any device) or numpy row as given;
        a parameter tree flattened."""
        if isinstance(base, dict):
            base = FlatSpec.from_tree(base).flatten(base)
        elif not isinstance(base, torch.Tensor):
            base = np.asarray(base)
        if tuple(base.shape) != (self.size,):
            raise ValueError(f"probe suite was built for flat size {self.size}, got base of "
                             f"shape {tuple(base.shape)}")
        return base

    def _readouts(self, flat) -> List[np.ndarray]:
        """Each task's ``[M, C]`` f32 readout ``flat[idx] * sign``, gathered
        where the row lives."""
        if not isinstance(flat, torch.Tensor):
            flat = np.asarray(flat, np.float32)
            return [(flat[idx] * sign).reshape(feats.shape[1], -1)
                    for _, feats, _, idx, sign in self._tasks]
        dev = flat.device
        if dev not in self._on_device:
            self._on_device[dev] = [(torch.from_numpy(idx).to(dev), torch.from_numpy(sign).to(dev))
                                    for *_, idx, sign in self._tasks]
        gathered = torch.cat([flat[i].float() * s for i, s in self._on_device[dev]]).cpu().numpy()
        out, at = [], 0
        for _, feats, _, idx, _ in self._tasks:
            out.append(gathered[at:at + idx.size].reshape(feats.shape[1], -1))
            at += idx.size
        return out

    def _readout_metric(self, flat, metric) -> Dict[str, float]:
        return {name: float(metric(torch.from_numpy(feats @ w), labels))
                for (name, feats, labels, _, _), w in zip(self._tasks, self._readouts(flat))}

    def score(self, base) -> Dict[str, float]:
        """Per-task probe losses of a base (flat row or tree); the same base
        always scores the same."""
        flat = self._flat(base)
        if self._evals is not None:
            return self._evals.score(flat)
        return self._readout_metric(flat, cls_loss)

    def accuracies(self, base) -> Dict[str, float]:
        """Per-task probe accuracies (observability only: the gate compares
        losses, which move smoothly under small drift)."""
        flat = self._flat(base)
        if self._evals is not None:
            return self._evals.accuracies(flat)
        return self._readout_metric(flat, accuracy)

    # -- gate decision --------------------------------------------------
    def compare(self, baseline: Dict[str, float], scores: Dict[str, float],
                *, tolerance: float = 0.5, max_regressed: int = 0) -> ProbeReport:
        """A task *regressed* when its loss rose more than ``tolerance``
        over ``baseline``; the gate is ``ok`` while at most
        ``max_regressed`` tasks regressed.  Tasks missing from ``baseline``
        are skipped."""
        deltas = {name: scores[name] - baseline[name] for name in scores if name in baseline}
        regressed = [name for name, d in deltas.items() if d > tolerance]
        return ProbeReport(
            ok=len(regressed) <= max_regressed,
            tolerance=float(tolerance),
            max_regressed=int(max_regressed),
            regressed=sorted(regressed),
            deltas=deltas,
            scores=dict(scores),
            baseline=dict(baseline),
        )


@dataclass
class RegressionGate:
    """The service's gate: a probe pool plus the trip rule.  Built by
    ``repro_torch.launch.serve_repository`` from the ``--gate`` flags and
    handed to ``ColdService(gate=...)``."""

    probes: ProbeSuite
    tolerance: float = 0.5
    max_regressed: int = 0

    def check(self, baseline: Dict[str, float], base) -> ProbeReport:
        """Score ``base`` and compare against ``baseline``."""
        return self.probes.compare(baseline, self.probes.score(base),
                                   tolerance=self.tolerance, max_regressed=self.max_regressed)
