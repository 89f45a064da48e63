"""The ColD Fusion loop (paper §3, Fig. 1) and its evaluation protocol
(§4.4), port of ``repro.core.cold_fusion``: at each iteration contributors
finetune the current base on their private data, the Repository screens
and fuses the uploads, and the new base is evaluated both ways —

* **ColD** (base-model goal): full finetune on each eval task;
* **ColD-Frozen** (single-model goal): linear probe (head-only training).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.contributor import Contributor
from repro_torch.core.repository import Repository
from repro_torch.models import encoder as E
from repro_torch.train import finetune as FT
from repro_torch.utils.pytree import tree_device


@dataclass
class EvalTask:
    task_id: int
    num_classes: int
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray


def evaluate_base_model(
    cfg: ArchConfig,
    body,
    tasks: Sequence[EvalTask],
    *,
    frozen: bool,
    steps: int = 30,
    lr: float = 5e-4,
    batch_size: int = 32,
    seed: int = 0,
    few_shot: Optional[int] = None,
) -> Dict[int, float]:
    """Finetune (or probe) the base on each task's train split; test acc.
    Each task's fresh head comes from a CPU generator seeded
    ``seed * 7919 + task_id``."""
    device = tree_device(body)
    out = {}
    for t in tasks:
        gen = torch.Generator().manual_seed(seed * 7919 + t.task_id)
        head = E.init_cls_head(cfg, gen, t.num_classes, device=device)
        x, y = t.x_train, t.y_train
        if few_shot is not None:
            x, y = x[:few_shot], y[:few_shot]
        body_ft, head, _ = FT.finetune(
            cfg, body, head, x, y,
            steps=steps, batch_size=min(batch_size, len(x)), lr=lr,
            frozen_body=frozen, seed=seed,
        )
        out[t.task_id] = FT.evaluate(cfg, body_ft, head, t.x_test, t.y_test)
    return out


@dataclass
class ColdFusionRun:
    """Result log: per-iteration eval scores."""

    seen_finetuned: List[Dict[int, float]] = field(default_factory=list)
    seen_frozen: List[Dict[int, float]] = field(default_factory=list)
    unseen_finetuned: List[Dict[int, float]] = field(default_factory=list)
    unseen_frozen: List[Dict[int, float]] = field(default_factory=list)

    def mean(self, series: str) -> List[float]:
        rows = getattr(self, series)
        return [float(np.mean(list(r.values()))) for r in rows]


def run_cold_fusion(
    cfg: ArchConfig,
    repo: Repository,
    contributors: Sequence[Contributor],
    *,
    iterations: int,
    contributors_per_iter: Optional[int] = None,
    eval_seen: Sequence[EvalTask] = (),
    eval_unseen: Sequence[EvalTask] = (),
    eval_every: int = 1,
    eval_steps: int = 30,
    eval_lr: float = 5e-4,
    seed: int = 0,
    progress: bool = False,
) -> ColdFusionRun:
    """Run the ColD Fusion loop (paper §4.4).  Each iteration samples
    ``contributors_per_iter`` contributors (all, if None), collects their
    finetuned bodies (with each one's Fisher, for ``fusion_op="fisher"``)
    and fuses them; evaluation follows §4.4."""
    rng = np.random.default_rng(seed)
    log = ColdFusionRun()

    def _eval(body):
        for tasks, ft, fr in ((eval_seen, log.seen_finetuned, log.seen_frozen),
                              (eval_unseen, log.unseen_finetuned, log.unseen_frozen)):
            if tasks:
                ft.append(evaluate_base_model(cfg, body, tasks, frozen=False,
                                              steps=eval_steps, lr=eval_lr, seed=seed))
                fr.append(evaluate_base_model(cfg, body, tasks, frozen=True,
                                              steps=eval_steps, lr=eval_lr, seed=seed))

    for it in range(iterations):
        pool = list(contributors)
        if contributors_per_iter is not None and contributors_per_iter < len(pool):
            idx = rng.choice(len(pool), size=contributors_per_iter, replace=False)
            pool = [pool[i] for i in idx]
        base = repo.download()
        for c in pool:
            body = c.contribute(base)
            repo.upload(body, fisher=getattr(c, "last_fisher", None))
        rec = repo.fuse_pending()
        if progress:
            print(f"[cold] iter {it + 1}/{iterations}: fused {rec.n_accepted}/"
                  f"{rec.n_contributions} contributions (op={rec.op})")
        if (it + 1) % eval_every == 0 or it == iterations - 1:
            _eval(repo.download())
    return log
