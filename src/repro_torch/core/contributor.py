"""A ColD Fusion contributor (port of ``repro.core.contributor``): a party
with a private dataset that downloads the base, finetunes it locally and
uploads the body.  The classification head stays private and persists
across iterations (unless ``reset_head_each_iter``); with ``with_fisher``
each contribution also leaves its diagonal Fisher in ``last_fisher``, for
the Repository's ``fusion_op="fisher"``."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encoder as E
from repro_torch.train import finetune as FT
from repro_torch.utils.pytree import tree_device


@dataclass
class Contributor:
    cfg: ArchConfig
    task_id: int
    num_classes: int
    x: np.ndarray
    y: np.ndarray
    steps: int = 30
    batch_size: int = 32
    lr: float = 5e-4
    seed: int = 0
    reset_head_each_iter: bool = False
    with_fisher: bool = False
    last_fisher: Optional[Dict] = field(default=None, repr=False)
    _head: Optional[Dict] = field(default=None, repr=False)
    _iter: int = 0

    def _ensure_head(self, device) -> Dict:
        """The private head, drawn on first use (and at every iteration with
        ``reset_head_each_iter``) on ``device`` from a CPU generator seeded
        like the reference's head key."""
        if self._head is None or self.reset_head_each_iter:
            gen = torch.Generator().manual_seed(
                self.seed * 7919 + self.task_id * 131 + self._iter)
            self._head = E.init_cls_head(self.cfg, gen, self.num_classes, device=device)
        return self._head

    def contribute(self, base_body) -> Dict:
        """One ColD iteration: finetune the downloaded base on local data
        and return the updated body (the upload)."""
        device = tree_device(base_body)
        head = self._ensure_head(device)
        body, head, _ = FT.finetune(
            self.cfg, base_body, head, self.x, self.y,
            steps=self.steps, batch_size=self.batch_size, lr=self.lr,
            seed=self.seed * 1000 + self._iter,
        )
        self._head = head
        if self.with_fisher:
            self.last_fisher = FT.compute_fisher(self.cfg, body, head, self.x, self.y,
                                                 seed=self.seed, device=device)
        self._iter += 1
        return body
