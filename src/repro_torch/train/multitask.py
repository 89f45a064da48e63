"""Standard multitask baseline (paper §4.2), port of
``repro.train.multitask``: ONE shared body trained jointly over all
datasets with a dedicated classification head per dataset — the
centralized upper baseline ColD Fusion is compared against (Fig. 2).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encoder as E
from repro_torch.optim.optimizers import adamw, constant_lr
from repro_torch.train import finetune as FT
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map

Dataset = Tuple[int, np.ndarray, np.ndarray, int]  # (task_id, x, y, n_cls)


def train_multitask(
    cfg: ArchConfig,
    body,
    datasets: Sequence[Dataset],
    *,
    steps: int,
    batch_size: int = 32,
    lr: float = 5e-4,
    seed: int = 0,
    device="cuda",
) -> Tuple[Dict, Dict[int, Dict]]:
    """Returns (body, heads keyed by task_id), trained on ``device``.

    Each step samples one dataset uniformly and takes one gradient step on
    the shared body + that dataset's head.  Task ``tid``'s head is drawn
    from a generator seeded ``seed * 997 + tid`` (``_train_multitask``
    trains given heads)."""
    device = resolve_device(device)
    heads = {tid: E.init_cls_head(cfg, torch.Generator().manual_seed(seed * 997 + tid),
                                  n_cls, device=device)
             for tid, _, _, n_cls in datasets}
    return _train_multitask(cfg, body, heads, datasets, steps=steps, batch_size=batch_size,
                            lr=lr, seed=seed, device=device)


def _train_multitask(cfg: ArchConfig, body, heads: Dict[int, Dict],
                     datasets: Sequence[Dataset], *, steps: int, batch_size: int,
                     lr: float, seed: int, device) -> Tuple[Dict, Dict[int, Dict]]:
    """Train copies of ``body`` and ``heads`` on ``device``.  ONE Adam state
    for the body (true joint optimisation); each head keeps its own m and
    v but takes the global step count, as in the reference."""
    fresh = lambda t: tree_map(
        lambda p: p.detach().to(device, copy=True).requires_grad_(True), t)
    body = fresh(body)
    heads = {tid: fresh(h) for tid, h in heads.items()}
    opt = adamw(constant_lr(lr))
    body_state = opt.init({"body": body})
    head_states = {tid: opt.init({"head": heads[tid]}) for tid, *_ in datasets}
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        tid, x, y, _ = datasets[rng.integers(len(datasets))]
        idx = rng.integers(0, len(x), size=batch_size)
        batch = FT.to_device({"tokens": x[idx], "labels": y[idx]}, device)
        state = {
            "step": body_state["step"],
            "m": {"body": body_state["m"]["body"], "head": head_states[tid]["m"]["head"]},
            "v": {"body": body_state["v"]["body"], "head": head_states[tid]["v"]["head"]},
        }
        state, _, _ = FT.train_step(cfg, opt, {"body": body, "head": heads[tid]}, state,
                                    body, batch)
        body_state = {"step": state["step"], "m": {"body": state["m"]["body"]},
                      "v": {"body": state["v"]["body"]}}
        head_states[tid] = {"step": state["step"], "m": {"head": state["m"]["head"]},
                            "v": {"head": state["v"]["head"]}}
    detach = lambda t: tree_map(lambda p: p.detach(), t)
    return detach(body), {tid: detach(h) for tid, h in heads.items()}
