"""Classifier finetuning (the paper's §4.3 procedure), port of
``repro.train.finetune``: used by each contributor inside the ColD Fusion
loop and to evaluate a base model (full finetune or linear probe), and the
contributor-side diagonal Fisher for ``fusion_op="fisher"``.

Autograd computes the gradients; the step is the reference's: clip the
(head, body) tree by global norm 1.0, AdamW update, add.  ``finetune``
trains a clone of what it is given, never the caller's tensors: the body a
contributor downloads is a view into the Repository's published row.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import batches
from repro_torch.models import encoder as E
from repro_torch.optim.optimizers import adamw, clipped_step, linear_decay_lr
from repro_torch.train.losses import accuracy, cls_loss
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (tree_device, tree_from_paths, tree_leaves,
                                      tree_leaves_with_path, tree_map)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device).long() for k, v in batch.items()}


def train_step(cfg: ArchConfig, opt, trainable, opt_state, body, batch):
    """One step on ``trainable`` (``{"head"}`` or ``{"head", "body"}``;
    leaves require grad) in place.  Returns (opt_state, loss, acc)."""
    logits = E.classify(cfg, trainable.get("body", body), trainable["head"], batch["tokens"])
    loss = cls_loss(logits, batch["labels"])
    grads = torch.autograd.grad(loss, tree_leaves(trainable))
    opt_state = clipped_step(opt, trainable, opt_state, grads)
    with torch.no_grad():
        acc = accuracy(logits, batch["labels"])
    return opt_state, loss.detach(), acc


def finetune(
    cfg: ArchConfig,
    body,
    head,
    x: np.ndarray,
    y: np.ndarray,
    *,
    steps: int,
    batch_size: int = 32,
    lr: float = 5e-4,
    lr_decay: float = 0.0,
    frozen_body: bool = False,
    seed: int = 0,
) -> Tuple[Dict, Dict, Dict]:
    """Finetune (body, head) on (x, y).  Returns (body, head, metrics).
    ``frozen_body=True`` trains only the head (linear probing); the body is
    then returned as given."""
    device = tree_device(body)
    opt = adamw(linear_decay_lr(lr, lr_decay))
    fresh = lambda t: tree_map(lambda p: p.detach().clone().requires_grad_(True), t)
    trainable = {"head": fresh(head)} if frozen_body else {"head": fresh(head), "body": fresh(body)}
    opt_state = opt.init(trainable)
    it = batches(x, y, batch_size, rng=np.random.default_rng(seed), epochs=10_000)
    losses, accs = [], []
    for _ in range(steps):
        b = to_device(next(it), device)
        opt_state, loss, acc = train_step(cfg, opt, trainable, opt_state, body, b)
        losses.append(float(loss))
        accs.append(float(acc))
    out = tree_map(lambda p: p.detach(), trainable)
    return out.get("body", body), out["head"], {"loss": losses, "train_acc": accs}


def compute_fisher(
    cfg: ArchConfig, body, head, x: np.ndarray, y: np.ndarray,
    *, batches_n: int = 8, batch_size: int = 32, seed: int = 0, device="cuda",
):
    """Diagonal empirical Fisher of the body (Matena & Raffel 2021): the
    mean over minibatches of the squared gradient of ``cls_loss``, in f32,
    with respect to the body only (the head is a constant; nothing is
    clipped).  As the reference, it takes the first ``batches_n`` batches
    of one shuffled epoch (drop_remainder) and divides by ``batches_n``
    even when fewer exist.  Runs on ``device`` (the inputs are moved there
    if they live elsewhere); ``body`` is never written (it may be a view
    into a published row)."""
    device = resolve_device(device)
    paths = [path for path, _ in tree_leaves_with_path(body)]
    leaves = [p.detach().to(device).requires_grad_(True) for p in tree_leaves(body)]
    trainable = tree_from_paths(zip(paths, leaves))
    head = tree_map(lambda p: p.detach().to(device), head)
    fisher = [torch.zeros(p.shape, dtype=torch.float32, device=device) for p in leaves]
    rng = np.random.default_rng(seed)
    for b in list(batches(x, y, batch_size, rng=rng))[:batches_n]:
        b = to_device(b, device)
        loss = cls_loss(E.classify(cfg, trainable, head, b["tokens"]), b["labels"])
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for f, g in zip(fisher, grads):
                f.add_(torch.square(g.float()))
    return tree_from_paths((p, f / batches_n) for p, f in zip(paths, fisher))


@torch.no_grad()
def evaluate(cfg: ArchConfig, body, head, x: np.ndarray, y: np.ndarray,
             batch_size: int = 64) -> float:
    device = tree_device(body)
    correct, total = 0, 0
    for b in batches(x, y, batch_size, drop_remainder=False):
        b = to_device(b, device)
        logits = E.classify(cfg, body, head, b["tokens"])
        correct += int(torch.sum(torch.argmax(logits, -1) == b["labels"]))
        total += len(b["labels"])
    return correct / max(total, 1)
