"""Tiny MLM pretraining (port of ``repro.train.pretrain``): produces the
"pretrained model" θ₀ the ColD Fusion experiments start from (the stand-in
for RoBERTa-base).

Masked-token prediction over the synthetic token mixture, with the
reference's numpy stream and masking (``default_rng(seed)``,
``lm_stream(..., seed=seed + 17)``), warmup ``max(10, steps // 20)`` into a
cosine decay, a global-norm clip at 1.0 and AdamW.  Autograd computes the
gradients.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import SyntheticSuite, mask_for_mlm
from repro_torch.models import encoder as E
from repro_torch.optim.optimizers import adamw, clipped_step, warmup_cosine_lr
from repro_torch.train.losses import softmax_xent
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_device, tree_leaves, tree_map


def pretrain_mlm(
    cfg: ArchConfig,
    suite: SyntheticSuite,
    *,
    steps: int = 400,
    batch_size: int = 64,
    seq_len: int = 24,
    lr: float = 2e-3,
    seed: int = 0,
    device="cuda",
) -> Tuple[Dict, Dict]:
    """Returns (body, metrics).  The initial body is drawn on ``device``
    from a generator seeded ``seed`` (torch cannot draw the reference's
    ``PRNGKey(seed)`` body; ``_pretrain_from`` trains a given one)."""
    device = resolve_device(device)
    body = E.init_encoder_body(cfg, torch.Generator(device=device).manual_seed(seed),
                               device=device)
    return _pretrain_from(cfg, suite, body, steps=steps, batch_size=batch_size,
                          seq_len=seq_len, lr=lr, seed=seed)


def mlm_step(cfg: ArchConfig, opt, body, opt_state, batch):
    """One clipped AdamW step on ``body`` (leaves require grad) in place.
    Returns (opt_state, loss)."""
    logits = E.mlm_logits(cfg, body, batch["inputs"])
    loss = softmax_xent(logits, batch["targets"], batch["mask"])
    grads = torch.autograd.grad(loss, tree_leaves(body))
    return clipped_step(opt, body, opt_state, grads), loss.detach()


def _pretrain_from(cfg: ArchConfig, suite: SyntheticSuite, body, *, steps: int,
                   batch_size: int, seq_len: int, lr: float, seed: int) -> Tuple[Dict, Dict]:
    """Pretrain a clone of ``body`` (on its device)."""
    device = tree_device(body)
    body = tree_map(lambda p: p.detach().clone().requires_grad_(True), body)
    opt = adamw(warmup_cosine_lr(lr, warmup=max(10, steps // 20), total=steps))
    opt_state = opt.init(body)
    rng = np.random.default_rng(seed)
    stream = suite.lm_stream(steps * batch_size, seq_len, seed=seed + 17)
    losses = []
    for i in range(steps):
        toks = stream[i * batch_size: (i + 1) * batch_size]
        inputs, targets, mask = mask_for_mlm(toks, rng)
        batch = {"inputs": torch.as_tensor(inputs, device=device).long(),
                 "targets": torch.as_tensor(targets, device=device).long(),
                 "mask": torch.as_tensor(mask, device=device)}
        opt_state, loss = mlm_step(cfg, opt, body, opt_state, batch)
        losses.append(float(loss))
    return tree_map(lambda p: p.detach(), body), {"loss": losses}
