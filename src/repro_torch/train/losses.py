"""Loss functions (port of ``repro.train.losses``)."""
from __future__ import annotations

import torch


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None,
                 z_loss: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy in f32.  logits [..., V], labels [...] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if z_loss:
        nll = nll + z_loss * torch.square(logz)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor, mask=None) -> torch.Tensor:
    """Next-token prediction: logits [B, S, V] against tokens [B, S], each
    position scored on the token after it; ``mask`` [B, S] weights the
    targets."""
    shift_mask = None if mask is None else mask[:, 1:]
    return softmax_xent(logits[:, :-1], tokens[:, 1:], shift_mask)


def cls_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return softmax_xent(logits, labels)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())
