"""Loss functions (port of ``repro.train.losses``), and the vocab-parallel
form of ``lm_loss`` that the partitioned train step scores its logits
with."""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.launch import mesh as M


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


def lm_loss_vocab_parallel(logits: Sequence[torch.Tensor], tokens: Sequence[torch.Tensor],
                           mesh: M.Mesh, axis: Optional[str], mask=None,
                           denominator: Optional[float] = None) -> List[torch.Tensor]:
    """``lm_loss`` of logits split over the vocabulary along ``axis``: slot
    ``s``'s ``logits[s]`` [B, S, V/k] are the vocabulary block at its index
    ``i`` on ``axis`` (ids ``[i V/k, (i + 1) V/k)``), ``tokens[s]`` [B, S]
    its rows' tokens (``mask[s]`` their weights).  Per slot, in f32: the
    rows' maximum logit all-reduced (max) over ``axis``, the sum of
    exp(logit − max) and the target's logit (zero off its block) each
    all-reduced (sum), so the loss is the same on every slot of a group
    and its gradient is the softmax of the slot's block less the one-hot
    target there.  Returns each slot's 0-d loss: Σ nll · mask over
    ``denominator`` (by default the rows' own count, clamped at 1 with a
    mask: ``lm_loss`` exactly where the axis has extent 1)."""
    shift = None if mask is None else [m[:, 1:].float() for m in mask]
    if mesh.extent(axis) == 1:
        out = []
        for s, (lg, tk) in enumerate(zip(logits, tokens)):
            if denominator is None:
                out.append(lm_loss(lg, tk, None if mask is None else mask[s]))
                continue
            lf = lg[:, :-1].float()
            gold = torch.gather(lf, -1, tk[:, 1:].long()[..., None])[..., 0]
            nll = torch.logsumexp(lf, -1) - gold
            out.append(torch.sum(nll if shift is None else nll * shift[s]) / denominator)
        return out
    lf = [lg[:, :-1].float() for lg in logits]
    V = lf[0].shape[-1]
    top = M.axis_all_reduce_max([x.amax(-1) for x in lf], mesh, axis)
    sumexp = M.axis_all_reduce([torch.exp(x - t[..., None]).sum(-1) for x, t in zip(lf, top)],
                               mesh, axis)
    gold = []
    for s, (x, tk) in enumerate(zip(lf, tokens)):
        ids = tk[:, 1:].long() - mesh.coord(s, axis) * V
        inside = (ids >= 0) & (ids < V)
        g = torch.gather(x, -1, ids.clamp(0, V - 1)[..., None])[..., 0]
        gold.append(torch.where(inside, g, torch.zeros_like(g)))
    gold = M.axis_all_reduce(gold, mesh, axis)
    out = []
    for s in range(len(lf)):
        nll = torch.log(sumexp[s]) + top[s] - gold[s]
        if shift is not None:
            num, cnt = torch.sum(nll * shift[s]), torch.clamp(torch.sum(shift[s]), min=1.0)
        else:
            num, cnt = torch.sum(nll), nll.numel()
        out.append(num / (cnt if denominator is None else denominator))
    return out


def cls_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return softmax_xent(logits, labels)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())
