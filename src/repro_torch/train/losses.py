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


def _scored(logits, tokens, mask, mesh: M.Mesh, seq_axis: Optional[str]):
    """Each slot's ``(logits scored [B, S', V'], their targets [B, S'],
    their weights [B, S'] f32 or None)``: every position but the last
    against the token after it.  Where ``seq_axis`` splits the sequence
    into chunks (slot ``s`` holding chunk ``coord(s, seq_axis)``), each
    chunk's first token and its mask weight are all-gathered over it (one
    counted gather, f64: both exact), and every chunk but the last scores
    its last position against the next chunk's first token."""
    R = mesh.extent(seq_axis)
    if R > 1:
        firsts = M.axis_all_gather(
            [torch.stack([tk[:, :1].double(), torch.ones_like(tk[:, :1], dtype=torch.float64)
                          if mask is None else mask[s][:, :1].double()], -1)
             for s, tk in enumerate(tokens)], mesh, seq_axis, 1)        # [B, R, 2]
    out = []
    for s, (lg, tk) in enumerate(zip(logits, tokens)):
        tgt, w = tk[:, 1:].long(), None if mask is None else mask[s][:, 1:].float()
        r = mesh.coord(s, seq_axis)
        if r == R - 1:  # the last chunk, or rows held whole: the last position drops
            out.append((lg[:, :-1], tgt, w))
            continue
        nxt = firsts[s][:, r + 1]                                        # [B, 2]
        out.append((lg, torch.cat([tgt, nxt[:, :1].long()], 1),
                    None if w is None else torch.cat([w, nxt[:, 1:].float()], 1)))
    return out


def lm_loss_vocab_parallel(logits: Sequence[torch.Tensor], tokens: Sequence[torch.Tensor],
                           mesh: M.Mesh, axis: Optional[str], mask=None,
                           denominator: Optional[float] = None, *,
                           seq_axis: Optional[str] = None) -> List[torch.Tensor]:
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
    mask: ``lm_loss`` exactly where the axis has extent 1).

    ``seq_axis``: the batch axis where it splits the sequence into chunks
    (``tokens[s]`` chunk ``coord(s, seq_axis)`` of every row): each chunk's
    last position is scored against the next chunk's first token (one
    counted gather, ``_scored``) and only the last chunk drops its last
    position, so the slots' shares over ``denominator`` sum over the axis
    to ``lm_loss`` of the whole sequence."""
    scored = _scored(logits, tokens, mask, mesh, seq_axis)
    if mesh.extent(axis) == 1:
        out = []
        for lg, tgt, w in scored:
            if denominator is None:
                out.append(softmax_xent(lg, tgt, w))
                continue
            lf = lg.float()
            gold = torch.gather(lf, -1, tgt[..., None])[..., 0]
            nll = torch.logsumexp(lf, -1) - gold
            out.append(torch.sum(nll if w is None else nll * w) / denominator)
        return out
    lf = [lg.float() for lg, _, _ in scored]
    V = lf[0].shape[-1]
    top = M.axis_all_reduce_max([x.amax(-1) for x in lf], mesh, axis)
    sumexp = M.axis_all_reduce([torch.exp(x - t[..., None]).sum(-1) for x, t in zip(lf, top)],
                               mesh, axis)
    gold = []
    for s, (x, (_, tgt, _)) in enumerate(zip(lf, scored)):
        ids = tgt - mesh.coord(s, axis) * V
        inside = (ids >= 0) & (ids < V)
        g = torch.gather(x, -1, ids.clamp(0, V - 1)[..., None])[..., 0]
        gold.append(torch.where(inside, g, torch.zeros_like(g)))
    gold = M.axis_all_reduce(gold, mesh, axis)
    out = []
    for s, (_, _, w) in enumerate(scored):
        nll = torch.log(sumexp[s]) + top[s] - gold[s]
        if w is not None:
            num, cnt = torch.sum(nll * w), torch.clamp(torch.sum(w), min=1.0)
        else:
            num, cnt = torch.sum(nll), nll.numel()
        out.append(num / (cnt if denominator is None else denominator))
    return out


def cls_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return softmax_xent(logits, labels)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())
