"""Mixture-of-Experts FFN (port of ``repro.models.moe``): GShard/Switch
top-k routing with a per-expert capacity.

Three routings, the reference's:

* ``gshard`` — one-hot dispatch/combine products with a per-expert
  capacity: a ``[T, E, C]`` dispatch tensor gathers each expert's tokens
  (``xe = x^T dispatch``) and a combine tensor of the same shape scatters
  the experts' outputs back, weighted by the router.
* ``dense`` — every expert on every token, combined by the top-k router
  weights (tiny configs and the routing tests' oracle).
* ``sort`` — gshard's capacity semantics with gathers in place of the
  one-hot products; chosen for gshard-configured layers by the
  reference's lever ``REPRO_OPT_MOE_SORT=1``, read at import as there.

Tokens over an expert's capacity are dropped (they get no FFN output from
that expert).  ``capacity = max(int(capacity_factor * T * K / E), K)``, and
a (token, k) pair takes its expert's next slot in token-major, k-minor
order.  The auxiliary load-balance loss is Switch's
``aux = E * sum_e f_e * p_e``, with f_e the fraction of tokens whose top-1
is e and p_e the mean router probability.

The experts' products are plain ``torch.bmm``/``einsum``, as the
reference leaves them to XLA (no Pallas kernel).  The top-k selection is
a stable descending sort: ``jax.lax.top_k`` breaks ties by the lower
index and ``torch.topk`` does not (a zero router makes every probability
tie).  Everything is differentiable: the router's gradient flows through
the top-k weights (combine) and through p_e (aux), not through the
one-hot dispatch.

``moe_fwd`` is three steps that the partitioned FFN
(``models.partitioned``) also calls apart: ``_router`` selects (the one
place a routing replay patches), ``plan`` gives a block of rows its
capacity and queues (the whole batch's, given the batch's token count and
the pairs queued ahead of the block), ``experts`` runs a subset of the
experts, or a slice of every expert's F, on the block's kept pairs.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import activation, dense_init

# the reference's perf lever: gshard-configured layers route through the
# sort/gather implementation; off by default
OPT_MOE_SORT = os.environ.get("REPRO_OPT_MOE_SORT", "0") == "1"


def init_moe(cfg: ArchConfig, gen: torch.Generator, dtype, device):
    """Draw order: the router, then w_gate, w_up and w_down, each expert
    in turn.  Leaves and shapes are the reference's: ``router`` [D, E],
    ``w_gate``/``w_up`` [E, D, F], ``w_down`` [E, F, D]."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts

    def expert_stack(d_in, d_out):
        w = torch.empty((e, d_in, d_out), dtype=dtype, device=device)
        for i in range(e):  # one expert's f32 draw is the only transient
            w[i] = dense_init(gen, d_in, d_out, dtype, device)
        return w

    return {"router": dense_init(gen, d, e, dtype, device),
            "w_gate": expert_stack(d, f),
            "w_up": expert_stack(d, f),
            "w_down": expert_stack(f, d)}


def _router(cfg: ArchConfig, p, x: torch.Tensor):
    """x: [T, D] -> (probs [T, E] f32, topk_idx [T, K], topk_w [T, K] f32)."""
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    k = cfg.moe.experts_per_token
    # lax.top_k's order: descending, ties to the lower expert index
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_w, topk_idx = w[:, :k], idx[:, :k]
    topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True)  # renormalize over the top k
    return probs, topk_idx, topk_w


def _expert_ffn(cfg: ArchConfig, p, xe: torch.Tensor) -> torch.Tensor:
    """xe: [E, C, D] -> [E, C, D]; batched over the expert dim."""
    act = activation(cfg.act)
    h = act(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _slots(topk_idx: torch.Tensor, E: int):
    """Each (token, k)'s position in its expert's queue ([T, K, E], -1 off
    its expert): a running count over the flattened [T * K, E] one-hot."""
    T, K = topk_idx.shape
    flat = F.one_hot(topk_idx, E).reshape(T * K, E)
    # scanned along contiguous rows of the transpose: a scan over the outer
    # dim of [T * K, E] took 6.3 ms a layer at 4 x 1024 tokens on an H100
    count = torch.cumsum(flat.t().contiguous(), dim=1).t()
    return (count * flat - 1).reshape(T, K, E)


class Plan(NamedTuple):
    """The routing of a block of rows: the router's ``probs`` [T, E] f32,
    ``topk_idx`` [T, K] and ``topk_w`` [T, K] f32; for the capacity
    routings each pair's position in its expert's queue within the block
    (``slot`` [T, K], clamped to ``width`` - 1), whether it is kept
    (``keep`` [T, K]) and the queue length the dispatch holds (``width``:
    the capacity, or for a block of a larger batch the most of it the
    block can fill)."""
    probs: torch.Tensor
    topk_idx: torch.Tensor
    topk_w: torch.Tensor
    slot: Optional[torch.Tensor] = None
    keep: Optional[torch.Tensor] = None
    width: int = 0


def pair_counts(topk_idx: torch.Tensor, E: int) -> torch.Tensor:
    """[E]: the (token, k) pairs a block queues on each expert."""
    idx = topk_idx.reshape(-1).long()   # a scatter, not bincount: the meta device has no bincount
    return torch.zeros(E, dtype=torch.long, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def plan(cfg: ArchConfig, probs, topk_idx, topk_w, *, tokens: Optional[int] = None,
         ahead: Optional[torch.Tensor] = None) -> Plan:
    """The capacity and queues of ``_router``'s choice for a block of T
    rows.  By default the block is the whole batch.  A block of a batch of
    ``tokens`` rows in all takes the batch's capacity, ``max(int(cf *
    tokens * K / E), K)``, and ``ahead`` [E], the pairs of the rows before
    the block queued on each expert: a pair is kept where its place in the
    whole batch's queue, ``ahead[e]`` plus its place in the block's, is
    under the capacity (the reference's cumsum over the global token
    order).  ``ahead`` [T, E] gives each row of the block its own count (a
    block of sequence chunks, whose rows interleave with other blocks' in
    the global order)."""
    routing = _routing(cfg)
    if routing == "dense":
        return Plan(probs, topk_idx, topk_w)
    E, K = cfg.moe.num_experts, cfg.moe.experts_per_token
    T = topk_idx.shape[0]
    capacity = max(int(cfg.moe.capacity_factor * (T if tokens is None else tokens) * K / E), K)
    slot = _slots(topk_idx, E).gather(-1, topk_idx[..., None])[..., 0]  # [T, K]
    queued = slot
    if ahead is not None:
        queued = slot + (ahead[topk_idx] if ahead.dim() == 1 else ahead.gather(1, topk_idx))
    keep = (queued >= 0) & (queued < capacity)
    # a block's kept pairs sit in its first capacity - ahead[e] places, and
    # it queues at most T pairs on an expert
    width = capacity if ahead is None else min(capacity, T)
    return Plan(probs, topk_idx, topk_w, slot.clamp(0, width - 1), keep, width)


def experts(cfg: ArchConfig, p, xt: torch.Tensor, pl: Plan, lo: int = 0,
            hi: Optional[int] = None) -> torch.Tensor:
    """xt [T, D] -> [T, D]: the outputs of experts ``lo``..``hi`` (all by
    default) for ``pl``'s kept pairs, combined by the router weights.
    ``p``'s expert stacks hold exactly those experts (a model slot's
    E / M), or every expert's slice of F, whose outputs are partial sums
    over the slices."""
    T, D = xt.shape
    E = cfg.moe.num_experts
    hi = E if hi is None else hi
    n = hi - lo
    dev, topk_idx = xt.device, pl.topk_idx
    routing = _routing(cfg)
    if routing == "dense":
        ye = _expert_ffn(cfg, p, xt.expand(n, T, D))  # [n, T, D]
        combine = torch.zeros((T, E), dtype=xt.dtype, device=dev).scatter(
            1, topk_idx, pl.topk_w.to(xt.dtype))[:, lo:hi]
        return torch.einsum("te,etd->td", combine, ye)

    W = pl.width
    tok = torch.arange(T, device=dev)[:, None].expand(T, topk_idx.shape[1])
    keep = pl.keep if (lo, hi) == (0, E) else pl.keep & (topk_idx >= lo) & (topk_idx < hi)
    local = topk_idx if lo == 0 else topk_idx - lo
    local = local.clamp(0, n - 1) if n < E else local   # a pair off the range is not kept

    if routing == "sort":
        # gather/scatter dispatch: x[idx] in, the experts' rows back out
        col = torch.where(keep, pl.slot, W)
        # token per (expert, slot); T is the sentinel of an empty slot (a
        # zero row); dropped pairs write the spare last column, discarded
        idx = torch.full((n, W + 1), T, dtype=torch.long, device=dev)
        idx[local, col] = tok
        x_pad = torch.cat([xt, xt.new_zeros((1, D))], dim=0)
        ye = _expert_ffn(cfg, p, x_pad[idx[:, :W]])  # [n, W, D]
        ye_pad = torch.cat([ye, ye.new_zeros((n, 1, D))], dim=1)
        return torch.einsum("tk,tkd->td", pl.topk_w.to(xt.dtype), ye_pad[local, col])

    # --- GShard capacity routing ---------------------------------------
    dispatch = torch.zeros((T, n, W), dtype=xt.dtype, device=dev)
    dispatch.index_put_((tok, local, pl.slot), keep.to(xt.dtype), accumulate=True)
    # combine weights: the dispatch's sparsity, scaled by the router weight
    w_full = torch.zeros((T, n), dtype=torch.float32, device=dev).index_put(
        (tok, local), torch.where(keep, pl.topk_w, 0.0), accumulate=True)
    combine = dispatch * w_full[..., None].to(xt.dtype)  # [T, n, W]

    xe = torch.einsum("td,tec->ecd", xt, dispatch)  # [n, W, D]
    ye = _expert_ffn(cfg, p, xe)
    return torch.einsum("tec,ecd->td", combine, ye)


def _routing(cfg: ArchConfig) -> str:
    if OPT_MOE_SORT and cfg.moe.routing == "gshard":
        return "sort"
    return cfg.moe.routing


def moe_fwd(cfg: ArchConfig, p, x: torch.Tensor):
    """x: [B, S, D] -> (out [B, S, D], aux_loss 0-d f32)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    probs, topk_idx, topk_w = _router(cfg, p, xt)
    # Switch-style load-balance aux loss (top-1 assignment fractions)
    E = cfg.moe.num_experts
    f_e = F.one_hot(topk_idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(f_e * probs.mean(dim=0))
    out = experts(cfg, p, xt, plan(cfg, probs, topk_idx, topk_w))
    return out.reshape(B, S, D), aux
