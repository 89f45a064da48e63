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
"""
from __future__ import annotations

import os

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


def moe_fwd(cfg: ArchConfig, p, x: torch.Tensor):
    """x: [B, S, D] -> (out [B, S, D], aux_loss 0-d f32)."""
    B, S, D = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.experts_per_token
    xt = x.reshape(B * S, D)
    probs, topk_idx, topk_w = _router(cfg, p, xt)
    T = B * S
    dev = x.device

    # Switch-style load-balance aux loss (top-1 assignment fractions)
    f_e = F.one_hot(topk_idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(f_e * probs.mean(dim=0))

    routing = cfg.moe.routing
    if OPT_MOE_SORT and routing == "gshard":
        routing = "sort"

    if routing == "dense":
        ye = _expert_ffn(cfg, p, xt.expand(E, T, D))  # [E, T, D]
        combine = torch.zeros((T, E), dtype=xt.dtype, device=dev).scatter(
            1, topk_idx, topk_w.to(xt.dtype))
        out = torch.einsum("te,etd->td", combine, ye)
        return out.reshape(B, S, D), aux

    capacity = max(int(cfg.moe.capacity_factor * T * K / E), K)
    pos = _slots(topk_idx, E)
    tok = torch.arange(T, device=dev)[:, None].expand(T, K)

    if routing == "sort":
        # gather/scatter dispatch: x[idx] in, the experts' rows back out
        slot = pos.gather(-1, topk_idx[..., None])[..., 0]  # [T, K]
        keep = (slot >= 0) & (slot < capacity)
        col = torch.where(keep, slot.clamp(0, capacity - 1), capacity)
        # token per (expert, slot); T is the sentinel of an empty slot (a
        # zero row); dropped pairs write the spare last column, discarded
        idx = torch.full((E, capacity + 1), T, dtype=torch.long, device=dev)
        idx[topk_idx, col] = tok
        x_pad = torch.cat([xt, xt.new_zeros((1, D))], dim=0)
        ye = _expert_ffn(cfg, p, x_pad[idx[:, :capacity]])  # [E, C, D]
        ye_pad = torch.cat([ye, ye.new_zeros((E, 1, D))], dim=1)
        out = torch.einsum("tk,tkd->td", topk_w.to(xt.dtype), ye_pad[topk_idx, col])
        return out.reshape(B, S, D), aux

    # --- GShard capacity routing ---------------------------------------
    within_cap = (pos >= 0) & (pos < capacity)
    slot = pos.gather(-1, topk_idx[..., None])[..., 0].clamp(0, capacity - 1)
    keep = within_cap.any(dim=-1) & within_cap.gather(-1, topk_idx[..., None])[..., 0]
    dispatch = torch.zeros((T, E, capacity), dtype=x.dtype, device=dev)
    dispatch.index_put_((tok, topk_idx, slot), keep.to(x.dtype), accumulate=True)
    # combine weights: the dispatch's sparsity, scaled by the router weight
    w_full = torch.zeros((T, E), dtype=torch.float32, device=dev).index_put(
        (tok, topk_idx), torch.where(keep, topk_w, 0.0), accumulate=True)
    combine = dispatch * w_full[..., None].to(x.dtype)  # [T, E, C]

    xe = torch.einsum("td,tec->ecd", xt, dispatch)  # [E, C, D]
    ye = _expert_ffn(cfg, p, xe)
    out = torch.einsum("tec,ecd->td", combine, ye)
    return out.reshape(B, S, D), aux
