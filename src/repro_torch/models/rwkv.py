"""RWKV6 ("Finch", arXiv:2404.05892) — attention-free mixer with
data-dependent decay, plus the RWKV channel-mix FFN.  Port of
``repro.models.rwkv``; parameter trees carry the reference's keys.

Time-mix recurrence per head (state S in R^{hd x hd}, f32):

    out_t = r_t · (diag(u) k_t v_tᵀ + S_t)
    S_t+1 = diag(w_t) S_t + k_t v_tᵀ

with per-token per-channel decay w_t = exp(-exp(w0 + LoRA_w(x̄_t))).  The
recurrence goes straight to the ``rwkv6_scan`` wrapper (the hand-written
kernel on the card, its plain version on the CPU) with
``logw = -exp(w0 + LoRA_w(x̄_t))``, unclamped as in the reference model
(``kernels.ops.rwkv6_mix`` clamps, so the model does not call it).  With
``differentiable=True`` (the LM train step; the kernel has no backward, as
the reference's has none) it runs ``_recurrence`` instead, a copy of the
reference's scan step that autograd can differentiate (on the meta device,
a dry run, its output shapes and its cost by formula).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models.layers import dense_init, normal_init
from repro_torch.utils import op_counts as _oc


def num_heads(cfg: ArchConfig) -> int:
    return cfg.d_model // cfg.ssm.head_dim


def _lora_init(gen, d: int, r: int, dtype, device):
    return {"a": dense_init(gen, d, r, dtype, device),
            "b": normal_init(gen, (r, d), 0.01, dtype, device)}


def _lora(p, x):
    return torch.tanh(x @ p["a"]) @ p["b"]


def init_time_mix(cfg: ArchConfig, gen: torch.Generator, dtype, device):
    """Draw order: mu, lora_mix, lora_w, u, wr, wk, wv, wg, wo."""
    d, r = cfg.d_model, cfg.ssm.decay_lora
    H, hd = num_heads(cfg), cfg.ssm.head_dim
    mu = torch.rand((5, d), generator=gen, dtype=torch.float32, device=gen.device)
    p = {
        "mu": mu.to(device=device, dtype=dtype),  # static lerp base (w,k,v,r,g)
        "lora_mix": _lora_init(gen, d, 32, dtype, device),  # shared data-dependent mix delta
        "lora_w": _lora_init(gen, d, r, dtype, device),
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=device),
        "u": normal_init(gen, (H, hd), 0.1, torch.float32, device),  # bonus for the current token
    }
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = dense_init(gen, d, d, dtype, device)
    p["ln_scale"] = torch.ones((d,), dtype=dtype, device=device)  # per-head group norm
    p["ln_bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def _token_shift(x, last=None):
    """Previous-token features; ``last`` [B,1,D] carries decode state."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _ddlerp(p, x, xx):
    """Data-dependent lerp between current (x) and shifted (xx) features."""
    base = xx + (x - xx) * p["mu"][0].to(x.dtype)  # coarse mix for the delta net
    delta = _lora(p["lora_mix"], base)
    return [xx + (x - xx) * (p["mu"][i].to(x.dtype) + delta) for i in range(5)]  # w,k,v,r,g


def _recurrence(r, k, v, w, u, s0):
    """The reference's ``lax.scan`` step over T in f32, under autograd:
    r, k, v, w [B, T, H, hd], u [H, hd], s0 [B, H, hd, hd] ->
    (y [B, T, H, hd], the final state)."""
    if r.is_meta:
        return _meta_recurrence(r, k, v, w, u, s0)
    S, ys = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # [B,H,hd,hd]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], u[None, :, :, None] * kv + S))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S


def _meta_recurrence(r, k, v, w, u, s0):
    """``_recurrence`` on the meta device (a dry run of the train step):
    ``(y, S)`` without the loop over T, its cost booked as
    ``rwkv_recurrence`` (``utils.op_counts.meta_recurrence``): the FLOPs the
    loop's ``einsum`` counts, 2·B·T·H·hd² forward and twice that backward,
    and the bytes a counter sees the loop's ops move forward,
    T·(12X + 9Y + 4·H·hd) with X = 4·B·H·hd² and Y = 4·B·H·hd (the
    backward's taken as four times that)."""
    B, T, H, hd = r.shape
    flops = 2 * B * T * H * hd * hd
    nbytes = T * (12 * 4 * B * H * hd * hd + 9 * 4 * B * H * hd + 4 * H * hd)
    return _oc.meta_recurrence("rwkv_recurrence", (r, k, v, w, u, s0),
                               (((B, T, H, hd), torch.float32), ((B, H, hd, hd), torch.float32)),
                               (flops, nbytes), (2 * flops, 4 * nbytes))


def time_mix_fwd(cfg: ArchConfig, p, x, *, state=None, return_state=False,
                 differentiable: bool = False):
    """x: [B,S,D] -> (y [B,S,D], new_state).  state={"S":[B,H,hd,hd] f32,
    "shift":[B,1,D]}; new_state is a fresh dict (None unless
    ``return_state``).  ``differentiable=True`` runs the recurrence as
    ``_recurrence`` instead of the kernel."""
    xx = _token_shift(x, state["shift"] if state is not None else None)
    yg, s_final = time_mix_heads(cfg, p, x, xx, s0=None if state is None else state["S"],
                                 differentiable=differentiable)
    out = yg @ p["wo"]
    new_state = {"S": s_final, "shift": x[:, -1:]} if return_state else None
    return out, new_state


def time_mix_heads(cfg: ArchConfig, p, x, xx, *, s0=None, differentiable: bool = False):
    """The time mix up to its output product, over the heads whose leaves
    ``p`` holds: x and its token shift xx [B,S,D] -> (y·g [B,S,H·hd] in x's
    dtype, the final state [B,H,hd,hd] f32), H = ``p["u"].shape[0]``.
    ``mu`` and ``lora_mix`` act on all D channels; ``wr/wk/wv/wg``, the
    decay's ``lora_w/b`` and ``w0``, ``u`` and the group norm's
    ``ln_scale``/``ln_bias`` may be a slot's block of H heads (the
    head-parallel time mix of ``models.partitioned``), whose group norm is
    then local.  ``s0`` (default zeros) is those heads' state."""
    B, S, _ = x.shape
    H, hd = p["u"].shape
    xw, xk, xv, xr, xg = _ddlerp(p, x, xx)

    # the reference casts r, k, v to f32 for the recurrence (rwkv.py:102)
    r = (xr @ p["wr"]).reshape(B, S, H, hd).float()
    k = (xk @ p["wk"]).reshape(B, S, H, hd).float()
    v = (xv @ p["wv"]).reshape(B, S, H, hd).float()
    g = F.silu(xg @ p["wg"])
    # data-dependent log-decay, <= 0: w = exp(logw) is in (0, 1]
    logw = -torch.exp(p["w0"] + _lora(p["lora_w"], xw).float()).reshape(B, S, H, hd)

    if s0 is None:
        s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    if differentiable:
        y, s_final = _recurrence(r, k, v, torch.exp(logw), p["u"], s0)
    else:
        y, s_final = rwkv6_scan(r.contiguous(), k.contiguous(), v.contiguous(),
                                logw.contiguous(), p["u"], s0)

    # per-head group norm (biased variance, eps 64e-5)
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, unbiased=False)
    yh = (y - mu) * torch.rsqrt(var + 64e-5)
    y = yh.reshape(B, S, H * hd) * p["ln_scale"].float() + p["ln_bias"].float()
    return y.to(x.dtype) * g, s_final


def init_channel_mix(cfg: ArchConfig, gen: torch.Generator, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dtype, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=dtype, device=device),
        "wk": dense_init(gen, d, f, dtype, device),
        "wv": dense_init(gen, f, d, dtype, device),
        "wr": dense_init(gen, d, d, dtype, device),
    }


def channel_mix_fwd(cfg: ArchConfig, p, x, *, last=None, return_state=False):
    xx = _token_shift(x, last)
    xk = xx + (x - xx) * p["mu_k"]
    xr = xx + (x - xx) * p["mu_r"]
    k = torch.square(F.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    return (out, x[:, -1:]) if return_state else (out, None)


def init_rwkv_state(cfg: ArchConfig, batch: int, dtype, device):
    H, hd = num_heads(cfg), cfg.ssm.head_dim
    return {
        "S": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        "shift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
        "cm_shift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
    }
