"""Layers of the port's models (port of ``repro.models.layers``): norms,
activations, RoPE, GQA attention with an optional KV cache, dense FFNs.
Functional, like the reference: ``init_*`` returns a dict of tensors,
``*_fwd`` applies it.

Numerics follow the reference:
* the norm runs in f32 with the biased variance and ``cfg.norm_eps`` and
  casts back to the input dtype;
* ``gelu`` is the tanh approximation (``jax.nn.gelu``'s default);
* RoPE is rotate-half, with ``cos``/``sin`` cast to x's dtype before the
  products;
* ``_sdpa`` is a copy of the reference's attention: q scaled by 1/sqrt(hd)
  in f32, masked scores at -1e30, a softmax in f32, the probabilities cast
  to v's dtype before the second product, blocked over 512-query chunks
  from 2048 queries on (``_sdpa_chunked``).  It is written with
  ``einsum``/``softmax`` as the reference writes it, so it trains through
  autograd.  The encoder's bidirectional attention runs it, and so does
  the decoder's when the caller asks for ``differentiable=True`` (the LM
  train step: the kernels have no backward, as the reference's have none);
* otherwise causal or cached attention (the decoder) goes through
  ``kernels.ops.attention``: the hand-written kernel on the card, its plain
  version on the CPU.  It keeps the probabilities in f32, so at bf16 it
  differs from ``_sdpa`` by that rounding only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, RopeCfg
from repro_torch.kernels import ops


def normal_init(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, std²) drawn in f32 on the generator's device, then placed."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * std
    return x.to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    return normal_init(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype, device)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return normal_init(gen, (vocab, d), 0.02, dtype, device)


def init_norm(cfg: ArchConfig, dtype, device):
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def norm_fwd(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return out.to(x.dtype)


def activation(name: str):
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def init_attention(cfg: ArchConfig, gen: torch.Generator, dtype, device):
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": dense_init(gen, d, nq * hd, dtype, device),
        "wk": dense_init(gen, d, nkv * hd, dtype, device),
        "wv": dense_init(gen, d, nkv * hd, dtype, device),
        "wo": dense_init(gen, nq * hd, d, dtype, device),
    }


def rope_freqs(rope: RopeCfg, head_dim: int, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (rope.theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def rope_angles(rope: RopeCfg, positions: torch.Tensor, head_dim: int) -> torch.Tensor:
    """positions [..., S] -> angles [..., S, head_dim//2] (f32)."""
    inv = rope_freqs(rope, head_dim, positions.device)
    pos = positions.float() / rope.scaling
    return pos[..., None] * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; angles: [B, S, hd//2].  Rotate-half convention
    (HF Llama/Mistral/Gemma); cos and sin are cast to x's dtype first."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)  # [B,S,1,half]
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# Query lengths from this one on are blocked over CHUNK_Q-query chunks, so
# an [Sq, Sk] score matrix is never held whole (the reference's rule).
CHUNKED_THRESHOLD = 2048
CHUNK_Q = 512


def _mask(Sq: int, Sk: int, causal: bool, window: Optional[int], q_offset: int, device):
    """[Sq, Sk] visibility: query i sits at position q_offset + i."""
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _sdpa_chunked(q, k, v, *, causal: bool, window: Optional[int], q_offset: int,
                  chunk: int = CHUNK_Q):
    """``_sdpa`` one chunk of queries at a time; a query that sees no key
    gets zeros, as in the reference's blocked path."""
    Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[3]
    rep = q.shape[2] // k.shape[2]
    kf = torch.repeat_interleave(k, rep, dim=2).float()
    vf = torch.repeat_interleave(v, rep, dim=2)
    outs = []
    for q0 in range(0, Sq, chunk):
        qf = q[:, q0:q0 + chunk].float() * (hd ** -0.5)
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
        mask = _mask(qf.shape[1], Sk, causal, window, q_offset + q0, q.device)
        probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
        probs = torch.where(torch.isnan(probs), 0.0, probs)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), vf))
    return torch.cat(outs, dim=1)


def _sdpa(q, k, v, *, causal: bool, window: Optional[int] = None, q_offset: int = 0):
    """Attention with GQA broadcast, differentiable.  q [B, Sq, Hq, hd],
    k/v [B, Sk, Hkv, hd]; ``q_offset`` is the position of q[0], so a
    shorter q masks correctly against a longer key cache."""
    Sq = q.shape[1]
    if Sq >= CHUNKED_THRESHOLD and Sq % CHUNK_Q == 0:
        return _sdpa_chunked(q, k, v, causal=causal, window=window, q_offset=q_offset)
    hd = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    qf = q.float() / math.sqrt(hd)
    kf = torch.repeat_interleave(k.float(), rep, dim=2)
    vf = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    mask = _mask(Sq, k.shape[1], causal, window, q_offset, q.device)
    probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), vf)


def attention_fwd(cfg: ArchConfig, p, x: torch.Tensor, *, angles=None, causal: bool = True,
                  window: Optional[int] = None, q_offset: int = 0, kv_cache=None,
                  cache_index: Optional[int] = None, differentiable: bool = False):
    """Self-attention: x [B, Sq, D] -> (out [B, Sq, D], cache).

    ``kv_cache``: optional dict {"k": [B, S_cache, Hkv, hd], "v": ...}; with
    ``cache_index`` (an int) the new k/v are written into it IN PLACE at
    that offset and attention runs over the whole cache (the decode path);
    the same dict is returned.  The reference's ring-buffer cache is not
    ported.  Without a cache the returned cache is None.
    ``differentiable=True`` computes causal attention with ``_sdpa`` (which
    autograd can differentiate) instead of the kernel."""
    B, Sq, _ = x.shape
    hd, nq, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q = (x @ p["wq"]).reshape(B, Sq, nq, hd)
    k = (x @ p["wk"]).reshape(B, Sq, nkv, hd)
    v = (x @ p["wv"]).reshape(B, Sq, nkv, hd)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    if kv_cache is not None:
        ck, cv = kv_cache["k"], kv_cache["v"]
        if cache_index is not None:
            i = int(cache_index)
            if not 0 <= i <= ck.shape[1] - Sq:
                raise ValueError(f"cache_index {i} + {Sq} new positions overrun a cache of "
                                 f"{ck.shape[1]}")
            ck[:, i:i + Sq] = k.to(ck.dtype)
            cv[:, i:i + Sq] = v.to(cv.dtype)
        k, v = ck, cv
    if differentiable or not (causal or kv_cache is not None or window is not None):
        out = _sdpa(q, k, v, causal=causal, window=window, q_offset=q_offset)
    else:
        out = ops.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    out = out.reshape(B, Sq, nq * hd) @ p["wo"]
    return out.to(x.dtype), kv_cache


def init_glu(cfg: ArchConfig, gen: torch.Generator, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": dense_init(gen, d, f, dtype, device),
            "w_up": dense_init(gen, d, f, dtype, device),
            "w_down": dense_init(gen, f, d, dtype, device)}


def glu_fwd(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.act)
    return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def init_mlp(cfg: ArchConfig, gen: torch.Generator, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    return {"w_up": dense_init(gen, d, f, dtype, device),
            "w_down": dense_init(gen, f, d, dtype, device)}


def mlp_fwd(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    return activation(cfg.act)(x @ p["w_up"]) @ p["w_down"]
