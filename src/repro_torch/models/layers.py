"""Layers of the RoBERTa-style encoder (port of the parts of
``repro.models.layers`` the encoder runs).  Functional, like the reference:
``init_*`` returns a dict of tensors, ``*_fwd`` applies it.

Numerics follow the reference:
* the norm runs in f32 with the biased variance and ``cfg.norm_eps`` and
  casts back to the input dtype;
* ``gelu`` is the tanh approximation (``jax.nn.gelu``'s default);
* attention scales q by 1/sqrt(hd) in f32, softmaxes in f32, and casts the
  probabilities to v's dtype before the second product — written with
  ``matmul``/``softmax`` as the reference writes it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig


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


def attention_fwd(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Bidirectional self-attention with no cache (the encoder's case):
    x [B, S, D] -> [B, S, D].  GQA broadcasts kv heads to query heads."""
    B, S, _ = x.shape
    hd, nq, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q = (x @ p["wq"]).reshape(B, S, nq, hd)
    k = (x @ p["wk"]).reshape(B, S, nkv, hd)
    v = (x @ p["wv"]).reshape(B, S, nkv, hd)
    rep = nq // nkv
    qf = q.float() / math.sqrt(hd)
    kf = torch.repeat_interleave(k.float(), rep, dim=2)
    vf = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), vf)
    out = out.reshape(B, S, nq * hd) @ p["wo"]
    return out.to(x.dtype)


def init_mlp(cfg: ArchConfig, gen: torch.Generator, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    return {"w_up": dense_init(gen, d, f, dtype, device),
            "w_down": dense_init(gen, f, d, dtype, device)}


def mlp_fwd(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    return activation(cfg.act)(x @ p["w_up"]) @ p["w_down"]
