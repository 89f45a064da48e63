"""Layers of the port's models (port of ``repro.models.layers``): norms,
activations, RoPE and M-RoPE, GQA attention with an optional KV cache (a
ring buffer for sliding-window layers) or a cross-attention source, dense
FFNs.  Functional, like the reference: ``init_*`` returns a dict of
tensors, ``*_fwd`` applies it.

Numerics follow the reference:
* the norm runs in f32 with the biased variance and ``cfg.norm_eps`` and
  casts back to the input dtype;
* ``gelu`` is the tanh approximation (``jax.nn.gelu``'s default);
* RoPE is rotate-half, with ``cos``/``sin`` cast to x's dtype before the
  products;
* ``_sdpa`` is a copy of the reference's attention: q scaled by 1/sqrt(hd)
  in f32, masked scores at -1e30, a softmax in f32, the probabilities cast
  to v's dtype before the second product, blocked over 512-query chunks
  from 2048 queries on (``_sdpa_chunked``, which scores only the keys a
  sliding window can see when ``OPT_WINDOW_SLICING`` is on).  It is
  written with ``einsum``/``softmax`` as the reference writes it, so it
  trains through autograd.  ``attention_fwd`` runs it when the caller asks
  for ``differentiable=True`` (the LM train step, and the RoBERTa encoder,
  which always trains: the kernels have no backward, as the reference's
  have none);
* otherwise attention goes through ``kernels.ops.attention``: the
  hand-written kernel on the card, its plain version on the CPU.  It keeps
  the probabilities in f32, so at bf16 it differs from ``_sdpa`` by that
  rounding only.  A ring-buffer decode step runs it over the ring with
  ``q_offset = min(i, W - 1)``: the reference's reconstructed positions
  keep exactly slots ``0..min(i, W - 1)`` visible, and the keys' order
  does not change a softmax.
"""
from __future__ import annotations

import math
import os
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


def mrope_merge_angles(rope: RopeCfg, positions_3d: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Qwen2-VL M-RoPE: positions_3d [3, B, S] (temporal, height, width
    ids) -> angles [B, S, head_dim//2].  The head_dim/2 frequency slots
    split into ``rope.mrope_sections`` (t, h, w) chunks, each driven by its
    own position stream; identical t/h/w ids give ordinary RoPE."""
    sections = rope.mrope_sections
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope_sections {sections} must sum to head_dim // 2 = {head_dim // 2}")
    inv = rope_freqs(rope, head_dim, positions_3d.device)
    ang_all = (positions_3d.float() / rope.scaling)[..., None] * inv  # [3, B, S, half]
    chunks, start = [], 0
    for axis, sec in enumerate(sections):
        chunks.append(ang_all[axis, ..., start:start + sec])
        start += sec
    return torch.cat(chunks, dim=-1)


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

# The reference's lever REPRO_OPT_WINDOW, read at import as there: the
# blocked path scores a sliding-window layer's chunk of queries only
# against the window + chunk keys it can see (same outputs, less work).
OPT_WINDOW_SLICING = os.environ.get("REPRO_OPT_WINDOW", "0") == "1"


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: Optional[int]):
    """[Sq, Sk] visibility from the queries' positions [Sq, 1] and the
    keys' [1, Sk]."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[1]), dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _positions(n: int, start: int, device) -> torch.Tensor:
    return start + torch.arange(n, device=device)


def _sdpa_chunked(q, k, v, *, causal: bool, window: Optional[int], q_offset: int,
                  chunk: int = CHUNK_Q):
    """``_sdpa`` one chunk of queries at a time; a query that sees no key
    gets zeros, as in the reference's blocked path.  With
    ``OPT_WINDOW_SLICING`` a causal windowed chunk starting at position q0
    scores only keys ``[start, start + W)``, W = min(Sk, window + chunk),
    start = clip(q0 - window + 1, 0, Sk - W)."""
    Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[3]
    rep = q.shape[2] // k.shape[2]
    kf = torch.repeat_interleave(k, rep, dim=2).float()
    vf = torch.repeat_interleave(v, rep, dim=2)
    W = Sk
    if OPT_WINDOW_SLICING and window is not None and causal:
        W = min(Sk, window + chunk)
    outs = []
    for c0 in range(0, Sq, chunk):
        q0 = q_offset + c0
        qf = q[:, c0:c0 + chunk].float() * (hd ** -0.5)
        start = min(max(q0 - window + 1, 0), Sk - W) if W < Sk else 0
        kw, vw = kf[:, start:start + W], vf[:, start:start + W]
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kw)
        mask = _mask(_positions(qf.shape[1], q0, q.device)[:, None],
                     _positions(W, start, q.device)[None, :], causal, window)
        probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
        probs = torch.where(torch.isnan(probs), 0.0, probs)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), vw))
    return torch.cat(outs, dim=1)


def _sdpa(q, k, v, *, causal: bool, window: Optional[int] = None, q_offset: int = 0,
          k_positions: Optional[torch.Tensor] = None):
    """Attention with GQA broadcast, differentiable.  q [B, Sq, Hq, hd],
    k/v [B, Sk, Hkv, hd]; ``q_offset`` is the position of q[0], so a
    shorter q masks correctly against a longer key cache.  ``k_positions``
    [Sk] overrides each key slot's position (a ring buffer; slots at a
    position < 0 are never visible)."""
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq >= CHUNKED_THRESHOLD and Sq % CHUNK_Q == 0 and k_positions is None:
        return _sdpa_chunked(q, k, v, causal=causal, window=window, q_offset=q_offset)
    hd = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    qf = q.float() / math.sqrt(hd)
    kf = torch.repeat_interleave(k.float(), rep, dim=2)
    vf = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    k_pos = _positions(Sk, 0, q.device) if k_positions is None else k_positions
    mask = _mask(_positions(Sq, q_offset, q.device)[:, None], k_pos[None, :], causal, window)
    if k_positions is not None:
        mask &= k_pos[None, :] >= 0
    probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), vf)


def attention_fwd(cfg: ArchConfig, p, x: torch.Tensor, *, angles=None, causal: bool = True,
                  window: Optional[int] = None, q_offset: int = 0, kv_cache=None,
                  cache_index: Optional[int] = None, kv_source: Optional[torch.Tensor] = None,
                  differentiable: bool = False):
    """Self- (or cross-) attention: x [B, Sq, D] -> (out [B, Sq, D], cache).

    ``kv_cache``: optional dict {"k": [B, S_cache, Hkv, hd], "v": ...}; with
    ``cache_index`` (an int) the new k/v are written into it IN PLACE at
    that offset and attention runs over the whole cache (the decode path);
    the same dict is returned.  A cache of exactly ``window`` slots at a
    one-token step is the reference's RING buffer: the write goes to slot
    ``cache_index % window``.  Without a cache the returned cache is None.
    ``kv_source`` [B, Skv, D]: keys and values are projected from it
    (cross-attention), k is not rotated, and no query is masked.
    ``differentiable=True`` computes attention with ``_sdpa`` (which
    autograd can differentiate) instead of the kernel."""
    B, Sq, _ = x.shape
    hd, nq, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q = (x @ p["wq"]).reshape(B, Sq, nq, hd)
    src = x if kv_source is None else kv_source
    k = (src @ p["wk"]).reshape(B, src.shape[1], nkv, hd)
    v = (src @ p["wv"]).reshape(B, src.shape[1], nkv, hd)
    if angles is not None:
        q = apply_rope(q, angles)
        if kv_source is None:
            k = apply_rope(k, angles)
    causal = causal and kv_source is None
    ring = None
    if kv_cache is not None:
        ck, cv = kv_cache["k"], kv_cache["v"]
        if cache_index is not None:
            i, ring = cache_slot(ck.shape[1], cache_index, Sq, window)
            ck[:, i:i + Sq] = k.to(ck.dtype)
            cv[:, i:i + Sq] = v.to(cv.dtype)
        k, v = ck, cv
    if ring is not None and differentiable:
        # the reference's positions p(s) = i - ((i - s) mod W); unwritten slots < 0
        s_idx = _positions(window, 0, q.device)
        out = _sdpa(q, k, v, causal=causal, window=window, q_offset=q_offset,
                    k_positions=ring - torch.remainder(ring - s_idx, window))
    elif differentiable:
        out = _sdpa(q, k, v, causal=causal, window=window, q_offset=q_offset)
    else:
        out = kernel_attention(q, k, v, causal=causal, window=window, q_offset=q_offset, ring=ring)
    out = out.reshape(B, Sq, nq * hd) @ p["wo"]
    return out.to(x.dtype), kv_cache


def cache_slot(length: int, cache_index, Sq: int, window: Optional[int]):
    """``(write offset, ring position or None)`` of ``Sq`` new positions at
    ``cache_index`` in a cache of ``length`` slots: a cache of exactly
    ``window`` slots at a one-token step is the reference's ring buffer
    (the write goes to slot ``cache_index % window``; the ring position is
    ``cache_index``); otherwise the positions must fit."""
    i = int(cache_index)
    if window is not None and length == window and Sq == 1:
        return i % window, i
    if not 0 <= i <= length - Sq:
        raise ValueError(f"cache_index {i} + {Sq} new positions overrun a cache of {length}")
    return i, None


def cache_block(length: int, cache_index, window: Optional[int], r: int, R: int):
    """A one-token step at ``cache_index`` in data slot ``r``'s block of a
    cache of ``length`` slots whose sequence is split over ``R`` slots (a
    context-parallel decode): ``(write offset in the block, or None where
    another slot's block owns the position, the block's q_offset, the
    window to mask with)``.  A linear cache writes position
    ``cache_index``, and its block ``r`` sees it at ``cache_index - r L /
    R`` under the layer's window.  A ring (``cache_slot``) writes slot
    ``cache_index % W``, and block ``r`` sees its slots up to ``min(
    cache_index, W - 1) - r W / R`` causally: negative where the ring has
    not reached the block yet (no visible key), past its end once the ring
    has wrapped (every slot visible)."""
    i, ring = cache_slot(length, cache_index, 1, window)
    blk = length // R
    lo = r * blk
    write = i - lo if lo <= i < lo + blk else None
    if ring is not None:
        return write, min(ring, length - 1) - lo, None
    return write, i - lo, window


def block_span(start: int, n: int, r: int, blk: int):
    """Of the positions ``[start, start + n)``, those block ``r`` of
    ``blk`` slots holds (``[r blk, (r + 1) blk)``): ``(offset among the n,
    offset in the block, count)``, count 0 where it holds none."""
    lo, hi = max(start, r * blk), min(start + n, (r + 1) * blk)
    return lo - start, lo - r * blk, max(0, hi - lo)


def kernel_attention(q, k, v, *, causal: bool, window: Optional[int], q_offset: int,
                     ring: Optional[int] = None) -> torch.Tensor:
    """``kernels.ops.attention`` over the keys ``k``, ``v`` (a cache, or
    the sequence's own); over a ring buffer (``ring`` = the step's
    position) with ``q_offset = min(ring, W - 1)`` and no mask beyond
    causality (see the module docstring)."""
    if ring is not None:
        return ops.attention(q, k, v, causal=True, window=None,
                             q_offset=min(ring, k.shape[1] - 1))
    return ops.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


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
