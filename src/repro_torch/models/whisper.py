"""Whisper-style encoder-decoder backbone (arXiv:2212.04356); port of
``repro.models.whisper``, whose parameter tree it carries.

As in the reference, the mel-spectrogram and conv feature extractor is a
stub: the encoder takes precomputed frame embeddings [B, n_frames, D].
Everything after it is real: the encoder stack, the decoder with self- and
cross-attention, and the KV caches.  Learned positions, pre-LayerNorm,
GELU MLPs, tied output embeddings.

Attention at inference runs ``kernels.ops.attention`` (the kernel on the
card): the encoder's bidirectional self-attention, the decoder's causal
self-attention and the cross-attention over the encoder states (the
reference computes all three in plain XLA).  ``differentiable=True`` (the
train step) runs ``_sdpa`` instead.  With a cache, the decoder writes its
self-attention k/v IN PLACE and the cross-attention reads the k/v that
``prime_cross_cache`` projected once from the encoder states.

Placed params (a replica × model grid, ``launch.sharding.device_put``)
take the partitioned encoder and priming here and the partitioned
decoder in ``train.step``'s steps (``models.partitioned``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.utils.device import resolve_device
from repro_torch.utils.flat import dtype_of
from repro_torch.utils.pytree import is_placed


def _init_enc_block(cfg: ArchConfig, gen, dtype, device):
    return {"norm1": L.init_norm(cfg, dtype, device),
            "attn": L.init_attention(cfg, gen, dtype, device),
            "norm2": L.init_norm(cfg, dtype, device),
            "mlp": L.init_mlp(cfg, gen, dtype, device)}


def _init_dec_block(cfg: ArchConfig, gen, dtype, device):
    return {"norm1": L.init_norm(cfg, dtype, device),
            "attn": L.init_attention(cfg, gen, dtype, device),
            "norm_x": L.init_norm(cfg, dtype, device),
            "xattn": L.init_attention(cfg, gen, dtype, device),
            "norm2": L.init_norm(cfg, dtype, device),
            "mlp": L.init_mlp(cfg, gen, dtype, device)}


def init_whisper(cfg: ArchConfig, gen: torch.Generator, max_target_len: Optional[int] = None,
                 *, device="cuda") -> Dict[str, Any]:
    """Random model drawn from ``gen`` (on the generator's device, then
    placed on ``device``); the decoder's learned positions cover
    ``max_target_len`` (default ``cfg.max_seq_len``).  Draw order: the
    encoder's positions and layers, then the decoder's embedding,
    positions and layers."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    max_target_len = max_target_len or cfg.max_seq_len
    enc = {"pos": L.normal_init(gen, (cfg.encoder_seq, cfg.d_model), 0.01, dtype, device),
           "final_norm": L.init_norm(cfg, dtype, device),
           "layers": {f"layer{i}": _init_enc_block(cfg, gen, dtype, device)
                      for i in range(cfg.encoder_layers)}}
    dec = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
           "pos": L.normal_init(gen, (max_target_len, cfg.d_model), 0.01, dtype, device),
           "final_norm": L.init_norm(cfg, dtype, device),
           "layers": {f"layer{i}": _init_dec_block(cfg, gen, dtype, device)
                      for i in range(cfg.num_layers)}}
    return {"enc": enc, "dec": dec}


def whisper_encode(cfg: ArchConfig, params, frames: torch.Tensor, *,
                   differentiable: bool = False, **grid_axes) -> torch.Tensor:
    """frames [B, n_frames, D] (the stub frontend's embeddings) -> encoder
    states [B, n_frames, D] in the compute dtype.  On params placed on a
    grid of several slots (``launch.sharding.device_put``) the encoder runs
    partitioned on the kernels and its states come back placed per replica
    (``train.step.partitioned_encode``; ``grid_axes``, its ``data_axis``
    and ``model_axis``, name the grid)."""
    if is_placed(params):
        from repro_torch.train.step import partitioned_encode  # step imports this module
        return partitioned_encode(cfg, params, frames, **grid_axes)
    enc = params["enc"]
    cdt = dtype_of(cfg.compute_dtype)
    x = frames.to(cdt) + enc["pos"][None, :frames.shape[1]].to(cdt)
    for i in range(cfg.encoder_layers):
        p = enc["layers"][f"layer{i}"]
        out, _ = L.attention_fwd(cfg, p["attn"], L.norm_fwd(cfg, p["norm1"], x), causal=False,
                                 differentiable=differentiable)
        x = x + out
        x = x + L.mlp_fwd(cfg, p["mlp"], L.norm_fwd(cfg, p["norm2"], x))
    return L.norm_fwd(cfg, enc["final_norm"], x)


def init_whisper_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
                       device="cuda") -> Dict[str, Any]:
    """Zeroed decoder caches: per layer the self-attention's ``k``/``v``
    [B, max_len, Hkv, hd] and the cross-attention's ``xk``/``xv``
    [B, encoder_seq, Hkv, hd] (filled by ``prime_cross_cache``)."""
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.compute_dtype)
    hd, nkv = cfg.head_dim, cfg.num_kv_heads

    def zeros(n):
        return torch.zeros((batch, n, nkv, hd), dtype=dtype, device=device)

    return {f"layer{i}": {"k": zeros(max_len), "v": zeros(max_len),
                          "xk": zeros(cfg.encoder_seq), "xv": zeros(cfg.encoder_seq)}
            for i in range(cfg.num_layers)}


def prime_cross_cache(cfg: ArchConfig, params, cache, enc_out: torch.Tensor, **grid_axes):
    """Project the encoder states into every decoder layer's cross k/v (new
    tensors in the cache's dicts, as the reference replaces them); returns
    the cache.  On placed params the cache is placed on their grid by
    ``cache_shardings`` and each slot writes its blocks in place
    (``train.step.partitioned_prime``; ``grid_axes``, its ``data_axis``
    and ``model_axis``, name the grid)."""
    if is_placed(params):
        from repro_torch.train.step import partitioned_prime  # step imports this module
        return partitioned_prime(cfg, params, cache, enc_out, **grid_axes)
    B, Se, _ = enc_out.shape
    hd, nkv = cfg.head_dim, cfg.num_kv_heads
    for i in range(cfg.num_layers):
        p = params["dec"]["layers"][f"layer{i}"]["xattn"]
        cache[f"layer{i}"]["xk"] = (enc_out @ p["wk"]).reshape(B, Se, nkv, hd)
        cache[f"layer{i}"]["xv"] = (enc_out @ p["wv"]).reshape(B, Se, nkv, hd)
    return cache


def whisper_decode(cfg: ArchConfig, params, tokens: torch.Tensor,
                   enc_out: Optional[torch.Tensor] = None, *, cache=None,
                   cache_index: Optional[int] = None, differentiable: bool = False):
    """Decoder forward: tokens [B, S] -> (logits [B, S, V], aux 0-d f32
    zero, cache | None).  Either ``enc_out`` (training, prefill) or a
    primed ``cache`` (incremental decode, updated in place) supplies the
    cross-attention's source.  The learned positions start at
    ``cache_index`` (0 without it); a position past the table raises (the
    reference's ``dynamic_slice`` would clamp silently)."""
    dec = params["dec"]
    B, S = tokens.shape
    cdt = dtype_of(cfg.compute_dtype)
    offset = 0 if cache_index is None else int(cache_index)
    if not 0 <= offset <= dec["pos"].shape[0] - S:
        raise ValueError(f"decoder positions {offset}..{offset + S - 1} run past the "
                         f"{dec['pos'].shape[0]} learned positions (max_target_len)")
    if cache is None and enc_out is None:
        raise ValueError("whisper_decode needs enc_out or a primed cache")
    x = dec["embed"][tokens].to(cdt) + dec["pos"][None, offset:offset + S].to(cdt)
    nq, hd = cfg.num_heads, cfg.head_dim
    for i in range(cfg.num_layers):
        p = dec["layers"][f"layer{i}"]
        c = None if cache is None else cache[f"layer{i}"]
        out, _ = L.attention_fwd(cfg, p["attn"], L.norm_fwd(cfg, p["norm1"], x), causal=True,
                                 q_offset=offset, kv_cache=c, cache_index=cache_index,
                                 differentiable=differentiable)
        x = x + out
        hx = L.norm_fwd(cfg, p["norm_x"], x)
        if c is not None:  # the primed cross k/v
            q = (hx @ p["xattn"]["wq"]).reshape(B, S, nq, hd)
            attend = L._sdpa if differentiable else ops.attention
            xout = attend(q, c["xk"], c["xv"], causal=False).reshape(B, S, nq * hd) \
                @ p["xattn"]["wo"]
        else:
            xout, _ = L.attention_fwd(cfg, p["xattn"], hx, kv_source=enc_out,
                                      differentiable=differentiable)
        x = x + xout.to(x.dtype)
        x = x + L.mlp_fwd(cfg, p["mlp"], L.norm_fwd(cfg, p["norm2"], x))
    x = L.norm_fwd(cfg, dec["final_norm"], x)
    logits = x @ dec["embed"].T.to(x.dtype)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device), cache
