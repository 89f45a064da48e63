"""Composable decoder LM (port of ``repro.models.transformer``):
attention (GQA, optional sliding window, per-layer RoPE theta or M-RoPE),
Mamba and RWKV6 mixers; GLU, MLP, MoE and RWKV channel-mix FFNs; the
reference's ``extra_embeds`` input (a stub modality frontend's embeddings
in place of the first positions' token embeddings).  The encoder-decoder
stack (whisper) is ``models/whisper.py``.

The parameter tree is the reference's: the full periods of the layer
pattern are stacked, ``scan/pos{i}`` leaves of shape ``[n_full, ...]``,
and the remainder layers sit under ``tail/layer{li}``, so ``FlatSpec``
gives the same spec in both packages.  The reference scans over the
stacked periods; here a Python loop walks views of them.  Decode state
(KV caches, Mamba and RWKV states) is stacked the same way and updated IN
PLACE.  ``RING_CACHE`` (the reference's lever ``REPRO_OPT_RING_CACHE``,
read at import as there) gives sliding-window layers a ring buffer of
``window`` slots instead of a cache of ``max_len``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, BlockCfg
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R
from repro_torch.utils.device import resolve_device
from repro_torch.utils.flat import dtype_of
from repro_torch.utils.pytree import tree_map

RING_CACHE = os.environ.get("REPRO_OPT_RING_CACHE", "0") == "1"


def _init_block(cfg: ArchConfig, blk: BlockCfg, gen, dtype, device) -> Dict[str, Any]:
    """One block's parameters.  Draw order: the mixer, then the FFN."""
    p: Dict[str, Any] = {"norm1": L.init_norm(cfg, dtype, device),
                         "norm2": L.init_norm(cfg, dtype, device)}
    if blk.mixer == "attn":
        p["attn"] = L.init_attention(cfg, gen, dtype, device)
    elif blk.mixer == "rwkv":
        p["rwkv"] = R.init_time_mix(cfg, gen, dtype, device)
    elif blk.mixer == "mamba":
        p["mamba"] = M.init_mamba(cfg, gen, dtype, device)
    else:
        raise ValueError(f"unknown mixer {blk.mixer!r}")
    if blk.ffn == "glu":
        p["glu"] = L.init_glu(cfg, gen, dtype, device)
    elif blk.ffn == "mlp":
        p["mlp"] = L.init_mlp(cfg, gen, dtype, device)
    elif blk.ffn == "rwkv_cm":
        p["rwkv_cm"] = R.init_channel_mix(cfg, gen, dtype, device)
    elif blk.ffn == "moe":
        p["moe"] = MOE.init_moe(cfg, gen, dtype, device)
    else:
        raise ValueError(f"unknown ffn {blk.ffn!r}")
    return p


def split_layers(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_full_periods, n_tail_layers)."""
    return cfg.num_layers // cfg.period, cfg.num_layers % cfg.period


def _stack_into(stacked, one, rep: int, n: int):
    """Copy one layer's tree into slot ``rep`` of ``[n, ...]`` leaves,
    allocating them at the first slot (one layer's draw is the only
    transient, however many layers)."""
    if stacked is None:
        stacked = tree_map(lambda x: torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                                                 device=x.device), one)
    tree_map(lambda s, x: s[rep].copy_(x), stacked, one)
    return stacked


def init_lm(cfg: ArchConfig, gen: torch.Generator, *, device="cuda") -> Dict[str, Any]:
    """Random LM drawn from ``gen`` (on the generator's device, then placed
    on ``device``).  Draw order: embed, lm_head (untied only), then the
    layers in order 0..num_layers-1."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    n_full, n_tail = split_layers(cfg)
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": L.init_norm(cfg, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, device)
    scan: Dict[str, Any] = {}
    for rep in range(n_full):
        for pos, blk in enumerate(cfg.pattern):
            one = _init_block(cfg, blk, gen, dtype, device)
            scan[f"pos{pos}"] = _stack_into(scan.get(f"pos{pos}"), one, rep, n_full)
    params["scan"] = scan
    params["tail"] = {}
    for t in range(n_tail):
        li = n_full * cfg.period + t
        params["tail"][f"layer{li}"] = _init_block(cfg, cfg.blocks[li], gen, dtype, device)
    return params


# ---------------------------------------------------------------------------
# caches (decode state)
# ---------------------------------------------------------------------------


def _init_block_cache(cfg: ArchConfig, blk: BlockCfg, batch: int, max_len: int, dtype,
                      device, lead=()):
    if blk.mixer == "attn":
        length = max_len
        if RING_CACHE and blk.window is not None:
            length = min(max_len, blk.window)
        shape = tuple(lead) + (batch, length, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if blk.mixer == "rwkv":
        one = R.init_rwkv_state(cfg, batch, dtype, device)
    elif blk.mixer == "mamba":
        one = M.init_mamba_state(cfg, batch, dtype, device)
    else:
        raise ValueError(blk.mixer)
    return tree_map(lambda x: x.expand(tuple(lead) + tuple(x.shape)).contiguous(), one)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
               device="cuda") -> Dict[str, Any]:
    """Zeroed decode state for ``batch`` sequences of up to ``max_len``
    positions, stacked like the parameters.  ``forward_lm`` updates it in
    place; a sliding-window layer's cache is a ring of ``window`` slots
    when ``RING_CACHE`` is on."""
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.compute_dtype)
    n_full, n_tail = split_layers(cfg)
    cache: Dict[str, Any] = {"scan": {}, "tail": {}}
    if n_full:
        for pos, blk in enumerate(cfg.pattern):
            cache["scan"][f"pos{pos}"] = _init_block_cache(cfg, blk, batch, max_len, dtype,
                                                           device, lead=(n_full,))
    for t in range(n_tail):
        li = n_full * cfg.period + t
        cache["tail"][f"layer{li}"] = _init_block_cache(cfg, cfg.blocks[li], batch, max_len,
                                                        dtype, device)
    return cache


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> embeddings in the compute dtype; gemma's
    ``sqrt(d_model)`` factor is rounded to the compute dtype first, as in
    the reference (in bf16, sqrt(1152) = 33.941 becomes 34.0)."""
    cdt = dtype_of(cfg.compute_dtype)
    x = params["embed"][tokens].to(cdt)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt, device=x.device)
    return x


def _rope_angles(cfg: ArchConfig, positions, seq: int, batch: int, device):
    """Rotation angles for every distinct theta in the pattern:
    {theta: [B, S, head_dim//2]}, or None for rope-free models.  M-RoPE
    takes positions [3, B, S]; 2-D positions (plain text) drive all three
    streams (t = h = w)."""
    if cfg.rope.kind == "none":
        return None
    if positions is None:
        positions = torch.arange(seq, device=device)[None].expand(batch, seq)
    if cfg.rope.kind == "mrope":
        if positions.ndim == 2:
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return {cfg.rope.theta: L.mrope_merge_angles(cfg.rope, positions, cfg.head_dim)}
    out = {}
    for th in {blk.rope_theta or cfg.rope.theta for blk in cfg.pattern}:
        out[th] = L.rope_angles(dataclasses.replace(cfg.rope, theta=th), positions, cfg.head_dim)
    return out


def _apply_block(cfg: ArchConfig, blk: BlockCfg, p, x, angles, *, cache=None,
                 cache_index=None, q_offset: int, differentiable: bool):
    """One block: (x, aux loss 0-d f32 or None).  Writes its decode state
    into ``cache`` in place."""
    h = L.norm_fwd(cfg, p["norm1"], x)
    if blk.mixer == "attn":
        ang = None if angles is None else angles[blk.rope_theta or cfg.rope.theta]
        out, _ = L.attention_fwd(cfg, p["attn"], h, angles=ang, causal=True, window=blk.window,
                                 q_offset=q_offset, kv_cache=cache, cache_index=cache_index,
                                 differentiable=differentiable)
    elif blk.mixer == "rwkv":
        out, st = R.time_mix_fwd(cfg, p["rwkv"], h, state=cache, return_state=cache is not None,
                                 differentiable=differentiable)
        if cache is not None:
            cache["S"].copy_(st["S"])
            cache["shift"].copy_(st["shift"])
    elif blk.mixer == "mamba":
        out, st = M.mamba_fwd(cfg, p["mamba"], h, state=cache, return_state=cache is not None)
        if cache is not None:
            cache["h"].copy_(st["h"])
            cache["conv"].copy_(st["conv"])
    else:
        raise ValueError(f"unknown mixer {blk.mixer!r}")
    x = x + out
    h2 = L.norm_fwd(cfg, p["norm2"], x)
    aux = None
    if blk.ffn == "glu":
        f = L.glu_fwd(cfg, p["glu"], h2)
    elif blk.ffn == "mlp":
        f = L.mlp_fwd(cfg, p["mlp"], h2)
    elif blk.ffn == "moe":
        f, aux = MOE.moe_fwd(cfg, p["moe"], h2)
    elif blk.ffn == "rwkv_cm":
        last = None if cache is None else cache["cm_shift"]
        f, cm = R.channel_mix_fwd(cfg, p["rwkv_cm"], h2, last=last,
                                  return_state=cache is not None)
        if cache is not None:
            cache["cm_shift"].copy_(cm)
    else:
        raise ValueError(f"unknown ffn {blk.ffn!r}")
    return x + f, aux


def _layers(cfg: ArchConfig, tree):
    """``[(layer index, block cfg, subtree)]`` in layer order, the stacked
    periods as views of their slot."""
    n_full, n_tail = split_layers(cfg)
    out = []
    for rep in range(n_full):
        for pos, blk in enumerate(cfg.pattern):
            sub = tree_map(lambda x, r=rep: x[r], tree["scan"][f"pos{pos}"])
            out.append((rep * cfg.period + pos, blk, sub))
    for t in range(n_tail):
        li = n_full * cfg.period + t
        out.append((li, cfg.blocks[li], tree["tail"][f"layer{li}"]))
    return out


def forward_lm(cfg: ArchConfig, params, tokens: torch.Tensor, *,
               positions: Optional[torch.Tensor] = None, extra_embeds=None,
               cache: Optional[Dict[str, Any]] = None, cache_index: Optional[int] = None,
               differentiable: bool = False):
    """Run the LM: tokens [B, S] -> (logits [B, S, V], aux_loss 0-d f32,
    cache | None).  ``aux_loss`` is the MoE layers' load-balance losses
    summed (0 without MoE layers).

    ``positions``: [B, S] (or [3, B, S] for M-RoPE) position ids; by
    default 0..S-1, offset by ``cache_index`` with a cache.
    ``extra_embeds`` [B, N, D] (the stub modality frontend's output)
    replaces the embeddings of the first N positions.

    With ``cache`` the step is incremental: attention attends over the
    cache and Mamba and RWKV mixers resume their state; ``cache_index``
    (an int) is the write offset (the number of positions already in the
    cache).  The cache is updated IN PLACE and returned.

    ``differentiable=True`` (the train step's choice) computes attention
    and the RWKV recurrence as plain PyTorch that autograd can
    differentiate, as the reference's train step does; by default every
    block runs the kernels, which have no backward."""
    B, S = tokens.shape
    dev = tokens.device
    x = embed_tokens(cfg, params, tokens)
    if extra_embeds is not None:
        n = extra_embeds.shape[1]
        x = torch.cat([extra_embeds.to(x.dtype), x[:, n:]], dim=1)
    if positions is None and cache_index is not None:
        positions = (torch.arange(S, device=dev)[None] + int(cache_index)).expand(B, S)
    angles = _rope_angles(cfg, positions, S, B, dev)
    q_offset = 0 if cache_index is None else int(cache_index)

    caches = None if cache is None else {li: c for li, _, c in _layers(cfg, cache)}
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    for li, blk, p in _layers(cfg, params):
        x, aux = _apply_block(cfg, blk, p, x, angles,
                              cache=None if caches is None else caches[li],
                              cache_index=cache_index, q_offset=q_offset,
                              differentiable=differentiable)
        if aux is not None:
            aux_total = aux_total + aux

    x = L.norm_fwd(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits, aux_total, cache
