"""RoBERTa-style bidirectional encoder + classification heads — the model
family the paper runs ColD Fusion on (§4.2).  Port of
``repro.models.encoder``; parameter trees carry the reference's keys, so a
flat row means the same thing in both packages.

ColD Fusion averages the shared body; each contributor keeps a private
per-dataset head.  Pre-LayerNorm, as in the reference.  The encoder always
trains, so its attention is ``_sdpa`` (``differentiable=True``): the
reference computes it in plain XLA too.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.utils.device import resolve_device
from repro_torch.utils.flat import dtype_of


def init_encoder_body(cfg: ArchConfig, gen: torch.Generator, *,
                      device="cuda") -> Dict[str, Any]:
    """Random body drawn from ``gen`` (on the generator's device, then
    placed on ``device``).  Draw order: embed, pos, then per layer wq, wk,
    wv, wo, w_up, w_down."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "pos": L.normal_init(gen, (cfg.max_seq_len, cfg.d_model), 0.02, dtype, device),
        "final_norm": L.init_norm(cfg, dtype, device),
        "layers": {},
    }
    for i in range(cfg.num_layers):
        params["layers"][f"layer{i}"] = {
            "norm1": L.init_norm(cfg, dtype, device),
            "attn": L.init_attention(cfg, gen, dtype, device),
            "norm2": L.init_norm(cfg, dtype, device),
            "mlp": L.init_mlp(cfg, gen, dtype, device),
        }
    return params


def encode(cfg: ArchConfig, body, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> hidden states [B, S, D]."""
    cdt = dtype_of(cfg.compute_dtype)
    S = tokens.shape[1]
    x = body["embed"][tokens].to(cdt) + body["pos"][None, :S].to(cdt)
    for i in range(cfg.num_layers):
        p = body["layers"][f"layer{i}"]
        out, _ = L.attention_fwd(cfg, p["attn"], L.norm_fwd(cfg, p["norm1"], x), causal=False,
                                 differentiable=True)
        x = x + out
        x = x + L.mlp_fwd(cfg, p["mlp"], L.norm_fwd(cfg, p["norm2"], x))
    return L.norm_fwd(cfg, body["final_norm"], x)


def init_cls_head(cfg: ArchConfig, gen: torch.Generator, num_classes: int, *,
                  device="cuda") -> Dict[str, Any]:
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    return {
        "dense": L.dense_init(gen, cfg.d_model, cfg.d_model, dtype, device),
        "out": L.dense_init(gen, cfg.d_model, num_classes, dtype, device),
        "bias": torch.zeros((num_classes,), dtype=dtype, device=device),
    }


def classify(cfg: ArchConfig, body, head, tokens: torch.Tensor) -> torch.Tensor:
    """Sequence classification from mean-pooled hidden states (every
    position; there is no pad mask) -> [B, C]."""
    h = encode(cfg, body, tokens)
    pooled = torch.tanh(torch.mean(h, dim=1) @ head["dense"])
    return pooled @ head["out"] + head["bias"]


def mlm_logits(cfg: ArchConfig, body, tokens: torch.Tensor) -> torch.Tensor:
    """Masked-LM logits with tied embeddings."""
    h = encode(cfg, body, tokens)
    return h @ body["embed"].T.to(h.dtype)
