"""Abstract input/state specs for a dry run (port of ``repro.launch.specs``):
tensors on the meta device only, so nothing is allocated.  The reference
builds ``jax.ShapeDtypeStruct`` trees with ``jax.eval_shape``; the port runs
its own init functions on the meta device, their random draws made there
(``meta_draws``), so every tree has the reference's paths, shapes and
dtypes.

``input_specs(cfg, shape)`` follows the reference's contract: for training
steps {tokens, ...}; for serving the request batch (+ KV/state cache).  The
modality stubs surface here: whisper gets precomputed frame embeddings,
qwen2-vl gets patch embeddings + 3-stream M-RoPE position ids.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import whisper as W
from repro_torch.models.transformer import init_cache, init_lm
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils.flat import dtype_of

META = torch.device("meta")


class meta_draws(TorchFunctionMode):
    """Inside the block, ``torch.randn`` and ``torch.rand`` (the init
    functions draw from a CPU generator) return meta tensors: a full-width
    tree as shapes only."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.randn or func is torch.rand:
            kwargs = {k: v for k, v in kwargs.items() if k != "generator"}
            kwargs["device"] = META
        return func(*args, **kwargs)


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def leaf_spec(leaf) -> Tuple[Tuple[int, ...], torch.dtype]:
    """``(shape, dtype)`` of a spec leaf; a Python int (the optimizer's
    step) is the reference's int32 scalar."""
    if isinstance(leaf, int):
        return (), torch.int32
    return tuple(leaf.shape), leaf.dtype


def input_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """Model-input stand-ins for one step of the given input shape.

    train/prefill: the full [B, S] token batch (+ modality extras).
    decode: one new token per sequence: tokens [B, 1] (+ cache_index).
    """
    B, S = shape.global_batch, shape.seq_len
    cdt = dtype_of(cfg.compute_dtype)
    if shape.is_decode:
        return {"tokens": _sds((B, 1), torch.int32)}
    batch = {"tokens": _sds((B, S), torch.int32)}
    if cfg.rope.kind == "mrope":
        batch["positions"] = _sds((3, B, S), torch.int32)
    if cfg.family == "vlm" and cfg.num_frontend_tokens:
        batch["extra_embeds"] = _sds((B, cfg.num_frontend_tokens, cfg.d_model), cdt)
    if cfg.is_encoder_decoder:
        batch["frames"] = _sds((B, cfg.encoder_seq, cfg.d_model), cdt)
    return batch


def abstract_params(cfg: ArchConfig):
    with meta_draws():
        gen = torch.Generator()
        if cfg.is_encoder_decoder:
            return W.init_whisper(cfg, gen, device=META)
        return init_lm(cfg, gen, device=META)


def abstract_state(cfg: ArchConfig, optimizer: Optimizer):
    params = abstract_params(cfg)
    return {"params": params, "opt": optimizer.init(params)}


def abstract_cache(cfg: ArchConfig, shape: InputShape):
    """Decode-state stand-in: KV/state cache of length seq_len."""
    B, S = shape.global_batch, shape.seq_len
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.is_encoder_decoder:
        return W.init_whisper_cache(cfg, B, S, cdt, device=META)
    return init_cache(cfg, B, S, cdt, device=META)


def auto_microbatches(cfg: ArchConfig, shape: InputShape, dp_size: int) -> int:
    """Gradient-accumulation factor: drive per-device microbatch to ~1
    sequence for the big-activation training shape."""
    if shape.kind != "train":
        return 1
    if cfg.microbatches:
        return cfg.microbatches
    per_dp = shape.global_batch // max(dp_size, 1)
    return max(1, min(16, per_dp))
