"""Train, eval, prefill and serve steps for the decoder LM (port of
``repro.train.step``).

``make_train_step`` returns ``(state, batch) -> (state, metrics)``, a pure
function like the reference's: the new parameters and optimizer state are
new tensors and the old ones are left as they were.  The batch splits into
``microbatches`` equal slices of the batch axis (axis 0; axis 1 of M-RoPE
positions [3, B, S]) whose gradients are summed in f32 and averaged (what
the reference's ``lax.scan`` over microbatches computes).  The MoE
load-balance loss enters the objective at ``cfg.moe.aux_loss_weight`` (the
reference's default weight) and is reported as the metric ``aux``.  The
forward pass of the train step runs with ``differentiable=True``: the
kernels have no backward (the reference has none either and trains through
XLA), so attention and the RWKV recurrence are the plain PyTorch copies of
the reference's.  Every inference step
(eval, prefill, serve) runs on the kernels.  An encoder-decoder config
(whisper) runs ``models.whisper``: the batch's ``frames`` through the
encoder, its ``tokens`` through the decoder.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import whisper as W
from repro_torch.models.transformer import forward_lm
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.train.losses import lm_loss
from repro_torch.utils.pytree import tree_device, tree_leaves, tree_map, tree_unflatten


def make_train_state(params, optimizer: Optimizer) -> Dict[str, Any]:
    return {"params": params, "opt": optimizer.init(params)}


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device``; token ids as int64."""
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _logits(cfg: ArchConfig, params, batch, *, differentiable: bool):
    """(logits [B, S, V], aux loss) of the batch, no cache."""
    if cfg.is_encoder_decoder:
        enc_out = W.whisper_encode(cfg, params, batch["frames"], differentiable=differentiable)
        logits, aux, _ = W.whisper_decode(cfg, params, batch["tokens"], enc_out,
                                          differentiable=differentiable)
        return logits, aux
    logits, aux, _ = forward_lm(cfg, params, batch["tokens"], positions=batch.get("positions"),
                                extra_embeds=batch.get("extra_embeds"),
                                differentiable=differentiable)
    return logits, aux


def _microbatch(batch, i: int, n: int):
    """Slice ``i`` of ``n`` along the batch axis: axis 1 of M-RoPE positions
    [3, B, S], axis 0 of everything else.  (The reference picks the axis by
    comparing a leaf's first dim with the batch size, which takes the wrong
    axis for positions at a global batch of 3.)"""
    out = {}
    for key, v in batch.items():
        axis = 1 if key == "positions" and v.ndim == 3 else 0
        mb = v.shape[axis] // n
        out[key] = v.narrow(axis, i * mb, mb)
    return out


def _lm_loss_fn(cfg: ArchConfig, params, batch, aux_weight: float, *, differentiable: bool):
    logits, aux = _logits(cfg, params, batch, differentiable=differentiable)
    loss = lm_loss(logits, batch["tokens"], batch.get("mask"))
    return loss + aux_weight * aux, loss, aux


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, *, microbatches: int = 1,
                    clip_norm: float = 1.0, aux_weight: Optional[float] = None,
                    grad_sync: Optional[Callable] = None, grad_shardings=None) -> Callable:
    """Build the train step: the gradient of ``lm_loss`` (accumulated over
    ``microbatches``), ``grad_sync``, ``clip_by_global_norm(clip_norm)``,
    then ``optimizer.update``; metrics ``loss``, ``aux`` (the MoE
    load-balance loss, 0 without MoE layers; weighted by ``aux_weight``,
    default ``cfg.moe.aux_loss_weight``, in the objective) and
    ``grad_norm`` (the norm before clipping), 0-d f32 tensors; ``loss`` and
    ``aux`` are means over the microbatches.

    ``grad_sync(grads) -> grads``: the hook a distribution strategy uses to
    reduce gradients across devices; identity by default.
    ``grad_shardings`` pins the reference's gradient accumulator to a mesh
    layout and waits for the model-side mesh (ROADMAP.md A6)."""
    if grad_shardings is not None:
        raise NotImplementedError("make_train_step(grad_shardings=) needs the model-side mesh "
                                  "(parameter and gradient shardings), which is not ported yet "
                                  "(ROADMAP.md A6)")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1; got {microbatches}")
    aux_w = cfg.moe.aux_loss_weight if aux_weight is None else aux_weight

    def grads_of(params, leaves, batch):
        """(loss, aux, gradient per leaf) on one (micro)batch."""
        with torch.enable_grad():
            live = [x.detach().requires_grad_(True) for x in leaves]
            total, loss, aux = _lm_loss_fn(cfg, tree_unflatten(params, live), batch, aux_w,
                                           differentiable=True)
            grads = torch.autograd.grad(total, live)
        return loss.detach(), aux.detach(), grads

    @torch.no_grad()
    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        batch = _on_device(batch, tree_device(params))
        if microbatches > 1:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"a batch of {B} does not split into {microbatches} equal "
                                 "microbatches")
            gacc = [torch.zeros_like(x, dtype=torch.float32) for x in leaves]
            loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            aux_sum = torch.zeros_like(loss_sum)
            for i in range(microbatches):
                loss, aux, grads = grads_of(params, leaves, _microbatch(batch, i, microbatches))
                for acc, g in zip(gacc, grads):
                    acc.add_(g)
                loss_sum += loss
                aux_sum += aux
            grads = [g / microbatches for g in gacc]
            loss, aux = loss_sum / microbatches, aux_sum / microbatches
        else:
            loss, aux, grads = grads_of(params, leaves, batch)
        grads = tree_unflatten(params, grads)
        if grad_sync is not None:
            grads = grad_sync(grads)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, new_opt = optimizer.update(grads, state["opt"], params)
        new_params = tree_map(torch.add, params, updates)
        return {"params": new_params, "opt": new_opt}, {"loss": loss, "aux": aux,
                                                        "grad_norm": gnorm}

    return train_step


def make_eval_step(cfg: ArchConfig) -> Callable:
    """``(params, batch) -> loss``: ``lm_loss`` of the batch (plus the aux
    loss at weight 0), computed on the kernels without gradients."""

    @torch.no_grad()
    def eval_step(params, batch):
        total, _, _ = _lm_loss_fn(cfg, params, _on_device(batch, tree_device(params)), 0.0,
                               differentiable=False)
        return total

    return eval_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """Forward pass of the full prompt, no cache: ``(params, batch) ->
    last-position logits [B, V]`` (the next-token distribution)."""

    def prefill_step(params, batch):
        return _logits(cfg, params, batch, differentiable=False)[0][:, -1]

    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """One decode step against a KV/state cache: ``(params, cache, tokens
    [B, 1], cache_index) -> (logits [B, V], cache)``; the cache is updated
    in place and returned.  For an encoder-decoder config the cache is
    ``whisper.init_whisper_cache``'s, primed by ``prime_cross_cache``."""

    def serve_step(params, cache, tokens, cache_index):
        if cfg.is_encoder_decoder:
            logits, _, cache = W.whisper_decode(cfg, params, tokens, cache=cache,
                                                cache_index=cache_index)
        else:
            logits, _, cache = forward_lm(cfg, params, tokens, cache=cache,
                                          cache_index=cache_index)
        return logits[:, -1], cache

    return serve_step
