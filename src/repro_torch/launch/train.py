"""End-to-end LM training driver (port of ``repro.launch.train``, one
device).

Trains an architecture (full or ``--reduced``) on the synthetic token
stream with the real train step (microbatching, the optimizer from the
config, the reference's warmup-cosine schedule) on
``--device`` (default ``cuda``; without a card it raises unless
``--device cpu`` is given).  Parameters and compute are f32 and ``remat``
is off, as in the reference's driver.  Weights are drawn from ``--seed`` by
a torch generator on the device, so they are not the reference launcher's
draws; the token stream is the same.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --reduced \\
      --steps 200 --batch 8 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --steps 30   # on the card

``--arch`` takes every reference arch.  As in the reference's driver, an
M-RoPE arch gets ``positions`` 0..seq-1 on all three streams, a vlm arch
zero ``extra_embeds`` for its frontend tokens, and an encoder-decoder arch
(whisper, built by ``init_whisper``) zero ``frames``.  ``--save`` writes
the trained parameters as an ``.npz`` that both packages'
``checkpoint.io.load`` read.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.data.synthetic import SyntheticSuite
from repro_torch.models import whisper as W
from repro_torch.models.transformer import init_lm
from repro_torch.optim.optimizers import make_optimizer, warmup_cosine_lr
from repro_torch.train.step import make_train_state, make_train_step
from repro_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LM training driver (PyTorch port)")
    p.add_argument("--arch", choices=list(ARCH_IDS), default="gemma3-1b")
    p.add_argument("--reduced", action="store_true",
                   help="train the smoke-scale variant (CPU-friendly)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--save", default=None, help="checkpoint path (.npz)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="where the model trains (cuda, cpu)")
    return p


def train_config(arch: str, *, reduced: bool, seq: int):
    """The driver's config: ``arch`` (reduced or not) in f32 without remat;
    roberta-base trains as a decoder with the default RoPE."""
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_config(cfg)
    if arch == "roberta-base":
        cfg = dataclasses.replace(cfg, rope=dataclasses.replace(cfg.rope, kind="default"))
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                               remat=False, max_seq_len=max(cfg.max_seq_len, seq))


def build_params(cfg, gen: torch.Generator, device):
    if cfg.is_encoder_decoder:
        return W.init_whisper(cfg, gen, max_target_len=cfg.max_seq_len, device=device)
    return init_lm(cfg, gen, device=device)


def train_batch(cfg, tokens: np.ndarray) -> Dict[str, np.ndarray]:
    """The reference driver's batch for ``tokens`` [B, S]: M-RoPE positions
    [3, B, S], a vlm's zero frontend embeddings, an encoder-decoder's zero
    frames."""
    B, S = tokens.shape
    batch = {"tokens": tokens}
    if cfg.rope.kind == "mrope":
        batch["positions"] = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).copy()
    if cfg.family == "vlm" and cfg.num_frontend_tokens:
        batch["extra_embeds"] = np.zeros((B, cfg.num_frontend_tokens, cfg.d_model), np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = np.zeros((B, cfg.encoder_seq, cfg.d_model), np.float32)
    return batch


def token_stream(cfg, *, steps: int, batch: int, seq: int, seed: int) -> np.ndarray:
    """``steps * batch`` sequences of the synthetic suite's LM stream over
    ``min(vocab, 512)`` tokens."""
    suite = SyntheticSuite(vocab_size=min(cfg.vocab_size, 512), num_tasks=8, seed=seed)
    stream = suite.lm_stream(steps * batch, seq, seed=seed)
    return np.clip(stream, 0, cfg.vocab_size - 1)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train; returns the config, the final state and every step's
    ``loss``, ``aux`` (the MoE load-balance loss), ``grad_norm`` and wall
    seconds (each step ends in a read of its loss, so the seconds include
    the device's work)."""
    args = build_parser().parse_args(argv)
    cfg = train_config(args.arch, reduced=args.reduced, seq=args.seq)
    device = resolve_device(args.device)
    print(f"[train] {cfg.name}: ~{cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps x batch {args.batch} x seq {args.seq}")
    params = build_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    opt = make_optimizer(cfg.optimizer, warmup_cosine_lr(args.lr, warmup=20, total=args.steps))
    state = make_train_state(params, opt)
    step = make_train_step(cfg, opt, microbatches=args.microbatches)
    stream = token_stream(cfg, steps=args.steps, batch=args.batch, seq=args.seq, seed=args.seed)

    history: Dict[str, list] = {"loss": [], "aux": [], "grad_norm": [], "step_s": []}
    t0 = time.time()
    for i in range(args.steps):
        ts = time.perf_counter()
        state, m = step(state, train_batch(cfg, stream[i * args.batch:(i + 1) * args.batch]))
        history["loss"].append(float(m["loss"]))
        history["aux"].append(float(m["aux"]))
        history["grad_norm"].append(float(m["grad_norm"]))
        history["step_s"].append(time.perf_counter() - ts)
        if (i + 1) % args.log_every == 0 or i == 0:
            dt = (time.time() - t0) / (i + 1)
            print(f"  step {i+1:4d}: loss={history['loss'][-1]:.4f} "
                  f"gnorm={history['grad_norm'][-1]:.2f} ({dt*1e3:.0f} ms/step)")
    print(f"[train] done in {time.time()-t0:.0f}s; final loss {history['loss'][-1]:.4f}")
    if args.save:
        ckpt.save(args.save, state["params"])
        print(f"[train] saved params to {args.save}")
    return {"cfg": cfg, "state": state, **history}


if __name__ == "__main__":
    main()
