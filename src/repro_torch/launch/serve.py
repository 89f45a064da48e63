"""Batched serving launcher (port of ``repro.launch.serve``): loads (or
random-inits) a model, prefills a batch of synthetic prompts, and
greedy-decodes with the KV-cache engine on ``--device`` (default ``cuda``;
without a card it raises unless ``--device cpu`` is given).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --reduced \\
      --batch 4 --prompt-len 12 --new-tokens 16 --device cpu

``--arch`` takes every reference arch; an encoder-decoder arch (whisper)
exits as the reference's launcher does (``models.whisper`` drives it).
``--num-layers N`` keeps the config's first N layers (a depth cut at full
width, for a model that does not fit the card whole).  ``--load`` reads a
parameter tree ``.npz`` as either package writes it.
Random weights and prompts are drawn from ``--seed`` (a torch generator on
the device for the weights, numpy for the prompts), so they are not the
reference launcher's draws.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.models.transformer import init_lm
from repro_torch.serve.engine import Engine, GenerationResult
from repro_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="batched greedy serving (PyTorch port)")
    p.add_argument("--arch", choices=list(ARCH_IDS), default="gemma3-1b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--load", default=None, help="params checkpoint (.npz)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=12)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-layers", type=int, default=None,
                   help="serve only the config's first N layers (default: all)")
    p.add_argument("--device", default="cuda", help="where the model runs (cuda, cpu)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> GenerationResult:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if cfg.is_encoder_decoder:
        raise SystemExit("use whisper_decode directly for enc-dec archs")
    if args.num_layers is not None:
        if not 1 <= args.num_layers <= cfg.num_layers:
            raise SystemExit(f"--num-layers must be in 1..{cfg.num_layers}; got {args.num_layers}")
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    device = resolve_device(args.device)
    if args.load:
        params = ckpt.load(args.load, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_lm(cfg, gen, device=device)
    max_len = args.prompt_len + args.new_tokens + 1
    eng = Engine(cfg, params, max_len=max_len)
    prompts = np.random.default_rng(args.seed).integers(
        3, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    res = eng.generate(prompts, max_new_tokens=args.new_tokens)
    dt = time.time() - t0
    print(f"[serve] {cfg.name} on {device}: {args.batch} requests x {args.new_tokens} tokens "
          f"in {dt:.2f}s ({args.batch * args.new_tokens / dt:.1f} tok/s)")
    for i, row in enumerate(res.tokens):
        print(f"  req{i}: {row[: res.prompt_len].tolist()} -> {row[res.prompt_len:].tolist()}")
    return res


if __name__ == "__main__":
    main()
