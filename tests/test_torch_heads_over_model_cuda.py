"""Attention whose query heads the model axis does not divide, on the card:
``flash_attention`` at the per-slot shapes of such a grid (every slot all
4 query heads on gemma3-1b's one kv head: a prompt on ``prefill_tc``, a
decode step on ``decode``) against its plain version, and a reduced train
step and greedy run of gemma3-1b on (data 1, model 8) and of whisper at 6
query heads on (data 1, model 4) on the card against the same on the CPU
(whose results ``tests/test_torch_heads_over_model.py`` holds against the
JAX package's partitioned jit).  Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_heads_over_model_cuda.py

Each test skips without a card.  Tolerances (``chip_smoke.py``'s): a bf16
kernel output within 1 bf16 ulp + 2e-5 x max(1, max|plain|) of the plain
version; the train step's loss and grad_norm within rtol 1e-5 and its
params within rtol/atol 1e-5 of the CPU's (f32, TF32 off); the greedy
tokens and the collectives equal the CPU's, every attention launch on the
card's routes."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import transformer as TT
from repro_torch.models import whisper as TW
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_serve_step, make_train_state, make_train_step
from repro_torch.utils.pytree import tree_leaves_with_path

WINDOW = 512


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: flash_attention launches there")
    torch.backends.cuda.matmul.allow_tf32 = False


def _bf16_close(got, want):
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(g.abs(), w.abs())
    assert bool(((g - w).abs() <= ulp + 2e-5 * max(1.0, w.abs().max().item())).all())


def _qkv(Sq, Sk, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
            for shape in ((4, Sq, 4, 256), (4, Sk, 1, 256), (4, Sk, 1, 256)))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("route", ["prefill_tc", "decode"])
def test_every_head_on_a_slot_at_the_per_slot_shapes(route, window):
    """gemma3-1b's slot on (data 1, model 8): q [4, 512, 4, 256] over its 512
    keys on ``prefill_tc``, q [4, 1, 4, 256] at position 527 over a
    528-slot cache on ``decode``, each launched once on its route."""
    _card()
    if route == "prefill_tc":
        q, k, v = _qkv(512, 512, 36)
        kw = dict(causal=True, window=window)
    else:
        q, k, v = _qkv(1, 528, 37)
        kw = dict(causal=True, window=window, q_offset=527)
    before = dict(tfa.flash_attention.launches_by_route)
    got = tfa.flash_attention(q, k, v, **kw)
    assert tfa.flash_attention.launches_by_route[route] == before[route] + 1
    _bf16_close(got, tfa.flash_attention_plain(q, k, v, **kw))


def _gemma():
    cfg = reduce_config(get_config("gemma3-1b"))
    return dataclasses.replace(cfg, num_layers=2, pattern=cfg.pattern[:2])


def _six_heads():
    return dataclasses.replace(reduce_config(get_config("whisper-tiny"), d_model=192),
                               num_heads=6, num_kv_heads=6, head_dim=32)


def _train(arch, device):
    cfg = _gemma() if arch == "gemma3-1b" else _six_heads()
    mesh = tmesh.make_mesh((1, 8) if arch == "gemma3-1b" else (1, 4), ("data", "model"),
                           device=device)
    init = TT.init_lm if arch == "gemma3-1b" else TW.init_whisper
    opt = make_optimizer("sgd", constant_lr(0.05), momentum=0.9)
    state = make_train_state(init(cfg, torch.Generator().manual_seed(0), device="cpu"), opt)
    psh = tsh.params_shardings(mesh, state["params"], cfg)
    state = tsh.device_put(state, {"params": psh, "opt": tsh.opt_state_shardings(
        mesh, state["opt"], psh)})
    rng = np.random.default_rng(36)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (4, 8))}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((4, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    tmesh.reset_collectives()
    state, m = make_train_step(cfg, opt, grad_shardings=psh)(state, batch)
    counts = dict(tmesh.collectives)
    return m, {k: v.cpu() for k, v in tree_leaves_with_path(tsh.gather(state["params"]))}, counts


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-tiny"])
def test_train_step_on_the_card_matches_the_cpu(arch):
    """One SGD step with every query head on every model slot: loss,
    grad_norm, params and collectives as on the CPU."""
    _card()
    gm, gp, gc = _train(arch, "cuda")
    cm, cp, cc = _train(arch, "cpu")
    assert gc == cc
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(gm[k]), float(cm[k]), rtol=1e-5)
    for k in cp:
        np.testing.assert_allclose(gp[k].numpy(), cp[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def _generate(arch, device):
    rng = np.random.default_rng(26)
    tfa.reset_launches()
    tmesh.reset_collectives()
    if arch == "gemma3-1b":
        cfg = _gemma()
        mesh = tmesh.make_mesh((1, 8), ("data", "model"), device=device)
        params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
        placed = tsh.device_put(params, tsh.params_shardings(mesh, params, cfg))
        prompts = rng.integers(3, cfg.vocab_size, (4, 8))
        toks = Engine(cfg, placed, max_len=16).generate(prompts, max_new_tokens=6).tokens
    else:
        cfg = _six_heads()
        mesh = tmesh.make_mesh((1, 4), ("data", "model"), device=device)
        params = TW.init_whisper(cfg, torch.Generator().manual_seed(0), device="cpu")
        placed = tsh.device_put(params, tsh.params_shardings(mesh, params, cfg))
        frames = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        prompts = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 4)))
        cache = TW.init_whisper_cache(cfg, 2, 16, device="cpu")
        cache = tsh.device_put(cache, tsh.cache_shardings(mesh, cache, cfg))
        cache = TW.prime_cross_cache(cfg, placed, cache, TW.whisper_encode(cfg, placed, frames))
        step = make_serve_step(cfg)
        logits, cache = step(placed, cache, prompts, 0)
        got = [torch.argmax(logits, -1).cpu()]
        for t in range(5):
            logits, cache = step(placed, cache, got[-1][:, None], 4 + t)
            got.append(torch.argmax(logits, -1).cpu())
        toks = torch.stack(got, 1).numpy()
    return np.asarray(toks), dict(tfa.flash_attention.launches_by_route), \
        dict(tmesh.collectives)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-tiny"])
def test_greedy_run_on_the_card_matches_the_cpu(arch):
    """Greedy 6 tokens (f32) with every query head on every model slot:
    the tokens and the collectives as on the CPU, the attention launched on
    the card."""
    _card()
    g_toks, g_routes, g_cols = _generate(arch, "cuda")
    c_toks, _, c_cols = _generate(arch, "cpu")
    np.testing.assert_array_equal(g_toks, c_toks)
    assert g_cols == c_cols
    assert sum(g_routes.values()) > 0
