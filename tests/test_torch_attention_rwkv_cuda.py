"""The ``flash_attention`` and ``rwkv6_scan`` CUDA kernels against their
plain PyTorch versions, on the card, and the reduced serving path on the
card against the CPU.  Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_attention_rwkv_cuda.py

Each test skips without a card (the kernels have no CPU mode).
Tolerances: f32 outputs within 2e-5 x max(1, max|plain|) (f32 sums in
another order); bf16 outputs within that plus 1 bf16 ulp of the larger
side (the same f32 sums, each side rounded once; where a sum cancels to a
small value the f32 term dominates); the reduced f32 models' logits within 1e-4
of the CPU's, with the same greedy tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rwkv6_scan as trs
from repro_torch.models.transformer import forward_lm, init_lm
from repro_torch.serve.engine import Engine
from repro_torch.utils.pytree import tree_map


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_close(got, want):
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(
        2.0 ** -126))) - 7)
    tol = ulp + 2e-5 * max(1.0, w.abs().max().item())
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.isfinite(g).all()
    assert bool(((g - w).abs() <= tol).all()), (g - w).abs().max().item()


def _f32_close(got, want):
    assert torch.isfinite(got).all()
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 2e-5 * scale


def _randn(shape, seed, dev, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)).to(dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,dtype,causal,window,q_offset", [
    (2, 256, 320, 4, 1, 256, torch.bfloat16, True, 64, 0),     # gemma3-like local layer
    (2, 256, 320, 4, 1, 256, torch.bfloat16, True, None, 0),   # gemma3-like global layer
    (2, 1, 320, 4, 1, 256, torch.bfloat16, True, 64, 300),     # decode
    (2, 96, 160, 4, 1, 256, torch.float32, True, 64, 0),      # hd 256 in f32
    (2, 77, 133, 8, 2, 64, torch.float32, True, None, 56),     # ragged, GQA
    (3, 45, 45, 4, 4, 128, torch.float32, False, None, 0),     # bidirectional
    (1, 33, 40, 4, 2, 32, torch.float32, True, 8, 7),
    (1, 40, 64, 4, 1, 64, torch.float32, True, 8, 66),         # rows 6.. see no key
])
def test_flash_kernel_matches_plain(B, Sq, Sk, Hq, Hkv, hd, dtype, causal, window, q_offset):
    dev = _card()
    q = _randn((B, Sq, Hq, hd), 1, dev, dtype)
    k = _randn((B, Sk, Hkv, hd), 2, dev, dtype)
    v = _randn((B, Sk, Hkv, hd), 3, dev, dtype)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    (_bf16_close if dtype == torch.bfloat16 else _f32_close)(got, want)
    if q_offset == 66:
        assert bool((got[:, 6:] == 0).all())


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_take():
    dev = _card()
    q = _randn((1, 4, 2, 48), 0, dev)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous())
    q = _randn((1, 4, 2, 64), 0, dev)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="no backward"):
        tfa.flash_attention(q.clone().requires_grad_(), q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd,dtype", [
    (4, 256, 16, 64, torch.float32),
    (2, 45, 8, 64, torch.bfloat16),
    (3, 37, 4, 32, torch.float32),
    (2, 1, 8, 64, torch.float32),     # one decode step
])
def test_rwkv_kernel_matches_plain(B, T, H, hd, dtype):
    dev = _card()
    rng = np.random.default_rng(T)
    r, k, v = (_randn((B, T, H, hd), s, dev, dtype) for s in (4, 5, 6))
    logw = torch.from_numpy(-np.exp(rng.uniform(-6.0, np.log(20.0), (B, T, H, hd))).astype(
        np.float32)).to(dev).to(dtype)  # down to -20: no clamp
    u = 0.5 * _randn((H, hd), 7, dev)
    s0 = 0.3 * _randn((B, H, hd, hd), 8, dev)
    before = trs.rwkv6_scan.launches
    y, s = trs.rwkv6_scan(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    assert trs.rwkv6_scan.launches == before + 1
    yp, sp = trs.rwkv6_scan_plain(r, k, v, logw, u, s0)
    assert y.dtype == dtype and s.dtype == torch.float32
    (_bf16_close if dtype == torch.bfloat16 else _f32_close)(y, yp)
    _f32_close(s, sp)
    if T > 2:  # the state carried across two calls
        h = T // 2
        y1, s1 = trs.rwkv6_scan(*(t[:, :h].contiguous() for t in (r, k, v, logw)), u, s0)
        y2, s2 = trs.rwkv6_scan(*(t[:, h:].contiguous() for t in (r, k, v, logw)), u, s1)
        (_bf16_close if dtype == torch.bfloat16 else _f32_close)(torch.cat([y1, y2], 1), yp)
        _f32_close(s2, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-7b"])
def test_reduced_serving_path_card_matches_cpu(arch):
    dev = _card()
    cfg = reduce_config(get_config(arch))
    if arch == "gemma3-1b":
        cfg = dataclasses.replace(cfg, num_layers=8, pattern=tuple(
            dataclasses.replace(b, window=8) if b.window else b for b in cfg.pattern))
    params = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = np.random.default_rng(1).integers(3, cfg.vocab_size, (3, 12))
    out = {}
    for d in ("cpu", dev):
        p = tree_map(lambda x: x.to(d), params)
        res = Engine(cfg, p, max_len=32).generate(prompts, max_new_tokens=16)
        with torch.inference_mode():
            logits, _, _ = forward_lm(cfg, p, torch.as_tensor(res.tokens, device=d))
        out[str(d)] = (res.tokens, logits.cpu())
    np.testing.assert_array_equal(out["cpu"][0], out[str(dev)][0])
    assert (out["cpu"][1] - out[str(dev)][1]).abs().max().item() <= 1e-4
