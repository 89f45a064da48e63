"""Context-parallel decode on the card: ``flash_decode.cu``'s partials and
merge entries against their plain versions at ``chip_smoke.py``'s phase
22 per-slot shapes, with an empty block among them, in bf16 and f32; and a
reduced context-parallel generate (B = 1 on (data 2, model 2)) on the card
against the same on the CPU (whose results
``tests/test_torch_context_parallel.py`` holds against the JAX package's
partitioned jit).  Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_context_parallel_cuda.py

Each test skips without a card.  Tolerances: the partials' m (log2 units),
l and acc within 2e-5 x max(1, max|plain|) of each (f32 sums in another
order), an empty split exactly (m = -1e30, l = acc = 0); the merged output
in bf16 within 1 bf16 ulp + 2e-5 x max(1, max|plain|), in f32 within 2e-5
x max(1, max|plain|) (``chip_smoke.py``'s bounds), against the plain merge
and against ``flash_attention_plain`` over the whole cache; the generate's
tokens equal the CPU's, its logits within rtol/atol 1e-5 (f32, TF32 off),
its launches by route and collectives as worked out."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import Engine

# label -> (Hq, Hkv, hd, cache length, position, window): phase 22's slots
SHAPES = {"gemma3-1b global": (2, 1, 256, 32_768, 32_760, None),
          "gemma3-1b local": (2, 1, 256, 32_768, 32_760, 512),   # block 0 holds no visible key
          "granite-moe": (8, 4, 64, 2_064, 2_060, None)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the partials and merge entries launch there")
    torch.backends.cuda.matmul.allow_tf32 = False


def _f32_close(got, want):
    assert bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-5 * max(1.0, want.float().abs().max().item()), err


def _bf16_close(got, want):
    g, w = got.float(), want.float()
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(g.abs(), w.abs())
    assert bool(((g - w).abs() <= ulp + 2e-5 * max(1.0, w.abs().max().item())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("label", sorted(SHAPES))
def test_partials_and_merge_at_the_per_slot_shapes(label, dtype):
    _card()
    Hq, Hkv, hd, L, pos, window = SHAPES[label]
    g = torch.Generator(device="cuda").manual_seed(22)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((1, 1, Hq, hd), (1, L, Hkv, hd), (1, L, Hkv, hd)))
    blk, parts, empty = L // 2, [], 0
    for r in range(2):
        kb, vb = k[:, r * blk:(r + 1) * blk].contiguous(), v[:, r * blk:(r + 1) * blk].contiguous()
        _, q_off, win = TL.cache_block(L, pos, window, r, 2)
        before = dict(tfa.flash_attention.launches_by_route)
        got = tfa.flash_attention_partials(q, kb, vb, window=win, q_offset=q_off)
        assert tfa.flash_attention.launches_by_route["decode_partial"] == \
            before["decode_partial"] + 1
        want = tfa.flash_attention_partials_plain(q, kb, vb, window=win, q_offset=q_off)
        assert got.shape == want.shape
        dead = want[..., 0] == tfa.EMPTY_M
        assert torch.equal(got[..., 0] == tfa.EMPTY_M, dead)
        empty += int(dead.all())
        if (~dead).any():
            _f32_close(got[..., 0][~dead], want[..., 0][~dead])
        _f32_close(got[..., 1], want[..., 1])
        _f32_close(got[..., 2:], want[..., 2:])
        parts.append(got)
    assert empty == (1 if window else 0)
    part = torch.cat(parts, 2)
    before = dict(tfa.flash_attention.launches_by_route)
    o = tfa.merge_partials(part, 1, dtype)
    assert tfa.flash_attention.launches_by_route["decode_merge"] == before["decode_merge"] + 1
    close = _bf16_close if dtype == torch.bfloat16 else _f32_close
    close(o, tfa.merge_partials_plain(part, 1, dtype))
    close(o, tfa.flash_attention_plain(q, k, v, window=window, q_offset=pos))


@pytest.mark.cuda
def test_a_row_that_sees_no_key_merges_to_zero_on_the_card():
    _card()
    q = torch.randn((1, 1, 4, 64), device="cuda")
    k = torch.randn((1, 16, 2, 64), device="cuda")
    parts = [tfa.flash_attention_partials(q, k[:, 8 * r:8 * r + 8].contiguous(),
                                          k[:, 8 * r:8 * r + 8].contiguous(), q_offset=-1 - 8 * r)
             for r in range(2)]
    assert torch.equal(tfa.merge_partials(torch.cat(parts, 2), 1, torch.float32),
                       torch.zeros_like(q))


def _run(device):
    cfg = reduce_config(get_config("gemma3-1b"), d_model=128)
    local = dataclasses.replace(cfg.pattern[0], window=8)
    cfg = dataclasses.replace(cfg, num_layers=3, pattern=(local, cfg.pattern[-1]))
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device=device)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    placed = tsh.device_put(params, tsh.params_shardings(mesh, params, cfg))
    prompts = np.random.default_rng(31).integers(3, cfg.vocab_size, (1, 6))
    eng = Engine(cfg, placed, max_len=14)
    tfa.reset_launches()
    tmesh.reset_collectives()
    res = eng.generate(prompts, max_new_tokens=8)
    routes, counts = dict(tfa.flash_attention.launches_by_route), dict(tmesh.collectives)
    toks, cache = eng._start(placed, prompts)
    logits = []
    with torch.inference_mode():
        lg, cache = eng._prefill(placed, toks, cache)
        logits.append(lg.cpu())
        for t in range(1, 8):
            lg, cache = eng._serve(placed, cache, res.tokens[:, 5 + t:6 + t], 5 + t)
            logits.append(lg.cpu())
    return cfg, res.tokens, torch.stack(logits, 1), routes, counts


@pytest.mark.cuda
def test_context_parallel_generate_on_the_card_matches_the_cpu():
    """gemma3-1b cut to 3 layers, B = 1, prompt 6 in two chunks, 8 new
    tokens on (data 2, model 2), f32: each slot runs its chunk's 3 rows of
    its 2 query heads once a layer on the route ``route`` names (the decode
    route, at 6 rows on the one kv head, with its combine kernel), and each
    decode step ``decode_partial`` and ``decode_merge`` once a layer."""
    _card()
    cfg, g_toks, g_logits, routes, g_counts = _run("cuda")
    _, c_toks, c_logits, _, c_counts = _run("cpu")
    np.testing.assert_array_equal(g_toks, c_toks)
    np.testing.assert_allclose(g_logits.numpy(), c_logits.numpy(), rtol=1e-5, atol=1e-5)
    assert g_counts == c_counts
    n_attn, slots = cfg.num_layers, 4
    want = dict.fromkeys(tfa.COUNTED, 0)
    prefill = tfa.route(torch.float32, 3, 2, 1)
    want[prefill] = slots * n_attn
    if prefill == "decode":
        want["decode_combine"] = slots * n_attn
    want["decode_partial"] = want["decode_merge"] = slots * n_attn * 7
    assert routes == want
