"""The partitioned steps on the production grids, on the card:
``flash_attention`` at ``chip_smoke.py``'s phase 26 per-slot shapes
against its plain versions (the B = 1 run on grid (b): the partials over
each of four cache blocks and their four-block merge, bf16 and f32, three
blocks empty under the local window; each of the four prompt chunks on
``prefill_tc``), and a reduced train step and greedy run on grid (b)
(``data_axis=("data", "model")``, ``model_axis=None``) and grid (a)
(("pod", "data", "model"), ``pod`` replicated) on the card against the
same on the CPU (whose results ``tests/test_torch_batch_axes.py`` holds
against the JAX package's partitioned jit).  Imports neither JAX nor the
JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_batch_axes_cuda.py

Each test skips without a card.  Tolerances (``chip_smoke.py``'s): the
partials' m, l and acc within 2e-5 x max(1, max|plain|), an empty split
exactly; the merged output and a prefill chunk in bf16 within 1 bf16 ulp
+ 2e-5 x max(1, max|plain|), in f32 within 2e-5 x max(1, max|plain|),
against the plain versions and ``flash_attention_plain`` over the whole
cache; the train step's loss and grad_norm within rtol 1e-5 and its
params within rtol/atol 1e-5 of the CPU's (f32, TF32 off); the greedy
tokens equal the CPU's, the launches by route and the collectives as on
the CPU."""
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
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_train_state, make_train_step
from repro_torch.utils.pytree import tree_leaves_with_path

# phase 26's B = 1 run on grid (b): q [1, 1, 4, 256] on one kv head over four
# 1,028-slot blocks of a 4,112-slot cache at position 4,110; its prompt of
# 4,096 in four chunks of 1,024
BLOCKS, L, POS, PROMPT = 4, 4_112, 4_110, 4_096
WINDOW = 512
# grid -> (mesh shape, mesh axes, data_axis, model_axis)
GRIDS = {"a": ((2, 2, 2), ("pod", "data", "model"), "data", "model"),
         "b": ((2, 2), ("data", "model"), ("data", "model"), None)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash_attention entries launch there")
    torch.backends.cuda.matmul.allow_tf32 = False


def _f32_close(got, want):
    assert bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-5 * max(1.0, want.float().abs().max().item()), err


def _bf16_close(got, want):
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(g.abs(), w.abs())
    assert bool(((g - w).abs() <= ulp + 2e-5 * max(1.0, w.abs().max().item())).all())


def _qkv(Sq, Sk, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((1, Sq, 4, 256), (1, Sk, 1, 256), (1, Sk, 1, 256)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, WINDOW])
def test_four_block_partials_and_merge_at_the_per_slot_shape(window, dtype):
    _card()
    q, k, v = _qkv(1, L, dtype, 26)
    blk, parts, empty = L // BLOCKS, [], 0
    for r in range(BLOCKS):
        kb, vb = k[:, r * blk:(r + 1) * blk].contiguous(), v[:, r * blk:(r + 1) * blk].contiguous()
        _, q_off, win = TL.cache_block(L, POS, window, r, BLOCKS)
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
    assert empty == (3 if window else 0)
    part = torch.cat(parts, 2)
    before = dict(tfa.flash_attention.launches_by_route)
    o = tfa.merge_partials(part, 1, dtype)
    assert tfa.flash_attention.launches_by_route["decode_merge"] == before["decode_merge"] + 1
    close = _bf16_close if dtype == torch.bfloat16 else _f32_close
    close(o, tfa.merge_partials_plain(part, 1, dtype))
    close(o, tfa.flash_attention_plain(q, k, v, window=window, q_offset=POS))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, WINDOW])
def test_each_prompt_chunk_on_prefill_tc_at_the_per_slot_shape(window):
    _card()
    c = PROMPT // BLOCKS
    q, k, v = _qkv(c, PROMPT, torch.bfloat16, 27)
    for r in range(BLOCKS):
        kw = dict(causal=True, window=window, q_offset=r * c)
        before = dict(tfa.flash_attention.launches_by_route)
        got = tfa.flash_attention(q, k, v, **kw)
        assert tfa.flash_attention.launches_by_route["prefill_tc"] == before["prefill_tc"] + 1
        _bf16_close(got, tfa.flash_attention_plain(q, k, v, **kw))


def _cfg():
    cfg = reduce_config(get_config("gemma3-1b"), d_model=128)
    local = dataclasses.replace(cfg.pattern[0], window=8)
    return dataclasses.replace(cfg, num_layers=3, pattern=(local, cfg.pattern[-1]))


def _grid(g, device):
    shape, names, da, ma = GRIDS[g]
    return tmesh.make_mesh(shape, names, device=device), dict(data_axis=da, model_axis=ma)


def _train(g, device):
    cfg = dataclasses.replace(_cfg(), fsdp=True)
    mesh, axes = _grid(g, device)
    opt = make_optimizer("sgd", constant_lr(0.05), momentum=0.9)
    state = make_train_state(TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu"),
                             opt)
    psh = tsh.params_shardings(mesh, state["params"], cfg, **axes)
    state = tsh.device_put(state, {"params": psh, "opt": tsh.opt_state_shardings(
        mesh, state["opt"], psh)})
    tokens = np.random.default_rng(35).integers(3, cfg.vocab_size, (8, 16))
    tmesh.reset_collectives()
    state, m = make_train_step(cfg, opt, grad_shardings=psh, **axes)(state, {"tokens": tokens})
    counts = (dict(tmesh.collectives), dict(tmesh.collectives_by_axis))
    return m, {k: v.cpu() for k, v in tree_leaves_with_path(tsh.gather(state["params"]))}, counts


@pytest.mark.cuda
@pytest.mark.parametrize("g", sorted(GRIDS))
def test_train_step_on_the_grid_on_the_card_matches_the_cpu(g):
    """One SGD step of gemma3-1b cut to 3 layers (FSDP, f32, 8 x 16) with
    the grid's axes: loss, grad_norm, params and collectives as on the CPU."""
    _card()
    gm, gp, gc = _train(g, "cuda")
    cm, cp, cc = _train(g, "cpu")
    assert gc == cc
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(gm[k]), float(cm[k]), rtol=1e-5)
    for k in cp:
        np.testing.assert_allclose(gp[k].numpy(), cp[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def _generate(g, B, P, device):
    cfg = _cfg()
    mesh, axes = _grid(g, device)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    placed = tsh.device_put(params, tsh.params_shardings(mesh, params, cfg, **axes))
    prompts = np.random.default_rng(26).integers(3, cfg.vocab_size, (B, P))
    tfa.reset_launches()
    tmesh.reset_collectives()
    res = Engine(cfg, placed, max_len=16, **axes).generate(prompts, max_new_tokens=8)
    return (res.tokens, dict(tfa.flash_attention.launches_by_route), dict(tmesh.collectives),
            dict(tmesh.collectives_by_axis))


@pytest.mark.cuda
@pytest.mark.parametrize("g,B,P", [("b", 4, 8), ("b", 1, 8), ("a", 8, 8)])
def test_greedy_run_on_the_grid_on_the_card_matches_the_cpu(g, B, P):
    """Greedy 8 tokens of gemma3-1b cut to 3 layers (f32) on grid (b) at
    B = 4 (one row a slot) and at B = 1 (the prompt in four chunks, the
    cache in four blocks), and on grid (a) at B = 8: the tokens, the
    collectives as on the CPU, and every launch the CPU's plain versions
    stand in for made on the card, by route."""
    _card()
    g_toks, g_routes, g_cols, g_axes = _generate(g, B, P, "cuda")
    c_toks, _, c_cols, c_axes = _generate(g, B, P, "cpu")
    np.testing.assert_array_equal(g_toks, c_toks)
    assert (g_cols, g_axes) == (c_cols, c_axes)
    assert "pod" not in g_axes
    n_slots = int(np.prod(GRIDS[g][0]))
    if B == 1:
        assert g_routes["decode_partial"] == g_routes["decode_merge"] == n_slots * 3 * 7
    else:
        assert sum(g_routes.values()) > 0 and g_routes["decode_partial"] == 0
