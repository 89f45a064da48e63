"""M-RoPE with ``extra_embeds`` (qwen2-vl-72b), the ring-buffer KV cache
(``REPRO_OPT_RING_CACHE``) and window slicing (``REPRO_OPT_WINDOW``) in the
port against the JAX package on the CPU, reduced configs in f32 with the
reference's parameters carried across bit for bit and inputs from numpy
seeds.  The levers are module attributes, set in both packages by
monkeypatch.

Tolerances (f32): angles, logits, caches and attention outputs within 1e-4
absolute and relative (the same arithmetic in another summation order);
greedy tokens exactly equal; a 2-microbatch SGD step's loss and grad_norm
within 1e-5 relative and its parameters within 1e-5 relative and 1e-7
absolute.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import optimizers as JO
from repro.serve.engine import Engine as JEngine
from repro.train import step as JS
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import make_optimizer
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.train import make_train_state, make_train_step
from repro_torch.utils.pytree import tree_leaves_with_path

TOL = dict(rtol=1e-4, atol=1e-4)
QWEN = "qwen2-vl-72b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gemma(get, reduce):
    """Reduced gemma3-1b with window 8 and 8 layers (a 2-layer tail)."""
    cfg = reduce(get("gemma3-1b"))
    pattern = tuple(dataclasses.replace(b, window=8) if b.window else b for b in cfg.pattern)
    return dataclasses.replace(cfg, num_layers=8, pattern=pattern)


def _cfgs(arch):
    if arch == "gemma3-1b":
        return _gemma(jget_config, jreduce_config), _gemma(get_config, reduce_config)
    return jreduce_config(jget_config(arch)), reduce_config(get_config(arch))


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg, _ = _cfgs(arch)
    jp = jax.tree.map(np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(0)))
    return jp, convert.from_jax_params(jp, "cpu")


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def _jflat(tree):
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_tree_close(ttree, jtree, **tol):
    t, j = dict(tree_leaves_with_path(ttree)), _jflat(jtree)
    assert sorted(t) == sorted(j)
    for key in t:
        _close(t[key], j[key], **tol)


def _vision_inputs(cfg, B, n_text, seed):
    """A 2 x 2 grid of patch embeddings (t = 0, h = row, w = col), then text
    at positions 2 + b.. on all three streams in row b (so the rows'
    positions differ): (tokens, positions [3, B, S], extra_embeds [B, 4, D])."""
    rng = np.random.default_rng(seed)
    n = cfg.num_frontend_tokens
    side = int(round(n ** 0.5))
    S = n + n_text
    pos = np.zeros((3, B, S), np.int32)
    pos[1, :, :n] = np.arange(n) // side
    pos[2, :, :n] = np.arange(n) % side
    pos[:, :, n:] = side + np.arange(n_text) + np.arange(B)[:, None]
    extra = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return _tokens(cfg, B, S, seed), pos, extra


def test_mrope_merge_angles():
    jcfg, tcfg = _cfgs(QWEN)
    assert tcfg.rope.mrope_sections == (4, 6, 6)
    pos = np.random.default_rng(1).integers(0, 300, (3, 2, 7)).astype(np.int32)
    want = JL.mrope_merge_angles(jcfg.rope, jnp.asarray(pos), jcfg.head_dim)
    got = TL.mrope_merge_angles(tcfg.rope, torch.from_numpy(pos), tcfg.head_dim)
    assert tuple(got.shape) == want.shape == (2, 7, tcfg.head_dim // 2)
    _close(got, want, rtol=1e-6, atol=1e-4)
    # t = h = w is ordinary RoPE, bit for bit
    same = torch.from_numpy(pos[0])
    assert torch.equal(TL.mrope_merge_angles(tcfg.rope, same[None].expand(3, -1, -1),
                                             tcfg.head_dim),
                       TL.rope_angles(tcfg.rope, same, tcfg.head_dim))
    with pytest.raises(ValueError, match="must sum to head_dim"):
        TL.mrope_merge_angles(dataclasses.replace(tcfg.rope, mrope_sections=(4, 4, 4)),
                              torch.from_numpy(pos), tcfg.head_dim)


def test_forward_lm_with_3d_positions_and_extra_embeds():
    """The vision prefill into a cache, one serve step after it, and a
    forward without a cache, against the reference."""
    jcfg, tcfg = _cfgs(QWEN)
    jp, tp = _params(QWEN)
    toks, pos, extra = _vision_inputs(tcfg, 2, 6, seed=2)
    S = toks.shape[1]
    jl, _, _ = JT.forward_lm(jcfg, jp, jnp.asarray(toks), positions=jnp.asarray(pos),
                             extra_embeds=jnp.asarray(extra))
    tl, _, _ = TT.forward_lm(tcfg, tp, torch.from_numpy(toks).long(),
                             positions=torch.from_numpy(pos), extra_embeds=torch.from_numpy(extra))
    _close(tl, jl)
    jcache, tcache = JT.init_cache(jcfg, 2, S + 2), TT.init_cache(tcfg, 2, S + 2, device="cpu")
    jl, _, jcache = JT.forward_lm(jcfg, jp, jnp.asarray(toks), positions=jnp.asarray(pos),
                                  extra_embeds=jnp.asarray(extra), cache=jcache,
                                  cache_index=jnp.asarray(0, jnp.int32))
    tl, _, tcache = TT.forward_lm(tcfg, tp, torch.from_numpy(toks).long(),
                                  positions=torch.from_numpy(pos),
                                  extra_embeds=torch.from_numpy(extra), cache=tcache,
                                  cache_index=0)
    _close(tl, jl)
    _assert_tree_close(tcache, jcache)
    nxt = toks[:, -1:]
    jl, _, jcache = JT.forward_lm(jcfg, jp, jnp.asarray(nxt), cache=jcache,
                                  cache_index=jnp.asarray(S, jnp.int32))
    tl, _, tcache = TT.forward_lm(tcfg, tp, torch.from_numpy(nxt).long(), cache=tcache,
                                  cache_index=S)
    _close(tl, jl)
    _assert_tree_close(tcache, jcache)
    # the patch embeddings matter, and text-only positions reduce to RoPE
    plain, _, _ = TT.forward_lm(tcfg, tp, torch.from_numpy(toks).long())
    assert (plain - TT.forward_lm(tcfg, tp, torch.from_numpy(toks).long(),
                                  extra_embeds=torch.from_numpy(extra))[0]).abs().max() > 1e-3
    rope = dataclasses.replace(tcfg, rope=dataclasses.replace(tcfg.rope, kind="default"))
    assert torch.equal(plain, TT.forward_lm(rope, tp, torch.from_numpy(toks).long())[0])


def test_two_microbatch_step_slices_positions_on_the_batch_axis():
    """Reduced qwen2-vl, a batch of 4 with [3, 4, S] positions and extra
    embeddings, 2 microbatches, one SGD step at lr 1: loss, grad_norm and
    the parameters against the reference's (B = 4, so its slicing picks
    axis 1 for the positions too)."""
    jcfg, tcfg = _cfgs(QWEN)
    jp, tp = _params(QWEN)
    toks, pos, extra = _vision_inputs(tcfg, 4, 8, seed=3)
    batch = {"tokens": toks, "positions": pos, "extra_embeds": extra}
    jopt, topt = JO.make_optimizer("sgd", lambda step: 1.0), make_optimizer("sgd", lambda s: 1.0)
    js = JS.make_train_state(jax.tree.map(jnp.asarray, jp), jopt)
    js2, jm = jax.jit(JS.make_train_step(jcfg, jopt, microbatches=2))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts2, tm = make_train_step(tcfg, topt, microbatches=2)(make_train_state(tp, topt), batch)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    _assert_tree_close(ts2["params"], js2["params"], rtol=1e-5, atol=1e-7)
    # each row kept its own positions: the whole batch in one step gives the
    # same step, and shuffling the positions' rows does not
    whole, _ = make_train_step(tcfg, topt)(make_train_state(tp, topt), batch)
    _assert_tree_close(whole["params"], js2["params"], rtol=1e-5, atol=1e-7)
    swapped = dict(batch, positions=pos[:, ::-1].copy())
    _, ms = make_train_step(tcfg, topt, microbatches=2)(make_train_state(tp, topt), swapped)
    assert abs(float(ms["loss"]) / float(tm["loss"]) - 1) > 1e-6


def test_ring_cache_decodes_past_the_wrap(monkeypatch):
    """Reduced gemma3 (window 8): a 6-token prompt and 14 new tokens, so the
    local layers' 8-slot rings wrap after 2 decode steps.  Tokens equal to
    the reference's under its ring, and to the port's own full cache;
    teacher-forced logits and the rings against the reference's."""
    jcfg, tcfg = _cfgs("gemma3-1b")
    jp, tp = _params("gemma3-1b")
    prompts = _tokens(tcfg, 2, 6, seed=4)
    full = TEngine(tcfg, tp, max_len=24).generate(prompts, max_new_tokens=14)
    monkeypatch.setattr(JT, "RING_CACHE", True)
    monkeypatch.setattr(TT, "RING_CACHE", True)
    cache = TT.init_cache(tcfg, 2, 24, device="cpu")
    local = cache["scan"]["pos0"]["k"]
    assert local.shape[2] == 8 and cache["tail"]["layer6"]["k"].shape[1] == 8
    assert cache["scan"]["pos5"]["k"].shape[2] == 24  # the global layer keeps its cache
    jres = JEngine(jcfg, jax.tree.map(jnp.asarray, jp), max_len=24).generate(
        prompts, max_new_tokens=14)
    tres = TEngine(tcfg, tp, max_len=24).generate(prompts, max_new_tokens=14)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    np.testing.assert_array_equal(tres.tokens, full.tokens)

    seq = tres.tokens
    jfwd = jax.jit(lambda p, tok, c, i: JT.forward_lm(jcfg, p, tok, cache=c, cache_index=i))
    jcache = JT.init_cache(jcfg, 2, 24)
    jl, _, jcache = jfwd(jp, jnp.asarray(seq[:, :6]), jcache, jnp.asarray(0, jnp.int32))
    tl, _, cache = TT.forward_lm(tcfg, tp, torch.from_numpy(seq[:, :6]).long(), cache=cache,
                                 cache_index=0)
    _close(tl, jl)
    for t in range(6, seq.shape[1] - 1):
        jl, _, jcache = jfwd(jp, jnp.asarray(seq[:, t:t + 1]), jcache, jnp.asarray(t, jnp.int32))
        tl, _, cache = TT.forward_lm(tcfg, tp, torch.from_numpy(seq[:, t:t + 1]).long(),
                                     cache=cache, cache_index=t)
        _close(tl, jl)
    _assert_tree_close(cache, jcache)
    # a prefill longer than the ring cannot be written into it
    with pytest.raises(ValueError, match="overrun"):
        TT.forward_lm(tcfg, tp, torch.from_numpy(seq[:, :9]).long(),
                      cache=TT.init_cache(tcfg, 2, 24, device="cpu"), cache_index=0)


def test_ring_decode_step_differentiable_matches_the_kernel_path(monkeypatch):
    """One ring decode step with ``differentiable=True`` (the reference's
    reconstructed key positions in ``_sdpa``) equals the kernel path's
    ``q_offset = min(i, W - 1)`` over the ring, before and after the wrap."""
    _, tcfg = _cfgs("gemma3-1b")
    p = TL.init_attention(tcfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    gen = torch.Generator().manual_seed(1)
    W = 8
    for i in (3, 7, 8, 13):
        cache = {"k": torch.randn((2, W, tcfg.num_kv_heads, tcfg.head_dim), generator=gen),
                 "v": torch.randn((2, W, tcfg.num_kv_heads, tcfg.head_dim), generator=gen)}
        x = torch.randn((2, 1, tcfg.d_model), generator=gen)
        outs = []
        for diff in (False, True):
            c = {k: v.clone() for k, v in cache.items()}
            out, c = TL.attention_fwd(tcfg, p, x, window=W, q_offset=i, kv_cache=c,
                                      cache_index=i, differentiable=diff)
            outs.append((out, c))
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-6)
        assert torch.equal(outs[0][1]["k"], outs[1][1]["k"])
        assert not torch.equal(outs[0][1]["k"][:, i % W], cache["k"][:, i % W])


@pytest.mark.parametrize("window,q_offset", [(8, 0), (20, 16), (5, 3)])
def test_sdpa_chunked_window_slicing(monkeypatch, window, q_offset):
    """``_sdpa_chunked`` over 64 queries in chunks of 16 against 80 keys,
    with the lever on in both packages: equal to the reference's sliced
    result and to the port's own unsliced one."""
    rng = np.random.default_rng(window)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 80, 2, 16)).astype(np.float32) for _ in range(2))
    kw = dict(causal=True, window=window, q_offset=q_offset, chunk=16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    unsliced = TL._sdpa_chunked(tq, tk, tv, **kw)
    monkeypatch.setattr(JL, "OPT_WINDOW_SLICING", True)
    monkeypatch.setattr(TL, "OPT_WINDOW_SLICING", True)
    got = TL._sdpa_chunked(tq, tk, tv, **kw)
    _close(got, JL._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    _close(got, unsliced.numpy(), rtol=1e-5, atol=1e-6)
