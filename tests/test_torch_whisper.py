"""The port's whisper encoder-decoder (``models/whisper.py``) against the JAX
package on the CPU: reduced whisper-tiny (d 128, 4 query heads on 2 kv
heads of 32, 2 encoder and 2 decoder layers, 16 frames, vocab 512) in f32,
the reference's parameters carried across bit for bit, frames and tokens
from numpy seeds.

Tolerances (f32): encoder states, logits and caches within 1e-4 absolute
and relative (the port's attention keeps its probabilities in f32 like the
reference at f32; the two differ in summation order); one AdamW step's
loss and grad_norm within 1e-5 relative, and its parameters, with both
packages fed the reference's gradient (Adam's first step divides by
sqrt(v) + eps), within 1e-5 relative and 1e-7 absolute.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.launch import train as jlaunch
from repro.models import whisper as JW
from repro.optim import optimizers as JO
from repro.train import step as JS
from repro.utils.flat import FlatSpec as JFlatSpec
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import train as tlaunch
from repro_torch.models import whisper as TW
from repro_torch.optim import make_optimizer, warmup_cosine_lr
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.train import make_train_state, make_train_step
from repro_torch.train import step as tstep
from repro_torch.utils.flat import FlatSpec as TFlatSpec
from repro_torch.utils.pytree import tree_leaves_with_path

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-tiny"
MAX_TARGET = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs():
    return jreduce_config(jget_config(ARCH)), reduce_config(get_config(ARCH))


@functools.lru_cache(maxsize=None)
def _params():
    jcfg, _ = _cfgs()
    jp = jax.tree.map(np.asarray, JW.init_whisper(jcfg, jax.random.PRNGKey(0), MAX_TARGET))
    return jp, convert.from_jax_params(jp, "cpu")


def _frames(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


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


def test_init_whisper_tree_has_the_reference_spec():
    jcfg, tcfg = _cfgs()
    jspec = JFlatSpec.from_tree(JW.init_whisper(jcfg, jax.random.PRNGKey(0), MAX_TARGET))
    tp = TW.init_whisper(tcfg, torch.Generator().manual_seed(0), MAX_TARGET, device="cpu")
    assert TFlatSpec.from_tree(tp).to_json() == jspec.to_json()
    jcache = JW.init_whisper_cache(jcfg, 2, 12)
    tcache = TW.init_whisper_cache(tcfg, 2, 12, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in tree_leaves_with_path(tcache)} == \
        {k: (v.shape, str(v.dtype)) for k, v in _jflat(jcache).items()}


def test_whisper_encode():
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    frames = _frames(tcfg, 2, seed=1)
    want = JW.whisper_encode(jcfg, jp, jnp.asarray(frames))
    got = TW.whisper_encode(tcfg, tp, torch.from_numpy(frames))
    _close(got, want)
    _close(TW.whisper_encode(tcfg, tp, torch.from_numpy(frames), differentiable=True), want)


def test_whisper_decode_without_a_cache():
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    frames, toks = _frames(tcfg, 2, seed=2), _tokens(tcfg, 2, 9, seed=3)
    enc = JW.whisper_encode(jcfg, jp, jnp.asarray(frames))
    jl, jaux, jc = JW.whisper_decode(jcfg, jp, jnp.asarray(toks), enc)
    tenc = convert.from_numpy(np.asarray(enc), "cpu")
    for diff in (False, True):
        tl, taux, tc = TW.whisper_decode(tcfg, tp, torch.from_numpy(toks).long(), tenc,
                                         differentiable=diff)
        _close(tl, jl)
        assert tc is None and jc is None and float(taux) == float(jaux) == 0.0
    # the prefill step: last-position logits from frames and tokens
    batch = {"frames": frames, "tokens": toks}
    jlast = JS.make_prefill_step(jcfg)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tlast = tstep.make_prefill_step(tcfg)(tp, {"frames": torch.from_numpy(frames),
                                               "tokens": torch.from_numpy(toks).long()})
    _close(tlast, jlast)


def test_prime_cache_prefill_and_serve_steps():
    """Encode, prime the cross k/v, prefill a 5-token prompt into the cache,
    then 4 serve steps: logits and every cache leaf against the reference's
    at each step, and the cached steps against one forward over all 9."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    B, P, L = 2, 5, 12
    frames, toks = _frames(tcfg, B, seed=4), _tokens(tcfg, B, P + 4, seed=5)
    jenc = JW.whisper_encode(jcfg, jp, jnp.asarray(frames))
    tenc = TW.whisper_encode(tcfg, tp, torch.from_numpy(frames))
    jcache = JW.prime_cross_cache(jcfg, jp, JW.init_whisper_cache(jcfg, B, L), jenc)
    tcache = TW.prime_cross_cache(tcfg, tp, TW.init_whisper_cache(tcfg, B, L, device="cpu"), tenc)
    _assert_tree_close(tcache, jcache)
    jserve, tserve = JS.make_serve_step(jcfg), tstep.make_serve_step(tcfg)
    jl, jcache = jserve(jp, jcache, jnp.asarray(toks[:, :P]), jnp.asarray(0, jnp.int32))
    tl, tcache = tserve(tp, tcache, torch.from_numpy(toks[:, :P]).long(), 0)
    _close(tl, jl)
    _assert_tree_close(tcache, jcache)
    steps = [tl]
    for t in range(P, P + 4):
        jl, jcache = jserve(jp, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32))
        tl, tcache = tserve(tp, tcache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        _close(tl, jl)
        _assert_tree_close(tcache, jcache)
        steps.append(tl)
    full, _, _ = TW.whisper_decode(tcfg, tp, torch.from_numpy(toks).long(), tenc)
    _close(torch.stack(steps, 1), full[:, P - 1:].numpy())


def test_decode_past_the_learned_positions_raises():
    """The reference's dynamic_slice clamps past max_target_len; the port
    refuses."""
    _, tcfg = _cfgs()
    _, tp = _params()
    cache = TW.init_whisper_cache(tcfg, 1, MAX_TARGET + 1, device="cpu")
    TW.prime_cross_cache(tcfg, tp, cache, torch.zeros((1, tcfg.encoder_seq, tcfg.d_model)))
    tok = torch.zeros((1, 1), dtype=torch.long)
    TW.whisper_decode(tcfg, tp, tok, cache=cache, cache_index=MAX_TARGET - 1)
    with pytest.raises(ValueError, match="learned positions"):
        TW.whisper_decode(tcfg, tp, tok, cache=cache, cache_index=MAX_TARGET)
    with pytest.raises(ValueError, match="enc_out or a primed cache"):
        TW.whisper_decode(tcfg, tp, tok)
    with pytest.raises(ValueError, match="use whisper_decode directly"):
        TEngine(tcfg, tp)


def test_adamw_train_step_matches_reference():
    """One AdamW step on frames and tokens: loss and grad_norm from each
    package's own gradient; then the parameters from the reference's
    gradient fed to both."""
    jcfg, tcfg = _cfgs()
    jp, _ = _params()
    sched = dict(warmup=1, total=3)
    jopt = JO.make_optimizer("adamw", JO.warmup_cosine_lr(3e-3, **sched))
    topt = make_optimizer("adamw", warmup_cosine_lr(3e-3, **sched))
    batch = {"frames": _frames(tcfg, 4, seed=6), "tokens": _tokens(tcfg, 4, 10, seed=7)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    js = JS.make_train_state(jax.tree.map(jnp.asarray, jp), jopt)
    jloss, g = jax.jit(jax.value_and_grad(
        lambda p: JS._lm_loss_fn(jcfg, p, jbatch, 0.0)[0]))(js["params"])
    ts = make_train_state(convert.from_jax_params(jp, "cpu"), topt)
    _, tm = make_train_step(tcfg, topt)(ts, batch)
    assert float(tm["loss"]) == pytest.approx(float(jloss), rel=1e-5)
    jnorm = np.sqrt(sum(float(jnp.sum(jnp.square(x))) for x in jax.tree.leaves(g)))
    assert float(tm["grad_norm"]) == pytest.approx(jnorm, rel=1e-5)
    assert float(tm["aux"]) == 0.0

    js2, _ = jax.jit(JS.make_train_step(jcfg, jopt, grad_sync=lambda _: g))(js, jbatch)
    tg = convert.from_jax_params(jax.tree.map(np.asarray, g), "cpu")
    ts2, _ = make_train_step(tcfg, topt, grad_sync=lambda _: tg)(ts, batch)
    _assert_tree_close(ts2["params"], js2["params"], rtol=1e-5, atol=1e-7)


def test_launcher_builds_whisper_and_feeds_zero_frames():
    jcfg = jreduce_config(jget_config(ARCH))
    tcfg = tlaunch.train_config(ARCH, reduced=True, seq=16)
    tp = tlaunch.build_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert tcfg.max_seq_len == jcfg.max_seq_len
    jspec = JFlatSpec.from_tree(jlaunch.build_params(jcfg, jax.random.PRNGKey(0)))
    assert TFlatSpec.from_tree(tp).to_json() == jspec.to_json()
    batch = tlaunch.train_batch(tcfg, np.zeros((3, 16), np.int32))
    assert sorted(batch) == ["frames", "tokens"]
    assert batch["frames"].shape == (3, tcfg.encoder_seq, tcfg.d_model)
    assert not batch["frames"].any()
