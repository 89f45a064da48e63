"""The port's LM training path against the JAX package, on the CPU: the
optimizers, ``lm_loss``, the param counts, the differentiable attention and
RWKV recurrence (outputs and gradients), ``make_train_step`` (with
microbatches) and ``make_eval_step`` on reduced gemma3-1b and rwkv6-7b, and
the training launcher's ``--save``.

Tolerances, all f32 unless said: optimizer updates and states within rtol
1e-5 / atol 1e-7 over 3 steps on the same gradients; losses within 1e-6
relative; attention within 2e-6 absolute (bf16: within 1 bf16 ulp of the
output's scale, 2^-7 relative); gradients within 1e-5 relative to the
largest (bf16: 2^-6); the recurrence within 1e-5; train steps (loss,
grad_norm, params after 3 SGD steps, and 3 AdamW steps on the reference's
gradients) within 1e-5 absolute and relative.  AdamW's parameters are
compared only after a shared gradient: its first update is g / (|g| +
1e-8), which amplifies a last-bit gradient difference near eps (ROADMAP.md
§C).  XLA and PyTorch differ in summation order and in their
``exp``/``pow``/``rsqrt`` roundings only.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.models import layers as JL
from repro.models import rwkv as JR
from repro.models import transformer as JT
from repro.optim import optimizers as JO
from repro.train import losses as JLS
from repro.train import step as JS
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as TL
from repro_torch.models import rwkv as TR
from repro_torch.models import transformer as TT
from repro_torch.optim import make_optimizer, warmup_cosine_lr
from repro_torch.train import lm_loss, make_eval_step, make_train_state, make_train_step
from repro_torch.utils.pytree import tree_leaves_with_path, tree_map
from test_torch_lm import _cfgs  # reduced gemma3 with a window of 8 over 8 layers

ARCHS = ("gemma3-1b", "rwkv6-7b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: the suite runs several workers on a few
    cores, and torch's BLAS threads spin-wait, so a many-threaded test can
    stall the other workers' tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jflat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    return {k: v.detach().float().numpy() for k, v in tree_leaves_with_path(tree)}


def _assert_trees_close(t, j, rtol, atol):
    t, j = _tflat(t), _jflat(j)
    assert sorted(t) == sorted(j)
    for k in t:
        np.testing.assert_allclose(t[k], j[k], rtol=rtol, atol=atol, err_msg=k)


# -- optimizers ----------------------------------------------------------------


OPTIMIZERS = [("sgd", {}), ("sgd", {"momentum": 0.9}), ("adamw", {}), ("adafactor", {}),
              ("adafactor", {"clip_threshold": 10.0})]


def _opt_params(rng):
    """A rank-2 and a rank-3 leaf (factored by adafactor) and a vector."""
    return {"w": rng.standard_normal((8, 6)).astype(np.float32),
            "blk": {"k": rng.standard_normal((2, 4, 5)).astype(np.float32),
                    "b": rng.standard_normal((7,)).astype(np.float32)}}


@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=[f"{n}{kw}" for n, kw in OPTIMIZERS])
def test_optimizer_matches_reference_over_three_steps(name, kw):
    rng = np.random.default_rng(0)
    params = _opt_params(rng)
    jopt = JO.make_optimizer(name, JO.warmup_cosine_lr(0.1, warmup=1, total=3), **kw)
    topt = make_optimizer(name, warmup_cosine_lr(0.1, warmup=1, total=3), **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(_t, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(tree_map(_t, g), ts, tp)
        _assert_trees_close(tu, ju, rtol=1e-5, atol=1e-7)
        jp = jax.tree.map(jnp.add, jp, ju)
        tp = tree_map(torch.add, tp, tu)
    assert ts["step"] == int(js["step"]) == 3
    jstate = {k: v for k, v in js.items() if k != "step"}
    tstate = {k: v for k, v in ts.items() if k != "step"}
    _assert_trees_close(tstate, jstate, rtol=1e-5, atol=1e-7)
    if name == "adafactor":  # factored state for rank >= 2, whole v otherwise
        assert set(ts["v"]["w"]) == {"vr", "vc"} and ts["v"]["w"]["vr"].shape == (8,)
        assert ts["v"]["blk"]["k"]["vc"].shape == (2, 5)
        assert set(ts["v"]["blk"]["b"]) == {"v"}


def test_adafactor_rms_clip_bites():
    """With unit gradients the first update's RMS is 1/sqrt(1 - beta) = 1.32
    before the clip, so clip_threshold 1 scales it and 10 leaves it."""
    g = {"w": torch.ones(4, 3), "b": torch.ones(5)}
    p = tree_map(torch.zeros_like, g)
    ups = {}
    for clip in (1.0, 10.0):
        opt = make_optimizer("adafactor", lambda step: 1.0, clip_threshold=clip)
        ups[clip], _ = opt.update(g, opt.init(p), p)
    for k in g:
        rms = lambda u: float(torch.sqrt(torch.mean(u ** 2)))
        assert rms(ups[10.0][k]) == pytest.approx(1 / np.sqrt(2.0 ** -0.8), rel=1e-5)
        assert rms(ups[1.0][k]) == pytest.approx(1.0, rel=1e-5)


def test_unknown_optimizer_is_refused_like_the_reference():
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        JO.make_optimizer("lion", JO.constant_lr(1.0))
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        make_optimizer("lion", lambda step: 1.0)


# -- loss, counts, pipeline ----------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss(masked):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    tokens = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = JLS.lm_loss(jnp.asarray(logits), jnp.asarray(tokens),
                       None if mask is None else jnp.asarray(mask))
    got = lm_loss(_t(logits), torch.from_numpy(tokens), None if mask is None else _t(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_reference(arch, reduced):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jreduce_config(jcfg), reduce_config(tcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert tcfg.optimizer == jcfg.optimizer
    if arch == "gemma3-1b" and not reduced:
        assert tcfg.param_count() == 999_812_736


def test_num_steps_matches_reference():
    from repro.data import pipeline as jpipe
    for n, b, e in ((100, 8, 3), (7, 8, 2), (64, 8, 1)):
        assert tpipe.num_steps(n, b, e) == jpipe.num_steps(n, b, e)


# -- differentiable attention and recurrence -------------------------------------------


ATTN_CASES = [  # (B, Sq, Sk, Hq, Hkv, hd, window, q_offset)
    (2, 9, 9, 4, 2, 16, None, 0),      # causal, GQA 2:1
    (2, 12, 12, 4, 1, 8, 5, 0),        # sliding window, GQA 4:1
    (1, 5, 17, 2, 1, 8, 6, 12),        # queries after a longer key range
    (1, 2048, 2048, 2, 1, 8, 700, 0),  # the blocked path over 512-query chunks
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=[f"Sq{c[1]}w{c[6]}" for c in ATTN_CASES])
def test_differentiable_attention_matches_sdpa(case, dtype):
    B, Sq, Sk, Hq, Hkv, hd, window, q_offset = case
    rng = np.random.default_rng(Sq)
    q, k, v, ct = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd),
                             (B, Sq, Hq, hd)))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jfn(q, k, v):
        out = JL._sdpa(q, k, v, causal=True, window=window, q_offset=q_offset)
        return jnp.sum(out.astype(jnp.float32) * ct), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    tq, tk, tv = (_t(x).to(tdt).requires_grad_(True) for x in (q, k, v))
    tout = TL._sdpa(tq, tk, tv, causal=True, window=window, q_offset=q_offset)
    assert tout.dtype == tdt
    (tout.float() * _t(ct)).sum().backward()
    if dtype == "float32":
        out_tol, grad_rel = dict(rtol=0, atol=2e-6), 1e-5
    else:
        out_tol, grad_rel = dict(rtol=2 ** -7, atol=2 ** -7), 2 ** -6
    np.testing.assert_allclose(tout.detach().float().numpy(), np.asarray(jout, np.float32),
                               **out_tol)
    for name, tg, jg in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        jg = np.asarray(jg, np.float32)
        np.testing.assert_allclose(tg.float().numpy(), jg, rtol=0,
                                   atol=grad_rel * np.abs(jg).max(), err_msg=name)


def test_attention_fwd_picks_the_kernel_unless_differentiable():
    """The decoder's default is the kernel wrapper, which refuses a tensor
    that needs grad; ``differentiable=True`` trains through ``_sdpa``."""
    cfg = reduce_config(get_config("gemma3-1b"))
    p = TL.init_attention(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    p = tree_map(lambda x: x.requires_grad_(True), p)
    x = torch.randn(2, 6, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="flash_attention has no backward"):
        TL.attention_fwd(cfg, p, x, causal=True)
    out, _ = TL.attention_fwd(cfg, p, x, causal=True, differentiable=True)
    out.sum().backward()
    assert p["wq"].grad is not None
    with torch.no_grad():
        kern, _ = TL.attention_fwd(cfg, p, x, causal=True, window=4)
        plain, _ = TL.attention_fwd(cfg, p, x, causal=True, window=4, differentiable=True)
    torch.testing.assert_close(kern, plain, rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _rwkv_block():
    jcfg = jreduce_config(jget_config("rwkv6-7b"))
    jp = jax.tree.map(np.asarray, JR.init_time_mix(jcfg, jax.random.PRNGKey(3), jnp.float32))
    # a decay spread over (0.05, 1): the init's w0 = -6 puts every w near 1
    jp["w0"] = np.linspace(-3.0, 1.0, jcfg.d_model).astype(np.float32)
    return jcfg, reduce_config(get_config("rwkv6-7b")), jp


@pytest.mark.parametrize("with_state", [False, True])
def test_differentiable_recurrence_matches_reference(with_state):
    jcfg, tcfg, jp = _rwkv_block()
    rng = np.random.default_rng(4)
    B, S, D = 2, 11, jcfg.d_model
    H, hd = D // jcfg.ssm.head_dim, jcfg.ssm.head_dim
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    ct = rng.standard_normal((B, S, D)).astype(np.float32)
    st = None
    if with_state:
        st = {"S": rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1,
              "shift": rng.standard_normal((B, 1, D)).astype(np.float32)}

    def jfn(p, x):
        out, new = JR.time_mix_fwd(jcfg, p, x, state=st, return_state=True)
        return jnp.sum(out * ct), (out, new["S"])

    (_, (jout, jS)), (jgp, jgx) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1),
                                                             has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = tree_map(lambda a: _t(a).requires_grad_(True), jp)
    tx = _t(x).requires_grad_(True)
    tst = None if st is None else tree_map(_t, st)
    tout, tnew = TR.time_mix_fwd(tcfg, tp, tx, state=tst, return_state=True,
                                 differentiable=True)
    (tout * _t(ct)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tnew["S"].detach().numpy(), np.asarray(jS), rtol=1e-5, atol=1e-5)
    jg = _jflat(jgp)
    for key, leaf in tree_leaves_with_path(tp):
        np.testing.assert_allclose(leaf.grad.numpy(), jg[key], rtol=0,
                                   atol=1e-5 * max(np.abs(jg[key]).max(), 1e-3), err_msg=key)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jgx)).max())
    with torch.no_grad():  # the kernel path (its plain version here) computes the same
        kern, knew = TR.time_mix_fwd(tcfg, tree_map(torch.Tensor.detach, tp), tx.detach(),
                                     state=tst, return_state=True)
    torch.testing.assert_close(kern, tout.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(knew["S"], tnew["S"].detach(), rtol=1e-5, atol=1e-5)


# -- train and eval steps -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jax.tree.map(np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jp


def _batches(cfg, n, B=4, S=16, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_sgd_matches_reference(arch, microbatches):
    """3 SGD steps (momentum 0.9, clip at norm 1): loss, grad_norm and the
    params after every step."""
    jcfg, tcfg, jp = _model(arch)
    sched = dict(lr=0.05, warmup=1, total=3)
    jopt = JO.make_optimizer("sgd", JO.warmup_cosine_lr(**sched), momentum=0.9)
    topt = make_optimizer("sgd", warmup_cosine_lr(**sched), momentum=0.9)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt, microbatches=microbatches))
    tstep = make_train_step(tcfg, topt, microbatches=microbatches)
    js = JS.make_train_state(jax.tree.map(jnp.asarray, jp), jopt)
    ts = make_train_state(convert.from_jax_params(jp, "cpu"), topt)
    for toks in _batches(tcfg, 3):
        js, jm = jstep(js, {"tokens": jnp.asarray(toks)})
        ts, tm = tstep(ts, {"tokens": toks})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        _assert_trees_close(ts["params"], js["params"], rtol=1e-5, atol=1e-5)
    _assert_trees_close(ts["opt"]["mom"], js["opt"]["mom"], rtol=1e-4, atol=1e-5)
    assert not any(x.requires_grad for _, x in tree_leaves_with_path(ts["params"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_train_step_on_a_shared_gradient(arch):
    """3 AdamW steps (the configs' optimizer), both packages fed the
    reference's gradient at the reference's params through ``grad_sync``."""
    jcfg, tcfg, jp = _model(arch)
    jopt = JO.make_optimizer(jcfg.optimizer, JO.warmup_cosine_lr(3e-3, warmup=1, total=3))
    topt = make_optimizer(tcfg.optimizer, warmup_cosine_lr(3e-3, warmup=1, total=3))
    js = JS.make_train_state(jax.tree.map(jnp.asarray, jp), jopt)
    ts = make_train_state(convert.from_jax_params(jp, "cpu"), topt)

    @jax.jit
    def jstep(state, toks):
        g = jax.grad(lambda p: JLS.lm_loss(JT.forward_lm(jcfg, p, toks)[0], toks))(
            state["params"])
        return JS.make_train_step(jcfg, jopt, grad_sync=lambda _: g)(state, {"tokens": toks}), g

    for toks in _batches(tcfg, 3, seed=6):
        (js, jm), g = jstep(js, jnp.asarray(toks))
        tg = convert.from_jax_params(jax.tree.map(np.asarray, g), "cpu")
        ts, tm = make_train_step(tcfg, topt, grad_sync=lambda _: tg)(ts, {"tokens": toks})
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        _assert_trees_close(ts["params"], js["params"], rtol=1e-5, atol=1e-7)
    _assert_trees_close(ts["opt"]["m"], js["opt"]["m"], rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_matches_reference_and_the_train_loss(arch):
    jcfg, tcfg, jp = _model(arch)
    toks = _batches(tcfg, 1, seed=7)[0]
    mask = (np.arange(16)[None] < np.array([[16], [9], [4], [12]])).astype(np.float32)
    tp = convert.from_jax_params(jp, "cpu")
    for batch in ({"tokens": toks}, {"tokens": toks, "mask": mask}):
        want = JS.make_eval_step(jcfg)(jax.tree.map(jnp.asarray, jp),
                                       {k: jnp.asarray(v) for k, v in batch.items()})
        got = make_eval_step(tcfg)(tp, batch)
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    # the train step's differentiable forward gives the kernel path's loss
    opt = make_optimizer("sgd", lambda step: 0.0)
    _, m = make_train_step(tcfg, opt)(make_train_state(tp, opt), {"tokens": toks})
    assert float(m["loss"]) == pytest.approx(float(make_eval_step(tcfg)(tp, {"tokens": toks})),
                                             rel=1e-6)


def test_train_step_refusals():
    _, tcfg, _ = _model("gemma3-1b")
    opt = make_optimizer("sgd", lambda step: 0.1)
    state = make_train_state(TT.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu"),
                             opt)
    # grad_shardings is accepted; a tree that does not match the params raises
    mismatched = make_train_step(tcfg, opt, grad_shardings={})
    with pytest.raises(ValueError, match="grad_shardings does not match the params"):
        mismatched(state, {"tokens": _batches(tcfg, 1)[0]})
    step = make_train_step(tcfg, opt, microbatches=3)
    with pytest.raises(ValueError, match="does not split into 3"):
        step(state, {"tokens": _batches(tcfg, 1)[0]})


def test_launcher_save_reads_back_in_the_reference(tmp_path, capsys):
    path = str(tmp_path / "trained.npz")
    out = tlaunch.main(["--device", "cpu", "--reduced", "--steps", "3", "--log-every", "1",
                        "--save", path])
    printed = capsys.readouterr().out
    assert "[train] gemma3-1b-smoke: ~0.9M params, 3 steps x batch 8 x seq 64" in printed
    assert printed.count("  step ") == 3 and f"[train] saved params to {path}" in printed
    assert len(out["loss"]) == 3 and all(np.isfinite(out["loss"] + out["grad_norm"]))
    back = _jflat(jckpt.load(path))
    mine = _tflat(out["state"]["params"])
    assert sorted(back) == sorted(mine)
    for k in mine:
        np.testing.assert_array_equal(back[k], mine[k], err_msg=k)
    jcfg = dataclasses.replace(jreduce_config(jget_config("gemma3-1b")), remat=False)
    want = jax.tree.map(lambda x: x.shape, JT.init_lm(jcfg, jax.random.PRNGKey(0)))
    assert {k: v.shape for k, v in back.items()} == {
        "/".join(str(p.key) for p in path): s
        for path, s in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, tuple))[0]}
    # every reference arch resolves and trains: one step of reduced jamba
    # (Mamba, MoE and attention layers) through the same launcher
    assert tlaunch.train_config("mixtral-8x7b", reduced=True, seq=64).moe.num_experts == 4
    jamba = tlaunch.main(["--device", "cpu", "--arch", "jamba-1.5-large-398b", "--reduced",
                          "--steps", "1", "--batch", "2", "--seq", "16"])
    assert jamba["cfg"].name == "jamba-1.5-large-398b-smoke"
    assert np.isfinite(jamba["loss"][0]) and jamba["aux"][0] > 0
    assert "mamba" in jamba["state"]["params"]["scan"]["pos0"]
