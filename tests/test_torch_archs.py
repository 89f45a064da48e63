"""Every reference arch config in the port, and the archs the MoE and hybrid
slices run (granite-moe-1b-a400m, mixtral-8x7b, mistral-nemo-12b,
stablelm-12b, granite-20b, jamba-1.5-large-398b, qwen2-vl-72b) reduced,
against the JAX package on the CPU; every arch through both launchers; plus
``flash_attention``'s plain version at head_dim 160 (stablelm-12b's)
against the reference's oracle and its Pallas kernel in interpret mode.

The reduced models are f32 with the reference's parameters carried across
bit for bit.  Tolerances (f32): logits, caches and the aux loss within
1e-4 absolute and relative (``test_torch_lm.TOL``: the same arithmetic in
another summation order); greedy tokens exactly equal; one AdamW step's
loss, aux and grad_norm within 1e-5 relative, and its parameters, with
both packages fed the reference's gradient (Adam's first step divides by
sqrt(v) + eps, so a gradient entry near eps would amplify a last-bit
difference), within 1e-5 relative and 1e-7 absolute.  Reduced MoE configs
have capacity_factor = E / k, so no token drops and the routing of a
cached decode equals that of one forward over the same tokens.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import all_configs as jall_configs
from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import transformer as JT
from repro.optim import optimizers as JO
from repro.serve.engine import Engine as JEngine
from repro.train import losses as JLS
from repro.train import step as JS
from repro.utils.flat import FlatSpec as JFlatSpec
from repro_torch import convert
from repro_torch.configs import (ARCH_IDS, SHAPES, all_configs, get_config, get_shape,
                                 reduce_config)
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as TT
from repro_torch.optim import make_optimizer, warmup_cosine_lr
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.train import make_train_state, make_train_step
from repro_torch.train import step as tstep
from repro_torch.utils.flat import FlatSpec as TFlatSpec
from repro_torch.utils.pytree import tree_leaves_with_path

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("granite-moe-1b-a400m", "mixtral-8x7b", "mistral-nemo-12b", "stablelm-12b",
         "granite-20b", "jamba-1.5-large-398b", "qwen2-vl-72b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread (the suite runs several workers on a few
    cores; many-threaded torch stalls the others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- configs ---------------------------------------------------------------------------


def test_every_reference_arch_resolves_in_the_reference_order():
    assert ARCH_IDS == tuple(jall_configs())
    assert list(all_configs()) == list(ARCH_IDS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_equals_the_reference_field_by_field(arch, reduced):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jreduce_config(jcfg), reduce_config(tcfg)
    assert [f.name for f in dataclasses.fields(tcfg)] == [f.name for f in dataclasses.fields(jcfg)]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert [dataclasses.asdict(b) for b in tcfg.blocks] == [dataclasses.asdict(b)
                                                            for b in jcfg.blocks]
    assert (tcfg.period, tcfg.is_subquadratic, tcfg.has_decoder) == \
        (jcfg.period, jcfg.is_subquadratic, jcfg.has_decoder)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch,total,active", [
    ("granite-moe-1b-a400m", 1_334_628_352, 428_658_688),
    ("mixtral-8x7b", 46_702_792_704, 12_879_925_248),
    ("jamba-1.5-large-398b", 398_553_047_040, 94_147_239_936),
    ("whisper-tiny", 36_440_832, 36_440_832),
    ("gemma3-1b", 999_812_736, 999_812_736),
])
def test_param_counts_of_the_moe_ssm_and_encoder_decoder_archs(arch, total, active):
    cfg = get_config(arch)
    assert (cfg.param_count(), cfg.active_param_count()) == (total, active)


def test_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert get_shape("decode_32k").is_decode and not get_shape("train_4k").is_decode
    with pytest.raises(KeyError, match="unknown input shape"):
        get_shape("nope")


def test_reduced_moe_config_drops_no_token():
    cfg = reduce_config(get_config("granite-moe-1b-a400m"))
    assert (cfg.moe.num_experts, cfg.moe.experts_per_token, cfg.moe.capacity_factor) == \
        (4, 2, 2.0)
    jamba = reduce_config(get_config("jamba-1.5-large-398b"))
    assert (jamba.ssm.d_state, jamba.ssm.dt_rank, jamba.num_layers) == (8, 8, 8)
    qwen = reduce_config(get_config("qwen2-vl-72b"))
    assert sum(qwen.rope.mrope_sections) == qwen.head_dim // 2


# -- the reduced archs this slice runs -------------------------------------------------


def _cfgs(arch):
    return jreduce_config(jget_config(arch)), reduce_config(get_config(arch))


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg, _ = _cfgs(arch)
    jp = jax.tree.map(np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(0)))
    return jp, convert.from_jax_params(jp, "cpu")


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want, np.float32), **(tol or TOL))


def _assert_tree_close(ttree, jtree, **tol):
    t = dict(tree_leaves_with_path(ttree))
    j = {"/".join(str(k.key) for k in path): leaf
         for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert sorted(t) == sorted(j)
    for key in t:
        _close(t[key].detach(), j[key], **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_tree_has_the_reference_spec(arch, dtype):
    jcfg, tcfg = (dataclasses.replace(c, param_dtype=dtype) for c in _cfgs(arch))
    jspec = JFlatSpec.from_tree(JT.init_lm(jcfg, jax.random.PRNGKey(0)))
    tparams = TT.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert TFlatSpec.from_tree(tparams).to_json() == jspec.to_json()
    n = sum(x.numel() for _, x in tree_leaves_with_path(tparams))
    # the analytic count leaves out the LayerNorms' biases and each Mamba
    # mixer's conv_b and dt_bias, as the reference's does
    biases = (2 * tcfg.num_layers + 1) * tcfg.d_model if tcfg.norm == "layernorm" else 0
    biases += sum(b.mixer == "mamba" for b in tcfg.blocks) * 2 * tcfg.ssm.expand * tcfg.d_model
    assert n == tcfg.param_count() + biases


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_lm_logits_and_aux(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    toks = _tokens(tcfg, 2, 20, seed=1)
    jl, jaux, _ = JT.forward_lm(jcfg, jp, jnp.asarray(toks))
    tl, taux, _ = TT.forward_lm(tcfg, tp, torch.from_numpy(toks).long())
    _close(tl, jl)
    assert taux.dtype == torch.float32 and taux.shape == ()
    assert float(taux) == pytest.approx(float(jaux), rel=1e-4, abs=1e-6)
    # one load-balance loss per MoE layer, each near 1 for a random router
    n_moe = sum(b.ffn == "moe" for b in tcfg.blocks)
    assert (float(taux) > 0.5 * n_moe) if n_moe else float(taux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_cache_and_one_serve_step(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    B, P, L = 2, 12, 24
    toks = _tokens(tcfg, B, P + 1, seed=2)
    jcache = JT.init_cache(jcfg, B, L)
    tcache = TT.init_cache(tcfg, B, L, device="cpu")
    jl, _, jcache = JT.forward_lm(jcfg, jp, jnp.asarray(toks[:, :P]), cache=jcache,
                                  cache_index=jnp.asarray(0, jnp.int32))
    tl, _, tcache = TT.forward_lm(tcfg, tp, torch.from_numpy(toks[:, :P]).long(), cache=tcache,
                                  cache_index=0)
    _close(tl, jl)
    _assert_tree_close(tcache, jcache)
    jlog, jcache = JS.make_serve_step(jcfg)(jp, jcache, jnp.asarray(toks[:, P:]),
                                            jnp.asarray(P, jnp.int32))
    tlog, tcache = tstep.make_serve_step(tcfg)(tp, tcache, torch.from_numpy(toks[:, P:]).long(),
                                               P)
    _close(tlog, jlog)
    _assert_tree_close(tcache, jcache)
    # no token dropped: the cached path ends where one forward over P + 1 does
    full, _, _ = TT.forward_lm(tcfg, tp, torch.from_numpy(toks).long())
    _close(tlog, full[:, -1])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generate_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    prompts = _tokens(tcfg, 2, 8, seed=3)
    jres = JEngine(jcfg, jax.tree.map(jnp.asarray, jp), max_len=16).generate(
        prompts, max_new_tokens=8)
    tres = TEngine(tcfg, tp, max_len=16).generate(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)


def _jflat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_train_step_matches_reference(arch):
    """One AdamW step (the configs' optimizer, aux at cfg.moe.aux_loss_weight):
    loss, aux and grad_norm from each package's own gradient; then the
    parameters and Adam's moments from the reference's gradient fed to both."""
    jcfg, tcfg = _cfgs(arch)
    jp, _ = _params(arch)
    assert tcfg.optimizer == jcfg.optimizer == "adamw"
    sched = dict(warmup=1, total=3)
    jopt = JO.make_optimizer(jcfg.optimizer, JO.warmup_cosine_lr(3e-3, **sched))
    topt = make_optimizer(tcfg.optimizer, warmup_cosine_lr(3e-3, **sched))
    toks = _tokens(tcfg, 4, 16, seed=4)
    js = JS.make_train_state(jax.tree.map(jnp.asarray, jp), jopt)

    def jtotal(p):
        logits, aux, _ = JT.forward_lm(jcfg, p, jnp.asarray(toks))
        return JLS.lm_loss(logits, jnp.asarray(toks)) + jcfg.moe.aux_loss_weight * aux, aux

    (_, jaux), g = jax.value_and_grad(jtotal, has_aux=True)(js["params"])
    _, jm = JS.make_train_step(jcfg, jopt)(js, {"tokens": jnp.asarray(toks)})
    ts = make_train_state(convert.from_jax_params(jp, "cpu"), topt)
    _, tm = make_train_step(tcfg, topt)(ts, {"tokens": toks})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    assert float(tm["aux"]) == pytest.approx(float(jaux), rel=1e-5, abs=1e-7)

    js2, jm2 = JS.make_train_step(jcfg, jopt, grad_sync=lambda _: g)(js, {"tokens": toks})
    tg = convert.from_jax_params(jax.tree.map(np.asarray, g), "cpu")
    ts2, tm2 = make_train_step(tcfg, topt, grad_sync=lambda _: tg)(ts, {"tokens": toks})
    assert float(tm2["grad_norm"]) == pytest.approx(float(jm2["grad_norm"]), rel=1e-6)
    _assert_tree_close(ts2["params"], js2["params"], rtol=1e-5, atol=1e-7)
    _assert_tree_close(ts2["opt"]["m"], js2["opt"]["m"], rtol=1e-5, atol=1e-9)


def test_microbatched_moe_step_with_drops_matches_reference():
    """Reduced granite-moe at the full config's capacity_factor 1.25 (tokens
    drop) and its aux weight, 2 microbatches: each microbatch routes with
    its own capacity and its own aux loss, in both packages.  Loss and
    grad_norm against the reference's; the parameters after an SGD step at
    lr 1 (the clipped, accumulated gradient itself; Adam's first step would
    amplify last-bit differences near its eps)."""
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=1.25))
                  for c in _cfgs("granite-moe-1b-a400m"))
    assert tcfg.moe.aux_loss_weight == jcfg.moe.aux_loss_weight == 0.01
    jp, tp = _params("granite-moe-1b-a400m")
    toks = _tokens(tcfg, 8, 16, seed=6)
    jopt, topt = JO.make_optimizer("sgd", lambda step: 1.0), make_optimizer("sgd", lambda step: 1.0)
    js = JS.make_train_state(jax.tree.map(jnp.asarray, jp), jopt)
    ts = make_train_state(tp, topt)
    js2, jm = JS.make_train_step(jcfg, jopt, microbatches=2)(js, {"tokens": jnp.asarray(toks)})
    ts2, tm = make_train_step(tcfg, topt, microbatches=2)(ts, {"tokens": toks})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    _assert_tree_close(ts2["params"], js2["params"], rtol=1e-5, atol=1e-7)
    # not vacuous: tokens drop at 1.25 (the loss differs from E / k's), and
    # the microbatches route otherwise than the whole batch does
    _, tm_nodrop = make_train_step(_cfgs("granite-moe-1b-a400m")[1], topt, microbatches=2)(
        ts, {"tokens": toks})
    _, tm_one = make_train_step(tcfg, topt)(ts, {"tokens": toks})
    assert abs(float(tm_nodrop["loss"]) - float(tm["loss"])) > 1e-4
    assert abs(float(tm_one["grad_norm"]) / float(tm["grad_norm"]) - 1) > 1e-4


def test_aux_weight_reads_the_config():
    """The objective is loss + cfg.moe.aux_loss_weight * aux unless
    ``aux_weight=`` is given: with the weight at 0 the router learns from the
    combine weights alone, so its gradient changes."""
    _, tcfg = _cfgs("granite-moe-1b-a400m")
    _, tp = _params("granite-moe-1b-a400m")
    toks = _tokens(tcfg, 2, 8, seed=5)
    opt = make_optimizer("sgd", lambda step: 1.0)
    state = make_train_state(tp, opt)
    router = "scan/pos0/moe/router"
    moved = {}
    for name, kw in (("cfg", {}), ("explicit", {"aux_weight": tcfg.moe.aux_loss_weight}),
                     ("zero", {"aux_weight": 0.0})):
        new, m = make_train_step(tcfg, opt, clip_norm=1e9, **kw)(state, {"tokens": toks})
        moved[name] = dict(tree_leaves_with_path(new["params"]))[router] - \
            dict(tree_leaves_with_path(tp))[router]
        assert float(m["aux"]) > 0
    assert torch.equal(moved["cfg"], moved["explicit"])
    assert not torch.equal(moved["cfg"], moved["zero"])
    assert not hasattr(tstep, "AUX_LOSS_WEIGHT")


# -- launchers --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "granite-20b"])
def test_serve_launcher_runs_the_reduced_arch(arch, capsys):
    res = tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "6", "--new-tokens", "4"])
    assert res.tokens.shape == (2, 10)
    assert f"[serve] {arch}-smoke on cpu: 2 requests x 4 tokens" in capsys.readouterr().out


def test_train_launcher_trains_reduced_granite_moe(tmp_path):
    out = tlaunch.main(["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
                        "--steps", "3", "--batch", "4", "--seq", "16", "--log-every", "1",
                        "--save", str(tmp_path / "moe.npz")])
    assert len(out["loss"]) == len(out["aux"]) == len(out["grad_norm"]) == 3
    assert all(np.isfinite(out["loss"] + out["aux"] + out["grad_norm"]))
    assert all(a > 0 for a in out["aux"])
    back = tserve.main(["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
                        "--load", str(tmp_path / "moe.npz"), "--batch", "1",
                        "--prompt-len", "4", "--new-tokens", "2"])
    assert back.tokens.shape == (1, 6)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_runs_through_both_launchers(arch, tmp_path, capsys):
    """Every reference arch, reduced, trains through the launcher and serves
    what it trained, jamba (Mamba), qwen2-vl (M-RoPE, extra_embeds) and
    whisper (the encoder-decoder stack) among them; whisper's serve
    launcher exits as the reference's does."""
    npz = str(tmp_path / "trained.npz")
    out = tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                        "--batch", "4", "--seq", "16", "--log-every", "1", "--save", npz])
    assert len(out["loss"]) == 2 and all(np.isfinite(out["loss"] + out["grad_norm"]))
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--load", npz, "--batch", "2",
            "--prompt-len", "6", "--new-tokens", "3"]
    if arch == "whisper-tiny":
        with pytest.raises(SystemExit, match="use whisper_decode directly"):
            tserve.main(argv)
        return
    res = tserve.main(argv)
    assert res.tokens.shape == (2, 9)
    assert f"[serve] {arch}-smoke on cpu: 2 requests x 3 tokens" in capsys.readouterr().out


def test_serve_launcher_cuts_depth():
    res = tserve.main(["--arch", "jamba-1.5-large-398b", "--reduced", "--device", "cpu",
                       "--num-layers", "5", "--batch", "1", "--prompt-len", "4",
                       "--new-tokens", "2"])
    assert res.tokens.shape == (1, 6)
    with pytest.raises(SystemExit, match="--num-layers must be in 1..8"):
        tserve.main(["--arch", "jamba-1.5-large-398b", "--reduced", "--device", "cpu",
                     "--num-layers", "9"])


# -- flash_attention's plain version at head_dim 160 ----------------------------------


def _qkv(B, Sq, Sk, Hq, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal,window,q_offset,bq,bk", [
    (1, 64, 64, 4, 1, True, None, 0, 32, 32),     # causal, GQA 4:1
    (1, 64, 96, 4, 1, True, 24, 32, 32, 32),      # window, queries deep in the keys
    (2, 1, 64, 8, 2, True, None, 63, 1, 32),      # decode with q_offset, GQA 4:1
    (1, 1, 64, 4, 1, True, 8, 40, 1, 32),         # decode under a window
    (1, 32, 32, 2, 2, False, None, 0, 32, 32),    # bidirectional
])
def test_flash_plain_at_head_dim_160(B, Sq, Sk, Hq, Hkv, causal, window, q_offset, bq, bk):
    assert 160 in tfa.HEAD_DIMS
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, 160, seed=Sq + Sk)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = tfa.flash_attention(*t, causal=causal, window=window, q_offset=q_offset)
    want = ref.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    pallas = pallas_flash(q, k, v, causal=causal, window=window, q_offset=q_offset,
                          block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5, rtol=0)


def test_flash_plain_at_head_dim_160_rows_that_see_no_key():
    q, k, v = _qkv(1, 4, 64, 4, 1, 160, seed=9)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = tfa.flash_attention(*t, causal=True, window=8, q_offset=100)
    assert torch.equal(got, torch.zeros_like(got))
    np.testing.assert_array_equal(np.asarray(ref.flash_attention(q, k, v, causal=True, window=8,
                                                                 q_offset=100)), 0.0)
    got = tfa.flash_attention(*t, causal=True, window=8, q_offset=66)  # rows 1.. see fewer
    want = ref.flash_attention(q, k, v, causal=True, window=8, q_offset=66)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    assert (got[0, 0] != 0).any()
