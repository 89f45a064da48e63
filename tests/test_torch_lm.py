"""The port's decoder-LM serving path against the JAX package, on the CPU:
reduced gemma3-1b (window 8, 8 layers, so the 6-layer pattern has a
2-layer tail) and reduced rwkv6-7b, both f32, with the JAX parameters
carried across bit for bit.

Tolerances (f32): logits, caches and states within 1e-4 absolute and
relative (the port's attention keeps its probabilities in f32 like the
reference at f32, and XLA and PyTorch differ only in summation order and
in their ``pow``/``cos``/``exp`` roundings); greedy tokens exactly equal.
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve.engine import Engine as JEngine
from repro.train import step as jstep
from repro.utils.flat import FlatSpec as JFlatSpec
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve.cold_service import ContributorClient
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.train import step as tstep
from repro_torch.utils.flat import FlatSpec as TFlatSpec
from repro_torch.utils.pytree import tree_leaves_with_path, tree_map

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("gemma3-1b", "rwkv6-7b")


def _small(mod_get, mod_reduce, arch):
    """The test's reduced config in either package (same recipe)."""
    cfg = mod_reduce(mod_get(arch))
    if arch == "gemma3-1b":
        pattern = tuple(dataclasses.replace(b, window=8) if b.window else b for b in cfg.pattern)
        cfg = dataclasses.replace(cfg, num_layers=8, pattern=pattern)
    return cfg


def _cfgs(arch):
    return _small(jget_config, jreduce_config, arch), _small(get_config, reduce_config, arch)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """JAX params (numpy leaves) and the port's copy, built once per arch."""
    jcfg, _ = _cfgs(arch)
    jp = jax.tree.map(np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(0)))
    return jp, convert.from_jax_params(jp, "cpu")


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want, np.float32), **(tol or TOL))


def _assert_tree_close(tcache, jcache):
    t = dict(tree_leaves_with_path(tcache))
    j = {"/".join(str(k.key) for k in path): leaf
         for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]}
    assert sorted(t) == sorted(j)
    for key in t:
        _close(t[key], j[key])


def test_configs_match_the_reference():
    """All 11 reference archs resolve, full and reduced, equal to the
    reference's field by field (MoE, SSM and RoPE sub-configs included)."""
    assert ARCH_IDS == JARCH_IDS and len(ARCH_IDS) == 11
    for arch in ARCH_IDS:
        for cfg_pair in ((jget_config(arch), get_config(arch)),
                         (jreduce_config(jget_config(arch)), reduce_config(get_config(arch)))):
            jcfg, tcfg = cfg_pair
            assert [f.name for f in dataclasses.fields(tcfg)] == \
                [f.name for f in dataclasses.fields(jcfg)]
            for f in dataclasses.fields(tcfg):
                jv, tv = getattr(jcfg, f.name), getattr(tcfg, f.name)
                if dataclasses.is_dataclass(tv) and not isinstance(tv, type):
                    tv, jv = dataclasses.asdict(tv), dataclasses.asdict(jv)
                elif isinstance(tv, tuple) and tv and dataclasses.is_dataclass(tv[0]):
                    tv, jv = [dataclasses.asdict(b) for b in tv], [dataclasses.asdict(b) for b in jv]
                assert jv == tv, (arch, f.name)
            assert [dataclasses.asdict(b) for b in jcfg.blocks] == \
                [dataclasses.asdict(b) for b in tcfg.blocks]
            assert jcfg.period == tcfg.period
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mixtral-8x22b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_tree_has_the_reference_spec(arch, dtype):
    jcfg, tcfg = _cfgs(arch)
    jcfg = dataclasses.replace(jcfg, param_dtype=dtype)
    tcfg = dataclasses.replace(tcfg, param_dtype=dtype)
    jspec = JFlatSpec.from_tree(JT.init_lm(jcfg, jax.random.PRNGKey(0)))
    tparams = TT.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert TFlatSpec.from_tree(tparams).to_json() == jspec.to_json()
    if arch == "gemma3-1b":  # stacked periods and a tail, as in the reference
        assert tparams["scan"]["pos0"]["attn"]["wq"].shape[0] == 1
        assert sorted(tparams["tail"]) == ["layer6", "layer7"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_lm_logits(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    toks = _tokens(tcfg, 2, 20, seed=1)
    jl, _, jc = JT.forward_lm(jcfg, jp, jnp.asarray(toks))
    tl, aux, tc = TT.forward_lm(tcfg, tp, torch.from_numpy(toks).long())
    assert jc is None and tc is None and float(aux) == 0.0
    assert tl.shape == (2, 20, tcfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_cache_and_one_serve_step(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    B, P, L = 2, 12, 24
    toks = _tokens(tcfg, B, P + 1, seed=2)
    jcache = JT.init_cache(jcfg, B, L)
    tcache = TT.init_cache(tcfg, B, L, device="cpu")
    _assert_tree_close(tcache, jcache)
    jl, _, jcache = JT.forward_lm(jcfg, jp, jnp.asarray(toks[:, :P]), cache=jcache,
                                  cache_index=jnp.asarray(0, jnp.int32))
    tl, _, tcache2 = TT.forward_lm(tcfg, tp, torch.from_numpy(toks[:, :P]).long(),
                                   cache=tcache, cache_index=0)
    assert tcache2 is tcache  # updated in place
    _close(tl, jl)
    _assert_tree_close(tcache, jcache)

    jlog, jcache = jstep.make_serve_step(jcfg)(jp, jcache, jnp.asarray(toks[:, P:]),
                                               jnp.asarray(P, jnp.int32))
    tlog, tcache = tstep.make_serve_step(tcfg)(tp, tcache, torch.from_numpy(toks[:, P:]).long(),
                                               P)
    assert tlog.shape == (B, tcfg.vocab_size)
    _close(tlog, jlog)
    _assert_tree_close(tcache, jcache)

    jpre = jstep.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    tpre = tstep.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks).long()})
    _close(tpre, jpre)
    _close(tpre, tlog)  # the cached path ends where the full prefill does


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generate_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    prompts = _tokens(tcfg, 3, 12, seed=3)
    jres = JEngine(jcfg, jax.tree.map(jnp.asarray, jp), max_len=32).generate(
        prompts, max_new_tokens=16)
    eng = TEngine(tcfg, tp, max_len=32)
    tres = eng.generate(prompts, max_new_tokens=16)
    assert (tres.prompt_len, tres.steps) == (jres.prompt_len, jres.steps) == (12, 16)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    # params= serves one request against another tree; the default stays
    half = tree_map(lambda x: x * 0.5, tp)
    moved = eng.generate(prompts, max_new_tokens=4, params=half)
    oracle = TEngine(tcfg, half, max_len=32).generate(prompts, max_new_tokens=4)
    np.testing.assert_array_equal(moved.tokens, oracle.tokens)
    np.testing.assert_array_equal(eng.generate(prompts, max_new_tokens=16).tokens, tres.tokens)
    with pytest.raises(ValueError, match="prompt_len=12 .*max_new_tokens=30.*max_len=32"):
        eng.generate(prompts, max_new_tokens=30)


def test_jax_checkpoint_served_by_the_port_launcher(tmp_path, capsys):
    jcfg = jreduce_config(jget_config("gemma3-1b"))
    jparams = JT.init_lm(jcfg, jax.random.PRNGKey(4))
    path = str(tmp_path / "lm.npz")
    jckpt.save(path, jparams)
    res = tserve.main(["--arch", "gemma3-1b", "--reduced", "--load", path, "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--new-tokens", "16", "--seed", "5"])
    assert "[serve] gemma3-1b-smoke on cpu: 2 requests x 16 tokens" in capsys.readouterr().out
    prompts = res.tokens[:, :12]
    jres = JEngine(jcfg, jparams, max_len=29).generate(prompts, max_new_tokens=16)
    np.testing.assert_array_equal(res.tokens, jres.tokens)


def test_embed_scale_rounds_in_the_compute_dtype():
    """gemma's sqrt(1152) = 33.941 is cast to bf16 (34.0) before the product."""
    cfg = dataclasses.replace(get_config("gemma3-1b"), vocab_size=16)
    embed = np.random.default_rng(6).standard_normal((16, 1152)).astype(np.float32) * 0.02
    ebf = np.asarray(jnp.asarray(embed, jnp.bfloat16))
    toks = np.array([[1, 5, 9]])
    got = TT.embed_tokens(cfg, {"embed": convert.from_numpy(ebf, "cpu")}, torch.from_numpy(toks))
    want = jnp.asarray(ebf)[toks].astype(jnp.bfloat16) * jnp.asarray(1152 ** 0.5, jnp.bfloat16)
    assert float(jnp.asarray(1152 ** 0.5, jnp.bfloat16)) == 34.0
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_rope_casts_cos_sin_to_the_input_dtype():
    rng = np.random.default_rng(7)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 5, 3, 32)), jnp.bfloat16))
    pos = np.arange(100, 105)[None].repeat(2, 0)
    rope = get_config("gemma3-1b").rope
    jang = JL.rope_angles(jget_config("gemma3-1b").rope, jnp.asarray(pos), 32)
    tang = TL.rope_angles(rope, torch.from_numpy(pos), 32)
    _close(tang, jang, rtol=1e-6, atol=1e-4)
    got = TL.apply_rope(convert.from_numpy(x, "cpu"), convert.from_numpy(jang, "cpu"))
    want = JL.apply_rope(jnp.asarray(x), jang)
    assert got.dtype == torch.bfloat16
    # both multiply by cos/sin already rounded to bf16; the sums may round differently
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2 ** -6, rtol=2 ** -7)


@pytest.mark.parametrize("variant", ["mamba", "mrope"])
def test_mamba_block_and_mrope_on_reduced_gemma3_match_the_reference(variant):
    """Reduced gemma3 (window 8, 8 layers) with its first pattern slot a
    Mamba mixer, or with M-RoPE sections (4, 6, 6) on 2-D positions: a prefill into the
    cache and one serve step, logits and caches against the reference's;
    the cache refuses a write past its end."""

    def variant_of(cfg):
        if variant == "mamba":
            return dataclasses.replace(cfg, pattern=(dataclasses.replace(
                cfg.pattern[0], mixer="mamba"),) + cfg.pattern[1:])
        # M-RoPE drives every layer at the config's theta (gemma's local layers
        # carry a theta of their own, which the reference's M-RoPE has no angles for)
        return dataclasses.replace(
            cfg, rope=dataclasses.replace(cfg.rope, kind="mrope", mrope_sections=(4, 6, 6)),
            pattern=tuple(dataclasses.replace(b, rope_theta=None) for b in cfg.pattern))

    jcfg, tcfg = (variant_of(c) for c in _cfgs("gemma3-1b"))
    jp = jax.tree.map(np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(0)))
    tp = convert.from_jax_params(jp, "cpu")
    B, P, L = 2, 10, 16
    toks = _tokens(tcfg, B, P + 1, seed=8)
    jcache, tcache = JT.init_cache(jcfg, B, L), TT.init_cache(tcfg, B, L, device="cpu")
    jl, _, jcache = JT.forward_lm(jcfg, jp, jnp.asarray(toks[:, :P]), cache=jcache,
                                  cache_index=jnp.asarray(0, jnp.int32))
    tl, _, tcache = TT.forward_lm(tcfg, tp, torch.from_numpy(toks[:, :P]).long(), cache=tcache,
                                  cache_index=0)
    _close(tl, jl)
    _assert_tree_close(tcache, jcache)
    jl, jcache = jstep.make_serve_step(jcfg)(jp, jcache, jnp.asarray(toks[:, P:]),
                                             jnp.asarray(P, jnp.int32))
    tl, tcache = tstep.make_serve_step(tcfg)(tp, tcache, torch.from_numpy(toks[:, P:]).long(), P)
    _close(tl, jl)
    _assert_tree_close(tcache, jcache)
    if variant == "mamba":
        assert sorted(tcache["scan"]["pos0"]) == ["conv", "h"]
    with pytest.raises(ValueError, match="overrun"):
        TT.forward_lm(tcfg, tp, torch.zeros((1, 4), dtype=torch.long),
                      cache=TT.init_cache(tcfg, 1, 8, device="cpu"), cache_index=6)


def test_serving_entry_points_default_to_the_card(tmp_path):
    assert inspect.signature(ContributorClient.download_base).parameters["device"].default \
        == "cuda"
    assert tserve.build_parser().parse_args([]).device == "cuda"
    cfg = reduce_config(get_config("rwkv6-7b"))
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the defaults would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_lm(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "rwkv6-7b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContributorClient(str(tmp_path), "c0").download_base()
