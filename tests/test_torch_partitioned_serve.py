"""Partitioned serving (prefill and decode on placed params and a cache
placed by ``cache_shardings``) against the JAX package's partitioned jit,
on the CPU.

The reference runs ``jax.jit(make_serve_step(cfg), in_shardings=(params_sh,
cache_sh, tokens_sh, rep), out_shardings=(None, cache_sh))`` and its
Engine's prefill (``forward_lm`` at ``cache_index`` 0) under
``in_shardings=(params_sh, tokens_sh, cache_sh)``, ``out_shardings=(None,
cache_sh)``, greedily for 8 tokens, and ``jax.jit(make_prefill_step(cfg),
in_shardings=(params_sh, batch_sh), out_shardings=None)``, on meshes made
as ``jax.make_mesh(shape, ("data", "model"), axis_types=(Auto, Auto))``,
all in one subprocess on 8 forced CPU devices with the ring cache on
(``REPRO_OPT_RING_CACHE=1``).  Cases (d 128, f32): gemma3-1b cut to 3
layers (local, global, local; window 8, so the local layers' 8-slot rings
wrap during the decode; its one KV head puts the cache's head_dim on
``model``) on (2, 2) and (1, 4); mistral-nemo-12b with ``fsdp=True`` on
(2, 2); rwkv6-7b with ``fsdp=True`` (its config's) on (2, 2).  The port
places the same params by its ``device_put`` and serves them through
``Engine``, ``make_serve_step`` and ``make_prefill_step``.

Tolerances (f32): last-position logits within rtol 1e-5 / atol 1e-5 after
the prefill and after each decode step (teacher-forced on the reference's
tokens); each placed cache block of the reference's shape and within the
same rtol 1e-5 / atol 1e-5 of its ``addressable_shards`` after the prefill
and after the last step (the port's unpartitioned path differs from these
blocks by as much, up to 1.3e-6 of a leaf's largest value: the f32 sums
run in another order than XLA's, so an atol of 1e-6 is below that noise);
the 8 greedy tokens equal.  The collectives a step are
held against ``serve_collectives``, the formula PERF.md states."""
import dataclasses
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import TINY, get_config, reduce_config
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import encoder as TE
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_prefill_step, make_serve_step
from repro_torch.utils.placed import Layout, Placed
from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P, NEW, WINDOW = 4, 6, 8, 8
MAX_LEN = P + WINDOW
# case -> (arch, fsdp, mesh shape)
CASES = {"gemma_2x2": ("gemma3-1b", False, (2, 2)),
         "gemma_1x4": ("gemma3-1b", False, (1, 4)),
         "mistral_fsdp_2x2": ("mistral-nemo-12b", True, (2, 2)),
         "rwkv_fsdp_2x2": ("rwkv6-7b", True, (2, 2))}
LOGIT_RTOL = LOGIT_ATOL = 1e-5
CACHE_RTOL = CACHE_ATOL = 1e-5


def cfg_of(arch, fsdp):
    """The cut both packages serve (the reference script runs this source)."""
    cfg = reduce_config(get_config(arch), d_model=128)
    if arch == "gemma3-1b":  # local, global, local: a stacked period and a tail layer
        local = dataclasses.replace(cfg.pattern[0], window=WINDOW)
        cfg = dataclasses.replace(cfg, num_layers=3, pattern=(local, cfg.pattern[-1]))
    else:
        cfg = dataclasses.replace(cfg, num_layers=2)
    return dataclasses.replace(cfg, fsdp=fsdp)


_REF_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config, reduce_config
from repro.launch import sharding as SH
from repro.models.transformer import forward_lm, init_cache, init_lm
from repro.train.step import make_prefill_step, make_serve_step
from repro.utils.pytree import tree_map_with_name

args = json.loads(sys.argv[1])
out_npz = sys.argv[2]
inputs = np.load(args["inputs"])
B, P, NEW, WINDOW, MAX_LEN = (args[k] for k in ("B", "P", "new", "window", "max_len"))
arrays = {}
""" + inspect.getsource(cfg_of) + r"""

def put(prefix, tree):
    tree_map_with_name(lambda n, x: arrays.__setitem__(f"{prefix}/{n}", np.asarray(x)), tree)

for case, (arch, fsdp, shape) in args["cases"].items():
    cfg = cfg_of(arch, fsdp)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    params = init_lm(cfg, jax.random.PRNGKey(0))
    put(f"{case}/init", params)
    prompts = jnp.asarray(inputs[arch])
    cache = init_cache(cfg, B, MAX_LEN)
    psh = SH.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    csh = SH.cache_shardings(mesh, cache, cfg, data_axis="data", model_axis="model")
    bsh = SH.batch_shardings(mesh, {"tokens": prompts}, data_axis="data")
    rep = SH.replicated(mesh)
    slot = {d: i for i, d in enumerate(mesh.devices.flat)}

    def prefill(params, tokens, cache):
        logits, _, cache = forward_lm(cfg, params, tokens, cache=cache,
                                      cache_index=jnp.asarray(0, jnp.int32))
        return logits[:, -1], cache

    def shards(prefix, cache):
        def one(n, x):
            for sh in x.addressable_shards:
                arrays[f"{prefix}/{n}/{slot[sh.device]}"] = np.asarray(sh.data)
        tree_map_with_name(one, cache)

    with mesh:
        params = jax.device_put(params, psh)
        step = jax.jit(make_prefill_step(cfg), in_shardings=(psh, bsh), out_shardings=None)
        arrays[f"{case}/prefill_step"] = np.asarray(step(params, {"tokens": prompts}))
        pre = jax.jit(prefill, in_shardings=(psh, bsh["tokens"], csh), out_shardings=(None, csh))
        serve = jax.jit(make_serve_step(cfg), in_shardings=(psh, csh, bsh["tokens"], rep),
                        out_shardings=(None, csh))
        logits, cache = pre(params, prompts, jax.device_put(cache, csh))
        shards(f"{case}/cache/prefill", cache)
        toks = [jnp.argmax(logits, -1)]
        arrays[f"{case}/logits/0"] = np.asarray(logits)
        for t in range(1, NEW):
            logits, cache = serve(params, cache, toks[-1][:, None].astype(jnp.int32),
                                  jnp.asarray(P + t - 1, jnp.int32))
            arrays[f"{case}/logits/{t}"] = np.asarray(logits)
            toks.append(jnp.argmax(logits, -1))
        shards(f"{case}/cache/last", cache)
        arrays[f"{case}/tokens"] = np.stack([np.asarray(t) for t in toks], 1)
np.savez(out_npz, **arrays)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference case in one subprocess on 8 forced CPU devices."""
    d = tmp_path_factory.mktemp("partitioned_serve_ref")
    rng = np.random.default_rng(28)
    prompts = {arch: rng.integers(3, 512, (B, P)).astype(np.int32)
               for arch in sorted({a for a, _, _ in CASES.values()})}
    np.savez(d / "in.npz", **prompts)
    args = dict(cases={k: [a, f, list(s)] for k, (a, f, s) in CASES.items()}, B=B, P=P,
                new=NEW, window=WINDOW, max_len=MAX_LEN, inputs=str(d / "in.npz"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8", REPRO_OPT_RING_CACHE="1")
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, json.dumps(args),
                           str(d / "out.npz")], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(d / "out.npz") as out:
        return dict(out), prompts


@pytest.fixture(autouse=True)
def _one_torch_thread_and_the_ring(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(TT, "RING_CACHE", True)  # the reference's REPRO_OPT_RING_CACHE=1
    yield
    torch.set_num_threads(threads)


def _tree(arrays, prefix):
    return tree_from_paths([(k[len(prefix) + 1:], torch.from_numpy(v.copy()))
                            for k, v in sorted(arrays.items()) if k.startswith(prefix + "/")])


def _placed(case, arrays):
    """(cfg, mesh, the reference's params placed by the port, their
    shardings)."""
    arch, fsdp, shape = CASES[case]
    cfg = cfg_of(arch, fsdp)
    mesh = tmesh.make_mesh(shape, ("data", "model"), device="cpu")
    params = _tree(arrays, f"{case}/init")
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    return cfg, mesh, tsh.device_put(params, psh), psh


# -- the collectives a partitioned serving step makes ------------------------------------


def serve_collectives(cfg, psh, R: int, M: int, *, cached: bool = True, data_axis="data"):
    """The formula of PERF.md §5: the collectives of one partitioned
    forward (a prefill, or one decode step) of a dense or RWKV decoder on a
    (data R, model M) grid, as ``({kind: count}, {axis: count})``.  Over
    ``model`` (M > 1): the embedding's all-reduce where the vocabulary
    splits; an all-reduce for each row-parallel output (attention's ``wo``
    and the GLU/MLP where they split, the RWKV time mix's ``wo``); the
    ``wk``/``wv`` blocks all-gathered where the KV heads do not split but
    their spec does; with a cache, its k and v all-gathered where the
    cache's spec splits ``head_dim`` (the KV heads do not split), and an
    RWKV layer's two token-shift states all-gathered; the last logits
    all-gathered where they come out per vocabulary block.  Over the batch
    axis (R > 1): each use of a leaf FSDP splits, one all-gather, and the
    last logits' all-gather."""
    L_attn = [b for b in cfg.blocks if b.mixer == "attn"]
    L_rwkv = [b for b in cfg.blocks if b.mixer == "rwkv"]
    dense = [b for b in cfg.blocks if b.ffn in ("glu", "mlp")]
    ar = ag_m = ag_d = 0
    if M > 1:
        vocab = cfg.vocab_size % M == 0
        hd, Hkv = cfg.head_dim, cfg.num_kv_heads
        attn = (cfg.num_heads * hd) % M == 0
        ar += vocab + len(L_attn) * attn + len(dense) * (cfg.d_ff % M == 0)
        ar += len(L_rwkv) * (cfg.d_model % M == 0)
        if attn and Hkv % M and (Hkv * hd) % M == 0:
            ag_m += 2 * len(L_attn)
        if cached:
            if Hkv % M and hd % M == 0:
                ag_m += 2 * len(L_attn)
            ag_m += 2 * len(L_rwkv) * (cfg.d_model % M == 0)
        ag_m += vocab
    if R > 1:
        n_full, _ = TT.split_layers(cfg)
        for name, sh in tree_leaves_with_path(psh):
            if data_axis in sh.spec:
                ag_d += n_full if name.startswith("scan/") else 1
        ag_d += 1
    kinds = {"all_reduce": ar, "all_gather": ag_m + ag_d, "reduce_scatter": 0}
    axes = {a: n for a, n in (("model", ar + ag_m), (data_axis, ag_d)) if n}
    return kinds, axes


def _step_counts():
    return dict(tmesh.collectives), dict(tmesh.collectives_by_axis)


# -- the steps ---------------------------------------------------------------------------


def _close_blocks(cache, arrays, prefix, n):
    for name, x in tree_leaves_with_path(cache):
        assert isinstance(x, Placed), name
        for s in range(n):
            want = arrays[f"{prefix}/{name}/{s}"]
            got = x.block(s).numpy()
            assert got.shape == want.shape, (name, s, got.shape, want.shape)
            np.testing.assert_allclose(got, want, rtol=CACHE_RTOL, atol=CACHE_ATOL,
                                       err_msg=f"{name} slot {s}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_steps_match_the_reference_jit(ref, case):
    """The engine's prefill and 7 decode steps through ``make_serve_step``
    on placed params and a placed cache, teacher-forced on the reference's
    tokens: logits and every cache block against the reference's, the
    collectives of each step against the formula; the bytes a slot holds
    of params and cache equal ``dryrun.slot_bytes``."""
    arrays, prompts = ref
    cfg, mesh, placed, psh = _placed(case, arrays)
    R, M = mesh.shape["data"], mesh.shape["model"]
    arch = CASES[case][0]
    tokens, cache = Engine(cfg, placed, max_len=MAX_LEN)._start(placed, prompts[arch])
    assert isinstance(tokens, Placed) and tokens.layout.spec[0] == ("data",)
    whole_cache = TT.init_cache(cfg, B, MAX_LEN, device="cpu")
    csh = tsh.cache_shardings(mesh, whole_cache, cfg, data_axis="data", model_axis="model")
    for name, x in tree_leaves_with_path(cache):
        sh = dict(tree_leaves_with_path(csh))[name]
        assert x.layout == Layout(x.shape, sh.spec, mesh), name
    want_bytes = tdry.slot_bytes({"p": placed, "c": whole_cache}, {"p": psh, "c": csh}, mesh)
    assert tsh.placed_slot_bytes({"p": placed, "c": cache}, mesh) == [want_bytes] * 4
    step = make_serve_step(cfg)
    want_counts = serve_collectives(cfg, psh, R, M)
    toks = arrays[f"{case}/tokens"]
    for t in range(NEW):
        tmesh.reset_collectives()
        if t == 0:
            logits, cache = step(placed, cache, tokens, 0)
        else:
            logits, cache = step(placed, cache, toks[:, t - 1:t], P + t - 1)
        assert _step_counts() == want_counts, (t, _step_counts())
        assert logits.shape == (B, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), arrays[f"{case}/logits/{t}"],
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL, err_msg=f"step {t}")
        if t == 0:
            _close_blocks(cache, arrays, f"{case}/cache/prefill", mesh.devices.size)
    _close_blocks(cache, arrays, f"{case}/cache/last", mesh.devices.size)


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_matches_the_reference(ref, case):
    """``Engine.generate`` on placed params: the reference's 8 greedy
    tokens, and the port's whole Engine's on the same params."""
    arrays, prompts = ref
    cfg, mesh, placed, _ = _placed(case, arrays)
    arch = CASES[case][0]
    res = Engine(cfg, placed, max_len=MAX_LEN).generate(prompts[arch], max_new_tokens=NEW)
    np.testing.assert_array_equal(res.tokens[:, P:], arrays[f"{case}/tokens"])
    whole = Engine(cfg, _tree(arrays, f"{case}/init"), max_len=MAX_LEN)
    np.testing.assert_array_equal(whole.generate(prompts[arch], max_new_tokens=NEW).tokens,
                                  res.tokens)
    # params= takes a placed tree on an engine built whole
    again = whole.generate(prompts[arch], max_new_tokens=NEW, params=placed)
    np.testing.assert_array_equal(again.tokens, res.tokens)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_step_matches_the_reference_jit(ref, case):
    """``make_prefill_step`` (no cache) on placed params, the tokens whole
    and placed by ``batch_shardings``, against the reference's partitioned
    prefill step; the collectives of a forward without a cache."""
    arrays, prompts = ref
    cfg, mesh, placed, psh = _placed(case, arrays)
    arch = CASES[case][0]
    batch = {"tokens": prompts[arch]}
    bsh = tsh.batch_shardings(mesh, batch, data_axis="data")
    want_counts = serve_collectives(cfg, psh, mesh.shape["data"], mesh.shape["model"],
                                    cached=False)
    for b in (batch, tsh.device_put(batch, bsh)):
        tmesh.reset_collectives()
        got = make_prefill_step(cfg)(placed, b)
        assert _step_counts() == want_counts
        np.testing.assert_allclose(got.numpy(), arrays[f"{case}/prefill_step"],
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_serve_collective_formula_at_full_width():
    """The formula's counts a decode step for ``chip_smoke.py``'s phase 19
    (gemma3-1b, mistral-nemo-12b with FSDP and rwkv6-7b with FSDP, each on
    (data 2, model 2)), as PERF.md §5 writes them, and the cache blocks
    ``cache_shardings`` gives there (gemma3-1b's head_dim split), from the
    full-width specs built on the meta device, at full depth (the phase
    cuts rwkv6-7b to 8 layers and mistral-nemo-12b to 10; the counts scale
    with the layers)."""
    want = {"gemma3-1b": ({"all_reduce": 53, "all_gather": 106, "reduce_scatter": 0},
                          {"model": 158, "data": 1}, "scan/pos5/k", (4, 2, 1280, 1, 128)),
            "mistral-nemo-12b": ({"all_reduce": 81, "all_gather": 284, "reduce_scatter": 0},
                                 {"model": 82, "data": 283}, "scan/pos0/k",
                                 (40, 2, 272, 4, 128)),
            "rwkv6-7b": ({"all_reduce": 33, "all_gather": 260, "reduce_scatter": 0},
                         {"model": 98, "data": 195}, "scan/pos0/S", (32, 2, 32, 64, 64))}
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device="meta")
    for arch, (kinds, axes, leaf, block) in want.items():
        cfg = get_config(arch)
        max_len = {"gemma3-1b": 1280, "mistral-nemo-12b": 272, "rwkv6-7b": 288}[arch]
        with torch.device("meta"):
            params = _meta_params(cfg)
            cache = TT.init_cache(cfg, 4, max_len, device="meta")
        psh = tsh.params_shardings(mesh, params, cfg)
        assert serve_collectives(cfg, psh, 2, 2) == (kinds, axes), arch
        csh = dict(tree_leaves_with_path(tsh.cache_shardings(mesh, cache, cfg)))
        x = dict(tree_leaves_with_path(cache))[leaf]
        assert Layout(x.shape, csh[leaf].spec, mesh).block_shape == block, arch


def _meta_params(cfg):
    """A full-width parameter tree of shapes only (the draws replaced by
    meta tensors)."""
    from unittest import mock

    def draw(*args, **kw):
        return torch.empty(args[0] if args else kw["size"], dtype=torch.float32, device="meta")

    with mock.patch.object(torch, "randn", draw), mock.patch.object(torch, "rand", draw):
        return TT.init_lm(cfg, torch.Generator(), device="meta")


# -- the refusals ------------------------------------------------------------------------


def _placed_any(params, cfg, mesh):
    return tsh.device_put(params, tsh.params_shardings(mesh, params, cfg))


@pytest.mark.parametrize("arch, part, entry", [
    ("gemma3-1b", "step of 4 positions at cache_index 4 at a batch the batch axis does not "
     "divide (a chunked prefill)", "serve_at"),
    ("gemma3-1b", "batch input 'frames'", "prefill"),
    ("roberta-base", "encoder (RoBERTa)", "prefill"),
    ("qwen2-vl-72b", "step of 3 positions at cache_index 4 at a batch the batch axis does not "
     "divide (a chunked prefill)", "serve_at"),
])
def test_partitioned_serving_refusals(arch, part, entry):
    """What the partitioned serving steps do not run raises
    ``NotImplementedError`` naming the arch and the part, in the train
    step's message format (``tests/test_torch_partitioned.py``'s
    ``test_other_archs_are_refused`` reads the same rule); jamba's Mamba
    mixer serves partitioned since ``tests/test_torch_partitioned_ssm.py``,
    and a batch the data axis does not divide since
    ``tests/test_torch_context_parallel.py`` (with vision inputs since
    ``tests/test_torch_context_parallel_train.py``), but not a prompt
    after the first at such a batch: its chunks (gemma3-1b) or a
    multi-position step every slot holds whole (qwen2-vl) against a cache
    whose sequence is split over data.  The encoder-decoder serves
    partitioned since ``tests/test_torch_partitioned_whisper.py`` (at any
    batch since ``tests/test_torch_context_parallel_whisper.py``; with query
    heads that ``model`` does not divide since
    ``test_heads_that_model_does_not_divide_serve``)."""
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    gen = torch.Generator().manual_seed(0)
    if arch == "roberta-base":
        cfg = TINY
        params = _placed_any(TE.init_encoder_body(cfg, gen, device="cpu"), cfg, mesh)
    else:
        cfg = reduce_config(get_config(arch))
        params = _placed_any(TT.init_lm(cfg, gen, device="cpu"), cfg, mesh)
    rows = 3 if entry == "serve_at" else 4
    toks = np.random.default_rng(0).integers(3, cfg.vocab_size, (rows, 5))
    match = (f"partitioned serving steps does not run {cfg.name}'s "
             + part.replace("(", r"\(").replace(")", r"\)"))
    with pytest.raises(NotImplementedError, match=match):
        if entry == "prefill":
            batch = {"tokens": toks}
            if "frames" in part:
                batch["frames"] = np.zeros((rows, 8, cfg.d_model), np.float32)
            make_prefill_step(cfg)(params, batch)
        elif entry == "serve_at":
            _, cache = Engine(cfg, params, max_len=16)._start(params, toks)
            make_serve_step(cfg)(params, cache, toks[:, :int(part.split()[2])], 4)


@pytest.mark.parametrize("entry", ["generate", "serve"])
def test_heads_that_model_does_not_divide_serve(entry):
    """Reduced whisper at 6 query heads (d 192) on (data 1, model 4), where
    ``model`` splits ``wq``'s columns but not the heads, serves partitioned
    with every query head on every model slot: the generate (encode, prime,
    the prompt through the serve step, then a token a step) gives the whole
    model's greedy tokens with logits within 1e-5 each step, and one serve
    step against a zero cache the whole step's logits.  The reference's
    partitioned jit is ``tests/test_torch_heads_over_model.py``'s."""
    from repro_torch.models import whisper as TW
    cfg = dataclasses.replace(reduce_config(get_config("whisper-tiny"), d_model=192),
                              num_heads=6, num_kv_heads=6, head_dim=32)
    mesh = tmesh.make_mesh((1, 4), ("data", "model"), device="cpu")
    whole = TW.init_whisper(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = _placed_any(whole, cfg, mesh)
    rows = 4
    toks = torch.from_numpy(np.random.default_rng(0).integers(3, cfg.vocab_size, (rows, 5)))
    frames = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32))

    def run(p, placed):
        cache = TW.init_whisper_cache(cfg, rows, 16, device="cpu")
        if placed:
            cache = tsh.device_put(cache, tsh.cache_shardings(mesh, cache, cfg))
        step = make_serve_step(cfg)
        if entry == "serve":
            return [step(p, cache, toks[:, :1], 0)[0]], None
        cache = TW.prime_cross_cache(cfg, p, cache, TW.whisper_encode(cfg, p, frames))
        logits, cache = step(p, cache, toks, 0)
        out, got = [logits], [torch.argmax(logits, -1)]
        for t in range(2):
            logits, cache = step(p, cache, got[-1][:, None], toks.shape[1] + t)
            out.append(logits)
            got.append(torch.argmax(logits, -1))
        return out, torch.stack(got, 1)

    want, want_toks = run(whole, False)
    got, got_toks = run(params, True)
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=f"{t}")
    if entry == "generate":
        np.testing.assert_array_equal(got_toks.numpy(), want_toks.numpy())
