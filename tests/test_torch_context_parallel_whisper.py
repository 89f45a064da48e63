"""The encoder-decoder (whisper) at a batch the batch axis does not divide
(one audio request trained and served on a data x model grid), against the
JAX package's partitioned jit, on the CPU.

The reference runs, in two subprocesses side by side on 8 forced CPU
devices, on meshes made as ``jax.make_mesh(shape, ("data", "model"),
axis_types=(Auto, Auto))``: ``jax.jit(make_train_step(cfg, sgd-momentum,
grad_shardings=psh), in_shardings=(state_sh, batch_sh),
out_shardings=(state_sh, None))`` for 3 steps, where ``batch_sh`` is
``batch_shardings``' (the tokens ``P(None, 'data')`` where R divides
their length, else whole; ``frames`` [B, N, D] whole); the eval and
prefill steps under ``in_shardings=(psh, batch_sh)``;
``prime_cross_cache`` after ``whisper_encode`` with
``out_shardings=cache_sh`` (``cache_shardings``: the self and cross
caches' positions over ``data`` where R divides them, their heads over
``model``); ``make_serve_step`` for the prompt at ``cache_index`` 0 under
the prompt's ``batch_shardings`` and for each greedy token under the
[B, 1] token's own (replicated: the prompt's does not lower for it), 8
tokens in all.  Cases, reduced whisper-tiny (``reduce_config``: d 128, 4
heads of 32 on 2 KV heads, 2 + 2 layers, 16 frames, vocab 512, f32):
B = 1 on (data 2, model 2) and on (4, 2), the tokens and the frames in
chunks; B = 1 at 7 tokens and a 3-token prompt on (2, 2) (the ``"whole"``
layout: every slot all the tokens, the frames still in chunks); B = 3 on
(2, 2); ``fsdp=True`` at B = 1 on (2, 2); B = 1 on (4, 2) at 18 frames,
which 4 does not divide (the encoder whole on every slot, the cross cache
whole over ``data``).  The port places the same params by its
``device_put`` and runs the same steps.

Tolerances (f32), those of ``tests/test_torch_partitioned_whisper.py``:
loss and grad_norm within rtol 1e-5, params and momentum within rtol / atol
1e-5 after the last step; the eval loss and the last logits within rtol /
atol 1e-5; every placed cache block (``k``, ``v``, ``xk``, ``xv``) within
1e-5 of its ``addressable_shards`` after priming, after the prompt and
after the last step; the 8 greedy tokens equal.  The collectives of each
step equal ``chip_smoke.partitioned_collectives(seq=)`` and
``chip_smoke.whisper_collectives(step=)``, the formulas PERF.md §5
states.  Two more cases hold the port against its own whole model (no
reference run): a 10-token prompt, whose cross partials run in pieces of
8 rows, and B = 1 on (data 2, model 4), where the caches split
``head_dim`` over ``model``."""
import dataclasses
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import whisper as TW
from repro_torch.models.partitioned import seq_layout
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train.step import (make_eval_step, make_prefill_step, make_serve_step,
                                    make_train_state, make_train_step)
from repro_torch.utils.placed import Layout, Placed
from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)
STEPS, LR, NEW, MAX_LEN = 3, 0.05, 8, 12
# case -> (fsdp, mesh shape, batch, tokens a train step, prompt, frames or None for 16)
CASES = {"b1_d2m2": (False, (2, 2), 1, 8, 4, None),
         "b1_d4m2": (False, (4, 2), 1, 8, 4, None),
         "b1_whole_d2m2": (False, (2, 2), 1, 7, 3, None),
         "b3_d2m2": (False, (2, 2), 3, 8, 4, None),
         "fsdp_b1_d2m2": (True, (2, 2), 1, 8, 4, None),
         "b1_n18_d4m2": (False, (4, 2), 1, 8, 4, 18)}
# the reference's cases in two subprocesses side by side
REF_GROUPS = (("b1_d2m2", "b1_whole_d2m2", "b1_n18_d4m2"),
              ("b1_d4m2", "b3_d2m2", "fsdp_b1_d2m2"))
RTOL = ATOL = 1e-5


def cfg_of(fsdp, frames):
    """The cut both packages run (the reference script runs this source)."""
    cfg = dataclasses.replace(reduce_config(get_config("whisper-tiny")), fsdp=fsdp)
    return cfg if frames is None else dataclasses.replace(cfg, encoder_seq=frames)


_REF_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config, reduce_config
from repro.launch import sharding as SH
from repro.models import whisper as W
from repro.optim.optimizers import constant_lr, make_optimizer
from repro.train.step import (make_eval_step, make_prefill_step, make_serve_step,
                              make_train_state, make_train_step)
from repro.utils.pytree import tree_map_with_name

args = json.loads(sys.argv[1])
out_npz = sys.argv[2]
inputs = dict(np.load(args["inputs"]))
NEW, MAX_LEN = args["new"], args["max_len"]
arrays = {}
""" + inspect.getsource(cfg_of) + r"""

def put(prefix, tree):
    tree_map_with_name(lambda n, x: arrays.__setitem__(f"{prefix}/{n}", np.asarray(x)), tree)

opt = make_optimizer("sgd", constant_lr(args["lr"]), momentum=0.9)
for case in args["jobs"]:
    fsdp, shape, B, S, P, n_frames = args["cases"][case]
    cfg = cfg_of(fsdp, n_frames)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    params = W.init_whisper(cfg, jax.random.PRNGKey(0))
    put(f"{case}/init", params)
    state = make_train_state(params, opt)
    psh = SH.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    state_sh = {"params": psh, "opt": SH.opt_state_shardings(mesh, state["opt"], psh)}

    def batch_of(i):
        return {"tokens": jnp.asarray(inputs[f"{case}/tokens"][i]),
                "frames": jnp.asarray(inputs[f"{case}/frames"][i])}

    bsh = SH.batch_shardings(mesh, batch_of(0), data_axis="data")
    prompts = jnp.asarray(inputs[f"{case}/prompts"])
    prompt_sh = SH.batch_shardings(mesh, {"tokens": prompts}, data_axis="data")["tokens"]
    token_sh = SH.batch_shardings(mesh, {"tokens": prompts[:, :1]}, data_axis="data")["tokens"]
    rep = SH.replicated(mesh)
    slot = {d: i for i, d in enumerate(mesh.devices.flat)}

    def shards(prefix, cache):
        def one(n, x):
            for sh in x.addressable_shards:
                arrays[f"{prefix}/{n}/{slot[sh.device]}"] = np.asarray(sh.data)
        tree_map_with_name(one, cache)

    with mesh:
        step = jax.jit(make_train_step(cfg, opt, grad_shardings=psh),
                       in_shardings=(state_sh, bsh), out_shardings=(state_sh, None))
        st = jax.device_put(state, state_sh)
        for i in range(args["steps"]):
            st, m = step(st, batch_of(i))
            arrays[f"{case}/loss/{i}"] = np.asarray(m["loss"])
            arrays[f"{case}/grad_norm/{i}"] = np.asarray(m["grad_norm"])
        put(f"{case}/params", st["params"])
        put(f"{case}/mom", st["opt"]["mom"])
        placed = jax.device_put(params, psh)
        ev = jax.jit(make_eval_step(cfg), in_shardings=(psh, bsh), out_shardings=None)
        arrays[f"{case}/eval"] = np.asarray(ev(placed, batch_of(0)))
        pre = jax.jit(make_prefill_step(cfg), in_shardings=(psh, bsh), out_shardings=None)
        arrays[f"{case}/prefill_step"] = np.asarray(pre(placed, batch_of(0)))

        cache = W.init_whisper_cache(cfg, B, MAX_LEN)
        csh = SH.cache_shardings(mesh, cache, cfg, data_axis="data", model_axis="model")
        prime = jax.jit(lambda p, f, c: W.prime_cross_cache(cfg, p, c, W.whisper_encode(cfg, p, f)),
                        in_shardings=(psh, bsh["frames"], csh), out_shardings=csh)
        cache = prime(placed, jnp.asarray(inputs[f"{case}/serve_frames"]),
                      jax.device_put(cache, csh))
        shards(f"{case}/cache/primed", cache)
        serve = {sh: jax.jit(make_serve_step(cfg), in_shardings=(psh, csh, sh, rep),
                             out_shardings=(None, csh)) for sh in (prompt_sh, token_sh)}
        logits, cache = serve[prompt_sh](placed, cache, prompts, jnp.asarray(0, jnp.int32))
        shards(f"{case}/cache/prompt", cache)
        toks = [jnp.argmax(logits, -1)]
        arrays[f"{case}/logits/0"] = np.asarray(logits)
        for t in range(1, NEW):
            logits, cache = serve[token_sh](placed, cache, np.asarray(toks[-1], np.int32)[:, None],
                                            jnp.asarray(P + t - 1, jnp.int32))
            arrays[f"{case}/logits/{t}"] = np.asarray(logits)
            toks.append(jnp.argmax(logits, -1))
        shards(f"{case}/cache/last", cache)
        arrays[f"{case}/tokens"] = np.stack([np.asarray(t) for t in toks], 1)
np.savez(out_npz, **arrays)
"""


def _inputs(rng):
    """Every case's seeded inputs: tokens [STEPS, B, S] and frames
    [STEPS, B, N, D] for the train steps, a prompt [B, P] and the served
    frames [B, N, D]."""
    out = {}
    for case, (fsdp, _, B, S, P, n_frames) in CASES.items():
        cfg = cfg_of(fsdp, n_frames)
        N, D = cfg.encoder_seq, cfg.d_model
        out[f"{case}/tokens"] = rng.integers(3, cfg.vocab_size, (STEPS, B, S)).astype(np.int32)
        out[f"{case}/frames"] = rng.standard_normal((STEPS, B, N, D)).astype(np.float32)
        out[f"{case}/prompts"] = rng.integers(3, cfg.vocab_size, (B, P)).astype(np.int32)
        out[f"{case}/serve_frames"] = rng.standard_normal((B, N, D)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference case (``REF_GROUPS``), on 8 forced CPU devices in
    each of two subprocesses run side by side."""
    d = tmp_path_factory.mktemp("context_parallel_whisper_ref")
    inputs = _inputs(np.random.default_rng(34))
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8", OMP_NUM_THREADS="1")
    procs = []
    for g, jobs in enumerate(REF_GROUPS):
        args = dict(cases={k: [f, list(sh), b, s, p, n] for k, (f, sh, b, s, p, n)
                           in CASES.items()}, jobs=list(jobs), new=NEW, max_len=MAX_LEN,
                    steps=STEPS, lr=LR, inputs=str(d / "in.npz"))
        procs.append(subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, json.dumps(args),
                                       str(d / f"out{g}.npz")], env=env,
                                      stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                      text=True))
    arrays = {}
    for g, proc in enumerate(procs):
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with np.load(d / f"out{g}.npz") as out:
            arrays.update(out)
    return arrays, inputs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(arrays, prefix):
    return tree_from_paths([(k[len(prefix) + 1:], torch.from_numpy(v.copy()))
                            for k, v in sorted(arrays.items()) if k.startswith(prefix + "/")])


def _close(got, want, rtol=RTOL, atol=ATOL):
    g, w = dict(tree_leaves_with_path(got)), dict(tree_leaves_with_path(want))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=rtol, atol=atol, err_msg=k)


def _placed(case, arrays):
    """(cfg, mesh, the reference's initial params placed by the port, their
    shardings)."""
    fsdp, shape, _, _, _, n_frames = CASES[case]
    cfg = cfg_of(fsdp, n_frames)
    mesh = tmesh.make_mesh(shape, ("data", "model"), device="cpu")
    params = _tree(arrays, f"{case}/init")
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    return cfg, mesh, params, psh


def _counts():
    return dict(tmesh.collectives), dict(tmesh.collectives_by_axis)


def _batch(inputs, case, i):
    return {"tokens": inputs[f"{case}/tokens"][i], "frames": inputs[f"{case}/frames"][i]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_the_reference_jit(ref, case):
    """3 SGD steps with momentum on placed state at a batch the batch axis
    does not divide: loss and grad_norm each step, params and momentum
    after the last, against the reference's partitioned jit; the
    collectives of each step the formula's; the second step's batch placed
    by ``batch_shardings`` (the frames whole, the tokens in chunks or
    whole)."""
    arrays, inputs = ref
    cfg, mesh, params, psh = _placed(case, arrays)
    _, _, B, S, _, _ = CASES[case]
    R, M = mesh.shape["data"], mesh.shape["model"]
    opt = make_optimizer("sgd", constant_lr(LR), momentum=0.9)
    state = make_train_state(params, opt)
    sh = {"params": psh, "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)}
    state = tsh.device_put(state, sh)
    step = make_train_step(cfg, opt, grad_shardings=psh)
    want = chip_smoke.partitioned_collectives(cfg, psh, R, M, mesh=mesh, seq=seq_layout(B, S, R))
    for i in range(STEPS):
        batch = _batch(inputs, case, i)
        if i == 1:
            batch = tsh.device_put(batch, tsh.batch_shardings(mesh, batch, data_axis="data"))
            assert batch["frames"].layout.spec == ((), (), ())
        tmesh.reset_collectives()
        state, m = step(state, batch)
        assert tmesh.collectives == want, (i, tmesh.collectives, want)
        np.testing.assert_allclose(float(m["loss"]), arrays[f"{case}/loss/{i}"], rtol=RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), arrays[f"{case}/grad_norm/{i}"],
                                   rtol=RTOL)
    got = tsh.gather(state)
    _close(got["params"], _tree(arrays, f"{case}/params"))
    _close(got["opt"]["mom"], _tree(arrays, f"{case}/mom"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_and_prefill_steps_match_the_reference_jit(ref, case):
    """The eval step (on the kernels' plain versions here) and the prefill
    step on placed params, the batch whole and placed by
    ``batch_shardings``, against the reference's partitioned jit; the
    prefill's collectives the formula's."""
    arrays, inputs = ref
    cfg, mesh, params, psh = _placed(case, arrays)
    _, _, B, S, _, _ = CASES[case]
    R, M = mesh.shape["data"], mesh.shape["model"]
    placed = tsh.device_put(params, psh)
    batch = _batch(inputs, case, 0)
    want = chip_smoke.whisper_collectives(cfg, psh, R, M, "prefill", step=seq_layout(B, S, R))
    for b in (batch, tsh.device_put(batch, tsh.batch_shardings(mesh, batch, data_axis="data"))):
        np.testing.assert_allclose(float(make_eval_step(cfg)(placed, b)), arrays[f"{case}/eval"],
                                   rtol=RTOL, atol=ATOL)
        tmesh.reset_collectives()
        got = make_prefill_step(cfg)(placed, b)
        assert _counts() == want
        np.testing.assert_allclose(got.numpy(), arrays[f"{case}/prefill_step"], rtol=RTOL,
                                   atol=ATOL)


def _close_blocks(cache, arrays, prefix, n):
    for name, x in tree_leaves_with_path(cache):
        assert isinstance(x, Placed), name
        for s in range(n):
            want = arrays[f"{prefix}/{name}/{s}"]
            got = x.block(s).numpy()
            assert got.shape == want.shape, (name, s, got.shape, want.shape)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} slot {s}")


def _primed(cfg, mesh, placed, psh, frames, B):
    """``whisper_encode`` and ``prime_cross_cache`` on placed params into a
    cache placed by ``cache_shardings``, each counted against the formula;
    the encoder states come back split by their positions over ``data``
    where it divides them, else whole."""
    R, M = mesh.shape["data"], mesh.shape["model"]
    cache = TW.init_whisper_cache(cfg, B, MAX_LEN, device="cpu")
    cache = tsh.device_put(cache, tsh.cache_shardings(mesh, cache, cfg, data_axis="data",
                                                      model_axis="model"))
    tmesh.reset_collectives()
    enc = TW.whisper_encode(cfg, placed, frames)
    assert _counts() == chip_smoke.whisper_collectives(cfg, psh, R, M, "encode", step="whole")
    split = ("data",) if cfg.encoder_seq % R == 0 else ()
    assert isinstance(enc, Placed) and enc.layout.spec == ((), split, ())
    tmesh.reset_collectives()
    cache = TW.prime_cross_cache(cfg, placed, cache, enc)
    assert _counts() == chip_smoke.whisper_collectives(cfg, psh, R, M, "prime", step="whole")
    return cache


@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_steps_match_the_reference_jit(ref, case):
    """Encode and prime on placed params into a placed cache, the prompt
    through ``make_serve_step`` at 0 (in chunks over ``data``, or whole),
    then 7 decode steps teacher-forced on the reference's tokens: every
    cache block against the reference's after priming, after the prompt
    and after the last step; the logits of each step; each step's
    collectives the formula's.  The encoder states given whole prime the
    same blocks."""
    arrays, inputs = ref
    cfg, mesh, params, psh = _placed(case, arrays)
    _, _, B, _, P, _ = CASES[case]
    R, M = mesh.shape["data"], mesh.shape["model"]
    placed = tsh.device_put(params, psh)
    n = mesh.devices.size
    frames = torch.from_numpy(inputs[f"{case}/serve_frames"])
    cache = _primed(cfg, mesh, placed, psh, frames, B)
    _close_blocks(cache, arrays, f"{case}/cache/primed", n)
    again = _primed(cfg, mesh, placed, psh, frames, B)
    again = TW.prime_cross_cache(cfg, placed, again, TW.whisper_encode(cfg, params, frames))
    _close_blocks(again, arrays, f"{case}/cache/primed", n)
    step = make_serve_step(cfg)
    toks = arrays[f"{case}/tokens"]
    for t in range(NEW):
        tmesh.reset_collectives()
        if t == 0:
            logits, cache = step(placed, cache, inputs[f"{case}/prompts"], 0)
            _close_blocks(cache, arrays, f"{case}/cache/prompt", n)
            kind = seq_layout(B, P, R)
        else:
            logits, cache = step(placed, cache, toks[:, t - 1:t], P + t - 1)
            kind = "decode"
        assert _counts() == chip_smoke.whisper_collectives(cfg, psh, R, M, "serve", step=kind,
                                                           max_len=MAX_LEN), (t, _counts())
        assert logits.shape == (B, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), arrays[f"{case}/logits/{t}"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {t}")
    _close_blocks(cache, arrays, f"{case}/cache/last", n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_match_the_reference(ref, case):
    """Greedy decoding as a user drives it (encode, prime, the prompt at 0,
    a serve step a token) on placed params: the reference's 8 tokens, and
    the port's whole model's on the same params."""
    arrays, inputs = ref
    cfg, mesh, params, psh = _placed(case, arrays)
    _, _, B, _, P, _ = CASES[case]
    frames = torch.from_numpy(inputs[f"{case}/serve_frames"])
    prompts = torch.from_numpy(inputs[f"{case}/prompts"]).long()

    def generate(p, cache):
        cache = TW.prime_cross_cache(cfg, p, cache, TW.whisper_encode(cfg, p, frames))
        step = make_serve_step(cfg)
        logits, cache = step(p, cache, prompts, 0)
        out = [torch.argmax(logits, -1)]
        for t in range(1, NEW):
            logits, cache = step(p, cache, out[-1][:, None], P + t - 1)
            out.append(torch.argmax(logits, -1))
        return torch.stack(out, 1).numpy()

    placed = tsh.device_put(params, psh)
    whole_cache = TW.init_whisper_cache(cfg, B, MAX_LEN, device="cpu")
    got = generate(placed, tsh.device_put(whole_cache, tsh.cache_shardings(mesh, whole_cache,
                                                                          cfg)))
    np.testing.assert_array_equal(got, arrays[f"{case}/tokens"])
    np.testing.assert_array_equal(generate(params, whole_cache), got)


def test_collective_formulas_at_full_width():
    """The formulas' counts for ``chip_smoke.py``'s phase 25 (whisper-tiny
    at B = 1 on (data 2, model 2): its AdamW train step at 448 tokens in
    chunks and at 447 whole, and each serving forward of one 1,500-frame
    request) as PERF.md §5 writes them, from the full-width specs built on
    the meta device; the cross cache's blocks there (its 1,500 positions
    over ``data``, its 6 KV heads over ``model``), and what 1,501 frames
    (which 2 does not divide) would drop."""
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device="meta")
    cfg = get_config("whisper-tiny")
    with torch.device("meta"):
        params = _meta_params(cfg)
        cache = TW.init_whisper_cache(cfg, 1, 36, device="meta")
    psh = tsh.params_shardings(mesh, params, cfg)
    want_train = {"chunks": {"all_reduce": 157, "all_gather": 25, "reduce_scatter": 24},
                  "whole": {"all_reduce": 157, "all_gather": 16, "reduce_scatter": 16}}
    for seq, counts in want_train.items():
        assert chip_smoke.partitioned_collectives(cfg, psh, 2, 2, mesh=mesh, opt_name="adamw",
                                                  seq=seq) == counts, seq
    odd = dataclasses.replace(cfg, encoder_seq=1501)
    assert chip_smoke.partitioned_collectives(odd, psh, 2, 2, mesh=mesh, opt_name="adamw",
                                              seq="chunks") == {
        "all_reduce": 157, "all_gather": 9, "reduce_scatter": 8}
    base = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}
    want_serve = {("encode", "chunks"): (dict(base, all_reduce=8, all_gather=8),
                                         {"model": 8, "data": 8}),
                  ("prime", "chunks"): (base, {}),
                  ("prefill", "chunks"): (dict(base, all_reduce=20, all_gather=24, broadcast=1),
                                          {"model": 20, "data": 25}),
                  ("serve", "chunks"): (dict(base, all_reduce=12, all_gather=16, broadcast=1),
                                        {"model": 12, "data": 17}),
                  ("serve", "whole"): (dict(base, all_reduce=12, all_gather=4),
                                       {"model": 12, "data": 4}),
                  ("serve", "decode"): (dict(base, all_reduce=12, all_gather=8),
                                        {"model": 12, "data": 8})}
    for (what, step), counts in want_serve.items():
        got = chip_smoke.whisper_collectives(cfg, psh, 2, 2, what, step=step, max_len=36)
        assert got == counts, (what, step, got)
    assert chip_smoke.whisper_collectives(odd, psh, 2, 2, "serve", step="decode",
                                          max_len=36)[0]["all_gather"] == 4
    csh = dict(tree_leaves_with_path(tsh.cache_shardings(mesh, cache, cfg)))
    x = dict(tree_leaves_with_path(cache))["layer0/xk"]
    assert Layout(x.shape, csh["layer0/xk"].spec, mesh).block_shape == (1, 750, 3, 64)


def _meta_params(cfg):
    """A full-width whisper tree of shapes only (the draws replaced by meta
    tensors)."""
    from unittest import mock

    def draw(*args, **kw):
        return torch.empty(args[0] if args else kw["size"], dtype=torch.float32, device="meta")

    with mock.patch.object(torch, "randn", draw):
        return TW.init_whisper(cfg, torch.Generator(), device="meta")


def test_a_prompt_longer_than_one_partials_call_matches_the_whole_model():
    """A 10-token prompt at B = 1 on (data 2, model 2): its gathered rows
    on each slot's 2 query heads a kv head exceed the 8 rows one partials
    call takes, so the cross-attention's partials run in pieces of query
    rows (and head groups), merged in one call; the prompt's and 4 greedy
    tokens' logits within rtol / atol 1e-5 of the port's whole model, the
    tokens equal."""
    cfg = cfg_of(False, None)
    params = TW.init_whisper(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    placed = tsh.device_put(params, tsh.params_shardings(mesh, params, cfg))
    rng = np.random.default_rng(34)
    frames = torch.from_numpy(rng.standard_normal((1, cfg.encoder_seq, cfg.d_model))
                              .astype(np.float32))
    prompt = torch.from_numpy(rng.integers(3, cfg.vocab_size, (1, 10)))

    def run(p, cache):
        cache = TW.prime_cross_cache(cfg, p, cache, TW.whisper_encode(cfg, p, frames))
        step = make_serve_step(cfg)
        lg, cache = step(p, cache, prompt, 0)
        out = [lg]
        for t in range(1, 5):
            lg, cache = step(p, cache, out[-1].argmax(-1)[:, None], 10 + t - 1)
            out.append(lg)
        return torch.stack(out, 1)

    whole = TW.init_whisper_cache(cfg, 1, 16, device="cpu")
    want = run(params, whole)
    got = run(placed, tsh.device_put(whole, tsh.cache_shardings(mesh, whole, cfg)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1).numpy())


def test_head_dim_over_model_at_b1_matches_the_whole_model():
    """B = 1 on (data 2, model 4): the 2 KV heads do not split over
    ``model`` 4, so ``wk``/``wv`` are gathered and the self and cross
    caches split ``head_dim`` over ``model`` (and their positions over
    ``data``); each serve step gathers the cross blocks' ``head_dim`` (and
    a decode step the self cache's) before the partials.  A train step and
    the prompt and 7 greedy tokens against the port's whole model (rtol /
    atol 1e-5, tokens equal), each step's collectives the formulas'."""
    cfg = cfg_of(False, None)
    params = TW.init_whisper(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), device="cpu")
    psh = tsh.params_shardings(mesh, params, cfg)
    rng = np.random.default_rng(34)
    frames = rng.standard_normal((1, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (1, 8)), "frames": frames}
    opt = make_optimizer("sgd", constant_lr(LR), momentum=0.9)
    state = make_train_state(params, opt)
    want_state, wm = make_train_step(cfg, opt)(
        state, {k: torch.as_tensor(v) for k, v in batch.items()})
    placed_state = tsh.device_put(state, {"params": psh, "opt": tsh.opt_state_shardings(
        mesh, state["opt"], psh)})
    tmesh.reset_collectives()
    got_state, gm = make_train_step(cfg, opt)(placed_state, batch)
    assert tmesh.collectives == chip_smoke.partitioned_collectives(cfg, psh, 2, 4, mesh=mesh,
                                                                   seq="chunks")
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]), rtol=RTOL)
    _close(tsh.gather(got_state["params"]), want_state["params"])

    placed = tsh.device_put(params, psh)
    prompt = torch.from_numpy(rng.integers(3, cfg.vocab_size, (1, 4)))
    frames = torch.from_numpy(frames)
    counts = []

    def run(p, cache):
        tmesh.reset_collectives()
        cache = TW.prime_cross_cache(cfg, p, cache, TW.whisper_encode(cfg, p, frames))
        step = make_serve_step(cfg)
        tmesh.reset_collectives()
        lg, cache = step(p, cache, prompt, 0)
        counts.append(_counts())
        out = [lg]
        for t in range(1, NEW):
            tmesh.reset_collectives()
            lg, cache = step(p, cache, out[-1].argmax(-1)[:, None], 4 + t - 1)
            counts.append(_counts())
            out.append(lg)
        return torch.stack(out, 1)

    whole = TW.init_whisper_cache(cfg, 1, MAX_LEN, device="cpu")
    want = run(params, whole)
    csh = tsh.cache_shardings(mesh, whole, cfg)
    assert csh["layer0"]["xk"].spec == (None, "data", None, "model")
    counts.clear()
    got = run(placed, tsh.device_put(whole, csh))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1).numpy())
    steps = ["chunks"] + ["decode"] * (NEW - 1)
    assert counts == [chip_smoke.whisper_collectives(cfg, psh, 2, 4, "serve", step=k,
                                                     max_len=MAX_LEN) for k in steps]
