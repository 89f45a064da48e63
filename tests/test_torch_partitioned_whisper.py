"""The encoder-decoder (whisper) partitioned on a data x model grid, against
the JAX package's partitioned jit, on the CPU.

The reference runs, in one subprocess on 8 forced CPU devices, on meshes
made as ``jax.make_mesh(shape, ("data", "model"), axis_types=(Auto,
Auto))``: ``jax.jit(make_train_step(cfg, sgd, microbatches=mb,
grad_shardings=psh), in_shardings=(state_sh, batch_sh),
out_shardings=(state_sh, None))`` over ``params_shardings``,
``opt_state_shardings`` and ``batch_shardings`` (the ``frames`` [B, N, D]
over ``data``) for 3 steps; the eval and prefill steps under
``in_shardings=(psh, batch_sh)``; ``prime_cross_cache`` after
``whisper_encode`` with ``out_shardings=cache_sh``; and ``make_serve_step``
under ``in_shardings=(psh, cache_sh, tokens_sh, rep), out_shardings=(None,
cache_sh)``, the prompt at ``cache_index`` 0 and then greedily for 8
tokens.  Cases, reduced whisper-tiny (``reduce_config``: d 128, 4 heads of
32 on 2 KV heads, 2 + 2 layers, 16 frames, vocab 512, f32): (data 2, model
2); (data 4, model 2); (1, 4), where the 2 KV heads do not split over
``model`` (``wk``/``wv`` gathered, the self and cross caches' ``head_dim``
on ``model``); ``fsdp=True`` on (2, 2), also at 2 microbatches.  The port
places the same params by its ``device_put`` and runs the same steps.

Tolerances (f32, those of ``tests/test_torch_partitioned.py`` and
``tests/test_torch_partitioned_serve.py``): loss and grad_norm within rtol 1e-5,
params and momentum within rtol / atol 1e-5 after the last step (SGD with
momentum: no gradient near Adam's eps); the eval loss and the last logits
within rtol / atol 1e-5; every placed cache block (``k``, ``v``, ``xk``,
``xv``) within 1e-5 of its ``addressable_shards`` after priming, after the
prompt and after the last step; the 8 greedy tokens equal.  The collectives
of each step equal ``chip_smoke.partitioned_collectives`` and
``chip_smoke.whisper_collectives``, the formulas PERF.md states."""
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
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train.step import (make_eval_step, make_prefill_step, make_serve_step,
                                    make_train_state, make_train_step)
from repro_torch.utils.placed import Layout, Placed
from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)
STEPS, B, S, LR = 3, 8, 8, 0.05
P, NEW, MAX_LEN = 4, 8, 12
# case -> (fsdp, mesh shape, microbatches of its train steps)
CASES = {"d2m2": (False, (2, 2), (1,)),
         "d4m2": (False, (4, 2), (1,)),
         "d1m4": (False, (1, 4), (1,)),
         "fsdp_d2m2": (True, (2, 2), (1, 2))}
TRAIN_CASES = [(c, mb) for c, (_, _, mbs) in sorted(CASES.items()) for mb in mbs]
RTOL = ATOL = 1e-5


def cfg_of(fsdp):
    """The cut both packages run (the reference script runs this source)."""
    return dataclasses.replace(reduce_config(get_config("whisper-tiny")), fsdp=fsdp)


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
inputs = np.load(args["inputs"])
B, P, NEW, MAX_LEN = (args[k] for k in ("B", "P", "new", "max_len"))
arrays = {}
""" + inspect.getsource(cfg_of) + r"""

def put(prefix, tree):
    tree_map_with_name(lambda n, x: arrays.__setitem__(f"{prefix}/{n}", np.asarray(x)), tree)

opt = make_optimizer("sgd", constant_lr(args["lr"]), momentum=0.9)
for case, (fsdp, shape, mbs) in args["cases"].items():
    cfg = cfg_of(fsdp)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    params = W.init_whisper(cfg, jax.random.PRNGKey(0))
    put(f"{case}/init", params)
    state = make_train_state(params, opt)
    psh = SH.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    state_sh = {"params": psh, "opt": SH.opt_state_shardings(mesh, state["opt"], psh)}
    batch = {"tokens": jnp.asarray(inputs["tokens"][0]), "frames": jnp.asarray(inputs["frames"][0])}
    bsh = SH.batch_shardings(mesh, batch, data_axis="data")
    slot = {d: i for i, d in enumerate(mesh.devices.flat)}

    def shards(prefix, cache):
        def one(n, x):
            for sh in x.addressable_shards:
                arrays[f"{prefix}/{n}/{slot[sh.device]}"] = np.asarray(sh.data)
        tree_map_with_name(one, cache)

    with mesh:
        for mb in mbs:
            step = jax.jit(make_train_step(cfg, opt, microbatches=mb, grad_shardings=psh),
                           in_shardings=(state_sh, bsh), out_shardings=(state_sh, None))
            st = jax.device_put(state, state_sh)
            for i in range(args["steps"]):
                st, m = step(st, {"tokens": jnp.asarray(inputs["tokens"][i]),
                                  "frames": jnp.asarray(inputs["frames"][i])})
                arrays[f"{case}/mb{mb}/loss/{i}"] = np.asarray(m["loss"])
                arrays[f"{case}/mb{mb}/grad_norm/{i}"] = np.asarray(m["grad_norm"])
            put(f"{case}/mb{mb}/params", st["params"])
            put(f"{case}/mb{mb}/mom", st["opt"]["mom"])
        placed = jax.device_put(params, psh)
        ev = jax.jit(make_eval_step(cfg), in_shardings=(psh, bsh), out_shardings=None)
        arrays[f"{case}/eval"] = np.asarray(ev(placed, batch))
        pre = jax.jit(make_prefill_step(cfg), in_shardings=(psh, bsh), out_shardings=None)
        arrays[f"{case}/prefill_step"] = np.asarray(pre(placed, batch))

        cache = W.init_whisper_cache(cfg, B, MAX_LEN)
        csh = SH.cache_shardings(mesh, cache, cfg, data_axis="data", model_axis="model")
        prime = jax.jit(lambda p, f, c: W.prime_cross_cache(cfg, p, c, W.whisper_encode(cfg, p, f)),
                        in_shardings=(psh, bsh["frames"], csh), out_shardings=csh)
        cache = prime(placed, jnp.asarray(inputs["serve_frames"]), jax.device_put(cache, csh))
        shards(f"{case}/cache/primed", cache)
        serve = jax.jit(make_serve_step(cfg), in_shardings=(psh, csh, bsh["tokens"],
                                                           SH.replicated(mesh)),
                        out_shardings=(None, csh))
        logits, cache = serve(placed, cache, jnp.asarray(inputs["prompts"]),
                              jnp.asarray(0, jnp.int32))
        shards(f"{case}/cache/prompt", cache)
        toks = [jnp.argmax(logits, -1)]
        arrays[f"{case}/logits/0"] = np.asarray(logits)
        for t in range(1, NEW):
            logits, cache = serve(placed, cache, np.asarray(toks[-1], np.int32)[:, None],
                                  jnp.asarray(P + t - 1, jnp.int32))
            arrays[f"{case}/logits/{t}"] = np.asarray(logits)
            toks.append(jnp.argmax(logits, -1))
        shards(f"{case}/cache/last", cache)
        arrays[f"{case}/tokens"] = np.stack([np.asarray(t) for t in toks], 1)
np.savez(out_npz, **arrays)
"""


# the reference's cases in two subprocesses side by side (one takes ~50 s)
REF_GROUPS = (("d2m2", "d4m2"), ("d1m4", "fsdp_d2m2"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference case, on 8 forced CPU devices in each of the
    subprocesses of ``REF_GROUPS``, run side by side."""
    d = tmp_path_factory.mktemp("partitioned_whisper_ref")
    cfg = cfg_of(False)
    rng = np.random.default_rng(33)
    inputs = {"tokens": rng.integers(3, cfg.vocab_size, (STEPS, B, S)).astype(np.int32),
              "frames": rng.standard_normal((STEPS, B, cfg.encoder_seq, cfg.d_model))
              .astype(np.float32),
              "prompts": rng.integers(3, cfg.vocab_size, (B, P)).astype(np.int32),
              "serve_frames": rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
              .astype(np.float32)}
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = []
    for g, group in enumerate(REF_GROUPS):
        args = dict(cases={k: [CASES[k][0], list(CASES[k][1]), list(CASES[k][2])]
                           for k in group}, B=B, P=P, new=NEW, max_len=MAX_LEN, steps=STEPS,
                    lr=LR, inputs=str(d / "in.npz"))
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
    fsdp, shape, _ = CASES[case]
    cfg = cfg_of(fsdp)
    mesh = tmesh.make_mesh(shape, ("data", "model"), device="cpu")
    params = _tree(arrays, f"{case}/init")
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    return cfg, mesh, params, psh


def _counts():
    return dict(tmesh.collectives), dict(tmesh.collectives_by_axis)


def _batch(inputs, i):
    return {"tokens": inputs["tokens"][i], "frames": inputs["frames"][i]}


@pytest.mark.parametrize("case, microbatches", TRAIN_CASES)
def test_train_step_matches_the_reference_jit(ref, case, microbatches):
    """3 SGD steps with momentum on placed state: loss and grad_norm each
    step, params and momentum after the last, against the reference's
    partitioned jit; the collectives of each step the formula's; the
    second step's batch placed by ``batch_shardings`` (frames included)."""
    arrays, inputs = ref
    cfg, mesh, params, psh = _placed(case, arrays)
    opt = make_optimizer("sgd", constant_lr(LR), momentum=0.9)
    state = make_train_state(params, opt)
    sh = {"params": psh, "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)}
    state = tsh.device_put(state, sh)
    step = make_train_step(cfg, opt, microbatches=microbatches, grad_shardings=psh)
    want = chip_smoke.partitioned_collectives(cfg, psh, mesh.shape["data"], mesh.shape["model"],
                                              microbatches, mesh=mesh)
    pre = f"{case}/mb{microbatches}"
    for i in range(STEPS):
        batch = _batch(inputs, i)
        if i == 1:
            batch = tsh.device_put(batch, tsh.batch_shardings(mesh, batch, data_axis="data"))
            assert isinstance(batch["frames"], Placed)
        tmesh.reset_collectives()
        state, m = step(state, batch)
        assert tmesh.collectives == want, (i, tmesh.collectives)
        np.testing.assert_allclose(float(m["loss"]), arrays[f"{pre}/loss/{i}"], rtol=RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), arrays[f"{pre}/grad_norm/{i}"],
                                   rtol=RTOL)
    got = tsh.gather(state)
    _close(got["params"], _tree(arrays, f"{pre}/params"))
    _close(got["opt"]["mom"], _tree(arrays, f"{pre}/mom"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_and_prefill_steps_match_the_reference_jit(ref, case):
    """The eval step (on the kernels' plain versions here) and the prefill
    step on placed params, the batch whole and placed by
    ``batch_shardings``, against the reference's partitioned jit; the
    prefill's collectives the formula's."""
    arrays, inputs = ref
    cfg, mesh, params, psh = _placed(case, arrays)
    placed = tsh.device_put(params, psh)
    batch = _batch(inputs, 0)
    want = chip_smoke.whisper_collectives(cfg, psh, mesh.shape["data"], mesh.shape["model"],
                                          "prefill")
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


def _primed(cfg, mesh, placed, psh, frames):
    """``whisper_encode`` and ``prime_cross_cache`` on placed params into a
    cache placed by ``cache_shardings``, each counted against the formula."""
    R, M = mesh.shape["data"], mesh.shape["model"]
    cache = TW.init_whisper_cache(cfg, B, MAX_LEN, device="cpu")
    cache = tsh.device_put(cache, tsh.cache_shardings(mesh, cache, cfg, data_axis="data",
                                                      model_axis="model"))
    tmesh.reset_collectives()
    enc = TW.whisper_encode(cfg, placed, frames)
    assert _counts() == chip_smoke.whisper_collectives(cfg, psh, R, M, "encode")
    assert isinstance(enc, Placed) and enc.layout.spec == (("data",), (), ())
    tmesh.reset_collectives()
    cache = TW.prime_cross_cache(cfg, placed, cache, enc)
    assert _counts() == chip_smoke.whisper_collectives(cfg, psh, R, M, "prime")
    return cache


@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_steps_match_the_reference_jit(ref, case):
    """Encode and prime on placed params into a placed cache, the prompt
    through ``make_serve_step`` at 0, then 7 decode steps teacher-forced
    on the reference's tokens: every cache block against the reference's
    after priming, after the prompt and after the last step; the logits of
    each step; each step's collectives the formula's.  The encoder states
    given whole prime the same blocks."""
    arrays, inputs = ref
    cfg, mesh, params, psh = _placed(case, arrays)
    placed = tsh.device_put(params, psh)
    n = mesh.devices.size
    frames = torch.from_numpy(inputs["serve_frames"])
    cache = _primed(cfg, mesh, placed, psh, frames)
    _close_blocks(cache, arrays, f"{case}/cache/primed", n)
    again = _primed(cfg, mesh, placed, psh, frames)
    again = TW.prime_cross_cache(cfg, placed, again, TW.whisper_encode(cfg, params, frames))
    _close_blocks(again, arrays, f"{case}/cache/primed", n)
    step = make_serve_step(cfg)
    want = chip_smoke.whisper_collectives(cfg, psh, mesh.shape["data"], mesh.shape["model"],
                                          "serve")
    toks = arrays[f"{case}/tokens"]
    for t in range(NEW):
        tmesh.reset_collectives()
        if t == 0:
            logits, cache = step(placed, cache, inputs["prompts"], 0)
            _close_blocks(cache, arrays, f"{case}/cache/prompt", n)
        else:
            logits, cache = step(placed, cache, toks[:, t - 1:t], P + t - 1)
        assert _counts() == want, (t, _counts())
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
    frames = torch.from_numpy(inputs["serve_frames"])
    prompts = torch.from_numpy(inputs["prompts"]).long()

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
    """The formulas' counts for ``chip_smoke.py``'s phase 24 (whisper-tiny
    on (data 2, model 2): its train step whole over ``data`` and with FSDP,
    and each serving forward) as PERF.md §5 writes them, from the
    full-width specs built on the meta device; the cross cache's blocks
    there (its 6 KV heads split over ``model``)."""
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device="meta")
    want_train = {False: {"all_reduce": 157, "all_gather": 0, "reduce_scatter": 0},
                  True: {"all_reduce": 92, "all_gather": 65, "reduce_scatter": 65}}
    want_serve = {"encode": ({"all_reduce": 8, "all_gather": 0, "reduce_scatter": 0},
                             {"model": 8}),
                  "prime": ({"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}, {}),
                  "prefill": ({"all_reduce": 20, "all_gather": 1, "reduce_scatter": 0},
                              {"model": 20, "data": 1}),
                  "serve": ({"all_reduce": 12, "all_gather": 1, "reduce_scatter": 0},
                            {"model": 12, "data": 1})}
    for fsdp in (False, True):
        cfg = dataclasses.replace(get_config("whisper-tiny"), fsdp=fsdp)
        with torch.device("meta"):
            params = _meta_params(cfg)
            cache = TW.init_whisper_cache(cfg, 4, 36, device="meta")
        psh = tsh.params_shardings(mesh, params, cfg)
        assert chip_smoke.partitioned_collectives(cfg, psh, 2, 2, mesh=mesh,
                                                  opt_name="adamw") == want_train[fsdp], fsdp
        if not fsdp:
            for what, counts in want_serve.items():
                assert chip_smoke.whisper_collectives(cfg, psh, 2, 2, what) == counts, what
            csh = dict(tree_leaves_with_path(tsh.cache_shardings(mesh, cache, cfg)))
            x = dict(tree_leaves_with_path(cache))["layer0/xk"]
            assert Layout(x.shape, csh["layer0/xk"].spec, mesh).block_shape == (2, 1500, 3, 64)


def _meta_params(cfg):
    """A full-width whisper tree of shapes only (the draws replaced by meta
    tensors)."""
    from unittest import mock

    def draw(*args, **kw):
        return torch.empty(args[0] if args else kw["size"], dtype=torch.float32, device="meta")

    with mock.patch.object(torch, "randn", draw):
        return TW.init_whisper(cfg, torch.Generator(), device="meta")


# -- query heads that model does not divide, and what stays refused ---------------------------


def _six_heads():
    """Reduced whisper at 6 query heads (d 192, 6 heads of 32 on 6 KV
    heads): ``model`` 4 splits the columns of ``wq`` but not the heads."""
    return dataclasses.replace(reduce_config(get_config("whisper-tiny"), d_model=192),
                               num_heads=6, num_kv_heads=6, head_dim=32)


@pytest.mark.parametrize("entry", ["train", "eval", "encode"])
def test_heads_that_model_does_not_divide_match_the_whole_step(entry):
    """6 query heads on ``model`` 4 run replicated on every model slot
    (``models.partitioned._heads``: ``wq`` gathered over ``model``), in the
    train step, the eval step and the encoder, and equal the port's whole
    step (loss, grad_norm and params of one SGD step, the eval loss, the
    encoder states) within 1e-5; the reference's partitioned jit is
    ``tests/test_torch_heads_over_model.py``'s."""
    cfg = _six_heads()
    mesh = tmesh.make_mesh((1, 4), ("data", "model"), device="cpu")
    params = TW.init_whisper(cfg, torch.Generator().manual_seed(0), device="cpu")
    psh = tsh.params_shardings(mesh, params, cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (2, 6)),
             "frames": rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    if entry == "train":
        opt = make_optimizer("sgd", constant_lr(LR))
        whole, wm = make_train_step(cfg, opt)(make_train_state(params, opt), batch)
        state = make_train_state(params, opt)
        state = tsh.device_put(state, {"params": psh, "opt": tsh.opt_state_shardings(
            mesh, state["opt"], psh)})
        new, m = make_train_step(cfg, opt)(state, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=RTOL)
        _close(tsh.gather(new["params"]), whole["params"])
    elif entry == "eval":
        got = make_eval_step(cfg)(tsh.device_put(params, psh), batch)
        np.testing.assert_allclose(float(got), float(make_eval_step(cfg)(params, batch)),
                                   rtol=RTOL, atol=ATOL)
    else:
        frames = torch.from_numpy(batch["frames"])
        got = TW.whisper_encode(cfg, tsh.device_put(params, psh), frames)
        got = got.whole() if isinstance(got, Placed) else got
        np.testing.assert_allclose(got.numpy(), TW.whisper_encode(cfg, params, frames).numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_frames_on_a_decoder_are_refused_by_the_eval_step():
    """A decoder's partitioned eval step refuses the encoder-decoder's
    ``frames``, as its train and prefill steps do."""
    cfg = reduce_config(get_config("gemma3-1b"))
    from repro_torch.models.transformer import init_lm
    params = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    placed = tsh.device_put(params, tsh.params_shardings(mesh, params, cfg))
    batch = {"tokens": np.random.default_rng(0).integers(3, cfg.vocab_size, (4, 6)),
             "frames": np.zeros((4, 8, cfg.d_model), np.float32)}
    with pytest.raises(NotImplementedError, match=r"batch input 'frames'"):
        make_eval_step(cfg)(placed, batch)
