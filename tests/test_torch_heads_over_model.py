"""Attention whose query heads the model axis does not divide, against the
JAX package's partitioned jit, on the CPU.

The reference's ``params_shardings`` splits ``wq``'s columns (and ``wo``'s
rows) over ``model`` wherever M divides ``Hq·hd``, whether or not it
divides the heads; GSPMD then runs such an attention replicated on every
model slot.  The port does the same (``models.partitioned._heads``):
``wq``'s column blocks all-gathered over ``model``, every query head on
every slot, each slot's column block of the output through its rows of
``wo`` and one all-reduce.

Cases, one reference subprocess each on 8 forced CPU devices with Auto axes:

* reduced gemma3-1b (d 128, its first 2 layers, 4 query heads of 32 on 1
  KV head, f32) on (data 1, model 8), and with FSDP on (data 2, model 4): 2 SGD
  steps with momentum under ``jax.jit(make_train_step(cfg, sgd,
  grad_shardings=psh), in_shardings=(state_sh, batch_sh))``, the eval
  step, a prefill into a placed cache and 4 greedy serve steps
  (``in_shardings=(params_sh, cache_sh, token_sh, rep)``), every cache
  block checked against the reference's shard on its slot;
* reduced whisper at 6 query heads (``_six_heads``: d 192, 6 heads of 32
  on 6 KV heads) on (data 1, model 4): 2 SGD steps, the eval step, the
  encoder and the cross cache's prime (every primed block checked), the
  prompt through the serve step and 3 greedy serve steps.

At one sequence (B = 1) on (data 2, model 4), the chunked layouts (the
train step's chunks and the whole layout, a chunked prompt against a cache
split over ``data``, whisper's frames and cross cache over ``data``) are
held against the port's own whole model.

Tolerances (``tests/test_torch_batch_axes.py``'s): loss, grad_norm and the
eval loss within rtol 1e-5, params within rtol/atol 1e-5, momentum within
rtol 1e-4 / atol 1e-5; logits within rtol/atol 1e-5 each step, every cache
block within rtol 1e-5 and atol 1e-5 x max(1, the block's largest |value|),
the greedy tokens equal.  Each train step's collectives equal
``chip_smoke.partitioned_collectives(grid=)``, each serving forward's
``chip_smoke.serve_collectives`` / ``whisper_collectives``."""
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
from repro_torch.models import transformer as TT
from repro_torch.models import whisper as TW
from repro_torch.models.partitioned import make_grid
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.serve.engine import Engine
from repro_torch.train.step import (make_eval_step, make_serve_step, make_train_state,
                                    make_train_step)
from repro_torch.utils.placed import Placed
from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

STEPS, LR, NEW, MAX_LEN = 2, 0.05, 4, 16
RTOL = ATOL = 1e-5
MOM_RTOL = 1e-4
# case -> (arch, fsdp, mesh shape (data, model), batch, sequence or prompt)
CASES = {"gemma_m8": ("gemma3-1b", False, (1, 8), 4, 8),
         "gemma_d2m4_fsdp": ("gemma3-1b", True, (2, 4), 4, 8),
         "whisper_m4": ("whisper-tiny", False, (1, 4), 2, 4)}


def cfg_of(arch, fsdp):
    """The cut both packages run (the reference script runs this source):
    gemma3-1b reduced to 2 layers (4 query heads on 1 KV head), whisper-tiny
    reduced at 6 query heads (d 192, head_dim 32)."""
    if arch == "whisper-tiny":
        return dataclasses.replace(reduce_config(get_config(arch), d_model=192),
                                   num_heads=6, num_kv_heads=6, head_dim=32)
    cfg = reduce_config(get_config(arch))
    return dataclasses.replace(cfg, num_layers=2, pattern=cfg.pattern[:2], fsdp=fsdp)


_REF_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config, reduce_config
from repro.launch import sharding as SH
from repro.models import whisper as W
from repro.models.transformer import forward_lm, init_cache, init_lm
from repro.optim.optimizers import constant_lr, make_optimizer
from repro.train.step import make_eval_step, make_serve_step, make_train_state, make_train_step
from repro.utils.pytree import tree_map_with_name

args = json.loads(sys.argv[1])
inputs = dict(np.load(args["inputs"]))
arrays = {}
""" + inspect.getsource(cfg_of) + r"""

def put(prefix, tree):
    tree_map_with_name(lambda n, x: arrays.__setitem__(f"{prefix}/{n}", np.asarray(x)), tree)

def shards(prefix, tree, mesh):
    slot = {d: i for i, d in enumerate(mesh.devices.flat)}
    def one(n, x):
        for sh in x.addressable_shards:
            arrays[f"{prefix}/{n}/{slot[sh.device]}"] = np.asarray(sh.data)
    tree_map_with_name(one, tree)

opt = make_optimizer("sgd", constant_lr(args["lr"]), momentum=0.9)
for case, (arch, fsdp, shape, B, S) in args["cases"].items():
    cfg = cfg_of(arch, fsdp)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    params = (W.init_whisper if cfg.is_encoder_decoder else init_lm)(cfg, jax.random.PRNGKey(0))
    put(f"{case}/init", params)
    psh = SH.params_shardings(mesh, params, cfg)
    state = make_train_state(params, opt)
    state_sh = {"params": psh, "opt": SH.opt_state_shardings(mesh, state["opt"], psh)}

    def batch_of(i):
        b = {"tokens": jnp.asarray(inputs[f"{case}/tokens"][i])}
        if cfg.is_encoder_decoder:
            b["frames"] = jnp.asarray(inputs[f"{case}/frames"][i])
        return b

    bsh = SH.batch_shardings(mesh, batch_of(0))
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

        prompts = jnp.asarray(inputs[f"{case}/prompts"])
        P = prompts.shape[1]
        prompt_sh = SH.batch_shardings(mesh, {"tokens": prompts})["tokens"]
        token_sh = SH.batch_shardings(mesh, {"tokens": prompts[:, :1]})["tokens"]
        rep = SH.replicated(mesh)
        if cfg.is_encoder_decoder:
            cache = W.init_whisper_cache(cfg, B, args["max_len"])
            csh = SH.cache_shardings(mesh, cache, cfg)
            fsh = SH.batch_shardings(mesh, {"frames": inputs[f"{case}/sframes"]})["frames"]
            prime = jax.jit(lambda p, f, c: W.prime_cross_cache(cfg, p, c,
                                                                W.whisper_encode(cfg, p, f)),
                            in_shardings=(psh, fsh, csh), out_shardings=csh)
            cache = prime(placed, jnp.asarray(inputs[f"{case}/sframes"]),
                          jax.device_put(cache, csh))
            shards(f"{case}/cache/primed", cache, mesh)
            pre = jax.jit(make_serve_step(cfg), in_shardings=(psh, csh, prompt_sh, rep),
                          out_shardings=(None, csh))
            logits, cache = pre(placed, cache, prompts, jnp.asarray(0, jnp.int32))
        else:
            cache = init_cache(cfg, B, args["max_len"])
            csh = SH.cache_shardings(mesh, cache, cfg)

            def prefill(params, tokens, cache):
                logits, _, cache = forward_lm(cfg, params, tokens, cache=cache,
                                              cache_index=jnp.asarray(0, jnp.int32))
                return logits[:, -1], cache

            pre = jax.jit(prefill, in_shardings=(psh, prompt_sh, csh), out_shardings=(None, csh))
            logits, cache = pre(placed, prompts, jax.device_put(cache, csh))
        shards(f"{case}/cache/prefill", cache, mesh)
        serve = jax.jit(make_serve_step(cfg), in_shardings=(psh, csh, token_sh, rep),
                        out_shardings=(None, csh))
        toks = [jnp.argmax(logits, -1)]
        arrays[f"{case}/logits/0"] = np.asarray(logits)
        for t in range(1, args["new"]):
            logits, cache = serve(placed, cache, toks[-1][:, None].astype(jnp.int32),
                                  jnp.asarray(P + t - 1, jnp.int32))
            arrays[f"{case}/logits/{t}"] = np.asarray(logits)
            toks.append(jnp.argmax(logits, -1))
        shards(f"{case}/cache/last", cache, mesh)
        arrays[f"{case}/tokens"] = np.stack([np.asarray(t) for t in toks], 1)
np.savez(sys.argv[2], **arrays)
"""


def _inputs(rng):
    out = {}
    for case, (arch, fsdp, _, B, S) in CASES.items():
        cfg = cfg_of(arch, fsdp)
        out[f"{case}/tokens"] = rng.integers(3, cfg.vocab_size, (STEPS, B, S)).astype(np.int32)
        out[f"{case}/prompts"] = rng.integers(3, cfg.vocab_size, (B, 4)).astype(np.int32)
        if cfg.is_encoder_decoder:
            out[f"{case}/frames"] = rng.standard_normal(
                (STEPS, B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
            out[f"{case}/sframes"] = rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference case, one subprocess a case on 8 forced CPU devices,
    started together."""
    d = tmp_path_factory.mktemp("heads_over_model_ref")
    inputs = _inputs(np.random.default_rng(36))
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8", OMP_NUM_THREADS="1")
    procs = {}
    for case, spec in CASES.items():
        args = dict(cases={case: list(spec)}, steps=STEPS, lr=LR, new=NEW, max_len=MAX_LEN,
                    inputs=str(d / "in.npz"))
        procs[case] = subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, json.dumps(args),
                                        str(d / f"{case}.npz")], env=env,
                                       stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                       text=True)
    arrays = {}
    for case, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with np.load(d / f"{case}.npz") as out:
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
        np.testing.assert_allclose(g[k].float().numpy(), w[k].float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def _close_blocks(cache, arrays, prefix, n):
    for name, x in tree_leaves_with_path(cache):
        assert isinstance(x, Placed), name
        for s in range(n):
            want = arrays[f"{prefix}/{name}/{s}"]
            got = x.block(s).float().numpy()
            assert got.shape == want.shape, (name, s, got.shape, want.shape)
            np.testing.assert_allclose(got, want, rtol=RTOL,
                                       atol=ATOL * max(1.0, float(np.abs(want).max())),
                                       err_msg=f"{name} slot {s}")


def _placed(case, arrays):
    arch, fsdp, shape, B, S = CASES[case]
    cfg = cfg_of(arch, fsdp)
    mesh = tmesh.make_mesh(shape, ("data", "model"), device="cpu")
    params = _tree(arrays, f"{case}/init")
    return cfg, make_grid(mesh), params, tsh.params_shardings(mesh, params, cfg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_and_eval_match_the_reference_jit(ref, case):
    """2 SGD steps with momentum on placed state: loss and grad_norm each
    step, params and momentum after the last, against the reference's
    partitioned jit; each step's collectives the formula's (``wq`` gathered
    and reduce-scattered back once an attention); the eval step."""
    arrays, inputs = ref
    cfg, grid, params, psh = _placed(case, arrays)
    opt = make_optimizer("sgd", constant_lr(LR), momentum=0.9)
    state = make_train_state(params, opt)
    state = tsh.device_put(state, {"params": psh, "opt": tsh.opt_state_shardings(
        grid.mesh, state["opt"], psh)})
    step = make_train_step(cfg, opt, grad_shardings=psh)
    want = chip_smoke.partitioned_collectives(cfg, psh, grid.R, grid.M, grid=grid)
    for i in range(STEPS):
        batch = {"tokens": inputs[f"{case}/tokens"][i]}
        if cfg.is_encoder_decoder:
            batch["frames"] = inputs[f"{case}/frames"][i]
        tmesh.reset_collectives()
        state, m = step(state, batch)
        assert tmesh.collectives == want, (i, tmesh.collectives, want)
        np.testing.assert_allclose(float(m["loss"]), arrays[f"{case}/loss/{i}"], rtol=RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), arrays[f"{case}/grad_norm/{i}"],
                                   rtol=RTOL)
    got = tsh.gather(state)
    _close(got["params"], _tree(arrays, f"{case}/params"))
    _close(got["opt"]["mom"], _tree(arrays, f"{case}/mom"), rtol=MOM_RTOL)
    batch = {"tokens": inputs[f"{case}/tokens"][0]}
    if cfg.is_encoder_decoder:
        batch["frames"] = inputs[f"{case}/frames"][0]
    loss = make_eval_step(cfg)(tsh.device_put(params, psh), batch)
    np.testing.assert_allclose(float(loss), arrays[f"{case}/eval"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_serving_matches_the_reference_jit(ref, case):
    """The prompt into a placed cache (whisper: encode and prime first, the
    primed blocks checked), then greedy steps teacher-forced on the
    reference's tokens: logits each step, every cache block after the
    prefill and after the last step, each forward's collectives the
    formula's; then the greedy tokens (``Engine.generate`` for gemma3-1b)
    equal the reference's."""
    arrays, inputs = ref
    cfg, grid, params, psh = _placed(case, arrays)
    mesh, n = grid.mesh, grid.mesh.devices.size
    B = CASES[case][3]
    placed = tsh.device_put(params, psh)
    prompts = inputs[f"{case}/prompts"]
    P = prompts.shape[1]
    if cfg.is_encoder_decoder:
        frames = torch.from_numpy(inputs[f"{case}/sframes"])
        cache = TW.init_whisper_cache(cfg, B, MAX_LEN, device="cpu")
        cache = tsh.device_put(cache, tsh.cache_shardings(mesh, cache, cfg))
        tmesh.reset_collectives()
        enc = TW.whisper_encode(cfg, placed, frames)
        assert dict(tmesh.collectives) == chip_smoke.whisper_collectives(
            cfg, psh, grid.R, grid.M, "encode")[0]
        tmesh.reset_collectives()
        cache = TW.prime_cross_cache(cfg, placed, cache, enc)
        assert dict(tmesh.collectives) == chip_smoke.whisper_collectives(
            cfg, psh, grid.R, grid.M, "prime")[0]
        _close_blocks(cache, arrays, f"{case}/cache/primed", n)
    else:
        cache = TT.init_cache(cfg, B, MAX_LEN, device="cpu")
        cache = tsh.device_put(cache, tsh.cache_shardings(mesh, cache, cfg))
    step = make_serve_step(cfg)
    toks = arrays[f"{case}/tokens"]
    for t in range(NEW):
        tmesh.reset_collectives()
        if t == 0:
            logits, cache = step(placed, cache, prompts, 0)
            _close_blocks(cache, arrays, f"{case}/cache/prefill", n)
        else:
            logits, cache = step(placed, cache, toks[:, t - 1:t], P + t - 1)
        assert (dict(tmesh.collectives), dict(tmesh.collectives_by_axis)) == \
            chip_smoke.serve_collectives(cfg, psh, grid.R, grid.M), t
        np.testing.assert_allclose(logits.numpy(), arrays[f"{case}/logits/{t}"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {t}")
    _close_blocks(cache, arrays, f"{case}/cache/last", n)
    if not cfg.is_encoder_decoder:
        got = Engine(cfg, placed, max_len=MAX_LEN).generate(prompts, max_new_tokens=NEW)
        np.testing.assert_array_equal(got.tokens[:, P:], toks)


@pytest.mark.parametrize("case", ["gemma_chunks", "gemma_whole", "whisper_chunks"])
def test_chunked_layouts_match_the_whole_step(case):
    """One sequence (B = 1) on (data 2, model 4), every query head on every
    model slot: the train step (the sequence in two chunks, or 15
    positions whole on every slot), then the prompt into a placed cache and
    greedy steps (gemma3-1b: the prompt's chunks and the cache's blocks
    over ``data``; whisper: the frames' and the cross cache's positions
    over ``data``), against the port's whole model: loss, grad_norm and
    params within 1e-5, logits within 1e-5 each step."""
    arch = "whisper-tiny" if case.startswith("whisper") else "gemma3-1b"
    cfg = cfg_of(arch, False)
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), device="cpu")
    init = TW.init_whisper if cfg.is_encoder_decoder else TT.init_lm
    params = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(37)
    S = 15 if case.endswith("whole") else 8
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (1, S))}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((1, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    opt = make_optimizer("sgd", constant_lr(LR), momentum=0.9)
    whole, wm = make_train_step(cfg, opt)(make_train_state(params, opt), batch)
    psh = tsh.params_shardings(mesh, params, cfg)
    state = make_train_state(params, opt)
    state = tsh.device_put(state, {"params": psh, "opt": tsh.opt_state_shardings(
        mesh, state["opt"], psh)})
    new, m = make_train_step(cfg, opt, grad_shardings=psh)(state, batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=RTOL)
    _close(tsh.gather(new["params"]), whole["params"])

    placed = tsh.device_put(params, psh)
    prompt = torch.from_numpy(batch["tokens"][:, :8])

    def run(p, on_grid):
        if cfg.is_encoder_decoder:
            cache = TW.init_whisper_cache(cfg, 1, MAX_LEN, device="cpu")
        else:
            cache = TT.init_cache(cfg, 1, MAX_LEN, device="cpu")
        if on_grid:
            cache = tsh.device_put(cache, tsh.cache_shardings(mesh, cache, cfg))
        if cfg.is_encoder_decoder:
            frames = torch.from_numpy(batch["frames"])
            cache = TW.prime_cross_cache(cfg, p, cache, TW.whisper_encode(cfg, p, frames))
        step = make_serve_step(cfg)
        logits, cache = step(p, cache, prompt, 0)
        out = [logits]
        for t in range(3):
            logits, cache = step(p, cache, torch.argmax(out[-1], -1)[:, None], 8 + t)
            out.append(logits)
        return out

    for t, (g, w) in enumerate(zip(run(placed, True), run(params, False))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{t}")
