"""The partitioned steps on the reference's production grids: a batch split
over several mesh axes and the multi-pod mesh's ``pod`` axis, against the
JAX package's partitioned jit, on the CPU.

The grids (the step's ``data_axis`` and ``model_axis``, the keywords of
the reference's sharding functions):

* (a) ("pod", "data", "model") (2, 2, 2), ``data_axis="data"``,
  ``model_axis="model"``: the multi-pod mesh's default; no spec names
  ``pod``, so every leaf is replicated over it;
* (b) ("data", "model") (2, 2), ``data_axis=("data", "model")``,
  ``model_axis=None``: the dry run's ``dp`` strategy;
* (c) ("pod", "data", "model") (2, 2, 2), ``data_axis=("pod", "data",
  "model")``, ``model_axis=None``: ``dp`` on the multi-pod mesh;
* (d) ("pod", "data", "model") (2, 2, 2), ``data_axis=("pod", "data")``,
  ``model_axis="model"``.

The reference runs ``jax.jit(make_train_step(cfg, sgd,
grad_shardings=psh), in_shardings=(state_sh, batch_sh),
out_shardings=(state_sh, None))`` (2 SGD steps with momentum), its eval
step, its Engine's prefill into a cache (``in_shardings=(params_sh,
batch_sh["tokens"], cache_sh)``) and ``make_serve_step`` under
``in_shardings=(params_sh, cache_sh, decode_sh, rep)`` greedily for 4
tokens, all with Auto axes, in ONE subprocess on 8 forced CPU devices.
Cases (d 64, 2 layers, f32; ``TRAIN``, ``SERVE``): gemma3-1b with and
without FSDP, granite-moe-1b-a400m and rwkv6-7b trained at B = 8 (rows
over the batch axes) and at B = 1 (16 positions in chunks over them, or
15: whole on every slot) spread over the four grids so that each grid
meets every arch and both layouts; gemma3-1b and rwkv6-7b served on
(a)-(c) at B = 8 and B = 1 (a prompt of 8 in chunks, of 7 whole) and
granite-moe at B = 4 on (b) (its routing global over four slots);
whisper-tiny (reduced) trained and served on (b) at B = 4 and B = 1.
The port places the reference's initial params by its ``device_put`` and
runs its steps with the same ``data_axis``/``model_axis``.

Tolerances (f32, ``tests/test_torch_partitioned.py``'s): loss, grad_norm
and the eval loss within rtol 1e-5, params within rtol/atol 1e-5,
momentum within rtol 1e-4 / atol 1e-5; placed parameter blocks equal to
the reference's ``addressable_shards`` exactly; serving (those of
``tests/test_torch_context_parallel.py``): logits within rtol/atol 1e-5
each step, every cache block within rtol 1e-5 and atol 1e-5 x max(1, the
block's largest |value|) of the reference's shard on the same slot after
the prefill and after the last step, the greedy tokens equal.  Each step's
collectives equal ``chip_smoke.partitioned_collectives(grid=)`` (train)
or ``chip_smoke.serve_collectives(data_axis=)`` (a decoder's serve steps),
none keyed by an axis the grid replicates; on grid (a) the two pods'
operands of every all-reduce and all-gather are equal bit for bit
(``chip_smoke.pod_twins``).  Jamba and qwen2-vl-72b (M-RoPE ``positions`` and
``extra_embeds``) are held against the port's own whole step."""
import contextlib
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
from repro_torch.models.partitioned import make_grid, seq_layout
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

STEPS, LR, NEW = 2, 0.05, 4
RTOL = ATOL = 1e-5
MOM_RTOL = 1e-4
# grid -> (mesh shape, mesh axes, data_axis, model_axis)
GRIDS = {"a": ((2, 2, 2), ("pod", "data", "model"), "data", "model"),
         "b": ((2, 2), ("data", "model"), ("data", "model"), None),
         "c": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data", "model"), None),
         "d": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"), "model")}
# arch key -> (arch, fsdp)
ARCHS = {"gemma": ("gemma3-1b", False), "gemma_fsdp": ("gemma3-1b", True),
         "granite": ("granite-moe-1b-a400m", False), "rwkv": ("rwkv6-7b", False),
         "whisper": ("whisper-tiny", False)}
# train case -> (arch key, grid, batch, positions)
TRAIN = {f"{a}_{g}_b{B}_s{S}": (a, g, B, S) for a, g, B, S in (
    ("gemma", "a", 8, 16), ("gemma", "b", 8, 16), ("gemma", "d", 1, 15),
    ("gemma_fsdp", "a", 1, 16), ("gemma_fsdp", "c", 8, 16), ("gemma_fsdp", "d", 8, 16),
    ("granite", "a", 8, 16), ("granite", "b", 1, 15), ("granite", "c", 1, 16),
    ("rwkv", "a", 1, 16), ("rwkv", "b", 8, 16), ("rwkv", "c", 8, 16), ("whisper", "b", 4, 8),
    ("whisper", "b", 1, 8))}
# the train cases whose eval step the reference also runs: one a grid
EVAL = ("gemma_d_b1_s15", "gemma_fsdp_a_b1_s16", "granite_b_b1_s15", "rwkv_c_b8_s16")
# serve case -> (arch key, grid, batch, prompt)
SERVE = {f"{a}_{g}_b{B}_p{P}": (a, g, B, P) for a, g, B, P in (
    ("gemma", "a", 8, 8), ("gemma", "a", 1, 7), ("gemma", "b", 1, 8), ("gemma", "b", 8, 8),
    ("gemma", "c", 1, 8), ("rwkv", "a", 1, 8), ("rwkv", "b", 8, 8), ("rwkv", "c", 1, 8),
    ("granite", "b", 4, 8), ("whisper", "b", 4, 4), ("whisper", "b", 1, 4))}
MAX_LEN = 16      # every cache's: its sequence splits over up to 8 slots


def cfg_of(arch, fsdp):
    """The cut both packages run (the reference script runs this source)."""
    if arch == "whisper-tiny":
        return reduce_config(get_config(arch))
    cfg = reduce_config(get_config(arch), d_model=64)
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
out_npz = sys.argv[2]
inputs = dict(np.load(args["inputs"]))
arrays = {}
""" + inspect.getsource(cfg_of) + r"""

def put(prefix, tree):
    tree_map_with_name(lambda n, x: arrays.__setitem__(f"{prefix}/{n}", np.asarray(x)), tree)

def axis(a):
    return tuple(a) if isinstance(a, list) else a

meshes, inits = {}, {}
for g, (shape, names, da, ma) in args["grids"].items():
    meshes[g] = (jax.make_mesh(tuple(shape), tuple(names), axis_types=(AxisType.Auto,) * 3
                               if len(names) == 3 else (AxisType.Auto,) * 2), axis(da), axis(ma))
for key, (arch, fsdp) in args["archs"].items():
    cfg = cfg_of(arch, fsdp)
    inits[key] = (W.init_whisper if cfg.is_encoder_decoder else init_lm)(cfg, jax.random.PRNGKey(0))
    put(f"{key}/init", inits[key])

def shards(prefix, tree, mesh):
    slot = {d: i for i, d in enumerate(mesh.devices.flat)}
    def one(n, x):
        for sh in x.addressable_shards:
            arrays[f"{prefix}/{n}/{slot[sh.device]}"] = np.asarray(sh.data)
    tree_map_with_name(one, tree)

opt = make_optimizer("sgd", constant_lr(args["lr"]), momentum=0.9)
for case, (key, g, B, S) in args["train"].items():
    arch, fsdp = args["archs"][key]
    cfg = cfg_of(arch, fsdp)
    mesh, da, ma = meshes[g]
    params = inits[key]
    state = make_train_state(params, opt)
    psh = SH.params_shardings(mesh, params, cfg, data_axis=da, model_axis=ma)
    state_sh = {"params": psh, "opt": SH.opt_state_shardings(mesh, state["opt"], psh)}

    def batch_of(i):
        b = {"tokens": jnp.asarray(inputs[f"{case}/tokens"][i])}
        if cfg.is_encoder_decoder:
            b["frames"] = jnp.asarray(inputs[f"{case}/frames"][i])
        return b

    bsh = SH.batch_shardings(mesh, batch_of(0), data_axis=da)
    try:
        with mesh:
            step = jax.jit(make_train_step(cfg, opt, grad_shardings=psh),
                           in_shardings=(state_sh, bsh), out_shardings=(state_sh, None))
            st = jax.device_put(state, state_sh)
            if case == args["shards_of"]:
                shards(f"{case}/shards", st["params"], mesh)
            for i in range(args["steps"]):
                st, m = step(st, batch_of(i))
                arrays[f"{case}/loss/{i}"] = np.asarray(m["loss"])
                arrays[f"{case}/grad_norm/{i}"] = np.asarray(m["grad_norm"])
            put(f"{case}/params", st["params"])
            put(f"{case}/mom", st["opt"]["mom"])
            if case in args["eval"]:
                ev = jax.jit(make_eval_step(cfg), in_shardings=(psh, bsh), out_shardings=None)
                arrays[f"{case}/eval"] = np.asarray(ev(jax.device_put(params, psh), batch_of(0)))
    except Exception as e:  # a case the reference's jit does not lower
        arrays[f"{case}/error"] = np.asarray(f"{type(e).__name__}: {e}"[:2000])

for case, (key, g, B, P) in args["serve"].items():
    arch, fsdp = args["archs"][key]
    cfg = cfg_of(arch, fsdp)
    mesh, da, ma = meshes[g]
    params = inits[key]
    prompts = jnp.asarray(inputs[f"{case}/prompts"])
    max_len = args["max_len"]
    psh = SH.params_shardings(mesh, params, cfg, data_axis=da, model_axis=ma)
    prompt_sh = SH.batch_shardings(mesh, {"tokens": prompts}, data_axis=da)["tokens"]
    token_sh = SH.batch_shardings(mesh, {"tokens": prompts[:, :1]}, data_axis=da)["tokens"]
    rep = SH.replicated(mesh)
    try:
        with mesh:
            placed = jax.device_put(params, psh)
            if cfg.is_encoder_decoder:
                cache = W.init_whisper_cache(cfg, B, max_len)
                csh = SH.cache_shardings(mesh, cache, cfg, data_axis=da, model_axis=ma)
                fsh = SH.batch_shardings(mesh, {"frames": inputs[f"{case}/frames"]},
                                         data_axis=da)["frames"]
                prime = jax.jit(lambda p, f, c: W.prime_cross_cache(cfg, p, c,
                                                                    W.whisper_encode(cfg, p, f)),
                                in_shardings=(psh, fsh, csh), out_shardings=csh)
                cache = prime(placed, jnp.asarray(inputs[f"{case}/frames"]),
                              jax.device_put(cache, csh))
                shards(f"{case}/cache/primed", cache, mesh)
                pre = jax.jit(make_serve_step(cfg), in_shardings=(psh, csh, prompt_sh, rep),
                              out_shardings=(None, csh))
                logits, cache = pre(placed, cache, prompts, jnp.asarray(0, jnp.int32))
            else:
                cache = init_cache(cfg, B, max_len)
                csh = SH.cache_shardings(mesh, cache, cfg, data_axis=da, model_axis=ma)

                def prefill(params, tokens, cache):
                    logits, _, cache = forward_lm(cfg, params, tokens, cache=cache,
                                                  cache_index=jnp.asarray(0, jnp.int32))
                    return logits[:, -1], cache

                pre = jax.jit(prefill, in_shardings=(psh, prompt_sh, csh),
                              out_shardings=(None, csh))
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
    except Exception as e:
        arrays[f"{case}/error"] = np.asarray(f"{type(e).__name__}: {e}"[:2000])
np.savez(out_npz, **arrays)
"""
SHARDS_OF = "gemma_fsdp_a_b1_s16"   # the train case whose placed blocks are compared


def _inputs(rng):
    """Every case's seeded inputs: tokens [STEPS, B, S] (and whisper's
    frames [STEPS, B, N, D]) a train case, a prompt [B, P] (and frames
    [B, N, D]) a serve case."""
    out = {}
    for case, (key, _, B, S) in TRAIN.items():
        cfg = cfg_of(*ARCHS[key])
        out[f"{case}/tokens"] = rng.integers(3, cfg.vocab_size, (STEPS, B, S)).astype(np.int32)
        if cfg.is_encoder_decoder:
            out[f"{case}/frames"] = rng.standard_normal(
                (STEPS, B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    for case, (key, _, B, P) in SERVE.items():
        cfg = cfg_of(*ARCHS[key])
        out[f"{case}/prompts"] = rng.integers(3, cfg.vocab_size, (B, P)).astype(np.int32)
        if cfg.is_encoder_decoder:
            out[f"{case}/frames"] = rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference case in one subprocess on 8 forced CPU devices."""
    d = tmp_path_factory.mktemp("batch_axes_ref")
    inputs = _inputs(np.random.default_rng(35))
    np.savez(d / "in.npz", **inputs)
    args = dict(grids={g: [list(sh), list(n), da, ma] for g, (sh, n, da, ma) in GRIDS.items()},
                archs={k: list(v) for k, v in ARCHS.items()},
                train={k: list(v) for k, v in TRAIN.items()},
                serve={k: list(v) for k, v in SERVE.items()}, steps=STEPS, lr=LR, new=NEW,
                max_len=MAX_LEN, shards_of=SHARDS_OF, eval=list(EVAL), inputs=str(d / "in.npz"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, json.dumps(args),
                           str(d / "out.npz")], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(d / "out.npz") as out:
        return dict(out), inputs


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


def _grid(g):
    """(the port's mesh of grid ``g``, its data_axis, its model_axis)."""
    shape, names, da, ma = GRIDS[g]
    return tmesh.make_mesh(shape, names, device="cpu"), da, ma


def _placed(key, g, arrays):
    """(cfg, the grid, the reference's initial params, their shardings)."""
    cfg = cfg_of(*ARCHS[key])
    mesh, da, ma = _grid(g)
    params = _tree(arrays, f"{key}/init")
    psh = tsh.params_shardings(mesh, params, cfg, data_axis=da, model_axis=ma)
    return cfg, make_grid(mesh, da, ma), params, psh


def _no_error(arrays, case):
    assert f"{case}/error" not in arrays, str(arrays[f"{case}/error"])


def _axis_keys(grid):
    """The keys ``collectives_by_axis`` may hold on ``grid``: its batch
    axes (a tuple as the tuple) and its model axis; never ``pod`` where it
    is replicated."""
    return {k for k in (grid.dp, grid.model) if k is not None}


def _pods(g, mesh):
    """On grid (a), ``chip_smoke.pod_twins``: every all-reduce and all-gather
    holds each pod-0 slot's operand bit-equal to its pod-1 twin's."""
    return chip_smoke.pod_twins(mesh) if g == "a" else contextlib.nullcontext()


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_train_step_matches_the_reference_jit(ref, case):
    """2 SGD steps with momentum on placed state with the grid's
    ``data_axis``/``model_axis``: loss and grad_norm each step, params and
    momentum after the last, against the reference's partitioned jit; each
    step's collectives ``chip_smoke.partitioned_collectives``' over the
    grid's axes alone; the eval step where the reference ran it.  On grid
    (a) every operand of the two pods' collectives is equal bit for bit."""
    arrays, inputs = ref
    _no_error(arrays, case)
    key, g, B, S = TRAIN[case]
    cfg, grid, params, psh = _placed(key, g, arrays)
    da, ma = GRIDS[g][2:]
    opt = make_optimizer("sgd", constant_lr(LR), momentum=0.9)
    state = make_train_state(params, opt)
    sh = {"params": psh, "opt": tsh.opt_state_shardings(grid.mesh, state["opt"], psh)}
    state = tsh.device_put(state, sh)
    step = make_train_step(cfg, opt, grad_shardings=psh, data_axis=da, model_axis=ma)
    want = chip_smoke.partitioned_collectives(cfg, psh, grid.R, grid.M, grid=grid,
                                              seq=seq_layout(B, S, grid.R))
    for i in range(STEPS):
        batch = {"tokens": inputs[f"{case}/tokens"][i]}
        if cfg.is_encoder_decoder:
            batch["frames"] = inputs[f"{case}/frames"][i]
        if i == 1:
            batch = tsh.device_put(batch, tsh.batch_shardings(grid.mesh, batch, data_axis=da))
        tmesh.reset_collectives()
        with _pods(g, grid.mesh) as twins:
            state, m = step(state, batch)
        assert twins is None or twins.calls
        assert tmesh.collectives == want, (i, tmesh.collectives, want)
        assert set(tmesh.collectives_by_axis) <= _axis_keys(grid), tmesh.collectives_by_axis
        np.testing.assert_allclose(float(m["loss"]), arrays[f"{case}/loss/{i}"], rtol=RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), arrays[f"{case}/grad_norm/{i}"],
                                   rtol=RTOL)
    got = tsh.gather(state)
    _close(got["params"], _tree(arrays, f"{case}/params"))
    _close(got["opt"]["mom"], _tree(arrays, f"{case}/mom"), rtol=MOM_RTOL)
    if case in EVAL:
        placed = tsh.device_put(params, psh)
        batch = {"tokens": inputs[f"{case}/tokens"][0]}
        loss = make_eval_step(cfg, data_axis=da, model_axis=ma)(placed, batch)
        np.testing.assert_allclose(float(loss), arrays[f"{case}/eval"], rtol=RTOL, atol=ATOL)


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


def _serve_counts(cfg, psh, grid, step):
    """``chip_smoke.serve_collectives`` on the grid: R and M its extents,
    its batch axes' key (a tuple as the tuple)."""
    return chip_smoke.serve_collectives(cfg, psh, grid.R, grid.M, data_axis=grid.dp,
                                        step=step)


@pytest.mark.parametrize("case", sorted(SERVE))
def test_serve_steps_match_the_reference_jit(ref, case):
    """The prompt into a placed cache (whisper: encode and prime first),
    then decode steps teacher-forced on the reference's tokens with the
    grid's ``data_axis``/``model_axis``: the logits each step, every cache
    block against the reference's shard on its slot after the prefill and
    after the last step, each decoder step's collectives the formula's
    over the grid's axes alone; then ``Engine.generate`` (whisper: the
    serve step a token) gives the reference's greedy tokens."""
    arrays, inputs = ref
    _no_error(arrays, case)
    key, g, B, P = SERVE[case]
    cfg, grid, params, psh = _placed(key, g, arrays)
    da, ma = GRIDS[g][2:]
    mesh, n = grid.mesh, grid.mesh.devices.size
    placed = tsh.device_put(params, psh)
    axes = dict(data_axis=da, model_axis=ma)
    max_len = MAX_LEN
    prompts = inputs[f"{case}/prompts"]
    if cfg.is_encoder_decoder:
        frames = torch.from_numpy(inputs[f"{case}/frames"])
        cache = TW.init_whisper_cache(cfg, B, max_len, device="cpu")
        cache = tsh.device_put(cache, tsh.cache_shardings(mesh, cache, cfg, **axes))
        cache = TW.prime_cross_cache(cfg, placed, cache,
                                     TW.whisper_encode(cfg, placed, frames, **axes), **axes)
        _close_blocks(cache, arrays, f"{case}/cache/primed", n)
    else:
        cache = TT.init_cache(cfg, B, max_len, device="cpu")
        cache = tsh.device_put(cache, tsh.cache_shardings(mesh, cache, cfg, **axes))
    step = make_serve_step(cfg, **axes)
    toks = arrays[f"{case}/tokens"]
    for t in range(NEW):
        tmesh.reset_collectives()
        with _pods(g, mesh) as twins:
            if t == 0:
                logits, cache = step(placed, cache, prompts, 0)
                kind = seq_layout(B, P, grid.R)
            else:
                logits, cache = step(placed, cache, toks[:, t - 1:t], P + t - 1)
                kind = None if seq_layout(B, P, grid.R) is None else "decode"
        assert twins is None or twins.calls
        if t == 0:
            _close_blocks(cache, arrays, f"{case}/cache/prefill", n)
        assert set(tmesh.collectives_by_axis) <= _axis_keys(grid), tmesh.collectives_by_axis
        if not cfg.is_encoder_decoder:
            assert (dict(tmesh.collectives), dict(tmesh.collectives_by_axis)) == \
                _serve_counts(cfg, psh, grid, kind), (t, kind)
        np.testing.assert_allclose(logits.numpy(), arrays[f"{case}/logits/{t}"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {t}")
    _close_blocks(cache, arrays, f"{case}/cache/last", n)
    if not cfg.is_encoder_decoder:
        got = Engine(cfg, placed, max_len=max_len, **axes).generate(prompts, max_new_tokens=NEW)
        np.testing.assert_array_equal(got.tokens[:, P:], toks)


# -- the two repaired faults ----------------------------------------------------------------


def test_pod_is_no_contributor_axis_on_the_production_mesh(ref):
    """On ("pod", "data", "model") no spec names ``pod`` (grid (a)): every
    leaf is placed over the whole grid, each of the 8 slots' block equal to
    the reference's ``addressable_shards`` there, the bytes a slot equal to
    ``launch.dryrun.slot_bytes``.  On the ColD multi-pod mesh ``pod`` stays
    a contributor axis (an unstacked leaf on contributor slot 0's
    sub-grid), and on the production mesh a leaf stacked over ``pod``
    alone is still split into its slabs."""
    from repro_torch.launch import dryrun as tdry
    arrays, _ = ref
    _no_error(arrays, SHARDS_OF)
    cfg, grid, params, psh = _placed("gemma_fsdp", "a", arrays)
    placed = tsh.device_put(params, psh)
    for name, x in tree_leaves_with_path(placed):
        assert isinstance(x, Placed) and x.layout.mesh.axis_names == ("pod", "data", "model")
        for s in range(8):
            np.testing.assert_array_equal(x.block(s).numpy(),
                                          arrays[f"{SHARDS_OF}/shards/{name}/{s}"], err_msg=name)
    assert tsh.placed_slot_bytes(placed, grid.mesh) == [tdry.slot_bytes(params, psh,
                                                                        grid.mesh)] * 8
    w = torch.arange(32.0).reshape(2, 4, 4)
    cold = tmesh.make_cold_mesh(contributors=2, replicas=1, model=2, multi_pod=True,
                                device="cpu")
    one = tsh.device_put({"w": w[0]}, {"w": tsh.NamedSharding(cold, tsh.P(None, "model"))})
    assert one["w"].layout.mesh.axis_names == ("replica", "model")
    slabs = tsh.device_put({"w": w}, {"w": tsh.NamedSharding(grid.mesh,
                                                             tsh.P("pod", None, "model"))})
    assert isinstance(slabs["w"], list) and len(slabs["w"]) == 2
    assert slabs["w"][1].layout.mesh.axis_names == ("data", "model")
    assert torch.equal(slabs["w"][1].whole(), w[1])


def test_the_grid_comes_from_the_shardings(ref, monkeypatch):
    """Grid (b) without FSDP, ``data_axis=("data", "model")``: no leaf names
    the batch axes, so only the step's keywords tell the grid.  Each of the
    four slots takes 2 of the 8 rows, in the reference's row-major order
    over (data, model); the batch collectives are keyed by the tuple and
    none by an axis alone; the loss is the reference's."""
    from repro_torch.models import partitioned as PT
    arrays, inputs = ref
    case = "gemma_b_b8_s16"
    cfg, grid, params, psh = _placed("gemma", "b", arrays)
    seen = []
    real = PT.partitioned_loss

    def spy(cfg_, grid_, live, layouts, tokens, *a, **k):
        seen.append([t.clone() for t in tokens])
        return real(cfg_, grid_, live, layouts, tokens, *a, **k)

    monkeypatch.setattr(PT, "partitioned_loss", spy)
    opt = make_optimizer("sgd", constant_lr(LR), momentum=0.9)
    state = make_train_state(params, opt)
    state = tsh.device_put(state, {"params": psh, "opt": tsh.opt_state_shardings(
        grid.mesh, state["opt"], psh)})
    tokens = inputs[f"{case}/tokens"][0]
    tmesh.reset_collectives()
    _, m = make_train_step(cfg, opt, grad_shardings=psh, data_axis=("data", "model"),
                           model_axis=None)(state, {"tokens": tokens})
    assert set(tmesh.collectives_by_axis) == {("data", "model")}
    for s, t in enumerate(seen[0]):
        np.testing.assert_array_equal(t.numpy(), tokens[2 * s:2 * s + 2])
    np.testing.assert_allclose(float(m["loss"]), arrays[f"{case}/loss/0"], rtol=RTOL)


def test_the_grid_refuses_what_its_axes_do_not_name():
    """``make_grid`` reads the axes from the mesh by default (``pod``
    replicated), refuses an axis the mesh lacks or a model axis among the
    batch axes; a step refuses a leaf split over an axis that is neither a
    batch axis nor the model axis."""
    mesh, _, _ = _grid("a")
    g = make_grid(mesh)
    assert (g.batch, g.model, g.replicated, g.R, g.M) == (("data",), "model", ("pod",), 2, 2)
    g = make_grid(mesh, ("pod", "data", "model"), None)
    assert (g.dp, g.replicated, g.R, g.M) == (("pod", "data", "model"), (), 8, 1)
    with pytest.raises(ValueError, match="not an axis"):
        make_grid(mesh, ("replica",))
    with pytest.raises(ValueError, match="model_axis"):
        make_grid(mesh, ("data", "model"), "model")
    cfg = cfg_of("gemma3-1b", True)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    psh = tsh.params_shardings(mesh, params, cfg, data_axis=("pod", "data"), model_axis="model")
    placed = tsh.device_put(params, psh)
    tokens = np.zeros((4, 8), np.int64)
    with pytest.raises(ValueError, match="neither|batch axes"):
        make_eval_step(cfg, data_axis="data")(placed, {"tokens": tokens})


# -- jamba and qwen2-vl against the port's own whole step ---------------------------------


def _whole_and_grid_step(cfg, params, batch, g, opt):
    mesh, da, ma = _grid(g)
    whole, wm = make_train_step(cfg, opt)(make_train_state(params, opt), batch)
    state = make_train_state(params, opt)
    psh = tsh.params_shardings(mesh, params, cfg, data_axis=da, model_axis=ma)
    state = tsh.device_put(state, {"params": psh, "opt": tsh.opt_state_shardings(
        mesh, state["opt"], psh)})
    tmesh.reset_collectives()
    new, m = make_train_step(cfg, opt, grad_shardings=psh, data_axis=da, model_axis=ma)(
        state, batch)
    assert set(tmesh.collectives_by_axis) <= _axis_keys(make_grid(mesh, da, ma))
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(wm["grad_norm"]), rtol=RTOL)
    _close(tsh.gather(new["params"]), whole["params"])
    return psh


@pytest.mark.parametrize("g,B", [("d", 1), ("b", 4)])
def test_jamba_on_the_grids_matches_its_whole_step(g, B):
    """Jamba's reduced config (Mamba, attention, MoE; FSDP) one SGD step on
    grid (d) at B = 1 (the sequence in chunks over ("pod", "data")) and on
    (b) at B = 4, against the port's whole step; then its greedy tokens
    served on the same grid equal the whole model's."""
    cfg = dataclasses.replace(reduce_config(get_config("jamba-1.5-large-398b")), fsdp=True)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(36)
    tokens = rng.integers(3, cfg.vocab_size, (B, 8))
    opt = make_optimizer("sgd", constant_lr(LR), momentum=0.9)
    psh = _whole_and_grid_step(cfg, params, {"tokens": tokens}, g, opt)
    mesh, da, ma = _grid(g)
    placed = tsh.device_put(params, psh)
    want = Engine(cfg, params, max_len=MAX_LEN).generate(tokens, max_new_tokens=NEW).tokens
    got = Engine(cfg, placed, max_len=MAX_LEN, data_axis=da, model_axis=ma).generate(
        tokens, max_new_tokens=NEW).tokens
    np.testing.assert_array_equal(got, want)


def test_qwen2_vl_positions_and_embeds_on_the_grids_match_its_whole_steps():
    """qwen2-vl-72b reduced (FSDP) with M-RoPE ``positions`` and
    ``extra_embeds``: one SGD step on grid (c) at B = 1 (16 positions in
    chunks over all eight slots, the 6 embedded ones straddling the first
    chunk edges) and its prefill step on grid (d), against the port's
    whole steps."""
    from repro_torch.train.step import make_prefill_step
    cfg = cfg_of("qwen2-vl-72b", True)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(37)
    S, N = 16, 6
    pos = np.zeros((3, 1, S), np.int64)
    pos[1, 0, :N], pos[2, 0, :N] = np.arange(N) // 3, np.arange(N) % 3
    pos[:, 0, N:] = 4 + np.arange(S - N)
    batch = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab_size, (1, S))),
             "positions": torch.from_numpy(pos),
             "extra_embeds": torch.from_numpy((0.02 * rng.standard_normal(
                 (1, N, cfg.d_model))).astype(np.float32))}
    opt = make_optimizer("sgd", constant_lr(LR), momentum=0.9)
    _whole_and_grid_step(cfg, params, batch, "c", opt)
    mesh, da, ma = _grid("d")
    psh = tsh.params_shardings(mesh, params, cfg, data_axis=da, model_axis=ma)
    want = make_prefill_step(cfg)(params, batch)
    got = make_prefill_step(cfg, data_axis=da, model_axis=ma)(tsh.device_put(params, psh), batch)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("g", ["c", "d"])
def test_microbatches_over_a_tuple_of_batch_axes_match_the_whole_step(g):
    """Two microbatches of 16 rows on grids (c) and (d) (the batch over
    ("pod", "data", "model"), 2 rows a slot, or ("pod", "data"), 4):
    microbatch ``i`` is the reference's rows ``[8 i, 8 i + 8)`` of the
    global batch, taken from the slots that hold them, so the step equals
    the whole step at two microbatches.  One row a slot does not split in
    two, and is refused."""
    cfg = cfg_of("gemma3-1b", True)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    tokens = np.random.default_rng(38).integers(3, cfg.vocab_size, (16, 8))
    mesh, da, ma = _grid(g)
    opt = make_optimizer("sgd", constant_lr(LR), momentum=0.9)
    whole, wm = make_train_step(cfg, opt, microbatches=2)(make_train_state(params, opt),
                                                          {"tokens": tokens})
    state = make_train_state(params, opt)
    psh = tsh.params_shardings(mesh, params, cfg, data_axis=da, model_axis=ma)
    state = tsh.device_put(state, {"params": psh, "opt": tsh.opt_state_shardings(
        mesh, state["opt"], psh)})
    new, m = make_train_step(cfg, opt, microbatches=2, data_axis=da, model_axis=ma)(
        state, {"tokens": tokens})
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(wm["grad_norm"]), rtol=RTOL)
    _close(tsh.gather(new["params"]), whole["params"])
    if g == "c":
        with pytest.raises(ValueError, match="1 rows do not split into 2"):
            make_train_step(cfg, opt, microbatches=2, data_axis=da, model_axis=ma)(
                state, {"tokens": tokens[:8]})
