"""The partitioned train step at a batch the batch axis does not divide (the
sequence split over ``data``, with gradients), and M-RoPE ``positions`` /
``extra_embeds`` served at such a batch, against the JAX package's
partitioned jit, on the CPU.

The reference runs ``jax.jit(make_train_step(cfg, sgd-momentum,
microbatches=mb, grad_shardings=psh), in_shardings=(state_sh, batch_sh),
out_shardings=(state_sh, None))`` for 3 steps on ``jax.make_mesh(shape,
("data", "model"))`` with Auto axes, where ``batch_sh`` is
``batch_shardings``' (tokens and mask ``P(None, 'data')``, M-RoPE
positions and ``extra_embeds`` replicated), in two subprocesses side by
side on 8 forced CPU devices.  Cases (d 64, 2 layers, 16 positions unless
stated, f32): gemma3-1b at B = 1 on (2, 2), at 15 positions (the
``"whole"`` layout: every slot the whole sequence) and with a mask that
zeroes a span across the chunk edge; rwkv6-7b with FSDP, B = 1, on (4, 2)
(the state chained over 4 chunks); jamba's reduced config with FSDP
(Mamba, attention and MoE layers), B = 1, on (2, 2); mistral-nemo-12b with
FSDP, B = 3, on (2, 2), microbatches 1 and 3; granite-moe-1b-a400m with
FSDP, B = 1, at 15 positions (the MoE's routing and aux loss where every
slot holds the whole sequence); qwen2-vl-72b with FSDP,
B = 1, with M-RoPE ``positions`` and 10 ``extra_embeds`` (the vision
prefix straddles the edge between the two 8-position chunks).  For
qwen2-vl the reference also serves at B = 1: its prefill step, its vision
prefill into a cache placed by ``cache_shardings`` (``forward_lm`` at
``cache_index`` 0 with ``positions`` and ``extra_embeds``, the 8-position
prompt's 6 embedded positions straddling the chunk edge) and 7 greedy
decode steps, and a text prompt's greedy generation.  The port places the
reference's initial state by its ``device_put`` and runs
``make_train_step``, ``make_eval_step``, ``make_prefill_step``,
``make_serve_step`` and ``Engine.generate`` on it (the reference's eval
step runs under ``in_shardings=(params_sh, batch_sh)`` on the initial
params).

Tolerances (f32), PR 27's: loss and grad_norm within rtol 1e-5; params
within rtol/atol 1e-5 and momentum within rtol 1e-4 / atol 1e-5 after
steps 1 and 3; serving logits within rtol/atol 1e-5; greedy tokens equal;
the MoE ``aux`` metric within rtol 1e-5 of the port's whole step.  The
collectives of each step equal ``chip_smoke.partitioned_collectives``,
the formula PERF.md §5 states."""
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
from repro_torch.models.partitioned import seq_layout
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.serve.engine import Engine
from repro_torch.train import make_eval_step, make_train_state, make_train_step
from repro_torch.train import step as TS
from repro_torch.utils.placed import Placed
from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_path
from test_torch_context_parallel import cp_collectives

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)
STEPS, LR = 3, 0.05
N_TRAIN = 10                       # qwen2-vl's embedded positions in training
P, N_SERVE, NEW = 8, 6, 8          # its vision prompt, embedded positions, new tokens
# case -> (arch, batch, positions, mesh shape, microbatches, masked)
CASES = {"gemma_b1": ("gemma3-1b", 1, 16, (2, 2), (1,), False),
         "gemma_b1_s15": ("gemma3-1b", 1, 15, (2, 2), (1,), False),
         "gemma_b1_mask": ("gemma3-1b", 1, 16, (2, 2), (1,), True),
         "rwkv_b1_4x2": ("rwkv6-7b", 1, 16, (4, 2), (1,), False),
         "jamba_b1": ("jamba-1.5-large-398b", 1, 16, (2, 2), (1,), False),
         "mistral_b3": ("mistral-nemo-12b", 3, 16, (2, 2), (1, 3), False),
         "qwen_b1": ("qwen2-vl-72b", 1, 16, (2, 2), (1,), False),
         "granite_moe_b1_s15": ("granite-moe-1b-a400m", 1, 15, (2, 2), (1,), False)}
# the reference's cases in two processes run side by side, balanced by
# their compile times (jamba's eight layers the longest)
JOBS = (["jamba_b1", "mistral_b3", "gemma_b1", "granite_moe_b1_s15"],
        ["rwkv_b1_4x2", "gemma_b1_mask", "qwen_b1", "gemma_b1_s15"])
RTOL = ATOL = 1e-5
MOM_RTOL = 1e-4


def cfg_of(arch):
    """The cut both packages run (the reference script runs this source)."""
    cfg = reduce_config(get_config(arch), d_model=64)
    if arch == "jamba-1.5-large-398b":  # its reduced depth: Mamba, attention and MoE layers
        return dataclasses.replace(cfg, fsdp=True)
    return dataclasses.replace(cfg, num_layers=2, pattern=cfg.pattern[:2],
                               fsdp=arch != "gemma3-1b")


def vision_inputs(rng, n_embedded, n_text, d):
    """(positions [3, 1, n_embedded + n_text], extra_embeds [1, n_embedded,
    d]): the embedded positions on a grid 3 wide at t = 0, then the text on
    all three streams from 4 on."""
    pos = np.zeros((3, 1, n_embedded + n_text), np.int32)
    grid = np.arange(n_embedded)
    pos[1, 0, :n_embedded], pos[2, 0, :n_embedded] = grid // 3, grid % 3
    pos[:, 0, n_embedded:] = 4 + np.arange(n_text)
    extra = (0.02 * rng.standard_normal((1, n_embedded, d))).astype(np.float32)
    return pos, extra


_REF_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config, reduce_config
from repro.launch import sharding as SH
from repro.models.transformer import forward_lm, init_cache, init_lm
from repro.optim.optimizers import constant_lr, make_optimizer
from repro.train.step import (make_eval_step, make_prefill_step, make_serve_step,
                              make_train_state, make_train_step)
from repro.utils.pytree import tree_map_with_name

args = json.loads(sys.argv[1])
out_npz = sys.argv[2]
inputs = dict(np.load(args["inputs"]))
arrays = {}
""" + inspect.getsource(cfg_of) + r"""

def put(prefix, tree):
    tree_map_with_name(lambda n, x: arrays.__setitem__(f"{prefix}/{n}", np.asarray(x)), tree)

def batch_of(case, i):
    b = {"tokens": jnp.asarray(inputs[f"{case}/tokens"][i])}
    for k in ("mask", "positions", "extra_embeds"):
        if f"{case}/{k}" in inputs:
            b[k] = jnp.asarray(inputs[f"{case}/{k}"])
    return b

def serve(case, cfg, params, mesh):
    # the vision prefill into a placed cache, greedy decode; the prefill
    # step; a text prompt's greedy generation
    prompts = jnp.asarray(inputs[f"{case}/prompt"])
    batch = {"tokens": prompts, "positions": jnp.asarray(inputs[f"{case}/prompt_positions"]),
             "extra_embeds": jnp.asarray(inputs[f"{case}/prompt_extra"])}
    cache = init_cache(cfg, 1, P + NEW)
    psh = SH.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    csh = SH.cache_shardings(mesh, cache, cfg, data_axis="data", model_axis="model")
    bsh = SH.batch_shardings(mesh, batch, data_axis="data")
    dsh = SH.batch_shardings(mesh, {"tokens": prompts[:, :1]}, data_axis="data")
    rep = SH.replicated(mesh)

    def prefill(params, tokens, cache, *extra):
        logits, _, cache = forward_lm(cfg, params, tokens, cache=cache,
                                      cache_index=jnp.asarray(0, jnp.int32),
                                      **dict(zip(("positions", "extra_embeds"), extra)))
        return logits[:, -1], cache

    with mesh:
        params = jax.device_put(params, psh)
        step = jax.jit(make_prefill_step(cfg), in_shardings=(psh, bsh), out_shardings=None)
        arrays[f"{case}/prefill_step"] = np.asarray(step(params, batch))
        pre_v = jax.jit(prefill, in_shardings=(psh, bsh["tokens"], csh, bsh["positions"],
                                               bsh["extra_embeds"]), out_shardings=(None, csh))
        pre_t = jax.jit(prefill, in_shardings=(psh, bsh["tokens"], csh),
                        out_shardings=(None, csh))
        dec = jax.jit(make_serve_step(cfg), in_shardings=(psh, csh, dsh["tokens"], rep),
                      out_shardings=(None, csh))
        for kind in ("vision", "text"):
            c = jax.device_put(init_cache(cfg, 1, P + NEW), csh)
            if kind == "vision":
                logits, c = pre_v(params, prompts, c, batch["positions"], batch["extra_embeds"])
            else:
                logits, c = pre_t(params, jnp.asarray(inputs[f"{case}/text_prompt"]), c)
            toks = [jnp.argmax(logits, -1)]
            arrays[f"{case}/{kind}/logits/0"] = np.asarray(logits)
            for t in range(1, NEW):
                logits, c = dec(params, c, toks[-1][:, None].astype(jnp.int32),
                                jnp.asarray(P + t - 1, jnp.int32))
                arrays[f"{case}/{kind}/logits/{t}"] = np.asarray(logits)
                toks.append(jnp.argmax(logits, -1))
            arrays[f"{case}/{kind}/tokens"] = np.stack([np.asarray(t) for t in toks], 1)

P, NEW = args["prompt"], args["new"]
opt = make_optimizer("sgd", constant_lr(args["lr"]), momentum=0.9)
for case in args["jobs"]:
    arch, B, S, shape, mbs, masked = args["cases"][case]
    cfg = cfg_of(arch)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    params = init_lm(cfg, jax.random.PRNGKey(0))
    put(f"{case}/init", params)
    state = make_train_state(params, opt)
    psh = SH.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    state_sh = {"params": psh, "opt": SH.opt_state_shardings(mesh, state["opt"], psh)}
    batch_sh = SH.batch_shardings(mesh, batch_of(case, 0), data_axis="data")
    arrays[f"{case}/batch_specs"] = np.asarray(json.dumps(
        {k: [None if e is None else str(e) for e in v.spec] for k, v in batch_sh.items()}))
    ev = jax.jit(make_eval_step(cfg), in_shardings=(psh, batch_sh), out_shardings=None)
    arrays[f"{case}/eval"] = np.asarray(ev(jax.device_put(params, psh), batch_of(case, 0)))
    for mb in mbs:
        step = jax.jit(make_train_step(cfg, opt, microbatches=mb, grad_shardings=psh),
                       in_shardings=(state_sh, batch_sh), out_shardings=(state_sh, None))
        st = jax.device_put(state, state_sh)
        for i in range(args["steps"]):
            st, m = step(st, batch_of(case, i))
            arrays[f"{case}/mb{mb}/loss/{i}"] = np.asarray(m["loss"])
            arrays[f"{case}/mb{mb}/grad_norm/{i}"] = np.asarray(m["grad_norm"])
            if i in (0, args["steps"] - 1):
                put(f"{case}/mb{mb}/params/{i}", st["params"])
                put(f"{case}/mb{mb}/mom/{i}", st["opt"]["mom"])
    if f"{case}/prompt" in inputs:
        serve(case, cfg, params, mesh)
np.savez(out_npz, **arrays)
"""


def _inputs(rng):
    """Every case's seeded inputs: tokens [STEPS, B, S], the mask, and
    qwen2-vl's positions and extra_embeds, its prompts and theirs."""
    out = {}
    for case, (arch, B, S, _, _, masked) in CASES.items():
        cfg = cfg_of(arch)
        out[f"{case}/tokens"] = rng.integers(3, cfg.vocab_size, (STEPS, B, S)).astype(np.int32)
        if masked:  # zero a span across the edge of the two chunks
            mask = np.ones((B, S), np.float32)
            mask[:, S // 2 - 3:S // 2 + 2] = 0.0
            out[f"{case}/mask"] = mask
        if cfg.rope.kind == "mrope":
            out[f"{case}/positions"], out[f"{case}/extra_embeds"] = vision_inputs(
                rng, N_TRAIN, S - N_TRAIN, cfg.d_model)
            out[f"{case}/prompt"] = rng.integers(3, cfg.vocab_size, (1, P)).astype(np.int32)
            out[f"{case}/text_prompt"] = rng.integers(3, cfg.vocab_size, (1, P)).astype(np.int32)
            out[f"{case}/prompt_positions"], out[f"{case}/prompt_extra"] = vision_inputs(
                rng, N_SERVE, P - N_SERVE, cfg.d_model)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's cases (``JOBS``) in two subprocesses on 8 forced CPU
    devices, run side by side."""
    d = tmp_path_factory.mktemp("context_parallel_train_ref")
    inputs = _inputs(np.random.default_rng(32))
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8", OMP_NUM_THREADS="1")
    procs = []
    for j, jobs in enumerate(JOBS):
        args = dict(cases={k: [a, b, s, list(g), list(m), mk]
                           for k, (a, b, s, g, m, mk) in CASES.items()},
                    jobs=jobs, lr=LR, steps=STEPS, prompt=P, new=NEW, inputs=str(d / "in.npz"))
        procs.append(subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, json.dumps(args),
                                       str(d / f"out{j}.npz")], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    arrays = {}
    for j, proc in enumerate(procs):
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with np.load(d / f"out{j}.npz") as out:
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


def _close(got, want, rtol, atol, what):
    g, w = dict(tree_leaves_with_path(got)), dict(tree_leaves_with_path(want))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k].float().numpy(), w[k].float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


def _sgd():
    return make_optimizer("sgd", constant_lr(LR), momentum=0.9)


def _batch(inputs, case, i):
    b = {"tokens": inputs[f"{case}/tokens"][i]}
    for k in ("mask", "positions", "extra_embeds"):
        if f"{case}/{k}" in inputs:
            b[k] = inputs[f"{case}/{k}"]
    return b


# -- the train step ----------------------------------------------------------------------


TRAIN_RUNS = [(c, mb) for c in sorted(CASES) for mb in CASES[c][4]]


@pytest.mark.parametrize("case, microbatches", TRAIN_RUNS)
def test_train_step_matches_the_reference_jit(ref, case, microbatches):
    """3 SGD steps with momentum on placed state (step 1's batch placed by
    ``batch_shardings``: the tokens and mask by their sequence over data,
    positions and extra_embeds replicated, as the reference's specs read):
    loss and grad_norm, params and momentum after the first and last step
    against the reference's partitioned jit; the collectives each step
    against ``chip_smoke.partitioned_collectives``; a MoE arch's aux against the port's
    whole step."""
    arrays, inputs = ref
    arch, B, S, grid, _, masked = CASES[case]
    cfg, opt = cfg_of(arch), _sgd()
    mesh = tmesh.make_mesh(grid, ("data", "model"), device="cpu")
    R, M = grid
    layout = seq_layout(B, S, R)
    assert layout == ("whole" if S % R else "chunks")
    init = _tree(arrays, f"{case}/init")
    state = make_train_state(init, opt)
    psh = tsh.params_shardings(mesh, init, cfg, data_axis="data", model_axis="model")
    state = tsh.device_put(state, {"params": psh,
                                   "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)})
    step = make_train_step(cfg, opt, microbatches=microbatches, grad_shardings=psh)
    moe = cfg.moe.num_experts > 0
    if moe:
        whole = make_train_state(_tree(arrays, f"{case}/init"), opt)
        whole_step = make_train_step(cfg, opt, microbatches=microbatches)
    want = chip_smoke.partitioned_collectives(cfg, psh, R, M, microbatches, mesh=mesh,
                                              seq=layout, masked=masked)
    pre = f"{case}/mb{microbatches}"
    specs = json.loads(str(arrays[f"{case}/batch_specs"]))
    for i in range(STEPS):
        batch = _batch(inputs, case, i)
        if moe:
            whole, wm = whole_step(whole, batch)
        if i == 1:
            bsh = tsh.batch_shardings(mesh, batch, data_axis="data")
            for k, sh in bsh.items():
                assert [None if e is None else str(e) for e in sh.spec] == specs[k], k
            batch = tsh.device_put(batch, bsh)
            # a sequence R does not divide is replicated, as the reference places it
            assert isinstance(batch["tokens"], Placed) == (layout == "chunks")
        tmesh.reset_collectives()
        state, m = step(state, batch)
        assert tmesh.collectives == want, (i, tmesh.collectives, want)
        np.testing.assert_allclose(float(m["loss"]), arrays[f"{pre}/loss/{i}"], rtol=RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), arrays[f"{pre}/grad_norm/{i}"],
                                   rtol=RTOL)
        if moe:
            assert float(m["aux"]) > 0
            np.testing.assert_allclose(float(m["aux"]), float(wm["aux"]), rtol=RTOL)
        else:
            assert float(m["aux"]) == 0.0
        if i in (0, STEPS - 1):
            got = tsh.gather(state)
            _close(got["params"], _tree(arrays, f"{pre}/params/{i}"), RTOL, ATOL,
                   f"step {i} params")
            _close(got["opt"]["mom"], _tree(arrays, f"{pre}/mom/{i}"), MOM_RTOL, ATOL,
                   f"step {i} momentum")


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_step_matches_the_reference_jit(ref, case):
    """``make_eval_step`` on placed params (the kernels' plain versions on
    the CPU), the batch whole and placed by ``batch_shardings``: the loss
    of step 0's batch against the reference's partitioned jit."""
    arrays, inputs = ref
    arch, _, _, grid, _, _ = CASES[case]
    cfg = cfg_of(arch)
    mesh = tmesh.make_mesh(grid, ("data", "model"), device="cpu")
    init = _tree(arrays, f"{case}/init")
    placed = tsh.device_put(init, tsh.params_shardings(mesh, init, cfg))
    batch = _batch(inputs, case, 0)
    step = make_eval_step(cfg)
    for b in (batch, tsh.device_put(batch, tsh.batch_shardings(mesh, batch, data_axis="data"))):
        np.testing.assert_allclose(float(step(placed, b)), arrays[f"{case}/eval"], rtol=RTOL)


def test_the_mask_zeroes_pairs_across_the_chunk_edge(ref):
    """The masked case's zeros straddle the edge between the two chunks
    (chunk 0's last target is chunk 1's first token), and its loss differs
    from the unmasked loss of the same tokens."""
    arrays, inputs = ref
    mask = inputs["gemma_b1_mask/mask"]
    S = mask.shape[1]
    assert mask[0, S // 2 - 1] == 0 and mask[0, S // 2] == 0 and mask.sum() < S
    cfg, opt = cfg_of("gemma3-1b"), _sgd()
    state = make_train_state(_tree(arrays, "gemma_b1_mask/init"), opt)
    batch = _batch(inputs, "gemma_b1_mask", 0)
    _, masked = make_train_step(cfg, opt)(state, batch)
    _, plain = make_train_step(cfg, opt)(state, {"tokens": batch["tokens"]})
    np.testing.assert_allclose(float(masked["loss"]), arrays["gemma_b1_mask/mb1/loss/0"],
                               rtol=RTOL)
    assert abs(float(masked["loss"]) - float(plain["loss"])) > 1e-3


# -- M-RoPE positions and extra_embeds served at B = 1 ------------------------------------


def _serve_placed(arrays):
    arch, _, _, grid, _, _ = CASES["qwen_b1"]
    cfg = cfg_of(arch)
    mesh = tmesh.make_mesh(grid, ("data", "model"), device="cpu")
    params = _tree(arrays, "qwen_b1/init")
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    return cfg, mesh, tsh.device_put(params, psh), psh


def test_vision_serving_at_batch_1_matches_the_reference_jit(ref):
    """qwen2-vl at B = 1 on (2, 2): the vision prefill into a placed cache
    with ``positions`` and ``extra_embeds`` (the prompt in two chunks, the
    6 embedded positions straddling their edge), then 7 decode steps
    through ``make_serve_step`` teacher-forced on the reference's tokens:
    logits against the reference's, the collectives of each step against
    ``cp_collectives``; ``make_prefill_step`` (no cache) with the batch
    whole and placed by ``batch_shardings``."""
    arrays, inputs = ref
    cfg, mesh, placed, psh = _serve_placed(arrays)
    R, M = mesh.shape["data"], mesh.shape["model"]
    batch = {"tokens": inputs["qwen_b1/prompt"], "positions": inputs["qwen_b1/prompt_positions"],
             "extra_embeds": inputs["qwen_b1/prompt_extra"]}
    assert seq_layout(1, P, R) == "chunks" and P // R < N_SERVE < P
    eng = Engine(cfg, placed, max_len=P + NEW)
    tokens, cache = eng._start(placed, batch["tokens"])
    assert isinstance(tokens, Placed) and tokens.layout.spec == ((), ("data",))
    gen = arrays["qwen_b1/vision/tokens"]
    step = TS.make_serve_step(cfg)
    for t in range(NEW):
        tmesh.reset_collectives()
        if t == 0:
            logits = TS._partitioned_last_logits(cfg, placed, tokens, cache, 0,
                                                 positions=batch["positions"],
                                                 extra_embeds=batch["extra_embeds"])
            want = cp_collectives(cfg, psh, R, M, step="chunks")
        else:
            logits, cache = step(placed, cache, gen[:, t - 1:t], P + t - 1)
            want = cp_collectives(cfg, psh, R, M, step="decode")
        assert (dict(tmesh.collectives), dict(tmesh.collectives_by_axis)) == want, t
        np.testing.assert_allclose(logits.numpy(), arrays[f"qwen_b1/vision/logits/{t}"],
                                   rtol=RTOL, atol=ATOL, err_msg=f"step {t}")
        assert np.array_equal(torch.argmax(logits, -1).numpy(), gen[:, t])
    prefill = TS.make_prefill_step(cfg)
    for b in (batch, tsh.device_put(batch, tsh.batch_shardings(mesh, batch, data_axis="data"))):
        tmesh.reset_collectives()
        got = prefill(placed, b)
        assert (dict(tmesh.collectives), dict(tmesh.collectives_by_axis)) == cp_collectives(
            cfg, psh, R, M, step="chunks", cached=False)
        np.testing.assert_allclose(got.numpy(), arrays["qwen_b1/prefill_step"], rtol=RTOL,
                                   atol=ATOL)


def test_generate_at_batch_1_matches_the_reference(ref):
    """``Engine.generate`` on placed qwen2-vl params at B = 1 (a text
    prompt, context-parallel over data): the reference's greedy tokens, and
    the port's whole Engine's on the same params."""
    arrays, inputs = ref
    cfg, _, placed, _ = _serve_placed(arrays)
    prompt = inputs["qwen_b1/text_prompt"]
    res = Engine(cfg, placed, max_len=P + NEW).generate(prompt, max_new_tokens=NEW)
    np.testing.assert_array_equal(res.tokens[:, P:], arrays["qwen_b1/text/tokens"])
    whole = Engine(cfg, _tree(arrays, "qwen_b1/init"), max_len=P + NEW)
    np.testing.assert_array_equal(whole.generate(prompt, max_new_tokens=NEW).tokens, res.tokens)


# -- the differentiable send and phase 23's formula ---------------------------------------


def test_axis_send_hands_the_gradient_back():
    """``mesh.axis_send`` on tracked operands (the train step's recurrent
    state): slot ``src + 1`` of each group gets slot ``src``'s operand, the
    backward hands the gradient back to slot ``src`` (zeros elsewhere);
    one counted permute each way, one operand's bytes a group; untracked,
    one permute and a detached copy."""
    mesh = tmesh.make_mesh((3, 2), ("data", "model"), device="cpu")
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(2, 4, generator=gen, dtype=torch.float64).requires_grad_(True)
             for _ in range(6)]
    groups = mesh.groups("data")
    for src in (0, 1):
        tmesh.reset_collectives()
        out = tmesh.axis_send(parts, mesh, "data", src)
        got = [s for s, o in enumerate(out) if o is not None]
        assert got == sorted(g[src + 1] for g in groups)
        for g in groups:
            assert torch.equal(out[g[src + 1]].detach(), parts[g[src]].detach())
        grads = torch.autograd.grad([out[s] for s in got], parts,
                                    [torch.full_like(out[s], float(s + 1)) for s in got],
                                    allow_unused=True)
        for g in groups:
            for s in g:
                if s == g[src]:
                    assert torch.all(grads[s] == g[src + 1] + 1)
                else:
                    assert grads[s] is None
        assert tmesh.collectives["permute"] == 2
        assert tmesh.collective_bytes["permute"] == 2 * len(groups) * 8 * 8
        assert tmesh.collectives_by_axis == {"data": 2}
    tmesh.reset_collectives()
    out = tmesh.axis_send([p.detach() for p in parts], mesh, "data", 0)
    assert not any(o.requires_grad for o in out if o is not None)
    assert tmesh.collectives["permute"] == 1


def test_cp_train_collective_formula_at_full_width():
    """The formula's counts for ``chip_smoke.py``'s phase 23 (B = 1 on
    (data 2, model 2)) as PERF.md §5 writes them: gemma3-1b at 1 x 4,096
    (chunks) and its 6 layers at 1 x 4,095 (every slot the whole
    sequence), granite-moe-1b-a400m at 1 x 2,048, rwkv6-7b at 2 layers and
    jamba at its layer 0 at 1 x 1,024 (FSDP), qwen2-vl-72b at 1 layer.
    The phase trains gemma3-1b at 1 x 2,048, granite-moe at 1 x 1,024 and
    rwkv6-7b and jamba at 1 x 256: in two chunks, the counts do not depend
    on the length."""
    from unittest import mock

    def draw(*args, **kw):
        return torch.empty(args[0] if args else kw["size"], dtype=torch.float32, device="meta")

    want = {("gemma3-1b", None, 4_096): {"all_reduce": 185, "all_gather": 105,
                                         "reduce_scatter": 104},
            ("gemma3-1b", 6, 4_095): {"all_reduce": 87, "all_gather": 12, "reduce_scatter": 12},
            ("granite-moe-1b-a400m", None, 2_048): {"all_reduce": 158, "all_gather": 73,
                                                    "reduce_scatter": 48},
            ("rwkv6-7b", 2, 1_024): {"all_reduce": 38, "all_gather": 19, "reduce_scatter": 18,
                                     "permute": 4},
            ("jamba-1.5-large-398b", 1, 1_024): {"all_reduce": 23, "all_gather": 10,
                                                 "reduce_scatter": 9, "permute": 2},
            ("qwen2-vl-72b", 1, 1_024): {"all_reduce": 14, "all_gather": 12,
                                         "reduce_scatter": 11}}
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device="meta")
    for (arch, layers, S), counts in want.items():
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        with mock.patch.object(torch, "randn", draw), mock.patch.object(torch, "rand", draw):
            params = TT.init_lm(cfg, torch.Generator(), device="meta")
        psh = tsh.params_shardings(mesh, params, cfg)
        assert chip_smoke.partitioned_collectives(cfg, psh, 2, 2, mesh=mesh,
                                                  seq=seq_layout(1, S, 2)) == counts, arch
