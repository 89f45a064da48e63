"""The partitioned MoE FFN and M-RoPE (placed params on a replica x model
grid) against the JAX package's partitioned jit, on the CPU.

The reference runs ``jax.jit(make_train_step(cfg, sgd, microbatches=mb,
grad_shardings=psh), in_shardings=(state_sh, batch_sh), out_shardings=
(state_sh, None))`` on a ``("replica", "model")`` mesh, and on a
``("data", "model")`` mesh its prefill step (``in_shardings=(params_sh,
batch_sh)``), the Engine's prefill into a cache (``forward_lm`` at
``cache_index`` 0; for qwen2-vl the vision prefill with ``positions`` and
``extra_embeds``) and its serve step (``in_shardings=(params_sh, cache_sh,
tokens_sh, rep)``), greedily, all with Auto axes in subprocesses on 8
forced CPU devices; the lever case runs in a second subprocess with
``REPRO_OPT_MOE_SHARD=1`` (the port reads the same variable at import; the
test sets the module attribute in process and checks a fresh process
reads it).  GSPMD keeps ``moe_fwd``'s semantics global over the batch
axis: the capacity counts every replica's rows, a pair's place in its
expert's queue follows the global token order, the aux loss takes the
global ``f_e`` and ``p_e``.

Cases (f32, d 128; mixtral cut to 8 query heads of 16 so that a (1, 8)
grid splits its heads, and to ``capacity_factor`` 1.25 so that pairs
drop): mixtral-8x7b with ``fsdp=True`` on (2, 2), 2 experts a slot, 3
SGD steps at microbatches 1 and 2, a prefill and 6 decode steps;
granite-moe-1b-a400m on (1, 4), one expert a slot; mixtral on (1, 8),
where E = 4 does not divide M, its experts whole on every slot without
the lever and split over F with it; qwen2-vl-72b with ``fsdp=True`` on
(2, 2), ``positions`` (a patch grid, then text, offset by row so that the
replicas' positions differ) and ``extra_embeds`` in the train step at
microbatches 1 and 2 and in the cached vision prefill, then decode.

Tolerances (f32), PR 27's and 28's: loss and grad_norm within rtol 1e-5;
params after the first and last step within rtol/atol 1e-5; logits within
rtol/atol 1e-5 after the prefill and each decode step (teacher-forced on
the reference's tokens); greedy tokens equal; the ``aux`` metric within
rtol 1e-5 of the port's whole step.  The collective counts are held
against ``train_collectives`` and ``serve_collectives``, the formulas
PERF.md states (``chip_smoke.py`` holds the same)."""
import dataclasses
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import distributed as D
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.serve.engine import Engine
from repro_torch.train import make_train_state, make_train_step
from repro_torch.train import step as TS
from repro_torch.utils.placed import Placed
from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, S, LR = 3, 4, 16, 0.05
P, NEW = 6, 7                  # a prefill, then 6 decode steps
PATCHES, TEXT = 4, 4           # qwen2-vl's vision prompt: a 2 x 2 patch grid, then text
# case -> (arch, fsdp, grid, the lever REPRO_OPT_MOE_SHARD, train microbatches)
CASES = {"mixtral_fsdp_2x2": ("mixtral-8x7b", True, (2, 2), False, (1, 2)),
         "granite_1x4": ("granite-moe-1b-a400m", False, (1, 4), False, (1,)),
         "mixtral_whole_1x8": ("mixtral-8x7b", False, (1, 8), False, (1,)),
         "mixtral_lever_1x8": ("mixtral-8x7b", False, (1, 8), True, (1,)),
         "qwen_fsdp_2x2": ("qwen2-vl-72b", True, (2, 2), False, (1, 2))}
RTOL = ATOL = 1e-5


def cfg_of(arch, fsdp):
    """The cut both packages run (the reference script runs this source)."""
    cfg = reduce_config(get_config(arch))
    if arch == "mixtral-8x7b":
        cfg = dataclasses.replace(cfg, num_heads=8, head_dim=16,
                                  moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    return dataclasses.replace(cfg, fsdp=fsdp)


def vision_inputs(rng, rows, n_patches, n_text, d):
    """(positions [3, rows, n_patches + n_text], extra_embeds [rows,
    n_patches, d]): the patches on a square grid at t = the row, h, w; the
    text after it on all three streams, from 2 x the row on."""
    side = int(round(n_patches ** 0.5))
    pos = np.zeros((3, rows, n_patches + n_text), np.int32)
    grid = np.arange(n_patches)
    for b in range(rows):
        pos[0, b, :n_patches] = b
        pos[1, b, :n_patches] = grid // side
        pos[2, b, :n_patches] = grid % side
        pos[:, b, n_patches:] = side + 2 * b + np.arange(n_text)
    extra = (0.02 * rng.standard_normal((rows, n_patches, d))).astype(np.float32)
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
from repro.train.step import make_prefill_step, make_serve_step, make_train_state, make_train_step
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
    if f"{case}/positions" in inputs:
        b["positions"] = jnp.asarray(inputs[f"{case}/positions"])
        b["extra_embeds"] = jnp.asarray(inputs[f"{case}/extra"])
    return b

opt = make_optimizer("sgd", constant_lr(args["lr"]), momentum=0.9)
for case, (arch, fsdp, shape, lever, mbs) in args["cases"].items():
    cfg = cfg_of(arch, fsdp)
    params = init_lm(cfg, jax.random.PRNGKey(0))
    put(f"{case}/init", params)
    mesh = jax.make_mesh(tuple(shape), ("replica", "model"), axis_types=(AxisType.Auto,) * 2)
    slot = {d: i for i, d in enumerate(mesh.devices.flat)}
    state = make_train_state(params, opt)
    psh = SH.params_shardings(mesh, params, cfg, data_axis="replica", model_axis="model")
    state_sh = {"params": psh, "opt": SH.opt_state_shardings(mesh, state["opt"], psh)}
    batch_sh = SH.batch_shardings(mesh, batch_of(case, 0), data_axis="replica")
    def shards(n, x):
        if "moe/" in n:
            for sh in x.addressable_shards:
                arrays[f"{case}/shards/{n}/{slot[sh.device]}"] = np.asarray(sh.data)
    tree_map_with_name(shards, jax.device_put(params, psh))
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

    # serving on a (data, model) mesh
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    prompts = jnp.asarray(inputs[f"{case}/prompts"])
    batch = {"tokens": prompts}
    if f"{case}/prompt_positions" in inputs:
        batch["positions"] = jnp.asarray(inputs[f"{case}/prompt_positions"])
        batch["extra_embeds"] = jnp.asarray(inputs[f"{case}/prompt_extra"])
    P = prompts.shape[1]
    cache = init_cache(cfg, prompts.shape[0], P + args["new"])
    psh = SH.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    csh = SH.cache_shardings(mesh, cache, cfg, data_axis="data", model_axis="model")
    bsh = SH.batch_shardings(mesh, batch, data_axis="data")
    rep = SH.replicated(mesh)
    extra_keys = [k for k in ("positions", "extra_embeds") if k in batch]

    def prefill(params, tokens, cache, *extra):
        logits, _, cache = forward_lm(cfg, params, tokens, cache=cache,
                                      cache_index=jnp.asarray(0, jnp.int32),
                                      **dict(zip(extra_keys, extra)))
        return logits[:, -1], cache

    with mesh:
        params_p = jax.device_put(params, psh)
        step = jax.jit(make_prefill_step(cfg), in_shardings=(psh, bsh), out_shardings=None)
        arrays[f"{case}/prefill_step"] = np.asarray(step(params_p, batch))
        pre = jax.jit(prefill, in_shardings=(psh, bsh["tokens"], csh) + tuple(
            bsh[k] for k in extra_keys), out_shardings=(None, csh))
        serve = jax.jit(make_serve_step(cfg), in_shardings=(psh, csh, bsh["tokens"], rep),
                        out_shardings=(None, csh))
        logits, cache = pre(params_p, prompts, jax.device_put(cache, csh),
                            *[batch[k] for k in extra_keys])
        toks = [jnp.argmax(logits, -1)]
        arrays[f"{case}/logits/0"] = np.asarray(logits)
        for t in range(1, args["new"]):
            logits, cache = serve(params_p, cache, toks[-1][:, None].astype(jnp.int32),
                                  jnp.asarray(P + t - 1, jnp.int32))
            arrays[f"{case}/logits/{t}"] = np.asarray(logits)
            toks.append(jnp.argmax(logits, -1))
        arrays[f"{case}/gen"] = np.stack([np.asarray(t) for t in toks], 1)
np.savez(out_npz, **arrays)
"""


def _inputs(rng):
    """Every case's seeded inputs: train tokens [STEPS, B, S], serving
    prompts, and qwen2-vl's positions and extra_embeds for both."""
    out = {}
    for case, (arch, fsdp, *_rest) in CASES.items():
        cfg = cfg_of(arch, fsdp)
        out[f"{case}/tokens"] = rng.integers(3, cfg.vocab_size, (STEPS, B, S)).astype(np.int32)
        if cfg.rope.kind == "mrope":
            out[f"{case}/positions"], out[f"{case}/extra"] = vision_inputs(
                rng, B, PATCHES, S - PATCHES, cfg.d_model)
            out[f"{case}/prompts"] = rng.integers(3, cfg.vocab_size,
                                                  (B, PATCHES + TEXT)).astype(np.int32)
            out[f"{case}/prompt_positions"], out[f"{case}/prompt_extra"] = vision_inputs(
                rng, B, PATCHES, TEXT, cfg.d_model)
        else:
            out[f"{case}/prompts"] = rng.integers(3, cfg.vocab_size, (B, P)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference cases in two subprocesses on 8 forced CPU devices, run
    side by side: the lever's case with ``REPRO_OPT_MOE_SHARD=1``."""
    d = tmp_path_factory.mktemp("partitioned_moe_ref")
    inputs = _inputs(np.random.default_rng(29))
    np.savez(d / "in.npz", **inputs)
    procs = []
    for lever in (False, True):
        cases = {k: [a, f, list(g), lv, list(m)] for k, (a, f, g, lv, m) in CASES.items()
                 if lv == lever}
        args = dict(cases=cases, lr=LR, steps=STEPS, new=NEW, inputs=str(d / "in.npz"))
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   REPRO_OPT_MOE_SHARD="1" if lever else "0")
        procs.append((subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, json.dumps(args),
                                        str(d / f"out{int(lever)}.npz")], env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), d / f"out{int(lever)}.npz"))
    arrays = {}
    for proc, path in procs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with np.load(path) as out:
            arrays.update(out)
    return arrays, inputs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def lever(monkeypatch):
    """Sets the port's ``REPRO_OPT_MOE_SHARD`` for a case (the module
    attribute ``param_spec`` reads, as the variable sets it at import)."""
    def set_for(case):
        monkeypatch.setattr(tsh, "OPT_MOE_SHARD", CASES[case][3])
    return set_for


def _tree(arrays, prefix):
    return tree_from_paths([(k[len(prefix) + 1:], torch.from_numpy(v.copy()))
                            for k, v in sorted(arrays.items()) if k.startswith(prefix + "/")])


def _close(got, want, what):
    g, w = dict(tree_leaves_with_path(got)), dict(tree_leaves_with_path(want))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k].float().numpy(), w[k].float().numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} {k}")


def _sgd():
    return make_optimizer("sgd", constant_lr(LR), momentum=0.9)


def _train_batch(inputs, case, i):
    """Step ``i``'s batch: the tokens, and qwen2-vl's positions and
    extra_embeds."""
    b = {"tokens": inputs[f"{case}/tokens"][i]}
    if f"{case}/positions" in inputs:
        b["positions"], b["extra_embeds"] = inputs[f"{case}/positions"], inputs[f"{case}/extra"]
    return b


def _prompt_batch(inputs, case):
    b = {"tokens": inputs[f"{case}/prompts"]}
    if f"{case}/prompt_positions" in inputs:
        b["positions"] = inputs[f"{case}/prompt_positions"]
        b["extra_embeds"] = inputs[f"{case}/prompt_extra"]
    return b


# -- the collectives ---------------------------------------------------------------------


def _moe_layers(cfg, psh, axis):
    """The MoE layers whose expert stacks a spec splits over ``axis``
    (each stacked layer once)."""
    n_full, _ = TT.split_layers(cfg)
    return sum((n_full if name.startswith("scan/") else 1)
               for name, sh in tree_leaves_with_path(psh)
               if name.endswith("moe/w_gate") and axis in sh.spec)


def train_collectives(cfg, psh, R: int, M: int, microbatches: int):
    """PERF.md §5's formula of a partitioned train step
    (``tests/test_torch_partitioned.py``'s ``expected_collectives``) with
    the MoE layers: per microbatch and MoE layer, over ``model`` where its
    experts (or, with the lever, its F) split, the combine's all-reduce and
    the backward all-reduces of the router's top-k weights and of the
    experts' input; over ``replica`` the aux loss's all-reduce and the
    expert counts' all-gather."""
    hd = cfg.head_dim
    n_attn = sum(b.mixer == "attn" for b in cfg.blocks)
    n_dense = sum(b.ffn in ("glu", "mlp") for b in cfg.blocks)
    n_moe = sum(b.ffn == "moe" for b in cfg.blocks)
    ar = ag = 0
    if M > 1:
        vocab = cfg.vocab_size % M == 0
        attn = (cfg.num_heads * hd) % M == 0
        ar += vocab + 2 * n_attn * attn + 2 * n_dense * (cfg.d_ff % M == 0) + vocab + 3 * vocab
        ar += 3 * _moe_layers(cfg, psh, "model")
        if attn and cfg.num_kv_heads % M:
            if (cfg.num_kv_heads * hd) % M == 0:
                ag += 2 * n_attn
            else:
                ar += 2 * n_attn
    fsdp_uses = per_step_ar = counts = 0
    if R > 1:
        n_full, _ = TT.split_layers(cfg)
        for name, sh in tree_leaves_with_path(psh):
            if "replica" in sh.spec:
                fsdp_uses += n_full if name.startswith("scan/") else 1
            else:
                per_step_ar += 1
        per_step_ar += 1  # the loss metric
        ar += n_moe       # the aux loss's f_e and p_e
        counts = n_moe * (cfg.moe.routing != "dense")  # the expert counts (no backward)
    per_step_ar += 1 if R * M > 1 else 0  # the global norm
    return {"all_reduce": microbatches * ar + per_step_ar,
            "all_gather": microbatches * (ag + counts + fsdp_uses),
            "reduce_scatter": microbatches * (ag + fsdp_uses)}


def serve_collectives(cfg, psh, R: int, M: int, *, cached: bool = True, data_axis="data"):
    """PERF.md §5's formula of one partitioned forward
    (``tests/test_torch_partitioned_serve.py``'s) with the MoE layers: over
    ``model`` an all-reduce of the combine where a layer's experts (or F)
    split, over the batch axis one all-gather of the expert counts a MoE
    layer.  As ``({kind: count}, {axis: count})``."""
    n_attn = sum(b.mixer == "attn" for b in cfg.blocks)
    n_dense = sum(b.ffn in ("glu", "mlp") for b in cfg.blocks)
    n_moe = sum(b.ffn == "moe" for b in cfg.blocks)
    ar = ag_m = ag_d = 0
    if M > 1:
        vocab = cfg.vocab_size % M == 0
        hd, Hkv = cfg.head_dim, cfg.num_kv_heads
        attn = (cfg.num_heads * hd) % M == 0
        ar += vocab + n_attn * attn + n_dense * (cfg.d_ff % M == 0)
        ar += _moe_layers(cfg, psh, "model")
        if attn and Hkv % M and (Hkv * hd) % M == 0:
            ag_m += 2 * n_attn
        if cached and Hkv % M and hd % M == 0:
            ag_m += 2 * n_attn
        ag_m += vocab
    if R > 1:
        n_full, _ = TT.split_layers(cfg)
        for name, sh in tree_leaves_with_path(psh):
            if data_axis in sh.spec:
                ag_d += n_full if name.startswith("scan/") else 1
        ag_d += 1 + n_moe * (cfg.moe.routing != "dense")
    kinds = {"all_reduce": ar, "all_gather": ag_m + ag_d, "reduce_scatter": 0}
    return kinds, {a: n for a, n in (("model", ar + ag_m), (data_axis, ag_d)) if n}


# -- placement ---------------------------------------------------------------------------


EXPERT_SPECS = {  # (w_gate, w_down) body specs by case, the reference's rules
    "mixtral_fsdp_2x2": (("model", "replica", None), ("model", None, "replica")),
    "granite_1x4": (("model", None, None), ("model", None, None)),
    "mixtral_whole_1x8": ((None, None, None), (None, None, None)),
    "mixtral_lever_1x8": ((None, None, "model"), (None, "model", None)),
    "qwen_fsdp_2x2": (None, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_placement_of_the_experts(ref, lever, case):
    """``device_put`` places the expert stacks by the reference's rules,
    with and without ``REPRO_OPT_MOE_SHARD``: every slot's block equals the
    reference's ``addressable_shards``, the specs are the rules'; the bytes
    a slot holds equal ``dryrun.slot_bytes``; M-RoPE positions [3, B, S]
    are placed over axis 1."""
    arrays, inputs = ref
    lever(case)
    arch, fsdp, grid, _, _ = CASES[case]
    cfg = cfg_of(arch, fsdp)
    mesh = tmesh.make_mesh(grid, ("replica", "model"), device="cpu")
    params = _tree(arrays, f"{case}/init")
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="replica", model_axis="model")
    placed = tsh.device_put(params, psh)
    specs = dict(tree_leaves_with_path(psh))
    want = EXPERT_SPECS[case]
    if want[0] is not None:
        assert tuple(specs["scan/pos0/moe/w_gate"].spec[1:]) == want[0]
        assert tuple(specs["scan/pos0/moe/w_up"].spec[1:]) == want[0]
        assert tuple(specs["scan/pos0/moe/w_down"].spec[1:]) == want[1]
        assert specs["scan/pos0/moe/router"].spec[1:] == (("replica" if fsdp else None), None)
    for name, x in tree_leaves_with_path(placed):
        assert isinstance(x, Placed), name
        for s in range(mesh.devices.size):
            key = f"{case}/shards/{name}/{s}"
            if key in arrays:
                np.testing.assert_array_equal(x.block(s).numpy(), arrays[key], err_msg=key)
    assert tsh.placed_slot_bytes(placed, mesh) == [tdry.slot_bytes(params, psh, mesh)] * \
        mesh.devices.size
    if cfg.rope.kind == "mrope":
        batch = _train_batch(inputs, case, 0)
        bsh = tsh.batch_shardings(mesh, batch, data_axis="replica")
        pos = tsh.device_put(batch, bsh)["positions"]
        assert tuple(bsh["positions"].spec) == (None, "replica", None)
        assert pos.layout.spec == ((), ("replica",), ()) and pos.block(3).shape == (3, B // 2, S)
        np.testing.assert_array_equal(pos.block(3).numpy(), batch["positions"][:, B // 2:])


def test_the_lever_is_read_at_import():
    """A fresh process with ``REPRO_OPT_MOE_SHARD=1`` reads the lever at
    import, as the reference's does; without it the lever is off."""
    code = "import repro_torch.launch.sharding as s; print(s.OPT_MOE_SHARD)"
    got = []
    for value in ("1", "0"):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), REPRO_OPT_MOE_SHARD=value)
        got.append(subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                                  text=True, timeout=120).stdout.strip())
    assert got == ["True", "False"]


# -- the train step --------------------------------------------------------------------------


TRAIN_RUNS = [(c, mb) for c in sorted(CASES) for mb in CASES[c][4]]


@pytest.mark.parametrize("case, microbatches", TRAIN_RUNS)
def test_train_step_matches_the_reference_jit(ref, lever, case, microbatches):
    """3 SGD steps on placed state (step 1's batch placed by
    ``batch_shardings``, its positions over axis 1): loss and grad_norm
    against the reference's partitioned jit, params after the first and
    last step, the collectives against ``train_collectives``, and ``aux``
    against the port's whole step on the same state."""
    arrays, inputs = ref
    lever(case)
    arch, fsdp, grid, _, _ = CASES[case]
    cfg, opt = cfg_of(arch, fsdp), _sgd()
    mesh = tmesh.make_mesh(grid, ("replica", "model"), device="cpu")
    init = _tree(arrays, f"{case}/init")
    whole = make_train_state(_tree(arrays, f"{case}/init"), opt)
    state = make_train_state(init, opt)
    psh = tsh.params_shardings(mesh, init, cfg, data_axis="replica", model_axis="model")
    state = tsh.device_put(state, {"params": psh,
                                   "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)})
    step = make_train_step(cfg, opt, microbatches=microbatches, grad_shardings=psh)
    whole_step = make_train_step(cfg, opt, microbatches=microbatches)
    want = train_collectives(cfg, psh, *grid, microbatches)
    pre = f"{case}/mb{microbatches}"
    for i in range(STEPS):
        batch = _train_batch(inputs, case, i)
        whole, wm = whole_step(whole, batch)
        if i == 1:
            batch = tsh.device_put(batch, tsh.batch_shardings(mesh, batch, data_axis="replica"))
        tmesh.reset_collectives()
        state, m = step(state, batch)
        assert tmesh.collectives == want, (i, tmesh.collectives, want)
        np.testing.assert_allclose(float(m["loss"]), arrays[f"{pre}/loss/{i}"], rtol=RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), arrays[f"{pre}/grad_norm/{i}"],
                                   rtol=RTOL)
        np.testing.assert_allclose(float(m["aux"]), float(wm["aux"]), rtol=RTOL)
        assert float(m["aux"]) > 0 or cfg.moe.num_experts == 0
        if i in (0, STEPS - 1):
            _close(tsh.gather(state["params"]), _tree(arrays, f"{pre}/params/{i}"),
                   f"step {i}")


# -- serving -----------------------------------------------------------------------------


def _serve_placed(case, arrays):
    arch, fsdp, grid, _, _ = CASES[case]
    cfg = cfg_of(arch, fsdp)
    mesh = tmesh.make_mesh(grid, ("data", "model"), device="cpu")
    params = _tree(arrays, f"{case}/init")
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    return cfg, mesh, tsh.device_put(params, psh), psh


@pytest.mark.parametrize("case", sorted(CASES))
def test_serving_matches_the_reference_jit(ref, lever, case):
    """The prefill into a placed cache (qwen2-vl's vision prefill with
    ``positions`` and ``extra_embeds``), then 6 decode steps through
    ``make_serve_step`` teacher-forced on the reference's tokens: logits
    against the reference's, the collectives of each step against
    ``serve_collectives``; ``make_prefill_step`` (no cache) against the
    reference's partitioned prefill step; ``Engine.generate`` (text) gives
    the reference's greedy tokens."""
    arrays, inputs = ref
    lever(case)
    cfg, mesh, placed, psh = _serve_placed(case, arrays)
    R, M = mesh.shape["data"], mesh.shape["model"]
    batch = _prompt_batch(inputs, case)
    prompts = batch["tokens"]
    P_ = prompts.shape[1]
    eng = Engine(cfg, placed, max_len=P_ + NEW)
    tokens, cache = eng._start(placed, prompts)
    want_counts = serve_collectives(cfg, psh, R, M)
    gen = arrays[f"{case}/gen"]
    step = TS.make_serve_step(cfg)
    for t in range(NEW):
        tmesh.reset_collectives()
        if t == 0:
            logits = TS._partitioned_last_logits(cfg, placed, tokens, cache, 0,
                                                 positions=batch.get("positions"),
                                                 extra_embeds=batch.get("extra_embeds"))
        else:
            logits, cache = step(placed, cache, gen[:, t - 1:t], P_ + t - 1)
        assert (dict(tmesh.collectives), dict(tmesh.collectives_by_axis)) == want_counts, t
        np.testing.assert_allclose(logits.numpy(), arrays[f"{case}/logits/{t}"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {t}")
        assert np.array_equal(torch.argmax(logits, -1).numpy(), gen[:, t])
    tmesh.reset_collectives()
    got = TS.make_prefill_step(cfg)(placed, tsh.device_put(
        batch, tsh.batch_shardings(mesh, batch, data_axis="data")))
    assert (dict(tmesh.collectives), dict(tmesh.collectives_by_axis)) == serve_collectives(
        cfg, psh, R, M, cached=False)
    np.testing.assert_allclose(got.numpy(), arrays[f"{case}/prefill_step"], rtol=RTOL,
                               atol=ATOL)
    if "positions" not in batch:
        res = eng.generate(prompts, max_new_tokens=NEW)
        np.testing.assert_array_equal(res.tokens[:, P_:], gen)


# -- drops: the global queue -------------------------------------------------------------


def test_mixtral_drops_follow_the_global_queue(ref, monkeypatch):
    """The mixtral case drops pairs, and replica 1's kept/dropped decisions
    depend on replica 0's counts: at least one would differ if it were
    routed without them (its queue starting at 0)."""
    arrays, inputs = ref
    case = "mixtral_fsdp_2x2"
    seen = {"pairs": 0, "dropped": 0, "changed": 0}
    plan = TM.plan

    def recording(cfg, probs, idx, w, *, tokens=None, ahead=None):
        out = plan(cfg, probs, idx, w, tokens=tokens, ahead=ahead)
        seen["pairs"] += out.keep.numel()
        seen["dropped"] += int((~out.keep).sum())
        if ahead is not None and int(ahead.sum()):
            alone = plan(cfg, probs, idx, w, tokens=tokens, ahead=torch.zeros_like(ahead))
            seen["changed"] += int((alone.keep != out.keep).sum())
        return out

    monkeypatch.setattr(TM, "plan", recording)
    arch, fsdp, grid, _, _ = CASES[case]
    cfg = cfg_of(arch, fsdp)
    mesh = tmesh.make_mesh(grid, ("replica", "model"), device="cpu")
    params = _tree(arrays, f"{case}/init")
    opt = _sgd()
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="replica", model_axis="model")
    state = make_train_state(params, opt)
    state = tsh.device_put(state, {"params": psh,
                                   "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)})
    _, m = make_train_step(cfg, opt)(state, _train_batch(inputs, case, 0))
    np.testing.assert_allclose(float(m["loss"]), arrays[f"{case}/mb1/loss/0"], rtol=RTOL)
    assert seen["dropped"] > 0 and seen["changed"] > 0, seen


def test_plan_of_blocks_equals_the_whole_batch():
    """``moe.plan`` of each replica's block with the counts queued ahead of
    it, and ``moe.experts`` on each model slot's experts, sum to
    ``moe_fwd`` of the whole batch in every routing (f64, drops at
    capacity factor 0.5)."""
    for routing in ("gshard", "sort", "dense"):
        base = cfg_of("mixtral-8x7b", False)
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, routing=routing,
                                                                capacity_factor=0.5))
        gen = torch.Generator().manual_seed(1)
        p = TM.init_moe(cfg, gen, torch.float64, "cpu")
        x = torch.randn(36, cfg.d_model, generator=gen, dtype=torch.float64)
        want = TM.moe_fwd(cfg, p, x[None])[0][0]
        E, blocks = cfg.moe.num_experts, x.chunk(3)
        sel = [TM._router(cfg, p, b) for b in blocks]
        counts = [TM.pair_counts(idx, E) for _, idx, _ in sel]
        got = []
        for r, b in enumerate(blocks):
            pl = TM.plan(cfg, *sel[r], tokens=x.shape[0],
                         ahead=sum(counts[:r], torch.zeros(E, dtype=torch.long)))
            got.append(sum(TM.experts(cfg, {k: v[lo:lo + 2] for k, v in p.items()}, b, pl,
                                      lo, lo + 2) for lo in (0, 2)))
        np.testing.assert_allclose(torch.cat(got).numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=routing)


# -- the cold step and the Engine on MoE slabs ------------------------------------------------


def test_cold_step_and_engine_take_moe_slabs():
    """``make_cold_train_step`` on granite-moe slabs placed on a (2, 2, 2)
    ColD mesh (each slab split over its replica x model sub-grid, 2 experts
    a slot) against ``make_train_step`` on each whole slab; then
    ``Engine.generate`` on a placed slab gives the whole slab's tokens."""
    cfg, opt = cfg_of("granite-moe-1b-a400m", False), _sgd()
    params = TT.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    toks = np.random.default_rng(3).integers(3, cfg.vocab_size, (2, B, S))
    mesh = tmesh.make_cold_mesh(contributors=2, replicas=2, model=2, device="cpu")
    state = D.stack_for_contributors(make_train_state(params, opt), 2)
    state_sh, batch_sh = D.cold_shardings(mesh, cfg, state, {"tokens": toks})
    placed = tsh.device_put(state, state_sh)
    assert all(isinstance(x, Placed) for x in placed["params"]["scan"]["pos0"]["moe"]["w_gate"])
    new, m = D.make_cold_train_step(cfg, opt)(placed, {"tokens": toks})
    for c in range(2):
        _, wm = make_train_step(cfg, opt)(make_train_state(params, opt), {"tokens": toks[c]})
        for k in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(float(m[k][c]), float(wm[k]), rtol=RTOL, err_msg=k)
    slab0 = D.slab(new["params"], 0)
    got = Engine(cfg, slab0, max_len=P + NEW).generate(toks[0, :, :P], max_new_tokens=NEW)
    whole = Engine(cfg, tsh.gather(slab0), max_len=P + NEW).generate(toks[0, :, :P],
                                                                     max_new_tokens=NEW)
    np.testing.assert_array_equal(got.tokens, whole.tokens)


# -- the formulas at full width (phase 20 of chip_smoke.py) ------------------------------------


def _meta_params(cfg):
    from unittest import mock

    def draw(*args, **kw):
        return torch.empty(args[0] if args else kw["size"], dtype=torch.float32, device="meta")

    with mock.patch.object(torch, "randn", draw):
        return TT.init_lm(cfg, torch.Generator(), device="meta")


def test_collective_formulas_at_full_width():
    """The counts ``chip_smoke.py``'s phase 20 holds, from the full-width
    specs on the meta device (PERF.md §5): a partitioned forward of
    granite-moe-1b-a400m (24 layers), mixtral-8x7b at 4 layers (FSDP) and
    qwen2-vl-72b at 8 layers (FSDP) on (data 2, model 2), and the train
    steps of granite-moe and of mixtral at 2 layers on (replica 2, model
    2).  The phase serves granite-moe at 8 of its 24 layers; its counts
    scale with the layers."""
    serve = {"granite-moe-1b-a400m": (None, ({"all_reduce": 48, "all_gather": 25,
                                              "reduce_scatter": 0},
                                             {"model": 48, "data": 25})),
             "mixtral-8x7b": (4, ({"all_reduce": 9, "all_gather": 40, "reduce_scatter": 0},
                                  {"model": 10, "data": 39})),
             "qwen2-vl-72b": (8, ({"all_reduce": 17, "all_gather": 60, "reduce_scatter": 0},
                                  {"model": 18, "data": 59}))}
    for axis in ("data", "replica"):
        mesh = tmesh.make_mesh((2, 2), (axis, "model"), device="meta")
        for arch, (layers, want) in serve.items():
            cfg = get_config(arch)
            if layers:
                cfg = dataclasses.replace(cfg, num_layers=layers)
            with torch.device("meta"):
                params = _meta_params(cfg)
            psh = tsh.params_shardings(mesh, params, cfg, data_axis=axis, model_axis="model")
            if axis == "data":
                assert serve_collectives(cfg, psh, 2, 2) == want, arch
            elif arch == "granite-moe-1b-a400m":
                assert train_collectives(cfg, psh, 2, 2, 1) == {
                    "all_reduce": 158, "all_gather": 24, "reduce_scatter": 0}
            elif arch == "mixtral-8x7b":
                cfg = dataclasses.replace(cfg, num_layers=2)
                with torch.device("meta"):
                    params = _meta_params(cfg)
                psh = tsh.params_shardings(mesh, params, cfg, data_axis=axis)
                assert train_collectives(cfg, psh, 2, 2, 1) == {
                    "all_reduce": 22, "all_gather": 20, "reduce_scatter": 18}
