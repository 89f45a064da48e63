"""The partitioned Mamba mixer (jamba), the RWKV block in the train step
and adafactor over placed leaves, against the JAX package's partitioned
jit, on the CPU.

The reference runs ``jax.jit(make_train_step(cfg, opt, microbatches=mb,
grad_shardings=psh), in_shardings=(state_sh, batch_sh), out_shardings=
(state_sh, None))`` on a ``("replica", "model")`` mesh, and on a
``("data", "model")`` mesh its prefill step, the Engine's prefill into a
cache (``forward_lm`` at ``cache_index`` 0) and its serve step, greedily,
all with Auto axes, in four subprocesses on 8 forced CPU devices run side
by side.

Cases (f32, d 128): reduced jamba-1.5-large-398b (its 8 layers: Mamba at
0-3 and 5-7, attention at 4, MoE at the odd ones; d_inner 256) with FSDP
on (2, 2), 3 adafactor steps at microbatches 1 and 2, and served on (2, 2)
and (1, 4): placement, a prefill and 6 decode steps, the cache's blocks;
reduced rwkv6-7b with FSDP on (2, 2), 3 SGD steps (momentum 0.9); reduced
gemma3-1b with FSDP on (2, 4), 3 adafactor steps (its embedding and
projections split on both dims).

Tolerances (f32), PR 27's to 29's: loss and grad_norm within rtol 1e-5;
params (and adafactor's statistics) after the first and last step within
rtol/atol 1e-5; logits within rtol/atol 1e-5 after the prefill and each
decode step (teacher-forced on the reference's tokens); greedy tokens
equal.  Adafactor's steps run at lr 1e-3: its update is about
``lr · sign(g)`` wherever a leaf's g² dominates its statistic, so a
gradient that rounds differently near zero moves the parameter by up to
``lr``; at lr 0.05 the third step's parameters differ by 1.2e-4 from the
port's own whole step while the gradients agree to 8e-6 of their
largest.  The collective counts are held against ``train_collectives``
and ``serve_collectives``, the formulas PERF.md §5 states
(``chip_smoke.py`` holds the same)."""
import dataclasses
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import mamba as TMB
from repro_torch.models import transformer as TT
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.serve.engine import Engine
from repro_torch.train import make_train_state, make_train_step
from repro_torch.train import step as TS
from repro_torch.utils.placed import Placed
from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, S = 3, 4, 16
P, NEW = 6, 7                  # a prefill, then 6 decode steps
LRS = {"sgd": 0.05, "adafactor": 1e-3}
# case -> (arch, grid, optimizer or None, train microbatches)
CASES = {"jamba_fsdp_2x2": ("jamba-1.5-large-398b", (2, 2), "adafactor", (1, 2)),
         "jamba_fsdp_1x4": ("jamba-1.5-large-398b", (1, 4), None, ()),
         "rwkv_fsdp_2x2": ("rwkv6-7b", (2, 2), "sgd", (1,)),
         "gemma_fsdp_2x4": ("gemma3-1b", (2, 4), "adafactor", (1,))}
# the reference's jobs in four processes run side by side: (case, "train" and its
# microbatches, or "serve")
JOBS = ([("jamba_fsdp_2x2", "train", [1])], [("jamba_fsdp_2x2", "train", [2])],
        [("jamba_fsdp_2x2", "serve", []), ("jamba_fsdp_1x4", "serve", [])],
        [("rwkv_fsdp_2x2", "train", [1]), ("gemma_fsdp_2x4", "train", [1])])
RTOL = ATOL = 1e-5


def cfg_of(arch):
    """The cut both packages run (the reference script runs this source):
    the reduced config with FSDP on."""
    return dataclasses.replace(reduce_config(get_config(arch)), fsdp=True)


def opt_of(name, lr):
    kw = {"momentum": 0.9} if name == "sgd" else {}
    return make_optimizer(name, constant_lr(lr), **kw)


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
""" + inspect.getsource(cfg_of) + inspect.getsource(opt_of) + r"""

def put(prefix, tree):
    tree_map_with_name(lambda n, x: arrays.__setitem__(f"{prefix}/{n}", np.asarray(x)), tree)

def shards(prefix, tree, mesh, keep=lambda n: True):
    slot = {d: i for i, d in enumerate(mesh.devices.flat)}
    def one(n, x):
        if keep(n):
            for sh in x.addressable_shards:
                arrays[f"{prefix}/{n}/{slot[sh.device]}"] = np.asarray(sh.data)
    tree_map_with_name(one, tree)

for case, what, mbs in args["jobs"]:
    arch, shape, opt_name, _ = args["cases"][case]
    cfg = cfg_of(arch)
    params = init_lm(cfg, jax.random.PRNGKey(0))
    if what == "train":
        put(f"{case}/init", params)
        opt = opt_of(opt_name, args["lrs"][opt_name])
        mesh = jax.make_mesh(tuple(shape), ("replica", "model"), axis_types=(AxisType.Auto,) * 2)
        state = make_train_state(params, opt)
        psh = SH.params_shardings(mesh, params, cfg, data_axis="replica", model_axis="model")
        state_sh = {"params": psh, "opt": SH.opt_state_shardings(mesh, state["opt"], psh)}
        batch_sh = SH.batch_shardings(mesh, {"tokens": jnp.asarray(inputs[f"{case}/tokens"][0])},
                                      data_axis="replica")
        for mb in mbs:
            step = jax.jit(make_train_step(cfg, opt, microbatches=mb, grad_shardings=psh),
                           in_shardings=(state_sh, batch_sh), out_shardings=(state_sh, None))
            st = jax.device_put(state, state_sh)
            for i in range(args["steps"]):
                st, m = step(st, {"tokens": jnp.asarray(inputs[f"{case}/tokens"][i])})
                arrays[f"{case}/mb{mb}/loss/{i}"] = np.asarray(m["loss"])
                arrays[f"{case}/mb{mb}/grad_norm/{i}"] = np.asarray(m["grad_norm"])
                if i in (0, args["steps"] - 1):
                    put(f"{case}/mb{mb}/params/{i}", st["params"])
                    if opt_name == "adafactor":
                        put(f"{case}/mb{mb}/stats/{i}", st["opt"]["v"])
        continue

    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    prompts = jnp.asarray(inputs[f"{case}/prompts"])
    P = prompts.shape[1]
    cache = init_cache(cfg, prompts.shape[0], P + args["new"])
    psh = SH.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    csh = SH.cache_shardings(mesh, cache, cfg, data_axis="data", model_axis="model")
    bsh = SH.batch_shardings(mesh, {"tokens": prompts}, data_axis="data")
    rep = SH.replicated(mesh)

    def prefill(params, tokens, cache):
        logits, _, cache = forward_lm(cfg, params, tokens, cache=cache,
                                      cache_index=jnp.asarray(0, jnp.int32))
        return logits[:, -1], cache

    with mesh:
        params_p = jax.device_put(params, psh)
        shards(f"{case}/shards", params_p, mesh, lambda n: "mamba/" in n)
        step = jax.jit(make_prefill_step(cfg), in_shardings=(psh, bsh), out_shardings=None)
        arrays[f"{case}/prefill_step"] = np.asarray(step(params_p, {"tokens": prompts}))
        pre = jax.jit(prefill, in_shardings=(psh, bsh["tokens"], csh), out_shardings=(None, csh))
        serve = jax.jit(make_serve_step(cfg), in_shardings=(psh, csh, bsh["tokens"], rep),
                        out_shardings=(None, csh))
        logits, cache = pre(params_p, prompts, jax.device_put(cache, csh))
        toks = [jnp.argmax(logits, -1)]
        arrays[f"{case}/logits/0"] = np.asarray(logits)
        for t in range(1, args["new"]):
            logits, cache = serve(params_p, cache, toks[-1][:, None].astype(jnp.int32),
                                  jnp.asarray(P + t - 1, jnp.int32))
            arrays[f"{case}/logits/{t}"] = np.asarray(logits)
            toks.append(jnp.argmax(logits, -1))
        arrays[f"{case}/gen"] = np.stack([np.asarray(t) for t in toks], 1)
        shards(f"{case}/cache", cache, mesh)
np.savez(out_npz, **arrays)
"""


def _inputs(rng):
    out = {}
    for case, (arch, *_rest) in CASES.items():
        cfg = cfg_of(arch)
        out[f"{case}/tokens"] = rng.integers(3, cfg.vocab_size, (STEPS, B, S)).astype(np.int32)
        out[f"{case}/prompts"] = rng.integers(3, cfg.vocab_size, (B, P)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's jobs (``JOBS``) in four subprocesses on 8 forced CPU
    devices, run side by side."""
    d = tmp_path_factory.mktemp("partitioned_ssm_ref")
    inputs = _inputs(np.random.default_rng(30))
    np.savez(d / "in.npz", **inputs)
    cases = {k: [a, list(g), o, list(m)] for k, (a, g, o, m) in CASES.items()}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8", OMP_NUM_THREADS="1")
    procs = []
    for j, jobs in enumerate(JOBS):
        args = dict(cases=cases, jobs=jobs, lrs=LRS, steps=STEPS, new=NEW,
                    inputs=str(d / "in.npz"))
        out = d / f"out{j}.npz"
        procs.append((subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, json.dumps(args),
                                        str(out)], env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), out))
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


def _tree(arrays, prefix):
    return tree_from_paths([(k[len(prefix) + 1:], torch.from_numpy(v.copy()))
                            for k, v in sorted(arrays.items()) if k.startswith(prefix + "/")])


def _close(got, want, what):
    g, w = dict(tree_leaves_with_path(got)), dict(tree_leaves_with_path(want))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k].float().numpy(), w[k].float().numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} {k}")


def _init(arrays, case):
    """The reference's init of the case's arch (the train jobs save it; a
    serving case draws the same from ``PRNGKey(0)``)."""
    arch = CASES[case][0]
    for c, (a, _, opt, _) in CASES.items():
        if a == arch and opt is not None:
            return _tree(arrays, f"{c}/init")
    raise KeyError(case)


# -- the collectives ---------------------------------------------------------------------


def _layers_split(cfg, psh, suffix, axis):
    """The layers whose leaf ``suffix`` a spec splits over ``axis`` (each
    stacked layer once)."""
    n_full, _ = TT.split_layers(cfg)
    return sum((n_full if name.startswith("scan/") else 1)
               for name, sh in tree_leaves_with_path(psh)
               if name.endswith(suffix) and axis in sh.spec)


def adafactor_collectives(psh, mesh):
    """Adafactor's collectives over placed leaves a step: where a leaf's
    spec splits it over an axis of extent > 1, a factored leaf (rank >= 2)
    all-reduces its row sums, its column sums and its u² (3), a rank-1
    leaf all-gathers its g² and all-reduces its u² (1 + 1)."""
    ar = ag = 0
    for _, sh in tree_leaves_with_path(psh):
        if any(a is not None and mesh.extent(a) > 1 for e in sh.spec
               for a in (e if isinstance(e, tuple) else (e,))):
            if len(sh.spec) >= 2:
                ar += 3
            else:
                ar += 1
                ag += 1
    return ar, ag


def train_collectives(cfg, psh, R: int, M: int, microbatches: int, opt_name="sgd",
                      mesh=None):
    """PERF.md §5's formula of a partitioned train step
    (``tests/test_torch_partitioned_moe.py``'s ``train_collectives``) with
    the Mamba and RWKV blocks and adafactor.  Per microbatch over ``model``:
    a Mamba layer whose channels split, the all-gather of the in_proj
    product (reduce-scattered back), the all-reduces of the x_proj partials
    and of out_proj's, and the backward all-reduces of its input and of
    the x_proj output every channel reads (4); an RWKV layer whose heads
    split, ``wo``'s all-reduce and the backward all-reduces of its input
    and of its four leaves held whole (6).  Per step, adafactor's
    (``adafactor_collectives``)."""
    hd = cfg.head_dim
    n_attn = sum(b.mixer == "attn" for b in cfg.blocks)
    n_dense = sum(b.ffn in ("glu", "mlp") for b in cfg.blocks)
    n_moe = sum(b.ffn == "moe" for b in cfg.blocks)
    ar = ag = rs = 0
    if M > 1:
        vocab = cfg.vocab_size % M == 0
        attn = (cfg.num_heads * hd) % M == 0
        ar += vocab + 2 * n_attn * attn + 2 * n_dense * (cfg.d_ff % M == 0) + vocab + 3 * vocab
        ar += 3 * _layers_split(cfg, psh, "moe/w_gate", "model")
        mamba = _layers_split(cfg, psh, "mamba/in_proj", "model")
        ar += 4 * mamba
        ag += mamba
        rs += mamba
        ar += 6 * _layers_split(cfg, psh, "rwkv/wr", "model")
        if n_attn and attn and cfg.num_kv_heads % M:
            if (cfg.num_kv_heads * hd) % M == 0:
                ag += 2 * n_attn
                rs += 2 * n_attn
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
        counts = n_moe * (cfg.moe.routing != "dense")
    per_step_ar += 1 if R * M > 1 else 0  # the global norm
    opt_ar, opt_ag = adafactor_collectives(psh, mesh) if opt_name == "adafactor" else (0, 0)
    return {"all_reduce": microbatches * ar + per_step_ar + opt_ar,
            "all_gather": microbatches * (ag + counts + fsdp_uses) + opt_ag,
            "reduce_scatter": microbatches * (rs + fsdp_uses)}


def serve_collectives(cfg, psh, R: int, M: int, *, cached: bool = True, data_axis="data"):
    """PERF.md §5's formula of one partitioned forward
    (``tests/test_torch_partitioned_moe.py``'s) with the Mamba and RWKV
    mixers: over ``model`` a Mamba layer whose channels split all-gathers
    its in_proj product and all-reduces its x_proj partials and its
    out_proj's (1 + 2); an RWKV layer whose heads split all-reduces its
    ``wo`` and, with a cache, all-gathers its two token-shift states.  As
    ``({kind: count}, {axis: count})``."""
    n_attn = sum(b.mixer == "attn" for b in cfg.blocks)
    n_dense = sum(b.ffn in ("glu", "mlp") for b in cfg.blocks)
    n_moe = sum(b.ffn == "moe" for b in cfg.blocks)
    ar = ag_m = ag_d = 0
    if M > 1:
        vocab = cfg.vocab_size % M == 0
        hd, Hkv = cfg.head_dim, cfg.num_kv_heads
        attn = (cfg.num_heads * hd) % M == 0
        ar += vocab + n_attn * attn + n_dense * (cfg.d_ff % M == 0)
        ar += _layers_split(cfg, psh, "moe/w_gate", "model")
        mamba = _layers_split(cfg, psh, "mamba/in_proj", "model")
        ar += 2 * mamba
        ag_m += mamba
        rwkv = _layers_split(cfg, psh, "rwkv/wr", "model")
        ar += rwkv
        if n_attn and attn and Hkv % M and (Hkv * hd) % M == 0:
            ag_m += 2 * n_attn
        if cached:
            if n_attn and Hkv % M and hd % M == 0:
                ag_m += 2 * n_attn
            ag_m += 2 * rwkv
        ag_m += vocab
    if R > 1:
        n_full, _ = TT.split_layers(cfg)
        for name, sh in tree_leaves_with_path(psh):
            if data_axis in sh.spec:
                ag_d += n_full if name.startswith("scan/") else 1
        ag_d += 1 + n_moe * (cfg.moe.routing != "dense")
    kinds = {"all_reduce": ar, "all_gather": ag_m + ag_d, "reduce_scatter": 0}
    return kinds, {a: n for a, n in (("model", ar + ag_m), (data_axis, ag_d)) if n}


# -- the factored Mamba path -------------------------------------------------------------------


def _mamba_unfactored(cfg, p, x, *, state=None, return_state=False):
    """``models.mamba.mamba_fwd`` as it was before its channel-local parts
    were factored out (a verbatim copy of the composition)."""
    B, S_, _ = x.shape
    di, ds, dc = TMB.d_inner(cfg), cfg.ssm.d_state, cfg.ssm.d_conv
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    prepend = None if state is None else state["conv"]
    xc = TMB._conv(cfg, p, xi, prepend=prepend)
    dtr = cfg.ssm.dt_rank
    proj = (xc @ p["x_proj"]).float()
    dt_low, Bmat, Cmat = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_low @ p["dt_proj"].float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * xc.float())[..., :, None] * Bmat[..., None, :]
    h = state["h"] if state is not None else torch.zeros((B, di, ds), dtype=torch.float32,
                                                          device=x.device)
    steps = []
    for t in range(S_):
        h = dA[:, t] * h + dBx[:, t]
        steps.append(torch.einsum("bns,bs->bn", h, Cmat[:, t]))
    ys = torch.stack(steps, dim=1)
    y = ys + xc.float() * p["D"]
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    new_state = None
    if return_state:
        if prepend is None:
            prepend = torch.zeros((B, dc - 1, di), dtype=x.dtype, device=x.device)
        new_state = {"h": h, "conv": torch.cat([prepend, xi], dim=1)[:, -(dc - 1):]}
    return out, new_state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_factored_mamba_is_bit_for_bit_the_old_path(dtype):
    """``mamba_fwd`` composed of its channel-local parts gives the old
    composition's bits: the forward of a prompt, the state it leaves, a
    resumed step from that state, and every gradient."""
    cfg = cfg_of("jamba-1.5-large-398b")
    gen = torch.Generator().manual_seed(7)
    p = TMB.init_mamba(cfg, gen, dtype, "cpu")
    x = (0.5 * torch.randn(2, 9, cfg.d_model, generator=gen)).to(dtype)
    x1 = (0.5 * torch.randn(2, 1, cfg.d_model, generator=gen)).to(dtype)
    outs = {}
    for name, fn in (("new", TMB.mamba_fwd), ("old", _mamba_unfactored)):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        xs = x.detach().clone().requires_grad_(True)
        y, st = fn(cfg, leaves, xs, return_state=True)
        y1, st1 = fn(cfg, leaves, x1, state=st, return_state=True)
        loss = (y.float() ** 2).sum() + (y1.float() * 3).sum()
        grads = torch.autograd.grad(loss, [xs] + [leaves[k] for k in sorted(leaves)])
        outs[name] = [y, st["h"], st["conv"], y1, st1["h"], st1["conv"], *grads]
    for a, b in zip(outs["new"], outs["old"]):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- placement ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["jamba_fsdp_2x2", "jamba_fsdp_1x4"])
def test_placement_of_the_mamba_leaves(ref, case):
    """``device_put`` places the Mamba leaves by the reference's rules on
    the serving grid: every slot's block equals the reference's
    ``addressable_shards``; the bytes a slot holds equal
    ``dryrun.slot_bytes``."""
    arrays, _ = ref
    arch, grid, *_ = CASES[case]
    cfg = cfg_of(arch)
    mesh = tmesh.make_mesh(grid, ("data", "model"), device="cpu")
    params = _init(arrays, case)
    psh = tsh.params_shardings(mesh, params, cfg)
    placed = tsh.device_put(params, psh)
    specs = dict(tree_leaves_with_path(psh))
    want = {"in_proj": (None, "data", "model"), "out_proj": (None, "model", "data"),
            "x_proj": (None, "model", None), "A_log": (None, "model", None),
            "conv_b": (None, "model")}
    for leaf, spec in want.items():
        assert tuple(specs[f"scan/pos0/mamba/{leaf}"].spec) == spec, leaf
    seen = 0
    for name, x in tree_leaves_with_path(placed):
        assert isinstance(x, Placed), name
        for s in range(mesh.devices.size):
            key = f"{case}/shards/{name}/{s}"
            if key in arrays:
                np.testing.assert_array_equal(x.block(s).numpy(), arrays[key], err_msg=key)
                seen += 1
    assert seen == 9 * 7 * mesh.devices.size  # every Mamba leaf of the 7 Mamba layers
    assert tsh.placed_slot_bytes(placed, mesh) == [tdry.slot_bytes(params, psh, mesh)] * \
        mesh.devices.size


# -- the train step --------------------------------------------------------------------------


TRAIN_RUNS = [(c, mb) for c in sorted(CASES) for mb in CASES[c][3]]


@pytest.mark.parametrize("case, microbatches", TRAIN_RUNS)
def test_train_step_matches_the_reference_jit(ref, case, microbatches):
    """3 steps on placed state (step 1's batch placed by
    ``batch_shardings``) with the case's optimizer: loss and grad_norm
    against the reference's partitioned jit, params after the first and
    last step (and adafactor's statistics), the collectives against
    ``train_collectives``."""
    arrays, inputs = ref
    arch, grid, opt_name, _ = CASES[case]
    cfg, opt = cfg_of(arch), opt_of(opt_name, LRS[opt_name])
    mesh = tmesh.make_mesh(grid, ("replica", "model"), device="cpu")
    init = _tree(arrays, f"{case}/init")
    state = make_train_state(init, opt)
    psh = tsh.params_shardings(mesh, init, cfg, data_axis="replica", model_axis="model")
    state = tsh.device_put(state, {"params": psh,
                                   "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)})
    step = make_train_step(cfg, opt, microbatches=microbatches, grad_shardings=psh)
    want = train_collectives(cfg, psh, *grid, microbatches, opt_name, mesh)
    pre = f"{case}/mb{microbatches}"
    for i in range(STEPS):
        batch = {"tokens": inputs[f"{case}/tokens"][i]}
        if i == 1:
            batch = tsh.device_put(batch, tsh.batch_shardings(mesh, batch, data_axis="replica"))
        tmesh.reset_collectives()
        state, m = step(state, batch)
        assert tmesh.collectives == want, (i, tmesh.collectives, want)
        np.testing.assert_allclose(float(m["loss"]), arrays[f"{pre}/loss/{i}"], rtol=RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), arrays[f"{pre}/grad_norm/{i}"],
                                   rtol=RTOL)
        if i in (0, STEPS - 1):
            _close(tsh.gather(state["params"]), _tree(arrays, f"{pre}/params/{i}"),
                   f"step {i}")
            if opt_name == "adafactor":
                _close(tsh.gather(state["opt"]["v"]), _tree(arrays, f"{pre}/stats/{i}"),
                       f"statistics after step {i}")


def test_adafactor_on_placed_params_keeps_replicated_statistics():
    """``adafactor.init`` on placed params gives whole statistics placed as
    ``opt_state_shardings`` places them (``P()``: one block a device, so
    one block for the eight slots on the CPU), and two steps from it give
    the bits of two steps from the whole state placed by ``device_put``;
    the statistics are blended once a leaf (not once a slot) and equal the
    whole step's."""
    cfg = cfg_of("gemma3-1b")
    opt = opt_of("adafactor", LRS["adafactor"])
    params = TT.init_lm(cfg, torch.Generator().manual_seed(4), device="cpu")
    toks = np.random.default_rng(4).integers(3, cfg.vocab_size, (B, S))
    mesh = tmesh.make_mesh((2, 4), ("replica", "model"), device="cpu")
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="replica", model_axis="model")
    whole = make_train_state(params, opt)
    osh = tsh.opt_state_shardings(mesh, whole["opt"], psh)
    assert all(tuple(sh.spec) == () for _, sh in tree_leaves_with_path(osh["v"]))
    put = tsh.device_put(whole, {"params": psh, "opt": osh})
    own = make_train_state(tsh.device_put(params, psh), opt)
    for (k, a), (_, b) in zip(tree_leaves_with_path(own["opt"]["v"]),
                              tree_leaves_with_path(put["opt"]["v"])):
        assert isinstance(a, Placed) and a.layout == b.layout and len(a.blocks) == 1, k
    step = make_train_step(cfg, opt)
    for _ in range(2):
        (put, m1), (own, m2) = step(put, {"tokens": toks}), step(own, {"tokens": toks})
        whole, wm = step(whole, {"tokens": toks})
        assert float(m1["loss"]) == float(m2["loss"])
        np.testing.assert_allclose(float(m1["grad_norm"]), float(wm["grad_norm"]), rtol=RTOL)
    assert put["opt"]["step"] == own["opt"]["step"] == 2
    trees = [{"params": st["params"], "v": st["opt"]["v"]} for st in (put, own)]
    for (k, a), (_, b) in zip(*map(tree_leaves_with_path, trees)):
        assert all(torch.equal(x, y) for x, y in zip(a.blocks, b.blocks)), k
    _close(tsh.gather(put["opt"]["v"]), whole["opt"]["v"], "statistics")
    _close(tsh.gather(put["params"]), whole["params"], "params")


def test_adafactor_on_unstacked_leaves_matches_the_whole_step():
    """jamba cut to its layer 0 (a tail layer: its Mamba leaves unstacked,
    ``D``, ``conv_b`` and ``dt_bias`` rank-1 and split over ``model``) with
    FSDP on (2, 2): 3 adafactor steps against the port's whole step
    (loss, grad_norm, params and statistics within rtol/atol 1e-5), the
    collectives of each step ``train_collectives``'."""
    cfg = dataclasses.replace(cfg_of("jamba-1.5-large-398b"), num_layers=1)
    opt = opt_of("adafactor", LRS["adafactor"])
    params = TT.init_lm(cfg, torch.Generator().manual_seed(6), device="cpu")
    toks = np.random.default_rng(6).integers(3, cfg.vocab_size, (STEPS, B, S))
    mesh = tmesh.make_mesh((2, 2), ("replica", "model"), device="cpu")
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="replica", model_axis="model")
    assert tuple(psh["tail"]["layer0"]["mamba"]["D"].spec) == ("model",)
    whole = make_train_state(params, opt)
    placed = tsh.device_put(whole, {"params": psh,
                                    "opt": tsh.opt_state_shardings(mesh, whole["opt"], psh)})
    step = make_train_step(cfg, opt)
    want = train_collectives(cfg, psh, 2, 2, 1, "adafactor", mesh)
    for i in range(STEPS):
        whole, wm = step(whole, {"tokens": toks[i]})
        tmesh.reset_collectives()
        placed, m = step(placed, {"tokens": toks[i]})
        assert tmesh.collectives == want, (i, tmesh.collectives, want)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=RTOL, err_msg=k)
    _close(tsh.gather(placed["params"]), whole["params"], "params")
    _close(tsh.gather(placed["opt"]["v"]), whole["opt"]["v"], "statistics")


# -- serving -----------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["jamba_fsdp_2x2", "jamba_fsdp_1x4"])
def test_serving_matches_the_reference_jit(ref, case):
    """The prefill into a placed cache, then 6 decode steps through
    ``make_serve_step`` teacher-forced on the reference's tokens: logits
    against the reference's, the collectives of each step against
    ``serve_collectives``, every block of the Mamba state ``h`` and
    ``conv`` and of the KV cache against the reference's
    ``addressable_shards`` at the end; ``make_prefill_step`` (no cache)
    against the reference's partitioned prefill step; ``Engine.generate``
    gives the reference's greedy tokens."""
    arrays, inputs = ref
    arch, grid, *_ = CASES[case]
    cfg = cfg_of(arch)
    mesh = tmesh.make_mesh(grid, ("data", "model"), device="cpu")
    params = _init(arrays, case)
    psh = tsh.params_shardings(mesh, params, cfg)
    placed = tsh.device_put(params, psh)
    R, M = grid
    prompts = inputs[f"{case}/prompts"]
    eng = Engine(cfg, placed, max_len=P + NEW)
    tokens, cache = eng._start(placed, prompts)
    want_counts = serve_collectives(cfg, psh, R, M)
    gen = arrays[f"{case}/gen"]
    step = TS.make_serve_step(cfg)
    for t in range(NEW):
        tmesh.reset_collectives()
        if t == 0:
            logits, cache = step(placed, cache, tokens, 0)
        else:
            logits, cache = step(placed, cache, gen[:, t - 1:t], P + t - 1)
        assert (dict(tmesh.collectives), dict(tmesh.collectives_by_axis)) == want_counts, t
        np.testing.assert_allclose(logits.numpy(), arrays[f"{case}/logits/{t}"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {t}")
        assert np.array_equal(torch.argmax(logits, -1).numpy(), gen[:, t])
    n = 0
    for name, x in tree_leaves_with_path(cache):
        for s in range(mesh.devices.size):
            want = arrays[f"{case}/cache/{name}/{s}"]
            assert tuple(x.block(s).shape) == want.shape, (name, s)
            np.testing.assert_allclose(x.block(s).numpy(), want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"cache {name} slot {s}")
            n += 1
    assert n == 8 * 2 * mesh.devices.size
    tmesh.reset_collectives()
    got = TS.make_prefill_step(cfg)(placed, {"tokens": prompts})
    assert (dict(tmesh.collectives), dict(tmesh.collectives_by_axis)) == serve_collectives(
        cfg, psh, R, M, cached=False)
    np.testing.assert_allclose(got.numpy(), arrays[f"{case}/prefill_step"], rtol=RTOL,
                               atol=ATOL)
    res = eng.generate(prompts, max_new_tokens=NEW)
    np.testing.assert_array_equal(res.tokens[:, P:], gen)


# -- the formulas at full width (phase 21 of chip_smoke.py) ------------------------------------


def _meta_params(cfg):
    from unittest import mock

    def draw(*args, **kw):
        return torch.empty(args[0] if args else kw["size"], dtype=torch.float32, device="meta")

    with mock.patch.object(torch, "randn", draw), mock.patch.object(torch, "rand", draw):
        return TT.init_lm(cfg, torch.Generator(), device="meta")


def test_collective_formulas_at_full_width():
    """The counts ``chip_smoke.py``'s phase 21 holds, from the full-width
    specs on the meta device (PERF.md §5): a partitioned forward of
    jamba-1.5-large-398b at its layers 0-4 (FSDP) on (data 2, model 2),
    and the train steps of jamba at its layer 0 with adafactor and of
    rwkv6-7b at 2 layers with AdamW on (replica 2, model 2)."""
    jamba = get_config("jamba-1.5-large-398b")
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device="meta")
    cfg = dataclasses.replace(jamba, num_layers=5)
    with torch.device("meta"):
        params = _meta_params(cfg)
    psh = tsh.params_shardings(mesh, params, cfg)
    assert serve_collectives(cfg, psh, 2, 2) == (
        {"all_reduce": 15, "all_gather": 39, "reduce_scatter": 0}, {"model": 20, "data": 34})
    mesh = tmesh.make_mesh((2, 2), ("replica", "model"), device="meta")
    for arch, layers, opt_name, want in (
            ("jamba-1.5-large-398b", 1, "adafactor",
             {"all_reduce": 59, "all_gather": 11, "reduce_scatter": 8}),
            ("rwkv6-7b", 2, "adamw", {"all_reduce": 38, "all_gather": 14, "reduce_scatter": 14})):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        with torch.device("meta"):
            params = _meta_params(cfg)
        psh = tsh.params_shardings(mesh, params, cfg, data_axis="replica")
        assert train_collectives(cfg, psh, 2, 2, 1, opt_name, mesh) == want, arch
