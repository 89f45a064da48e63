"""The partitioned train step (a slab split over its replica x model slots)
against the JAX package's partitioned jit, on the CPU.

The reference runs ``jax.jit(make_train_step(cfg, sgd, grad_shardings=psh),
in_shardings=(state_sh, batch_sh), out_shardings=(state_sh, None))`` over
its own ``params_shardings`` (``data_axis="replica"``) on meshes made as
``jax.make_mesh(shape, ("replica", "model"), axis_types=(Auto, Auto))``
(the default Explicit axes fail at the embedding gather), all in one
subprocess on 8 forced CPU devices.  Cases: reduced gemma3-1b (d 64, 2
layers; tensor and data parallel, its one KV head gathered over
``model``) on (2, 2) and (2, 4), and reduced mistral-nemo-12b with
``fsdp=True`` forced on (tensor parallel and FSDP) on (2, 2); microbatches
1 and 2.  The port places the same state by its ``device_put`` and runs
``make_train_step`` on it.

Tolerances (f32): loss and grad_norm within 1e-5 relative, params within
rtol 1e-5 / atol 1e-5, momentum within rtol 1e-4 / atol 1e-5 after 1 and
3 SGD steps with momentum (``tests/test_torch_lm_train.py``'s tolerance
for an SGD step: the sums run in another order than XLA's); placed blocks
equal the reference's ``addressable_shards`` exactly.  The cold step on a
(2, 2, 2) mesh is held per slab against the reference's partitioned step
on the slab's (2, 2) sub-mesh, and both fuses of the trained slabs against
the reference's per-leaf fuse (rtol 1e-6 / atol 1e-7).  The collective
counts are held against ``expected_collectives``, the formula PERF.md
states.  Stablelm-12b and granite-20b (reduced) are held against the
port's own whole step; the Mamba mixer, the RWKV block and adafactor
are refused (``tests/test_torch_partitioned_moe.py`` holds the MoE archs)."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import distributed as D
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import transformer as TT
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train import make_train_state, make_train_step
from repro_torch.train.losses import lm_loss, lm_loss_vocab_parallel
from repro_torch.utils.placed import Placed
from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, S, LR, C = 3, 4, 16, 0.05, 2
# case -> (arch, fsdp, mesh shape)
CASES = {"gemma_2x2": ("gemma3-1b", False, (2, 2)),
         "gemma_2x4": ("gemma3-1b", False, (2, 4)),
         "mistral_fsdp_2x2": ("mistral-nemo-12b", True, (2, 2))}
ALPHAS = (1.0, 0.5)

_REF_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduce_config
from repro.core.distributed import ColdSchedule, make_fuse_step
from repro.launch import sharding as SH
from repro.models.transformer import init_lm
from repro.optim.optimizers import constant_lr, make_optimizer
from repro.train.step import make_train_state, make_train_step
from repro.utils.pytree import tree_map_with_name

args = json.loads(sys.argv[1])
out_npz = sys.argv[2]
inputs = np.load(args["inputs"])
arrays = {}

def put(prefix, tree):
    tree_map_with_name(lambda n, x: arrays.__setitem__(f"{prefix}/{n}", np.asarray(x)), tree)

def cfg_of(arch, fsdp):
    cfg = reduce_config(get_config(arch), d_model=64)
    return dataclasses.replace(cfg, num_layers=2, pattern=cfg.pattern[:2], fsdp=fsdp)

def mesh_of(shape):
    return jax.make_mesh(tuple(shape), ("replica", "model"), axis_types=(AxisType.Auto,) * 2)

opt = make_optimizer("sgd", constant_lr(args["lr"]), momentum=0.9)
steps = {}
for case, (arch, fsdp, shape) in args["cases"].items():
    cfg, mesh = cfg_of(arch, fsdp), mesh_of(shape)
    params = init_lm(cfg, jax.random.PRNGKey(0))
    put(f"{case}/init", params)
    state = make_train_state(params, opt)
    psh = SH.params_shardings(mesh, params, cfg, data_axis="replica", model_axis="model")
    state_sh = {"params": psh, "opt": SH.opt_state_shardings(mesh, state["opt"], psh)}
    batch_sh = SH.batch_shardings(mesh, {"tokens": inputs["tokens"][0, 0]}, data_axis="replica")
    placed = jax.device_put(state["params"], psh)
    slot = {d: i for i, d in enumerate(mesh.devices.flat)}
    def shards(n, x):
        for sh in x.addressable_shards:
            arrays[f"{case}/shards/{n}/{slot[sh.device]}"] = np.asarray(sh.data)
    tree_map_with_name(shards, placed)
    for mb in args["microbatches"]:
        step = jax.jit(make_train_step(cfg, opt, microbatches=mb, grad_shardings=psh),
                       in_shardings=(state_sh, batch_sh), out_shardings=(state_sh, None))
        steps[(case, mb)] = step
        st = jax.device_put(state, state_sh)
        for i in range(args["steps"]):
            st, m = step(st, {"tokens": jnp.asarray(inputs["tokens"][0, i])})
            arrays[f"{case}/mb{mb}/loss/{i}"] = np.asarray(m["loss"])
            arrays[f"{case}/mb{mb}/grad_norm/{i}"] = np.asarray(m["grad_norm"])
            if i in (0, args["steps"] - 1):
                put(f"{case}/mb{mb}/params/{i}", st["params"])
                put(f"{case}/mb{mb}/mom/{i}", st["opt"]["mom"])

# the cold step's slabs: each slab the partitioned step on its own tokens
# (its (2, 2) sub-mesh), then the reference's per-leaf fuse of the two
step = steps[("gemma_2x2", 1)]
cfg = cfg_of("gemma3-1b", False)
state = make_train_state(init_lm(cfg, jax.random.PRNGKey(0)), opt)
slabs = []
for c in range(args["C"]):
    st = state
    for i in range(2):
        st, m = step(st, {"tokens": jnp.asarray(inputs["tokens"][c, i])})
        arrays[f"cold/loss/{c}/{i}"] = np.asarray(m["loss"])
    slabs.append(jax.tree.map(np.asarray, st["params"]))
stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *slabs)
put("cold/params", stacked)
cold = jax.make_mesh((2, 2, 2), ("contrib", "replica", "model"))
for a in args["alphas"]:
    f = jax.jit(make_fuse_step(cfg, cold, ColdSchedule(alpha=a), flat=False))
    put(f"cold/fused/{a}", f(stacked))
np.savez(out_npz, **arrays)
"""


def _cfg(arch="gemma3-1b", fsdp=False):
    cfg = reduce_config(get_config(arch), d_model=64)
    return dataclasses.replace(cfg, num_layers=2, pattern=cfg.pattern[:2], fsdp=fsdp)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference case in one subprocess on 8 forced CPU devices."""
    d = tmp_path_factory.mktemp("partitioned_ref")
    rng = np.random.default_rng(27)
    tokens = rng.integers(3, _cfg().vocab_size, (C, STEPS, B, S)).astype(np.int32)
    np.savez(d / "in.npz", tokens=tokens)
    args = dict(cases={k: [a, f, list(s)] for k, (a, f, s) in CASES.items()}, lr=LR,
                steps=STEPS, microbatches=[1, 2], C=C, alphas=list(ALPHAS),
                inputs=str(d / "in.npz"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, json.dumps(args),
                           str(d / "out.npz")], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(d / "out.npz") as out:
        return dict(out), tokens


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(arrays, prefix):
    return tree_from_paths([(k[len(prefix) + 1:], torch.from_numpy(v.copy()))
                            for k, v in sorted(arrays.items()) if k.startswith(prefix + "/")])


def _sgd():
    return make_optimizer("sgd", constant_lr(LR), momentum=0.9)


def _close(got, want, rtol, atol):
    g, w = dict(tree_leaves_with_path(got)), dict(tree_leaves_with_path(want))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k].float().numpy(), w[k].float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def _placed_state(case, arrays):
    """The reference's initial state placed on the port's mesh, with its
    shardings (``params_shardings`` with ``data_axis="replica"``)."""
    arch, fsdp, shape = CASES[case]
    cfg, opt = _cfg(arch, fsdp), _sgd()
    mesh = tmesh.make_mesh(shape, ("replica", "model"), device="cpu")
    state = make_train_state(_tree(arrays, f"{case}/init"), opt)
    psh = tsh.params_shardings(mesh, state["params"], cfg, data_axis="replica",
                               model_axis="model")
    sh = {"params": psh, "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)}
    return cfg, opt, mesh, state, sh, psh


# -- the collectives a partitioned step makes ----------------------------------------------


def expected_collectives(cfg, psh, R: int, M: int, microbatches: int):
    """The formula of PERF.md §5: a dense decoder's partitioned step on a
    (replica R, model M) grid.  Per microbatch, over ``model`` (M > 1): the
    embedding's all-reduce where the vocabulary splits, per layer two
    output all-reduces and two input all-reduces (backward) for attention
    and the FFN where they split, the logits' input all-reduce (backward)
    and the loss's three; the KV weights all-gathered (reduce-scattered
    back) where Hkv does not split but their spec does, their gradient
    all-reduced where the spec keeps them whole.  Over ``replica`` (R > 1):
    each use of a leaf FSDP splits, one all-gather and one reduce-scatter.
    Per step: one all-reduce over ``replica`` per leaf not split over it,
    the global norm's one, and the loss metric's one over ``replica``."""
    L, hd = cfg.num_layers, cfg.head_dim
    ar = ag = 0
    if M > 1:
        vocab = cfg.vocab_size % M == 0
        attn = (cfg.num_heads * hd) % M == 0
        ffn = cfg.d_ff % M == 0
        ar += vocab + L * (2 * attn + 2 * ffn) + vocab + 3 * vocab
        if attn and cfg.num_kv_heads % M:
            if (cfg.num_kv_heads * hd) % M == 0:
                ag += 2 * L
            else:
                ar += 2 * L
    fsdp_uses = per_step_ar = 0
    if R > 1:
        n_full, _ = TT.split_layers(cfg)
        for name, sh in tree_leaves_with_path(psh):
            if "replica" in sh.spec:  # gathered where used: each stacked layer once
                fsdp_uses += n_full if name.startswith("scan/") else 1
            else:
                per_step_ar += 1
        per_step_ar += 1  # the loss metric
    per_step_ar += 1 if R * M > 1 else 0  # the global norm
    return {"all_reduce": microbatches * ar + per_step_ar,
            "all_gather": microbatches * (ag + fsdp_uses),
            "reduce_scatter": microbatches * (ag + fsdp_uses)}


# -- the collectives over one named axis ------------------------------------------------------


def test_axis_collectives_count_forward_and_backward():
    """Each named-axis collective on a (2, 3) grid against its definition,
    counted once a call forward and once backward (Megatron's pairs), with
    the ring bytes; on one device the slots of a group share a result
    outside autograd; an axis of extent 1 is no collective."""
    mesh = tmesh.make_mesh((2, 3), ("replica", "model"), device="cpu")
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(2, 6, generator=gen, dtype=torch.float64).requires_grad_(True)
             for _ in range(6)]
    groups = mesh.groups("model")
    assert groups == [[0, 1, 2], [3, 4, 5]] and mesh.groups("replica") == [[0, 3], [1, 4], [2, 5]]
    cases = {
        "all_reduce": (tmesh.axis_all_reduce, {}, ("all_reduce", None)),
        "sum_grads": (tmesh.axis_sum_grads, {}, (None, "all_reduce")),
        "all_gather": (tmesh.axis_all_gather, {"dim": 1}, ("all_gather", "reduce_scatter")),
        "reduce_scatter": (tmesh.axis_reduce_scatter, {"dim": 1},
                           ("reduce_scatter", "all_gather")),
    }
    for name, (fn, kw, (fwd, bwd)) in cases.items():
        tmesh.reset_collectives()
        out = fn(parts, mesh, "model", **kw)
        fwd_counts = dict(tmesh.collectives)
        weights = [torch.full_like(o, float(s + 1)) for s, o in enumerate(out)]
        grads = torch.autograd.grad(out, parts, weights)
        assert fwd_counts == {k: int(k == fwd) for k in fwd_counts}, name
        assert tmesh.collectives == {k: int(k in (fwd, bwd)) for k in fwd_counts}, name
        assert tmesh.collectives_by_axis == {"model": int(fwd is not None) + int(bwd is not None)}
        for g in groups:
            total = sum(parts[s].detach() for s in g)
            wsum = sum(float(s + 1) for s in g)
            for i, s in enumerate(g):
                if name == "all_reduce":
                    assert torch.equal(out[s], total) and torch.all(grads[s] == s + 1)
                elif name == "sum_grads":
                    assert torch.equal(out[s], parts[s]) and torch.all(grads[s] == wsum)
                elif name == "all_gather":
                    assert torch.equal(out[s], torch.cat([parts[t] for t in g], 1).detach())
                    assert torch.all(grads[s] == wsum)
                else:
                    assert torch.equal(out[s], total[:, 2 * i:2 * i + 2])
                    assert torch.all(grads[s][:, 2 * i:2 * i + 2] == s + 1)
    tmesh.reset_collectives()
    assert tmesh.collective_bytes["all_reduce"] == 0
    shared = tmesh.axis_all_reduce([p.detach() for p in parts], mesh, "replica")
    assert shared[0] is shared[3] and shared[1] is not shared[0]
    assert tmesh.collective_bytes["all_reduce"] == 3 * 2 * (2 - 1) * 12 * 8
    top = tmesh.axis_all_reduce_max(parts, mesh, "model")
    assert not top[0].requires_grad and torch.equal(top[1], torch.maximum(
        torch.maximum(parts[0], parts[1]), parts[2]).detach())
    tmesh.reset_collectives()
    one = tmesh.make_mesh((2, 1), ("replica", "model"), device="cpu")
    assert tmesh.axis_all_gather(parts[:2], one, "model", 1)[0] is parts[0]
    assert tmesh.collectives["all_gather"] == 0


# -- placement -------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_placement_matches_the_reference_shards(ref, case):
    """Each slot's block of every parameter equals the reference's
    ``addressable_shards`` for that device; the bytes each slot holds of
    the state equal ``dryrun.slot_bytes``; a replicated block is one tensor
    a device."""
    arrays, _ = ref
    cfg, opt, mesh, state, sh, psh = _placed_state(case, arrays)
    placed = tsh.device_put(state, sh)
    n = mesh.devices.size
    for name, x in tree_leaves_with_path(placed["params"]):
        assert isinstance(x, Placed), name
        for s in range(n):
            want = arrays[f"{case}/shards/{name}/{s}"]
            np.testing.assert_array_equal(x.block(s).numpy(), want, err_msg=f"{name} slot {s}")
        # on the CPU every slot shares one device: one tensor a logical block
        assert len(x.blocks) == len(x.layout.logical_blocks())
    want = tdry.slot_bytes(state, sh, mesh)
    assert tsh.placed_slot_bytes(placed, mesh) == [want] * n
    whole = tsh.gather(placed)
    _close(whole["params"], state["params"], 0, 0)


# -- the step ----------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_partitioned_step_matches_the_reference_jit(ref, case, microbatches):
    arrays, tokens = ref
    cfg, opt, mesh, state, sh, psh = _placed_state(case, arrays)
    R, M = mesh.shape["replica"], mesh.shape["model"]
    state = tsh.device_put(state, sh)
    step = make_train_step(cfg, opt, microbatches=microbatches, grad_shardings=psh)
    want_counts = expected_collectives(cfg, psh, R, M, microbatches)
    pre = f"{case}/mb{microbatches}"
    for i in range(STEPS):
        batch = {"tokens": tokens[0, i]}
        if i == 1:  # a batch placed by its own sharding reads the same rows
            bsh = tsh.batch_shardings(mesh, batch, data_axis="replica")
            batch = tsh.device_put(batch, bsh)
            assert isinstance(batch["tokens"], Placed)
        tmesh.reset_collectives()
        state, m = step(state, batch)
        assert tmesh.collectives == want_counts, (i, tmesh.collectives)
        np.testing.assert_allclose(float(m["loss"]), arrays[f"{pre}/loss/{i}"], rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), arrays[f"{pre}/grad_norm/{i}"],
                                   rtol=1e-5)
        assert float(m["aux"]) == 0.0
        if i in (0, STEPS - 1):
            got = tsh.gather(state)
            _close(got["params"], _tree(arrays, f"{pre}/params/{i}"), 1e-5, 1e-5)
            _close(got["opt"]["mom"], _tree(arrays, f"{pre}/mom/{i}"), 1e-4, 1e-5)
    assert state["opt"]["step"] == STEPS
    assert all(isinstance(x, Placed) for _, x in tree_leaves_with_path(state["opt"]["mom"]))


def test_collective_formula_at_full_width():
    """The formula's counts for phase 16 and phase 18 of ``chip_smoke.py``
    (gemma3-1b and 4 layers of mistral-nemo-12b with FSDP, both on (2, 2),
    one microbatch), as PERF.md §5 writes them, from the full-width specs
    built on the meta device."""
    for arch, layers, want in (("gemma3-1b", None, {"all_reduce": 185, "all_gather": 52,
                                                    "reduce_scatter": 52}),
                               ("mistral-nemo-12b", 4, {"all_reduce": 26, "all_gather": 30,
                                                        "reduce_scatter": 30})):
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        mesh = tmesh.make_mesh((2, 2), ("replica", "model"), device="meta")
        with torch.device("meta"):
            params = _meta_params(cfg)
        psh = tsh.params_shardings(mesh, params, cfg, data_axis="replica", model_axis="model")
        assert expected_collectives(cfg, psh, 2, 2, 1) == want, arch


def _meta_params(cfg):
    """A full-width parameter tree of shapes only (the draws replaced by
    meta tensors)."""
    from unittest import mock

    def draw(*args, **kw):
        return torch.empty(args[0] if args else kw["size"], dtype=torch.float32, device="meta")

    with mock.patch.object(torch, "randn", draw):
        return TT.init_lm(cfg, torch.Generator(), device="meta")


# -- the loss ----------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("model", [1, 2, 4])
def test_vocab_parallel_lm_loss_equals_lm_loss(model, masked):
    """Split over ``model`` blocks, the loss and its gradient equal
    ``lm_loss`` of the whole logits within f32 rounding (rtol 1e-6 /
    atol 1e-8 for the gradient); on one block it is ``lm_loss`` itself."""
    gen = torch.Generator().manual_seed(model)
    Bq, Sq, V = 3, 7, 48
    logits = torch.randn(Bq, Sq, V, generator=gen) * 3
    tokens = torch.randint(0, V, (Bq, Sq), generator=gen)
    mask = (torch.rand(Bq, Sq, generator=gen) > 0.3).float() if masked else None
    whole = logits.clone().requires_grad_(True)
    want = lm_loss(whole, tokens, mask)
    (gw,) = torch.autograd.grad(want, whole)
    mesh = tmesh.make_mesh((2, model), ("replica", "model"), device="cpu")
    Vl = V // model
    parts = [logits[..., mesh.coord(s, "model") * Vl:(mesh.coord(s, "model") + 1) * Vl]
             .clone().requires_grad_(True) for s in range(2 * model)]
    tmesh.reset_collectives()
    got = lm_loss_vocab_parallel(parts, [tokens] * len(parts), mesh, "model",
                                 None if mask is None else [mask] * len(parts))
    assert tmesh.collectives["all_reduce"] == (3 if model > 1 else 0)
    grads = torch.autograd.grad(got, parts, [torch.ones(())] * len(parts))
    for s, (g, l) in enumerate(zip(grads, got)):
        if model == 1:
            assert torch.equal(l, want)
        np.testing.assert_allclose(float(l.detach()), float(want.detach()), rtol=1e-6)
        m = mesh.coord(s, "model")
        np.testing.assert_allclose(g.numpy(), gw[..., m * Vl:(m + 1) * Vl].numpy(), rtol=1e-6,
                                   atol=1e-8)


# -- the cold step on (2, 2, 2) ------------------------------------------------------------


def test_cold_step_partitioned_per_slab(ref):
    """Each slab of a (2, 2, 2) ColD mesh runs the partitioned step on its
    (2, 2) sub-grid: per slab against the reference's partitioned step on
    its own tokens, no collective over ``contrib`` and C times the formula
    a local step; then both fuses on the placed slabs against the
    reference's per-leaf fuse, the slabs placed as before."""
    arrays, tokens = ref
    cfg, opt = _cfg(), _sgd()
    mesh = tmesh.make_cold_mesh(contributors=C, replicas=2, model=2, device="cpu")
    state = D.stack_for_contributors(make_train_state(_tree(arrays, "gemma_2x2/init"), opt), C)
    state_sh, batch_sh = D.cold_shardings(mesh, cfg, state, {"tokens": tokens[:, 0]})
    slot_want = tdry.slot_bytes(state, state_sh, mesh)
    state = tsh.device_put(state, state_sh)
    assert tsh.placed_slot_bytes(state, mesh) == [slot_want] * 8
    assert all(isinstance(x, Placed) for x in state["params"]["embed"])
    sub = tsh.sub_mesh(mesh, 0)
    psh = tsh.params_shardings(sub, D.slab(state["params"], 0), cfg, data_axis="replica",
                               model_axis="model")
    per_slab = expected_collectives(cfg, psh, 2, 2, 1)
    cold = D.make_cold_train_step(cfg, opt)
    for i in range(2):
        tmesh.reset_collectives()
        state, m = cold(state, tpipe.shard_batch({"tokens": tokens[:, i]}, batch_sh["tokens"]))
        assert tmesh.collectives == {k: C * v for k, v in per_slab.items()}
        assert tmesh.collectives_by_axis.get("contrib", 0) == 0
        for c in range(C):
            np.testing.assert_allclose(float(m["loss"][c]), arrays[f"cold/loss/{c}/{i}"],
                                       rtol=1e-5)
    got = tsh.gather(state["params"])
    _close({k: torch.stack(v) for k, v in tree_leaves_with_path(got)},
           _tree(arrays, "cold/params"), 1e-5, 1e-5)
    n_leaves = len(tree_leaves_with_path(state["params"]))
    for alpha in ALPHAS:
        fused = {}
        for flat in (True, False):
            tmesh.reset_collectives()
            f = D.make_fuse_step(cfg, mesh, D.ColdSchedule(alpha=alpha), flat=flat)(
                state["params"])
            if flat:  # each slab gathered to its home, fused, gathered back
                assert tmesh.collectives == {"all_reduce": 1, "all_gather": 2 * C,
                                             "reduce_scatter": 0}
            else:  # one all-reduce a leaf over the contributor axis, on stored blocks
                assert tmesh.collectives == {"all_reduce": n_leaves, "all_gather": 0,
                                             "reduce_scatter": 0}
                assert tmesh.collectives_by_axis == {"contrib": n_leaves}
            for k, v in tree_leaves_with_path(f):
                layouts = [x.layout for x in dict(tree_leaves_with_path(state["params"]))[k]]
                assert [x.layout for x in v] == layouts, k
            fused[flat] = {k: torch.stack(v) for k, v in tree_leaves_with_path(tsh.gather(f))}
            _close(fused[flat], _tree(arrays, f"cold/fused/{alpha}"), 1e-6, 1e-7)
        for k in fused[True]:  # at C = 2 the two paths give the same bits
            assert torch.equal(fused[True][k], fused[False][k]), k


# -- the other dense archs and the refusals ----------------------------------------------------


@pytest.mark.parametrize("arch", ["stablelm-12b", "granite-20b"])
def test_other_dense_archs_match_the_whole_step(arch):
    """One partitioned SGD step on (2, 2) against the port's own whole step
    (layernorm with biases; granite's MLP and single KV head)."""
    cfg, opt = _cfg(arch), _sgd()
    params = TT.init_lm(cfg, torch.Generator().manual_seed(5), device="cpu")
    toks = np.random.default_rng(5).integers(3, cfg.vocab_size, (B, S))
    mesh = tmesh.make_mesh((2, 2), ("replica", "model"), device="cpu")
    state = make_train_state(params, opt)
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="replica", model_axis="model")
    placed = tsh.device_put(state, {"params": psh,
                                    "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)})
    want, wm = make_train_step(cfg, opt)(state, {"tokens": toks})
    tmesh.reset_collectives()
    got, gm = make_train_step(cfg, opt)(placed, {"tokens": toks})
    assert tmesh.collectives == expected_collectives(cfg, psh, 2, 2, 1)
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(gm["grad_norm"]), float(wm["grad_norm"]), rtol=1e-5)
    _close(tsh.gather(got["params"]), want["params"], 1e-5, 1e-5)


@pytest.mark.parametrize("arch, part", [
    ("roberta-base", "encoder (RoBERTa)"),
    ("gemma3-1b", "batch input 'frames'")])
def test_other_archs_are_refused(arch, part):
    """What the partitioned train step does not run raises
    ``NotImplementedError`` naming the arch and the part (the Mamba mixer,
    the RWKV block and adafactor train partitioned since
    ``tests/test_torch_partitioned_ssm.py``, the encoder-decoder at a batch
    the batch axis divides since ``tests/test_torch_partitioned_whisper.py``
    and at any other since ``tests/test_torch_context_parallel_whisper.py``):
    the encoder, and a decoder's batch with the encoder-decoder's
    ``frames``."""
    gen = torch.Generator().manual_seed(0)
    if arch == "roberta-base":
        from repro_torch.configs import TINY
        from repro_torch.models.encoder import init_encoder_body
        cfg = TINY
        params = init_encoder_body(cfg, gen, device="cpu")
    else:
        cfg = reduce_config(get_config(arch))
        params = TT.init_lm(cfg, gen, device="cpu")
    opt = _sgd()
    mesh = tmesh.make_mesh((2, 2), ("replica", "model"), device="cpu")
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="replica", model_axis="model")
    state = make_train_state(params, opt)
    state = tsh.device_put(state, {"params": psh,
                                   "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)})
    batch = {"tokens": np.random.default_rng(0).integers(3, cfg.vocab_size, (B, S))}
    if arch != "gemma3-1b" or "frames" in part:
        batch["frames"] = np.zeros((B, 8, cfg.d_model), np.float32)
    match = f"{cfg.name}'s " + part.replace("(", r"\(").replace(")", r"\)")
    with pytest.raises(NotImplementedError, match=match):
        make_train_step(cfg, opt)(state, batch)
