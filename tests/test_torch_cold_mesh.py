"""The port's model-side ColD mesh against the JAX package's, on the CPU:
the sharding rules (``param_spec`` through ``cache_shardings``) for all 11
arch configs at full width on a (2, 2, 2) ``contrib/replica/model`` mesh,
an (8,) ``model`` mesh and a (16,) one (an abstract mesh on the reference's
side), ``make_cold_train_step`` against the
reference's ``jax.jit(jax.vmap(local))``, ``cohort_fuse_sharded`` and
``make_fuse_step`` against the reference's ``cohort_fuse_sharded`` and its
per-leaf path, then ``shard_batch``, ``device_put`` and
``make_train_step(grad_shardings=)``.  Each claim about slabs placed whole
runs on a (2, 1, 1) mesh, where a slab's sub-grid has one slot; on the
(2, 2, 2) mesh the slabs are partitioned (``tests/test_torch_partitioned.py``
holds that step against the reference's partitioned jit) and the same
calls run beside them.

Every reference case runs in one subprocess on 8 forced CPU devices (jax
starts once).  The reference's sharded jit of the cold step and its
``ShardedFlatSpec.unshard`` of a sharded array both fail in this jax
(ROADMAP §C), so the cold step is held against the vmap jitted without
shardings and the fuse against the per-leaf path and
``cohort_fuse_sharded`` read back as ``[C, S, L]``.  The port's full-width
trees are built on the meta device: shapes only, no memory.

Tolerances: specs are equal entry for entry.  The cold step takes
``tests/test_torch_lm_train.py``'s tolerance for an SGD step: loss and
grad_norm within 1e-5 relative, params within rtol 1e-5 / atol 1e-5,
momentum within rtol 1e-4 / atol 1e-5.  Fuses in f32 within rtol 1e-6 /
atol 1e-7 of the reference (the same sums, one or two f32 roundings
apart); the port's flat and per-leaf paths, placed or stacked, agree bit
for bit at C = 2, where the flat path's ``x0/2 + x1/2`` is the per-leaf
``(x0 + x1)/2`` exactly."""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.core import distributed as D
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import transformer as TT
from repro_torch.models import whisper as TW
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train import make_train_state, make_train_step
from repro_torch.utils import flat as tflat
from repro_torch.utils.placed import Placed
from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_path, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 2                      # contributors of the cold mesh
STEPS, B, S, LR = 2, 4, 16, 0.05
ALPHAS = (1.0, 0.3)
# (mesh, contrib axes, shard axes, C, N) for cohort_fuse_sharded
COHORT = {"cold_s4": ("cold", ("contrib",), ("replica", "model"), 2, 5000),
          "cold_s1": ("cold", ("contrib",), (), 2, 5000),
          "cold_local2": ("cold", ("contrib",), ("replica", "model"), 4, 3000),
          "contrib8": ("contrib8", ("contrib",), (), 16, 5000)}
SPEC_SHAPES = {"train": (256, 4096), "long": (1, 524_288)}   # (B, S) of a batch
CACHE_SHAPES = {"decode": (128, 32_768), "long": (1, 524_288)}

_REF_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
from repro.configs import ARCH_IDS, get_config, reduce_config
from repro.core.distributed import (ColdSchedule, make_cold_train_step, make_fuse_step,
                                    stack_for_contributors)
from repro.kernels import ops
from repro.launch import sharding as SH
from repro.models import whisper as W
from repro.models.transformer import init_cache, init_lm
from repro.optim.optimizers import constant_lr, make_optimizer
from repro.train.step import make_train_state
from repro.utils.flat import ShardedFlatSpec
from repro.utils.pytree import tree_map_with_name

args = json.loads(sys.argv[1])
out_json, out_npz = sys.argv[2], sys.argv[3]
C = args["C"]
meshes = {"cold": jax.make_mesh((2, 2, 2), ("contrib", "replica", "model")),
          "model8": jax.make_mesh((8,), ("model",)),
          "contrib8": jax.make_mesh((8,), ("contrib",)),
          "data_model": jax.make_mesh((2, 4), ("data", "model")),
          "model16": AbstractMesh((16,), ("model",))}
AXES = {"cold": dict(data_axis="replica", model_axis="model"),
        "model8": dict(data_axis=None, model_axis="model"),
        "model16": dict(data_axis=None, model_axis="model")}

def enc(tree):
    out = {}
    tree_map_with_name(lambda n, sh: out.__setitem__(
        n, [list(e) if isinstance(e, tuple) else e for e in sh.spec]), tree)
    return out

def stacked(tree):
    return jax.eval_shape(lambda t: stack_for_contributors(t, C), tree)

specs = {}
key = jax.random.PRNGKey(0)
for arch in ARCH_IDS:
    base = get_config(arch)
    if base.is_encoder_decoder:
        params = jax.eval_shape(lambda: W.init_whisper(base, key))
    else:
        params = jax.eval_shape(lambda: init_lm(base, key))
    opts = {n: jax.eval_shape(make_optimizer(n, constant_lr(1e-3)).init, params)
            for n in ("adamw", "adafactor")}
    for mname, ax in AXES.items():
        mesh = meshes[mname]
        leads = ("", "C") if mname == "cold" else ("",)
        for lead in leads:
            ca = ("contrib",) if lead else ()
            p = stacked(params) if lead else params
            for fsdp in (0, 1):
                for moe in (0, 1):
                    SH.OPT_MOE_SHARD = bool(moe)
                    cfg = dataclasses.replace(base, fsdp=bool(fsdp))
                    specs[f"{arch}|{mname}|params/fsdp{fsdp}/moe{moe}/{lead}"] = enc(
                        SH.params_shardings(mesh, p, cfg, contrib_axes=ca, **ax))
            SH.OPT_MOE_SHARD = False
            psh = SH.params_shardings(mesh, p, base, contrib_axes=ca, **ax)
            for n, o in opts.items():
                specs[f"{arch}|{mname}|opt/{n}/{lead}"] = enc(
                    SH.opt_state_shardings(mesh, stacked(o) if lead else o, psh))
            for sname, (b, s) in args["batch"].items():
                batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
                         "mask": jax.ShapeDtypeStruct((b, s), jnp.float32)}
                if base.rope.kind == "mrope":
                    batch["positions"] = jax.ShapeDtypeStruct((3, b, s), jnp.int32)
                if base.family == "vlm" and base.num_frontend_tokens:
                    batch["extra_embeds"] = jax.ShapeDtypeStruct(
                        (b, base.num_frontend_tokens, base.d_model), jnp.float32)
                if base.is_encoder_decoder:
                    batch["frames"] = jax.ShapeDtypeStruct((b, base.encoder_seq, base.d_model),
                                                           jnp.float32)
                specs[f"{arch}|{mname}|batch/{sname}/{lead}"] = enc(SH.batch_shardings(
                    mesh, stacked(batch) if lead else batch, contrib_axes=ca, **ax))
            for cname, (b, s) in args["cache"].items():
                if base.is_encoder_decoder:
                    cache = jax.eval_shape(lambda: W.init_whisper_cache(base, b, s))
                else:
                    cache = jax.eval_shape(lambda: init_cache(base, b, s))
                specs[f"{arch}|{mname}|cache/{cname}/{lead}"] = enc(SH.cache_shardings(
                    mesh, stacked(cache) if lead else cache, base, contrib_axes=ca, **ax))

arrays = {}
def put(prefix, tree):
    tree_map_with_name(lambda n, x: arrays.__setitem__(f"{prefix}/{n}", np.asarray(x)), tree)

# the cold step: reduced gemma3-1b (2 layers, d 64), SGD with momentum, vmap jitted
cfg = reduce_config(get_config("gemma3-1b"), d_model=64)
cfg = dataclasses.replace(cfg, num_layers=2, pattern=cfg.pattern[:2])
opt = make_optimizer("sgd", constant_lr(args["lr"]), momentum=0.9)
params = init_lm(cfg, key)
put("init", params)
state = stack_for_contributors(make_train_state(params, opt), C)
step = jax.jit(make_cold_train_step(cfg, opt))
toks = np.load(args["inputs"])["tokens"]
for i in range(toks.shape[0]):
    state, m = step(state, {"tokens": jnp.asarray(toks[i])})
    arrays[f"loss/{i}"] = np.asarray(m["loss"])
    arrays[f"grad_norm/{i}"] = np.asarray(m["grad_norm"])
put("params", state["params"])
put("mom", state["opt"]["mom"])
arrays["step"] = np.asarray(state["opt"]["step"])

# the per-leaf fuse of the trained slabs, on the cold mesh and on a mesh
# without a contributor axis
for a in args["alphas"]:
    for mname in ("cold", "data_model"):
        f = jax.jit(make_fuse_step(cfg, meshes[mname], ColdSchedule(alpha=a), flat=False))
        put(f"fused/{mname}/{a}", f(state["params"]))
toy = {"w": jnp.stack([jnp.zeros((4,)), jnp.full((4,), 2.0)])}
toy_fuse = jax.jit(make_fuse_step(None, meshes["data_model"], ColdSchedule()))
arrays["toy"] = np.asarray(toy_fuse(toy)["w"])

# cohort_fuse_sharded read back as [C, S, L]
bufs = np.load(args["inputs"])
for case, (mname, contrib, shard, c, n) in args["cohort"].items():
    mesh = meshes[mname]
    n_shards = SH.axes_extent(mesh, shard) if shard else 1
    sp = ShardedFlatSpec.for_size(n, n_shards)
    spec = P(SH.axes_entry(contrib), SH.axes_entry(shard) if shard else None, None)
    stage = jax.device_put(sp.shard(jnp.asarray(bufs[f"cohort/{case}"])), NamedSharding(mesh, spec))
    for a in args["alphas"]:
        got = ops.cohort_fuse_sharded(stage, mesh=mesh, contrib_axes=tuple(contrib),
                                      shard_axes=tuple(shard), alpha=a)
        arrays[f"cohort/{case}/{a}"] = np.asarray(got)
json.dump(specs, open(out_json, "w"))
np.savez(out_npz, **arrays)
"""


def _cfg():
    cfg = reduce_config(get_config("gemma3-1b"), d_model=64)
    return dataclasses.replace(cfg, num_layers=2, pattern=cfg.pattern[:2])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference case in one subprocess on 8 forced CPU devices."""
    d = tmp_path_factory.mktemp("cold_mesh_ref")
    cfg = _cfg()
    rng = np.random.default_rng(11)
    inputs = {"tokens": rng.integers(3, cfg.vocab_size, (STEPS, C, B, S)).astype(np.int32)}
    for case, (_, _, _, c, n) in COHORT.items():
        inputs[f"cohort/{case}"] = rng.normal(size=(c, n)).astype(np.float32)
    np.savez(d / "in.npz", **inputs)
    args = dict(C=C, lr=LR, alphas=list(ALPHAS), batch=SPEC_SHAPES, cache=CACHE_SHAPES,
                cohort={k: [v[0], list(v[1]), list(v[2]), v[3], v[4]] for k, v in COHORT.items()},
                inputs=str(d / "in.npz"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env.pop("REPRO_OPT_MOE_SHARD", None)
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, json.dumps(args),
                           str(d / "specs.json"), str(d / "out.npz")], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(d / "out.npz") as out:
        arrays = dict(out)
    return json.load(open(d / "specs.json")), arrays, inputs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread, as in ``tests/test_torch_lm_train.py``:
    the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(arrays, prefix):
    """The reference's ``prefix/...`` arrays as a port tree of tensors."""
    return tree_from_paths([(k[len(prefix) + 1:], torch.from_numpy(v.copy()))
                            for k, v in sorted(arrays.items()) if k.startswith(prefix + "/")])


def _meshes():
    return {"cold": tmesh.make_cold_mesh(contributors=2, replicas=2, model=2, device="cpu"),
            "whole": tmesh.make_cold_mesh(contributors=2, replicas=1, model=1, device="cpu"),
            "model8": tmesh.make_mesh((8,), ("model",), device="cpu"),
            "contrib8": tmesh.make_mesh((8,), ("contrib",), device="cpu"),
            "data_model": tmesh.make_mesh((2, 4), ("data", "model"), device="cpu"),
            "model16": tmesh.make_mesh((16,), ("model",), device="cpu")}


# -- the sharding rules, all 11 archs at full width ---------------------------------------


def _meta_draw(*args, **kw):
    return torch.empty(args[0] if args else kw["size"], dtype=kw.get("dtype") or torch.float32,
                       device="meta")


@contextlib.contextmanager
def _meta_init():
    """The port's init functions with every random draw on the meta device:
    full-width trees as shapes only."""
    with torch.device("meta"), mock.patch.object(torch, "randn", _meta_draw), \
            mock.patch.object(torch, "rand", _meta_draw):
        yield


def _enc(tree):
    return {k: [list(e) if isinstance(e, tuple) else e for e in sh.spec]
            for k, sh in tree_leaves_with_path(tree)}


def _stacked(tree):
    return tree_map(lambda x: (C,) + tsh._shape(x), tree)


def _port_specs(arch, mname, mesh):
    base = get_config(arch)
    with _meta_init():
        gen = torch.Generator()
        params = (TW.init_whisper(base, gen, device="meta") if base.is_encoder_decoder
                  else TT.init_lm(base, gen, device="meta"))
        opts = {n: make_optimizer(n, constant_lr(1e-3)).init(params)
                for n in ("adamw", "adafactor")}
        caches = {n: (TW.init_whisper_cache(base, b, s, device="meta") if base.is_encoder_decoder
                      else TT.init_cache(base, b, s, device="meta"))
                  for n, (b, s) in CACHE_SHAPES.items()}
    ax = (dict(data_axis="replica", model_axis="model") if mname == "cold"
          else dict(data_axis=None, model_axis="model"))  # the model-only meshes
    specs = {}
    for lead in (("", "C") if mname == "cold" else ("",)):
        ca = ("contrib",) if lead else ()
        p = _stacked(params) if lead else params
        for fsdp in (0, 1):
            for moe in (0, 1):
                with mock.patch.object(tsh, "OPT_MOE_SHARD", bool(moe)):
                    cfg = dataclasses.replace(base, fsdp=bool(fsdp))
                    specs[f"{arch}|{mname}|params/fsdp{fsdp}/moe{moe}/{lead}"] = _enc(
                        tsh.params_shardings(mesh, p, cfg, contrib_axes=ca, **ax))
        with mock.patch.object(tsh, "OPT_MOE_SHARD", False):
            psh = tsh.params_shardings(mesh, p, base, contrib_axes=ca, **ax)
        for n, o in opts.items():
            specs[f"{arch}|{mname}|opt/{n}/{lead}"] = _enc(
                tsh.opt_state_shardings(mesh, _stacked(o) if lead else o, psh))
        for sname, (b, s) in SPEC_SHAPES.items():
            batch = {"tokens": (b, s), "mask": (b, s)}
            if base.rope.kind == "mrope":
                batch["positions"] = (3, b, s)
            if base.family == "vlm" and base.num_frontend_tokens:
                batch["extra_embeds"] = (b, base.num_frontend_tokens, base.d_model)
            if base.is_encoder_decoder:
                batch["frames"] = (b, base.encoder_seq, base.d_model)
            specs[f"{arch}|{mname}|batch/{sname}/{lead}"] = _enc(tsh.batch_shardings(
                mesh, _stacked(batch) if lead else batch, contrib_axes=ca, **ax))
        for cname, cache in caches.items():
            specs[f"{arch}|{mname}|cache/{cname}/{lead}"] = _enc(tsh.cache_shardings(
                mesh, _stacked(cache) if lead else cache, base, contrib_axes=ca, **ax))
    return specs


@pytest.mark.parametrize("mname", ["cold", "model8", "model16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_rules_match_the_reference(ref, arch, mname):
    """Every leaf's spec: params (fsdp off and on, REPRO_OPT_MOE_SHARD 0 and
    1), AdamW and adafactor state, batches and caches, each also stacked
    for the contributor axis on the cold mesh.  The (16,) mesh is where
    mixtral's 8 experts do not divide the model axis, so the lever acts."""
    specs = ref[0]
    got = _port_specs(arch, mname, _meshes()[mname])
    want = {k: v for k, v in specs.items() if k.startswith(f"{arch}|{mname}|")}
    assert sorted(got) == sorted(want) and len(got) >= 10
    for key in want:
        assert got[key] == want[key], key
    if mname == "model16" and arch == "mixtral-8x7b":
        key = f"{arch}|{mname}|params/fsdp0"
        assert got[f"{key}/moe1/"] != got[f"{key}/moe0/"]
    if mname == "cold":  # the stacked step replicates, as the reference's opt/step does
        assert got[f"{arch}|cold|opt/adamw/C"]["step"] == []


def test_partition_spec_and_placement():
    P = tsh.PartitionSpec
    assert P(("contrib",), None, ("replica", "model"), ()) == ("contrib", None,
                                                             ("replica", "model"), None)
    assert P("a") != P("a", None) and P() == () and tsh.axes_entry(("x",)) == "x"
    assert tsh.axes_entry(("x", "y")) == ("x", "y") and tsh.replicated(_meshes()["cold"]).spec == ()
    mesh = _meshes()["whole"]  # a slab's sub-grid of one slot: slabs stay whole
    sh = tsh.NamedSharding(mesh, P("contrib", "model", None))
    x = torch.arange(24.0).reshape(2, 3, 4)
    placed = sh.place(x)
    assert isinstance(placed, list) and len(placed) == 2
    assert all(torch.equal(p, x[c]) for c, p in enumerate(placed))
    assert sh.slab_devices(4) == [torch.device("cpu")] * 4 and sh.contrib_axes == ("contrib",)
    whole = tsh.NamedSharding(mesh, P(None, "model")).place(x)
    assert isinstance(whole, torch.Tensor) and torch.equal(whole, x)
    # on (2, 2, 2) each slab splits into blocks over its replica x model slots
    mesh = _meshes()["cold"]
    x = torch.arange(32.0).reshape(2, 4, 4)
    placed = tsh.NamedSharding(mesh, P("contrib", "model", None)).place(x)
    assert all(isinstance(p, Placed) for p in placed)
    assert [tuple(b.shape) for b in placed[1].slot_blocks()] == [(2, 4)] * 4
    assert torch.equal(placed[1].block(3), x[1, 2:]) and len(placed[1].blocks) == 2
    assert torch.equal(tsh.gather(placed)[1], x[1])
    blocks = tsh.NamedSharding(mesh, P(None, "model")).place(x[0])
    assert isinstance(blocks, Placed) and torch.equal(blocks.block(1), x[0][:, 2:])
    with pytest.raises(ValueError, match="does not split"):
        tsh.NamedSharding(mesh, P("contrib", "model", None)).place(
            torch.arange(24.0).reshape(2, 3, 4))
    with pytest.raises(ValueError, match="do not split"):
        sh.slab_devices(3)
    with pytest.raises(ValueError, match="leading one"):
        tsh.NamedSharding(mesh, P(None, "contrib")).place(x)
    with pytest.raises(ValueError, match="does not match"):
        tsh.device_put({"a": x}, {"b": sh})
    # a tagged mesh: slab c on contributor slot g = c // (C/G), at index g % R
    # of the slot's R = 4 replica x model slots
    tagged = tmesh.Mesh(np.arange(8, dtype=object).reshape(2, 2, 2),
                        ("contrib", "replica", "model"))
    assert tsh.NamedSharding(tagged, P("contrib")).slab_devices(4) == [0, 0, 5, 5]
    assert tsh.contrib_slot_devices(tagged, "contrib") == (0, 5)
    assert tsh.flat_row_sharding(tagged, ("contrib", "replica", "model")) == tuple(range(8))
    pod = tmesh.Mesh(np.arange(16, dtype=object).reshape(2, 2, 2, 2),
                     ("pod", "contrib", "replica", "model"))
    assert tsh.contrib_slot_devices(pod, ("pod", "contrib")) == (0, 5, 10, 15)


@pytest.mark.parametrize("cards", [1, 2, 4, 8])
def test_contributor_slots_spread_over_the_cards(cards):
    """``make_mesh``'s round-robin layout of a (2, 2, 2) cold mesh over
    ``cards`` cards (tagged, no card needed): the two contributor slots'
    slabs land on two cards wherever there are two."""
    grid = np.empty(8, dtype=object)
    grid[:] = [torch.device("cuda", i % cards) for i in range(8)]
    mesh = tmesh.Mesh(grid.reshape(2, 2, 2), ("contrib", "replica", "model"))
    devs = tsh.NamedSharding(mesh, tsh.P("contrib", "model")).slab_devices(2)
    assert devs[0] == torch.device("cuda", 0) == mesh.devices.flat[0]
    assert devs[1] == torch.device("cuda", 5 % cards)
    assert (devs[0] != devs[1]) == (cards > 1)


def test_fuse_step_default_path_is_per_leaf(ref):
    """``make_fuse_step`` fuses per leaf by default (the reference's
    default is flat): one all-reduce a leaf, no gather, the same bits as
    ``flat=False``."""
    _, arrays, _ = ref
    cfg, mesh = _cfg(), _meshes()["cold"]
    sh = tsh.params_shardings(mesh, _trained(arrays), cfg, data_axis="replica",
                              model_axis="model", contrib_axes=("contrib",))
    params = tsh.device_put(_trained(arrays), sh)
    tmesh.reset_collectives()
    got = D.make_fuse_step(cfg, mesh, D.ColdSchedule(alpha=0.3))(params)
    n_leaves = len(tree_leaves_with_path(params))
    assert tmesh.collectives == {"all_reduce": n_leaves, "all_gather": 0, "reduce_scatter": 0}
    want = dict(tree_leaves_with_path(tsh.gather(
        D.make_fuse_step(cfg, mesh, D.ColdSchedule(alpha=0.3), flat=False)(params))))
    for k, v in tree_leaves_with_path(tsh.gather(got)):
        assert all(torch.equal(a, b) for a, b in zip(v, want[k])), k


# -- the cold step ----------------------------------------------------------------------


def _sgd():
    return make_optimizer("sgd", constant_lr(LR), momentum=0.9)


def _close(got, want, rtol, atol):
    g, w = dict(tree_leaves_with_path(got)), dict(tree_leaves_with_path(want))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k].float().numpy(), w[k].float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("placed", [False, True, "partitioned"],
                         ids=["stacked", "placed", "partitioned"])
def test_cold_step_matches_the_reference_vmap(ref, placed):
    """Stacked, placed whole on a (2, 1, 1) mesh (no collective), and
    partitioned on (2, 2, 2) (no collective over ``contrib``)."""
    _, arrays, inputs = ref
    cfg, opt = _cfg(), _sgd()
    mesh = _meshes()["cold" if placed == "partitioned" else "whole"]
    state = D.stack_for_contributors(make_train_state(_tree(arrays, "init"), opt), C)
    assert state["opt"]["step"].dtype == torch.int32 and state["opt"]["step"].shape == (C,)
    step = D.make_cold_train_step(cfg, opt)
    tmesh.reset_collectives()
    for i in range(STEPS):
        batch = {"tokens": inputs["tokens"][i]}
        if placed:
            state_sh, batch_sh = D.cold_shardings(mesh, cfg, state, batch)
            state, batch = tsh.device_put(state, state_sh), tsh.device_put(batch, batch_sh)
            assert isinstance(state["params"]["embed"], list)
            assert isinstance(state["opt"]["step"], torch.Tensor)  # P(): whole, with slab 0
        state, m = step(state, batch)
        np.testing.assert_allclose(m["loss"].numpy(), arrays[f"loss/{i}"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].numpy(), arrays[f"grad_norm/{i}"], rtol=1e-5)
    if placed == "partitioned":
        assert tmesh.collectives["all_reduce"] > 0 and "contrib" not in tmesh.collectives_by_axis
    else:
        assert tmesh.collectives == {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}
    restack = (lambda t: tree_map(torch.stack, tsh.gather(t))) if placed else (lambda t: t)
    _close(restack(state["params"]), _tree(arrays, "params"), 1e-5, 1e-5)
    _close(restack(state["opt"]["mom"]), _tree(arrays, "mom"), 1e-4, 1e-5)
    assert state["opt"]["step"].tolist() == arrays["step"].tolist() == [STEPS] * C


@pytest.mark.parametrize("microbatches", [1, 2])
def test_cold_step_equals_the_plain_step_per_slab(microbatches):
    """AdamW (its step counter stacked as the reference's int32 [C]): each
    slab equals the port's plain ``make_train_step`` on its own batches,
    bit for bit, and the slabs diverge."""
    cfg = _cfg()
    opt = make_optimizer("adamw", constant_lr(3e-3))
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(3).integers(3, cfg.vocab_size, (STEPS, C, B, S))
    mesh = _meshes()["whole"]
    state = D.stack_for_contributors(make_train_state(params, opt), C)
    state_sh, batch_sh = D.cold_shardings(mesh, cfg, state, {"tokens": toks[0]})
    state = tsh.device_put(state, state_sh)
    cold = D.make_cold_train_step(cfg, opt, microbatches=microbatches)
    plain = make_train_step(cfg, opt, microbatches=microbatches)
    for i in range(STEPS):
        state, _ = cold(state, tpipe.shard_batch({"tokens": toks[i]}, batch_sh["tokens"]))
    for c in range(C):
        alone = make_train_state(params, opt)
        for i in range(STEPS):
            alone, _ = plain(alone, {"tokens": toks[i, c]})
        got = D.slab(state, c)
        assert got["opt"]["step"] == alone["opt"]["step"] == STEPS
        for part in ("params", "opt"):
            want = dict(tree_leaves_with_path(alone[part]))
            for k, v in tree_leaves_with_path(got[part]):
                assert (torch.equal(v, want[k]) if isinstance(v, torch.Tensor)
                        else v == want[k]), (part, k)
    e = state["params"]["embed"]
    assert (e[0] - e[1]).abs().max() > 0


@pytest.mark.parametrize("microbatches", [1, 2])
def test_cold_step_partitioned_adamw_per_slab(microbatches):
    """The same AdamW cold step with each slab partitioned over (2, 2): the
    first step's losses equal the plain step's on the same slab within
    1e-5 relative (its params are the same), every step stays finite, the
    slabs diverge and no collective crosses ``contrib``.  AdamW's later
    steps are not compared: g / (|g| + eps) amplifies a last-bit gradient
    difference near eps (ROADMAP.md §C); SGD steps are held against the
    reference in ``tests/test_torch_partitioned.py``."""
    cfg = _cfg()
    opt = make_optimizer("adamw", constant_lr(3e-3))
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(3).integers(3, cfg.vocab_size, (STEPS, C, B, S))
    mesh = _meshes()["cold"]
    state = D.stack_for_contributors(make_train_state(params, opt), C)
    state_sh, batch_sh = D.cold_shardings(mesh, cfg, state, {"tokens": toks[0]})
    state = tsh.device_put(state, state_sh)
    cold = D.make_cold_train_step(cfg, opt, microbatches=microbatches)
    plain = make_train_step(cfg, opt, microbatches=microbatches)
    tmesh.reset_collectives()
    for i in range(STEPS):
        state, m = cold(state, tpipe.shard_batch({"tokens": toks[i]}, batch_sh["tokens"]))
        assert torch.isfinite(m["loss"]).all() and torch.isfinite(m["grad_norm"]).all()
        if i == 0:
            for c in range(C):
                _, pm = plain(make_train_state(params, opt), {"tokens": toks[0, c]})
                np.testing.assert_allclose(float(m["loss"][c]), float(pm["loss"]), rtol=1e-5)
    assert "contrib" not in tmesh.collectives_by_axis
    assert state["opt"]["step"].tolist() == [STEPS] * C
    e = tsh.gather(state["params"]["embed"])
    assert (e[0] - e[1]).abs().max() > 0


# -- the fuse ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("case", sorted(COHORT))
def test_cohort_fuse_sharded_matches_the_reference(ref, case, alpha):
    _, arrays, inputs = ref
    mname, contrib, shard, c, n = COHORT[case]
    mesh = _meshes()[mname]
    n_shards = tsh.axes_extent(mesh, shard) if shard else 1
    sp = tflat.ShardedFlatSpec.for_size(n, n_shards)
    stage = sp.shard(torch.from_numpy(inputs[f"cohort/{case}"]))
    tmesh.reset_collectives()
    got = tops.cohort_fuse_sharded(tflat.StagedBuffer(stage), mesh=mesh, contrib_axes=contrib,
                                   shard_axes=shard, alpha=alpha)
    assert tmesh.collectives == {"all_reduce": 1, "all_gather": 0, "reduce_scatter": 0}
    G = tsh.axes_extent(mesh, contrib)
    L = sp.shard_len
    assert tmesh.collective_bytes["all_reduce"] == 2 * (G - 1) * n_shards * L * 4
    out = torch.stack([torch.stack(row) for row in got]).numpy()
    assert out.shape == (c, n_shards, L)
    want = arrays[f"cohort/{case}/{alpha}"]
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-7)
    # the closed form, and the slabs equal at alpha 1
    buf = inputs[f"cohort/{case}"].astype(np.float64)
    closed = buf * (1 - alpha) + buf.mean(0, keepdims=True) * alpha
    np.testing.assert_allclose(sp.unshard(torch.from_numpy(out)).numpy(), closed, atol=1e-6)
    if alpha == 1.0:
        assert all(np.array_equal(out[0], out[k]) for k in range(c))
    # the same stage as C slabs of [S, L], and of S [L] blocks
    for form in (list(stage.unbind(0)), [list(x.unbind(0)) for x in stage]):
        again = tops.cohort_fuse_sharded(form, mesh=mesh, contrib_axes=contrib, shard_axes=shard,
                                         alpha=alpha)
        assert np.array_equal(torch.stack([torch.stack(r) for r in again]).numpy(), out)


def test_cohort_fuse_sharded_refuses_a_stage_that_does_not_fit():
    mesh = _meshes()["cold"]
    with pytest.raises(ValueError, match="does not fit"):
        tops.cohort_fuse_sharded(torch.zeros(3, 4, 128), mesh=mesh, contrib_axes="contrib",
                                 shard_axes=("replica", "model"))
    with pytest.raises(ValueError, match="does not fit"):
        tops.cohort_fuse_sharded(torch.zeros(2, 2, 128), mesh=mesh, contrib_axes="contrib",
                                 shard_axes=("replica", "model"))


def _trained(arrays):
    """The reference's trained [C, ...] params (the slabs differ)."""
    return _tree(arrays, "params")


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("flat", [True, False], ids=["flat", "per_leaf"])
@pytest.mark.parametrize("placed", [False, True, "partitioned"],
                         ids=["stacked", "placed", "partitioned"])
def test_fuse_step_matches_the_reference_per_leaf_path(ref, placed, flat, alpha):
    """Stacked, placed whole on a (2, 1, 1) mesh, and partitioned on
    (2, 2, 2), where the flat path gathers each slab to its home first."""
    _, arrays, _ = ref
    cfg, mesh = _cfg(), _meshes()["cold" if placed == "partitioned" else "whole"]
    params = _trained(arrays)
    assert (params["embed"][0] - params["embed"][1]).abs().max() > 0
    if placed:
        sh = tsh.params_shardings(mesh, params, cfg, data_axis="replica", model_axis="model",
                                  contrib_axes=("contrib",))
        params = tsh.device_put(params, sh)
    tmesh.reset_collectives()
    fused = D.make_fuse_step(cfg, mesh, D.ColdSchedule(alpha=alpha), flat=flat)(params)
    n_leaves = len(tree_leaves_with_path(params))
    gathers = 2 * C if placed == "partitioned" else C
    if flat:  # one all-reduce over the contributor axis; each slab gathered to its slot
        assert tmesh.collectives == {"all_reduce": 1, "all_gather": gathers, "reduce_scatter": 0}
    else:  # one all-reduce a leaf across placed slabs, none within one tensor
        assert tmesh.collectives == {"all_reduce": n_leaves if placed else 0, "all_gather": 0,
                                     "reduce_scatter": 0}
    assert isinstance(fused["embed"], list) == bool(placed)
    assert isinstance(fused["embed"][0], Placed) == (placed == "partitioned")
    stacked = tree_map(torch.stack, tsh.gather(fused)) if placed else fused
    _close(stacked, _tree(arrays, f"fused/cold/{alpha}"), 1e-6, 1e-7)
    # every path and form gives the same bits at C = 2
    other = D.make_fuse_step(cfg, mesh, D.ColdSchedule(alpha=alpha), flat=not flat)(
        _trained(arrays))
    for k, v in tree_leaves_with_path(stacked):
        assert torch.equal(v, dict(tree_leaves_with_path(other))[k]), k
    if alpha == 1.0:
        assert torch.equal(stacked["embed"][0], stacked["embed"][1])


def test_fuse_step_without_a_contributor_axis(ref):
    """``flat=True`` on a ("data", "model") mesh takes the per-leaf path
    (``tests/test_flat_engine.py``'s case), with no collective."""
    _, arrays, _ = ref
    mesh = _meshes()["data_model"]
    tmesh.reset_collectives()
    toy = {"w": torch.stack([torch.zeros(4), torch.full((4,), 2.0)])}
    got = D.make_fuse_step(None, mesh, D.ColdSchedule(), flat=True)(toy)["w"]
    np.testing.assert_array_equal(got.numpy(), arrays["toy"])
    for alpha in ALPHAS:
        fused = D.make_fuse_step(_cfg(), mesh, D.ColdSchedule(alpha=alpha), flat=True)(
            _trained(arrays))
        _close(fused, _tree(arrays, f"fused/data_model/{alpha}"), 1e-6, 1e-7)
    assert tmesh.collectives == {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}
    assert D.contrib_axes_of(mesh) == () and D.num_contributors(mesh) == 1
    cold = _meshes()["cold"]
    assert D.contrib_axes_of(cold) == ("contrib",) and D.shard_axes_of(cold) == ("replica", "model")
    assert D.num_contributors(cold) == 2


# -- the rest: shard_batch, the mesh's byte counts, grad_shardings ----------------------


def test_shard_batch_places_contributor_slabs():
    mesh = _meshes()["whole"]
    toks = np.arange(2 * 4 * 3, dtype=np.int32).reshape(2, 4, 3)
    batch = {"tokens": toks, "mask": np.ones((2, 4, 3), np.float32)}
    _, bsh = D.cold_shardings(mesh, _cfg(), {"params": {}, "opt": {}}, batch)
    assert tuple(bsh["tokens"].spec) == ("contrib", "replica", None)
    out = tpipe.shard_batch(batch, bsh["tokens"])
    cold = tpipe.shard_batch(batch, D.cold_shardings(_meshes()["cold"], _cfg(),
                                                     {"params": {}, "opt": {}}, batch)[1]["tokens"])
    for k, v in cold.items():  # on (2, 2, 2): each slab's rows split over replica
        for c in range(2):
            assert isinstance(v[c], Placed)
            for s in range(4):
                r = s // 2
                np.testing.assert_array_equal(v[c].block(s).numpy(), batch[k][c][2 * r:2 * r + 2])
    assert sorted(out) == ["mask", "tokens"]
    for k, v in out.items():
        assert isinstance(v, list) and len(v) == 2
        for c in range(2):
            np.testing.assert_array_equal(v[c].numpy(), batch[k][c])
    whole = tpipe.shard_batch(batch, tsh.replicated(mesh))
    assert isinstance(whole["tokens"], torch.Tensor) and whole["tokens"].shape == (2, 4, 3)
    np.testing.assert_array_equal(whole["tokens"].numpy(), toks)


def test_collective_byte_counts():
    mesh = tmesh.make_mesh((4,), ("model",), device="cpu")
    parts = [torch.full((5,), float(i)) for i in range(4)]
    tmesh.reset_collectives()
    tmesh.all_reduce_sum(parts, mesh)
    tmesh.all_gather(parts, mesh)
    assert tmesh.collective_bytes == {"all_reduce": 3 * 20, "all_gather": 3 * 20,
                                      "reduce_scatter": 0}
    tmesh.reset_collectives()
    groups = [[torch.full((5,), float(g + s)) for s in range(3)] for g in range(2)]
    out = tmesh.all_reduce_over(groups)
    assert tmesh.collectives == {"all_reduce": 1, "all_gather": 0, "reduce_scatter": 0}
    assert tmesh.collective_bytes["all_reduce"] == 3 * 2 * 1 * 20
    assert [[x.tolist() for x in row] for row in out] == [[[2.0 * s + 1] * 5 for s in range(3)]] * 2
    with pytest.raises(ValueError):
        tmesh.all_reduce_over([[torch.zeros(1)], []])


def test_grad_shardings_pin_nothing_and_check_the_tree():
    """A microbatched step with ``grad_shardings`` equals the step without
    it bit for bit, also with replicated or short specs; a tree of another
    structure, a spec longer than its rank or another device raises."""
    cfg = _cfg()
    opt = _sgd()
    mesh = tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")  # leaves stay whole
    params = TT.init_lm(cfg, torch.Generator().manual_seed(1), device="cpu")
    psh = tsh.params_shardings(mesh, params, cfg)
    toks = np.random.default_rng(4).integers(3, cfg.vocab_size, (B, S))
    state = make_train_state(tsh.device_put(params, psh), opt)
    want, wm = make_train_step(cfg, opt, microbatches=2)(state, {"tokens": toks})
    got, gm = make_train_step(cfg, opt, microbatches=2, grad_shardings=psh)(state, {"tokens": toks})
    assert float(gm["loss"]) == float(wm["loss"])
    for part in ("params", "opt"):
        w = dict(tree_leaves_with_path(want[part]))
        for k, v in tree_leaves_with_path(got[part]):
            assert torch.equal(v, w[k]) if isinstance(v, torch.Tensor) else v == w[k]
    # a spec shorter than its gradient's rank is padded with None, as in JAX
    short = dict(psh, embed=tsh.NamedSharding(mesh, tsh.P("model")))
    for ok in (tree_map(lambda _: tsh.replicated(mesh), psh), short):
        again, _ = make_train_step(cfg, opt, microbatches=2, grad_shardings=ok)(
            state, {"tokens": toks})
        assert torch.equal(again["params"]["embed"], want["params"]["embed"])
    too_long = dict(psh, embed=tsh.NamedSharding(mesh, tsh.P("model", None, None)))
    for bad in ({}, {**psh, "extra": tsh.replicated(mesh)}, too_long):
        step = make_train_step(cfg, opt, grad_shardings=bad)
        with pytest.raises(ValueError, match="grad_shardings"):
            step(state, {"tokens": toks})


def test_grad_shardings_check_placed_leaves():
    """On a (2, 4) ("data", "model") mesh the params are placed in blocks:
    the partitioned step with ``grad_shardings`` equals the step without it
    bit for bit, a short spec is padded; a sharding that names another
    spec than a leaf's placement (``replicated(mesh)`` for a split leaf),
    a spec longer than its rank or another tree raises."""
    cfg, opt = _cfg(), _sgd()
    mesh = _meshes()["data_model"]
    params = TT.init_lm(cfg, torch.Generator().manual_seed(1), device="cpu")
    psh = tsh.params_shardings(mesh, params, cfg)
    toks = np.random.default_rng(4).integers(3, cfg.vocab_size, (B, S))
    state = make_train_state(tsh.device_put(params, psh), opt)
    assert isinstance(state["params"]["embed"], Placed)
    want, wm = make_train_step(cfg, opt, microbatches=2)(state, {"tokens": toks})
    short = dict(psh, embed=tsh.NamedSharding(mesh, tsh.P("model")))
    for ok in (psh, short):
        got, gm = make_train_step(cfg, opt, microbatches=2, grad_shardings=ok)(
            state, {"tokens": toks})
        assert float(gm["loss"]) == float(wm["loss"])
        w = dict(tree_leaves_with_path(tsh.gather(want["params"])))
        for k, v in tree_leaves_with_path(tsh.gather(got["params"])):
            assert torch.equal(v, w[k]), k
    too_long = dict(psh, embed=tsh.NamedSharding(mesh, tsh.P("model", None, None)))
    for bad in (tree_map(lambda _: tsh.replicated(mesh), psh), {}, too_long):
        step = make_train_step(cfg, opt, grad_shardings=bad)
        with pytest.raises(ValueError, match="grad_shardings"):
            step(state, {"tokens": toks})
