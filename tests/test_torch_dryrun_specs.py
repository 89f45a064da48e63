"""The port's dry-run tooling against the JAX package's, on the CPU:
``launch.specs`` (input, parameter, state and cache specs and
``auto_microbatches``) against the reference's ``jax.eval_shape`` trees for
all 11 archs at every input shape each is eligible for, ``utils.roofline``
against ``repro.utils.roofline``, the reference's eligibility and mesh
constants, and ``launch.dryrun``'s CLI on gemma3-1b ``train_4k`` over the
``cold8x2`` mesh, whose argument bytes a slot are held against the
reference's committed artifact and, leaf by leaf, against the reference's
own ``cold_shardings`` on an abstract mesh.

Tolerances: specs are equal path for path, shape and dtype; the roofline's
terms equal the reference's once rescaled by the constants' ratio (1e-12
relative); argument bytes a slot within 0.5 % of the artifact's
625,717,536, every leaf equal."""
import ast
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.core import distributed as JD
from repro.launch import specs as JS
from repro.optim.optimizers import constant_lr as jconstant_lr
from repro.optim.optimizers import make_optimizer as jmake_optimizer
from repro.utils import roofline as JR
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import distributed as D
from repro_torch.launch import dryrun as TD
from repro_torch.launch import specs as TS
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.utils import roofline as TR
from repro_torch.utils.flat import ShardedFlatSpec
from repro_torch.utils.pytree import tree_leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_ARTIFACT = os.path.join(ROOT, "artifacts", "dryrun", "gemma3-1b__train_4k__cold8x2__cold.json")
DP_SIZES = (1, 16, 32, 256)


def _jtree(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): (tuple(x.shape), str(jnp.dtype(x.dtype)))
            for path, x in leaves}


def _ttree(tree):
    out = {}
    for name, leaf in tree_leaves_with_path(tree):
        shape, dtype = TS.leaf_spec(leaf)
        out[name] = (shape, str(dtype).removeprefix("torch."))
    return out


def _eligible_shapes(arch):
    return [s for s in SHAPES if TD.eligible(arch, SHAPES[s])]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch):
    assert tuple(JARCH_IDS) == tuple(ARCH_IDS) and list(JSHAPES) == list(SHAPES)
    cfg, jcfg = get_config(arch), jget_config(arch)
    opt = make_optimizer(cfg.optimizer, constant_lr(1e-4))
    jopt = jmake_optimizer(jcfg.optimizer, jconstant_lr(1e-4))
    # abstract_state's params are abstract_params' tree (one eval_shape less)
    state, jstate = TS.abstract_state(cfg, opt), JS.abstract_state(jcfg, jopt)
    assert _ttree(state) == _jtree(jstate)
    assert _ttree(TS.abstract_params(cfg)) == _jtree(jstate["params"])
    assert all(x.is_meta for _, x in tree_leaves_with_path(state) if isinstance(x, torch.Tensor))
    for name in _eligible_shapes(arch):
        shape, jshape = SHAPES[name], JSHAPES[name]
        assert _ttree(TS.input_specs(cfg, shape)) == _jtree(JS.input_specs(jcfg, jshape)), name
        assert _ttree(TS.abstract_cache(cfg, shape)) == _jtree(JS.abstract_cache(jcfg, jshape)), \
            name
        for dp in DP_SIZES:
            assert TS.auto_microbatches(cfg, shape, dp) == JS.auto_microbatches(jcfg, jshape, dp)


def test_eligibility_and_mesh_constants_match_reference():
    """Read from the reference's module source: importing it forces 512 fake
    host devices into the environment."""
    tree = ast.parse(open(os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")).read())
    consts = {t.id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name) and t.id in ("LONG_CTX_ARCHS", "MODEL_AXIS")}
    assert consts == {"LONG_CTX_ARCHS": TD.LONG_CTX_ARCHS, "MODEL_AXIS": TD.MODEL_AXIS}
    mesh = TD._mesh("cold8x2")
    assert dict(mesh.shape) == {"contrib": 8, "replica": 2, "model": 16}
    assert {d.type for d in mesh.devices.flat} == {"meta"}
    assert TD._dp_size(TD._mesh("pod2")) == 32 and TD._dp_size(mesh) == 16


ROOF_CASES = [
    (4.8e14, 6.6e12, 0.0, 3.9e14, 256, "bfloat16"),
    (3.1e12, 9.0e10, 3.4e8, 3.0e12, 1, "float32"),
    (1.0e9, 5.0e12, 8.0e11, 0.0, 16, "bfloat16"),
    (0.0, 0.0, 0.0, 0.0, 1, "float32"),
]


@pytest.mark.parametrize("flops,hbm,coll,model,chips,dtype", ROOF_CASES)
def test_roofline_matches_reference(flops, hbm, coll, model, chips, dtype):
    mine = TR.Roofline(flops, hbm, coll, model, chips, dtype=dtype)
    ref = JR.Roofline(flops, hbm, coll, model, chips)
    peak = TR.peak_flops(dtype)
    assert mine.peak == {"bfloat16": 989e12, "float32": 67e12}[dtype]
    assert mine.compute_s * peak / JR.PEAK_FLOPS == pytest.approx(ref.compute_s, rel=1e-12)
    assert mine.memory_s * TR.HBM_BW / JR.HBM_BW == pytest.approx(ref.memory_s, rel=1e-12)
    assert mine.collective_s * TR.NVLINK_BW / JR.ICI_BW == pytest.approx(ref.collective_s,
                                                                        rel=1e-12)
    assert mine.useful_flops_ratio == ref.useful_flops_ratio
    if ref.step_time_s:
        assert mine.mfu * mine.step_time_s * peak == pytest.approx(
            ref.mfu * ref.step_time_s * JR.PEAK_FLOPS, rel=1e-12)
    assert set(ref.as_dict()) <= set(mine.as_dict())
    for training in (True, False):
        assert TR.model_flops_per_step(123_456, 789, training=training) == \
            JR.model_flops_per_step(123_456, 789, training=training)


def _ref_slot_bytes():
    """Per leaf, the bytes a slot holds of the reference's cold state and
    batch, by its own ``cold_shardings`` on an abstract (8, 2, 16) mesh."""
    cfg = dataclasses.replace(jget_config("gemma3-1b"), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    shape = JSHAPES["train_4k"]
    mesh = AbstractMesh((8, 2, 16), ("contrib", "replica", "model"))
    opt = jmake_optimizer(cfg.optimizer, jconstant_lr(1e-4))
    state = jax.tree.map(lambda x: jax.ShapeDtypeStruct((8,) + x.shape, x.dtype),
                         JS.abstract_state(cfg, opt))
    batch = {k: jax.ShapeDtypeStruct((8, v.shape[0] // 8) + v.shape[1:], v.dtype)
             for k, v in JS.input_specs(cfg, shape).items()}
    state_sh, batch_sh = JD.cold_shardings(mesh, cfg, state, batch)
    out = {}
    for prefix, tree, shs in (("state", state, state_sh), ("batch", batch, batch_sh)):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        specs = jax.tree_util.tree_leaves(shs, is_leaf=lambda x: hasattr(x, "spec"))
        for (path, x), sh in zip(leaves, specs):
            split = 1
            for entry in sh.spec:
                for a in ((entry,) if isinstance(entry, str) else (entry or ())):
                    split *= mesh.shape[a]
            name = prefix + "/" + "/".join(str(k.key) for k in path)
            out[name] = int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize // split
    return out


def _port_slot_bytes():
    cfg = TD._dry_cfg(get_config("gemma3-1b"))
    mesh = TD._mesh("cold8x2")
    opt = make_optimizer(cfg.optimizer, constant_lr(1e-4))
    state = D.stack_for_contributors(TS.abstract_state(cfg, opt), 8)
    batch = {k: torch.empty((8, v.shape[0] // 8) + tuple(v.shape[1:]), dtype=v.dtype,
                            device="meta")
             for k, v in TS.input_specs(cfg, SHAPES["train_4k"]).items()}
    state_sh, batch_sh = D.cold_shardings(mesh, cfg, state, batch)
    out = {}
    for prefix, tree, shs in (("state", state, state_sh), ("batch", batch, batch_sh)):
        sh = dict(tree_leaves_with_path(shs))
        for name, x in tree_leaves_with_path(tree):
            out[f"{prefix}/{name}"] = TD.slot_bytes({"x": x}, {"x": sh[name]}, mesh)
    return out


def test_dryrun_cli_cold_gemma(tmp_path, monkeypatch, capsys):
    """The CLI on gemma3-1b train_4k over cold8x2, on the CPU: the
    reference's roofline keys, ``"partitioned": true`` (one slab's
    partitioned local step traced on its (replica 2, model 16) grid, 16
    rows a slot in 16 microbatches; the trace cut to 1 of the 26 layers,
    whose full depth costs minutes on the meta device), the fuse's one
    all-reduce, and argument bytes a slot as the reference's."""
    monkeypatch.setattr(TD, "ARTIFACT_DIR", TD.ARTIFACT_DIR)
    real = TD.trace_step
    monkeypatch.setattr(TD, "trace_step", lambda cfg, *a, **k: real(
        dataclasses.replace(cfg, num_layers=1, pattern=cfg.pattern[:1]), *a, **k))
    assert TD.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--strategy", "cold",
                    "--cold-mesh", "8x2", "--out", str(tmp_path), "--force"]) == 0
    assert "-> memory" in capsys.readouterr().out
    got = json.load(open(tmp_path / "gemma3-1b__train_4k__cold8x2__cold.json"))
    ref = json.load(open(REF_ARTIFACT))
    assert got["ok"] and got["partitioned"] is True and got["strategy"] == "cold"
    assert set(ref["roofline"]) <= set(got["roofline"])
    assert set(ref["memory_analysis"]) <= set(got["memory_analysis"])
    assert got["mesh_shape"] == ref["mesh_shape"] and got["chips"] == ref["chips"]
    assert got["microbatches"] == ref["microbatches"] == 16
    assert got["traced"]["rows_a_slot"] == 16 and got["traced"]["trips"] == 16
    assert got["traced"]["grid"] == {"replica": 2, "model": 16} == got["traced"]["slab_grid"]
    assert set(got["collectives"]["by_axis"]) == {"replica", "model"}
    fuse = got["fuse"]["collectives"]
    assert fuse["count_by_kind"]["all-reduce"] == 1
    n = sum(int(np.prod(s)) for s, _ in _ttree(TS.abstract_params(
        TD._dry_cfg(get_config("gemma3-1b")))).values())
    n_pad = ShardedFlatSpec.for_size(n, 2 * 16).padded_size
    assert fuse["bytes_by_kind"]["all-reduce"] == 2 * (8 - 1) * n_pad * 4
    want = ref["memory_analysis"]["argument_size_in_bytes"]
    args = got["memory_analysis"]["argument_size_in_bytes"]
    mine, theirs = _port_slot_bytes(), _ref_slot_bytes()
    differ = sorted(k for k in set(mine) | set(theirs) if mine.get(k) != theirs.get(k))
    assert not differ, f"leaves whose bytes a slot differ: {differ[:10]}"
    assert args == sum(mine.values())
    assert abs(args - want) <= 0.005 * want, (args, want)


# each arch's layers in these traces (the whole 26, 72 and 32 cost tens of seconds to
# minutes on the meta grid): gemma3-1b's first two, jamba's first Mamba layer and its
# first attention layer (both with the GLU FFN: a MoE layer widens the traced grid to 8
# data slots, ``test_torch_dryrun_partitioned.py``), rwkv6-7b's first
LAYERS = {"gemma3-1b": (0, 1), "jamba-1.5-large-398b": (0, 4), "rwkv6-7b": (0,)}


@pytest.mark.parametrize("arch,shape,entries", [
    ("gemma3-1b", "decode_32k", {"flash_attention": {"decode": 2, "decode_combine": 2}}),
    ("gemma3-1b", "prefill_32k", {"flash_attention": {"prefill_tc": 2}}),
    ("jamba-1.5-large-398b", "decode_32k", {"flash_attention": {"decode": 1},
                                            "mamba_scan": {"forward": 1}}),
    ("rwkv6-7b", "long_500k", {"rwkv6_scan": {"step": 1}}),
])
def test_dryrun_inference_kinds(arch, shape, entries, monkeypatch):
    """A serve and a prefill step of the partitioned program traced on the
    meta grid (``LAYERS``): each kernel booked once a layer and slot on the
    route the card takes, the Mamba scan by formula; rows a slot the
    grid's (B / 16 on a sub-grid of 2 data slots; the one long_500k
    sequence whole on every slot of the full grid traced)."""
    real = TD.get_config

    def cut(a):
        cfg = real(a)
        return dataclasses.replace(cfg, num_layers=len(LAYERS[a]),
                                   pattern=tuple(cfg.pattern[i] for i in LAYERS[a]))

    monkeypatch.setattr(TD, "get_config", cut)
    res = TD.run_one(arch, shape, "pod1")
    assert res["ok"] and res["partitioned"] is True
    t = res["traced"]
    B = SHAPES[shape].global_batch
    assert t["rows_a_slot"] == (B // 16 if B % 16 == 0 else B)
    assert t["slots"] == (2 * 16 if B % 16 == 0 else 256)
    got = {name: {r: e["calls"] for r, e in by_route.items()}
           for name, by_route in res["counts"]["entries"].items()}
    for name, want in entries.items():
        per_slot = {r: got[name].get(r, 0) / t["slots"] for r in want}
        assert per_slot == want, (name, got.get(name))
    r = res["roofline"]
    assert r["flops_per_chip"] > 0 and r["hbm_bytes_per_chip"] > 0
    assert r["roofline_step_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"])
