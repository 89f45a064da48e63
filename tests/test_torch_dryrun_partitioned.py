"""The dry run of the partitioned step (``launch.dryrun``), on the CPU.

* The rows a slot come from the grid: on ``pod1`` (data 16, model 16) and
  ``pod2`` (pod 2, data 16, model 16) with the default axes, ``pod`` is
  replicated, so an arch and shape trace the same rows a slot and the same
  FLOPs a chip on both (a reduced gemma3-1b at ``decode_32k``).
* The sub-grid rule: on a small meta grid (pod 2, data 4, model 2) the
  numbers derived from the traced sub-grid (pod 1, data 2, model 2) equal
  those of a trace of the whole grid: FLOPs and HBM bytes a chip (busiest
  slot and mean), and the collectives by axis, their counts and their bytes
  a slot (reduced gemma3-1b with FSDP, train and decode; reduced
  granite-moe at decode, whose expert buffers widen the sub-grid).
* Against the reference's compiled jit, in one JAX subprocess on 8 forced
  CPU devices: a reduced mistral-nemo-12b train step (d 128, 2 layers, f32,
  SGD, 8 x 64) on (data 2, model 4): the port's FLOPs a chip within 2 % of
  ``repro.utils.hlo_flops.analyze_hlo`` of the per-device program, its
  argument bytes a slot equal to XLA's ``memory_analysis``.  The same
  comparison for reduced gemma3-1b (4 query heads) on (data 1, model 8),
  whose attention the port replicates on every model slot, is printed and
  asserted where the two agree (ROADMAP.md §C).

Tolerances: the sub-grid's FLOPs and collectives equal the full trace's
within 1e-9 relative (float sums in another order), its HBM bytes within
1e-4: a few scalar ops a stored block in the train step's tail (the
clip's sums) and a MoE slot's sum over the replicas ahead of it, tens of
bytes in millions, follow the number of blocks and replicas, not a slot's
share; FLOPs within 2 % of the HLO count; argument bytes exact."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as TD
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.partitioned import make_grid
from repro_torch.optim import constant_lr, make_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-9


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gemma(layers=2, fsdp=False):
    cfg = reduce_config(get_config("gemma3-1b"))
    return dataclasses.replace(cfg, num_layers=layers, pattern=cfg.pattern[:layers], fsdp=fsdp)


def test_pod1_and_pod2_trace_the_same_share(monkeypatch):
    """``pod`` is replicated on the multi-pod mesh with the default axes:
    a slot holds B / 16 rows on both production meshes, so both trace the
    same rows a slot and count the same FLOPs a chip."""
    monkeypatch.setattr(TD, "get_config", lambda arch: _gemma(layers=1))
    got = {m: TD.run_one("gemma3-1b", "decode_32k", m) for m in ("pod1", "pod2")}
    rows = {m: r["traced"].get("rows_a_slot", r["traced"]["batch"]) for m, r in got.items()}
    flops = {m: r["roofline"]["flops_per_chip"] for m, r in got.items()}
    assert rows == {"pod1": 128 // 16, "pod2": 128 // 16}
    assert flops["pod1"] == flops["pod2"], flops
    for r in got.values():
        assert r["partitioned"] is True
        assert "pod" not in r["collectives"]["by_axis"]


def _numbers(res):
    r, t = res["roofline"], res["traced"]
    return {"flops": r["flops_per_chip"], "flops_mean": t["flops_mean"],
            "hbm_bytes": r["hbm_bytes_per_chip"], "hbm_bytes_mean": t["hbm_bytes_mean"],
            **{f"{axis}/{kind}/{key}": v for axis, kinds in res["collectives"]["by_axis"].items()
               for kind, rec in kinds.items() for key, v in rec.items()}}


@pytest.mark.parametrize("case", ["gemma_fsdp_train", "gemma_fsdp_decode", "granite_decode"])
def test_the_sub_grid_derives_the_full_grid(case):
    """The numbers derived from the traced sub-grid equal a trace of the
    whole (pod 2, data 4, model 2) grid's."""
    mesh = make_mesh((2, 4, 2), ("pod", "data", "model"), device="meta")
    opt, mb = None, 1
    if case.startswith("gemma"):
        cfg = _gemma(fsdp=True)
    else:
        cfg = dataclasses.replace(reduce_config(get_config("granite-moe-1b-a400m")),
                                  num_layers=2)
    if case.endswith("train"):
        shape = InputShape("t", seq_len=32, global_batch=16, kind="train")
        opt, mb = make_optimizer("adamw", constant_lr(1e-4)), 2
    else:
        shape = InputShape("d", seq_len=64, global_batch=8, kind="decode")
    runs = {sub: TD.dry_run(cfg, shape, mesh, opt=opt, microbatches=mb, sub=sub)
            for sub in (True, False)}
    assert runs[True]["traced"]["slots"] < runs[False]["traced"]["slots"] == 16
    assert runs[True]["traced"]["rows_a_slot"] == runs[False]["traced"]["rows_a_slot"]
    got, want = _numbers(runs[True]), _numbers(runs[False])
    assert sorted(got) == sorted(want)
    for k in want:
        rel = 1e-4 if k.startswith("hbm") else REL
        assert got[k] == pytest.approx(want[k], rel=rel), (k, got[k], want[k])
    for kind in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert runs[True]["memory_analysis"][kind] == runs[False]["memory_analysis"][kind]


def test_a_moe_widens_the_traced_grid():
    """A MoE FFN with capacity routing keeps a slot's expert buffer as wide
    as on the full grid: jamba at ``decode_32k`` on ``pod1`` (16 experts,
    top-2, capacity factor 1.25, 8 tokens a slot) needs 8 data slots for
    the buffer to hold every token, mixtral (8 experts) 4; a dense FFN 2."""
    mesh = TD._mesh("pod1")
    grid = make_grid(mesh)
    want = {"jamba-1.5-large-398b": 8, "mixtral-8x7b": 4, "mistral-nemo-12b": 2}
    for arch, data in want.items():
        got = TD.traced_grid(TD._dry_cfg(get_config(arch)), mesh, grid, None, 8)
        assert got == {"data": data, "model": 16}, (arch, got)


# -- against the reference's compiled jit ----------------------------------------------------


def cfg_of(arch):
    """The cut both packages run (the reference script runs this source):
    reduced mistral-nemo-12b at 2 layers and 8 query heads of 16 on 4 KV
    heads, so that ``model`` 4 splits both (where it splits neither KV head
    the port gathers ``wk``/``wv`` and projects every KV head on every
    slot, XLA each slot's columns: 1.25x its FLOPs at d 128, ROADMAP §C);
    reduced gemma3-1b as it is (4 query heads of 32 on 1 KV head)."""
    cfg = dataclasses.replace(reduce_config(get_config(arch)), remat=False)
    if arch == "mistral-nemo-12b":
        cfg = dataclasses.replace(cfg, num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16)
    return cfg


# case -> (arch, mesh (data, model), batch, sequence)
HLO_CASES = {"mistral": ("mistral-nemo-12b", (2, 4), 8, 64),
             "gemma_heads": ("gemma3-1b", (1, 8), 8, 64)}

_REF_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config, reduce_config
from repro.launch import sharding as SH
from repro.models.transformer import init_lm
from repro.optim.optimizers import constant_lr, make_optimizer
from repro.train.step import make_train_step
from repro.utils.hlo_flops import analyze_hlo
""" + __import__("inspect").getsource(cfg_of) + r"""
out = {}
for case, (arch, shape, B, S) in json.loads(sys.argv[1]).items():
    cfg = cfg_of(arch)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    opt = make_optimizer("sgd", constant_lr(0.1))
    params = jax.eval_shape(lambda: init_lm(cfg, jax.random.PRNGKey(0)))
    state = {"params": params, "opt": jax.eval_shape(opt.init, params)}
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    psh = SH.params_shardings(mesh, params, cfg)
    state_sh = {"params": psh, "opt": SH.opt_state_shardings(mesh, state["opt"], psh)}
    with mesh:
        compiled = jax.jit(make_train_step(cfg, opt, grad_shardings=psh),
                           in_shardings=(state_sh, SH.batch_shardings(mesh, batch)),
                           out_shardings=(state_sh, None)).lower(state, batch).compile()
    out[case] = {"flops": analyze_hlo(compiled.as_text()).flops,
                 "args": compiled.memory_analysis().argument_size_in_bytes}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def hlo():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                           json.dumps({k: list(v) for k, v in HLO_CASES.items()})],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(HLO_CASES))
def test_flops_and_argument_bytes_match_the_reference_jit(hlo, case):
    """The port's dry run of the partitioned train step on the same grid
    (its whole grid traced) against the reference's compiled per-device
    program: argument bytes a slot equal; FLOPs a chip within 2 % where the
    two partition the same work (reduced mistral-nemo); the replicated
    attention of 4 query heads on 8 model slots printed beside XLA's."""
    arch, shape, B, S = HLO_CASES[case]
    cfg = cfg_of(arch)
    mesh = make_mesh(shape, ("data", "model"), device="meta")
    res = TD.dry_run(cfg, InputShape("t", seq_len=S, global_batch=B, kind="train"), mesh,
                     opt=make_optimizer("sgd", constant_lr(0.1)), sub=False)
    flops, ref = res["roofline"]["flops_per_chip"], hlo[case]["flops"]
    print(f"{case}: port FLOPs a chip {flops:,.0f}, XLA {ref:,.0f}, ratio {flops / ref:.6f}; "
          f"argument bytes {res['memory_analysis']['argument_size_in_bytes']:,} vs "
          f"{hlo[case]['args']:,}")
    assert res["memory_analysis"]["argument_size_in_bytes"] == hlo[case]["args"]
    if case == "mistral" or abs(flops / ref - 1) <= 0.02:
        assert flops == pytest.approx(ref, rel=0.02)
