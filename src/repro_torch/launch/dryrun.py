"""Dry run of every (architecture × input shape × mesh) on the meta device
(port of ``repro.launch.dryrun``).

The reference lowers and compiles each step for 512 fake host devices and
reads XLA's memory analysis, FLOPs, bytes and collectives from the
optimized HLO.  The port has no compiler: it runs the real step on meta
tensors (``launch.specs``: shapes only, no memory) under a
``utils.op_counts.OpCounter`` and records:

* ``memory_analysis`` — argument and output bytes a mesh slot, exact per
  shard from the ``launch.sharding`` specs; temporaries from the step's
  trace (the bytes saved for the backward plus the largest allocation);
  ``traced_peak_bytes``, what one card holds running the traced step as
  the port runs it (its inputs whole, plus the peak of what it allocates);
* FLOPs and HBM bytes a chip (``utils.op_counts``: matmul FLOPs as
  ``FlopCounterMode`` counts them, the kernels' ``cost`` formulas, the
  eager ops' operand and result bytes);
* collectives as ``launch.mesh`` counts them;
* the roofline terms at the H100's constants (``utils.roofline``), at the
  peak of the config's compute dtype.

What differs from the reference, and every artifact says so
(``"partitioned": false`` and ``traced``):

* the dry run does not trace the partitioned step (``models.partitioned``,
  which the port runs on placed params; tracing it is ROADMAP A6c, what is
  left), so the step is traced for the batch one slot holds, the global
  batch over the slots the batch is split over (a batch that does not
  divide is traced whole), with every weight whole: FLOPs, bytes and
  activations a chip are that trace's.  The tensor-parallel and
  data-parallel collectives of a partitioned step are not in it;
* the microbatch loop and the time loops (Mamba, the RWKV recurrence of
  the train step) are Python: one microbatch is traced under
  ``op_counts.trips(microbatches)`` and the loops book their cost by
  formula, the counterpart of ``known_trip_count``;
* the ColD strategy traces one contributor slab's local step (what
  ``make_cold_train_step`` runs per slab, on that slab's slot) and the flat
  fuse over all C slabs, whose one all-reduce carries 2·(C−1)·N_pad·4
  bytes (``launch.mesh.collective_bytes``);
* a decode step is traced at the last position of a full cache.

Artifacts land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__<strategy>].json``
(ignored by git; the reference's ``artifacts/dryrun/`` is its own).  No
card is needed: the kernels' meta branches only infer shapes.

Usage:
  python -m repro_torch.launch.dryrun --arch mistral-nemo-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh pod1|pod2|both] [--force]
  python -m repro_torch.launch.dryrun --all --shape decode_32k     # every arch at one shape
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k --strategy cold \\
      --cold-mesh 8x2 --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import distributed as D
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh, data_axes, make_cold_mesh, make_production_mesh
from repro_torch.launch.specs import (META, abstract_cache, abstract_params, abstract_state,
                                      auto_microbatches, input_specs, leaf_spec)
from repro_torch.optim.optimizers import constant_lr, make_optimizer
from repro_torch.train.step import make_prefill_step, make_serve_step, make_train_step
from repro_torch.utils.op_counts import OpCounter
from repro_torch.utils.pytree import tree_leaves_with_path
from repro_torch.utils.roofline import Roofline, model_flops_per_step

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                            "dryrun_torch")

# long_500k eligibility: SSM / hybrid / windowed archs only (the reference's set).
LONG_CTX_ARCHS = {"rwkv6-7b", "jamba-1.5-large-398b", "mixtral-8x7b", "gemma3-1b"}

# Model-parallel submesh is fixed at 16 by the production mesh.
MODEL_AXIS = 16


def eligible(arch: str, shape: InputShape) -> bool:
    if shape.name == "long_500k":
        return arch in LONG_CTX_ARCHS
    return True


def _mesh(kind: str) -> Mesh:
    if kind == "pod1":
        return make_production_mesh(multi_pod=False, device="meta")
    if kind == "pod2":
        return make_production_mesh(multi_pod=True, device="meta")
    if kind.startswith("cold"):
        # cold mesh: contributors x replicas x model; e.g. "cold8x2"
        spec = kind[4:] or "8x2"
        c, r = (int(x) for x in spec.split("x"))
        return make_cold_mesh(contributors=c, replicas=r, model=MODEL_AXIS, device="meta")
    raise ValueError(kind)


def _dp_size(mesh: Mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


def _dry_cfg(cfg: ArchConfig) -> ArchConfig:
    """Dry-run numerics policy: bf16 params/compute (the reference's)."""
    return dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")


def slot_bytes(tree, shardings, mesh: Mesh) -> int:
    """Bytes one mesh slot holds of ``tree`` placed by ``shardings``: each
    leaf's bytes over the extent of the axes its spec splits it over."""
    sh = dict(tree_leaves_with_path(shardings))
    total = 0
    for name, leaf in tree_leaves_with_path(tree):
        shape, dtype = leaf_spec(leaf)
        n = dtype.itemsize
        for d in shape:
            n *= d
        split = 1
        for entry in sh[name].spec:
            if entry is not None:
                split *= SH.axes_extent(mesh, entry)
        total += n // split
    return total


def tree_bytes(tree) -> int:
    total = 0
    for _, leaf in tree_leaves_with_path(tree):
        shape, dtype = leaf_spec(leaf)
        n = dtype.itemsize
        for d in shape:
            n *= d
        total += n
    return total


def _split(shape: InputShape, dp: int) -> int:
    """The slots the batch is split over: ``dp`` when it divides the
    global batch, else 1 (the batch traced whole)."""
    return dp if shape.global_batch % dp == 0 else 1


def _count(fn, *args) -> Tuple[OpCounter, float]:
    t0 = time.time()
    with OpCounter() as oc:
        fn(*args)
    return oc, time.time() - t0


def _analyze(oc: OpCounter, mesh: Mesh, cfg: ArchConfig, shape: InputShape, *,
             training: Optional[bool],
             wall_s: float, microbatches: int, split: int, args_bytes: int, out_bytes: int,
             held_bytes: int, extra: Optional[Dict] = None) -> Dict[str, Any]:
    """The artifact of one traced step: ``held_bytes`` are the traced step's
    inputs whole (what the card holds before it runs); ``training=None``
    for a step without model FLOPs (the fuse)."""
    chips = int(mesh.devices.size)
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    mf_total = (0.0 if training is None else
                model_flops_per_step(cfg.active_param_count(), tokens, training=training))
    st = oc.collectives
    roof = Roofline(flops=oc.flops, hbm_bytes=oc.hbm_bytes,
                    collective_bytes=st.total_bytes / chips, model_flops=mf_total / split,
                    chips=chips, dtype=cfg.compute_dtype)
    temp = oc.saved_bytes + oc.largest_alloc
    out = {
        "ok": True,
        "arch": cfg.name,
        "shape": shape.name,
        "mesh_shape": dict(mesh.shape),
        "chips": chips,
        "kind": shape.kind,
        "microbatches": microbatches,
        "trace_wall_s": wall_s,
        "partitioned": False,
        "traced": {
            "device": "meta",
            "batch": shape.global_batch // split,
            "batch_split_over": split,
            "microbatches_traced": 1,
            "trips": microbatches,
            "note": ("per chip: the batch of one slot over the batch-split slots, every "
                     "weight whole (the partitioned step not traced, ROADMAP A6c); one "
                     "microbatch traced and counted as all of them; Python time loops "
                     "counted by formula; no tensor- or data-parallel collective"),
        },
        "memory_analysis": {
            "argument_size_in_bytes": args_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": temp,
            "peak_memory_in_bytes": args_bytes + out_bytes + temp,
            "saved_for_backward_bytes": oc.saved_bytes,
            "largest_alloc_bytes": oc.largest_alloc,
            "traced_peak_bytes": held_bytes + oc.peak_live_bytes,
        },
        "collectives": {
            "bytes_by_kind": {k: float(v) for k, v in st.bytes_by_kind.items()},
            "count_by_kind": {k: int(v) for k, v in st.count_by_kind.items()},
            "total_bytes": float(st.total_bytes),
            "dynamic_whiles": 0,
        },
        "roofline": roof.as_dict(),
        "counts": oc.as_dict(),
    }
    if extra:
        out.update(extra)
    return out


def run_one(arch: str, shape_name: str, mesh_kind: str, *,
            strategy: str = "sync") -> Dict[str, Any]:
    cfg = _dry_cfg(get_config(arch))
    shape = get_shape(shape_name)
    if not eligible(arch, shape):
        return {"ok": False, "skipped": True,
                "reason": f"{arch} is full-attention; long_500k reserved for sub-quadratic archs"}
    mesh = _mesh(mesh_kind)
    # the "dp" layout: batch over every mesh axis, weights replicated
    data_axis: Any = "data"
    model_axis: Any = "model"
    if strategy == "dp":
        data_axis = ("data", "model") if "pod" not in mesh.axis_names else ("pod", "data", "model")
        model_axis = None
    ax = dict(data_axis=data_axis, model_axis=model_axis)
    dp = int(mesh.devices.size) if strategy == "dp" else _dp_size(mesh)
    split = _split(shape, dp)
    b = shape.global_batch // split

    if shape.is_decode:
        params = abstract_params(cfg)
        cache = abstract_cache(cfg, shape)
        batch = input_specs(cfg, shape)
        params_sh = SH.params_shardings(mesh, params, cfg, **ax)
        cache_sh = SH.cache_shardings(mesh, cache, cfg, **ax)
        batch_sh = SH.batch_shardings(mesh, batch, **ax)
        args = (slot_bytes(params, params_sh, mesh) + slot_bytes(cache, cache_sh, mesh)
                + slot_bytes(batch, batch_sh, mesh) + 4)   # + the int32 cache_index
        logits = shape.global_batch * cfg.vocab_size * 2
        outs = logits + slot_bytes(cache, cache_sh, mesh)
        local = dataclasses.replace(shape, global_batch=b)
        cache_b = abstract_cache(cfg, local)
        tokens = input_specs(cfg, local)["tokens"]
        oc, wall = _count(make_serve_step(cfg), params, cache_b, tokens, shape.seq_len - 1)
        held = tree_bytes(params) + tree_bytes(cache_b) + tree_bytes(tokens)
        return _analyze(oc, mesh, cfg, shape, training=False, wall_s=wall, microbatches=1,
                        split=split, args_bytes=args, out_bytes=outs, held_bytes=held)

    if shape.kind == "prefill":
        params = abstract_params(cfg)
        batch = input_specs(cfg, shape)
        params_sh = SH.params_shardings(mesh, params, cfg, **ax)
        batch_sh = SH.batch_shardings(mesh, batch, **ax)
        args = slot_bytes(params, params_sh, mesh) + slot_bytes(batch, batch_sh, mesh)
        outs = shape.global_batch * cfg.vocab_size * 2
        local = input_specs(cfg, dataclasses.replace(shape, global_batch=b))
        oc, wall = _count(make_prefill_step(cfg), params, local)
        held = tree_bytes(params) + tree_bytes(local)
        return _analyze(oc, mesh, cfg, shape, training=False, wall_s=wall, microbatches=1,
                        split=split, args_bytes=args, out_bytes=outs, held_bytes=held)

    # --- training ---------------------------------------------------------
    # the reference's lever: force the factored optimizer (REPRO_OPT_ADAFACTOR=1)
    opt_name = "adafactor" if os.environ.get("REPRO_OPT_ADAFACTOR", "0") == "1" else cfg.optimizer
    opt = make_optimizer(opt_name, constant_lr(1e-4))
    batch = input_specs(cfg, shape)
    state1 = abstract_state(cfg, opt)
    mb = auto_microbatches(cfg, shape, dp)
    local = input_specs(cfg, dataclasses.replace(shape, global_batch=b))
    metrics = 3 * 4

    if strategy == "cold":
        C = mesh.shape.get("contrib", 1) * mesh.shape.get("pod", 1)
        state = D.stack_for_contributors(state1, C)
        batch = {k: torch.empty((C, v.shape[0] // C) + tuple(v.shape[1:]), dtype=v.dtype,
                                device=META) for k, v in batch.items()}
        state_sh, batch_sh = D.cold_shardings(mesh, cfg, state, batch)
        args = slot_bytes(state, state_sh, mesh) + slot_bytes(batch, batch_sh, mesh)
        outs = slot_bytes(state, state_sh, mesh) + C * metrics
        oc, wall = _count(make_train_step(cfg, opt, microbatches=mb), state1, local)
        held = tree_bytes(state1) + tree_bytes(local)
        res = _analyze(oc, mesh, cfg, shape, training=True, wall_s=wall, microbatches=mb,
                       split=split, args_bytes=args, out_bytes=outs, held_bytes=held,
                       extra={"strategy": "cold", "contributors": C})
        # the fuse (the Repository collective), reported separately: the flat
        # fuse over all C slabs, one all-reduce across the contributor axes
        fuse = D.make_fuse_step(cfg, mesh, D.ColdSchedule(), flat=True)
        p_bytes = slot_bytes(state["params"], state_sh["params"], mesh)
        foc, fwall = _count(fuse, state["params"])
        res["fuse"] = _analyze(foc, mesh, cfg, shape, training=None, wall_s=fwall,
                               microbatches=1, split=split, args_bytes=p_bytes,
                               out_bytes=p_bytes, held_bytes=tree_bytes(state["params"]))
        res["fuse"]["traced"]["note"] = (
            "the flat fuse over all C slabs (make_fuse_step(flat=True)); collectives as "
            "launch.mesh counts them: one all-reduce of 2·(C−1)·N_pad·4 bytes and a gather "
            "a slab; FLOPs, bytes and memory of the whole fuse, not a chip's share")
        return res

    params_sh = SH.params_shardings(mesh, state1["params"], cfg, **ax)
    opt_sh = SH.opt_state_shardings(mesh, state1["opt"], params_sh)
    state_sh = {"params": params_sh, "opt": opt_sh}
    batch_sh = SH.batch_shardings(mesh, batch, **ax)
    args = slot_bytes(state1, state_sh, mesh) + slot_bytes(batch, batch_sh, mesh)
    outs = slot_bytes(state1, state_sh, mesh) + metrics
    oc, wall = _count(make_train_step(cfg, opt, microbatches=mb), state1, local)
    held = tree_bytes(state1) + tree_bytes(local)
    return _analyze(oc, mesh, cfg, shape, training=True, wall_s=wall, microbatches=mb,
                    split=split, args_bytes=args, out_bytes=outs, held_bytes=held)


def _artifact_path(arch: str, shape: str, mesh_kind: str, strategy: str) -> str:
    tag = f"{arch}__{shape}__{mesh_kind}"
    if strategy != "sync":
        tag += f"__{strategy}"
    return os.path.abspath(os.path.join(ARTIFACT_DIR, tag + ".json"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    p.add_argument("--shape", choices=list(SHAPES), default=None)
    p.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="pod1")
    p.add_argument("--strategy", default="sync",
                   help="sync | dp | cold (cold uses the contributor mesh; combine with "
                        "--cold-mesh)")
    p.add_argument("--cold-mesh", default="8x2", help="contributors x replicas, e.g. 8x2")
    p.add_argument("--all", action="store_true",
                   help="run every (arch, shape); with --arch or --shape, every one of the other")
    p.add_argument("--force", action="store_true", help="recompute existing artifacts")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        p.error("give --arch and --shape, or --all")

    global ARTIFACT_DIR
    if args.out:
        ARTIFACT_DIR = args.out
    os.makedirs(ARTIFACT_DIR, exist_ok=True)

    archs = list(ARCH_IDS[:10]) if args.all and args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all and args.shape is None else [args.shape]
    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    if args.strategy.startswith("cold"):
        meshes = [f"cold{args.cold_mesh}"]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = _artifact_path(arch, shape, mesh_kind, args.strategy)
                if os.path.exists(path) and not args.force:
                    print(f"[skip-cached] {os.path.basename(path)}")
                    continue
                print(f"[dryrun] {arch} x {shape} x {mesh_kind} ({args.strategy}) ...", flush=True)
                try:
                    res = run_one(arch, shape, mesh_kind, strategy=args.strategy)
                except Exception as e:  # record failures as artifacts too
                    res = {"ok": False, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                    failures += 1
                    print(f"  FAILED: {res['error']}")
                res.setdefault("arch", arch)
                res.setdefault("shape", shape)
                res.setdefault("mesh", mesh_kind)
                res["strategy"] = args.strategy
                with open(path, "w") as f:
                    json.dump(res, f, indent=2)
                if res.get("ok"):
                    r = res["roofline"]
                    print(
                        f"  ok in {res['trace_wall_s']:.1f}s: "
                        f"compute={r['compute_s']*1e3:.2f}ms memory={r['memory_s']*1e3:.2f}ms "
                        f"collective={r['collective_s']*1e3:.2f}ms -> {r['bottleneck']} "
                        f"(useful={r['useful_flops_ratio']:.2f}, "
                        f"peak={res['memory_analysis']['peak_memory_in_bytes']/2**30:.2f}GiB)",
                        flush=True)
                elif res.get("skipped"):
                    print(f"  skipped: {res['reason']}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
