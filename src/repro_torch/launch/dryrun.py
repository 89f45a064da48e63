"""Dry run of every (architecture × input shape × mesh) on the meta device
(port of ``repro.launch.dryrun``).

The reference lowers and compiles each step's sharded jit for 512 fake host
devices and reads XLA's memory analysis, FLOPs, bytes and collectives of
one device's share of the partitioned program.  The port has no compiler:
it places the step's state, cache and batch on a mesh of the meta device
(``launch.specs``: shapes only, no memory) by the strategy's shardings
(``launch.sharding.device_put`` with its ``data_axis``/``model_axis``) and
runs the partitioned step there (``train.step.make_train_step``,
``make_prefill_step``, ``make_serve_step`` on placed params:
``models.partitioned``, every slot's ops issued in turn from one process)
under a ``utils.op_counts.OpCounter``.  ``--strategy cold`` traces one
contributor slab's partitioned local step on its replica × model grid
(what ``core.distributed.make_cold_train_step`` runs per slab) and the
flat fuse over all C slabs.

**The traced grid** (``traced_grid``).  A trace costs time in proportion to
the slots it runs, so where every slot of the full grid holds the same
share (``models.partitioned.seq_layout`` None: each slot its rows), the dry
run traces a sub-grid: the model axis whole, each batch axis cut to extent
2 (grown, for a MoE FFN with capacity routing, until a slot's expert
buffer is as wide as on the full grid), every replicated axis to 1, and the
global batch cut in proportion, so that a slot's rows stay the same.
Where the layout splits the sequence over the batch axes (one long
sequence: ``long_500k``) a slot's share depends on the extent, and the full
grid is traced.  Every artifact says ``"partitioned": true`` and records in
``traced`` the traced grid and its slots, a slot's rows and positions and
the layout, the trace's wall seconds and how each full-grid number was
derived from the trace (``DERIVED``):

* ``memory_analysis`` — argument and output bytes a slot exact from the
  full grid's specs (``slot_bytes``); temporaries and the peak a slot's
  (the bytes saved for the backward over the traced slots, plus the
  largest allocation); ``traced_peak_bytes``, what one card holds running
  every traced slot (as the port runs a grid on ``cuda:0``): the placed
  inputs' stored blocks plus the peak of what the step allocates;
* FLOPs and HBM bytes a chip: the busiest slot's (kernels' ``cost`` booked
  to their slot, ``op_counts.at_slot``; the rest, whose shapes every slot
  shares, over the traced slots), with the mean beside.  The copies by
  which ``launch.mesh`` carries out a collective are no op bytes (their
  traffic is the collective term); each slot's work on its gradient
  blocks (``op_counts.section("blocks")``) is scaled from the traced
  grid's blocks to the full grid's, and the train step's tail (gradient
  reduction, clip, update: each stored block once, the whole state on one
  device) to the state a slot holds;
* collectives by axis (``collectives_by_axis``), counts a step and bytes
  a slot, each kind's bytes a slot carried from the traced extent k to the
  full grid's K by its rule with the extent (``launch.mesh``'s ring
  counts): an all-reduce, a reduce-scatter, a broadcast and the gather of
  an operand split over the axis (an FSDP weight) ``(K-1)/K`` of their
  operand, any other all-gather ``K-1`` blocks, a permute ``1/K``;
* the roofline terms at the H100's constants (``utils.roofline``), at the
  peak of the config's compute dtype.

The microbatch loop and the time loops (Mamba, the RWKV recurrence of the
train step) are Python: one microbatch is traced under
``op_counts.trips(microbatches)`` and the loops book their cost by formula,
the counterpart of ``known_trip_count``.  A decode step is traced at the
last position of a full cache.  The flat fuse of ``--strategy cold``
carries 2·(C−1)·N_pad·4 bytes in its one all-reduce
(``launch.mesh.collective_bytes``).

Artifacts land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__<strategy>].json``
(ignored by git; the reference's ``artifacts/dryrun/`` is its own).  No
card is needed: the kernels' meta branches only infer shapes.

Usage:
  python -m repro_torch.launch.dryrun --arch mistral-nemo-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh pod1|pod2|both] [--force]
  python -m repro_torch.launch.dryrun --all --shape decode_32k     # every arch at one shape
  python -m repro_torch.launch.dryrun --arch gemma3-1b whisper-tiny --shape decode_32k prefill_32k
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
from repro_torch.launch.mesh import (Mesh, data_axes, make_cold_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.launch.specs import (abstract_cache, abstract_params, abstract_state,
                                      auto_microbatches, input_specs, leaf_spec)
from repro_torch.models import moe as MOE
from repro_torch.models.partitioned import Grid, make_grid, seq_layout
from repro_torch.optim.optimizers import Optimizer, constant_lr, make_optimizer
from repro_torch.train.step import make_prefill_step, make_serve_step, make_train_step
from repro_torch.utils.op_counts import OpCounter
from repro_torch.utils.placed import Placed
from repro_torch.utils.pytree import tree_leaves, tree_leaves_with_path
from repro_torch.utils.roofline import Roofline, model_flops_per_step

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                            "dryrun_torch")

# long_500k eligibility: SSM / hybrid / windowed archs only (the reference's set).
LONG_CTX_ARCHS = {"rwkv6-7b", "jamba-1.5-large-398b", "mixtral-8x7b", "gemma3-1b"}

# Model-parallel submesh is fixed at 16 by the production mesh.
MODEL_AXIS = 16

# a batch axis's extent in the traced sub-grid
SUB_EXTENT = 2

DERIVED = {
    "flops_per_chip": "the busiest traced slot's: its kernels' cost (booked to it) plus the "
                      "matmul FLOPs over the traced slots (every slot the same shapes); "
                      "flops_mean beside it",
    "hbm_bytes_per_chip": "the busiest traced slot's: its kernels' bytes plus the eager op "
                          "bytes over the traced slots (a collective's own copies not among "
                          "them), each slot's work on its gradient blocks scaled from the "
                          "traced grid's blocks to the full grid's, the train step's tail "
                          "(gradient reduction, clip, update: each stored block once) scaled "
                          "from the whole state to the state a slot holds; hbm_bytes_mean "
                          "beside it",
    "argument_size_in_bytes": "exact: each leaf's bytes over the full grid's split (slot_bytes)",
    "output_size_in_bytes": "exact from the full grid's specs, plus the whole logits",
    "temp_size_in_bytes": "the bytes saved for the backward over the traced slots, plus the "
                          "largest single allocation",
    "traced_peak_bytes": "one card running every traced slot: the placed inputs' stored "
                         "blocks plus the peak of the step's live allocations",
    "collectives": "counts a step as traced (no count depends on the extent); bytes a slot "
                   "by axis, from the traced extent k to the full grid's K: all-reduce, "
                   "reduce-scatter, broadcast and a split operand's gather x (K-1)/K / "
                   "((k-1)/k), another gather x (K-1)/(k-1), a permute x k/K",
}


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


def stored_bytes(tree) -> int:
    """Bytes of every tensor ``tree`` stores: a placed leaf's stored blocks
    (one a block and device), a whole leaf itself."""
    total = 0
    for x in tree_leaves(tree):
        for b in (x.blocks if isinstance(x, Placed) else [x]):
            if isinstance(b, torch.Tensor):
                total += b.numel() * b.element_size()
    return total


def _moe_width(cfg: ArchConfig, R: int, tokens: int) -> Optional[int]:
    """The expert buffer's width a slot of ``tokens`` tokens runs at R
    slots of the batch axes (``models.moe.plan``'s), None without a MoE
    FFN with capacity routing."""
    if not any(b.ffn == "moe" for b in cfg.blocks) or MOE._routing(cfg) == "dense":
        return None
    E, K = cfg.moe.num_experts, cfg.moe.experts_per_token
    capacity = max(int(cfg.moe.capacity_factor * R * tokens * K / E), K)
    return capacity if R == 1 else min(capacity, tokens)


def traced_grid(cfg: ArchConfig, mesh: Mesh, grid: Grid, layout: Optional[str],
                tokens: int) -> Dict[str, int]:
    """The extents of the grid the dry run traces (the module docstring):
    the full grid where ``layout`` splits the sequence or holds it whole
    on every slot; else the model axis whole, each batch axis cut to
    ``SUB_EXTENT`` (the first ones grown back while a MoE expert buffer of
    a slot's ``tokens`` is narrower than on the full grid) and every
    replicated axis to 1."""
    if layout is not None:
        return dict(mesh.shape)
    out = {a: (n if a == grid.model else 1) for a, n in mesh.shape.items()}
    for a in grid.batch:
        out[a] = min(SUB_EXTENT, mesh.shape[a])
    want = _moe_width(cfg, grid.R, tokens)

    def extent():
        r = 1
        for a in grid.batch:
            r *= out[a]
        return r

    while want is not None and _moe_width(cfg, extent(), tokens) != want:
        a = next(a for a in grid.batch if out[a] < mesh.shape[a])
        out[a] = min(2 * out[a], mesh.shape[a])
    return out


def _sub_mesh(mesh: Mesh, extents: Dict[str, int]) -> Mesh:
    return make_mesh([extents[a] for a in mesh.axis_names], mesh.axis_names, device="meta")


@dataclasses.dataclass
class Trace:
    """One step traced on a meta grid: its counter, wall seconds, the bytes
    its placed inputs store on the one device (``stored_bytes``), the
    state bytes its tail updates (the whole state, once) and a slot's
    bytes of the params on that grid."""

    oc: OpCounter
    wall_s: float
    held_bytes: int
    state_bytes: int = 0
    params_slot_bytes: int = 0


def trace_step(cfg: ArchConfig, kind: str, mesh: Mesh, shape: InputShape, *,
               data_axis: Any = "data", model_axis: Any = "model",
               opt: Optional[Optimizer] = None, microbatches: int = 1) -> Trace:
    """The partitioned ``kind`` step (``"train"``, ``"prefill"`` or
    ``"decode"``) of ``cfg`` at ``shape`` (its global batch the traced
    grid's) on the meta grid ``mesh``: the abstract state (params and
    ``opt``'s state), cache and batch placed by ``params_shardings``,
    ``opt_state_shardings``, ``cache_shardings`` and ``batch_shardings``
    with ``data_axis``/``model_axis``, then one step under an
    ``OpCounter``.  A decode step runs at the last position of a full
    cache.  ``chip_smoke.py`` phase 27 holds this trace against the card."""
    ax = dict(data_axis=data_axis, model_axis=model_axis)
    if kind == "train":
        state = abstract_state(cfg, opt)
        psh = SH.params_shardings(mesh, state["params"], cfg, **ax)
        sh = {"params": psh, "opt": SH.opt_state_shardings(mesh, state["opt"], psh)}
        batch = input_specs(cfg, shape)
        placed = SH.device_put(state, sh)
        pbatch = SH.device_put(batch, SH.batch_shardings(mesh, batch, **ax))
        step = make_train_step(cfg, opt, microbatches=microbatches, grad_shardings=psh, **ax)
        args: Tuple = (placed, pbatch)
        held, state_bytes = stored_bytes(placed) + stored_bytes(pbatch), tree_bytes(state)
        p_slot = slot_bytes(state["params"], psh, mesh)
    else:
        params = abstract_params(cfg)
        placed = SH.device_put(params, SH.params_shardings(mesh, params, cfg, **ax))
        batch = input_specs(cfg, shape)
        pbatch = SH.device_put(batch, SH.batch_shardings(mesh, batch, **ax))
        held, state_bytes, p_slot = stored_bytes(placed) + stored_bytes(pbatch), 0, 0
        if kind == "decode":
            cache = abstract_cache(cfg, shape)
            pcache = SH.device_put(cache, SH.cache_shardings(mesh, cache, cfg, **ax))
            held += stored_bytes(pcache)
            step = make_serve_step(cfg, **ax)
            args = (placed, pcache, pbatch["tokens"], shape.seq_len - 1)
        else:
            step = make_prefill_step(cfg, **ax)
            args = (placed, pbatch)
    t0 = time.time()
    with torch.no_grad(), OpCounter() as oc:
        step(*args)
    return Trace(oc, time.time() - t0, held, state_bytes, p_slot)


def per_slot(tr: Trace, n: int, state_slot_bytes: int = 0,
             params_slot_bytes: int = 0) -> Dict[str, float]:
    """The busiest slot's and the mean slot's FLOPs and HBM bytes of a
    trace over ``n`` slots (the module docstring's rule): the train step's
    tail scaled from the whole state to ``state_slot_bytes``, each slot's
    work on its gradient blocks from the traced grid's ``params`` bytes a
    slot to ``params_slot_bytes``."""
    oc = tr.oc
    slots = oc.slot_entries
    booked = {k: sum(t[k] for t in slots.values()) for k in ("flops", "bytes")}
    tail, blocks = oc.sections.get("tail", 0.0), oc.sections.get("blocks", 0.0)
    tail_slot = tail * state_slot_bytes / tr.state_bytes if tr.state_bytes else 0.0
    blocks_slot = (blocks / n * params_slot_bytes / tr.params_slot_bytes
                   if tr.params_slot_bytes else 0.0)
    flops_rest = (oc.flops - booked["flops"]) / n
    bytes_rest = (oc.hbm_bytes - tail - blocks - booked["bytes"]) / n + tail_slot + blocks_slot
    top = max(slots.values(), key=lambda t: (t["flops"], t["bytes"])) if slots else None
    return {"flops": flops_rest + (top["flops"] if top else 0.0),
            "flops_mean": flops_rest + booked["flops"] / n,
            "hbm_bytes": bytes_rest + (top["bytes"] if top else 0.0),
            "hbm_bytes_mean": bytes_rest + booked["bytes"] / n,
            "tail_bytes_traced": tail, "tail_bytes_slot": tail_slot,
            "blocks_bytes_traced": blocks, "blocks_bytes_slot": blocks_slot}


def _rule(kind: str, split: bool):
    """A collective kind's bytes a slot as a function of its axis's extent
    (``launch.mesh``'s ring counts)."""
    if kind == "collective-permute":
        return lambda k: 1.0 / k
    if kind == "all-gather" and not split:
        return lambda k: float(k - 1)
    return lambda k: (k - 1) / k


def collectives_per_slot(oc: OpCounter, traced: Mesh, full: Mesh) -> Dict[str, Any]:
    """The trace's collectives by axis: counts a step, and bytes a slot
    carried from the traced grid to ``full`` by each kind's rule over the
    extent of the call's group (a call over several axes, one group over
    their product, counts under each with its bytes shared)."""
    n = traced.devices.size
    by_axis: Dict[str, Dict[str, Dict[str, float]]] = {}
    by_kind: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for (axis, kind, split, joint), (calls, nbytes) in sorted(oc.by_axis.items(), key=str):
        k, K = traced.extent(joint), full.extent(joint)
        rule = _rule(kind, split)
        got = nbytes / n * (rule(K) / rule(k) if k > 1 else 1.0)
        key = axis if isinstance(axis, str) else ",".join(axis)
        rec = by_axis.setdefault(key, {}).setdefault(kind, {"count": 0, "bytes_per_slot": 0.0})
        rec["count"] += int(calls)
        rec["bytes_per_slot"] += got
        by_kind[kind] = by_kind.get(kind, 0.0) + got
        count[kind] = count.get(kind, 0) + int(calls)
    return {"bytes_by_kind": by_kind, "count_by_kind": count,
            "total_bytes": sum(by_kind.values()), "by_axis": by_axis,
            "bytes": "a slot's, on the full grid", "dynamic_whiles": 0}


def _analyze(tr: Trace, traced: Mesh, full: Mesh, cfg: ArchConfig, shape: InputShape, *,
             training: Optional[bool], microbatches: int, args_bytes: int, out_bytes: int,
             state_slot_bytes: int = 0, params_slot_bytes: int = 0,
             share: Optional[Dict] = None,
             extra: Optional[Dict] = None) -> Dict[str, Any]:
    """The artifact of one step traced on ``traced`` for the grid ``full``;
    ``training=None`` for a step without model FLOPs (the fuse)."""
    chips = int(full.devices.size)
    n = int(traced.devices.size)
    oc = tr.oc
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    mf_total = (0.0 if training is None else
                model_flops_per_step(cfg.active_param_count(), tokens, training=training))
    slot = per_slot(tr, n, state_slot_bytes, params_slot_bytes)
    cols = collectives_per_slot(oc, traced, full)
    roof = Roofline(flops=slot["flops"], hbm_bytes=slot["hbm_bytes"],
                    collective_bytes=cols["total_bytes"], model_flops=mf_total / chips,
                    chips=chips, dtype=cfg.compute_dtype)
    temp = oc.saved_bytes / n + oc.largest_alloc
    out = {
        "ok": True,
        "arch": cfg.name,
        "shape": shape.name,
        "mesh_shape": dict(full.shape),
        "chips": chips,
        "kind": shape.kind,
        "microbatches": microbatches,
        "trace_wall_s": tr.wall_s,
        "partitioned": True,
        "traced": dict({
            "device": "meta",
            "grid": dict(traced.shape),
            "slots": n,
            "full_slots": chips,
            "microbatches_traced": 1,
            "trips": microbatches,
            "trace_s": tr.wall_s,
            "flops_mean": slot["flops_mean"],
            "hbm_bytes_mean": slot["hbm_bytes_mean"],
            "tail_bytes": [slot["tail_bytes_traced"], slot["tail_bytes_slot"]],
            "blocks_bytes": [slot["blocks_bytes_traced"], slot["blocks_bytes_slot"]],
            "derived": DERIVED,
            "note": ("the partitioned step traced on the meta grid above (every slot's ops, "
                     "one process); one microbatch traced and counted as all of them; Python "
                     "time loops counted by formula"),
        }, **(share or {})),
        "memory_analysis": {
            "argument_size_in_bytes": args_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": temp,
            "peak_memory_in_bytes": args_bytes + out_bytes + temp,
            "saved_for_backward_bytes": oc.saved_bytes / n,
            "largest_alloc_bytes": oc.largest_alloc,
            "traced_peak_bytes": tr.held_bytes + oc.peak_live_bytes,
        },
        "collectives": cols,
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
    mb = auto_microbatches(cfg, shape, dp)
    opt = None
    if shape.kind == "train":
        # the reference's lever: force the factored optimizer (REPRO_OPT_ADAFACTOR=1)
        opt_name = ("adafactor" if os.environ.get("REPRO_OPT_ADAFACTOR", "0") == "1"
                    else cfg.optimizer)
        opt = make_optimizer(opt_name, constant_lr(1e-4))
    if strategy == "cold":
        return _run_cold(cfg, shape, mesh, opt, mb)

    return dry_run(cfg, shape, mesh, opt=opt, microbatches=mb, **ax)


def dry_run(cfg: ArchConfig, shape: InputShape, full: Mesh, *, data_axis: Any = "data",
            model_axis: Any = "model", opt: Optional[Optimizer] = None, microbatches: int = 1,
            sub: bool = True) -> Dict[str, Any]:
    """The artifact of ``cfg``'s partitioned step at ``shape`` on the meta
    grid ``full`` with ``data_axis``/``model_axis``: traced on
    ``traced_grid``'s sub-grid (the full grid without ``sub``), the full
    grid's numbers derived from it (the module docstring)."""
    ax = dict(data_axis=data_axis, model_axis=model_axis)
    kind = "decode" if shape.is_decode else shape.kind
    mb = microbatches
    grid = make_grid(full, **ax)
    S = 1 if kind == "decode" else shape.seq_len
    B = shape.global_batch
    layout = seq_layout(B, S, grid.R)
    rows = B // grid.R if layout is None else B
    extents = traced_grid(cfg, full, grid, layout, rows // mb * S) if sub else dict(full.shape)
    traced = _sub_mesh(full, extents)
    local = dataclasses.replace(
        shape, global_batch=rows * make_grid(traced, **ax).R if layout is None else B)
    tr = trace_step(cfg, kind, traced, local, opt=opt, microbatches=mb, **ax)
    share = {"layout": layout or "rows", "rows_a_slot": rows,
             "positions_a_slot": S // grid.R if layout == "chunks" else S,
             "batch": local.global_batch}

    params = abstract_params(cfg)
    params_sh = SH.params_shardings(full, params, cfg, **ax)
    batch = input_specs(cfg, shape)
    batch_sh = SH.batch_shardings(full, batch, **ax)
    logits = B * cfg.vocab_size * 2
    if kind == "decode":
        cache = abstract_cache(cfg, shape)
        cache_sh = SH.cache_shardings(full, cache, cfg, **ax)
        c_bytes = slot_bytes(cache, cache_sh, full)
        share["cache_positions_a_slot"] = _cache_positions(cache, cache_sh, full, shape.seq_len)
        args = (slot_bytes(params, params_sh, full) + c_bytes
                + slot_bytes(batch, batch_sh, full) + 4)   # + the int32 cache_index
        return _analyze(tr, traced, full, cfg, shape, training=False, microbatches=1,
                        args_bytes=args, out_bytes=logits + c_bytes, share=share)
    if kind == "prefill":
        args = slot_bytes(params, params_sh, full) + slot_bytes(batch, batch_sh, full)
        return _analyze(tr, traced, full, cfg, shape, training=False, microbatches=1,
                        args_bytes=args, out_bytes=logits, share=share)
    state = abstract_state(cfg, opt)
    opt_sh = SH.opt_state_shardings(full, state["opt"], params_sh)
    s_bytes = slot_bytes(state, {"params": params_sh, "opt": opt_sh}, full)
    args = s_bytes + slot_bytes(batch, batch_sh, full)
    return _analyze(tr, traced, full, cfg, shape, training=True, microbatches=mb,
                    args_bytes=args, out_bytes=s_bytes + 3 * 4, state_slot_bytes=s_bytes,
                    params_slot_bytes=slot_bytes(params, params_sh, full), share=share)


def _cache_positions(cache, cache_sh, mesh: Mesh, seq_len: int) -> int:
    """A slot's positions of the cache: ``seq_len`` over the extent of the
    axes that the spec of the first leaf ``[..., seq_len, Hkv, hd]`` (a
    self-attention's k or v) splits that dim over; all of them without one
    (a recurrent state)."""
    sh = dict(tree_leaves_with_path(cache_sh))
    for name, leaf in tree_leaves_with_path(cache):
        shape, _ = leaf_spec(leaf)
        d = len(shape) - 3
        if d >= 1 and shape[d] == seq_len:
            spec = tuple(sh[name].spec)
            entry = spec[d] if d < len(spec) else None
            return seq_len // (SH.axes_extent(mesh, entry) if entry is not None else 1)
    return seq_len


def _run_cold(cfg: ArchConfig, shape: InputShape, mesh: Mesh, opt: Optimizer,
              mb: int) -> Dict[str, Any]:
    """``--strategy cold``: one contributor slab's partitioned local step on
    its replica × model grid (the sub-grid rule on it), the slab's rows of
    the global batch, argument bytes a slot of the whole stacked state; and
    the flat fuse over all C slabs, reported separately."""
    C = mesh.shape.get("contrib", 1) * mesh.shape.get("pod", 1)
    state1 = abstract_state(cfg, opt)
    state = D.stack_for_contributors(state1, C)
    batch = {k: torch.empty((C, v.shape[0] // C) + tuple(v.shape[1:]), dtype=v.dtype,
                            device=v.device) for k, v in input_specs(cfg, shape).items()}
    state_sh, batch_sh = D.cold_shardings(mesh, cfg, state, batch)
    s_bytes = slot_bytes(state, state_sh, mesh)
    args = s_bytes + slot_bytes(batch, batch_sh, mesh)
    outs = s_bytes + C * 3 * 4
    slab_grid = SH.sub_mesh(mesh, 0)
    ax = dict(data_axis="replica", model_axis="model")
    grid = make_grid(slab_grid, **ax)
    B = shape.global_batch // C
    layout = seq_layout(B, shape.seq_len, grid.R)
    rows = B // grid.R if layout is None else B
    traced = _sub_mesh(slab_grid, traced_grid(cfg, slab_grid, grid, layout,
                                              rows // mb * shape.seq_len))
    local = dataclasses.replace(
        shape, global_batch=rows * make_grid(traced, **ax).R if layout is None else B)
    tr = trace_step(cfg, "train", traced, local, opt=opt, microbatches=mb, **ax)
    share = {"layout": layout or "rows", "rows_a_slot": rows,
             "positions_a_slot": shape.seq_len, "batch": local.global_batch,
             "slab_grid": dict(slab_grid.shape)}
    p_slot = slot_bytes(state["params"], state_sh["params"], mesh)
    res = _analyze(tr, traced, mesh, cfg, shape, training=True, microbatches=mb,
                   args_bytes=args, out_bytes=outs, state_slot_bytes=s_bytes,
                   params_slot_bytes=p_slot, share=share,
                   extra={"strategy": "cold", "contributors": C})
    # the fuse (the Repository collective), reported separately: the flat
    # fuse over all C slabs, one all-reduce across the contributor axes
    fuse = D.make_fuse_step(cfg, mesh, D.ColdSchedule(), flat=True)
    p_bytes = p_slot
    t0 = time.time()
    with OpCounter() as foc:
        fuse(state["params"])
    st = foc.collectives
    res["fuse"] = {
        "ok": True, "trace_wall_s": time.time() - t0,
        "memory_analysis": {"argument_size_in_bytes": p_bytes, "output_size_in_bytes": p_bytes},
        "collectives": {"bytes_by_kind": {k: float(v) for k, v in st.bytes_by_kind.items()},
                        "count_by_kind": {k: int(v) for k, v in st.count_by_kind.items()},
                        "total_bytes": float(st.total_bytes)},
        "counts": foc.as_dict(),
        "traced": {"device": "meta", "note": (
            "the flat fuse over all C slabs (make_fuse_step(flat=True)) on the stacked state; "
            "collectives as launch.mesh counts them: one all-reduce of 2·(C−1)·N_pad·4 "
            "bytes and a gather a slab; FLOPs and bytes of the whole fuse, not a chip's "
            "share")}}
    return res


def _artifact_path(arch: str, shape: str, mesh_kind: str, strategy: str) -> str:
    tag = f"{arch}__{shape}__{mesh_kind}"
    if strategy != "sync":
        tag += f"__{strategy}"
    return os.path.abspath(os.path.join(ARTIFACT_DIR, tag + ".json"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=list(ARCH_IDS), nargs="+", default=None,
                   help="one arch or several")
    p.add_argument("--shape", choices=list(SHAPES), nargs="+", default=None,
                   help="one shape or several")
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

    archs = list(ARCH_IDS[:10]) if args.all and args.arch is None else args.arch
    shapes = list(SHAPES) if args.all and args.shape is None else args.shape
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
                    t = res["traced"]
                    print(
                        f"  ok in {res['trace_wall_s']:.1f}s on {t['slots']} of "
                        f"{t['full_slots']} slots ({t['layout']}): "
                        f"compute={r['compute_s']*1e3:.2f}ms memory={r['memory_s']*1e3:.2f}ms "
                        f"collective={r['collective_s']*1e3:.2f}ms -> {r['bottleneck']} "
                        f"(useful={r['useful_flops_ratio']:.2f}, "
                        f"peak={res['memory_analysis']['peak_memory_in_bytes']/2**30:.2f}GiB "
                        f"a slot)", flush=True)
                elif res.get("skipped"):
                    print(f"  skipped: {res['reason']}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
