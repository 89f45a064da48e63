"""What one step computes, moves and holds, counted while it runs on any
device — the meta device included, where nothing is allocated.  The port's
counterpart of both ``repro.utils.hlo`` (collective traffic parsed from the
optimized HLO) and ``repro.utils.hlo_flops`` (trip-count-aware FLOPs and HBM
bytes of the HLO): the port has no compiler and no HLO, so it counts the
operations the step dispatches.

``OpCounter`` is one context manager over a step.  It records:

* ``matmul_flops`` — the FLOPs ``torch.utils.flop_counter.FlopCounterMode``
  counts (mm, bmm, addmm, baddbmm, convolutions, SDPA; forward and
  backward, ``2·M·N·K`` a product), as ``hlo_flops`` counts its dots;
* ``op_bytes`` — the operand and result bytes of every aten op: the
  traffic of the step run eagerly, one kernel an op, but for the copies
  and sums by which ``launch.mesh`` carries out a collective in one
  process (``collective_ops``: their traffic is the collective's bytes).  A view moves nothing,
  a gather moves its result (read and written), a scatter its update, a
  tensor broadcast by a zero stride counts its stored elements.  A fused
  program moves less, so this is an upper bound on what the reference's
  XLA moves;
* ``entries`` — what the dispatcher cannot see: each hand-written kernel's
  ``cost(...)`` under its name and route (``add``; the wrappers add it on
  the card and on the meta device), and the Python loops over time whose
  meta path books its cost by formula (``meta_recurrence``: the Mamba scan
  and the RWKV recurrence of the train step);
* ``trips(n)`` — a body traced once but run ``n`` times is counted ``n``
  times: the counterpart of ``known_trip_count``.  The train step traces
  one microbatch on the meta device under ``trips(microbatches)``;
* memory: the bytes of tensors saved for the backward
  (``torch.autograd.graph.saved_tensors_hooks``) that the step allocated,
  the largest single allocation, and the peak of the bytes the step holds
  live (each allocation from its op until its storage is freed: its last
  tensor or view gone);
* ``collectives`` — the port's collectives as ``launch.mesh`` counts them
  (``count_collective`` reports each call here), as a ``CollectiveStats``
  in the reference's kind names; ``by_axis`` the same calls by the axis
  (or tuple of axes) they run over, and whether each operand is a block of
  something split over that axis (``operand_split``: an FSDP weight's
  gather), which is how its bytes a slot grow with the axis's extent;
* ``slot_entries`` — the entries booked inside ``at_slot(s)`` (the
  partitioned forward runs each slot's kernels there), by slot, so that a
  trace of every slot on one device tells the busiest slot's work.

``flops`` and ``hbm_bytes`` add the entries to the dispatcher's counts.
Only one counter is active at a time; ``ACTIVE`` is it, or None (one
module-level lookup in the kernel wrappers, so a path without a counter
pays nothing more).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

ACTIVE: Optional["OpCounter"] = None

aten = torch.ops.aten

# allocations without a write, and queries: no traffic
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
               aten.new_empty_strided, aten._local_scalar_dense, aten.lift_fresh,
               aten.detach, aten.alias}
# read the rows they pick and write them: the result twice, and the indices
_GATHERS = {aten.embedding, aten.index, aten.index_select, aten.gather}
# write the rows they pick: the update read and written, and the indices
_SCATTERS = {aten.index_put, aten.index_put_, aten.index_copy, aten.index_copy_,
             aten.index_add, aten.index_add_, aten.scatter, aten.scatter_,
             aten.scatter_add, aten.scatter_add_}

# the reference's kind names (``repro.utils.hlo.COLLECTIVE_KINDS``) for the
# collectives the port issues (``launch.mesh.collectives``)
_KIND_OF = {"all_reduce": "all-reduce", "all_gather": "all-gather",
            "permute": "collective-permute", "broadcast": "collective-broadcast"}


@dataclass
class CollectiveStats:
    """Bytes and calls by collective kind (``repro.utils.hlo.CollectiveStats``).
    Filled from ``launch.mesh``, the bytes are those it counts: carried
    between mesh slots, the wire traffic itself (an all-reduce over G groups
    carries ``2·(G-1)`` partials)."""

    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def as_dict(self) -> Dict:
        return {
            "total_bytes": self.total_bytes,
            "total_count": self.total_count,
            "bytes_by_kind": dict(self.bytes_by_kind),
            "count_by_kind": dict(self.count_by_kind),
        }


def wire_bytes(stats: CollectiveStats,
               participants_by_kind: Optional[Dict[str, int]] = None) -> int:
    """Wire traffic of stats counted as result-shard bytes (the reference's
    reading of the HLO): ring multipliers, all-reduce 2x, the rest 1x, a
    reduce-scatter times its participants when given
    (``repro.utils.hlo.wire_bytes``).  ``launch.mesh``'s bytes are wire
    bytes already and are not passed through this."""
    mult = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
            "all-to-all": 1.0, "collective-permute": 1.0}
    total = 0.0
    for kind, b in stats.bytes_by_kind.items():
        m = mult.get(kind, 1.0)
        if kind == "reduce-scatter" and participants_by_kind:
            m = float(participants_by_kind.get(kind, 1))
        total += m * b
    return int(total)


def footprint(t: torch.Tensor) -> int:
    """Bytes a kernel reads or writes for ``t``: its elements, a dim of
    stride 0 (a broadcast) counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(xs) -> List[torch.Tensor]:
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


class _OpMode(TorchDispatchMode):
    """Per aten op: its bytes (scaled by the counter's trip multiplier), and
    every new allocation tracked live until its tensor goes."""

    def __init__(self, counter: "OpCounter"):
        super().__init__()
        self.c = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.c
        c.ops += 1
        if c._quiet:   # a collective's own copies: tracked as memory, not as op bytes
            for o in _tensors(out if isinstance(out, (tuple, list)) else (out,)):
                c._track(o)
            return out
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out if isinstance(out, (tuple, list)) else (out,))
        in_storages = {t.untyped_storage()._cdata for t in ins}
        fresh = [o for o in outs if o.untyped_storage()._cdata not in in_storages]
        for o in fresh:
            c._track(o)
        packet = func._overloadpacket
        mutable = func._schema.is_mutable
        if packet in _NO_TRAFFIC or func.is_view or (not fresh and not mutable):
            return out
        if packet in _GATHERS:
            nbytes = sum(2 * footprint(o) for o in outs)
            nbytes += sum(footprint(t) for t in ins if not t.is_floating_point())
        elif packet in _SCATTERS:
            nbytes = sum(2 * footprint(t) if t.is_floating_point() else footprint(t)
                         for t in ins[1:])
        elif packet is aten.copy_:
            nbytes = footprint(ins[0]) + footprint(ins[1])
        else:
            nbytes = sum(footprint(t) for t in ins) + sum(footprint(o) for o in outs)
        c.op_bytes += c.mult * nbytes
        for name in c._sections:
            c.sections[name] += c.mult * nbytes
        return out


class OpCounter:
    """Counts one step; see the module docstring.  Use as ``with
    OpCounter() as oc: step(...)`` and read its fields after."""

    def __init__(self):
        self.op_bytes = 0.0
        self.entries: Dict[Tuple[str, str], Dict[str, float]] = {}
        self.ops = 0
        self.mult = 1
        self.saved_bytes = 0
        self.largest_alloc = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.collectives = CollectiveStats()
        # (axis key, kind, operand split, the call's axes) -> [calls, bytes]
        self.by_axis: Dict[Tuple, List[float]] = {}
        self.slot_entries: Dict[int, Dict[str, float]] = {}
        self._slot: Optional[int] = None
        self._split = False
        self._quiet = 0
        self.sections: Dict[str, float] = {}   # name -> the op bytes counted inside section(name)
        self._sections: List[str] = []
        self._fc: Optional[FlopCounterMode] = None
        self._fc_extra = 0.0
        self._live: Dict[int, int] = {}     # storage id -> bytes, of the step's allocations
        self._saved: set = set()
        self._stack: List = []

    # -- reading ----------------------------------------------------------------

    @property
    def matmul_flops(self) -> float:
        return (self._fc.get_total_flops() if self._fc is not None else 0) + self._fc_extra

    @property
    def flops(self) -> float:
        return self.matmul_flops + sum(e["flops"] for e in self.entries.values())

    @property
    def hbm_bytes(self) -> float:
        return self.op_bytes + sum(e["bytes"] for e in self.entries.values())

    def calls(self, name: str) -> Dict[str, int]:
        """Calls of entry ``name`` by route."""
        return {r: int(e["calls"]) for (n, r), e in sorted(self.entries.items()) if n == name}

    def as_dict(self) -> Dict:
        by_name: Dict[str, Dict] = defaultdict(dict)
        for (name, route), e in sorted(self.entries.items()):
            by_name[name][route] = dict(e)
        return {"flops": self.flops, "matmul_flops": self.matmul_flops,
                "hbm_bytes": self.hbm_bytes, "op_bytes": self.op_bytes, "ops": self.ops,
                "entries": dict(by_name), "saved_bytes": self.saved_bytes,
                "largest_alloc_bytes": self.largest_alloc,
                "peak_live_bytes": self.peak_live_bytes,
                "collectives": self.collectives.as_dict()}

    # -- recording ----------------------------------------------------------------

    def add(self, name: str, route: str, flops: float, nbytes: float, calls: int = 1) -> None:
        """One call of a kernel (or a loop booked by formula) that does
        ``flops`` and moves ``nbytes``, scaled by the trip multiplier."""
        e = self.entries.setdefault((name, route), {"calls": 0, "flops": 0.0, "bytes": 0.0})
        e["calls"] += self.mult * calls
        e["flops"] += self.mult * flops
        e["bytes"] += self.mult * nbytes
        if self._slot is not None:
            t = self.slot_entries.setdefault(self._slot, {"flops": 0.0, "bytes": 0.0})
            t["flops"] += self.mult * flops
            t["bytes"] += self.mult * nbytes

    def collective(self, name: str, nbytes: int, axes: Sequence = ()) -> None:
        kind = _KIND_OF.get(name, name)
        st = self.collectives
        st.bytes_by_kind[kind] = st.bytes_by_kind.get(kind, 0) + self.mult * int(nbytes)
        st.count_by_kind[kind] = st.count_by_kind.get(kind, 0) + self.mult
        # a call over several axes (one group over their product: the
        # global norm's) counts under each, its bytes shared among them
        joint = tuple(n for a in axes for n in ((a,) if isinstance(a, str) else a))
        for a in axes:
            rec = self.by_axis.setdefault((a, kind, self._split, joint), [0, 0])
            rec[0] += self.mult
            rec[1] += self.mult * int(nbytes) / len(axes)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
        if key in self._live:
            return
        self._live[key] = n
        self.live_bytes += n
        self.largest_alloc = max(self.largest_alloc, n)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        # the storage's own Python object lives exactly as long as the storage
        # (a view may outlive the tensor that made it)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n
            self._saved.discard(key)

    def _pack(self, t: torch.Tensor):
        key = t.untyped_storage()._cdata
        if key in self._live and key not in self._saved:
            self._saved.add(key)
            self.saved_bytes += self._live[key]
        return t

    def _push_trips(self, n: int) -> None:
        self._stack.append((n, self.matmul_flops))
        self.mult *= n

    def _pop_trips(self) -> None:
        n, before = self._stack.pop()
        self.mult //= n
        self._fc_extra += (n - 1) * (self.matmul_flops - before)

    def __enter__(self) -> "OpCounter":
        global ACTIVE
        if ACTIVE is not None:
            raise RuntimeError("an op counter is already active")
        self._fc = FlopCounterMode(display=False)
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack, lambda t: t)
        self._fc.__enter__()
        self._mode = _OpMode(self)
        self._mode.__enter__()
        self._hooks.__enter__()
        ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global ACTIVE
        ACTIVE = None
        self._hooks.__exit__(*exc)
        self._mode.__exit__(*exc)
        self._fc.__exit__(*exc)


@contextlib.contextmanager
def trips(n: int):
    """Count what runs inside as run ``n`` times (nothing without an active
    counter)."""
    c = ACTIVE
    if c is None or n == 1:
        yield
        return
    c._push_trips(int(n))
    try:
        yield
    finally:
        c._pop_trips()


def add(name: str, route: str, flops: float, nbytes: float) -> None:
    """``ACTIVE.add(...)`` when a counter is active."""
    c = ACTIVE
    if c is not None:
        c.add(name, route, flops, nbytes)


def count_collective(name: str, nbytes: int, axes: Sequence = ()) -> None:
    c = ACTIVE
    if c is not None:
        c.collective(name, nbytes, axes)


def collective_ops(fn):
    """Decorate a function that carries out a collective in one process
    (``launch.mesh``): the ops it dispatches add no ``op_bytes`` (the
    collective's bytes are counted as such), their results are tracked as
    memory all the same."""

    def run(*args, **kwargs):
        c = ACTIVE
        if c is None:
            return fn(*args, **kwargs)
        c._quiet += 1
        try:
            return fn(*args, **kwargs)
        finally:
            c._quiet -= 1

    run.__name__, run.__doc__, run.__wrapped__ = fn.__name__, fn.__doc__, fn
    return run


@contextlib.contextmanager
def section(name: str):
    """Add the op bytes counted inside to ``sections[name]`` as well (the
    partitioned train step's work on its parameter blocks, which a dry run
    scales with the blocks' size; nothing without an active counter)."""
    c = ACTIVE
    if c is None:
        yield
        return
    c.sections.setdefault(name, 0.0)
    c._sections.append(name)
    try:
        yield
    finally:
        c._sections.pop()


@contextlib.contextmanager
def at_slot(s: int):
    """Book the entries added inside to slot ``s`` as well (nothing without
    an active counter)."""
    c = ACTIVE
    if c is None:
        yield
        return
    saved, c._slot = c._slot, s
    try:
        yield
    finally:
        c._slot = saved


@contextlib.contextmanager
def operand_split():
    """Mark the collectives counted inside as carrying blocks of an operand
    split over their axis (an FSDP weight gathered where a layer uses it):
    their bytes a slot are a share (k - 1) / k of the whole, where another
    gather's grow with the blocks it collects."""
    c = ACTIVE
    if c is None:
        yield
        return
    saved, c._split = c._split, True
    try:
        yield
    finally:
        c._split = saved


class _MetaLoop(torch.autograd.Function):
    """A Python loop over time on the meta device: empty outputs of its
    shapes, its cost booked by formula, forward now and backward when
    autograd runs it."""

    @staticmethod
    def forward(ctx, spec, *inputs):
        name, outs, fwd, bwd = spec
        ctx.spec = (name, bwd, [(t.shape, t.dtype) for t in inputs])
        add(name, "forward", *fwd)
        return tuple(torch.empty(shape, dtype=dtype, device="meta") for shape, dtype in outs)

    @staticmethod
    def backward(ctx, *grads):
        name, bwd, shapes = ctx.spec
        add(name, "backward", *bwd)
        return (None,) + tuple(
            torch.empty(shape, dtype=dtype, device="meta") if need else None
            for (shape, dtype), need in zip(shapes, ctx.needs_input_grad[1:]))


def meta_recurrence(name: str, inputs: Sequence[torch.Tensor],
                    outs: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
                    fwd: Tuple[float, float], bwd: Tuple[float, float]) -> Tuple[torch.Tensor, ...]:
    """The outputs (empty meta tensors of ``outs``' shapes and dtypes) of a
    recurrence over ``inputs`` that a real device runs as a Python loop over
    time, with its ``(flops, bytes)`` booked as ``name``'s ``forward`` now
    and its ``backward`` when a gradient flows back.  Autograd sees one node,
    so the gradients reach every input that requires one."""
    return _MetaLoop.apply((name, tuple(outs), fwd, bwd), *inputs)
