"""Sharding rules and placement on a mesh (port of
``repro.launch.sharding``).

**The model-side half** maps every parameter, optimizer-state, batch and
cache leaf to a ``PartitionSpec`` on a mesh, by the reference's rules and
name for name (``param_spec``, ``params_shardings``,
``opt_state_shardings``, ``batch_shardings``, ``cache_shardings``): pure
functions of leaf names, shapes and ``mesh.shape``.  A leaf may be a
tensor, a shape tuple, a Python number (shape ``()``) or a placed stacked
leaf (the list of its slabs).  ``device_put`` is the counterpart of
``jax.device_put(tree, shardings)`` in a one-process mesh, and places by
the whole spec:

* a stacked ``[C, ...]`` leaf whose spec puts its leading dim over the
  contributor axes becomes the list of its C slabs, slab ``c`` on
  contributor slot ``g = c // (C / G)`` of the G.  ``contrib`` is always a
  contributor axis; ``pod`` is one only where the reference's ColD mesh
  makes it one (``cold_axes``): on a mesh with ``contrib`` (the ColD
  multi-pod mesh puts ``pod`` beside it), or for a leaf whose spec puts
  its leading dim over ``pod``.  On a ColD mesh every other leaf goes to
  contributor slot 0;
* on a slot whose sub-grid over the other axes (``sub_mesh``: ``data``,
  ``replica``, ``model``, and ``pod`` where it is no contributor axis, as
  on the production multi-pod mesh) has more than one device, a slab (or
  an unstacked leaf) becomes a ``utils.placed.Placed`` leaf: every dim its
  spec puts over those axes is split into blocks, slot ``s`` of the
  sub-grid holding its block, and a block that several slots on one
  device hold (a leaf replicated over an axis, such as ``pod`` where no
  spec names it) is one tensor there.  ``models.partitioned`` runs the
  train step on such leaves over the grid the step's ``data_axis`` and
  ``model_axis`` name (``models.partitioned.Grid``): tensor parallel over
  the model axis, data parallel and FSDP over the batch axes (one name or
  a tuple, such as the ``dp`` strategy's ``("data", "model")``), any other
  axis replicated; and the serving steps, on a cache placed by
  ``cache_shardings`` and a token batch placed by ``batch_shardings`` with
  the same axes (each slot's block of the cache written in place);
* on a sub-grid of one device, and for an integer leaf the spec does not
  split (the optimizer's step counter), the slab stays whole on its
  slot's device (``contrib_slot_devices``; the mesh's first device where
  there is no contributor axis).

``gather`` reads placed leaves whole (counted as ``all_gather``s) and
``placed_slot_bytes`` counts what each mesh slot holds.

**The flat-row half** places the Repository's block-cyclic flat rows.  A
row laid out by ``utils.flat.ShardedFlatSpec`` over the mesh axes ``axes``
has S = ``axes_extent(mesh, axes)`` shards; shard ``s`` lives on one
device, the mesh slot whose linear index over ``axes`` (first axis most
significant, as the reference's ``shard_map`` numbers shards) is ``s`` and
whose index on every other axis is 0.  In the port a staged row is the
list of its S ``[shard_len]`` slices, each on its shard's device, and a
staged cohort the list of S ``[K, shard_len]`` stacks.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import mesh as M
from repro_torch.launch.mesh import Mesh
from repro_torch.utils.placed import Layout, Placed
from repro_torch.utils.pytree import tree_leaves_with_path, tree_map, tree_map_with_name

Axis = Optional[object]  # str | tuple[str, ...] | None

# the reference's perf lever, read from its environment variable at import
OPT_MOE_SHARD = os.environ.get("REPRO_OPT_MOE_SHARD", "0") == "1"

CONTRIB_AXES = ("pod", "contrib")  # the mesh axes a ColD stacked leaf's C dim may run over


def cold_axes(mesh: Mesh, lead: Sequence[str] = ()) -> Tuple[str, ...]:
    """The mesh's contributor axes for a leaf whose leading dim's spec
    entry names ``lead``: every ``pod``/``contrib`` axis of a mesh with
    ``contrib`` (the ColD mesh); on a mesh without it, ``pod`` only where
    ``lead`` names contributor axes alone (a stacked leaf over the pods),
    else none (the production multi-pod mesh, where ``pod`` is a batch
    axis, alone or in a tuple such as ``("pod", "data")``, or
    replicated)."""
    present = tuple(a for a in mesh.axis_names if a in CONTRIB_AXES)
    if "contrib" in mesh.axis_names:
        return present
    if not lead or set(lead) - set(CONTRIB_AXES):
        return ()
    return tuple(a for a in present if a in lead)


class PartitionSpec(tuple):
    """One entry per dim: an axis name, a tuple of names, or ``None``.
    Entries are normalised as JAX's ``PartitionSpec`` normalises them (a
    one-name tuple is the name, an empty one ``None``), so a spec compares
    equal to the reference's entry by entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's, an array's or a placed leaf's (global),
    a shape tuple itself, ``()`` for a Python number, ``(C,) + slab
    shape`` for a placed stacked leaf."""
    if isinstance(leaf, list):
        return (len(leaf),) + _shape(leaf[0])
    if isinstance(leaf, tuple):
        return tuple(int(n) for n in leaf)
    if isinstance(leaf, (int, float)):
        return ()
    return tuple(leaf.shape)


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A ``PartitionSpec`` over a ``Mesh`` (the reference's
    ``jax.sharding.NamedSharding``).  ``place`` puts one leaf where the
    spec says (see the module docstring)."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def lead(self) -> Tuple[str, ...]:
        return norm_axes(self.spec[0]) if self.spec and self.spec[0] is not None else ()

    @property
    def contrib_axes(self) -> Tuple[str, ...]:
        """The contributor axes the leaf's leading dim is split over (none
        for a leaf placed whole)."""
        cold = cold_axes(self.mesh, self.lead)
        return tuple(a for a in self.lead if a in cold)

    @property
    def home(self) -> torch.device:
        """The device of a leaf placed whole (slab 0's)."""
        return self.mesh.devices.flat[0]

    def slab_devices(self, n: int) -> List[torch.device]:
        """The device of each of the ``n`` slabs of a stacked leaf, where a
        slab stays whole."""
        slots = contrib_slot_devices(self.mesh, self.contrib_axes)
        if n % len(slots):
            raise ValueError(f"{n} slabs do not split over {len(slots)} contributor slots")
        per = n // len(slots)
        return [slots[c // per] for c in range(n)]

    def place(self, x):
        """One leaf placed: the list of its slabs, a ``Placed`` leaf, or
        the whole leaf on its slot's device (a Python number stays as it
        is)."""
        cold = cold_axes(self.mesh, self.lead)
        for e in self.spec[1:]:
            if e is not None and set(norm_axes(e)) & set(cold):
                raise ValueError(f"{self.spec}: a contributor axis on a dim other than the "
                                 "leading one")
        if isinstance(x, (int, float)):
            return x
        if not self.contrib_axes:
            return _place_slab(x, tuple(self.spec), self.mesh, 0, self.home, cold)
        slabs = list(x) if isinstance(x, list) else [torch.as_tensor(x)[c]
                                                      for c in range(len(x))]
        devs = self.slab_devices(len(slabs))
        per = len(slabs) // axes_extent(self.mesh, self.contrib_axes)
        return [_place_slab(sl, tuple(self.spec[1:]), self.mesh, c // per, d, cold)
                for c, (sl, d) in enumerate(zip(slabs, devs))]


def sub_mesh(mesh: Mesh, g: int = 0, axes: Optional[Sequence[str]] = None) -> Mesh:
    """Contributor slot ``g``'s grid over the mesh's other axes, the
    contributor axes being ``axes`` (by default ``cold_axes(mesh)``): the
    whole mesh where there are none."""
    axes = cold_axes(mesh) if axes is None else tuple(axes)
    contrib = [a for a in mesh.axis_names if a in axes]
    if not contrib:
        return mesh
    order = [mesh.axis_names.index(a) for a in contrib]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    G = axes_extent(mesh, contrib)
    grid = np.transpose(mesh.devices, order + rest)
    grid = grid.reshape((G,) + grid.shape[len(order):])[g]
    return Mesh(grid, [mesh.axis_names[i] for i in rest])


def _slot_ids(mesh: Mesh, g: int, axes: Optional[Sequence[str]] = None) -> List[int]:
    """The flat mesh slots of contributor slot ``g``'s sub-grid, in its order."""
    tagged = Mesh(np.arange(mesh.devices.size, dtype=object).reshape(mesh.devices.shape),
                  mesh.axis_names)
    return [int(s) for s in sub_mesh(tagged, g, axes).devices.flat]


def _place_slab(x, spec: Tuple, mesh: Mesh, g: int, whole_on: torch.device,
                axes: Optional[Sequence[str]] = None):
    """One slab (or unstacked leaf) on contributor slot ``g``'s sub-grid: a
    ``Placed`` leaf, or whole on ``whole_on`` (see the module docstring).
    A leaf placed already stays as it is where its layout is the one asked
    for, else it is gathered (counted) and placed again.  ``axes``: the
    contributor axes (``sub_mesh``'s)."""
    grid = sub_mesh(mesh, g, axes)
    if isinstance(x, Placed):
        if grid.devices.size > 1 and x.layout == Layout(x.shape, spec, grid):
            return x
        x = _gather_leaf(x, None)
    x = torch.as_tensor(x)
    splits = any(e is not None for e in spec)
    if grid.devices.size == 1 or not (splits or x.is_floating_point()):
        return x.to(whole_on)
    return Placed.split(x, spec, grid)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def device_put(tree, shardings):
    """``tree`` placed by ``shardings``, a tree of ``NamedSharding``s with
    the same structure, as ``jax.device_put(tree, shardings)``."""
    names = [k for k, _ in tree_leaves_with_path(tree)]
    want = [k for k, _ in tree_leaves_with_path(shardings)]
    if names != want:
        raise ValueError(f"sharding tree does not match the tree: {sorted(set(names) ^ set(want))}")
    return tree_map(lambda x, sh: sh.place(x), tree, shardings)


def gather_bytes(x: Placed) -> int:
    """What reading a placed leaf whole carries: every logical block but one."""
    n_blocks = len(x.layout.logical_blocks())
    return (n_blocks - 1) * int(np.prod(x.layout.block_shape, dtype=np.int64)) * x.element_size()


def _gather_leaf(x: Placed, device) -> torch.Tensor:
    M.count_collective("all_gather", gather_bytes(x), x.layout.mesh.axis_names)
    return x.whole(device)


def gather(tree, device=None):
    """``tree`` with every placed leaf read whole (the counterpart of
    reading a sharded array whole): each on ``device``, or on the device
    of its slot 0, counted as one ``all_gather`` a leaf of every logical
    block but one; a list of slabs gathered slab by slab; any other leaf
    as it is."""
    def leaf(x):
        if isinstance(x, list):
            return [leaf(v) for v in x]
        return _gather_leaf(x, device) if isinstance(x, Placed) else x

    return tree_map_with_name(lambda _, x: leaf(x), tree)


def placed_slot_bytes(tree, mesh: Mesh) -> List[int]:
    """The bytes each slot of ``mesh`` (flat, row-major) holds of a placed
    tree (params, optimizer state, a cache placed by ``cache_shardings``,
    or a tree of them) by its specs: a slab's block (or the slab, placed
    whole) on each slot of its contributor slot's sub-grid; on a ColD mesh
    a leaf without a contributor dim on every contributor slot, as its spec
    replicates it there (the port keeps its one copy with contributor slot
    0); elsewhere a placed leaf's block on every slot of the mesh (an axis
    its spec does not name replicates it, such as the production multi-pod
    mesh's ``pod``); a Python int as the reference's int32 scalar.  With
    the specs that placed the tree it equals ``launch.dryrun.slot_bytes``
    on every slot."""
    n = mesh.devices.size
    out = [0] * n
    stacked = cold_axes(mesh, CONTRIB_AXES)   # a list of slabs runs over these
    cold = cold_axes(mesh)                    # and a leaf placed once over these

    def add(x, g, axes):
        ids = _slot_ids(mesh, g, axes) if g is not None else range(n)
        if isinstance(x, Placed):
            nb = int(np.prod(x.layout.block_shape, dtype=np.int64)) * x.element_size()
        elif isinstance(x, (int, float)):
            nb = 4
        else:
            nb = x.numel() * x.element_size()
        for s in ids:
            out[s] += nb

    for _, x in tree_leaves_with_path(tree):
        if isinstance(x, list):
            per = len(x) // axes_extent(mesh, stacked)
            for c, v in enumerate(x):
                add(v, c // per, stacked)
        elif isinstance(x, Placed):
            for g in range(axes_extent(mesh, cold)):
                add(x, g, cold)
        else:
            add(x, None, cold)
    return out


def _axis_size(mesh: Mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _fit(mesh: Mesh, shape: Tuple[int, ...], want: Sequence[Axis]) -> PartitionSpec:
    """Drop any axis whose size doesn't divide the corresponding dim."""
    spec = []
    for dim, axis in zip(shape, want):
        if axis is not None and dim % _axis_size(mesh, axis) == 0 and dim > 0:
            spec.append(axis)
        else:
            spec.append(None)
    return P(*spec)


# -- parameters -------------------------------------------------------------------------

# (regex over the leaf path, wanted axes for the *trailing* dims of the leaf)
_PARAM_RULES = [
    ("embed$", ("model", "fsdp")),          # [V, D]
    ("lm_head$", ("fsdp", "model")),        # [D, V]
    (r"(^|/)pos$", (None, None)),           # learned positions: replicate
    ("attn/wo", ("model", "fsdp")),
    ("xattn/wo", ("model", "fsdp")),
    ("attn/w", ("fsdp", "model")),          # wq/wk/wv
    ("xattn/w", ("fsdp", "model")),
    ("glu/w_down", ("model", "fsdp")),
    ("glu/w", ("fsdp", "model")),
    ("mlp/w_down", ("model", "fsdp")),
    ("mlp/w_up", ("fsdp", "model")),
    ("moe/router", ("fsdp", None)),
    ("moe/w_down", ("model", None, "fsdp")),  # [E, F, D]
    ("moe/w", ("model", "fsdp", None)),       # [E, D, F]
    ("mamba/in_proj", ("fsdp", "model")),
    ("mamba/conv_w", (None, "model")),
    ("mamba/conv_b", ("model",)),
    ("mamba/x_proj", ("model", None)),
    ("mamba/dt_proj", (None, "model")),
    ("mamba/dt_bias", ("model",)),
    ("mamba/A_log", ("model", None)),
    ("mamba/D", ("model",)),
    ("mamba/out_proj", ("model", "fsdp")),
    ("rwkv/wo", ("model", "fsdp")),
    ("rwkv/w", ("fsdp", "model")),          # wr/wk/wv/wg
    ("rwkv/lora_w/a", ("fsdp", None)),
    ("rwkv/lora_w/b", (None, "model")),
    ("rwkv/u", ("model", None)),            # [H, hd]
    ("rwkv/w0", ("model",)),
    ("rwkv/ln_", ("model",)),
    ("head/dense", ("fsdp", "model")),
    ("head/out", ("model", None)),
]


def _sub_axes(axis_map, want: Sequence[Axis]) -> Tuple[Axis, ...]:
    return tuple(axis_map.get(a, None) if isinstance(a, str) else a for a in want)


def param_spec(mesh: Mesh, name: str, leaf, *, data_axis: Axis = "data",
               model_axis: Axis = "model", fsdp: bool = False,
               prefix: Tuple[Axis, ...] = ()) -> PartitionSpec:
    """PartitionSpec for one named parameter leaf: the first rule whose
    pattern matches the name and whose rank matches the body's, fitted to
    the mesh.  ``prefix`` covers leading stacking dims (scan period repeats
    get None; the ColD contributor dim gets the contributor axes)."""
    axis_map = {"model": model_axis, "fsdp": data_axis if fsdp else None}
    shape = _shape(leaf)
    body_shape = shape[len(prefix):]
    want: Optional[Sequence[Axis]] = None
    for pat, axes in _PARAM_RULES:
        if re.search(pat, name) and len(axes) == len(body_shape):
            want = _sub_axes(axis_map, axes)
            break
    if want is None:
        want = (None,) * len(body_shape)
    # the lever (REPRO_OPT_MOE_SHARD=1): when num_experts doesn't divide the
    # model axis, shard the per-expert FFN dim on it instead of replicating
    if (OPT_MOE_SHARD and "moe/w" in name and len(body_shape) == 3
            and want and want[0] is not None
            and body_shape[0] % _axis_size(mesh, want[0]) != 0):
        fsdp_ax = _sub_axes(axis_map, ("fsdp",))[0]
        if "w_down" in name:  # [E, F, D]: F on model, D on fsdp
            want = (None, want[0], fsdp_ax)
        else:  # w_gate/w_up [E, D, F]: D on fsdp, F on model
            want = (None, fsdp_ax, want[0])
    body = list(_fit(mesh, body_shape, want))
    lead = [(a if a is not None and shape[i] % _axis_size(mesh, a) == 0 else None)
            for i, a in enumerate(prefix)]
    return P(*(lead + body))


def params_shardings(mesh: Mesh, params, cfg: ArchConfig, *, data_axis: Axis = "data",
                     model_axis: Axis = "model", contrib_axes: Tuple[Axis, ...] = ()):
    """``NamedSharding`` tree for a params tree.  Leaves under ``scan/``
    carry a leading period-stack dim (None); ``contrib_axes`` (ColD)
    prepends the contributor dim before that."""

    def spec(name: str, leaf):
        prefix: Tuple[Axis, ...] = tuple(contrib_axes)
        if "scan/" in name or name.startswith("scan"):
            prefix = prefix + (None,)
        return NamedSharding(mesh, param_spec(mesh, name, leaf, data_axis=data_axis,
                                              model_axis=model_axis, fsdp=cfg.fsdp,
                                              prefix=prefix))

    return tree_map_with_name(spec, params)


# -- optimizer state: m/v/momentum mirror the params; the rest replicates ----------------


def opt_state_shardings(mesh: Mesh, opt_state, params_sh):
    """``m/``, ``v/`` and ``mom/`` leaves take their parameter's sharding
    where the ranks agree; the step, adafactor's factored statistics and
    anything else replicate (``P()``)."""
    flat_params = dict(tree_leaves_with_path(params_sh))

    def spec(name: str, leaf):
        for prefix in ("m/", "v/", "mom/"):
            if name.startswith(prefix):
                sh = flat_params.get(name[len(prefix):])
                if sh is not None and len(sh.spec) == len(_shape(leaf)):
                    return sh
        return NamedSharding(mesh, P())

    return tree_map_with_name(spec, opt_state)


# -- activations, batches, caches ---------------------------------------------------------


def batch_shardings(mesh: Mesh, batch, *, data_axis: Axis = "data", model_axis: Axis = "model",
                    contrib_axes: Tuple[Axis, ...] = ()):
    """tokens/labels [B, S]: the batch over the data axes, or the sequence
    if the batch doesn't divide (long context, batch 1); M-RoPE positions
    [3, B, S] and frames/extra_embeds [B, N, D] likewise."""

    def spec(name: str, leaf):
        lead = tuple(contrib_axes)
        body = _shape(leaf)[len(lead):]
        if name.endswith("positions") and len(body) == 3:
            want = (None, data_axis, None)
        elif len(body) == 3:  # frames / extra_embeds [B, N, D]
            want = (data_axis, None, None)
        elif len(body) == 2:
            B, _ = body
            want = (data_axis, None) if B % _axis_size(mesh, data_axis) == 0 else (None, data_axis)
        elif len(body) == 1:
            want = (data_axis,)
        else:
            want = (None,) * len(body)
        return NamedSharding(mesh, P(*(list(lead) + list(_fit(mesh, body, want)))))

    return tree_map_with_name(spec, batch)


def cache_shardings(mesh: Mesh, cache, cfg: ArchConfig, *, data_axis: Axis = "data",
                    model_axis: Axis = "model", contrib_axes: Tuple[Axis, ...] = ()):
    """Decode-state sharding.  KV k/v [B, S, Hkv, hd]: batch on data, heads
    on model (else head_dim on model; the sequence on data when the batch
    doesn't divide).  Mamba h [B, di, ds] and conv [B, dc-1, di]: channels
    on model.  RWKV S [B, H, hd, hd]: heads on model; shifts [B, 1, D]: D
    on model."""

    def spec(name: str, leaf):
        lead: Tuple[Axis, ...] = tuple(contrib_axes)
        if "scan/" in name or name.startswith("scan"):
            lead = lead + (None,)
        shape = _shape(leaf)[len(lead):]
        dsz = _axis_size(mesh, data_axis)
        msz = _axis_size(mesh, model_axis)
        want: Sequence[Axis]
        leafname = name.rsplit("/", 1)[-1]
        if leafname in ("k", "v", "xk", "xv") and len(shape) == 4:
            B, S, H, hd = shape
            b_ax = data_axis if B % dsz == 0 else None
            s_ax = None if b_ax else data_axis
            if H % msz == 0:
                want = (b_ax, s_ax, model_axis, None)
            elif hd % msz == 0:
                want = (b_ax, s_ax, None, model_axis)
            else:
                want = (b_ax, s_ax, None, None)
        elif leafname == "h" and len(shape) == 3:  # mamba [B, di, ds]
            want = (data_axis if shape[0] % dsz == 0 else None, model_axis, None)
        elif leafname == "conv" and len(shape) == 3:  # [B, dc-1, di]
            want = (data_axis if shape[0] % dsz == 0 else None, None, model_axis)
        elif leafname == "S" and len(shape) == 4:  # rwkv [B, H, hd, hd]
            want = (data_axis if shape[0] % dsz == 0 else None, model_axis, None, None)
        elif leafname in ("shift", "cm_shift") and len(shape) == 3:
            want = (data_axis if shape[0] % dsz == 0 else None, None, model_axis)
        else:
            want = (None,) * len(shape)
        return NamedSharding(mesh, P(*(list(lead) + list(_fit(mesh, shape, want)))))

    return tree_map_with_name(spec, cache)


# -- the Repository's block-cyclic flat rows ----------------------------------------------


def norm_axes(axes) -> Tuple[str, ...]:
    """A bare axis name or a sequence of names -> a tuple of names."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axes_entry(axes):
    """The ``PartitionSpec`` entry for one dim sharded over ``axes`` (a
    single name collapses out of its tuple, as in JAX's specs)."""
    axes = norm_axes(axes)
    return axes if len(axes) > 1 else axes[0]


def axes_extent(mesh: Mesh, axes) -> int:
    """The product of the extents of ``axes``: the shard count S of a flat
    row laid out over them."""
    shape = mesh.shape
    return int(np.prod([shape[a] for a in norm_axes(axes)], dtype=np.int64))


def flat_row_sharding(mesh: Mesh, axes) -> Tuple[torch.device, ...]:
    """The device of each shard of a row laid out over ``axes``, in shard
    order (where the reference's ``P(axes, None)`` places them)."""
    axes = norm_axes(axes)
    order = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    grid = np.transpose(mesh.devices, order + rest)
    grid = grid[(Ellipsis,) + (0,) * len(rest)] if rest else grid
    return tuple(grid.reshape(-1))


def contrib_slot_devices(mesh: Mesh, axes) -> Tuple[torch.device, ...]:
    """The device that holds contributor slot ``g``'s slabs, for each slot
    over ``axes`` in order: of the R slots of ``g``'s sub-grid over the
    other axes (row-major), the one at index ``g % R``.  On ``make_mesh``'s
    round-robin grid that spreads the contributor slots over the cards
    first: a (2, 2, 2) mesh of 4 cards puts slot 0 on ``cuda:0`` and slot 1
    on ``cuda:1``, where slot 1's first device would be ``cuda:0`` again."""
    axes = norm_axes(axes)
    order = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    G = axes_extent(mesh, axes)
    grid = np.transpose(mesh.devices, order + rest).reshape(G, -1)
    return tuple(grid[g, g % grid.shape[1]] for g in range(G))


def place_shards(x, mesh: Mesh, axes, dim: int = 0) -> List[torch.Tensor]:
    """A sharded operand as its S per-shard tensors, each contiguous on its
    shard's device: a list or tuple is placed as it is, a tensor is split
    along its shard dim ``dim`` (the JAX package's ``[S, L]`` row or
    ``[K, S, L]`` stage).  A staged cohort's ``[K, shard_len]`` stacks sit
    where its rows' slices do, so no device holds more than ``K ·
    shard_len`` staged elements."""
    devices = flat_row_sharding(mesh, axes)
    if isinstance(x, torch.Tensor):
        if x.shape[dim] != len(devices):
            raise ValueError(f"shard dim {dim} of {tuple(x.shape)} != {len(devices)} shards")
        x = x.unbind(dim)
    if len(x) != len(devices):
        raise ValueError(f"{len(x)} shards for a {len(devices)}-shard layout")
    return [p.to(d).contiguous() for p, d in zip(x, devices)]


def stage_row_from_shards(mesh: Mesh, axes, n_shards: int, shard_len: int,
                          read_shard: Callable[[int], torch.Tensor]) -> List[torch.Tensor]:
    """Stage one row from a per-shard host reader (the sharded spill's
    reload path): ``read_shard(i)`` gives shard ``i``'s ``[shard_len]``
    host slice, which is copied to its device before the next is read, so
    the host never holds the whole ``[N]`` row."""
    devices = flat_row_sharding(mesh, axes)
    if len(devices) != n_shards:
        raise ValueError(f"{n_shards} shards for a {len(devices)}-shard layout")
    out = []
    for i, dev in enumerate(devices):
        part = torch.as_tensor(read_shard(i))
        if tuple(part.shape) != (shard_len,):
            raise ValueError(f"shard {i} has shape {tuple(part.shape)}, want ({shard_len},)")
        out.append(part.to(dev))
    return out
