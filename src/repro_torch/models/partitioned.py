"""The partitioned forward of a decoder LM (and of the encoder-decoder):
one slab's train-step loss, or its prefill and decode steps against a
placed cache, computed over the slots of its grid
(``launch.sharding.sub_mesh``), on the blocks ``launch.sharding.device_put``
placed there.

The grid (``Grid``, from the step's ``data_axis`` and ``model_axis``, as
the reference's jit reads its ``in_shardings``) has a model axis (M slots,
or none: M = 1) and batch axes (R slots: one axis, ``replica`` or
``data``, or a tuple such as the ``dp`` strategy's ``("data", "model")``
or the multi-pod mesh's ``("pod", "data")``, whose slots are ordered
row-major with the first name major, as JAX orders a tuple
``PartitionSpec`` entry; every "batch axis" below is that group).  Any
other mesh axis (``pod`` where no spec names it) is replicated: its slots
run the same program on the same blocks and no collective crosses it.
Every activation is a list of per-slot tensors and every slot runs its
part of each layer in turn, in one process, so a collective sees all its
slots at once (``launch.mesh``'s ``axis_*`` functions, which autograd
differentiates; the train step's counts are for one forward and its
backward).  Slot ``(r, m)`` takes replica ``r``'s rows of the batch.
Without a model axis every slot runs the whole width: no tensor
parallelism, and the vocab-parallel loss over one slot.

* Weights split over the batch axis (FSDP) are all-gathered over it where
  a layer uses them, one layer's slice at a time; the gather's backward
  reduce-scatters their gradient back to the blocks.
* The embedding is vocab-parallel when its spec splits the vocabulary over
  ``model``: each slot looks up the tokens in its block (zeros elsewhere)
  and one all-reduce sums the rows.  The logits ``x @ embedᵀ`` (or
  ``x @ lm_head``) come out per vocabulary block, scored by
  ``train.losses.lm_loss_vocab_parallel`` (three all-reduces) in the train
  step; the serving steps all-gather the last position's (``gather_last``).
* Attention: the query heads are column-parallel (``Hq % M == 0``); the
  KV heads are split where ``Hkv % M == 0``, else the ``wk``/``wv`` blocks
  are all-gathered over ``model`` (or, where the spec keeps them whole,
  their gradient is all-reduced), and each slot attends with its own query
  heads; ``wo`` is row-parallel with one all-reduce.  Where the spec splits
  ``wq``'s columns but M does not divide the query heads (gemma3-1b's 4 on
  16, whisper-tiny's 6), ``wq``'s column blocks are all-gathered over
  ``model`` too (their backward reduce-scatters), every slot attends with
  all ``Hq`` heads (the attention replicated, as the reference's GSPMD
  program runs it) and keeps its column block of the output for its rows
  of ``wo``.  The GLU and MLP are
  column-parallel, then row-parallel with one all-reduce.  A layer whose
  spec does not split it over ``model`` runs whole on every slot.
* The replicated input of each column-parallel product passes
  ``axis_sum_grads`` (identity; its backward all-reduces), the norms run
  on every slot.

So each slot's gradient of a leaf it holds whole over ``model`` is the
whole gradient, as in Megatron; the train step sums the batch axis.  The
train step's attention is ``layers._sdpa`` (the differentiable copy).

**Serving** (``differentiable=False``: ``train.step.make_prefill_step``,
``make_serve_step`` and ``serve.engine.Engine`` on placed params) runs the
kernels on each slot's own heads, against a cache placed by
``launch.sharding.cache_shardings`` (each slot holds its block and writes
it in place):

* attention: ``kernels.ops.attention`` on the slot's ``Hq / M`` query
  heads and the KV heads they read (``Hkv / M`` of the cache where the
  heads split; else the one or few of the whole ``Hkv``), with the ring
  rule of ``layers.cache_slot`` for a ``window``-slot cache.  Where the
  cache's spec splits ``head_dim`` over ``model`` (the KV heads do not
  split), each slot writes its ``head_dim`` slice of the new k/v into its
  block, and the layer's whole-``head_dim`` cache is all-gathered over
  ``model`` for the call (one counted gather for k, one for v) and
  dropped after it: no slot keeps it between steps;
* the RWKV time mix is head-parallel by the reference's rules:
  ``wr/wk/wv/wg`` column-parallel, ``lora_w/b``, ``w0``, ``u`` and the
  group norm's ``ln_*`` split over ``model`` (the group norm is local to
  a head), ``mu`` and ``lora_mix`` whole, ``wo`` row-parallel with one
  all-reduce; each slot runs ``rwkv6_scan`` on its ``H / M`` heads and
  its block of the state ``S``.  The channel mix matches no rule, so it
  runs whole on every slot.  The token-shift states ``shift`` and
  ``cm_shift`` [B, 1, D] are split over D on ``model``: each is gathered
  (counted) where the shift reads it, and each slot stores its slice of
  the new one.

**The RWKV block in the train step** is the same split, on the plain
recurrence (``rwkv._recurrence``: the reference's ``rwkv6_scan`` has no
backward either).  The leaves held whole over ``model`` but used by each
slot's heads alone (``mu``, ``lora_mix/a``, ``lora_mix/b``, ``lora_w/a``)
pass ``axis_sum_grads`` over it, as the whole ``wk``/``wv`` of attention
do: each slot's gradient is then the whole one.

**The Mamba mixer** is channel-parallel by the reference's rules: every
leaf splits its d_inner channels over ``model`` (``in_proj`` [D, 2·di] on
its 2·di columns as one dim, ``conv_*``, ``x_proj`` [di, dtr + 2·ds] on
its rows, ``dt_proj`` on its columns, ``dt_bias``, ``A_log``, ``D``;
``out_proj`` [di, D] on its rows, FSDP on its columns), and slot ``m``
runs channels ``[m·di/M, (m+1)·di/M)``:

* ``in_proj``'s blocks are not a slot's channels of both halves (at M = 2
  slot 0 holds all of ``xi``, slot 1 all of ``z``): each slot multiplies
  its block, the [B, S, 2·di] product is all-gathered over ``model`` (one
  counted gather of activations, whose backward reduce-scatters), and
  each slot slices its channels of ``xi`` and ``z``;
* the conv, the SSM inputs from ``dt_low``/``B``/``C`` on, the scan, the
  ``+ xc·D`` and the ``silu(z)`` gate are local to a channel
  (``mamba``'s parts); ``x_proj`` is row-parallel, its partial products
  all-reduced over ``model`` (one a layer), and since every slot's
  channels read the whole ``dt_low``, ``B`` and ``C`` that output passes
  ``axis_sum_grads``;
* ``out_proj`` is row-parallel with one all-reduce;
* serving: each slot resumes from and writes in place its blocks of the
  state, ``h`` [B, di, ds] split (data, model, None) and ``conv``
  [B, dc-1, di] split (data, None, model) by ``cache_shardings``.

**The MoE FFN** is expert parallel, by the reference's rules
(``moe/w_gate``/``w_up`` [E, D, F] and ``w_down`` [E, F, D] split E over
``model``, the router [D, E] whole over it), and computes what GSPMD makes
of the reference's ``moe_fwd``: its routing is global over the batch axis.

* Each slot routes its replica's rows with the whole router (gathered
  over the batch axis where FSDP splits D): ``moe._router``'s top-k, the
  capacity of the whole batch, ``max(int(cf * T * K / E), K)`` with T
  counting every replica's rows.
* The queues: each replica's count of pairs on each expert is
  all-gathered over the batch axis (one counted gather a layer), and
  replica ``r``'s pairs queue behind those of replicas ``< r`` (the
  reference's cumsum over the global token order), so a pair is kept or
  dropped as it is in the whole batch.
* Each slot runs its E / M experts on its replica's kept pairs (the FFN is
  row-wise: no token moves), and its partial combine is all-reduced over
  ``model``.  Where M does not divide E the experts stay whole on every
  slot (no all-reduce), or, with the lever ``REPRO_OPT_MOE_SHARD=1``,
  ``w_gate``/``w_up`` are column-parallel and ``w_down`` row-parallel over
  F, with one all-reduce.
* The train step's load-balance loss takes the global ``f_e`` and ``p_e``:
  each replica's sums, one counted all-reduce over the batch axis a
  layer.  Every slot adds the whole aux to its objective (the all-reduce's
  backward is the identity, so each replica's router gets its own rows'
  share of the gradient); the metric counts it once.
* Under the Megatron rule the router's top-k weights pass
  ``axis_sum_grads`` over ``model`` after the branch to the aux loss (a
  slot's weights feed only its experts), and so does the experts' input,
  not the router's.

**M-RoPE and ``extra_embeds``**: each slot takes its replica's
``positions`` [3, B_r, S] (or [B_r, S]) and ``extra_embeds`` [B_r, N, D];
the latter replace the first N embeddings after the vocab-parallel
lookup's all-reduce.  The rotary angles are computed once per replica and
device (the replicas' positions differ).  A decode step takes its
positions from ``cache_index``, as the reference's serve step does.

**A batch that the batch axis does not divide** (one request, or one
training sequence, of a long context) lies as the reference's
``batch_shardings`` and ``cache_shardings`` place it (``seq_layout``):
the tokens (and a train step's mask) split into R chunks over the batch
axis where R divides their length (``"chunks"``: slot ``(r, m)`` holds
positions ``[r S / R, (r + 1) S / R)``), else whole on every slot
(``"whole"``), as is every decode step's token; M-RoPE ``positions`` and
``extra_embeds`` whole on every slot, each chunk taking its positions'
part (the embedded positions of a chunk: none, all, or a prefix where N
ends inside it); a KV cache's sequence is split over the batch axis (data
slot ``r`` holds positions, or ring slots, ``[r L / R, (r + 1) L / R)``),
the RWKV and Mamba states are whole over it.  Each slot runs the model on
its tokens:

* attention: a prompt's new k/v are all-gathered over the batch axis (one
  counted gather each), each slot runs the kernel on its query chunk at
  ``q_offset`` = the chunk's start over every position's keys and writes
  the positions its cache block holds; a decode step's k/v go to the block
  that owns the position (``layers.cache_block``), each slot takes the
  decode partials of its query rows over its own block
  (``ops.attention_partials``, the block's ``q_offset``), and the partials
  are all-gathered over the batch axis (one counted gather) and merged
  (``ops.attention_merge``): no slot reads another's block;
* the RWKV time and channel mixes' token shift reads the previous chunk's
  last position (each chunk's last position all-gathered), and the
  recurrence runs chunk after chunk, each chunk's final state handed to
  the next chunk's slots (``mesh.axis_send``); every slot stores the last
  chunk's state (``mesh.axis_broadcast``).  The Mamba mixer likewise: the
  conv reads the d_conv - 1 inputs before its chunk (each chunk's last
  ones all-gathered), the scan's ``h`` is handed on and broadcast;
* the MoE FFN routes globally: the capacity counts the whole sequence, and
  each chunk's pairs queue behind the earlier rows' and its own row's
  earlier chunks' (the per-row expert counts all-gathered); a batch every
  slot holds whole is routed once, with no collective;
* the logits are the last chunk's last position, broadcast over the batch
  axis (``gather_last``).

A batch every slot holds whole writes its replicated states once all
slots have read them (slots that share a device share those blocks).

**The train step at such a batch** (``differentiable=True``) runs the same
split on the differentiable copies, with no cache:

* attention: each chunk's queries through ``layers._sdpa`` at ``q_offset``
  = the chunk's start over the keys of every position, all-gathered over
  the batch axis (one counted gather each for k and v, whose backward
  reduce-scatters the keys' gradient back to their chunks);
* the RWKV and Mamba recurrences run chunk after chunk, each chunk's final
  state handed to the next chunk's slots by ``mesh.axis_send``, whose
  backward hands the state's gradient back (a permute each way); the token
  shifts and the conv halo through the gathers above, whose backward
  reduce-scatters;
* the MoE FFN's queue as above, and its aux loss's f_e and p_e summed over
  the whole sequence by one all-reduce over the batch axis of each chunk's
  sums (none where every slot holds the batch whole);
* the loss (``train.losses.lm_loss_vocab_parallel`` with ``seq_axis``)
  scores each chunk's last position against the next chunk's first token
  (one counted gather of each chunk's first token and mask weight); only
  the last chunk drops its last position.  ``train.step`` divides each
  slot's share by the whole batch's count of scored pairs, and, where every
  slot holds the whole sequence, by R more, so that the sums over the batch
  axis (of the gradients, the loss and the aux) count the batch once.

**The encoder-decoder (whisper)**, at a batch the batch axis divides:
each slot takes its replica's rows of ``frames`` [B_r, N, D] and tokens.
The encoder adds the learned positions (replicated) and runs each layer's
bidirectional self-attention (``_attention(causal=False)``) and MLP as a
decoder's, tensor parallel over ``model``; every slot of a replica ends
with the same states.  Each decoder layer runs its causal self-attention,
then its cross-attention (``_attention(source=)``): ``wq`` and the
``wk``/``wv`` that read the encoder states column-parallel (gathered over
``model`` where the KV heads do not split), ``wo`` row-parallel with one
all-reduce; the states pass ``axis_sum_grads`` in the train step (each
slot's heads give a part of their gradient).  The tied embedding is
vocab-parallel where its spec splits the vocabulary.  Serving primes the
cross cache once (``partitioned_prime``: each slot writes its block of
``xk``/``xv``, its KV heads or its slice of ``head_dim``), and a serve step
reads those blocks as they are (a cache without ``cache_index``), made
whole over ``model`` for the call where ``head_dim`` is split.

**The encoder-decoder at a batch the batch axis does not divide** (one
audio request): ``frames`` [B, N, D] lie whole on every slot, as
``batch_shardings`` places them, the tokens as a decoder's
(``seq_layout``), and ``cache_shardings`` splits the cross cache's N
positions over the batch axis where R divides them.  The encoder's
positions lie as ``seq_layout(B, N, R)`` says (``_Slab.frames``):

* ``"chunks"`` (R divides N): slot ``(r, m)`` runs positions ``[r N / R,
  (r + 1) N / R)`` with the learned positions at that offset; each layer's
  bidirectional self-attention reads k/v all-gathered over the batch axis
  (one counted gather each, whose backward reduce-scatters), its MLP the
  chunk alone; every slot of index ``r`` ends with the same chunk of
  states;
* ``"whole"``: every slot runs the whole encoder.

The cross-attention reads all N positions with no mask: in the train,
eval and prefill steps each slot's queries over its chunk's ``wk``/``wv``
projections all-gathered over the batch axis (two gathers; their backward
sums each chunk's gradient over every slot's use), or over its own where
the states are whole.  ``partitioned_prime`` writes each slot's chunk's
projections into its block of ``xk``/``xv`` (the same positions, no
gather).  A serve step against that primed cache (``_cross_cp``): each
slot takes the decode partials of every query row over its own block
(``ops.attention_partials(causal=False)``; a chunked prompt's rows first
all-gathered over the batch axis, one counted gather), the partials are
all-gathered over the batch axis (one) and merged (``ops.attention_merge``),
and each slot keeps its own rows; a cross cache whole over the batch axis
is read by the rows' rule.

Every decoder (attention, Mamba and RWKV mixers; GLU, MLP, MoE and RWKV
channel-mix FFNs; RoPE or M-RoPE) and the encoder-decoder are partitioned
for training and serving at any batch size.  ``frames`` on a decoder and
the encoder (RoBERTa) raise ``NotImplementedError``
(``check_partitionable``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R
from repro_torch.models import transformer as T
from repro_torch.train.losses import lm_loss_vocab_parallel
from repro_torch.utils import op_counts as _oc
from repro_torch.utils.flat import dtype_of
from repro_torch.utils.placed import Layout, spec_axes

PATHS = {False: ("train step", "train"), True: ("serving steps", "serve")}


def refuse(cfg: ArchConfig, part: str, *, serving: bool = False):
    what, verb = PATHS[serving]
    raise NotImplementedError(
        f"the partitioned {what} does not run {cfg.name}'s {part} (ROADMAP.md A6c); "
        f"place its state on a grid of one slot (replica = model = 1) to {verb} it whole")


MIXERS = ("attn", "rwkv", "mamba")
FFNS = ("glu", "mlp", "moe", "rwkv_cm")


def check_partitionable(cfg: ArchConfig, batch_keys: Sequence[str] = (), *,
                        serving: bool = False) -> None:
    """Raise ``NotImplementedError`` naming the arch and the part the
    partitioned train step (or, with ``serving``, the partitioned prefill
    and decode steps) lacks.  Both take a decoder and the encoder-decoder
    at any batch size (``seq_layout``); the encoder stays refused, as does
    ``frames`` on a decoder."""
    if cfg.family == "encoder":
        refuse(cfg, "encoder (RoBERTa)", serving=serving)
    for blk in cfg.blocks:
        if blk.mixer not in MIXERS:
            refuse(cfg, f"{blk.mixer} mixer", serving=serving)
        if blk.ffn not in FFNS:
            refuse(cfg, f"{blk.ffn} FFN", serving=serving)
    if "frames" in batch_keys and not cfg.is_encoder_decoder:
        refuse(cfg, "batch input 'frames' (the encoder-decoder's)", serving=serving)


def seq_layout(B: int, S: int, R: int) -> Optional[str]:
    """How a step's tokens [B, S] lie over the R slots of the batch axis,
    by ``batch_shardings``' rule: None where R divides B (each replica its
    rows), else ``"chunks"`` where R divides S (each slot a chunk of the
    sequence, in order), else ``"whole"`` (every slot all of it)."""
    if B % R == 0:
        return None
    return "chunks" if S % R == 0 else "whole"


BATCH_AXES = ("replica", "data")
MODEL_AXIS = "model"


@dataclass(frozen=True, eq=False)
class Grid:
    """A slab's grid as the step's shardings name it (the reference's jit
    reads its ``in_shardings``): ``batch``, the batch axes (none, one, or
    several, such as the ``dp`` strategy's ``("data", "model")``), whose
    slots are ordered row-major with the first name major, as JAX orders a
    tuple ``PartitionSpec`` entry; ``model``, the model axis or None.  Every
    other mesh axis is ``replicated``: its slots run the same program on
    the same blocks, and no collective crosses it."""

    mesh: M.Mesh
    batch: Tuple[str, ...]
    model: Optional[str]

    @property
    def replicated(self) -> Tuple[str, ...]:
        return tuple(a for a in self.mesh.axis_names
                     if a not in self.batch and a != self.model)

    @property
    def dp(self):
        """The batch axes as ``launch.mesh``'s collectives take them: None,
        a name, or a tuple of names."""
        return M.axis_key(self.batch) if self.batch else None

    @property
    def R(self) -> int:
        return self.mesh.extent(self.batch)

    @property
    def M(self) -> int:
        return self.mesh.extent(self.model)

    def check(self, layouts: Dict[str, Layout]) -> None:
        """``ValueError`` for a leaf placed on another grid, or split over
        an axis that is neither a batch axis nor the model axis."""
        names, devices = self.mesh.axis_names, list(self.mesh.devices.flat)
        ok = set(self.batch) | {self.model}
        for name, lay in layouts.items():
            if lay.mesh.axis_names != names or list(lay.mesh.devices.flat) != devices:
                raise ValueError(f"{name} is placed on {lay.mesh!r}, the grid is {self.mesh!r}")
            for d, axes in enumerate(lay.spec):
                if set(axes) - ok:
                    raise ValueError(
                        f"{name}: dim {d} is split over {axes}; the step's batch axes are "
                        f"{self.batch} and its model axis {self.model!r}")


def as_grid(grid) -> Grid:
    """A ``Grid`` as it is; a ``Mesh`` read ``FROM_MESH``."""
    return grid if isinstance(grid, Grid) else make_grid(grid)


def make_grid(mesh: M.Mesh, data_axis=M.FROM_MESH, model_axis=M.FROM_MESH) -> Grid:
    """The grid of ``mesh`` for a step whose shardings use ``data_axis`` (a
    name, a tuple of names, or None) and ``model_axis`` (a name or None),
    the reference's sharding functions' keywords.  ``FROM_MESH`` reads them
    from the axis names: the mesh's ``replica`` or ``data`` axis, and
    ``model`` where the mesh has it and it is not a batch axis; any other
    axis (the multi-pod mesh's ``pod``) is replicated."""
    if data_axis is M.FROM_MESH:
        batch = tuple(a for a in mesh.axis_names if a in BATCH_AXES)
        if len(batch) > 1:
            raise ValueError(f"a grid over {mesh.axis_names}: name its batch axes (data_axis=)")
    else:
        batch = spec_axes(data_axis)
    if model_axis is M.FROM_MESH:
        model_axis = MODEL_AXIS if MODEL_AXIS in mesh.axis_names and MODEL_AXIS not in batch \
            else None
    for a in batch + spec_axes(model_axis):
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} is not an axis of {mesh!r}")
    if model_axis is not None and (not isinstance(model_axis, str) or model_axis in batch):
        raise ValueError(f"model_axis {model_axis!r}: one axis, not a batch axis ({batch})")
    if len(set(batch)) != len(batch):
        raise ValueError(f"repeated batch axis in {batch}")
    return Grid(mesh, batch, model_axis)


class _Slab:
    """One slab's per-slot parameter tensors and their layouts, on ``grid``."""

    def __init__(self, cfg: ArchConfig, grid, live: Dict[str, List[torch.Tensor]],
                 layouts: Dict[str, Layout], seq: Optional[str] = None):
        grid = as_grid(grid)
        self.cfg, self.grid, self.live, self.layouts = cfg, grid, live, layouts
        self.mesh = grid.mesh
        self.dp, self.mp = grid.dp, grid.model
        self.n = self.mesh.devices.size
        self.M, self.R = grid.M, grid.R
        self.seq = seq   # seq_layout's: None, "chunks" or "whole"
        self.frames = None   # the encoder's positions: seq_layout's (B, N, R), _whisper_encode

    def by_chunk(self) -> List[List[int]]:
        """The slots of each index of the batch axes, in order."""
        return [[s for s in range(self.n) if self.mesh.coord(s, self.dp) == r]
                for r in range(self.R)]

    def spec(self, name: str, stacked: bool):
        spec = self.layouts[name].spec
        return spec[1:] if stacked else spec

    def split_over_model(self, name: str, dim: int, stacked: bool = False) -> bool:
        return self.mp is not None and self.mp in self.spec(name, stacked)[dim]

    def weight(self, name: str, rep: Optional[int] = None) -> List[torch.Tensor]:
        """Slot tensors of leaf ``name`` (layer ``rep`` of a stacked one),
        all-gathered over the batch axis on every dim FSDP splits."""
        parts = self.live[name]
        if rep is not None:
            parts = [x[rep] for x in parts]
        batch = self.grid.batch
        for d, axes in enumerate(self.spec(name, rep is not None)):
            if set(axes) & set(batch):
                if axes != batch:
                    raise NotImplementedError(f"{name}: dim {d} split over {axes}, the batch "
                                              f"axes are {batch}")
                with _oc.operand_split():
                    parts = M.axis_all_gather(parts, self.mesh, self.dp, d)
        return parts

    def norm(self, prefix: str, rep, x: List[torch.Tensor]) -> List[torch.Tensor]:
        keys = ["scale"] + (["bias"] if self.cfg.norm == "layernorm" else [])
        ws = {k: self.weight(f"{prefix}/{k}", rep) for k in keys}
        return [L.norm_fwd(self.cfg, {k: ws[k][s] for k in keys}, x[s]) for s in range(self.n)]

    def whole_over_model(self, blocks: List[torch.Tensor], dim: int, full: int):
        """Each slot's state ``blocks`` whole along ``dim`` (``full`` long):
        all-gathered over ``model`` (counted) where the cache's spec splits
        that dim, else as they are."""
        if blocks[0].shape[dim] == full:
            return blocks
        return M.axis_all_gather(blocks, self.mesh, self.mp, dim)

    def model_slice(self, s: int, x: torch.Tensor, dim: int, block: int) -> torch.Tensor:
        """Slot ``s``'s block of ``x`` along ``dim`` (``block`` long) where
        the cache splits it over ``model``; all of ``x`` otherwise."""
        if x.shape[dim] == block:
            return x
        m = self.mesh.coord(s, self.mp)
        return x.narrow(dim, m * block, block)


def _kv_heads(sl: _Slab, s: int, hq: int, k: torch.Tensor, v: torch.Tensor):
    """Slot ``s``'s KV heads for its ``hq`` query heads from all ``Hkv``
    (query head h reads kv head h // (Hq / Hkv)): the few its heads read
    where they form whole groups or share one, else one a query head."""
    rep_q = sl.cfg.num_heads // sl.cfg.num_kv_heads
    first = sl.mesh.coord(s, sl.mp) * hq
    if hq % rep_q == 0 or rep_q % hq == 0:
        lo, n = first // rep_q, max(1, hq // rep_q)
        return k[:, :, lo:lo + n].contiguous(), v[:, :, lo:lo + n].contiguous()
    idx = torch.tensor([(first + j) // rep_q for j in range(hq)], device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _each(n: int, fn) -> list:
    """``[fn(s) for s in range(n)]``, each call's kernel work booked to its
    slot (``utils.op_counts.at_slot``: a dry run's busiest slot)."""
    out = []
    for s in range(n):
        with _oc.at_slot(s):
            out.append(fn(s))
    return out


def _kv_weights(sl: _Slab, pre: str, rep, split: bool, kv_split: bool):
    """Each slot's ``wk`` and ``wv``: its column blocks where the KV heads
    split over ``model``; all-gathered over ``model`` where they do not but
    the spec splits the columns; else whole, passing ``axis_sum_grads``
    (each slot uses its query heads' share)."""
    kv = {}
    for k in ("wk", "wv"):
        w = sl.weight(f"{pre}/{k}", rep)
        if split and not kv_split:
            if sl.split_over_model(f"{pre}/{k}", -1, rep is not None):
                w = M.axis_all_gather(w, sl.mesh, sl.mp, w[0].dim() - 1)
            else:
                w = M.axis_sum_grads(w, sl.mesh, sl.mp)
        kv[k] = w
    return kv


def _heads(sl: _Slab, pre: str, rep, differentiable: bool):
    """``(split, kv_split, hq, hkv, q_whole)``: whether the spec splits the
    query heads' columns (and the KV heads) over ``model``, a slot's counts
    of each, and whether every slot runs all ``Hq`` query heads: the spec
    splits ``wq``'s columns but M does not divide the heads, so ``wq`` is
    all-gathered over ``model`` and the attention replicated on every slot
    (the reference's GSPMD program for such a layout)."""
    cfg, stacked = sl.cfg, rep is not None
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    split = sl.split_over_model(f"{pre}/wq", -1, stacked)
    if not split:
        for k in ("wk", "wv", "wo"):
            if sl.split_over_model(f"{pre}/{k}", -1 if k != "wo" else 0, stacked):
                refuse(cfg, f"attention with {k} split over model and wq whole",
                       serving=not differentiable)
    q_whole = split and Hq % sl.M != 0
    if q_whole and not sl.split_over_model(f"{pre}/wo", 0, stacked):
        refuse(cfg, "attention with wq's columns split over model and wo's rows whole",
               serving=not differentiable)
    kv_split = split and Hkv % sl.M == 0
    hq = Hq // sl.M if split and not q_whole else Hq
    return split, kv_split, hq, Hkv // sl.M if kv_split else Hkv, q_whole


def _attention(sl: _Slab, pre: str, rep, blk, h, angles, *, cache=None, cache_index=None,
               cache_len: Optional[int] = None, differentiable: bool = True,
               causal: bool = True, source=None):
    """Each slot's attention output [B_r, S, D] (the module docstring).
    ``source[s]`` (the encoder's states, whole over ``model``; they pass
    ``axis_sum_grads``) gives the keys and values in place of ``h``: a
    cross-attention.  A ``cache`` without ``cache_index`` is a primed cross
    cache: its blocks are the keys and values, read and never written, and
    ``wk``/``wv`` are not used.  ``cache_len`` is the cache's length (its
    layout's), which tells a block split over the batch axis."""
    cfg, mesh, mp = sl.cfg, sl.mesh, sl.mp
    hd = cfg.head_dim
    split, kv_split, hq, hkv, q_whole = _heads(sl, pre, rep, differentiable)
    primed = cache is not None and cache_index is None
    wq, wo = sl.weight(f"{pre}/wq", rep), sl.weight(f"{pre}/wo", rep)
    if q_whole:  # every query head on every slot: wq's column blocks gathered
        wq = M.axis_all_gather(wq, mesh, mp, wq[0].dim() - 1)
    kv = None if primed else _kv_weights(sl, pre, rep, split, kv_split)
    if split:
        h = M.axis_sum_grads(h, mesh, mp)
        if source is not None:
            source = M.axis_sum_grads(source, mesh, mp)
    src = h if source is None else source
    qs, ks, vs = [], [], []
    for s in range(sl.n):
        x = h[s]
        B, S, _ = x.shape
        ang = None if angles[s] is None else angles[s][blk.rope_theta or cfg.rope.theta]
        q = (x @ wq[s]).reshape(B, S, hq, hd)
        if ang is not None:
            q = L.apply_rope(q, ang)
        qs.append(q)
        if kv is not None:
            y = src[s]
            k = (y @ kv["wk"][s]).reshape(B, y.shape[1], hkv, hd)
            if ang is not None and source is None:
                k = L.apply_rope(k, ang)
            ks.append(k)
            vs.append((y @ kv["wv"][s]).reshape(B, y.shape[1], hkv, hd))
    select = split and not kv_split and not q_whole
    if sl.seq is not None and primed:
        attn = _cross_cp(sl, blk, qs, hq, hkv, select, cache, cache_len)
    elif sl.seq is not None and not causal:  # the encoder's, or a cross-attention over it
        if sl.frames == "chunks":  # every position's k/v from the chunks over the batch axis
            ks = M.axis_all_gather(ks, mesh, sl.dp, 1)
            vs = M.axis_all_gather(vs, mesh, sl.dp, 1)
        attn = _attention_rows(sl, blk, qs, ks, vs, hq, hkv, select, None, None, differentiable,
                               causal=False)
    elif sl.seq is not None and differentiable:
        attn = _attention_cp_train(sl, blk, qs, ks, vs, hq, select)
    elif sl.seq is not None:
        attn = _attention_cp(sl, blk, qs, ks, vs, hq, hkv, select, cache, cache_index, cache_len)
    else:
        attn = _attention_rows(sl, blk, qs, ks, vs, hq, hkv, select, cache, cache_index,
                               differentiable, causal)
    outs = []
    for s, a in enumerate(attn):
        a = a.reshape(a.shape[0], a.shape[1], hq * hd)
        if q_whole:  # the slot's column block of the output, for its rows of wo
            width = wo[s].shape[0]
            a = a.narrow(2, mesh.coord(s, mp) * width, width)
        outs.append(a @ wo[s])
    if split:
        outs = M.axis_all_reduce(outs, mesh, mp)
    return [o.to(x.dtype) for o, x in zip(outs, h)]


def _attention_rows(sl: _Slab, blk, qs, ks, vs, hq: int, hkv: int, select: bool, cache,
                    cache_index, differentiable: bool, causal: bool = True):
    """Each slot's attention output [B_r, S, hq, hd] over its replica's
    rows: its own keys, or (serving) its block of the cache after the new
    k/v are written into it at ``cache_index`` (a primed cache, without
    one, as it is).  ``select``: each slot picks its query heads' KV heads
    (``_kv_heads``)."""
    hd = sl.cfg.head_dim
    ring = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        if cache_index is not None:  # each slot's part of the new k/v into its block, in place
            S = qs[0].shape[1]
            i, ring = L.cache_slot(ck[0].shape[1], cache_index, S, blk.window)
            for s in range(sl.n):
                _write_kv(sl, s, ck, cv, ks[s], vs[s], slice(i, i + S), slice(None))
        # the keys each slot attends over: its block, made whole over model
        # where the cache's spec splits the heads or head_dim off the slot's
        ks = sl.whole_over_model(sl.whole_over_model(ck, 3, hd), 2, hkv)
        vs = sl.whole_over_model(sl.whole_over_model(cv, 3, hd), 2, hkv)

    def one(s):
        q, k, v = qs[s], ks[s], vs[s]
        if select:
            k, v = _kv_heads(sl, s, hq, k, v)
        if differentiable:
            return L._sdpa(q, k, v, causal=causal, window=blk.window)
        return L.kernel_attention(q, k, v, causal=causal, window=blk.window,
                                  q_offset=0 if cache_index is None else int(cache_index),
                                  ring=ring)

    return _each(sl.n, one)


def _write_kv(sl: _Slab, s: int, ck, cv, k, v, dst: slice, src: slice) -> None:
    """Slot ``s``'s heads and head_dim of the new ``k``/``v`` positions
    ``src`` into its cache blocks at ``dst``, in place."""
    for blocks, new in ((ck, k), (cv, v)):
        part = sl.model_slice(s, new[:, src], 2, blocks[s].shape[2])
        blocks[s][:, dst] = sl.model_slice(s, part, 3, blocks[s].shape[3]).to(blocks[s].dtype)


def _partials(q, k, v, causal: bool = True, **kw) -> torch.Tensor:
    """``ops.attention_partials`` of q's heads in g groups a kv head, g the
    fewest that leave each call at most ``DECODE_ROWS`` rows a kv head:
    [B, Hkv g, n_splits, rows / g, 2 + hd], group ``i`` of kv head ``h``
    at index ``h g + i``, so that the merge writes the heads in their
    order.  Without the causal mask the split plan does not depend on the
    query rows, so more rows than one call takes (a prompt's) run a piece
    of ``DECODE_ROWS`` rows at a time, concatenated in their order."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    g = next((g for g in range(1, rep + 1)
              if rep % g == 0 and Sq * rep // g <= FA.DECODE_ROWS), None)
    if g is None and causal:
        raise ValueError(f"causal partials of {Sq} query rows on {rep} heads a kv head: at most "
                         f"{FA.DECODE_ROWS} rows a kv head")
    g = g or rep
    per = max(1, FA.DECODE_ROWS // (rep // g))    # query positions a call

    def rows(qh):
        if Sq <= per:
            return ops.attention_partials(qh, k, v, causal=causal, **kw)
        return torch.cat([ops.attention_partials(qh[:, i:i + per].contiguous(), k, v,
                                                 causal=causal, **kw)
                          for i in range(0, Sq, per)], 3)

    if g == 1:
        return rows(q)
    qg = q.reshape(B, Sq, Hkv, g, rep // g, hd)
    parts = [rows(qg[:, :, :, i].reshape(B, Sq, Hkv * rep // g, hd).contiguous())
             for i in range(g)]
    return torch.stack(parts, 2).reshape((B, Hkv * g) + tuple(parts[0].shape[2:]))


def _cross_cp(sl: _Slab, blk, qs, hq: int, hkv: int, select: bool, cache,
              cache_len: Optional[int]):
    """Each slot's cross-attention output [B, S, hq, hd] against the primed
    cross cache at a batch the batch axis does not divide (the module
    docstring): every query row sees all N positions.  Where the cache's
    positions split over the batch axis, each slot takes the partials of
    every row over its own block (a chunked prompt's rows all-gathered over
    the batch axis first), the partials are all-gathered over it and
    merged, and each slot keeps its rows; a cache whole over the batch axis
    takes the rows' rule."""
    mesh, dp, hd = sl.mesh, sl.dp, sl.cfg.head_dim
    ck, cv = cache["k"], cache["v"]
    if ck[0].shape[1] == cache_len:
        return _attention_rows(sl, blk, qs, None, None, hq, hkv, select, cache, None, False,
                               causal=False)
    S = qs[0].shape[1]
    chunks = sl.seq == "chunks"
    rows = M.axis_all_gather(qs, mesh, dp, 1) if chunks else qs
    kb = sl.whole_over_model(sl.whole_over_model(ck, 3, hd), 2, hkv)
    vb = sl.whole_over_model(sl.whole_over_model(cv, 3, hd), 2, hkv)

    def part(s):
        k, v = _kv_heads(sl, s, hq, kb[s], vb[s]) if select else (kb[s], vb[s])
        return _partials(rows[s], k, v, causal=False)

    parts = M.axis_all_gather(_each(sl.n, part), mesh, dp, 2)

    def merged(s):
        o = ops.attention_merge(parts[s], rows[s].shape[1], qs[s].dtype)
        return o[:, mesh.coord(s, dp) * S:(mesh.coord(s, dp) + 1) * S] if chunks else o

    return _each(sl.n, merged)


def _attention_cp_train(sl: _Slab, blk, qs, ks, vs, hq: int, select: bool):
    """The train step's attention at a batch the batch axis does not
    divide: each chunk's queries through ``layers._sdpa`` at ``q_offset`` =
    the chunk's start over the keys of every position, all-gathered over
    the batch axis (one counted gather each for k and v, whose backward
    reduce-scatters); a sequence every slot holds whole over its own."""
    mesh, dp = sl.mesh, sl.dp
    S = qs[0].shape[1]
    chunks = sl.seq == "chunks"
    if chunks:
        ks = M.axis_all_gather(ks, mesh, dp, 1)
        vs = M.axis_all_gather(vs, mesh, dp, 1)
    outs = []
    for s in range(sl.n):
        k, v = _kv_heads(sl, s, hq, ks[s], vs[s]) if select else (ks[s], vs[s])
        outs.append(L._sdpa(qs[s], k, v, causal=True, window=blk.window,
                            q_offset=mesh.coord(s, dp) * S if chunks else 0))
    return outs


def _attention_cp(sl: _Slab, blk, qs, ks, vs, hq: int, hkv: int, select: bool, cache,
                  cache_index, cache_len: Optional[int]):
    """Each slot's attention output [B, S, hq, hd] at a batch the batch
    axis does not divide (the module docstring): a prompt's chunk over the
    gathered keys of the whole prompt, a replicated prompt over its own, a
    decode step's partials over the slot's block of the cache merged over
    the batch axis."""
    cfg, mesh, dp = sl.cfg, sl.mesh, sl.dp
    hd, R = cfg.head_dim, sl.R
    S, start = qs[0].shape[1], int(cache_index or 0)
    chunks = sl.seq == "chunks"
    ck = cv = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
    seq_split = ck is not None and ck[0].shape[1] != cache_len
    if start and (chunks or (seq_split and S > 1)):
        refuse(cfg, f"step of {S * (R if chunks else 1)} positions at cache_index {start} at a "
               "batch the batch axis does not divide (a chunked prefill)", serving=True)

    def heads(s, k, v):
        return _kv_heads(sl, s, hq, k, v) if select else (k, v)

    if start and not seq_split:  # the cache whole over the batch axis: the rows' rule
        return _attention_rows(sl, blk, qs, ks, vs, hq, hkv, select, cache, cache_index, False)
    if start:  # one token against the blocks of a cache split over the batch axis
        places = [L.cache_block(cache_len, start, blk.window, mesh.coord(s, dp), R)
                  for s in range(sl.n)]
        for s, (write, _, _) in enumerate(places):
            if write is not None:
                _write_kv(sl, s, ck, cv, ks[s], vs[s], slice(write, write + 1), slice(None))
        kb = sl.whole_over_model(sl.whole_over_model(ck, 3, hd), 2, hkv)
        vb = sl.whole_over_model(sl.whole_over_model(cv, 3, hd), 2, hkv)
        parts = M.axis_all_gather(
            _each(sl.n, lambda s: _partials(qs[s], *heads(s, kb[s], vb[s]), causal=True,
                                            window=places[s][2], q_offset=places[s][1])),
            mesh, dp, 2)
        return _each(sl.n, lambda s: ops.attention_merge(parts[s], S, qs[s].dtype))

    # a prompt at position 0: every position's k/v on every slot
    if chunks:
        ks = M.axis_all_gather(ks, mesh, dp, 1)
        vs = M.axis_all_gather(vs, mesh, dp, 1)
    total = ks[0].shape[1]
    if cache is not None:  # each slot writes the positions its block holds
        L.cache_slot(cache_len, 0, total, blk.window)   # the prompt must fit, as whole
        blen = ck[0].shape[1]
        for s in range(sl.n):
            r = mesh.coord(s, dp) if seq_split else 0
            src, dst, count = L.block_span(0, total, r, blen)
            if count:
                _write_kv(sl, s, ck, cv, ks[s], vs[s], slice(dst, dst + count),
                          slice(src, src + count))
    return _each(sl.n, lambda s: L.kernel_attention(
        qs[s], *heads(s, ks[s], vs[s]), causal=True, window=blk.window,
        q_offset=mesh.coord(s, dp) * S if chunks else 0))


def _ffn(sl: _Slab, pre: str, rep, kind: str, h, *, serving: bool = False):
    cfg, mesh, mp = sl.cfg, sl.mesh, sl.mp
    stacked = rep is not None
    split = sl.split_over_model(f"{pre}/w_up", -1, stacked)
    if split != sl.split_over_model(f"{pre}/w_down", 0, stacked):
        refuse(cfg, f"{kind} with w_up and w_down split differently over model", serving=serving)
    act = L.activation(cfg.act)
    up, down = sl.weight(f"{pre}/w_up", rep), sl.weight(f"{pre}/w_down", rep)
    gate = sl.weight(f"{pre}/w_gate", rep) if kind == "glu" else None
    if split:
        h = M.axis_sum_grads(h, mesh, mp)
    outs = []
    for s in range(sl.n):
        if kind == "glu":
            outs.append((act(h[s] @ gate[s]) * (h[s] @ up[s])) @ down[s])
        else:
            outs.append(act(h[s] @ up[s]) @ down[s])
    return M.axis_all_reduce(outs, mesh, mp) if split else outs


def _moe(sl: _Slab, pre: str, rep, h, *, differentiable: bool):
    """The expert-parallel MoE FFN with the reference's global routing (the
    module docstring): each slot's output and, in the train step, each
    slot's aux loss of the whole batch (None when serving)."""
    cfg, mesh, mp, dp = sl.cfg, sl.mesh, sl.mp, sl.dp
    stacked = rep is not None
    E, D = cfg.moe.num_experts, cfg.d_model
    ep = sl.split_over_model(f"{pre}/w_gate", 0, stacked)   # experts over model
    fp = sl.split_over_model(f"{pre}/w_gate", 2, stacked)   # F over model (the lever)
    if (ep and fp) or any(sl.split_over_model(f"{pre}/{k}", 0, stacked) != ep
                          or sl.split_over_model(f"{pre}/{k}", f_dim, stacked) != fp
                          for k, f_dim in (("w_up", 2), ("w_down", 1))) or any(
            sl.split_over_model(f"{pre}/router", d, stacked) for d in (0, 1)):
        refuse(cfg, "MoE FFN with its leaves split otherwise than by experts or by F",
               serving=not differentiable)
    router = sl.weight(f"{pre}/router", rep)
    ws = {k: sl.weight(f"{pre}/{k}", rep) for k in ("w_gate", "w_up", "w_down")}
    # a batch every slot holds whole (seq_layout's "whole") is routed once
    R, n = (1 if sl.seq == "whole" else mesh.extent(dp)), sl.n
    xt = [x.reshape(-1, D) for x in h]
    tokens = R * xt[0].shape[0]
    sel = [MOE._router(cfg, {"router": router[s]}, xt[s]) for s in range(n)]
    ahead = [None] * n
    if R > 1 and MOE._routing(cfg) != "dense" and sl.seq == "chunks":
        ahead = _chunk_queues(sl, [idx for _, idx, _ in sel], h[0].shape[0], E)
    elif R > 1 and MOE._routing(cfg) != "dense":
        # each replica's pairs on each expert, gathered: replica r queues behind r' < r
        counts = M.axis_all_gather([MOE.pair_counts(idx, E)[None] for _, idx, _ in sel],
                                   mesh, dp, 0)
        ahead = [c[:mesh.coord(s, dp)].sum(0) for s, c in enumerate(counts)]
    plans = [MOE.plan(cfg, *sel[s], tokens=tokens if R > 1 else None, ahead=ahead[s])
             for s in range(n)]
    aux = None
    if differentiable:  # the global f_e and p_e: one all-reduce of each replica's sums
        sums = [torch.cat([F.one_hot(pl.topk_idx[:, 0], E).float().sum(0), pl.probs.sum(0)])
                for pl in plans]
        if R > 1:
            sums = M.axis_all_reduce(sums, mesh, dp)
        aux = [E * torch.sum((t[:E] / tokens) * (t[E:] / tokens)) for t in sums]
    split = ep or fp
    xin = xt
    if split:  # a slot's experts see only its share: sum their gradients over model
        weights = M.axis_sum_grads([pl.topk_w for pl in plans], mesh, mp)
        plans = [pl._replace(topk_w=w) for pl, w in zip(plans, weights)]
        xin = M.axis_sum_grads(xt, mesh, mp)
    per = E // sl.M if ep else E
    outs = []
    for s in range(n):
        lo = mesh.coord(s, mp) * per if ep else 0
        out = MOE.experts(cfg, {k: w[s] for k, w in ws.items()}, xin[s], plans[s], lo, lo + per)
        outs.append(out.reshape(h[s].shape))
    return (M.axis_all_reduce(outs, mesh, mp) if split else outs), aux


def _chunk_queues(sl: _Slab, idx: List[torch.Tensor], B: int, E: int) -> List[torch.Tensor]:
    """Each slot's pairs queued ahead of each of its tokens' on each expert,
    [B c, E], where the batch axis splits the sequence into chunks of c:
    each chunk's count of each row's pairs on each expert, all-gathered
    over the batch axis (one counted gather), places a token behind the
    rows before its own (every chunk of them) and its own row's earlier
    chunks, the reference's cumsum over the global token order (row by
    row, each row's chunks in order); ``MOE.plan`` adds its place among
    the block's own pairs, which already counts the block's rows before
    its own."""
    counts = M.axis_all_gather([F.one_hot(i.reshape(B, -1), E).sum(1)[None] for i in idx],
                               sl.mesh, sl.dp, 0)               # [R, B, E] on every slot
    out = []
    for s, c in enumerate(counts):
        r = sl.mesh.coord(s, sl.dp)
        rows = c.sum(0)
        ahead = torch.cumsum(rows, 0) - rows + c[:r].sum(0) - (torch.cumsum(c[r], 0) - c[r])
        out.append(ahead.repeat_interleave(idx[s].shape[0] // B, 0))
    return out


# the time mix's leaves by the dim the reference's rules split over model:
# the head-parallel ones; ``mu`` and ``lora_mix`` stay whole
_TIME_MIX_SPLIT = {"wr": -1, "wk": -1, "wv": -1, "wg": -1, "lora_w/b": -1, "w0": 0, "u": 0,
                   "ln_scale": 0, "ln_bias": 0, "wo": 0}
_TIME_MIX_WHOLE = ("mu", "lora_mix/a", "lora_mix/b", "lora_w/a")


def _shift_state(sl: _Slab, blocks, D: int):
    """Each slot's token-shift state [B, 1, D] whole: gathered over model
    (counted) where the cache splits D."""
    return None if blocks is None else sl.whole_over_model(blocks, 2, D)


def _store_shift(sl: _Slab, blocks, h):
    """Each slot's slice of its last position ``h[s][:, -1:]`` into its
    shift block, in place."""
    for s in range(sl.n):
        blocks[s].copy_(sl.model_slice(s, h[s][:, -1:], 2, blocks[s].shape[2]))


def _chunk_order(sl: _Slab) -> List[List[int]]:
    """The order a recurrence runs the slots in: chunk by chunk where the
    batch axis splits the sequence (each chunk starts from the state the
    one before ends in), else all at once."""
    return sl.by_chunk() if sl.seq == "chunks" else [list(range(sl.n))]


def _chunk_shift(sl: _Slab, h, last):
    """``(each slot's token-shift input before its first position, the rows
    whose last position the cache keeps)``: ``last`` (the cache's state, or
    None) and ``h``; where the batch axis splits the sequence, each chunk's
    last position all-gathered over it (one counted gather), chunk ``r``
    taking chunk ``r - 1``'s (chunk 0 ``last``) and every slot keeping the
    last chunk's."""
    if sl.seq != "chunks":
        return [None] * sl.n if last is None else last, h
    tails = M.axis_all_gather([x[:, -1:] for x in h], sl.mesh, sl.dp, 1)   # [B, R, D]
    prev = []
    for s in range(sl.n):
        r = sl.mesh.coord(s, sl.dp)
        prev.append(tails[s][:, r - 1:r] if r else (None if last is None else last[s]))
    return prev, tails


def _chain(sl: _Slab, r: int, finals, starts) -> None:
    """Chunk ``r``'s final states handed to chunk ``r + 1``'s slots as their
    initial ones (one counted send over the batch axis)."""
    if sl.seq == "chunks" and r + 1 < sl.R:
        nxt = M.axis_send(finals, sl.mesh, sl.dp, r)
        for t in sl.by_chunk()[r + 1]:
            starts[t] = nxt[t]


def _final_states(sl: _Slab, finals):
    """The states every slot stores: its own, or where the batch axis splits
    the sequence the last chunk's, broadcast over it (counted)."""
    if sl.seq == "chunks":
        return M.axis_broadcast(finals, sl.mesh, sl.dp, sl.R - 1)
    return finals


def _time_mix(sl: _Slab, pre: str, rep, h, *, cache=None, differentiable: bool = False):
    """The head-parallel RWKV6 time mix (the module docstring): each slot
    ``rwkv.time_mix_heads`` on its heads' blocks (the plain recurrence when
    ``differentiable``, else ``rwkv6_scan``), ``wo`` row-parallel."""
    cfg, mesh, mp = sl.cfg, sl.mesh, sl.mp
    stacked = rep is not None
    split = sl.split_over_model(f"{pre}/wr", -1, stacked)
    if any(sl.split_over_model(f"{pre}/{k}", d, stacked) != split
           for k, d in _TIME_MIX_SPLIT.items()) or any(
            sl.split_over_model(f"{pre}/{k}", d, stacked) for k in _TIME_MIX_WHOLE
            for d in range(len(sl.spec(f"{pre}/{k}", stacked)))):
        refuse(cfg, "RWKV time mix with its leaves split otherwise than by heads",
               serving=not differentiable)
    ws = {k: sl.weight(f"{pre}/{k}", rep) for k in tuple(_TIME_MIX_SPLIT) + _TIME_MIX_WHOLE}
    if split:  # whole on every slot, each using its heads' share: sum their gradients
        for k in _TIME_MIX_WHOLE:
            ws[k] = M.axis_sum_grads(ws[k], mesh, mp)
    last = _shift_state(sl, None if cache is None else cache["shift"], cfg.d_model)
    if split:
        h = M.axis_sum_grads(h, mesh, mp)
    prev, tails = _chunk_shift(sl, h, last)
    starts = [None if cache is None else cache["S"][s] for s in range(sl.n)]
    outs, finals = [None] * sl.n, [None] * sl.n
    for r, slots in enumerate(_chunk_order(sl)):
        for s in slots:
            p = {k: ws[k][s] for k in ("mu", "w0", "u", "wr", "wk", "wv", "wg", "ln_scale",
                                       "ln_bias")}
            p["lora_mix"] = {"a": ws["lora_mix/a"][s], "b": ws["lora_mix/b"][s]}
            p["lora_w"] = {"a": ws["lora_w/a"][s], "b": ws["lora_w/b"][s]}
            with _oc.at_slot(s):
                yg, finals[s] = R.time_mix_heads(cfg, p, h[s], R._token_shift(h[s], prev[s]),
                                                 s0=starts[s], differentiable=differentiable)
            outs[s] = yg @ ws["wo"][s]
        _chain(sl, r, finals, starts)
    if cache is not None:  # after every slot has read its state: replicated blocks are shared
        for block, final in zip(cache["S"], _final_states(sl, finals)):
            block.copy_(final)
        _store_shift(sl, cache["shift"], tails)
    return M.axis_all_reduce(outs, mesh, mp) if split else outs


def _channel_mix(sl: _Slab, pre: str, rep, h, *, cache=None, serving: bool = True):
    """The RWKV channel mix, whole on every slot (no rule splits it)."""
    stacked = rep is not None
    names = ("mu_k", "mu_r", "wk", "wv", "wr")
    if any(sl.split_over_model(f"{pre}/{k}", d, stacked) for k in names
           for d in range(len(sl.spec(f"{pre}/{k}", stacked)))):
        refuse(sl.cfg, "RWKV channel mix split over model", serving=serving)
    ws = {k: sl.weight(f"{pre}/{k}", rep) for k in names}
    last = _shift_state(sl, None if cache is None else cache["cm_shift"], sl.cfg.d_model)
    prev, tails = _chunk_shift(sl, h, last)
    outs = [R.channel_mix_fwd(sl.cfg, {k: ws[k][s] for k in names}, h[s], last=prev[s])[0]
            for s in range(sl.n)]
    if cache is not None:
        _store_shift(sl, cache["cm_shift"], tails)
    return outs


# the Mamba mixer's leaves by the dim the reference's rules split over model:
# every one by its d_inner channels (in_proj's 2·di columns as one dim)
_MAMBA_SPLIT = {"in_proj": -1, "conv_w": -1, "conv_b": 0, "x_proj": 0, "dt_proj": -1,
                "dt_bias": 0, "A_log": 0, "D": 0, "out_proj": 0}


def _mamba(sl: _Slab, pre: str, rep, h, *, cache=None, differentiable: bool = False):
    """The channel-parallel Mamba mixer (the module docstring): each slot
    runs ``mamba``'s channel-local parts on its block of the d_inner
    channels, against its blocks of the state ``h`` and ``conv``."""
    cfg, mesh, mp = sl.cfg, sl.mesh, sl.mp
    stacked = rep is not None
    split = sl.split_over_model(f"{pre}/in_proj", -1, stacked)
    if any(sl.split_over_model(f"{pre}/{k}", d, stacked) != split
           for k, d in _MAMBA_SPLIT.items()):
        refuse(cfg, "Mamba mixer with its leaves split otherwise than by channels",
               serving=not differentiable)
    ws = {k: sl.weight(f"{pre}/{k}", rep) for k in _MAMBA_SPLIT}
    di = MB.d_inner(cfg)
    c = di // sl.M if split else di
    if split:
        h = M.axis_sum_grads(h, mesh, mp)
    xz = [h[s] @ ws["in_proj"][s] for s in range(sl.n)]
    if split:  # slot m's columns of [xi | z] are neither's channels m: gather the product
        xz = M.axis_all_gather(xz, mesh, mp, xz[0].dim() - 1)
    ps = [{k: ws[k][s] for k in _MAMBA_SPLIT} for s in range(sl.n)]
    xis, zs = [], []
    for s in range(sl.n):
        lo = mesh.coord(s, mp) * c if split else 0
        xis.append(xz[s][..., lo:lo + c])
        zs.append(xz[s][..., di + lo:di + lo + c])
    prepends, windows = _conv_halo(sl, xis, None if cache is None else cache["conv"])
    xcs = [MB._conv(cfg, ps[s], xis[s], prepend=prepends[s]) for s in range(sl.n)]
    partial = [MB.x_proj(ps[s], xc) for s, xc in enumerate(xcs)]
    if split:  # row-parallel x_proj; every channel reads the whole dt_low, B and C
        proj = M.axis_sum_grads(M.axis_all_reduce(partial, mesh, mp), mesh, mp)
    else:
        proj = partial
    starts = [None if cache is None else cache["h"][s] for s in range(sl.n)]
    outs, finals = [None] * sl.n, [None] * sl.n
    for r, slots in enumerate(_chunk_order(sl)):
        for s in slots:
            dA, dBx, Cmat = MB._ssm_inputs(cfg, ps[s], xcs[s], proj=proj[s])
            with _oc.at_slot(s):
                ys, finals[s] = MB.selective_scan(dA, dBx, Cmat, starts[s])
            outs[s] = MB.gated(ps[s], ys, xcs[s], zs[s]) @ ws["out_proj"][s]
        _chain(sl, r, finals, starts)
    if cache is not None:  # the slots' blocks of the state, in place, once all are read
        for s, final in enumerate(_final_states(sl, finals)):
            cache["conv"][s].copy_(windows[s])
            cache["h"][s].copy_(final)
    return M.axis_all_reduce(outs, mesh, mp) if split else outs


def _conv_halo(sl: _Slab, xis, conv):
    """``(each slot's conv prepend, the conv state the cache keeps)``: the
    d_conv - 1 inputs before a slot's first position (the cache's state
    ``conv``, zeros without one), and the last d_conv - 1 after the step.
    Where the batch axis splits the sequence, each chunk's last min(c,
    d_conv - 1) inputs are all-gathered over it (one counted gather): chunk
    ``r``'s prepend is the last d_conv - 1 of the cache's state and the
    chunks before it, the state kept the last d_conv - 1 of all."""
    cfg = sl.cfg
    init = [None if conv is None else conv[s] for s in range(sl.n)]
    if sl.seq != "chunks":
        return init, [MB.conv_window(cfg, init[s], xis[s]) for s in range(sl.n)]
    t = min(xis[0].shape[1], cfg.ssm.d_conv - 1)
    tails = M.axis_all_gather([x[:, x.shape[1] - t:] for x in xis], sl.mesh, sl.dp, 1)
    prepends = [MB.conv_window(cfg, init[s], tails[s][:, :sl.mesh.coord(s, sl.dp) * t])
                for s in range(sl.n)]
    return prepends, [MB.conv_window(cfg, init[s], tails[s]) for s in range(sl.n)]


def _layer_names(cfg: ArchConfig):
    n_full, n_tail = T.split_layers(cfg)
    out = []
    for rep in range(n_full):
        for pos, blk in enumerate(cfg.pattern):
            out.append((f"scan/pos{pos}", rep, blk))
    for t in range(n_tail):
        li = n_full * cfg.period + t
        out.append((f"tail/layer{li}", None, cfg.blocks[li]))
    return out


def vocab_axis(cfg: ArchConfig, grid, layouts: Dict[str, Layout]) -> Optional[str]:
    """``model`` where the logits come out per vocabulary block (the
    embedding's or the untied head's spec splits the vocabulary over it),
    else None."""
    sl = _Slab(cfg, grid, {}, layouts)
    embed = "dec/embed" if cfg.is_encoder_decoder else "embed"
    split = (sl.split_over_model(embed, 0) if cfg.tie_embeddings
             else sl.split_over_model("lm_head", -1))
    return sl.mp if split else None


def _embed(sl: _Slab, name: str, emb: List[torch.Tensor], tokens) -> List[torch.Tensor]:
    """Each slot's rows of the embedding ``emb`` for its tokens,
    vocab-parallel where the spec of ``name`` splits the vocabulary over
    ``model``: each slot looks up the tokens in its block (zeros elsewhere)
    and one all-reduce sums the rows."""
    if not sl.split_over_model(name, 0):
        return [emb[s][tokens[s]] for s in range(sl.n)]
    V = emb[0].shape[0]
    rows = []
    for s in range(sl.n):
        ids = tokens[s] - sl.mesh.coord(s, sl.mp) * V
        inside = (ids >= 0) & (ids < V)
        r = emb[s][ids.clamp(0, V - 1)]
        rows.append(torch.where(inside[..., None], r, torch.zeros_like(r)))
    return M.axis_all_reduce(rows, sl.mesh, sl.mp)


def _head_logits(sl: _Slab, heads: List[torch.Tensor], split: bool, x) -> List[torch.Tensor]:
    """Each slot's logits ``x @ head`` (its vocabulary block where the
    head's spec splits it over ``model``; the input then passes
    ``axis_sum_grads``)."""
    if split:
        x = M.axis_sum_grads(x, sl.mesh, sl.mp)
    return [x[s] @ heads[s].to(x[s].dtype) for s in range(sl.n)]


def _chunk_start(sl: _Slab, s: int, S: int) -> int:
    """The position of slot ``s``'s first token: its chunk's start where
    the batch axis splits the sequence (chunks of ``S``), else 0."""
    return sl.mesh.coord(s, sl.dp) * S if sl.seq == "chunks" else 0


def _slot_angles(sl: _Slab, tokens, positions, cache_index):
    """Each slot's rotary angles (None for a rope-free model) from its
    replica's ``positions`` (by default 0..S-1, offset by ``cache_index``
    and, where the batch axis splits the sequence, by the chunk's start;
    given positions, every slot's whole, are then sliced to the chunk),
    computed once per replica (or chunk) and device; on the meta device (a
    dry run) once per slot, as each card of a grid computes its own."""
    done, out = {}, []
    for s in range(sl.n):
        B, S = tokens[s].shape
        dev = tokens[s].device
        r = 0 if sl.seq == "whole" else sl.mesh.coord(s, sl.dp)
        key = (r, s if dev.type == "meta" else dev)
        if key not in done:
            first = _chunk_start(sl, s, S)
            pos = None if positions is None else positions[s]
            if pos is not None and sl.seq == "chunks":
                pos = pos[..., first:first + S]
            start = first + int(cache_index or 0)
            if pos is None and (start or cache_index is not None):
                pos = (torch.arange(S, device=dev)[None] + start).expand(B, S)
            done[key] = T._rope_angles(sl.cfg, pos, S, B, dev)
        out.append(done[key])
    return out


def _splice(x: torch.Tensor, e: torch.Tensor, first: int) -> torch.Tensor:
    """``x`` [B, S, D] (positions ``[first, first + S)``) with the
    positions among the first N replaced by ``e`` [B, N, D]'s: none, all,
    or a prefix where N ends inside the chunk."""
    k = min(max(e.shape[1] - first, 0), x.shape[1])
    if not k:
        return x
    return torch.cat([e[:, first:first + k].to(x.dtype), x[:, k:]], dim=1)


def partitioned_forward(cfg: ArchConfig, grid, live: Dict[str, List[torch.Tensor]],
                        layouts: Dict[str, Layout], tokens: List[torch.Tensor], *,
                        positions: Optional[List[torch.Tensor]] = None,
                        extra_embeds: Optional[List[torch.Tensor]] = None,
                        cache: Optional[Dict[str, List[torch.Tensor]]] = None,
                        cache_index: Optional[int] = None, differentiable: bool,
                        seq: Optional[str] = None,
                        cache_layouts: Optional[Dict[str, Layout]] = None,
                        last_only: bool = False,
                        frames: Optional[List[torch.Tensor]] = None):
    """``tokens[s]`` [B_r, S], replica ``r``'s rows on slot ``s``, through
    the partitioned decoder on ``grid`` (a ``Grid``; a ``Mesh`` is read
    ``FROM_MESH``; the module docstring): ``(logits, aux,
    cache)``, ``logits[s]`` [B_r, S, V / M] slot ``s``'s vocabulary block
    where ``vocab_axis`` is ``model`` (else [B_r, S, V]), ``aux[s]`` the MoE
    layers' load-balance losses of the whole batch summed (0 without MoE
    layers, and when serving).  ``live[name][s]`` is slot ``s``'s tensor of
    leaf ``name`` (a stacked layer leaf's may be the list of its layers'),
    ``layouts[name]`` its layout; ``positions[s]`` and
    ``extra_embeds[s]``, where given, the replica's rows of those inputs.

    ``differentiable=True`` is the train step's forward (``_sdpa`` and the
    plain recurrences; no cache).  Otherwise attention and the RWKV
    recurrence run the kernels, and with ``cache`` (``cache[name][s]`` slot
    ``s``'s block of the cache leaf ``name``, placed by
    ``cache_shardings``) the step is incremental at the write offset
    ``cache_index``: the blocks are updated in place and returned.

    ``seq`` is ``seq_layout``'s for a batch the batch axis does not divide:
    ``"chunks"`` (``tokens[s]`` [B, S / R], chunk ``r`` of the sequence on
    the slots of index ``r``) or ``"whole"`` (every slot all of [B, S]);
    ``positions[s]`` and ``extra_embeds[s]`` are then the whole batch's on
    every slot, each chunk taking its positions' part, and
    ``cache_layouts`` the cache leaves' layouts.  ``last_only`` computes
    the logits of each slot's last position alone, [B_r, 1, V / M].

    The encoder-decoder (whisper) takes ``frames[s]`` [B_r, N, D], the
    replica's frame embeddings (with ``seq``, the whole [B, N, D] on every
    slot), through the encoder; with a ``cache`` (``init_whisper_cache``'s,
    primed by ``prime_cross_cache``) it takes no frames and its decoder
    reads the primed cross k/v."""
    if cache is not None and differentiable:
        raise ValueError("the partitioned train forward takes no cache")
    sl = _Slab(cfg, grid, live, layouts, seq)
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.is_encoder_decoder:
        return _whisper_forward(sl, tokens, frames, cache, cache_index, differentiable,
                                last_only, cache_layouts)
    emb = sl.weight("embed")
    x = [xi.to(cdt) for xi in _embed(sl, "embed", emb, tokens)]
    if cfg.scale_embed:
        x = [xi * torch.tensor(cfg.d_model ** 0.5, dtype=cdt, device=xi.device) for xi in x]
    if extra_embeds is not None:  # the frontend's embeddings in place of the first N
        x = [_splice(xi, e, _chunk_start(sl, s, xi.shape[1]))
             for s, (xi, e) in enumerate(zip(x, extra_embeds))]
    angles = _slot_angles(sl, tokens, positions, cache_index)

    aux = [torch.zeros((), dtype=torch.float32, device=xi.device) for xi in x]
    for pre, rep, blk in _layer_names(cfg):
        lc = None
        if cache is not None:
            lc = {k[len(pre) + 1:]: v if rep is None else [b[rep] for b in v]
                  for k, v in cache.items() if k.startswith(pre + "/")}
        h = sl.norm(f"{pre}/norm1", rep, x)
        if blk.mixer == "rwkv":
            a = _time_mix(sl, f"{pre}/rwkv", rep, h, cache=lc, differentiable=differentiable)
        elif blk.mixer == "mamba":
            a = _mamba(sl, f"{pre}/mamba", rep, h, cache=lc, differentiable=differentiable)
        else:
            length = None if cache_layouts is None else cache_layouts[f"{pre}/k"].shape[-3]
            a = _attention(sl, f"{pre}/attn", rep, blk, h, angles, cache=lc,
                           cache_index=cache_index, cache_len=length,
                           differentiable=differentiable)
        x = [xi + ai for xi, ai in zip(x, a)]
        h2 = sl.norm(f"{pre}/norm2", rep, x)
        if blk.ffn == "rwkv_cm":
            f = _channel_mix(sl, f"{pre}/rwkv_cm", rep, h2, cache=lc,
                             serving=not differentiable)
        elif blk.ffn == "moe":
            f, layer_aux = _moe(sl, f"{pre}/moe", rep, h2, differentiable=differentiable)
            if layer_aux is not None:
                aux = [t + u for t, u in zip(aux, layer_aux)]
        else:
            f = _ffn(sl, f"{pre}/{blk.ffn}", rep, blk.ffn, h2, serving=not differentiable)
        x = [xi + fi for xi, fi in zip(x, f)]

    if last_only:
        x = [xi[:, -1:] for xi in x]
    x = sl.norm("final_norm", None, x)
    if cfg.tie_embeddings:
        logits = _head_logits(sl, [e.T for e in emb], sl.split_over_model("embed", 0), x)
    else:
        logits = _head_logits(sl, sl.weight("lm_head"), sl.split_over_model("lm_head", -1), x)
    if cfg.logit_softcap > 0:
        logits = [torch.tanh(lg / cfg.logit_softcap) * cfg.logit_softcap for lg in logits]
    return logits, aux, cache


def _whisper_encode(sl: _Slab, frames, differentiable: bool) -> List[torch.Tensor]:
    """Each slot's encoder states of its ``frames``: [B_r, N, D] of its
    replica's rows; at a batch the batch axis does not divide (every slot
    the whole [B, N, D]) its chunk of the positions, or all of them, as
    ``_Slab.frames`` says (the module docstring).  The learned positions
    (replicated) at the chunk's offset, then each layer's bidirectional
    self-attention and MLP as a decoder's, tensor parallel over ``model``;
    every slot of a replica (or chunk) ends with the same states."""
    cfg = sl.cfg
    cdt = dtype_of(cfg.compute_dtype)
    B, N = frames[0].shape[:2]
    sl.frames = None if sl.seq is None else seq_layout(B, N, sl.R)
    c = N // sl.R if sl.frames == "chunks" else N
    pos = sl.weight("enc/pos")
    x = []
    for s, f in enumerate(frames):
        lo = sl.mesh.coord(s, sl.dp) * c if sl.frames == "chunks" else 0
        x.append(f[:, lo:lo + c].to(cdt) + pos[s][None, lo:lo + c].to(cdt))
    blk, angles = cfg.blocks[0], [None] * sl.n
    for i in range(cfg.encoder_layers):
        pre = f"enc/layers/layer{i}"
        a = _attention(sl, f"{pre}/attn", None, blk, sl.norm(f"{pre}/norm1", None, x), angles,
                       differentiable=differentiable, causal=False)
        x = [xi + ai for xi, ai in zip(x, a)]
        f = _ffn(sl, f"{pre}/mlp", None, "mlp", sl.norm(f"{pre}/norm2", None, x),
                 serving=not differentiable)
        x = [xi + fi for xi, fi in zip(x, f)]
    return sl.norm("enc/final_norm", None, x)


def _whisper_forward(sl: _Slab, tokens, frames, cache, cache_index, differentiable: bool,
                     last_only: bool, cache_layouts=None):
    """``partitioned_forward`` of the encoder-decoder: the frames through
    the encoder (or, with a cache, none), the tokens through the decoder at
    the learned positions from ``cache_index`` (and, where the batch axis
    splits the sequence, the chunk's start): each layer's causal
    self-attention (against the self cache's blocks, written in place), its
    cross-attention over the encoder states (``wk``/``wv`` column-parallel)
    or the primed cross cache's blocks, its MLP; the tied embedding's
    logits, vocab-parallel where its spec splits the vocabulary."""
    cfg = sl.cfg
    if cache is None and frames is None:
        raise ValueError("the partitioned whisper forward needs frames or a primed cache")
    if cache is not None and cache_index is None:
        raise ValueError("a whisper step against a cache takes its cache_index")
    cdt = dtype_of(cfg.compute_dtype)
    enc = None if cache is not None else _whisper_encode(sl, frames, differentiable)
    S = tokens[0].shape[1]
    total = S * sl.R if sl.seq == "chunks" else S
    offset = int(cache_index or 0)
    pos = sl.weight("dec/pos")
    if not 0 <= offset <= pos[0].shape[0] - total:
        raise ValueError(f"decoder positions {offset}..{offset + total - 1} run past the "
                         f"{pos[0].shape[0]} learned positions (max_target_len)")
    emb = sl.weight("dec/embed")
    x = []
    for s, xi in enumerate(_embed(sl, "dec/embed", emb, tokens)):
        first = offset + _chunk_start(sl, s, S)
        x.append(xi.to(cdt) + pos[s][None, first:first + S].to(cdt))
    blk, angles = cfg.blocks[0], [None] * sl.n

    def length(name):
        return None if cache_layouts is None else cache_layouts[name].shape[-3]

    for i in range(cfg.num_layers):
        pre = f"dec/layers/layer{i}"
        c = None if cache is None else {k: cache[f"layer{i}/{k}"] for k in ("k", "v", "xk", "xv")}
        a = _attention(sl, f"{pre}/attn", None, blk, sl.norm(f"{pre}/norm1", None, x), angles,
                       cache=None if c is None else {"k": c["k"], "v": c["v"]},
                       cache_index=cache_index, cache_len=length(f"layer{i}/k"),
                       differentiable=differentiable)
        x = [xi + ai for xi, ai in zip(x, a)]
        hx = sl.norm(f"{pre}/norm_x", None, x)
        if c is None:
            a = _attention(sl, f"{pre}/xattn", None, blk, hx, angles, source=enc, causal=False,
                           differentiable=differentiable)
        else:
            a = _attention(sl, f"{pre}/xattn", None, blk, hx, angles, causal=False,
                           cache={"k": c["xk"], "v": c["xv"]}, cache_len=length(f"layer{i}/xk"),
                           differentiable=False)
        x = [xi + ai for xi, ai in zip(x, a)]
        f = _ffn(sl, f"{pre}/mlp", None, "mlp", sl.norm(f"{pre}/norm2", None, x),
                 serving=not differentiable)
        x = [xi + fi for xi, fi in zip(x, f)]
    if last_only:
        x = [xi[:, -1:] for xi in x]
    x = sl.norm("dec/final_norm", None, x)
    logits = _head_logits(sl, [e.T for e in emb], sl.split_over_model("dec/embed", 0), x)
    return logits, [torch.zeros((), dtype=torch.float32, device=xi.device) for xi in x], cache


def partitioned_encode(cfg: ArchConfig, grid, live: Dict[str, List[torch.Tensor]],
                       layouts: Dict[str, Layout], frames: List[torch.Tensor],
                       seq: Optional[str] = None) -> List[torch.Tensor]:
    """The encoder on the kernels: each slot's states [B_r, N, D] of its
    replica's ``frames[s]`` (the same on every slot of a replica); with
    ``seq`` (a batch the batch axis does not divide: every slot's
    ``frames[s]`` the whole [B, N, D]) its chunk of the positions, or all
    of them, by ``seq_layout(B, N, R)``."""
    return _whisper_encode(_Slab(cfg, grid, live, layouts, seq), frames, False)


def partitioned_prime(cfg: ArchConfig, grid, live: Dict[str, List[torch.Tensor]],
                      layouts: Dict[str, Layout], enc: List[torch.Tensor],
                      cache: Dict[str, List[torch.Tensor]]) -> None:
    """Every decoder layer's cross k/v projected from each slot's encoder
    states ``enc[s]`` and written into the slot's blocks of ``cache``
    (``layer{i}/xk``, ``xv``, placed by ``cache_shardings``) in place: each
    slot projects its KV heads (``wk``/``wv`` column-parallel), or, where
    the heads do not split over ``model``, the whole gathered ``wk``/``wv``
    and keeps its block of ``head_dim``.  Where the cache's positions split
    over the batch axis, ``enc[s]`` is the slot's chunk of the positions,
    the ones its block holds."""
    sl = _Slab(cfg, grid, live, layouts)
    hd = cfg.head_dim
    for i in range(cfg.num_layers):
        pre = f"dec/layers/layer{i}/xattn"
        split, kv_split, _, hkv, _ = _heads(sl, pre, None, False)
        kv = _kv_weights(sl, pre, None, split, kv_split)
        xk, xv = cache[f"layer{i}/xk"], cache[f"layer{i}/xv"]
        for s in range(sl.n):
            B, N, _ = enc[s].shape
            k = (enc[s] @ kv["wk"][s]).reshape(B, N, hkv, hd)
            v = (enc[s] @ kv["wv"][s]).reshape(B, N, hkv, hd)
            _write_kv(sl, s, xk, xv, k, v, slice(None), slice(None))


def gather_last(logits: List[torch.Tensor], grid: Grid, vocab: Optional[str],
                seq: Optional[str] = None) -> torch.Tensor:
    """The serving steps' output: each slot's last-position logits
    [B_r, V / M] all-gathered over ``vocab`` (the model axis, where they
    come out per vocabulary block) and then over the batch axes, each
    counted: [B, V] on slot 0's device (the reference's
    ``out_shardings=None``).  Where the batch axes split the sequence
    (``seq`` ``"chunks"``), the last position is the last chunk's,
    broadcast over them (counted); where every slot holds the whole batch
    (``"whole"``), slot 0's own."""
    mesh, dp = grid.mesh, grid.dp
    last = [lg[:, -1] for lg in logits]
    if vocab is not None:
        last = M.axis_all_gather(last, mesh, vocab, 1)
    if seq == "chunks":
        return M.axis_broadcast(last, mesh, dp, grid.R - 1)[0]
    if seq == "whole":
        return last[0]
    return M.axis_all_gather(last, mesh, dp, 0)[0]


def partitioned_loss(cfg: ArchConfig, grid: Grid, live: Dict[str, List[torch.Tensor]],
                     layouts: Dict[str, Layout], tokens: List[torch.Tensor], mask=None,
                     denominator: Optional[float] = None, *, positions=None,
                     extra_embeds=None, seq: Optional[str] = None, frames=None):
    """Each slot's loss of its replica's rows (or, with ``seq``
    ``"chunks"``, of its chunk of the sequence) and its aux loss:
    ``tokens[s]`` (and ``mask[s]``, ``positions[s]``, ``extra_embeds[s]``,
    the encoder-decoder's ``frames[s]``) through
    ``partitioned_forward(differentiable=True, seq=seq)``, scored by
    ``lm_loss_vocab_parallel`` as Σ nll · mask over ``denominator``.  The
    loss is the same on every slot of a replica (or chunk), the aux (the
    whole batch's) on every slot."""
    check_partitionable(cfg, () if frames is None else ("frames",))
    logits, aux, _ = partitioned_forward(cfg, grid, live, layouts, tokens, positions=positions,
                                         extra_embeds=extra_embeds, differentiable=True,
                                         seq=seq, frames=frames)
    return lm_loss_vocab_parallel(logits, tokens, grid.mesh, vocab_axis(cfg, grid, layouts), mask,
                                  denominator, seq_axis=grid.dp if seq == "chunks" else None), aux
