"""Train, eval, prefill and serve steps for the decoder LM (port of
``repro.train.step``).

``make_train_step`` returns ``(state, batch) -> (state, metrics)``, a pure
function like the reference's: the new parameters and optimizer state are
new tensors and the old ones are left as they were.  The batch splits into
``microbatches`` equal slices of the batch axis (axis 0; axis 1 of M-RoPE
positions [3, B, S]) whose gradients are summed in f32 and averaged (what
the reference's ``lax.scan`` over microbatches computes; on the meta
device, a dry run, one microbatch is traced and counted as all of them,
``utils.op_counts.trips``).  The MoE
load-balance loss enters the objective at ``cfg.moe.aux_loss_weight`` (the
reference's default weight) and is reported as the metric ``aux``.  The
forward pass of the train step runs with ``differentiable=True``: the
kernels have no backward (the reference has none either and trains through
XLA), so attention and the RWKV recurrence are the plain PyTorch copies of
the reference's.  Every inference step
(eval, prefill, serve) runs on the kernels.  An encoder-decoder config
(whisper) runs ``models.whisper``: the batch's ``frames`` through the
encoder, its ``tokens`` through the decoder.

Params placed by ``launch.sharding.device_put`` on a grid of several
slots (``utils.placed.Placed`` leaves) take the partitioned step: the
reference's ``jax.jit(step, in_shardings=...)`` over its
``params_shardings``.  See ``make_train_step``.  The encoder-decoder's
``frames`` split over the batch axis like the tokens (at a batch the
batch axis does not divide, whole on every slot), and its encoder and
cross-cache priming on placed params are ``partitioned_encode`` and
``partitioned_prime`` (what ``whisper.whisper_encode`` and
``whisper.prime_cross_cache`` call on them).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.models import partitioned as PT
from repro_torch.models import whisper as W
from repro_torch.models.transformer import forward_lm
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.train.losses import lm_loss, lm_loss_vocab_parallel
from repro_torch.utils import op_counts as _oc
from repro_torch.utils.placed import Layout, Placed, spec_axes
from repro_torch.utils.pytree import (is_placed, tree_device, tree_leaves,
                                      tree_leaves_with_path, tree_map, tree_unflatten)


def make_train_state(params, optimizer: Optimizer) -> Dict[str, Any]:
    return {"params": params, "opt": optimizer.init(params)}


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device``; token ids as int64."""
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _logits(cfg: ArchConfig, params, batch, *, differentiable: bool):
    """(logits [B, S, V], aux loss) of the batch, no cache."""
    if cfg.is_encoder_decoder:
        enc_out = W.whisper_encode(cfg, params, batch["frames"], differentiable=differentiable)
        logits, aux, _ = W.whisper_decode(cfg, params, batch["tokens"], enc_out,
                                          differentiable=differentiable)
        return logits, aux
    logits, aux, _ = forward_lm(cfg, params, batch["tokens"], positions=batch.get("positions"),
                                extra_embeds=batch.get("extra_embeds"),
                                differentiable=differentiable)
    return logits, aux


def _batch_axis(key: str, v) -> int:
    """The batch axis of a batch array: axis 1 of M-RoPE positions
    [3, B, S], axis 0 of everything else.  (The reference picks the axis by
    comparing a leaf's first dim with the batch size, which takes the wrong
    axis for positions at a global batch of 3.)"""
    return 1 if key == "positions" and v.ndim == 3 else 0


def _microbatch(batch, i: int, n: int):
    """Slice ``i`` of ``n`` along each array's batch axis."""
    out = {}
    for key, v in batch.items():
        axis = _batch_axis(key, v)
        mb = v.shape[axis] // n
        out[key] = v.narrow(axis, i * mb, mb)
    return out


def _lm_loss_fn(cfg: ArchConfig, params, batch, aux_weight: float, *, differentiable: bool):
    logits, aux = _logits(cfg, params, batch, differentiable=differentiable)
    loss = lm_loss(logits, batch["tokens"], batch.get("mask"))
    return loss + aux_weight * aux, loss, aux


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, *, microbatches: int = 1,
                    clip_norm: float = 1.0, aux_weight: Optional[float] = None,
                    grad_sync: Optional[Callable] = None, grad_shardings=None,
                    data_axis=M.FROM_MESH, model_axis=M.FROM_MESH) -> Callable:
    """Build the train step: the gradient of ``lm_loss`` (accumulated over
    ``microbatches``), ``grad_sync``, ``clip_by_global_norm(clip_norm)``,
    then ``optimizer.update``; metrics ``loss``, ``aux`` (the MoE
    load-balance loss, 0 without MoE layers; weighted by ``aux_weight``,
    default ``cfg.moe.aux_loss_weight``, in the objective) and
    ``grad_norm`` (the norm before clipping), 0-d f32 tensors; ``loss`` and
    ``aux`` are means over the microbatches.

    ``grad_sync(grads) -> grads``: the hook a distribution strategy uses to
    reduce gradients across devices; identity by default (it sees the
    partitioned step's gradients after their reduction over the batch
    axis).

    **Placed params** (every leaf a ``Placed`` leaf on one grid: a
    ``(replica, model)`` or ``(data, model)`` mesh, the multi-pod
    ``(pod, data, model)`` mesh, or one contributor's sub-grid of a ColD
    mesh) run the partitioned step on the grid ``data_axis`` and
    ``model_axis`` name (the keywords the params' ``params_shardings``
    took: a batch axis may be a tuple of names, the model axis None; by
    default both are read from the mesh, ``models.partitioned.make_grid``;
    an axis neither names is replicated, and a leaf split over such an
    axis raises ``ValueError``).  Slot ``(r, m)``
    takes replica ``r``'s rows of the batch (a batch placed over the batch
    axis, or any batch split here), in ``microbatches`` equal slices;
    ``models.partitioned.partitioned_loss`` gives each slot its loss (tensor
    parallel over ``model``, FSDP over the batch axis) and autograd each
    slot's gradient of each of its blocks.  Microbatch ``i``'s loss is the
    mean over the union of the replicas' slices ``i`` (Σ nll over their
    count, which a mask's count makes one all-reduce).  Gradients are
    summed over the microbatches per slot (in f32 from two microbatches
    on), then over the batch axis: an FSDP block's by the reduce-scatter of
    its gather's backward, each microbatch; any other leaf's by one
    all-reduce a leaf, after the microbatches; then divided by
    ``microbatches`` and stored once per block and device, placed as the
    parameter.  ``clip_by_global_norm`` counts each logical block once and
    the update runs block by block.  ``loss`` sums the replicas' shares
    (one all-reduce); every slot's objective adds ``aux_weight`` times the
    MoE aux loss of the whole microbatch (global ``f_e`` and ``p_e``, see
    ``models.partitioned``), and ``aux`` reports it once.  M-RoPE
    ``positions`` and ``extra_embeds`` split over the batch axis like the
    tokens.  Microbatch ``i`` is the reference's, rows ``[i B / n, (i + 1)
    B / n)`` of the global batch split over the replicas (the MoE routing
    is global over a microbatch, so its rows must be the reference's): a
    replica's share of it comes from the replica block that holds those
    rows, copied to the slot's device where that block is another
    replica's (an input's placement, not counted as a collective; at one
    microbatch no row moves).

    A batch the batch axis does not divide (``B % R != 0``: one long
    sequence) lies as ``batch_shardings`` places it
    (``models.partitioned.seq_layout``): the tokens and mask split into R
    chunks of the sequence where R divides its length, else whole on every
    slot; ``positions``, ``extra_embeds`` and ``frames`` whole on every
    slot (the encoder's positions split over the batch axis where it
    divides them, ``models.partitioned``).  A
    microbatch is rows ``[i B / n, (i + 1) B / n)`` of every slot's part,
    and its loss is Σ nll over the whole microbatch's count of scored pairs
    (the mask's, all-reduced over the batch axis); each chunk's last
    position is scored against the next chunk's first token.  Where every
    slot holds the whole sequence, each slot's loss and aux enter its
    objective at 1 / R, so that the batch axis's sums of the gradients and
    the loss count the batch once.  Every optimizer takes placed leaves;
    adafactor keeps its statistics whole and replicated, as the
    reference's ``opt_state_shardings`` places them
    (``optim.optimizers.adafactor``).

    ``grad_shardings``: a tree of ``launch.sharding.NamedSharding`` matching
    the params (``params_shardings``).  The reference pins its f32
    gradient accumulator to the parameter layout with it.  The port's
    accumulators always sit where their parameter's blocks do, so the tree
    is checked against the params at each call: another structure or a
    spec longer than its gradient's rank raises ``ValueError``, as does a
    leaf placed whole away from the device its sharding places it on, or a
    placed leaf whose sharding names another spec or grid.  A shorter spec
    is padded with ``None``, as JAX pads it (``replicated(mesh)``'s ``P()``
    fits any rank)."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1; got {microbatches}")
    aux_w = cfg.moe.aux_loss_weight if aux_weight is None else aux_weight

    def grads_of(params, leaves, batch):
        """(loss, aux, gradient per leaf) on one (micro)batch."""
        with torch.enable_grad():
            live = [x.detach().requires_grad_(True) for x in leaves]
            total, loss, aux = _lm_loss_fn(cfg, tree_unflatten(params, live), batch, aux_w,
                                           differentiable=True)
            grads = torch.autograd.grad(total, live)
        return loss.detach(), aux.detach(), grads

    def check_shardings(params):
        names = [k for k, _ in tree_leaves_with_path(params)]
        shardings = dict(tree_leaves_with_path(grad_shardings))
        if set(shardings) != set(names):
            raise ValueError("grad_shardings does not match the params: "
                             f"{sorted(set(names) ^ set(shardings))[:8]}")
        for name, x in tree_leaves_with_path(params):
            sh = shardings[name]
            if len(sh.spec) > x.dim():
                raise ValueError(f"grad_shardings[{name!r}]: spec {sh.spec} for a gradient of "
                                 f"rank {x.dim()}")
            if isinstance(x, Placed):
                spec = tuple(spec_axes(e) for e in sh.spec) + ((),) * (x.dim() - len(sh.spec))
                grid = x.layout.mesh
                if (spec != x.layout.spec or sh.mesh.axis_names != grid.axis_names
                        or list(sh.mesh.devices.flat) != list(grid.devices.flat)):
                    raise ValueError(f"grad_shardings[{name!r}] places its gradient as "
                                     f"{sh.spec} on {sh.mesh!r}, its parameter is placed as "
                                     f"{x.layout.spec} on {grid!r}")
            elif x.device != sh.home:
                raise ValueError(f"grad_shardings[{name!r}] places its gradient on "
                                 f"{sh.spec}/{sh.home}, its parameter lives on {x.device}")

    def partitioned_step(state, batch):
        params = state["params"]
        named, layouts, grid = _params_grid(params, data_axis, model_axis)
        mesh, dp, R = grid.mesh, grid.dp, grid.R
        seq = PT.seq_layout(*batch["tokens"].shape, R)
        PT.check_partitionable(cfg, list(batch))
        if grad_shardings is not None:
            check_shardings(params)
        if seq is None:
            rows = _slot_rows(batch, mesh, dp)
        else:
            rows = _slot_sequence_batch(batch, mesh, dp, seq)
        Br = rows["tokens"][0].shape[0]
        if Br % microbatches:
            what = "a replica's" if seq is None else "the batch's"
            raise ValueError(f"{what} {Br} rows do not split into {microbatches} equal "
                             "microbatches")
        mb = Br // microbatches
        # a batch every slot holds whole counts R times over the batch axis:
        # each slot's share of the loss (and aux) is 1 / R of it
        share = 1.0 / R if seq == "whole" else 1.0
        acc: Dict[str, list] = {}
        loss_sum = aux_sum = None
        # on the meta device (a dry run) every microbatch dispatches the same
        # ops: trace one, counted as run ``microbatches`` times
        runs = 1 if mesh.devices.flat[0].type == "meta" else microbatches
        with _oc.trips(microbatches // runs):
            for i in range(runs):
                if seq is None:
                    part = _microbatch_rows(rows, mesh, dp, i, microbatches)
                else:
                    part = {k: [p.narrow(_batch_axis(k, p), i * mb, mb) for p in parts]
                            for k, parts in rows.items()}
                denominator = _pairs(part, mesh, dp, seq)
                with torch.enable_grad():
                    live = {k: [_leaf_of(k, b) for b in x.slot_blocks()] for k, x in named}
                    losses, auxes = PT.partitioned_loss(
                        cfg, grid, live, layouts, part["tokens"], part.get("mask"), denominator,
                        positions=part.get("positions"), extra_embeds=part.get("extra_embeds"),
                        seq=seq, frames=part.get("frames"))
                    objective = [l + aux_w * share * a for l, a in zip(losses, auxes)]
                    flat = [t for k, _ in named for b in live[k]
                            for t in (b if isinstance(b, list) else [b])]
                    grads = torch.autograd.grad(objective, flat,
                                                [torch.ones_like(x) for x in objective],
                                                allow_unused=True)
                with _oc.section("blocks"):   # each slot's work on its parameter blocks
                    # consumed from the end, so that each gradient goes once it is stored
                    pieces = list(zip(flat, grads))[::-1]
                    del grads
                    for k, _ in named:
                        got = [_block_grad(b, pieces) for b in live[k]]
                        if microbatches == 1:
                            acc[k] = got
                        elif k not in acc:
                            acc[k] = [g.float() for g in got]
                        else:
                            for a, g in zip(acc[k], got):
                                a.add_(g)
                del live, flat, got, objective  # the slots' gradients live on in acc alone
                step_loss = [x.detach() for x in losses]
                loss_sum = (step_loss if loss_sum is None
                            else [a + b for a, b in zip(loss_sum, step_loss)])
                aux_sum = auxes[0].detach() if aux_sum is None else aux_sum + auxes[0].detach()
        # the tail touches each stored block once (one a block and device)
        with _oc.section("tail"):
            reduced = []
            for k, x in named:
                g = acc.pop(k)
                if not x.layout.splits_over(dp):
                    g = M.axis_all_reduce(g, mesh, dp)
                blocks = [g[s] for s in x.layout.first_slot]
                del g
                reduced.append(x.with_blocks([b / microbatches for b in blocks]
                                             if microbatches > 1 else blocks))
            grads = tree_unflatten(params, reduced)
            del reduced
            loss = M.axis_all_reduce(loss_sum, mesh, dp)[0] / microbatches
            aux = (aux_sum / microbatches).to(loss.device)
            if grad_sync is not None:
                grads = grad_sync(grads)
            grads, gnorm = clip_by_global_norm(grads, clip_norm,
                                               [a for a in (grid.dp, grid.model) if a is not None])
            updates, new_opt = optimizer.update(grads, state["opt"], params)
            new_params = tree_map(torch.add, params, updates)
        metrics = {"loss": loss, "aux": aux, "grad_norm": gnorm}
        return {"params": new_params, "opt": new_opt}, metrics

    @torch.no_grad()
    def train_step(state, batch):
        params = state["params"]
        if any(isinstance(x, Placed) for x in tree_leaves(params)):
            return partitioned_step(state, batch)
        if grad_shardings is not None:
            check_shardings(params)
        leaves = tree_leaves(params)
        batch = _on_device(batch, tree_device(params))
        if microbatches > 1:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"a batch of {B} does not split into {microbatches} equal "
                                 "microbatches")
            gacc = [torch.zeros_like(x, dtype=torch.float32) for x in leaves]
            loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            aux_sum = torch.zeros_like(loss_sum)
            # on the meta device (a dry run) every microbatch dispatches the same
            # ops: trace one, counted as run ``microbatches`` times
            runs = 1 if leaves[0].is_meta else microbatches
            with _oc.trips(microbatches // runs):
                for i in range(runs):
                    loss, aux, grads = grads_of(params, leaves,
                                                _microbatch(batch, i, microbatches))
                    for acc, g in zip(gacc, grads):
                        acc.add_(g)
                    loss_sum += loss
                    aux_sum += aux
            grads = [g / microbatches for g in gacc]
            loss, aux = loss_sum / microbatches, aux_sum / microbatches
        else:
            loss, aux, grads = grads_of(params, leaves, batch)
        grads = tree_unflatten(params, grads)
        if grad_sync is not None:
            grads = grad_sync(grads)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, new_opt = optimizer.update(grads, state["opt"], params)
        new_params = tree_map(torch.add, params, updates)
        return {"params": new_params, "opt": new_opt}, {"loss": loss, "aux": aux,
                                                        "grad_norm": gnorm}

    return train_step


def _leaf_of(name: str, block: torch.Tensor):
    """A slot's block of param ``name`` as the leaf (or leaves) the
    partitioned forward differentiates: a stacked layer leaf (``scan/``) as
    one leaf a layer, so that each layer's gradient is its slice alone (no
    layer's backward writes a whole stacked block of zeros)."""
    if name.startswith("scan/"):
        return [p.detach().requires_grad_(True) for p in block.unbind(0)]
    return block.detach().requires_grad_(True)


def _block_grad(leaf, pieces: list) -> torch.Tensor:
    """The gradient of a slot's block, popped from the end of ``pieces``
    (``(leaf, grad)`` pairs in ``_leaf_of``'s order, reversed): zeros where
    a leaf took none, a stacked leaf's layers stacked."""
    parts = []
    for _ in (leaf if isinstance(leaf, list) else [leaf]):
        t, g = pieces.pop()
        parts.append(g if g is not None else torch.zeros_like(t))
    return torch.stack(parts) if isinstance(leaf, list) else parts[0]


def _placed_grid(tree, what: str):
    """``(named leaves, grid)`` of a tree whose every leaf is placed on one
    grid; ``ValueError`` otherwise."""
    named = tree_leaves_with_path(tree)
    if not all(isinstance(x, Placed) for _, x in named):
        whole = [k for k, x in named if not isinstance(x, Placed)][:4]
        raise ValueError(f"placed {what} with leaves placed whole: {whole}")
    mesh = named[0][1].layout.mesh
    devices = list(mesh.devices.flat)
    for k, x in named:
        grid = x.layout.mesh
        if grid.axis_names != mesh.axis_names or list(grid.devices.flat) != devices:
            raise ValueError(f"{k} is placed on {grid!r}, the {what} on {mesh!r}")
    return named, mesh


def _params_grid(params, data_axis, model_axis):
    """``(named leaves, their layouts, the Grid)`` of placed params on the
    grid ``data_axis`` and ``model_axis`` name (``models.partitioned.
    make_grid``), each layout checked against it (``Grid.check``)."""
    named, mesh = _placed_grid(params, "params")
    layouts = {k: x.layout for k, x in named}
    grid = PT.make_grid(mesh, data_axis, model_axis)
    grid.check(layouts)
    return named, layouts, grid


def _placed_cache(cfg: ArchConfig, cache, grid: PT.Grid):
    """``(each slot's blocks, the layouts)`` of a cache placed on the
    params' grid as ``cache_shardings`` places it with the grid's axes, by
    leaf name; ``ValueError`` for any other placement."""
    mesh = grid.mesh
    placed, on = _placed_grid(cache, "cache")
    if on.axis_names != mesh.axis_names or list(on.devices.flat) != list(mesh.devices.flat):
        raise ValueError(f"the cache is placed on {on!r}, the params on {mesh!r}")
    want = dict(tree_leaves_with_path(SH.cache_shardings(mesh, cache, cfg, data_axis=grid.dp,
                                                         model_axis=grid.model)))
    for k, x in placed:
        spec = tuple(spec_axes(e) for e in want[k].spec)
        spec += ((),) * (x.dim() - len(spec))
        if x.layout.spec != spec:
            raise ValueError(f"cache leaf {k} is placed as {x.layout.spec}; "
                             f"cache_shardings places it as {want[k].spec}")
    return {k: x.slot_blocks() for k, x in placed}, {k: x.layout for k, x in placed}


@torch.no_grad()
def _partitioned_last_logits(cfg: ArchConfig, params, tokens, cache=None,
                             cache_index=None, *, positions=None,
                             extra_embeds=None, frames=None, data_axis=M.FROM_MESH,
                             model_axis=M.FROM_MESH) -> torch.Tensor:
    """The serving steps on placed params: ``tokens`` [B, S] (a tensor,
    an array, or placed by ``batch_shardings`` on the params' grid) through
    ``models.partitioned.partitioned_forward`` on the kernels, against
    ``cache`` (placed on the same grid by ``cache_shardings``, updated in
    place) at ``cache_index``; the last position's logits [B, V] gathered
    on slot 0's device.  M-RoPE ``positions`` [3, B, S], ``extra_embeds``
    [B, N, D] and the encoder-decoder's ``frames`` [B, N, D] (whole, or
    placed by ``batch_shardings``) split over the batch axis as the tokens
    do: the prefill step's, and a vision prompt's prefill into the cache
    (``forward_lm(cache=, cache_index=0, positions=, extra_embeds=)`` on
    whole params).

    A batch the batch axis does not divide lies as ``batch_shardings``
    places it (``models.partitioned.seq_layout``): the sequence split into
    chunks over the batch axis where it divides the prompt, else the
    tokens whole on every slot, against a cache whose sequence
    ``cache_shardings`` splits over the batch axis (a context-parallel
    prefill and decode); ``positions`` and ``extra_embeds`` are then whole
    on every slot, each chunk taking its part.  ``data_axis`` and
    ``model_axis`` name the grid (``make_train_step``'s)."""
    named, layouts, grid = _params_grid(params, data_axis, model_axis)
    mesh, dp = grid.mesh, grid.dp
    B, S = tokens.shape
    seq = PT.seq_layout(B, S, grid.R)
    batch = {k: v for k, v in (("tokens", tokens), ("positions", positions),
                               ("extra_embeds", extra_embeds), ("frames", frames))
             if v is not None}
    PT.check_partitionable(cfg, list(batch), serving=True)
    blocks = layouts_c = None
    if cache is not None:
        blocks, layouts_c = _placed_cache(cfg, cache, grid)
    if seq is None:
        rows = _slot_rows(batch, mesh, dp)
    else:
        rows = _slot_sequence_batch(batch, mesh, dp, seq)
    logits, _, _ = PT.partitioned_forward(cfg, grid, {k: x.slot_blocks() for k, x in named},
                                          layouts, rows["tokens"],
                                          positions=rows.get("positions"),
                                          extra_embeds=rows.get("extra_embeds"), cache=blocks,
                                          cache_index=cache_index, differentiable=False,
                                          seq=seq, cache_layouts=layouts_c, last_only=True,
                                          frames=rows.get("frames"))
    return PT.gather_last(logits, grid, PT.vocab_axis(cfg, grid, layouts), seq)


@torch.no_grad()
def partitioned_encode(cfg: ArchConfig, params, frames, *, data_axis=M.FROM_MESH,
                       model_axis=M.FROM_MESH) -> Placed:
    """``whisper.whisper_encode`` on placed params: ``frames`` [B, N, D]
    (whole, or placed by ``batch_shardings``) split over the batch axis,
    the encoder run on the kernels, tensor parallel over ``model``; the
    states come back per replica, a leaf placed over the batch axis
    (``batch_shardings``' placement of [B, N, D]) on the params' grid.  At
    a batch the batch axis does not divide, the frames whole on every slot
    (as ``batch_shardings`` places them), the states come back split by
    their positions over the batch axis where it divides N, else whole
    (``models.partitioned.seq_layout(B, N, R)``).  ``data_axis`` and
    ``model_axis`` name the grid (``make_train_step``'s)."""
    named, layouts, grid = _params_grid(params, data_axis, model_axis)
    mesh, dp, batch = grid.mesh, grid.dp, grid.batch
    B, N = frames.shape[:2]
    PT.check_partitionable(cfg, ["frames"], serving=True)
    seq = PT.seq_layout(B, 1, grid.R)
    rows = (_slot_rows({"frames": frames}, mesh, dp) if seq is None
            else _slot_sequence_batch({"frames": frames}, mesh, dp, seq))["frames"]
    enc = PT.partitioned_encode(cfg, grid, {k: x.slot_blocks() for k, x in named}, layouts,
                                rows, seq)
    split = PT.seq_layout(B, N, grid.R)
    spec = (batch,) if split is None else ((), batch if split == "chunks" else ())
    lay = Layout((B, N) + tuple(enc[0].shape[2:]), spec, mesh)
    return Placed(lay, [enc[s] for s in lay.first_slot])


@torch.no_grad()
def partitioned_prime(cfg: ArchConfig, params, cache, enc_out, *, data_axis=M.FROM_MESH,
                      model_axis=M.FROM_MESH):
    """``whisper.prime_cross_cache`` on placed params: every decoder
    layer's cross k/v from the encoder states ``enc_out`` (``whisper_encode``'s
    per-replica leaf, or whole [B, N, D]) written into the blocks of the
    ``xk``/``xv`` leaves of ``cache`` (placed on the params' grid by
    ``cache_shardings``: batch over the batch axis, heads over ``model``,
    or ``head_dim`` where the heads do not divide), in place.  At a batch
    the batch axis does not divide, ``cache_shardings`` splits the N
    positions over the batch axis where it divides them: each slot writes
    its block from its chunk of the states (``whisper_encode``'s leaf split
    so, or split here), with no gather.  Returns the cache.  ``data_axis``
    and ``model_axis`` name the grid (``make_train_step``'s)."""
    named, layouts, grid = _params_grid(params, data_axis, model_axis)
    mesh, dp = grid.mesh, grid.dp
    PT.check_partitionable(cfg, ["frames"], serving=True)
    blocks, _ = _placed_cache(cfg, cache, grid)
    split = PT.seq_layout(*enc_out.shape[:2], grid.R)
    rows = (_slot_rows({"enc": enc_out}, mesh, dp)["enc"] if split is None
            else _slot_sequence(enc_out, mesh, dp, split, long=False))
    PT.partitioned_prime(cfg, grid, {k: x.slot_blocks() for k, x in named}, layouts, rows,
                         blocks)
    return cache


def _slot_sequence(tokens, mesh: M.Mesh, dp, seq: str, long: bool = True) -> list:
    """Each slot's tokens of a batch the batch axis does not divide: its
    chunk of the sequence (``seq`` ``"chunks"``, chunk ``r`` on the slots
    of index ``r``) or all of it (``"whole"``), on the slot's device.
    Tokens placed so by ``batch_shardings`` give their blocks; any others
    are split here.  Token ids as int64 (``long``; a mask, or encoder
    states [B, N, D] split along N, as they are)."""
    R, devices = mesh.extent(dp), list(mesh.devices.flat)
    want = ((), spec_axes(dp) if seq == "chunks" else ()) + ((),) * (tokens.ndim - 2)
    cast = (lambda t: t.long()) if long else (lambda t: t)
    if (isinstance(tokens, Placed) and tokens.layout.spec == want
            and tokens.layout.mesh.axis_names == mesh.axis_names
            and list(tokens.layout.mesh.devices.flat) == devices):
        return [cast(p) for p in tokens.slot_blocks()]
    whole = tokens.whole() if isinstance(tokens, Placed) else torch.as_tensor(tokens)
    if seq == "whole":
        return [cast(whole.to(dev)) for dev in devices]
    c = whole.shape[1] // R
    return [cast(whole[:, mesh.coord(s, dp) * c:(mesh.coord(s, dp) + 1) * c].to(devices[s]))
            for s in range(len(devices))]


def _slot_rows(batch, mesh: M.Mesh, dp) -> Dict[str, list]:
    """Each slot's rows of each batch array: replica ``r``'s share of the
    batch axis (``_batch_axis``) on slot ``(r, m)``'s device.  A leaf placed
    over the batch axis (``shard_batch``, ``batch_shardings``) gives its
    blocks; any other is split here.  Token ids as int64."""
    R, n = mesh.extent(dp), mesh.devices.size
    devices = list(mesh.devices.flat)
    out = {}
    for key, v in batch.items():
        axis = _batch_axis(key, v)
        if (isinstance(v, Placed) and v.layout.mesh.axis_names == mesh.axis_names
                and list(v.layout.mesh.devices.flat) == devices
                and (v.layout.spec[axis] == spec_axes(dp)
                     or (R == 1 and not v.layout.spec[axis]))
                and not any(e for d, e in enumerate(v.layout.spec) if d != axis)):
            parts = v.slot_blocks()
        else:
            whole = v.whole() if isinstance(v, Placed) else torch.as_tensor(v)
            if whole.shape[axis] % R:
                raise ValueError(f"batch[{key!r}]: {whole.shape[axis]} rows do not split over "
                                 f"{R} replicas")
            share = whole.shape[axis] // R
            parts = [whole.narrow(axis, mesh.coord(s, dp) * share, share).to(devices[s])
                     for s in range(n)]
        out[key] = [p.long() for p in parts] if key == "tokens" else parts
    return out


def _microbatch_rows(rows: Dict[str, list], mesh: M.Mesh, dp, i: int, n: int
                     ) -> Dict[str, list]:
    """Microbatch ``i`` of ``n`` of each slot, as the reference slices the
    global batch (``make_train_step``): rows ``[(i R + r) mb, (i R + r + 1)
    mb)`` of it on slot ``(r, m)``, mb a replica's share of a microbatch,
    from the block of replica ``(i R + r) // n`` (``rows`` as
    ``_slot_rows`` gives them), copied to the slot's device where that is
    another replica's."""
    R, devices = mesh.extent(dp), list(mesh.devices.flat)
    along = {t: g for g in mesh.groups(dp) for t in g} if dp is not None else {}
    out = {}
    for key, parts in rows.items():
        axis = _batch_axis(key, parts[0])
        mb = parts[0].shape[axis] // n
        got = []
        for s in range(len(parts)):
            j = i * R + mesh.coord(s, dp)
            src = along[s][j // n] if dp is not None else s
            got.append(parts[src].narrow(axis, (j % n) * mb, mb).to(devices[s]))
        out[key] = got
    return out


def _pairs(part: Dict[str, list], mesh: M.Mesh, dp, seq: Optional[str]) -> float:
    """The count of scored pairs of a (micro)batch whose slots hold
    ``part``, over every slot of the batch axis: the mask's weights on the
    targets (``_scored_count`` all-reduced over ``dp``, clamped at 1), else
    each replica's B_r (S - 1), or the sequence's B (R c - 1) where it is
    split into chunks of c.  Where every slot holds the whole sequence
    (``seq`` ``"whole"``) it counts R times: each slot's share is 1 / R."""
    R = mesh.extent(dp)
    if "mask" in part:
        counts = M.axis_all_reduce([_scored_count(m, mesh.coord(s, dp), seq)
                                    for s, m in enumerate(part["mask"])], mesh, dp)
        return max(float(counts[0]), 1.0)
    B, S = part["tokens"][0].shape
    return float(B * (R * S - 1)) if seq == "chunks" else float(R * B * (S - 1))


def _scored_count(mask: torch.Tensor, r: int, seq: Optional[str]) -> torch.Tensor:
    """A slot's count of scored pairs (Σ of the mask's weights on the
    targets): ``mask[:, 1:]`` of its rows or its whole sequence, or of its
    chunk ``r`` the whole chunk's less, on chunk 0, the first position
    (every other chunk's first position is the previous chunk's target)."""
    if seq != "chunks":
        return mask[:, 1:].float().sum()
    m = mask.float()
    return m.sum() - m[:, 0].sum() if r == 0 else m.sum()


def _slot_sequence_batch(batch, mesh: M.Mesh, dp, seq: str) -> Dict[str, list]:
    """Each slot's part of a batch the batch axis does not divide, as
    ``batch_shardings`` places it: ``tokens`` and ``mask`` [B, S] split
    into chunks of the sequence (``seq`` ``"chunks"``) or whole on every
    slot (``"whole"``, ``_slot_sequence``), M-RoPE ``positions``,
    ``extra_embeds`` and the encoder-decoder's ``frames`` whole on every
    slot (each chunk takes its part; the encoder splits the frames'
    positions itself)."""
    out = {}
    devices = list(mesh.devices.flat)
    for key, v in batch.items():
        if key in ("tokens", "mask"):
            out[key] = _slot_sequence(v, mesh, dp, seq, long=key == "tokens")
        elif isinstance(v, Placed) and not any(v.layout.spec) and (
                list(v.layout.mesh.devices.flat) == devices):
            out[key] = v.slot_blocks()
        else:
            whole = v.whole() if isinstance(v, Placed) else torch.as_tensor(v)
            out[key] = [whole.to(dev) for dev in devices]
    return out


def make_eval_step(cfg: ArchConfig, *, data_axis=M.FROM_MESH,
                   model_axis=M.FROM_MESH) -> Callable:
    """``(params, batch) -> loss``: ``lm_loss`` of the batch (plus the aux
    loss at weight 0), computed on the kernels without gradients.  Placed
    params (a grid of several slots, named by ``data_axis`` and
    ``model_axis`` as in ``make_train_step``) take ``_partitioned_eval``,
    at any batch size."""

    @torch.no_grad()
    def eval_step(params, batch):
        if is_placed(params):
            return _partitioned_eval(cfg, params, batch, data_axis, model_axis)
        total, _, _ = _lm_loss_fn(cfg, params, _on_device(batch, tree_device(params)), 0.0,
                               differentiable=False)
        return total

    return eval_step


def _partitioned_eval(cfg: ArchConfig, params, batch, data_axis=M.FROM_MESH,
                      model_axis=M.FROM_MESH) -> torch.Tensor:
    """The eval step on placed params: the batch split as the train step
    splits it (by rows, or by its sequence where the batch axis does not
    divide it), ``models.partitioned.partitioned_forward`` on the kernels,
    each slot's share of the loss by ``lm_loss_vocab_parallel`` over the
    whole batch's count of scored pairs, summed over the batch axis (one
    all-reduce): the loss on slot 0's device."""
    named, layouts, grid = _params_grid(params, data_axis, model_axis)
    mesh, dp = grid.mesh, grid.dp
    seq = PT.seq_layout(*batch["tokens"].shape, grid.R)
    PT.check_partitionable(cfg, list(batch), serving=True)
    rows = (_slot_rows(batch, mesh, dp) if seq is None
            else _slot_sequence_batch(batch, mesh, dp, seq))
    logits, _, _ = PT.partitioned_forward(cfg, grid, {k: x.slot_blocks() for k, x in named},
                                          layouts, rows["tokens"],
                                          positions=rows.get("positions"),
                                          extra_embeds=rows.get("extra_embeds"),
                                          differentiable=False, seq=seq,
                                          frames=rows.get("frames"))
    losses = lm_loss_vocab_parallel(logits, rows["tokens"], mesh,
                                    PT.vocab_axis(cfg, grid, layouts), rows.get("mask"),
                                    _pairs(rows, mesh, dp, seq),
                                    seq_axis=dp if seq == "chunks" else None)
    return M.axis_all_reduce(losses, mesh, dp)[0]


def make_prefill_step(cfg: ArchConfig, *, data_axis=M.FROM_MESH,
                      model_axis=M.FROM_MESH) -> Callable:
    """Forward pass of the full prompt, no cache: ``(params, batch) ->
    last-position logits [B, V]`` (the next-token distribution).

    Placed params (a grid of several slots, as ``make_train_step``'s) run
    ``models.partitioned`` on the kernels, each slot on its own heads; the
    batch's tokens, M-RoPE ``positions`` and ``extra_embeds`` are split over
    the batch axis (or come placed by ``batch_shardings``) and the logits
    come back whole, on slot 0's
    device (the reference's ``jax.jit(prefill_step, in_shardings=(params_sh,
    batch_sh), out_shardings=None)``).  ``data_axis`` and ``model_axis``
    name the grid, as in ``make_train_step``."""

    def prefill_step(params, batch):
        if is_placed(params):
            return _partitioned_last_logits(cfg, params, batch["tokens"],
                                            positions=batch.get("positions"),
                                            extra_embeds=batch.get("extra_embeds"),
                                            frames=batch.get("frames"), data_axis=data_axis,
                                            model_axis=model_axis)
        return _logits(cfg, params, batch, differentiable=False)[0][:, -1]

    return prefill_step


def make_serve_step(cfg: ArchConfig, *, data_axis=M.FROM_MESH,
                    model_axis=M.FROM_MESH) -> Callable:
    """One step against a KV/state cache: ``(params, cache, tokens [B, S],
    cache_index) -> (logits [B, V], cache)``, the last position's logits;
    the cache is updated in place and returned.  S = 1 is a decode step;
    the prompt at ``cache_index`` 0 is the engine's prefill.  For an
    encoder-decoder config the cache is ``whisper.init_whisper_cache``'s,
    primed by ``prime_cross_cache``.

    Placed params take the partitioned step (``make_prefill_step``'s) with
    a cache placed on their grid by ``launch.sharding.cache_shardings``
    (the reference's ``in_shardings=(params_sh, cache_sh, tokens_sh, rep),
    out_shardings=(None, cache_sh)``): each slot writes its block in place,
    and the logits come back whole on slot 0's device.  ``data_axis`` and
    ``model_axis`` name the grid, as in ``make_train_step``; the cache is
    placed with the same axes."""

    def serve_step(params, cache, tokens, cache_index):
        if is_placed(params):
            return _partitioned_last_logits(cfg, params, tokens, cache, cache_index,
                                            data_axis=data_axis, model_axis=model_axis), cache
        if cfg.is_encoder_decoder:
            logits, _, cache = W.whisper_decode(cfg, params, tokens, cache=cache,
                                                cache_index=cache_index)
        else:
            logits, _, cache = forward_lm(cfg, params, tokens, cache=cache,
                                          cache_index=cache_index)
        return logits[:, -1], cache

    return serve_step
