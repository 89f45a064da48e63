"""The partitioned forward of the dense decoder: one slab's train-step loss
computed over the slots of its grid (``launch.sharding.sub_mesh``), on the
blocks ``launch.sharding.device_put`` placed there.

The grid has a ``model`` axis (M slots) and a batch axis, ``replica`` or
``data`` (R slots).  Every activation is a list of per-slot tensors and
every slot runs its part of each layer in turn, in one process, so a
collective sees all its slots at once (``launch.mesh``'s ``axis_*``
functions, which autograd differentiates; the counts below are for one
forward and its backward).  Slot ``(r, m)`` takes replica ``r``'s rows of
the batch.

* Weights split over the batch axis (FSDP) are all-gathered over it where
  a layer uses them, one layer's slice at a time; the gather's backward
  reduce-scatters their gradient back to the blocks.
* The embedding is vocab-parallel when its spec splits the vocabulary over
  ``model``: each slot looks up the tokens in its block (zeros elsewhere)
  and one all-reduce sums the rows.  The logits ``x @ embedᵀ`` (or
  ``x @ lm_head``) come out per vocabulary block, scored by
  ``train.losses.lm_loss_vocab_parallel`` (three all-reduces).
* Attention: the query heads are column-parallel (``Hq % M == 0``); the
  KV heads are split where ``Hkv % M == 0``, else the ``wk``/``wv`` blocks
  are all-gathered over ``model`` (or, where the spec keeps them whole,
  their gradient is all-reduced), and each slot attends with its own query
  heads; ``wo`` is row-parallel with one all-reduce.  The GLU and MLP are
  column-parallel, then row-parallel with one all-reduce.  A layer whose
  spec does not split it over ``model`` runs whole on every slot.
* The replicated input of each column-parallel product passes
  ``axis_sum_grads`` (identity; its backward all-reduces), the norms run
  on every slot.

So each slot's gradient of a leaf it holds whole over ``model`` is the
whole gradient, as in Megatron; the train step sums the batch axis.
Attention is ``layers._sdpa`` (the train path's differentiable copy).
Only attention + GLU/MLP decoders are partitioned: any other block, the
encoder-decoder, M-RoPE and the encoder raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.losses import lm_loss_vocab_parallel
from repro_torch.utils.flat import dtype_of
from repro_torch.utils.placed import Layout

BATCH_AXES = ("replica", "data")
MODEL_AXIS = "model"


def refuse(cfg: ArchConfig, part: str):
    raise NotImplementedError(
        f"the partitioned train step does not run {cfg.name}'s {part} (ROADMAP.md A6c); "
        "place its state on a grid of one slot (replica = model = 1) to train it whole")


def check_partitionable(cfg: ArchConfig, batch_keys: Sequence[str] = ()) -> None:
    """Raise ``NotImplementedError`` naming the arch and the part the
    partitioned step lacks."""
    if cfg.is_encoder_decoder:
        refuse(cfg, "encoder-decoder (whisper)")
    if cfg.family == "encoder":
        refuse(cfg, "encoder (RoBERTa)")
    for blk in cfg.blocks:
        if blk.mixer != "attn":
            refuse(cfg, {"mamba": "Mamba mixer", "rwkv": "RWKV time mix"}.get(
                blk.mixer, f"{blk.mixer} mixer"))
        if blk.ffn not in ("glu", "mlp"):
            refuse(cfg, {"moe": "MoE FFN", "rwkv_cm": "RWKV channel mix"}.get(
                blk.ffn, f"{blk.ffn} FFN"))
    if cfg.rope.kind == "mrope":
        refuse(cfg, "M-RoPE")
    for key in ("extra_embeds", "positions", "frames"):
        if key in batch_keys:
            refuse(cfg, f"batch input {key!r} (M-RoPE, extra_embeds, frames)")


def grid_axes(mesh: M.Mesh):
    """(batch axis or None, model axis or None) of a slab's grid."""
    batch = [a for a in mesh.axis_names if a in BATCH_AXES]
    other = [a for a in mesh.axis_names if a not in BATCH_AXES + (MODEL_AXIS,)]
    if len(batch) > 1 or other:
        raise NotImplementedError(f"a grid over {mesh.axis_names}: the partitioned step takes "
                                  "one batch axis (replica or data) and model")
    return (batch[0] if batch else None), (MODEL_AXIS if MODEL_AXIS in mesh.axis_names else None)


class _Slab:
    """One slab's per-slot parameter tensors and their layouts."""

    def __init__(self, cfg: ArchConfig, mesh: M.Mesh, live: Dict[str, List[torch.Tensor]],
                 layouts: Dict[str, Layout]):
        self.cfg, self.mesh, self.live, self.layouts = cfg, mesh, live, layouts
        self.dp, self.mp = grid_axes(mesh)
        self.n = mesh.devices.size
        self.M = mesh.extent(self.mp)

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
        for d, axes in enumerate(self.spec(name, rep is not None)):
            if self.dp is not None and self.dp in axes:
                if axes != (self.dp,):
                    raise NotImplementedError(f"{name}: dim {d} split over {axes}")
                parts = M.axis_all_gather(parts, self.mesh, self.dp, d)
        return parts

    def norm(self, prefix: str, rep, x: List[torch.Tensor]) -> List[torch.Tensor]:
        keys = ["scale"] + (["bias"] if self.cfg.norm == "layernorm" else [])
        ws = {k: self.weight(f"{prefix}/{k}", rep) for k in keys}
        return [L.norm_fwd(self.cfg, {k: ws[k][s] for k in keys}, x[s]) for s in range(self.n)]


def _attention(sl: _Slab, pre: str, rep, blk, h, angles):
    cfg, mesh, mp = sl.cfg, sl.mesh, sl.mp
    hd, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    stacked = rep is not None
    split = sl.split_over_model(f"{pre}/wq", -1, stacked)
    if not split:
        for k in ("wk", "wv", "wo"):
            if sl.split_over_model(f"{pre}/{k}", -1 if k != "wo" else 0, stacked):
                refuse(cfg, f"attention with {k} split over model and wq whole")
    elif Hq % sl.M:
        refuse(cfg, f"attention: {Hq} query heads do not split over model = {sl.M}")
    hq = Hq // sl.M if split else Hq
    kv_split = split and Hkv % sl.M == 0
    wq, wo = sl.weight(f"{pre}/wq", rep), sl.weight(f"{pre}/wo", rep)
    kv = {}
    for k in ("wk", "wv"):
        w = sl.weight(f"{pre}/{k}", rep)
        if split and not kv_split:
            if sl.split_over_model(f"{pre}/{k}", -1, stacked):
                w = M.axis_all_gather(w, mesh, mp, w[0].dim() - 1)
            else:  # whole on every slot, each using its query heads' share
                w = M.axis_sum_grads(w, mesh, mp)
        kv[k] = w
    if split:
        h = M.axis_sum_grads(h, mesh, mp)
    hkv = Hkv // sl.M if kv_split else Hkv
    rep_q = Hq // Hkv
    outs = []
    for s in range(sl.n):
        x = h[s]
        B, S, _ = x.shape
        ang = None if angles is None else angles[x.device][blk.rope_theta or cfg.rope.theta]
        q = (x @ wq[s]).reshape(B, S, hq, hd)
        k = (x @ kv["wk"][s]).reshape(B, S, hkv, hd)
        v = (x @ kv["wv"][s]).reshape(B, S, hkv, hd)
        if ang is not None:
            q, k = L.apply_rope(q, ang), L.apply_rope(k, ang)
        if split and not kv_split:  # each local query head's kv head, picked from all
            first = mesh.coord(s, mp) * hq
            idx = torch.tensor([(first + j) // rep_q for j in range(hq)], device=x.device)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        out = L._sdpa(q, k, v, causal=True, window=blk.window)
        outs.append(out.reshape(B, S, hq * hd) @ wo[s])
    if split:
        outs = M.axis_all_reduce(outs, mesh, mp)
    return [o.to(x.dtype) for o, x in zip(outs, h)]


def _ffn(sl: _Slab, pre: str, rep, kind: str, h):
    cfg, mesh, mp = sl.cfg, sl.mesh, sl.mp
    stacked = rep is not None
    split = sl.split_over_model(f"{pre}/w_up", -1, stacked)
    if split != sl.split_over_model(f"{pre}/w_down", 0, stacked):
        refuse(cfg, f"{kind} with w_up and w_down split differently over model")
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


def partitioned_loss(cfg: ArchConfig, mesh: M.Mesh, live: Dict[str, List[torch.Tensor]],
                     layouts: Dict[str, Layout], tokens: List[torch.Tensor], mask=None,
                     denominator: Optional[float] = None) -> List[torch.Tensor]:
    """Each slot's loss of its replica's rows: ``tokens[s]`` [B_r, S] (and
    ``mask[s]``) through the partitioned decoder (the module docstring),
    scored by ``lm_loss_vocab_parallel`` as Σ nll · mask over
    ``denominator``.  ``live[name][s]`` is slot ``s``'s tensor of leaf
    ``name``, ``layouts[name]`` its layout.  The loss is the same on every
    slot of a replica."""
    check_partitionable(cfg)
    sl = _Slab(cfg, mesh, live, layouts)
    n, mp = sl.n, sl.mp
    cdt = dtype_of(cfg.compute_dtype)
    # the embedding, vocab-parallel where its spec splits the vocabulary
    emb = sl.weight("embed")
    vocab_split = sl.split_over_model("embed", 0)
    if vocab_split:
        V = emb[0].shape[0]
        rows = []
        for s in range(n):
            ids = tokens[s] - mesh.coord(s, mp) * V
            inside = (ids >= 0) & (ids < V)
            r = emb[s][ids.clamp(0, V - 1)]
            rows.append(torch.where(inside[..., None], r, torch.zeros_like(r)))
        x = M.axis_all_reduce(rows, mesh, mp)
    else:
        x = [emb[s][tokens[s]] for s in range(n)]
    x = [xi.to(cdt) for xi in x]
    if cfg.scale_embed:
        x = [xi * torch.tensor(cfg.d_model ** 0.5, dtype=cdt, device=xi.device) for xi in x]
    angles = {}
    for s in range(n):
        dev = x[s].device
        if dev not in angles:
            B, S = tokens[s].shape
            angles[dev] = T._rope_angles(cfg, None, S, B, dev)
    if all(a is None for a in angles.values()):
        angles = None

    for pre, rep, blk in _layer_names(cfg):
        h = sl.norm(f"{pre}/norm1", rep, x)
        a = _attention(sl, f"{pre}/attn", rep, blk, h, angles)
        x = [xi + ai for xi, ai in zip(x, a)]
        h2 = sl.norm(f"{pre}/norm2", rep, x)
        f = _ffn(sl, f"{pre}/{blk.ffn}", rep, blk.ffn, h2)
        x = [xi + fi for xi, fi in zip(x, f)]

    x = sl.norm("final_norm", None, x)
    if cfg.tie_embeddings:
        heads, head_split = [e.T for e in emb], vocab_split
    else:
        heads, head_split = sl.weight("lm_head"), sl.split_over_model("lm_head", -1)
    if head_split:
        x = M.axis_sum_grads(x, mesh, mp)
    logits = [x[s] @ heads[s].to(x[s].dtype) for s in range(n)]
    if cfg.logit_softcap > 0:
        logits = [torch.tanh(lg / cfg.logit_softcap) * cfg.logit_softcap for lg in logits]
    return lm_loss_vocab_parallel(logits, tokens, mesh, mp if head_split else None, mask,
                                  denominator)
