"""Mamba (selective SSM) mixer, the recurrent 7 of every 8 layers of Jamba
(Gu & Dao 2023; arXiv:2403.19887).  Port of ``repro.models.mamba``; the
parameter tree carries the reference's leaves, shapes and dtypes:
``A_log`` and ``D`` are f32 whatever the param dtype, so a bf16 jamba tree
has mixed dtypes and its flat row is stored in f32 (``FlatSpec``'s rule,
as in the reference).

The dtypes follow the reference step by step: the depthwise causal conv
multiplies and adds its taps in the compute dtype; from ``x_proj`` on the
SSM inputs are f32; ``y`` is cast back to x's dtype before the ``silu(z)``
gate.  The reference scans the sequence with ``lax.scan`` and has no
kernel for it, so the port runs the selective scan as plain PyTorch on
every device, a Python loop over the sequence (it trains through
autograd).  On the meta device (a dry run) the loop is skipped: its output
shapes and its cost by formula (``_meta_scan``).  Decode keeps an O(1)
state: ``h`` [B, d_inner, d_state] f32 and the conv window ``conv``
[B, d_conv - 1, d_inner].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_init, normal_init
from repro_torch.utils import op_counts as _oc


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def init_mamba(cfg: ArchConfig, gen: torch.Generator, dtype, device):
    """Draw order: in_proj, conv_w, x_proj, dt_proj, out_proj.  A is the
    S4D-real init (A_log = log(1..d_state) per channel)."""
    d, di, ds = cfg.d_model, d_inner(cfg), cfg.ssm.d_state
    dtr, dc = cfg.ssm.dt_rank, cfg.ssm.d_conv
    A = torch.arange(1, ds + 1, dtype=torch.float32, device=device).expand(di, ds)
    p = {"in_proj": dense_init(gen, d, 2 * di, dtype, device),
         "conv_w": normal_init(gen, (dc, di), 0.1, dtype, device),
         "conv_b": torch.zeros((di,), dtype=dtype, device=device),
         "x_proj": dense_init(gen, di, dtr + 2 * ds, dtype, device),
         "dt_proj": dense_init(gen, dtr, di, dtype, device),
         "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=device),  # softplus^-1(0.01)
         "A_log": torch.log(A).contiguous(),
         "D": torch.ones((di,), dtype=torch.float32, device=device)}
    p["out_proj"] = dense_init(gen, di, d, dtype, device)
    return p


def x_proj(p, xc: torch.Tensor) -> torch.Tensor:
    """The ``x_proj`` product of the post-conv activations xc [B, S, di] in
    the compute dtype: [B, S, dtr + 2 ds] (a slot's partial sum over its
    channels on the partitioned path)."""
    return xc @ p["x_proj"]


def _ssm_inputs(cfg: ArchConfig, p, xc: torch.Tensor, proj=None):
    """xc [B, S, di] post-conv activations -> (dA, dBx [B, S, di, ds], C
    [B, S, ds]), all f32.  ``proj`` is ``x_proj(p, xc)`` (computed here by
    default); from it on every step is local to a channel, so ``p``'s
    ``dt_proj``, ``dt_bias``, ``A_log`` and xc may be a block of the di
    channels."""
    ds, dtr = cfg.ssm.d_state, cfg.ssm.dt_rank
    if proj is None:
        proj = x_proj(p, xc)
    dt_low, Bmat, Cmat = torch.split(proj.float(), [dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_low @ p["dt_proj"].float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"])  # [di, ds]
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * xc.float())[..., :, None] * Bmat[..., None, :]
    return dA, dBx, Cmat


def _conv(cfg: ArchConfig, p, x: torch.Tensor, prepend=None) -> torch.Tensor:
    """Depthwise causal conv over time, x [B, S, di]; ``prepend`` [B, dc-1,
    di] holds the previous positions (zeros without it).  Products and sums
    in the compute dtype, tap by tap, as the reference adds them."""
    dc, S = cfg.ssm.d_conv, x.shape[1]
    if prepend is None:
        prepend = torch.zeros_like(x[:, :1]).expand(-1, dc - 1, -1)
    ctx = torch.cat([prepend, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(dc):
        out = out + ctx[:, i:i + S] * p["conv_w"][i]
    return F.silu(out + p["conv_b"])


def _meta_scan(dA, dBx, Cmat, h):
    """The selective scan on the meta device (a dry run): ``(ys [B, S, di],
    h [B, di, ds])`` without the loop over S, its cost booked as
    ``mamba_scan`` (``utils.op_counts.meta_recurrence``): the FLOPs the
    loop's ``C`` contraction counts, 2·B·S·di·ds forward and twice that
    backward, and the bytes a counter sees the loop's ops move forward,
    S·(7X + 4·B·(ds + di)) + 8·B·S·di with X = 4·B·di·ds (the backward's
    taken as four times that)."""
    B, S, di, ds = dA.shape
    flops = 2 * B * S * di * ds
    nbytes = S * (7 * 4 * B * di * ds + 4 * B * (ds + di)) + 8 * B * S * di
    return _oc.meta_recurrence("mamba_scan", (dA, dBx, Cmat, h),
                               (((B, S, di), torch.float32), ((B, di, ds), torch.float32)),
                               (flops, nbytes), (2 * flops, 4 * nbytes))


def selective_scan(dA, dBx, Cmat, h=None):
    """The scan over S: ``(ys [B, S, di] f32, the final h [B, di, ds])``
    from ``h`` (zeros by default), channel by channel."""
    B, _, di, ds = dA.shape
    if h is None:
        h = torch.zeros((B, di, ds), dtype=torch.float32, device=dA.device)
    if dA.is_meta:
        return _meta_scan(dA, dBx, Cmat, h)
    steps = []
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        steps.append(torch.einsum("bns,bs->bn", h, Cmat[:, t]))
    return torch.stack(steps, dim=1), h


def gated(p, ys, xc, z):
    """``(ys + xc·D)`` cast to z's dtype, times ``silu(z)``: the input of
    ``out_proj`` [B, S, di]."""
    return (ys + xc.float() * p["D"]).to(z.dtype) * F.silu(z)


def conv_window(cfg: ArchConfig, prepend, xi: torch.Tensor) -> torch.Tensor:
    """The conv's new state: the last dc - 1 positions of ``prepend`` (zeros
    when None) followed by xi [B, S, di]."""
    if prepend is None:
        B, _, di = xi.shape
        prepend = torch.zeros((B, cfg.ssm.d_conv - 1, di), dtype=xi.dtype, device=xi.device)
    return torch.cat([prepend, xi], dim=1)[:, -(cfg.ssm.d_conv - 1):]


def mamba_fwd(cfg: ArchConfig, p, x: torch.Tensor, *, state=None, return_state: bool = False):
    """x [B, S, D] -> (y [B, S, D], new state or None).

    ``state``: optional dict {"h": [B, di, ds] f32, "conv": [B, dc-1, di]}
    to resume from (S may be 1).  The new state is returned as new tensors;
    the caller decides where it lives.  The steps after ``in_proj`` are
    the channel-local parts ``models.partitioned`` runs on a slot's block
    of channels: ``_conv``, ``x_proj``, ``_ssm_inputs``,
    ``selective_scan``, ``gated``."""
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)  # [B, S, di] each
    prepend = None if state is None else state["conv"]
    xc = _conv(cfg, p, xi, prepend=prepend)
    dA, dBx, Cmat = _ssm_inputs(cfg, p, xc)
    ys, h = selective_scan(dA, dBx, Cmat, None if state is None else state["h"])
    out = gated(p, ys, xc, z) @ p["out_proj"]
    new_state = None
    if return_state:
        new_state = {"h": h, "conv": conv_window(cfg, prepend, xi)}
    return out, new_state


def init_mamba_state(cfg: ArchConfig, batch: int, dtype, device):
    di, ds, dc = d_inner(cfg), cfg.ssm.d_state, cfg.ssm.d_conv
    return {"h": torch.zeros((batch, di, ds), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, dc - 1, di), dtype=dtype, device=device)}
