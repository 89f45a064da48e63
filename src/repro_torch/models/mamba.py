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


def _ssm_inputs(cfg: ArchConfig, p, xc: torch.Tensor):
    """xc [B, S, di] post-conv activations -> (dA, dBx [B, S, di, ds], C
    [B, S, ds]), all f32."""
    ds, dtr = cfg.ssm.d_state, cfg.ssm.dt_rank
    proj = (xc @ p["x_proj"]).float()  # [B, S, dtr + 2 ds]
    dt_low, Bmat, Cmat = torch.split(proj, [dtr, ds, ds], dim=-1)
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


def mamba_fwd(cfg: ArchConfig, p, x: torch.Tensor, *, state=None, return_state: bool = False):
    """x [B, S, D] -> (y [B, S, D], new state or None).

    ``state``: optional dict {"h": [B, di, ds] f32, "conv": [B, dc-1, di]}
    to resume from (S may be 1).  The new state is returned as new tensors;
    the caller decides where it lives."""
    B, S, _ = x.shape
    di, ds, dc = d_inner(cfg), cfg.ssm.d_state, cfg.ssm.d_conv
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)  # [B, S, di] each
    prepend = None if state is None else state["conv"]
    xc = _conv(cfg, p, xi, prepend=prepend)
    dA, dBx, Cmat = _ssm_inputs(cfg, p, xc)
    h = state["h"] if state is not None else torch.zeros((B, di, ds), dtype=torch.float32,
                                                          device=x.device)
    if x.is_meta:
        ys, h = _meta_scan(dA, dBx, Cmat, h)
    else:
        steps = []
        for t in range(S):
            h = dA[:, t] * h + dBx[:, t]
            steps.append(torch.einsum("bns,bs->bn", h, Cmat[:, t]))
        ys = torch.stack(steps, dim=1)
    y = ys + xc.float() * p["D"]
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    new_state = None
    if return_state:
        if prepend is None:
            prepend = torch.zeros((B, dc - 1, di), dtype=x.dtype, device=x.device)
        new_state = {"h": h, "conv": torch.cat([prepend, xi], dim=1)[:, -(dc - 1):]}
    return out, new_state


def init_mamba_state(cfg: ArchConfig, batch: int, dtype, device):
    di, ds, dc = d_inner(cfg), cfg.ssm.d_state, cfg.ssm.d_conv
    return {"h": torch.zeros((batch, di, ds), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, dc - 1, di), dtype=dtype, device=device)}
