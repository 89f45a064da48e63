"""The two routes of the port's ``rwkv6_scan`` on the card, each against
``rwkv6_scan_plain``.  Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_rwkv_routes_cuda.py

Each test skips without a card (the kernels have no CPU mode).
Tolerances as in ``test_torch_attention_rwkv_cuda.py``: f32 outputs within
2e-5 x max(1, max|plain|); bf16 outputs within that plus 1 bf16 ulp of the
larger side (f32 sums in another order, each side rounded once).  logw is
drawn down to -20: the kernels are exact for any logw <= 0, no clamp.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import rwkv6_scan as trs


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want):
    g, w = got.float(), want.float()
    assert got.dtype == want.dtype
    assert torch.isfinite(g).all()
    tol = 2e-5 * max(1.0, w.abs().max().item())
    if got.dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(
            2.0 ** -126))) - 7)
    assert bool(((g - w).abs() <= tol).all()), (g - w).abs().max().item()


def _inputs(B, T, H, hd, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(dev).to(dt)

    r, k, v = (t(rng.standard_normal((B, T, H, hd))) for _ in range(3))
    logw = t(-np.exp(rng.uniform(np.log(0.0025), np.log(20.0), (B, T, H, hd))))
    u = t(0.5 * rng.standard_normal((H, hd)), torch.float32)
    s0 = t(0.3 * rng.standard_normal((B, H, hd, hd)), torch.float32)
    return r, k, v, logw, u, s0


def _routed(want, *args):
    """One call, checked to launch once through ``want``."""
    assert trs.route(args[0].shape[1]) == want
    before = dict(trs.rwkv6_scan.launches_by_route)
    n = trs.rwkv6_scan.launches
    out = trs.rwkv6_scan(*args)
    torch.cuda.synchronize()
    after = trs.rwkv6_scan.launches_by_route
    assert after[want] == before[want] + 1 and trs.rwkv6_scan.launches == n + 1
    assert sum(after.values()) == sum(before.values()) + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd,dtype", [
    (4, 256, 64, 64, torch.float32),    # rwkv6-7b's prefill
    (3, 37, 5, 64, torch.float32),      # T off the 16-step chunk, B*H off any tiling
    (2, 100, 7, 32, torch.float32),     # hd 32
    (2, 45, 8, 64, torch.bfloat16),
    (1, 17, 3, 32, torch.bfloat16),
    (1, 2, 1, 64, torch.float32),       # the shortest scan
])
def test_scan_route_matches_plain(B, T, H, hd, dtype):
    dev = _card()
    args = _inputs(B, T, H, hd, dtype, dev, seed=T)
    y, s = _routed("scan", *args)
    yp, sp = trs.rwkv6_scan_plain(*args)
    assert y.dtype == dtype and s.dtype == torch.float32
    _close(y, yp)
    _close(s, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype", [(64, torch.float32), (32, torch.bfloat16)])
def test_scan_route_takes_one_step_too(hd, dtype):
    """T = 1 routes to step, but the scan kernel is right at T = 1 as well."""
    dev = _card()
    args = _inputs(3, 1, 5, hd, dtype, dev, seed=hd)
    before = dict(trs.rwkv6_scan.launches_by_route)
    y, s = trs._launch(*args, which="scan")
    torch.cuda.synchronize()
    assert trs.rwkv6_scan.launches_by_route["scan"] == before["scan"] + 1
    yp, sp = trs.rwkv6_scan_plain(*args)
    _close(y, yp)
    _close(s, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,hd,dtype", [
    (4, 64, 64, torch.float32),         # rwkv6-7b's decode step
    (3, 5, 64, torch.float32),
    (2, 7, 32, torch.float32),
    (4, 64, 64, torch.bfloat16),
    (1, 3, 32, torch.bfloat16),
])
def test_step_route_matches_plain(B, H, hd, dtype):
    dev = _card()
    args = _inputs(B, 1, H, hd, dtype, dev, seed=H)
    y, s = _routed("step", *args)
    yp, sp = trs.rwkv6_scan_plain(*args)
    assert y.dtype == dtype and s.dtype == torch.float32
    _close(y, yp)
    _close(s, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64])
def test_32_chained_steps_match_one_scan(hd):
    """The serving path's decode: 32 step calls carry the state as one scan
    call of T = 32 does, and both match the plain version."""
    dev = _card()
    r, k, v, logw, u, s0 = _inputs(4, 32, 8, hd, torch.float32, dev, seed=hd)
    y_scan, s_scan = _routed("scan", r, k, v, logw, u, s0)
    st, ys = s0, []
    for t in range(32):
        yt, st = _routed("step", *(x[:, t:t + 1].contiguous() for x in (r, k, v, logw)), u, st)
        ys.append(yt)
    yp, sp = trs.rwkv6_scan_plain(r, k, v, logw, u, s0)
    _close(torch.cat(ys, 1), yp)
    _close(st, sp)
    _close(y_scan, yp)
    _close(s_scan, sp)


@pytest.mark.cuda
def test_prefill_then_decode_chain():
    """A scan of 100 + 156 steps, then steps, against one plain call."""
    dev = _card()
    r, k, v, logw, u, s0 = _inputs(2, 260, 4, 64, torch.float32, dev, seed=1)
    y1, s1 = _routed("scan", *(x[:, :100].contiguous() for x in (r, k, v, logw)), u, s0)
    y2, s2 = _routed("scan", *(x[:, 100:256].contiguous() for x in (r, k, v, logw)), u, s1)
    ys, st = [y1, y2], s2
    for t in range(256, 260):
        yt, st = _routed("step", *(x[:, t:t + 1].contiguous() for x in (r, k, v, logw)), u, st)
        ys.append(yt)
    yp, sp = trs.rwkv6_scan_plain(r, k, v, logw, u, s0)
    _close(torch.cat(ys, 1), yp)
    _close(st, sp)


@pytest.mark.cuda
def test_card_refusals_launch_nothing():
    dev = _card()
    args = _inputs(1, 4, 2, 64, torch.float32, dev)
    before = trs.rwkv6_scan.launches
    with pytest.raises(ValueError, match="step route takes T = 1"):
        trs._launch(*args, which="step")
    with pytest.raises(ValueError, match="head_dim"):
        trs.rwkv6_scan(*_inputs(1, 4, 2, 48, torch.float32, dev))
    shifted = torch.zeros(args[0].numel() + 1, device=dev)[1:].view(args[0].shape)
    with pytest.raises(ValueError, match="16-byte"):
        trs.rwkv6_scan(shifted, *args[1:])
    with pytest.raises(TypeError, match="all bf16 or all f32"):
        trs.rwkv6_scan(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        trs.rwkv6_scan(args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:])
    assert trs.rwkv6_scan.launches == before
