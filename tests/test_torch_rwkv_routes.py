"""The routes of the port's ``rwkv6_scan`` wrapper, and plain models of its
two CUDA kernels' arithmetic, on the CPU.

``route`` is a pure function of T.  ``scan_model`` below repeats the scan
route's arithmetic (``csrc/rwkv6_scan.cu``): inputs staged a chunk of 16
steps at a time as f32 with w = exp(logw), each thread's 4 x 4 tile of the
state, the 4-row groups' partial sums of r_t[i] S[i][j] added in the
kernel's order, and the bonus term hoisted into s_t = sum_i r_t[i] u[i]
k_t[i].  ``step_model`` repeats the step route's (``csrc/rwkv6_step.cu``,
T = 1): each thread's share of s folded into its partial sums, which meet
by a butterfly inside a warp and then warp by warp.  Both are held against
the JAX package's oracle ``repro.kernels.ref.rwkv6_scan`` (given w =
exp(logw)) for logw down to -20, and against the Pallas kernel in interpret
mode for logw in [-4, 0], on the same numpy inputs.

Tolerances: f32 within 2e-5 x max(1, max|ref|) (the bound the card's check
holds the kernels to; only the order of the f32 sums differs); bf16 y
within 1 bf16 ulp of the larger side plus that (both sides round the same
f32 sums once); against the Pallas kernel 5e-4, the bound of the port's
existing Pallas comparison (its chunked form rescales by exp(cum - m)).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv
from repro_torch.kernels import rwkv6_scan as trs

CHUNK = 16   # steps staged per pass by the scan kernel
RT = 4       # rows of the state per thread (both kernels)


def _butterfly(x, ascending=False):
    """x [..., n] summed over its last axis as lanes 0..n-1 do with
    ``v += __shfl_xor_sync(v, m)`` at distances m = n/2, n/4, ..., 1 (or
    1, 2, ..., n/2 when ``ascending``); every lane ends with the same sum,
    lane 0's is returned."""
    n = x.shape[-1]
    dists = [1 << e for e in range(n.bit_length() - 1)]
    for m in (dists if ascending else dists[::-1]):
        x = x + x[..., torch.arange(n) ^ m]
    return x[..., 0]


def _group_partials(rt, S):
    """Per row group g of RT rows: sum_i r[i] S[i][j] over the group's rows,
    in row order (the first product, then multiply-adds).  rt [B, H, hd],
    S [B, H, hd, hd] -> [B, H, hd / RT, hd]."""
    B, H, hd = rt.shape
    rg = rt.reshape(B, H, hd // RT, RT, 1)
    Sg = S.reshape(B, H, hd // RT, RT, hd)
    p = rg[:, :, :, 0] * Sg[:, :, :, 0]
    for i in range(1, RT):
        p = p + rg[:, :, :, i] * Sg[:, :, :, i]
    return p


def scan_model(r, k, v, logw, u, s0):
    """The scan route's arithmetic in plain PyTorch."""
    B, T, H, hd = r.shape
    S = s0.float().clone()
    uf = u.float()
    ys = []
    for t0 in range(0, T, CHUNK):
        n = min(CHUNK, T - t0)
        # staging: f32, w = exp(logw), steps past T read 0
        stage = []
        for x in (r, k, logw, v):
            c = torch.zeros((B, CHUNK, H, hd), dtype=torch.float32)
            c[:, :n] = x[:, t0:t0 + n].float()
            stage.append(c)
        cr, ck, cw, cv = stage
        cw = torch.exp(cw)
        parts = []
        for t in range(n):
            parts.append(_group_partials(cr[:, t], S))                  # [B, H, NRG, hd]
            S = cw[:, t, :, :, None] * S + ck[:, t, :, :, None] * cv[:, t, :, None, :]
        for t in range(n):
            # s_t: lane l of a step's group adds r u k at rows 4l.. in
            # order; the hd / 4 lanes meet by a butterfly
            ruk = (cr[:, t] * uf * ck[:, t]).reshape(B, H, hd // 4, 4)
            lane = ruk[..., 0]
            for e in range(1, 4):
                lane = lane + ruk[..., e]
            s_t = _butterfly(lane)                                       # [B, H]
            acc = parts[t][:, :, 0]
            for g in range(1, hd // RT):
                acc = acc + parts[t][:, :, g]
            ys.append(acc + cv[:, t] * s_t[..., None])
    return torch.stack(ys, dim=1).to(r.dtype), S


def step_model(r, k, v, logw, u, s0):
    """The step route's arithmetic (T = 1) in plain PyTorch."""
    B, T, H, hd = r.shape
    assert T == 1
    rf, kf, vf, wf = (x[:, 0].float() for x in (r, k, v, logw))
    wf = torch.exp(wf)
    S = s0.float()
    nc4 = hd // 4
    ruk = (rf * u.float()).reshape(B, H, nc4, RT)
    kk = kf.reshape(B, H, nc4, RT)
    a = ruk[..., 0] * kk[..., 0]
    for i in range(1, RT):
        a = a + ruk[..., i] * kk[..., i]                                 # [B, H, NRG]
    p = _group_partials(rf, S) + vf[:, :, None, :] * a[..., None]        # [B, H, NRG, hd]
    # a warp holds 32 / nc4 row groups: butterfly over them, then warp by warp
    per_warp = 32 // nc4
    w = _butterfly(p.reshape(B, H, -1, per_warp, hd).transpose(-1, -2),
                   ascending=True)                                       # [B, H, warps, hd]
    y = w[:, :, 0]
    for i in range(1, w.shape[2]):
        y = y + w[:, :, i]
    S_new = wf[..., None] * S + kf[..., None] * vf[:, :, None, :]
    return y[:, None].to(r.dtype), S_new


def _inputs(B, T, H, hd, seed, lo=-20.0, hi=-0.0025):
    """r, k, v, logw, u, s0 as numpy f32; logw in [lo, hi] with log-uniform
    magnitudes (the card check's draw)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32) for _ in range(3))
    mag = rng.uniform(np.log(-hi), np.log(-lo), (B, T, H, hd))
    logw = (-np.exp(mag)).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, hd))).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((B, H, hd, hd))).astype(np.float32)
    return r, k, v, logw, u, s0


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def _f32_close(got, want):
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    got = got.float()
    assert torch.isfinite(got).all()
    tol = 2e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol, (got - want).abs().max().item()


def _bf16_close(got, want):
    assert got.dtype == torch.bfloat16
    g = got.float()
    w = torch.from_numpy(np.array(want.astype(jnp.float32)))
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(
        2.0 ** -126))) - 7)
    tol = ulp + 2e-5 * max(1.0, w.abs().max().item())
    assert bool(((g - w).abs() <= tol).all()), (g - w).abs().max().item()


def _ref(r, k, v, logw, u, s0):
    """The JAX oracle on the same values (bf16 inputs stay bf16)."""
    w = jnp.exp(jnp.asarray(logw).astype(jnp.float32))
    return ref.rwkv6_scan(jnp.asarray(r), jnp.asarray(k), jnp.asarray(v), w, jnp.asarray(u),
                          jnp.asarray(s0))


@pytest.mark.parametrize("T,want", [(1, "step"), (2, "scan"), (16, "scan"), (37, "scan"),
                                    (256, "scan"), (1024, "scan")])
def test_route_is_a_function_of_T(T, want):
    assert trs.route(T) == want
    assert trs.route(T) == want   # the same answer on every call
    assert want in trs.ROUTES


def test_rwkv6_7b_serving_routes():
    """The Engine's prefill (4 x 256 tokens) takes scan, each decode step
    (one token) takes step."""
    assert trs.route(256) == "scan" and trs.route(1) == "step"


@pytest.mark.parametrize("T", [16, 37, 256])
@pytest.mark.parametrize("hd", [32, 64])
def test_scan_model_matches_reference_f32(T, hd):
    a = _inputs(1, T, 2, hd, seed=T + hd)
    y, s = scan_model(*(torch.from_numpy(x) for x in a))
    y_ref, s_ref = ref.rwkv6_scan(*a[:3], np.exp(a[3]), *a[4:])
    _f32_close(y, y_ref)
    _f32_close(s, s_ref)
    assert a[3].min() < -19.0   # the draw reaches the decays the model never clamps


@pytest.mark.parametrize("T,hd", [(16, 64), (37, 32), (37, 64)])
def test_scan_model_matches_reference_bf16(T, hd):
    a = _inputs(2, T, 2, hd, seed=100 + T)
    rb, kb, vb, wb = (_bf16(x) for x in a[:4])
    y, s = scan_model(rb, kb, vb, wb, torch.from_numpy(a[4]), torch.from_numpy(a[5]))
    y_ref, s_ref = _ref(*(jnp.asarray(x, jnp.bfloat16) for x in a[:4]), a[4], a[5])
    _bf16_close(y, y_ref)
    _f32_close(s, s_ref)


@pytest.mark.parametrize("hd", [32, 64])
def test_scan_model_many_heads_matches_reference(hd):
    """Several batch rows and heads, T off the staging chunk."""
    a = _inputs(2, 37, 3, hd, seed=7)
    y, s = scan_model(*(torch.from_numpy(x) for x in a))
    y_ref, s_ref = ref.rwkv6_scan(*a[:3], np.exp(a[3]), *a[4:])
    _f32_close(y, y_ref)
    _f32_close(s, s_ref)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_step_model_matches_reference(hd, dtype):
    a = _inputs(4, 1, 3, hd, seed=hd)
    if dtype == "f32":
        y, s = step_model(*(torch.from_numpy(x) for x in a))
        y_ref, s_ref = ref.rwkv6_scan(*a[:3], np.exp(a[3]), *a[4:])
        _f32_close(y, y_ref)
    else:
        y, s = step_model(*(_bf16(x) for x in a[:4]), torch.from_numpy(a[4]),
                          torch.from_numpy(a[5]))
        y_ref, s_ref = _ref(*(jnp.asarray(x, jnp.bfloat16) for x in a[:4]), a[4], a[5])
        _bf16_close(y, y_ref)
    _f32_close(s, s_ref)


@pytest.mark.parametrize("T,hd", [(1, 64), (16, 32), (256, 64)])
def test_models_match_pallas_interpret(T, hd):
    """logw in [-4, 0], where the TPU kernel's chunked form holds."""
    a = _inputs(1, T, 1, hd, seed=T, lo=-4.0)
    y_k, s_k = pallas_rwkv(*a)
    model = step_model if T == 1 else scan_model
    y, s = model(*(torch.from_numpy(x) for x in a))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), atol=5e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_k), atol=5e-4)


def test_state_chained_across_calls():
    """32 chained step calls and a scan call of 100 + 156 steps carry the
    state as one call does (the serving path's prefill, then decode)."""
    a = _inputs(2, 256, 2, 64, seed=3)
    ta = [torch.from_numpy(x) for x in a]
    y_ref, s_ref = ref.rwkv6_scan(*a[:3], np.exp(a[3]), *a[4:])
    y1, s1 = scan_model(*(x[:, :100] for x in ta[:4]), ta[4], ta[5])
    y2, s2 = scan_model(*(x[:, 100:] for x in ta[:4]), ta[4], s1)
    _f32_close(torch.cat([y1, y2], 1), y_ref)
    _f32_close(s2, s_ref)
    y32_ref, s32_ref = ref.rwkv6_scan(*(x[:, :32] for x in a[:3]), np.exp(a[3][:, :32]),
                                      *a[4:])
    st, ys = ta[5], []
    for t in range(32):
        yt, st = step_model(*(x[:, t:t + 1] for x in ta[:4]), ta[4], st)
        ys.append(yt)
    _f32_close(torch.cat(ys, 1), y32_ref)
    _f32_close(st, s32_ref)


@pytest.mark.parametrize("T", [1, 37])
def test_wrapper_on_the_cpu_takes_the_plain_version(T):
    """CPU tensors go to rwkv6_scan_plain and launch nothing."""
    a = [torch.from_numpy(x) for x in _inputs(1, T, 2, 32, seed=T)]
    before = (trs.rwkv6_scan.launches, dict(trs.rwkv6_scan.launches_by_route))
    y, s = trs.rwkv6_scan(*a)
    yp, sp = trs.rwkv6_scan_plain(*a)
    assert torch.equal(y, yp) and torch.equal(s, sp)
    assert (trs.rwkv6_scan.launches, trs.rwkv6_scan.launches_by_route) == before


def test_reset_launches_zeroes_every_route():
    trs.rwkv6_scan.launches_by_route["step"] += 3
    trs.rwkv6_scan.launches += 3
    trs.reset_launches()
    assert trs.rwkv6_scan.launches == 0
    assert trs.rwkv6_scan.launches_by_route == {"scan": 0, "step": 0}


def test_wrapper_refuses_what_no_route_takes():
    """Refusals raise before anything reaches a card, and count nothing."""
    a = [torch.from_numpy(x) for x in _inputs(1, 4, 2, 32, seed=0)]
    before = (trs.rwkv6_scan.launches, dict(trs.rwkv6_scan.launches_by_route))
    with pytest.raises(ValueError, match="step route takes T = 1"):
        trs._launch(*a, which="step")
    with pytest.raises(ValueError, match="head_dim"):
        trs._launch(*(x[..., :16].contiguous() for x in a[:4]), a[4][:, :16].contiguous(),
                    a[5][..., :16, :16].contiguous())
    with pytest.raises(TypeError, match="all bf16 or all f32"):
        trs._launch(a[0].bfloat16(), *a[1:])
    with pytest.raises(TypeError, match="f32 u and s0"):
        trs._launch(*a[:5], a[5].double())
    with pytest.raises(ValueError, match="contiguous"):
        trs._launch(a[0].transpose(1, 2).contiguous().transpose(1, 2), *a[1:])
    shifted = torch.zeros(a[0].numel() + 1)[1:].view(a[0].shape)  # 4 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte"):
        trs._launch(shifted, *a[1:])
    with pytest.raises(ValueError, match="routes are"):
        trs._launch(*a, which="chunked")
    with pytest.raises(ValueError, match="one device"):
        trs._check(*a[:5], a[5].to("meta"))
    assert (trs.rwkv6_scan.launches, trs.rwkv6_scan.launches_by_route) == before


if __name__ == "__main__":
    # the models' largest differences from the oracle (ROADMAP.md quotes them):
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_rwkv_routes.py
    worst = {}
    for T in (1, 16, 37, 256):
        for hd in (32, 64):
            a = _inputs(1, T, 2, hd, seed=T + hd)
            y, s = (step_model if T == 1 else scan_model)(*(torch.from_numpy(x) for x in a))
            y_ref, s_ref = ref.rwkv6_scan(*a[:3], np.exp(a[3]), *a[4:])
            d = max(np.abs(y.numpy() - np.asarray(y_ref)).max(),
                    np.abs(s.numpy() - np.asarray(s_ref)).max())
            scale = max(1.0, float(np.abs(np.asarray(y_ref)).max()),
                        float(np.abs(np.asarray(s_ref)).max()))
            worst[(T, hd)] = (d, d / scale)
            print(f"T={T} hd={hd} f32, logw down to {a[3].min():.2f}: max|d| {d:.3g} "
                  f"({d / scale:.3g} x max(1, max|ref|))")
    print(f"largest relative to max(1, max|ref|): {max(v[1] for v in worst.values()):.3g}")
