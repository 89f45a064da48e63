"""The port's ``flash_attention`` and ``rwkv6_scan`` (their plain versions,
which the wrappers run for CPU tensors) against the JAX package: the
pure-jnp oracles in ``repro.kernels.ref`` and the Pallas kernels in
interpret mode, on the same numpy inputs.

Tolerances: f32 attention within 2e-5 (the bound the JAX package holds its
own Pallas kernel to; only the summation order differs); bf16 attention
within 1 bf16 ulp of the larger side (both compute in f32 and round once);
rwkv6 within 5e-4 against the chunked Pallas kernel (the bound of
``tests/test_kernels.py``) and 1e-5 relative against the sequential oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rwkv6_scan as trs


def _bf16_np(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _t(x):
    """numpy (f32 or ml_dtypes bf16) -> CPU tensor, bits carried over."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _qkv(B, Sq, Sk, Hq, Hkv, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v = (_bf16_np(a) for a in (q, k, v))
    return q, k, v


def _close_bf16(got: torch.Tensor, want: np.ndarray):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.maximum(abs(g), abs(w)), 2.0 ** -126))) - 7)
    assert got.dtype == torch.bfloat16
    assert np.all(np.abs(g - w) <= ulp), np.max(np.abs(g - w))


# (B, Sq, Sk, Hq, Hkv, hd, causal, window, bq, bk): tests/test_kernels.py's sweep
SWEEP = [
    (2, 128, 128, 4, 2, 32, True, None, 64, 64),
    (1, 256, 256, 4, 1, 64, True, 96, 64, 64),
    (2, 64, 64, 2, 2, 32, False, None, 32, 32),
    (1, 64, 64, 8, 8, 16, True, 16, 32, 32),
    (1, 128, 128, 2, 1, 128, True, None, 128, 128),
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window,bq,bk", SWEEP)
def test_flash_plain_matches_oracle_and_pallas(B, Sq, Sk, Hq, Hkv, hd, causal, window, bq, bk):
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, hd, seed=Sq + hd)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    pallas = pallas_flash(q, k, v, causal=causal, window=window, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5, rtol=0)
    via_ops = tops.attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                             block_q=bq, block_k=bk)
    assert torch.equal(via_ops, got)


def test_flash_plain_bf16():
    q, k, v = _qkv(1, 128, 128, 4, 2, 32, seed=7, dtype="bfloat16")
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True)
    _close_bf16(got, ref.flash_attention(q, k, v, causal=True))
    _close_bf16(got, pallas_flash(q, k, v, causal=True, block_q=64, block_k=64))


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("off", [0, 63, 127])
def test_flash_plain_decode_offset(off, window):
    """One-token decode against a longer cache (the serve_step pattern)."""
    q, k, v = _qkv(2, 1, 128, 4, 2, 32, seed=off)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window, q_offset=off)
    want = ref.flash_attention(q, k, v, causal=True, window=window, q_offset=off)
    pallas = pallas_flash(q, k, v, causal=True, window=window, q_offset=off, block_q=1,
                          block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5, rtol=0)


def test_flash_plain_fully_masked_rows_are_zero():
    """Rows at positions 100.. with a window of 8 over 64 keys see no key."""
    q, k, v = _qkv(1, 4, 64, 2, 1, 32, seed=3)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True, window=8, q_offset=100)
    want = ref.flash_attention(q, k, v, causal=True, window=8, q_offset=100)
    pallas = pallas_flash(q, k, v, causal=True, window=8, q_offset=100, block_q=4, block_k=64)
    assert torch.equal(got, torch.zeros_like(got))
    np.testing.assert_array_equal(np.asarray(want), 0.0)
    np.testing.assert_array_equal(np.asarray(pallas), 0.0)
    # a mix: with q_offset 66 the first row sees keys 59..63, later ones fewer or none
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True, window=8, q_offset=66)
    want = ref.flash_attention(q, k, v, causal=True, window=8, q_offset=66)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_flash_wrapper_refuses():
    before = tfa.flash_attention.launches
    q, k, v = (_t(a) for a in _qkv(1, 4, 8, 2, 1, 32, seed=0))
    with pytest.raises(ValueError, match="no backward"):
        tfa.flash_attention(q.requires_grad_(), k, v)
    q = q.detach()
    _, k3, v3 = (_t(a) for a in _qkv(1, 4, 8, 3, 3, 32, seed=0))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tfa.flash_attention(q, k3, v3)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, k, v, window=0)
    # the meta device (a dry run) gets an empty output of q's shape, no launch
    out = tfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    # the kernel's own limits are checked before anything touches a card
    q48, k48, v48 = (_t(a) for a in _qkv(1, 4, 8, 2, 1, 48, seed=0))
    with pytest.raises(ValueError, match="head_dim"):
        tfa._launch(q48, k48, v48, True, None, 0)
    with pytest.raises(TypeError, match="bf16 or all f32"):
        tfa._launch(q.half(), k.half(), v.half(), True, None, 0)
    shifted = torch.zeros(q.numel() + 1)[1:].view(q.shape)  # 4 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte"):
        tfa._launch(shifted, k, v, True, None, 0)
    assert tfa.flash_attention.launches == before


def _rwkv_inputs(B, T, H, hd, seed, floor=-4.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32) for _ in range(3))
    logw = np.clip(-np.exp(rng.standard_normal((B, T, H, hd)) - 1.5), floor, -1e-3)
    u = (rng.standard_normal((H, hd)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.3).astype(np.float32)
    return r, k, v, logw.astype(np.float32), u, s0


@pytest.mark.parametrize("B,T,H,hd,chunk",
                         [(2, 32, 2, 16, 16), (1, 64, 3, 32, 16), (2, 48, 1, 64, 16),
                          (1, 16, 4, 8, 8)])
def test_rwkv_plain_matches_oracle_and_pallas(B, T, H, hd, chunk):
    r, k, v, logw, u, s0 = _rwkv_inputs(B, T, H, hd, seed=T + hd)
    y, sT = trs.rwkv6_scan(*(_t(a) for a in (r, k, v, logw, u, s0)))
    y_ref, sT_ref = ref.rwkv6_scan(r, k, v, np.exp(logw), u, s0)
    y_k, sT_k = pallas_rwkv(r, k, v, logw, u, s0, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sT.numpy(), np.asarray(sT_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), atol=5e-4)
    np.testing.assert_allclose(sT.numpy(), np.asarray(sT_k), atol=5e-4)


def test_rwkv_plain_state_chaining():
    """Two half-sequences with the state carried == one full sequence."""
    r, k, v, logw, u, _ = _rwkv_inputs(1, 32, 2, 16, seed=5)
    s0 = np.zeros((1, 2, 16, 16), np.float32)
    full = trs.rwkv6_scan(*(_t(a) for a in (r, k, v, logw, u, s0)))
    y1, s1 = trs.rwkv6_scan(*(_t(a[:, :16]) for a in (r, k, v, logw)), _t(u), _t(s0))
    y2, s2 = trs.rwkv6_scan(*(_t(a[:, 16:]) for a in (r, k, v, logw)), _t(u), s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), full[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s2, full[1], rtol=1e-6, atol=1e-6)
    y_ref, s_ref = ref.rwkv6_scan(r, k, v, np.exp(logw), u, s0)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s_ref), rtol=1e-5, atol=1e-5)


def test_rwkv_plain_below_the_chunked_floor():
    """logw down to -20: the sequential form holds where the chunked Pallas
    kernel's contract (logw >= -4) does not, so only the oracle judges."""
    r, k, v, _, u, s0 = _rwkv_inputs(2, 24, 2, 32, seed=9)
    logw = -np.exp(np.random.default_rng(10).uniform(-3.0, np.log(20.0), r.shape)).astype(
        np.float32)
    assert logw.min() < -15
    y, sT = trs.rwkv6_scan(*(_t(a) for a in (r, k, v, logw, u, s0)))
    y_ref, sT_ref = ref.rwkv6_scan(r, k, v, np.exp(logw), u, s0)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sT.numpy(), np.asarray(sT_ref), rtol=1e-5, atol=1e-5)


def test_rwkv_plain_bf16_inputs_keep_rs_dtype():
    r, k, v, logw, u, s0 = _rwkv_inputs(1, 16, 2, 32, seed=11)
    rb, kb, vb, wb = (_bf16_np(a) for a in (r, k, v, logw))
    y, sT = trs.rwkv6_scan(*(_t(a) for a in (rb, kb, vb, wb, u, s0)))
    y_ref, sT_ref = ref.rwkv6_scan(rb, kb, vb, jnp.exp(jnp.asarray(wb, jnp.float32)), u, s0)
    assert y.dtype == torch.bfloat16 and sT.dtype == torch.float32
    _close_bf16(y, y_ref)
    np.testing.assert_allclose(sT.numpy(), np.asarray(sT_ref), rtol=1e-5, atol=1e-5)


def test_rwkv6_mix_clamps_like_the_reference():
    """ops.rwkv6_mix clamps logw to [-4, 0] before the recurrence."""
    r, k, v, _, u, s0 = _rwkv_inputs(1, 16, 1, 8, seed=12)
    logw = np.full(r.shape, -50.0, np.float32)  # far below the floor
    logw[0, ::3] = 0.5                           # and above the ceiling
    y, sT = tops.rwkv6_mix(*(_t(a) for a in (r, k, v, logw, u, s0)))
    y_j, sT_j = jops.rwkv6_mix(r, k, v, logw, u, s0)
    clamped = np.clip(logw, tops.RWKV_LOGW_FLOOR, 0.0)
    y_ref, sT_ref = ref.rwkv6_scan(r, k, v, np.exp(clamped), u, s0)
    assert tops.RWKV_LOGW_FLOOR == jops.RWKV_LOGW_FLOOR
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sT.numpy(), np.asarray(sT_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=5e-4)
    np.testing.assert_allclose(sT.numpy(), np.asarray(sT_j), atol=5e-4)


def test_rwkv_wrapper_refuses():
    before = trs.rwkv6_scan.launches
    args = [_t(a) for a in _rwkv_inputs(1, 4, 2, 16, seed=0)]
    with pytest.raises(ValueError, match="no backward"):
        trs.rwkv6_scan(args[0].clone().requires_grad_(), *args[1:])
    with pytest.raises(ValueError, match=r"u \[H, hd\]"):
        trs.rwkv6_scan(*args[:4], args[4][:1], args[5])
    with pytest.raises(ValueError, match="head_dim"):
        trs._launch(*args)  # hd 16: the kernel takes 32 or 64
    args32 = [_t(a) for a in _rwkv_inputs(1, 4, 2, 32, seed=0)]
    with pytest.raises(TypeError, match="f32 u and s0"):
        trs._launch(*args32[:4], args32[4].double(), args32[5])
    assert trs.rwkv6_scan.launches == before
    y, sT = trs.rwkv6_scan(*(a[:, :0] for a in args[:4]), args[4], args[5])
    assert y.shape == (1, 0, 2, 16) and torch.equal(sT, args[5])
