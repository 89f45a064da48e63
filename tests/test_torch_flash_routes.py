"""The route and split plan of the port's ``flash_attention`` wrapper, and
the plain model of its split-K decode, on the CPU.

``route`` and ``decode_plan`` are pure functions of dtype and shapes;
``split_merge_plain`` below repeats the decode kernel's arithmetic (f32
partials per split in the log2 domain, then the log-sum-exp merge) and is
held against ``flash_attention_plain`` and the JAX package's oracle
``repro.kernels.ref.flash_attention`` on the same numpy inputs.
Tolerances: f32 within 2e-5 (the bound of the kernels' own f32 parity;
only the order of the sums differs); bf16 within 1 bf16 ulp of the larger
side plus 2e-5 x max(1, max|o|) (both round the f32 result once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as tfa


def split_merge_plain(q, k, v, *, causal=True, window=None, q_offset=0):
    """Plain PyTorch model of the decode route's arithmetic: f32 partials
    ``(m, l, acc)`` per split of ``decode_plan`` (scores in the log2 domain,
    as the kernel's exp2), then the log-sum-exp merge of the splits."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    plan = tfa.decode_plan(B, Sq, Sk, Hkv, causal=causal, window=window, q_offset=q_offset)
    # rows of a kv head: r = i * rep + (h % rep), as the kernel's block holds them
    qf = q.float().reshape(B, Sq, Hkv, rep, hd).permute(0, 2, 1, 3, 4).reshape(B, Hkv, Sq * rep,
                                                                               hd)
    pos = q_offset + torch.arange(Sq * rep, device=q.device) // rep
    ms, ls, accs = [], [], []
    for s in range(plan.n_splits):
        a = plan.k_lo + s * plan.chunk
        e = min(a + plan.chunk, plan.k_hi)
        kf = k[:, a:e].float().permute(0, 2, 1, 3)          # [B, Hkv, n, hd]
        vf = v[:, a:e].float().permute(0, 2, 1, 3)
        sc = torch.einsum("bhrd,bhkd->bhrk", qf, kf) * (hd ** -0.5 * tfa.LOG2E)
        kp = torch.arange(a, e, device=q.device)[None, :]
        vis = torch.ones((Sq * rep, e - a), dtype=torch.bool, device=q.device)
        if causal:
            vis &= kp <= pos[:, None]
        if window is not None:
            vis &= kp > pos[:, None] - window
        sc = sc.masked_fill(~vis, float("-inf"))
        m = torch.clamp(sc.amax(-1) if e > a else sc.new_full(sc.shape[:-1], -float("inf")),
                        min=-1e30)
        p = torch.exp2(sc - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhrk,bhkd->bhrd", p, vf))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)   # splits first
    w = torch.exp2(m - m.amax(0))
    L = (w * l).sum(0)
    o = (w[..., None] * acc).sum(0) / torch.where(L > 0, L, 1.0)[..., None]
    o = torch.where((L > 0)[..., None], o, 0.0)
    return o.reshape(B, Hkv, Sq, rep, hd).permute(0, 2, 1, 3, 4).reshape(B, Sq, Hq, hd).to(
        q.dtype)


def _np_qkv(B, Sq, Sk, Hq, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))


@pytest.mark.parametrize("dtype,Sq,Hq,Hkv,want", [
    (torch.bfloat16, 1024, 4, 1, "prefill_tc"),    # gemma3-1b prefill
    (torch.bfloat16, 1, 4, 1, "decode"),           # gemma3-1b decode
    (torch.float32, 1, 4, 1, "decode"),            # the reduced f32 models' decode
    (torch.float32, 12, 4, 1, "prefill_fma"),      # the reduced f32 models' prefill
    (torch.bfloat16, 2, 4, 1, "decode"),           # 8 rows: the most one decode block holds
    (torch.bfloat16, 3, 4, 1, "prefill_tc"),       # 12 rows
    (torch.float32, 9, 1, 1, "prefill_fma"),
    (torch.bfloat16, 1, 16, 1, "prefill_tc"),      # 16 query heads on one kv head
    (torch.bfloat16, 1, 16, 2, "decode"),
])
def test_route_is_a_function_of_dtype_and_shapes(dtype, Sq, Hq, Hkv, want):
    assert tfa.route(dtype, Sq, Hq, Hkv) == want


def _visible(Sq, Sk, causal, window, q_offset):
    """{key: True} for every key some query row sees."""
    keys = set()
    for i in range(Sq):
        p = q_offset + i
        for j in range(Sk):
            if (not causal or j <= p) and (window is None or j > p - window):
                keys.add(j)
    return keys


@pytest.mark.parametrize("B,Sq,Sk,Hkv,causal,window,q_offset", [
    (4, 1, 1280, 1, True, None, 1100),    # gemma3-1b decode, global layer
    (4, 1, 1280, 1, True, 512, 1100),     # local layer
    (1, 1, 5, 1, True, None, 4),          # shorter than one split
    (1, 1, 1000, 1, True, 333, 998),      # edges off any 32-key tile
    (2, 2, 300, 2, True, 100, 250),
    (3, 1, 1, 4, True, None, 0),          # one key
    (1, 1, 64, 1, True, 8, 100),          # the window hides every key
    (2, 1, 77, 8, False, None, 0),        # bidirectional
    (1, 1, 100_000, 1, True, None, 99_999),
])
def test_decode_plan_partitions_the_visible_keys_once(B, Sq, Sk, Hkv, causal, window,
                                                      q_offset):
    plan = tfa.decode_plan(B, Sq, Sk, Hkv, causal=causal, window=window, q_offset=q_offset)
    assert plan.n_splits >= 1 and plan.chunk >= 1
    assert 0 <= plan.k_lo <= plan.k_hi <= Sk
    covered = []
    for s in range(plan.n_splits):
        a = plan.k_lo + s * plan.chunk
        e = min(a + plan.chunk, plan.k_hi)
        assert a < e or plan.k_lo == plan.k_hi, "only an empty range may have an empty split"
        covered.extend(range(a, e))
    assert len(covered) == len(set(covered)), "a key lies in two splits"
    assert set(covered) == set(range(plan.k_lo, plan.k_hi))
    if Sk <= 2000:
        assert _visible(Sq, Sk, causal, window, q_offset) <= set(covered)


@pytest.mark.parametrize("window", [None, 512])
def test_decode_grid_fills_the_card_at_gemma3_decode(window):
    cfg = get_config("gemma3-1b")
    plan = tfa.decode_plan(4, 1, 1280, cfg.num_kv_heads, window=window, q_offset=1100)
    blocks = plan.n_splits * cfg.num_kv_heads * 4
    assert blocks >= tfa.DECODE_MIN_BLOCKS
    assert tfa.route(torch.bfloat16, 1, cfg.num_heads, cfg.num_kv_heads) == "decode"
    assert tfa.route(torch.bfloat16, 1024, cfg.num_heads, cfg.num_kv_heads) == "prefill_tc"


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window,q_offset", [
    (2, 1, 320, 4, 1, 256, True, 64, 300),
    (2, 1, 1280, 4, 1, 64, True, None, 1100),
    (1, 2, 50, 8, 2, 32, True, None, 40),
    (3, 1, 1, 4, 4, 32, True, None, 0),
    (1, 1, 64, 4, 1, 64, True, 8, 100),     # every key hidden: 0
    (1, 1, 40, 8, 8, 32, False, None, 0),
    (3, 1, 77, 4, 2, 64, True, 13, 50),
])
def test_split_merge_model_matches_plain_and_reference(B, Sq, Sk, Hq, Hkv, hd, causal, window,
                                                      q_offset):
    q, k, v = _np_qkv(B, Sq, Sk, Hq, Hkv, hd, seed=Sk)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = split_merge_plain(tq, tk, tv, causal=causal, window=window, q_offset=q_offset)
    plain = tfa.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                      q_offset=q_offset)
    want = np.asarray(ref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal, window=window, q_offset=q_offset))
    assert (got - plain).abs().max().item() <= 2e-5
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    if q_offset == 100:
        assert bool((got == 0).all())


def test_split_merge_model_in_bf16():
    q, k, v = _np_qkv(4, 1, 1280, 4, 1, 256, seed=7)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    for window in (None, 512):
        got = split_merge_plain(tq, tk, tv, window=window, q_offset=1100).float()
        want = tfa.flash_attention_plain(tq, tk, tv, window=window, q_offset=1100).float()
        ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(got.abs(), want.abs()).clamp_min(
            2.0 ** -126))) - 7)
        tol = ulp + 2e-5 * max(1.0, want.abs().max().item())
        assert bool(((got - want).abs() <= tol).all())


def test_cpu_call_takes_the_plain_version_and_counts_no_route():
    q, k, v = (torch.from_numpy(a) for a in _np_qkv(1, 1, 30, 4, 1, 64, seed=3))
    before = (tfa.flash_attention.launches, dict(tfa.flash_attention.launches_by_route))
    got = tfa.flash_attention(q, k, v, q_offset=29)
    assert (tfa.flash_attention.launches, tfa.flash_attention.launches_by_route) == before
    assert torch.equal(got, tfa.flash_attention_plain(q, k, v, q_offset=29))


def test_reset_launches_zeroes_every_route():
    tfa.flash_attention.launches = 5
    tfa.flash_attention.launches_by_route["decode"] = 3
    tfa.reset_launches()
    assert tfa.flash_attention.launches == 0
    assert set(tfa.flash_attention.launches_by_route) == set(tfa.COUNTED)
    assert set(tfa.COUNTED) == set(tfa.ROUTES) | {"decode_combine", "decode_partial",
                                                  "decode_merge"}
    assert not any(tfa.flash_attention.launches_by_route.values())
