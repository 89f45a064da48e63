"""The three routes of the port's ``flash_attention`` on the card, each
against ``flash_attention_plain``.  Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_flash_routes_cuda.py

Each test skips without a card (the kernels have no CPU mode).
Tolerances as in ``test_torch_attention_rwkv_cuda.py``: f32 outputs within
2e-5 x max(1, max|plain|); bf16 outputs within that plus 1 bf16 ulp of the
larger side (f32 sums in another order, each side rounded once).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
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


def _qkv(B, Sq, Sk, Hq, Hkv, hd, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev).to(dtype)
                 for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))


def _run(B, Sq, Sk, Hq, Hkv, hd, dtype, causal, window, q_offset, want_route):
    dev = _card()
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, hd, dtype, dev)
    assert tfa.route(dtype, Sq, Hq, Hkv) == want_route
    before = dict(tfa.flash_attention.launches_by_route)
    got = tfa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    after = tfa.flash_attention.launches_by_route
    assert after[want_route] == before[want_route] + 1
    assert sum(after[r] for r in tfa.ROUTES) == sum(before[r] for r in tfa.ROUTES) + 1
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    _close(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window,q_offset", [
    (2, 100, 173, 4, 1, 256, True, None, 0),    # ragged, global
    (2, 130, 300, 4, 1, 256, True, 64, 40),     # windowed, q_offset
    (1, 77, 133, 8, 2, 128, True, None, 56),    # GQA 4
    (2, 65, 65, 4, 4, 64, False, None, 0),      # bidirectional
    (1, 90, 97, 2, 1, 32, True, 17, 7),         # hd 32 (padded to 64 in shared memory)
    (1, 64, 1280, 4, 1, 256, True, None, 1000),  # chunked prefill deep in the cache
    (1, 40, 64, 4, 1, 64, True, 8, 66),         # rows 6.. see no key
])
def test_prefill_tc_matches_plain(B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset):
    got = _run(B, Sq, Sk, Hq, Hkv, hd, torch.bfloat16, causal, window, q_offset, "prefill_tc")
    if q_offset == 66:
        assert bool((got[:, 6:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_decode_matches_plain_across_gqa(rep):
    _run(2, 1, 700, rep, 1, 256, torch.bfloat16, True, None, 650, "decode")
    _run(1, 1, 300, 2 * rep, 2, 64, torch.bfloat16, True, 100, 299, "decode")


@pytest.mark.cuda
@pytest.mark.parametrize("Sk,q_offset,window", [
    (5, 4, None),        # Sk smaller than one split
    (1000, 998, 333),    # split edges off any 32-key tile (chunk 8, k_lo 666)
    (411, 410, None),    # 51 splits of 8 keys and one of 3
])
def test_decode_split_edges(Sk, q_offset, window):
    plan = tfa.decode_plan(1, 1, Sk, 1, window=window, q_offset=q_offset)
    assert plan.n_splits >= 1
    _run(1, 1, Sk, 4, 1, 128, torch.bfloat16, True, window, q_offset, "decode")


@pytest.mark.cuda
def test_decode_window_hides_every_key_gives_exact_zero():
    got = _run(2, 1, 64, 4, 1, 64, torch.bfloat16, True, 8, 100, "decode")
    assert bool((got == 0).all())


@pytest.mark.cuda
def test_decode_first_position():
    _run(3, 1, 1, 4, 1, 256, torch.bfloat16, True, None, 0, "decode")


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_decode_f32(hd):
    _run(2, 1, 200, 4, 2, hd, torch.float32, True, None, 150, "decode")
    _run(1, 2, 90, 4, 1, hd, torch.float32, True, 16, 80, "decode")    # 8 rows: 2 tokens x 4


@pytest.mark.cuda
def test_f32_prefill_keeps_the_fma_route():
    _run(1, 33, 40, 4, 1, 64, torch.float32, True, 8, 7, "prefill_fma")


@pytest.mark.cuda
def test_decode_combine_is_counted_on_its_own():
    dev = _card()
    q, k, v = _qkv(1, 1, 50, 4, 1, 64, torch.bfloat16, dev)
    tfa.reset_launches()
    tfa.flash_attention(q, k, v, q_offset=49)
    assert tfa.flash_attention.launches == 1
    assert tfa.flash_attention.launches_by_route == {"decode": 1, "prefill_tc": 0,
                                                     "prefill_fma": 0, "decode_combine": 1,
                                                     "decode_partial": 0, "decode_merge": 0}


# head_dim 160 (stablelm-12b): prefill_tc pads it to 192 columns in shared
# memory, decode reads a key row as 16 lanes x 5 loads of 2 elements
@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal,window,q_offset", [
    (4, 256, 272, 32, 8, True, None, 0),      # stablelm-12b's prefill shape
    (2, 77, 133, 8, 2, True, None, 56),       # ragged, GQA 4
    (1, 90, 130, 4, 1, True, 17, 30),         # windowed, q_offset
    (2, 65, 65, 4, 4, False, None, 0),        # bidirectional
    (1, 40, 64, 4, 1, True, 8, 66),           # rows 6.. see no key
])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "prefill_tc"),
                                         (torch.float32, "prefill_fma")])
def test_hd160_prefill_matches_plain(B, Sq, Sk, Hq, Hkv, causal, window, q_offset, dtype,
                                     route):
    got = _run(B, Sq, Sk, Hq, Hkv, 160, dtype, causal, window, q_offset, route)
    if q_offset == 66:
        assert bool((got[:, 6:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,window,q_offset", [
    (4, 1, 272, 32, 8, None, 256),            # stablelm-12b's decode step
    (2, 1, 700, 8, 1, None, 650),             # 8 rows on one kv head
    (1, 2, 90, 4, 1, 16, 80),                 # 2 tokens x 4 rows
    (1, 1, 1000, 2, 2, 333, 998),             # split edges off any tile
    (2, 1, 64, 4, 1, 8, 100),                 # sees no key
])
def test_hd160_decode_matches_plain(B, Sq, Sk, Hq, Hkv, window, q_offset, dtype):
    got = _run(B, Sq, Sk, Hq, Hkv, 160, dtype, True, window, q_offset, "decode")
    if q_offset == 100:
        assert bool((got == 0).all())
