"""The last three archs' attention shapes and models on the card, against the
plain versions and the CPU (whose path ``tests/test_torch_whisper.py``,
``test_torch_mamba.py`` and ``test_torch_mrope_ring.py`` hold against the
JAX package).  Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_archs2_cuda.py

Each test skips without a card (the kernels have no CPU mode).
Tolerances: ``flash_attention`` f32 outputs within 2e-5 x max(1, max|plain|),
bf16 within that plus 1 bf16 ulp of the larger side (f32 sums in another
order, each side rounded once), as in ``test_torch_flash_routes_cuda.py``;
reduced f32 models' logits within 1e-4 absolute of the CPU's and greedy
tokens equal (``test_torch_archs_cuda.py``'s bound).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import whisper as W
from repro_torch.models.transformer import forward_lm, init_lm
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_serve_step
from repro_torch.utils.pytree import tree_map


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


def _routed(want_route, q, k, v, **kw):
    assert tfa.route(q.dtype, q.shape[1], q.shape[2], k.shape[2]) == want_route
    before = dict(tfa.flash_attention.launches_by_route)
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    after = tfa.flash_attention.launches_by_route
    assert after[want_route] == before[want_route] + 1
    assert sum(after[r] for r in tfa.ROUTES) == sum(before[r] for r in tfa.ROUTES) + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "prefill_tc"),
                                         (torch.float32, "prefill_fma")])
def test_whisper_encoder_shape_bidirectional(dtype, route):
    """Sq = Sk = 1500 frames, 6 heads on 6 of 64, no mask."""
    dev = _card()
    q, k, v = _qkv(2, 1500, 1500, 6, 6, 64, dtype, dev)
    _close(_routed(route, q, k, v, causal=False),
           tfa.flash_attention_plain(q, k, v, causal=False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq", [4, 1])
def test_whisper_cross_attention_on_the_decode_route(Sq, dtype):
    """A 4-token prompt and one token against 1500 encoder states."""
    dev = _card()
    q, k, v = _qkv(2, Sq, 1500, 6, 6, 64, dtype, dev, seed=Sq)
    _close(_routed("decode", q, k, v, causal=False),
           tfa.flash_attention_plain(q, k, v, causal=False))


@pytest.mark.cuda
@pytest.mark.parametrize("i", [5, 200, 511, 512, 700])
def test_ring_form_over_a_scrambled_ring(i):
    """A decode step at position i over a ring of W = 512 slots in write
    order (slot s holds position i - ((i - s) mod W)): ``causal=True,
    q_offset=min(i, W - 1)`` against the visible keys in position order."""
    dev = _card()
    W = 512
    q, k, v = _qkv(2, 1, W, 4, 1, 256, torch.bfloat16, dev, seed=i)
    order = torch.tensor([p % W for p in range(max(0, i - W + 1), i + 1)], device=dev)
    got = _routed("decode", q, k, v, causal=True, q_offset=min(i, W - 1))
    want = tfa.flash_attention_plain(q, k[:, order].contiguous(), v[:, order].contiguous(),
                                     causal=True, q_offset=len(order) - 1)
    _close(got, want)


def _on_card_and_cpu(run):
    """``run(device)`` on the CPU and on the card: (cpu, cuda) results."""
    dev = _card()
    return run("cpu"), run(dev.type)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "qwen2-vl-72b"])
def test_reduced_arch_served_on_the_card_matches_the_cpu(arch):
    cfg = reduce_config(get_config(arch))
    params = init_lm(cfg, torch.Generator().manual_seed(5), device="cpu")
    prompts = np.random.default_rng(6).integers(3, cfg.vocab_size, (3, 12))

    def run(where):
        p = tree_map(lambda x: x.to(where), params)
        tfa.reset_launches()
        res = Engine(cfg, p, max_len=32).generate(prompts, max_new_tokens=16)
        routes = dict(tfa.flash_attention.launches_by_route)
        with torch.inference_mode():
            lg, _, _ = forward_lm(cfg, p, torch.as_tensor(res.tokens, device=where))
        return res.tokens, lg.cpu(), routes

    cpu, card = _on_card_and_cpu(run)
    np.testing.assert_array_equal(cpu[0], card[0])
    assert (cpu[1] - card[1]).abs().max().item() <= 1e-4
    n = sum(b.mixer == "attn" for b in cfg.blocks)
    assert card[2] == {"prefill_fma": n, "prefill_tc": 0, "decode": n * 15,
                       "decode_combine": n * 15, "decode_partial": 0, "decode_merge": 0}
    assert cpu[2] == dict.fromkeys(card[2], 0)


@pytest.mark.cuda
def test_reduced_whisper_served_on_the_card_matches_the_cpu():
    cfg = reduce_config(get_config("whisper-tiny"))
    params = W.init_whisper(cfg, torch.Generator().manual_seed(5), 32, device="cpu")
    rng = np.random.default_rng(6)
    frames = torch.from_numpy(rng.standard_normal((3, cfg.encoder_seq, cfg.d_model))
                              .astype(np.float32))
    prompts = torch.from_numpy(rng.integers(3, cfg.vocab_size, (3, 4)))

    @torch.inference_mode()
    def run(where):
        p = tree_map(lambda x: x.to(where), params)
        tfa.reset_launches()
        cache = W.prime_cross_cache(cfg, p, W.init_whisper_cache(cfg, 3, 16, device=where),
                                    W.whisper_encode(cfg, p, frames.to(where)))
        serve = make_serve_step(cfg)
        lg, cache = serve(p, cache, prompts.to(where), 0)
        out, logits = [torch.argmax(lg, -1)], [lg]
        for t in range(1, 8):
            lg, cache = serve(p, cache, out[-1][:, None], 3 + t)
            out.append(torch.argmax(lg, -1))
            logits.append(lg)
        return (torch.stack(out, 1).cpu(), torch.stack(logits, 1).cpu(),
                dict(tfa.flash_attention.launches_by_route))

    cpu, card = _on_card_and_cpu(run)
    assert torch.equal(cpu[0], card[0])
    assert (cpu[1] - card[1]).abs().max().item() <= 1e-4
    # the encoder's layers on the f32 prefill route; per decoder layer and
    # call a self- and a cross-attention launch on the decode route
    n = cfg.num_layers
    assert card[2] == {"prefill_fma": cfg.encoder_layers, "prefill_tc": 0, "decode": 2 * n * 8,
                       "decode_combine": 2 * n * 8, "decode_partial": 0, "decode_merge": 0}
    assert cpu[2] == dict.fromkeys(card[2], 0)
