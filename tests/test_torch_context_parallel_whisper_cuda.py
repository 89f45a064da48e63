"""The encoder-decoder (whisper) at a batch the batch axis does not divide,
on the card: ``flash_decode.cu``'s partials and merge entries without the
causal mask (the cross-attention over each data slot's block of the cross
cache) against their plain versions at the per-slot shapes, in bf16 and
f32; and reduced whisper at B = 1 on (data 2, model 2), one train step and
a greedy run, on the card against the same on the CPU (whose results
``tests/test_torch_context_parallel_whisper.py`` holds against the JAX
package's partitioned jit).  Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_context_parallel_whisper_cuda.py

Each test skips without a card.  Tolerances: the partials' m (log2 units),
l and acc within 2e-5 x max(1, max|plain|) of each (f32 sums in another
order); the merged output in bf16 within 1 bf16 ulp + 2e-5 x max(1,
max|plain|), in f32 within 2e-5 x max(1, max|plain|) (``chip_smoke.py``'s
bounds), against the plain merge and against ``flash_attention_plain``
over every key; the train step's loss and grad_norm within rtol 1e-5 and
its params within rtol / atol 1e-5 (f32, TF32 off); the greedy tokens
equal and the logits within rtol / atol 1e-5; the launches by route
``chip_smoke.cpw_routes``' and the collectives the CPU's."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import whisper as TW
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train.step import make_serve_step, make_train_state, make_train_step
from repro_torch.utils.pytree import tree_leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)
S, P, NEW = 8, 4, 8
MAX_LEN = P + NEW
CFG = reduce_config(get_config("whisper-tiny"))
# label -> (query heads, kv heads, head_dim, frames): a data slot's share on (2, 2)
SHAPES = {"whisper-tiny": (3, 3, 64, 1_500), "reduced whisper-tiny": (2, 1, 32, 16)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the partials and merge entries launch there")
    torch.backends.cuda.matmul.allow_tf32 = False


def _f32_close(got, want):
    assert bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-5 * max(1.0, want.float().abs().max().item()), err


def _bf16_close(got, want):
    g, w = got.float(), want.float()
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(g.abs(), w.abs())
    assert bool(((g - w).abs() <= ulp + 2e-5 * max(1.0, w.abs().max().item())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, P])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("label", sorted(SHAPES))
def test_non_causal_partials_and_merge_at_the_per_slot_shapes(label, dtype, rows):
    """A token's (or the prompt's gathered rows') cross partials over each
    of the two blocks of the cross cache's positions, no mask, one
    ``decode_partial`` launch each; their merge, one ``decode_merge``."""
    _card()
    Hq, Hkv, hd, N = SHAPES[label]
    g = torch.Generator(device="cuda").manual_seed(34)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((1, rows, Hq, hd), (1, N, Hkv, hd), (1, N, Hkv, hd)))
    blk, parts = N // 2, []
    for r in range(2):
        kb, vb = k[:, r * blk:(r + 1) * blk].contiguous(), v[:, r * blk:(r + 1) * blk].contiguous()
        before = dict(tfa.flash_attention.launches_by_route)
        got = tfa.flash_attention_partials(q, kb, vb, causal=False)
        assert tfa.flash_attention.launches_by_route["decode_partial"] == \
            before["decode_partial"] + 1
        want = tfa.flash_attention_partials_plain(q, kb, vb, causal=False)
        assert got.shape == want.shape
        assert not bool((want[..., 0] == tfa.EMPTY_M).any())   # every key visible
        _f32_close(got[..., 0], want[..., 0])
        _f32_close(got[..., 1], want[..., 1])
        _f32_close(got[..., 2:], want[..., 2:])
        parts.append(got)
    part = torch.cat(parts, 2)
    before = dict(tfa.flash_attention.launches_by_route)
    o = tfa.merge_partials(part, rows, dtype)
    assert tfa.flash_attention.launches_by_route["decode_merge"] == before["decode_merge"] + 1
    close = _bf16_close if dtype == torch.bfloat16 else _f32_close
    close(o, tfa.merge_partials_plain(part, rows, dtype))
    close(o, tfa.flash_attention_plain(q, k, v, causal=False))


def _inputs():
    rng = np.random.default_rng(34)
    return (rng.integers(3, CFG.vocab_size, (1, S)),
            rng.standard_normal((1, CFG.encoder_seq, CFG.d_model)).astype(np.float32),
            rng.integers(3, CFG.vocab_size, (1, P)))


def _run(device):
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device=device)
    params = TW.init_whisper(CFG, torch.Generator().manual_seed(0), device="cpu")
    psh = tsh.params_shardings(mesh, params, CFG)
    toks, frames, prompts = _inputs()
    opt = make_optimizer("sgd", constant_lr(0.05), momentum=0.9)
    state = make_train_state(params, opt)
    state = tsh.device_put(state, {"params": psh,
                                   "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)})
    tmesh.reset_collectives()
    state, m = make_train_step(CFG, opt)(state, {"tokens": toks, "frames": frames})
    train = (float(m["loss"]), float(m["grad_norm"]), dict(tmesh.collectives),
             {k: v.cpu() for k, v in tree_leaves_with_path(tsh.gather(state["params"]))})
    placed = tsh.device_put(params, psh)
    dev = torch.device(device)
    tfa.reset_launches()
    tmesh.reset_collectives()
    cache = TW.init_whisper_cache(CFG, 1, MAX_LEN, device=device)
    cache = tsh.device_put(cache, tsh.cache_shardings(mesh, cache, CFG))
    frames = torch.from_numpy(frames).to(dev)
    cache = TW.prime_cross_cache(CFG, placed, cache, TW.whisper_encode(CFG, placed, frames))
    step = make_serve_step(CFG)
    with torch.inference_mode():
        lg, cache = step(placed, cache, torch.as_tensor(prompts, device=dev), 0)
        logits, out = [lg.cpu()], [torch.argmax(lg, -1)]
        for t in range(1, NEW):
            lg, cache = step(placed, cache, out[-1][:, None], P + t - 1)
            logits.append(lg.cpu())
            out.append(torch.argmax(lg, -1))
    served = (torch.stack(out, 1).cpu().numpy(), torch.stack(logits, 1),
              dict(tfa.flash_attention.launches_by_route), dict(tmesh.collectives))
    return train, served


@pytest.mark.cuda
def test_context_parallel_whisper_on_the_card_matches_the_cpu():
    """Reduced whisper-tiny (f32) at B = 1 on (data 2, model 2): its 16
    frames and the cross cache's positions in two chunks of 8, a train step
    at 8 tokens in chunks, the 4-token prompt in two chunks, 8 new
    tokens."""
    _card()
    (loss, gnorm, counts, params), (toks, logits, routes, s_counts) = _run("cuda")
    (loss_c, gnorm_c, counts_c, params_c), (toks_c, logits_c, _, s_counts_c) = _run("cpu")
    np.testing.assert_allclose(loss, loss_c, rtol=1e-5)
    np.testing.assert_allclose(gnorm, gnorm_c, rtol=1e-5)
    for k, v in params_c.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert counts == counts_c and s_counts == s_counts_c
    np.testing.assert_array_equal(toks, toks_c)
    np.testing.assert_allclose(logits.numpy(), logits_c.numpy(), rtol=1e-5, atol=1e-5)
    assert routes == chip_smoke.cpw_routes(CFG, torch.float32, P, NEW, MAX_LEN, 2, 2)
