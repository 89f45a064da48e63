"""Partitioned serving on the card against the same serving on the CPU
(whose results ``tests/test_torch_partitioned_serve.py`` holds against the
JAX package's partitioned jit), and each kernel at the per-slot shapes of
``chip_smoke.py``'s phase 19 against its plain version.  The models are
that file's reduced cuts in f32 on a (data 2, model 2) grid: gemma3-1b (3
layers, window 8, the ring cache on; its one KV head puts the cache's
head_dim on ``model``), mistral-nemo-12b and rwkv6-7b with ``fsdp=True``.
On one card every slot is ``cuda:0``.  Imports neither JAX nor the JAX
package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_partitioned_serve_cuda.py

Each test skips without a card.  Tolerances: the greedy tokens equal; the
last-position logits after the prefill and each decode step within rtol
1e-5 / atol 1e-5 (f32, TF32 off: the kernels sum in another order than the
plain versions); each slot launches each kernel once a layer and step, on
the route its own heads take; the collectives equal the CPU's.  The
per-slot kernel calls in bf16 within 1 bf16 ulp + 2e-5 x max(1, max|plain|),
in f32 within 2e-5 x max(1, max|plain|) (``chip_smoke.py``'s bounds)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rwkv6_scan as trs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import Engine
from repro_torch.utils.placed import Placed

B, P, NEW, WINDOW = 4, 6, 8, 8
MAX_LEN = P + WINDOW


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the partitioned serve places its blocks there")
    torch.backends.cuda.matmul.allow_tf32 = False


def _cfg(arch):
    cfg = reduce_config(get_config(arch), d_model=128)
    if arch == "gemma3-1b":
        local = dataclasses.replace(cfg.pattern[0], window=WINDOW)
        return dataclasses.replace(cfg, num_layers=3, pattern=(local, cfg.pattern[-1]))
    return dataclasses.replace(cfg, num_layers=2, fsdp=True)


def _run(device, arch):
    cfg = _cfg(arch)
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device=device)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    placed = tsh.device_put(params, tsh.params_shardings(mesh, params, cfg))
    assert isinstance(placed["embed"], Placed)
    assert placed["embed"].device.type == torch.device(device).type
    prompts = np.random.default_rng(28).integers(3, cfg.vocab_size, (B, P))
    eng = Engine(cfg, placed, max_len=MAX_LEN)
    tfa.reset_launches()
    trs.reset_launches()
    tmesh.reset_collectives()
    res = eng.generate(prompts, max_new_tokens=NEW)
    routes = (dict(tfa.flash_attention.launches_by_route),
              dict(trs.rwkv6_scan.launches_by_route))
    counts = dict(tmesh.collectives)
    toks, cache = eng._start(placed, prompts)
    logits = []
    with torch.inference_mode():
        lg, cache = eng._prefill(placed, toks, cache)
        logits.append(lg.cpu())
        for t in range(1, NEW):
            lg, cache = eng._serve(placed, cache, res.tokens[:, P + t - 1:P + t], P + t - 1)
            logits.append(lg.cpu())
    return cfg, res.tokens, torch.stack(logits, 1), routes, counts


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "mistral-nemo-12b", "rwkv6-7b"])
def test_partitioned_generate_on_the_card_matches_the_cpu(arch, monkeypatch):
    _card()
    monkeypatch.setattr(TT, "RING_CACHE", True)
    cfg, g_toks, g_logits, routes, g_counts = _run("cuda", arch)
    _, c_toks, c_logits, _, c_counts = _run("cpu", arch)
    np.testing.assert_array_equal(g_toks, c_toks)
    np.testing.assert_allclose(g_logits.numpy(), c_logits.numpy(), rtol=1e-5, atol=1e-5)
    assert g_counts == c_counts and g_counts["all_gather"] > 0
    slots, n_attn = 4, sum(b.mixer == "attn" for b in cfg.blocks)
    n_rwkv = sum(b.mixer == "rwkv" for b in cfg.blocks)
    # every slot's query heads read one kv head two at a time: f32 prefill
    # rows 2 P > 8 take prefill_fma, a decode step's 2 rows the decode route
    flash = dict.fromkeys(tfa.COUNTED, 0)
    flash["prefill_fma"] = slots * n_attn
    flash["decode"] = flash["decode_combine"] = slots * n_attn * (NEW - 1)
    assert routes == (flash, {"scan": slots * n_rwkv, "step": slots * n_rwkv * (NEW - 1)})


def _bf16_close(got, want):
    g, w = got.float(), want.float()
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(g.abs(), w.abs())
    assert bool(((g - w).abs() <= ulp + 2e-5 * max(1.0, w.abs().max().item())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("Hq, Hkv, hd, Sq, Sk, window", [
    (16, 4, 128, 256, 272, None),    # mistral-nemo-12b's slot on model 2
    (2, 1, 256, 1024, 1280, 512),    # gemma3-1b's slot: 2 query heads on its one kv head
    (2, 1, 256, 1024, 1280, None),
])
def test_flash_attention_at_the_per_slot_shapes(Hq, Hkv, hd, Sq, Sk, window):
    """bf16 prefill on ``prefill_tc`` and a decode step on ``decode``, B = 2,
    against ``flash_attention_plain``."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
               for shape in ((2, Sq, Hq, hd), (2, Sk, Hkv, hd), (2, Sk, Hkv, hd)))
    for qq, off, route in ((q, 0, "prefill_tc"), (q[:, :1].contiguous(), Sk - 1, "decode")):
        assert tfa.route(torch.bfloat16, qq.shape[1], Hq, Hkv) == route
        got = tfa.flash_attention(qq, k, v, window=window, q_offset=off)
        _bf16_close(got, tfa.flash_attention_plain(qq, k, v, window=window, q_offset=off))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [256, 1])
def test_rwkv6_scan_at_the_per_slot_shape(T):
    """rwkv6-7b's slot on model 2: 32 heads of 64, B = 2, f32, on the
    ``scan`` route (T > 1) and the ``step`` route (T = 1)."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(19)
    r, k, v = (torch.randn((2, T, 32, 64), generator=g, device="cuda") for _ in range(3))
    logw = -torch.exp(-6.0 + 9.0 * torch.rand((2, T, 32, 64), generator=g, device="cuda"))
    u = 0.5 * torch.randn((32, 64), generator=g, device="cuda")
    s0 = 0.3 * torch.randn((2, 32, 64, 64), generator=g, device="cuda")
    before = dict(trs.rwkv6_scan.launches_by_route)
    y, s = trs.rwkv6_scan(r, k, v, logw, u, s0)
    assert trs.rwkv6_scan.launches_by_route[trs.route(T)] == before[trs.route(T)] + 1
    yp, sp = trs.rwkv6_scan_plain(r, k, v, logw, u, s0)
    for got, want in ((y, yp), (s, sp)):
        assert (got - want).abs().max().item() <= 2e-5 * max(1.0, want.abs().max().item())
