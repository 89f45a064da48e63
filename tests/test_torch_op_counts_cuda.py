"""The kernels' entries in the op counter on the card: for each kernel (and
route) at a small shape, the entry an ``OpCounter`` records around the
card's launch equals ``cost(...)`` and the entry of the same call traced on
the meta device, and the launch counters move by one; then a reduced
gemma3-1b bf16 prefill and decode step counted on the card and on the meta
device give equal FLOPs and kernel calls by route equal to the card's
launches.  Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_op_counts_cuda.py

Each test skips without a card (the kernels have no CPU mode).  Counts are
exact."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import cold_fuse as tcf
from repro_torch.kernels import decode_accum as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import row_sketch as trs
from repro_torch.kernels import rwkv6_scan as trw
from repro_torch.launch.specs import abstract_params
from repro_torch.models.transformer import forward_lm, init_cache, init_lm
from repro_torch.train.step import make_serve_step
from repro_torch.utils.op_counts import OpCounter


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(dtype)


def _payload(C, nb, kb, seed):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, 1024, (C, nb, kb)).astype(np.int16))
    val = torch.from_numpy(rng.integers(-127, 128, (C, nb, kb)).astype(np.int8))
    scl = torch.from_numpy(rng.random((C, nb)).astype(np.float32))
    return idx, val, scl, torch.ones(C)


def _cases():
    q, k, v = _rand((2, 64, 4, 64), 0), _rand((2, 80, 2, 64), 1), _rand((2, 80, 2, 64), 2)
    r, kk, vv = (_rand((2, 8, 2, 64), s) for s in (3, 4, 5))
    logw = -torch.exp(_rand((2, 8, 2, 64), 6))
    u, s0 = _rand((2, 64), 7), _rand((2, 2, 64, 64), 8)
    return {
        "cold_fuse": (tcf.cold_fuse, tcf.cost, "cold_fuse",
                      (_rand((3000,), 0, torch.bfloat16), _rand((3, 3000), 1, torch.bfloat16),
                       torch.tensor([1.0, 0.0, 2.0])), {"alpha": 0.5}),
        "decode_accum": (tda.decode_accum, tda.cost, "decode_accum", _payload(3, 4, 64, 0),
                         {"size": 4000, "block": 1024}),
        "row_sketch": (trs.row_sketch, trs.cost, "row_sketch",
                       (_rand((5000,), 0, torch.bfloat16), 7), {}),
        "row_sketch_shard": (trs.row_sketch_shard, trs.shard_cost, "row_sketch_shard",
                             (_rand((4096,), 0), 1, 4, 2048), {}),
        "flash_prefill_fma": (tfa.flash_attention, tfa.cost, "prefill_fma", (q, k, v),
                              {"window": 24, "q_offset": 16}),
        "flash_prefill_tc": (tfa.flash_attention, tfa.cost, "prefill_tc",
                             (q.bfloat16(), k.bfloat16(), v.bfloat16()), {"q_offset": 16}),
        "flash_decode": (tfa.flash_attention, tfa.cost, "decode",
                         (q[:, :1].contiguous().bfloat16(), k.bfloat16(), v.bfloat16()),
                         {"q_offset": 70}),
        "rwkv6_scan": (trw.rwkv6_scan, trw.cost, "scan", (r, kk, vv, logw, u, s0), {}),
        "rwkv6_step": (trw.rwkv6_scan, trw.cost, "step",
                       tuple(a[:, :1].contiguous() for a in (r, kk, vv, logw)) + (u, s0), {}),
    }


def _on(x, dev):
    return x.to(dev) if isinstance(x, torch.Tensor) else x


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_cases()))
def test_card_entry_equals_cost_and_meta(case):
    dev = _card()
    fn, cost, route, args, kw = _cases()[case]
    entries = {}
    for where in (dev, torch.device("meta")):
        a = tuple(_on(x, where) for x in args)
        before = fn.launches
        with OpCounter() as oc:
            fn(*a, **kw)
        torch.cuda.synchronize()
        assert fn.launches - before == (1 if where.type == "cuda" else 0)
        entries[where.type] = oc.entries
        flops, nbytes = cost(*a, **kw)
        assert oc.entries[(fn.__name__, route)] == {"calls": 1, "flops": flops, "bytes": nbytes}
    assert entries["cuda"] == entries["meta"]


@pytest.mark.cuda
def test_reduced_gemma_serve_counts_on_card_and_meta():
    dev = _card()
    cfg = dataclasses.replace(reduce_config(get_config("gemma3-1b")), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    B, P, L = 2, 48, 64
    serve = make_serve_step(cfg)

    def counted(params, tokens, device):
        cache = init_cache(cfg, B, L, device=device)
        tfa.reset_launches()
        with OpCounter() as pre:
            logits = forward_lm(cfg, params, tokens, cache=cache, cache_index=0)[0][:, -1]
        launched_pre = {r: n for r, n in tfa.flash_attention.launches_by_route.items() if n}
        tfa.reset_launches()
        with OpCounter() as dec:
            serve(params, cache, torch.argmax(logits, -1)[:, None], P)
        launched_dec = {r: n for r, n in tfa.flash_attention.launches_by_route.items() if n}
        return pre, dec, launched_pre, launched_dec

    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_lm(cfg, gen, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
        card = counted(params, tokens, dev)
        meta = counted(abstract_params(cfg), torch.empty((B, P), dtype=torch.int64,
                                                         device="meta"), "meta")
    n = cfg.num_layers
    assert card[2] == {"prefill_tc": n} and card[3] == {"decode": n, "decode_combine": n}
    assert meta[2] == meta[3] == {}
    for c, m, launched in ((card[0], meta[0], card[2]), (card[1], meta[1], card[3])):
        assert c.flops == m.flops
        assert c.calls("flash_attention") == m.calls("flash_attention") == launched
