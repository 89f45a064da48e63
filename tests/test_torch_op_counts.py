"""The port's op counter (``utils.op_counts``) and the kernels' cost
formulas, on the CPU: exact FLOPs and bytes of plain products, the trip
multiplier, collectives counted through ``launch.mesh`` and ``wire_bytes``
against ``repro.utils.hlo``'s, each kernel's meta branch against its plain
version (shapes and dtypes, no launch, its ``cost`` booked), the Mamba and
RWKV loops' meta paths against the loops themselves, every ``bound_ms`` of
PERF.md's kernel table from the kernels' ``cost``, and the reduced
mistral-nemo-12b train step of ``tests/test_hlo_flops.py`` counted against
``repro.utils.hlo_flops.analyze_hlo`` on the reference's compiled step.

Tolerances: counts of plain ops are exact; the train step's FLOPs within 2 %
of the reference's HLO count and of the analytic 6·N·D + attention formula
(the ratios print with ``-s``); the meta paths' FLOPs equal the loops'
exactly, their forward bytes too; the bounds equal the table's to its
printed digits."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.models.transformer import init_lm as jinit_lm
from repro.optim.optimizers import constant_lr as jconstant_lr
from repro.optim.optimizers import sgd as jsgd
from repro.train.step import make_train_step as jmake_train_step
from repro.utils import hlo as jhlo
from repro.utils.hlo_flops import analyze_hlo
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import cold_fuse as tcf
from repro_torch.kernels import decode_accum as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import row_sketch as trs
from repro_torch.kernels import rwkv6_scan as trw
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.specs import abstract_params
from repro_torch.models import mamba as TM
from repro_torch.models import rwkv as TR
from repro_torch.models import transformer as TT
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train import make_train_step
from repro_torch.utils import op_counts as OC
from repro_torch.utils import roofline as RL

META = torch.device("meta")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(dtype)


# -- counting ----------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_plain_matmul_flops_and_bytes(device):
    a, b = _rand((64, 128), 0).to(device), _rand((128, 32), 1).to(device)
    with OC.OpCounter() as oc:
        a @ b
    assert oc.flops == 2 * 64 * 128 * 32
    assert oc.hbm_bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert oc.peak_live_bytes == oc.largest_alloc == 64 * 32 * 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_grad_counts_backward(device):
    """fwd x@w + bwd dw = xᵀ δ: exactly 2 products (the input needs no grad);
    the saved tensors are the step's own, not the weight."""
    w = _rand((256, 256), 0).to(device).requires_grad_(True)
    x = _rand((128, 256), 1).to(device)
    with OC.OpCounter() as oc:
        loss = torch.tanh(x @ w).square().sum()
        torch.autograd.grad(loss, [w])
    assert oc.flops == 2 * 2 * 128 * 256 * 256
    assert 0 < oc.saved_bytes <= 3 * 128 * 256 * 4


def test_broadcast_and_views_move_no_extra_bytes():
    x = _rand((8, 1024), 0)
    row = _rand((1024,), 1)
    with OC.OpCounter() as oc:
        y = x + row.expand(8, 1024)        # the broadcast row counts once
        y.view(8, 32, 32).transpose(1, 2)  # views move nothing
    assert oc.hbm_bytes == (8 * 1024 + 1024 + 8 * 1024) * 4


def test_trips_scale_counts():
    a, b = _rand((16, 32), 0), _rand((32, 8), 1)
    with OC.OpCounter() as one:
        a @ b
        OC.add("k", "r", 10, 100)
    with OC.OpCounter() as oc:
        with OC.trips(3):
            a @ b
            OC.add("k", "r", 10, 100)
            with OC.trips(2):
                a @ b
        a @ b
    mm = 2 * 16 * 32 * 8
    assert oc.matmul_flops == (3 + 6 + 1) * mm
    assert oc.op_bytes == 10 * one.op_bytes
    assert oc.entries[("k", "r")] == {"calls": 3, "flops": 30, "bytes": 300}
    assert oc.flops == oc.matmul_flops + 30 and oc.hbm_bytes == oc.op_bytes + 300
    with OC.trips(5):  # no counter: nothing to scale
        a @ b


def test_one_counter_at_a_time():
    with OC.OpCounter():
        with pytest.raises(RuntimeError, match="already active"):
            OC.OpCounter().__enter__()
    assert OC.ACTIVE is None


@pytest.mark.parametrize("stats", [
    {"all-reduce": 1 << 20},
    {"all-reduce": 3000, "all-gather": 5000, "reduce-scatter": 700},
    {"all-to-all": 11, "collective-permute": 13, "all-gather": 17},
])
def test_wire_bytes_matches_reference(stats):
    counts = {k: 1 for k in stats}
    mine = OC.CollectiveStats(dict(stats), dict(counts))
    ref = jhlo.CollectiveStats(dict(stats), dict(counts))
    assert OC.wire_bytes(mine) == jhlo.wire_bytes(ref)
    assert OC.wire_bytes(mine, {"reduce-scatter": 4}) == jhlo.wire_bytes(ref, {"reduce-scatter": 4})
    assert mine.as_dict() == ref.as_dict()


def test_mesh_collectives_are_counted():
    """``launch.mesh``'s collectives reach the counter in the reference's
    kind names, with the bytes launch.mesh counts (a trip multiplies them)."""
    mesh = tmesh.make_mesh((2, 4), ("contrib", "model"), device="cpu")
    parts = [[_rand((64,), g * 4 + s) for s in range(4)] for g in range(2)]
    tmesh.reset_collectives()
    with OC.OpCounter() as oc:
        with OC.trips(2):
            tmesh.all_reduce_over(parts)
        tmesh.all_gather(parts[0], mesh)
    assert oc.collectives.count_by_kind == {"all-reduce": 2, "all-gather": 1}
    assert oc.collectives.bytes_by_kind == {
        "all-reduce": 2 * tmesh.collective_bytes["all_reduce"],
        "all-gather": tmesh.collective_bytes["all_gather"]}
    assert tmesh.collective_bytes["all_reduce"] == 2 * (2 - 1) * 4 * 64 * 4


# -- the kernels' meta branches ----------------------------------------------------------


def _payload(C, nb, kb, seed):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, 1024, (C, nb, kb)).astype(np.int16))
    val = torch.from_numpy(rng.integers(-127, 128, (C, nb, kb)).astype(np.int8))
    scl = torch.from_numpy(rng.random((C, nb)).astype(np.float32))
    return idx, val, scl, torch.ones(C)


def _kernel_cases():
    q, k, v = _rand((2, 16, 4, 32), 0), _rand((2, 24, 2, 32), 1), _rand((2, 24, 2, 32), 2)
    r, kk, vv = (_rand((2, 5, 2, 32), s) for s in (3, 4, 5))
    logw = -torch.exp(_rand((2, 5, 2, 32), 6))
    u, s0 = _rand((2, 32), 7), _rand((2, 2, 32, 32), 8)
    return {
        "cold_fuse": (tcf.cold_fuse, tcf.cold_fuse_plain, tcf.cost, "cold_fuse",
                      (_rand((3000,), 0), _rand((3, 3000), 1), torch.tensor([1.0, 0.0, 2.0])),
                      {"alpha": 0.5}),
        "decode_accum": (tda.decode_accum, tda.decode_accum_plain, tda.cost, "decode_accum",
                         _payload(3, 4, 8, 0), {"size": 4000, "block": 1024}),
        "row_sketch": (trs.row_sketch, trs.row_sketch_plain, trs.cost, "row_sketch",
                       (_rand((5000,), 0, torch.bfloat16), 7), {}),
        "row_sketch_shard": (trs.row_sketch_shard, trs.row_sketch_shard_plain, trs.shard_cost,
                             "row_sketch_shard", (_rand((4096,), 0), 1, 4, 2048), {}),
        "flash_prefill": (tfa.flash_attention, tfa.flash_attention_plain, tfa.cost, "prefill_fma",
                          (q, k, v), {"window": 8, "q_offset": 8}),
        "flash_prefill_bf16": (tfa.flash_attention, tfa.flash_attention_plain, tfa.cost,
                               "prefill_tc", (q.bfloat16(), k.bfloat16(), v.bfloat16()),
                               {"q_offset": 8}),
        "flash_decode": (tfa.flash_attention, tfa.flash_attention_plain, tfa.cost, "decode",
                         (q[:, :1], k, v), {"q_offset": 20}),
        "rwkv6_scan": (trw.rwkv6_scan, trw.rwkv6_scan_plain, trw.cost, "scan",
                       (r, kk, vv, logw, u, s0), {}),
        "rwkv6_step": (trw.rwkv6_scan, trw.rwkv6_scan_plain, trw.cost, "step",
                       (r[:, :1], kk[:, :1], vv[:, :1], logw[:, :1], u, s0), {}),
    }


def _meta(x):
    return x.to(META) if isinstance(x, torch.Tensor) else x


def _launches():
    return (tcf.cold_fuse.launches, tda.decode_accum.launches, trs.row_sketch.launches,
            trs.row_sketch_shard.launches, tfa.flash_attention.launches,
            trw.rwkv6_scan.launches)


@pytest.mark.parametrize("case", sorted(_kernel_cases()))
def test_kernel_meta_branch(case):
    """Each wrapper's meta branch gives its plain version's output shapes
    and dtypes, launches nothing and books its ``cost`` under its route."""
    fn, plain, cost, route, args, kw = _kernel_cases()[case]
    want = plain(*args, **kw)
    before = _launches()
    margs = tuple(_meta(a) for a in args)
    with OC.OpCounter() as oc:
        got = fn(*margs, **kw)
    assert _launches() == before
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(g.device.type, tuple(g.shape), g.dtype) for g in got] == \
        [("meta", tuple(w.shape), w.dtype) for w in want]
    name = fn.__name__
    flops, nbytes = cost(*margs, **kw)
    assert oc.entries[(name, route)] == {"calls": 1, "flops": flops, "bytes": nbytes}
    if route == "decode":
        assert oc.entries[(name, "decode_combine")] == {"calls": 1, "flops": 0, "bytes": 0}


def test_meta_branch_holds_the_kernels_limits():
    q = torch.empty((1, 4, 2, 48), device=META)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    r = torch.empty((1, 2, 2, 32), device=META)
    with pytest.raises(TypeError, match="f32 u and s0"):
        trw.rwkv6_scan(r, r, r, r, torch.empty((2, 32), device=META, dtype=torch.bfloat16),
                       torch.empty((1, 2, 32, 32), device=META))


# -- PERF.md's bounds from the kernels' cost ----------------------------------------------

N_ROBERTA, N_GEMMA = 123_969_792, 999_812_736


def _m(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


def _qkv(B, Sq, Sk, Hq, Hkv, hd, dtype=torch.bfloat16):
    return _m(B, Sq, Hq, hd, dtype=dtype), _m(B, Sk, Hkv, hd, dtype=dtype), \
        _m(B, Sk, Hkv, hd, dtype=dtype)


def _codec(C):
    nb = -(-N_ROBERTA // 1024)
    return (_m(C, nb, 64, dtype=torch.int16), _m(C, nb, 64, dtype=torch.int8),
            _m(C, nb, dtype=torch.float32), _m(C, dtype=torch.float32))


def _rwkv(T):
    a = _m(4, T, 64, 64, dtype=torch.float32)
    return (a, a, a, a, _m(64, 64, dtype=torch.float32), _m(4, 64, 64, 64, dtype=torch.float32))


# (row label, cost, args, kwargs, peak dtype, bound_ms as PERF.md §6 prints it, digits)
PERF_BOUNDS = [
    ("cold_fuse K=5", tcf.cost, (_m(N_ROBERTA), _m(5, N_ROBERTA), _m(5)), {}, None, 0.5181, 4),
    ("cold_fuse K=3 gemma", tcf.cost, (_m(N_GEMMA), _m(3, N_GEMMA), _m(3)), {}, None, 2.9845, 4),
    ("decode_accum C=4", tda.cost, _codec(4), {"size": N_ROBERTA, "block": 1024}, None,
     0.1764, 4),
    ("decode_accum C=64", tda.cost, _codec(64), {"size": N_ROBERTA, "block": 1024}, None,
     0.6013, 4),
    ("row_sketch", trs.cost, (_m(N_ROBERTA), 32), {}, None, 0.0740, 4),
    ("row_sketch_shard", trs.shard_cost, (_m(25_600, dtype=torch.float32), 0, 8, 65_536), {},
     None, 0.00003, 5),
    ("flash prefill global", tfa.cost, _qkv(4, 1024, 1280, 4, 1, 256), {}, torch.bfloat16,
     0.0087, 4),
    ("flash prefill local", tfa.cost, _qkv(4, 1024, 1280, 4, 1, 256), {"window": 512},
     torch.bfloat16, 0.0065, 4),
    ("flash decode global", tfa.cost, _qkv(4, 1, 1280, 4, 1, 256), {"q_offset": 1100},
     torch.bfloat16, 0.0014, 4),
    ("flash decode local", tfa.cost, _qkv(4, 1, 1280, 4, 1, 256),
     {"q_offset": 1100, "window": 512}, torch.bfloat16, 0.0006, 4),
    ("flash hd160 bf16 prefill", tfa.cost, _qkv(4, 256, 272, 32, 8, 160), {}, torch.bfloat16,
     0.0078, 4),
    ("flash hd160 bf16 decode", tfa.cost, _qkv(4, 1, 272, 32, 8, 160), {"q_offset": 256},
     torch.bfloat16, 0.0016, 4),
    ("flash hd160 f32 prefill", tfa.cost, _qkv(4, 256, 272, 32, 8, 160, torch.float32), {},
     torch.float32, 0.0402, 4),
    ("flash hd160 f32 decode", tfa.cost, _qkv(4, 1, 272, 32, 8, 160, torch.float32),
     {"q_offset": 256}, torch.float32, 0.0032, 4),
    ("flash whisper bidirectional", tfa.cost, _qkv(4, 1500, 1500, 6, 6, 64),
     {"causal": False}, torch.bfloat16, 0.0140, 4),
    ("flash whisper cross", tfa.cost, _qkv(4, 1, 1500, 6, 6, 64), {"causal": False},
     torch.bfloat16, 0.0028, 4),
    ("flash qwen2-vl prefill", tfa.cost, _qkv(4, 512, 529, 64, 8, 128), {}, torch.bfloat16,
     0.0225, 4),
    ("flash qwen2-vl decode", tfa.cost, _qkv(4, 1, 529, 64, 8, 128), {"q_offset": 512},
     torch.bfloat16, 0.0025, 4),
    ("rwkv6_scan prefill", trw.cost, _rwkv(256), {}, None, 0.0275, 4),
    ("rwkv6_scan decode", trw.cost, _rwkv(1), {}, None, 0.0026, 4),
]


@pytest.mark.parametrize("label,cost,args,kw,dtype,want,digits", PERF_BOUNDS,
                         ids=[row[0] for row in PERF_BOUNDS])
def test_cost_reproduces_perf_bounds(label, cost, args, kw, dtype, want, digits):
    flops, nbytes = cost(*args, **kw)
    peak = RL.peak_flops(dtype) if dtype is not None else RL.F32_FLOPS
    bound, _ = RL.bound_of(nbytes, flops, peak)
    assert round(bound, digits) == want, (label, bound)


def test_flash_prefill_global_is_8_60_gflop():
    flops, _ = tfa.cost(*_qkv(4, 1024, 1280, 4, 1, 256))
    assert round(flops / 1e9, 2) == 8.60


# -- the loops' meta paths ---------------------------------------------------------------


def _mamba_cfg():
    return reduce_config(get_config("jamba-1.5-large-398b"))


def _loop_counts(fn, inputs, device):
    xs = [x.detach().to(device).requires_grad_(x.is_floating_point()) for x in inputs]
    with OC.OpCounter() as fwd:
        outs = fn(*xs)
    with OC.OpCounter() as both:
        outs = fn(*xs)
        loss = sum(o.float().sum() for o in outs)
        torch.autograd.grad(loss, [x for x in xs if x.requires_grad])
    return fwd, both, outs


@pytest.mark.parametrize("which", ["mamba", "rwkv"])
def test_meta_loop_counts_match_the_loop(which):
    """On the meta device the Mamba scan and the RWKV recurrence skip their
    loops: the same output shapes, the loop's FLOPs forward and backward,
    and its forward bytes, booked by formula."""
    if which == "mamba":
        cfg = _mamba_cfg()
        p = TM.init_mamba(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
        x = _rand((2, 5, cfg.d_model), 0)

        def fn(x, *leaves):
            return (TM.mamba_fwd(cfg, dict(zip(sorted(p), leaves)), x)[0],)
        inputs = [x] + [p[k] for k in sorted(p)]
    else:
        B, T, H, hd = 2, 5, 2, 8
        inputs = [_rand((B, T, H, hd), s) for s in range(3)]
        inputs += [torch.exp(-torch.exp(_rand((B, T, H, hd), 3))), _rand((H, hd), 4),
                   _rand((B, H, hd, hd), 5)]
        fn = TR._recurrence
    f_cpu, b_cpu, o_cpu = _loop_counts(fn, inputs, "cpu")
    f_meta, b_meta, o_meta = _loop_counts(fn, inputs, "meta")
    assert [(tuple(o.shape), o.dtype) for o in o_meta] == [(tuple(o.shape), o.dtype)
                                                            for o in o_cpu]
    assert f_meta.flops == f_cpu.flops and b_meta.flops == b_cpu.flops
    assert f_meta.hbm_bytes == f_cpu.hbm_bytes
    name = "mamba_scan" if which == "mamba" else "rwkv_recurrence"
    assert f_meta.calls(name) == {"forward": 1}
    assert b_meta.calls(name) == {"backward": 1, "forward": 1}


# -- a train step against the reference's HLO count ----------------------------------------


def _mistral():
    jcfg = dataclasses.replace(jreduce_config(jget_config("mistral-nemo-12b")), num_layers=2,
                               remat=False)
    tcfg = dataclasses.replace(reduce_config(get_config("mistral-nemo-12b")), num_layers=2,
                               remat=False)
    return jcfg, tcfg


def _analytic(cfg, B, S):
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    hd, nq, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    n_mat = L * (d * nq * hd + 2 * d * nkv * hd + nq * hd * d + 3 * d * f) + d * v
    attn = L * 2 * B * S * S * nq * hd * 2
    return 6 * n_mat * B * S + 3 * attn


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_flops_match_reference(mb):
    """The reduced mistral-nemo-12b train step of ``tests/test_hlo_flops.py``:
    the port's count on the CPU and on the meta device (one microbatch
    traced under ``trips``) against ``analyze_hlo`` of the reference's
    compiled step and against the analytic count."""
    jcfg, tcfg = _mistral()
    B, S = 4, 64
    jparams = jax.eval_shape(lambda: jinit_lm(jcfg, jax.random.PRNGKey(0)))
    jopt = jsgd(jconstant_lr(0.1))
    jstate = {"params": jparams, "opt": jax.eval_shape(jopt.init, jparams)}
    jbatch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    hlo = jax.jit(jmake_train_step(jcfg, jopt, microbatches=mb)).lower(
        jstate, jbatch).compile().as_text()
    ref = analyze_hlo(hlo).flops

    opt = make_optimizer("sgd", constant_lr(0.1))
    counts = {}
    for device in ("meta", "cpu"):
        params = (abstract_params(tcfg) if device == "meta" else
                  TT.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu"))
        state = {"params": params, "opt": opt.init(params)}
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, tcfg.vocab_size, (B, S)).astype(np.int32)).to(device)
        with OC.OpCounter() as oc:
            make_train_step(tcfg, opt, microbatches=mb)(state, {"tokens": tokens})
        counts[device] = oc.flops
    expect = _analytic(tcfg, B, S)
    print(f"mb={mb}: port/HLO {counts['meta'] / ref:.6f}, port/analytic "
          f"{counts['meta'] / expect:.6f}")
    assert counts["meta"] == counts["cpu"]
    assert counts["meta"] == pytest.approx(ref, rel=0.02)
    assert counts["meta"] == pytest.approx(expect, rel=0.02)
