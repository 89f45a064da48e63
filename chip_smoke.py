#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases (any failed check raises, so the script exits non-zero):

1. the card: name, count, and ``nvidia-smi``'s name and power limit;
2. build every kernel from ``src/repro_torch/kernels/csrc`` (``cold_fuse``,
   ``decode_accum``, ``row_sketch``, the three routes of ``flash_attention``
   — ``flash_prefill`` on the tensor cores for bf16, ``flash_decode``
   split-K for decode shapes, ``flash_attention`` FMA loops for f32
   prefill — and the two routes of ``rwkv6_scan``, ``rwkv6_scan`` for
   T > 1 and ``rwkv6_step`` for T = 1: one ``nvcc`` each, all started
   together; time, and ptxas' registers and spills per kernel);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and on ragged shapes: ``cold_fuse`` at K=5 x
   N=123,969,792 bf16 (one NaN row of weight 0, alpha 1.0 and 0.3);
   ``decode_accum`` at the service shape (C=4 compressed RoBERTa-base
   deltas, block 1024, kb 64, plus a NaN-scale row of weight 0, with
   random offsets where slot 1 repeats slot 0 and with a top-k's offsets
   as the codec writes them; called twice, the two results must be
   bit-identical), at C=64 (the service's ``max_cohort``) at the same
   shape, at block 32768, at a ragged size and at C=1; ``row_sketch`` of the
   bf16 body with 32 buckets, of 1,000,003 f32 with 7 and of 100 elements;
   ``flash_attention`` at gemma3-1b's prefill shape (B=4, Sq=1024,
   Sk=1280, 4 query heads on 1 kv head, hd 256, bf16, window 512 and
   none), at decode (Sq=1, q_offset 1100, bf16 and f32), in f32 at hd
   32-256 with ragged lengths, bf16 prefill at hd 64 and 128, and with
   rows that see no key, each call checked to take its route; ``rwkv6_scan`` at
   rwkv6-7b's prefill shape (B=4, T=256, H=64, hd=64, f32, logw down to
   -20), with the state chained across two calls, at the decode shape
   (T=1), as 32 chained T=1 calls against one plain call of T=32, with
   bf16 inputs and at hd 32, each call checked to take its route;
4. kernel and plain-version times (CUDA events, five windows after a
   warm-up, the median printed) beside each kernel's bound, and for
   ``flash_attention`` the route and the time of
   ``scaled_dot_product_attention`` on the same inputs and mask; both
   again replayed from a CUDA graph, which leaves out the host's work per
   call (the device time); ``rwkv6_scan`` likewise per route, with its
   wrapper's host time per call; ``decode_accum`` at C=4 and C=64, on
   both payload kinds, eager and from a CUDA graph, beside
   ``torch.zeros`` of its f32 accumulator (the write floor);
5. small-input checks: the same screen + fuse (the flat engine, and the
   per-leaf engine's ``fisher`` and ``ties`` repositories over a TINY f32
   body), the same small queue drained by the contributor service, and
   reduced f32 gemma3 and rwkv6 models serving the same prompts, on the
   card and on the CPU (whose paths the CPU tests hold against the JAX
   package) must agree;
6. the ColD Fusion training path (slices 1 and 4), through the entry points
   a user calls, at RoBERTa-base's full width: ``pretrain_mlm`` (20 steps of
   batch 32 x 128 tokens at lr 5e-4 from a body drawn from seed 0, after
   the same at 2e-3 and 1e-3 for their losses only; every loss finite)
   gives theta_0; a Repository over theta_0 runs two iterations of 4
   contributors x 3 finetune steps, an adversarial cohort (3 honest, one
   NaN, one runaway upload) that must fuse 3/5, and a frozen-probe
   evaluation; ``train_multitask`` takes 8 steps over the 4 tasks (body and
   heads finite); 4 ``Contributor(with_fisher=True)`` fuse 4/4 into a
   ``Repository(fusion_op="fisher")`` and 4 contributors 4/4 into a
   ``Repository(fusion_op="ties", density 0.2)``, both finite.  The
   pretrain, multitask and finetune steps, each ``compute_fisher`` call and
   each per-leaf fuse are timed (host clock, synchronised).  After the
   counts are read: the same cohort with all-ones Fishers must equal
   ``average``'s ``cold_fuse`` within 1 bf16 ulp, and ``ties`` on the CPU
   must give the card's result within 1 bf16 ulp on ``embed`` and two other
   leaves, with the same number of kept elements per contributor; the
   ``ties`` threshold (``topk``) is timed on ``embed`` beside ``kthvalue``;
7. the contributor service loop (slice 2) at the same width, in a
   temporary root: ``Repository(root, spill=True)`` behind a
   ``ColdService`` with the novelty screen on; round 1 takes 2 dense
   submissions (one without a rider sketch, so the service sketches it on
   the card), 2 compressed ones and a byte-identical replay that must be
   rejected; round 2 an all-dense cohort; round 3 three honest compressed
   submissions and a runaway one that must fuse 3/4.  Round 1's published
   base is held against ``cold_fuse_plain`` over the host-decoded rows;
8. the serving path (slice 3), for gemma3-1b (26 layers, d 1152, vocab
   262,144) and then rwkv6-7b (32 layers, d 4096), both at full width in
   bf16 with random weights from seed 0: ``launch.serve.main`` serves 4
   prompts (1024 tokens for gemma3, 256 for rwkv6) x 32 new tokens, then
   ``Engine.generate`` the same on its own model (gemma3's cache 1280
   long, so its 512-token window bites in prefill and decode); prefill and
   decode are timed, and the launches are counted per route (gemma3:
   prefill on the tensor-core route, decode on the split-K route; rwkv6:
   prefill on the scan route, decode on the step route); one
   prefill and 8 decode steps run under ``torch.profiler`` for the
   kernels' device time against the wall time (the device's idle share); then
   both models run teacher-forced on the kernel
   path's tokens once more and once with the kernels' plain versions, and
   the logits and greedy tokens are compared.

Before each of phases 6 and 7, and before each model of phase 8, every
kernel's launch counter is set to 0; it is read just after.  The last lines
are the kernels' JSON record (launches from phase 7 for the three fuse
kernels, from phase 8 for the other two), ``nvidia-smi``'s line and
``{"ok": true, "device": {...}}``.  Without a card (or without the rest of
the repository beside it) the script exits non-zero and prints no result.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import CONFIG, TINY, get_config, reduce_config  # noqa: E402
from repro_torch.core import (Contributor, EvalTask, Repository,  # noqa: E402
                              evaluate_base_model, fusion, run_cold_fusion)
from repro_torch.data.synthetic import SyntheticSuite  # noqa: E402
from repro_torch.checkpoint import io as ckpt  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels.cold_fuse import cold_fuse, cold_fuse_plain  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.decode_accum import decode_accum, decode_accum_plain  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_plain)
from repro_torch.kernels.row_sketch import row_sketch, row_sketch_plain  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs_mod  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import rwkv as rwkv_mod  # noqa: E402
from repro_torch.models.encoder import init_encoder_body  # noqa: E402
from repro_torch.models.transformer import forward_lm, init_cache, init_lm  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train import finetune as FT  # noqa: E402
from repro_torch.train import pretrain as pretrain_mod  # noqa: E402
from repro_torch.train import pretrain_mlm, train_multitask  # noqa: E402
from repro_torch.train.step import make_serve_step  # noqa: E402
from repro_torch.serve.cold_service import (AdmissionPolicy, ColdService,  # noqa: E402
                                            ContributorClient)
from repro_torch.utils.flat import (LANE, CohortSketch, FlatSpec, delta_decode,  # noqa: E402
                                    delta_encode)
from repro_torch.utils.pytree import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
N_ROBERTA = 123_969_792     # elements of the RoBERTa-base body (FlatSpec.size)
K_MAIN = 5
# the training path at full width (phase 6): batch x sequence of every step
SEQ_MAIN, BATCH_MAIN = 128, 32
PRETRAIN_STEPS, MULTITASK_STEPS = 20, 8
# theta_0's lr, not the reference's 2e-3: in bf16 at this width the loss
# rises after the warmup at 2e-3 and at 1e-3; phase 6 runs both (printed,
# not used) beside it, so every run shows why
PRETRAIN_LR = 5e-4
PRETRAIN_LR_REJECTED = (2e-3, 1e-3)
TIES_DENSITY = 0.2
# the leaves whose ties result the CPU recomputes (embed is the largest)
TIES_LEAVES = ("embed", "layers/layer0/attn/wq", "layers/layer11/mlp/w_down")
# the CUDA sources: flash_attention's three routes live in three files
SOURCES = ("cold_fuse", "decode_accum", "row_sketch", "flash_prefill", "flash_decode",
           "flash_attention", "rwkv6_scan", "rwkv6_step")
FLASH_SOURCE = {"prefill_tc": "flash_prefill", "decode": "flash_decode",
                "prefill_fma": "flash_attention"}
RWKV_SOURCE = {"scan": "rwkv6_scan", "step": "rwkv6_step"}
CODEC_BLOCK, CODEC_KB = 1024, 64   # the service's default delta codec
C_SERVICE = 4
C_MAX_COHORT = 64                  # AdmissionPolicy's default max_cohort
# novelty threshold of the service phases: a replay scores 0; three Adam
# steps from a random-init body move nearly every element by about lr, a
# shared isotropic growth that shrinks the relative distance of distinct
# contributions (docs/service_loop.md puts random-like finetunes near
# 0.03; this script's run on an H100 printed 0.056 for the nearest distinct
# pair), so the screen is set at the documented safe floor, not at 0.1
NOVELTY = 0.01
GEMMA = get_config("gemma3-1b")
RWKV = get_config("rwkv6-7b")
GEMMA_WINDOW = GEMMA.pattern[0].window  # the local layers' 512
# relative nudge of the plain attention / recurrence output in the serving
# comparison: about the f32 difference between kernel and plain that the
# "[check] flash_attention ... f32" lines show on an H100 (6e-7 at unit scale)
NUDGE = 1e-6
# the serving phases: 4 prompts of 1024 (gemma3) or 256 (rwkv6) tokens, 32
# new tokens; flash_attention's prefill kernel shape is (B, Sq, Sk, Hq, Hkv,
# hd) with Sk the Engine's max_len, rwkv6_scan's (B, T, H, hd)
SERVE_NEW = 32
GEMMA_PROMPT, GEMMA_MAX_LEN = 1024, 1280
RWKV_PROMPT, RWKV_MAX_LEN = 256, 256 + SERVE_NEW
FLASH_PREFILL = (4, GEMMA_PROMPT, GEMMA_MAX_LEN, GEMMA.num_heads, GEMMA.num_kv_heads,
                 GEMMA.head_dim)
RWKV_PREFILL = (4, RWKV_PROMPT, RWKV.d_model // RWKV.ssm.head_dim, RWKV.ssm.head_dim)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str):
    """One line per compiled kernel: registers and spill bytes."""
    name, out = None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), "spills not reported"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spills}")
            name = None
    return out


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


def fused_error(got, want) -> float:
    """max |got - want|, checked against 1 bf16 ulp (bf16) or 2e-5 (f32)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    check(bool(torch.isfinite(g).all()), "kernel's fused output is not finite")
    if got.dtype == torch.bfloat16:
        ok = bool((err <= bf16_ulp(torch.maximum(g.abs(), w.abs()))).all())
        check(ok, f"fused differs by more than 1 bf16 ulp (max |d| {err.max().item():.3g})")
    else:
        check(err.max().item() <= 2e-5, f"fused max |d| {err.max().item():.3g} > 2e-5")
    return err.max().item()


def sq_error(got, want) -> float:
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    check(bool(torch.equal(nan_g, nan_w)), "sq_diff NaN pattern differs")
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30))[~nan_w]
    worst = rel.max().item() if rel.numel() else 0.0
    check(worst <= 1e-3, f"sq_diff relative error {worst:.3g} > 1e-3")
    return worst


def fuse_inputs(K, N, dtype, gen, nan_row=None):
    dev = torch.device("cuda")
    base = 0.05 * torch.randn(N, generator=gen, device=dev)
    contribs = torch.empty((K, N), dtype=dtype, device=dev)
    for k in range(K):
        contribs[k] = base + 1e-3 * torch.randn(N, generator=gen, device=dev)
    w = torch.rand(K, generator=gen, device=dev) + 0.5
    if nan_row is not None:
        contribs[nan_row] = float("nan")
        w[nan_row] = 0.0
    return base.to(dtype), contribs, w


def reset_launches():
    for fn in (cold_fuse, decode_accum, row_sketch):
        fn.launches = 0
    fa_mod.reset_launches()
    rs_mod.reset_launches()


def launches():
    return {"cold_fuse": cold_fuse.launches, "decode_accum": decode_accum.launches,
            "row_sketch": row_sketch.launches, "flash_attention": flash_attention.launches,
            "rwkv6_scan": rwkv6_scan.launches}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel_checks(gen):
    """cold_fuse against cold_fuse_plain on the card.  Returns the main
    shape's inputs and the largest fused error there."""
    print(f"[check] cold_fuse vs plain, K={K_MAIN} N={N_ROBERTA} bf16, row 3 NaN with weight 0")
    base, contribs, w = fuse_inputs(K_MAIN, N_ROBERTA, torch.bfloat16, gen, nan_row=3)
    worst = 0.0
    for alpha in (1.0, 0.3):
        fk, sk = cold_fuse(base, contribs, w, alpha)
        fp, sp = cold_fuse_plain(base, contribs, w, alpha)
        e, r = fused_error(fk, fp), sq_error(sk, sp)
        worst = max(worst, e)
        print(f"  alpha={alpha}: fused max|d| {e:.3g} (bound 1 bf16 ulp), "
              f"sq max rel err {r:.3g} (bound 1e-3), sq[3]={sk[3].item()}")
        del fp, sp
    for dtype, K, N in ((torch.float32, 3, 10_000_019), (torch.float32, 3, 10_000_020),
                        (torch.bfloat16, 3, 1_000_003)):
        b, c, ww = fuse_inputs(K, N, dtype, gen, nan_row=1)
        fk, sk = cold_fuse(b, c, ww, 0.3)
        fp, sp = cold_fuse_plain(b, c, ww, 0.3)
        e, r = fused_error(fk, fp), sq_error(sk, sp)
        print(f"  ragged {str(dtype).removeprefix('torch.')} K={K} N={N}: fused max|d| {e:.3g} "
              f"(bound {'2e-5' if dtype == torch.float32 else '1 bf16 ulp'}), sq max rel err {r:.3g}")
    return (base, contribs, w), worst


def phase_timing(inputs, card):
    base, contribs, w = inputs
    K, N = contribs.shape
    s = base.element_size()
    nbytes = (K + 1) * N * s + N * s + 2 * K * 4
    flops = 4 * K * N + 3 * N  # per row and element: sub, fma (sq), select, fma (avg)
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound = max(bound_bytes, bound_ops)
    # five timing windows each; the median is reported, all are printed
    runs = [time_ms(lambda: cold_fuse(base, contribs, w, 1.0), iters=20) for _ in range(5)]
    plain_runs = [time_ms(lambda: cold_fuse_plain(base, contribs, w, 1.0), iters=3, warmup=1)
                  for _ in range(5)]
    ms, plain = sorted(runs)[2], sorted(plain_runs)[2]
    print(f"[time] cold_fuse K={K} N={N} bf16 on {card}: kernel_ms {ms:.4f} "
          f"(windows {[round(r, 4) for r in runs]}), bound_ms {bound:.4f} "
          f"({nbytes / 1e9:.3f} GB at 3.35 TB/s), kernel/bound {ms / bound:.2f}x, "
          f"plain_ms {plain:.4f} (windows {[round(r, 3) for r in plain_runs]})")
    print("[time] library_ms: none — no single PyTorch call computes both fused and sq_diff")
    return ms, plain, bound, "bytes" if bound_bytes >= bound_ops else "operations"


def phase_small_agreement():
    """The card's screen + fuse against the CPU path at a small size."""
    gen = torch.Generator().manual_seed(1)
    body = init_encoder_body(TINY, gen, device="cpu")
    noise = torch.Generator().manual_seed(2)
    uploads = [tree_map(lambda x: x + 0.01 * torch.randn(x.shape, generator=noise), body)
               for _ in range(3)]
    uploads.append(tree_map(lambda x: torch.full_like(x, float("nan")), body))
    bases, recs = [], []
    for dev in ("cpu", "cuda"):
        repo = Repository(tree_map(lambda x: x.to(dev), body))
        for u in uploads:
            repo.upload(tree_map(lambda x: x.to(dev), u))
        recs.append(repo.fuse_pending())
        bases.append(FlatSpec.from_tree(repo.download()).flatten(repo.download()).cpu())
    d = (bases[0] - bases[1]).abs().max().item()
    check(recs[0].n_accepted == recs[1].n_accepted == 3, "small cohort: 3/4 must fuse")
    check(d <= 1e-5, f"card and CPU published bases differ by {d:.3g} > 1e-5")
    print(f"[small] TINY f32 cohort of 4 (one NaN): card vs CPU published base max|d| {d:.3g} "
          f"(bound 1e-5), fused {recs[1].n_accepted}/{recs[1].n_contributions} on both")


def phase_small_per_leaf():
    """The per-leaf engine's fisher and ties repositories, card against CPU,
    on the same TINY f32 cohort (3 noisy uploads and a NaN one)."""
    gen = torch.Generator().manual_seed(3)
    body = init_encoder_body(TINY, gen, device="cpu")
    noise = torch.Generator().manual_seed(4)
    uploads = [tree_map(lambda x: x + 0.01 * torch.randn(x.shape, generator=noise), body)
               for _ in range(3)]
    uploads.append(tree_map(lambda x: torch.full_like(x, float("nan")), body))
    fishers = [tree_map(lambda x: torch.rand(x.shape, generator=noise), body) for _ in uploads]
    for op, kw in (("fisher", {}), ("ties", {"density": TIES_DENSITY})):
        bases, recs = [], []
        for dev in ("cpu", "cuda"):
            on = lambda t: tree_map(lambda x: x.to(dev), t)
            repo = Repository(on(body), fusion_op=op, fusion_kwargs=kw)
            check(not repo.use_flat, f"{op} must take the per-leaf engine")
            for u, f in zip(uploads, fishers):
                repo.upload(on(u), on(f))
            recs.append(repo.fuse_pending())
            bases.append(repo.flat_base_host())
        d = (bases[0] - bases[1]).abs().max().item()
        check(recs[0].n_accepted == recs[1].n_accepted == 3, f"small {op}: 3/4 must fuse")
        check(d <= 1e-5, f"small {op}: card and CPU published bases differ by {d:.3g} > 1e-5")
        print(f"[small] TINY f32 {op} repository, cohort of 4 (one NaN): card vs CPU published "
              f"base max|d| {d:.3g} (bound 1e-5), fused {recs[1].n_accepted}/"
              f"{recs[1].n_contributions} on both")


@contextlib.contextmanager
def timed(module, name):
    """Time every call of ``module.name`` on the host clock, synchronised
    on both sides, into the yielded list (seconds); restored on exit."""
    fn, seconds = getattr(module, name), []

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    setattr(module, name, wrapper)
    try:
        yield seconds
    finally:
        setattr(module, name, fn)


def median_ms(seconds) -> str:
    return (f"median {1e3 * float(np.median(seconds)):.1f} ms over {len(seconds)} "
            f"(min {1e3 * min(seconds):.1f}, max {1e3 * max(seconds):.1f})")


def all_finite(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree))


def main_contributors(suite, tids, **kw):
    out = []
    for tid in tids:
        d = suite.dataset(tid, 128, 32, SEQ_MAIN)
        out.append(Contributor(CONFIG, tid, suite.tasks[tid].num_classes, d["x_train"],
                               d["y_train"], steps=3, batch_size=BATCH_MAIN, seed=tid, **kw))
    return out


def loss_summary(losses) -> str:
    warm = max(10, len(losses) // 20)
    return (f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, max after the {warm}-step warmup "
            f"{max(losses[warm:]):.4f} (min {min(losses):.4f}); every step: "
            f"{' '.join(f'{x:.3f}' for x in losses)}")


def phase_pretrain(suite, card):
    """Step 1 of the main path: theta_0 from ``pretrain_mlm`` at full width,
    after the same pretraining at the larger lrs it does not use."""
    for lr in PRETRAIN_LR_REJECTED:
        _, m = pretrain_mlm(CONFIG, suite, steps=PRETRAIN_STEPS, batch_size=BATCH_MAIN,
                            seq_len=SEQ_MAIN, lr=lr)
        check(all(math.isfinite(x) for x in m["loss"]), f"lr {lr:g}: losses not finite")
        print(f"[main] pretrain_mlm at lr {lr:g} (not used): {loss_summary(m['loss'])}")
    t0 = time.perf_counter()
    with timed(pretrain_mod, "mlm_step") as step_s:
        body, m = pretrain_mlm(CONFIG, suite, steps=PRETRAIN_STEPS, batch_size=BATCH_MAIN,
                               seq_len=SEQ_MAIN, lr=PRETRAIN_LR)
    losses = m["loss"]
    check(len(losses) == PRETRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"pretrain losses not finite: {losses}")
    check(all_finite(body), "pretrained body is not finite")
    print(f"[main] pretrain_mlm {PRETRAIN_STEPS} steps (batch {BATCH_MAIN}, seq {SEQ_MAIN}, "
          f"lr {PRETRAIN_LR:g}): {loss_summary(losses)}; {time.perf_counter() - t0:.1f} s")
    print(f"[time] pretrain step on {card}: {median_ms(step_s)}")
    return body


def phase_fisher(theta, suite, card):
    """One iteration of 4 Contributor(with_fisher=True) into a fisher
    Repository; returns the cohort for the all-ones check."""
    contribs = main_contributors(suite, range(4), with_fisher=True)
    repo = Repository(theta, fusion_op="fisher")
    check(not repo.use_flat, "fusion_op='fisher' must take the per-leaf engine")
    base = repo.download()
    bodies = []
    with timed(FT, "compute_fisher") as fisher_s:
        for c in contribs:
            bodies.append(c.contribute(base))
            repo.upload(bodies[-1], c.last_fisher)
    check(all(all_finite(c.last_fisher) for c in contribs), "a Fisher is not finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = repo.fuse_pending()
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    print(f"[main] fisher iteration: fused {rec.n_accepted}/{rec.n_contributions} "
          f"(diff norms {[f'{n:.4g}' for n in rec.diff_norms]})")
    check((rec.n_accepted, rec.n_contributions) == (4, 4), "the fisher cohort must fuse 4/4")
    check(all_finite(repo.download()), "the fisher base is not finite")
    print(f"[time] compute_fisher on {card} (4 batches of {BATCH_MAIN} x {SEQ_MAIN}, "
          f"f32 squares of bf16 grads): {median_ms(fisher_s)}")
    print(f"[time] fisher fuse on {card} (screen + per-leaf fuse of 4, synchronised): "
          f"{1e3 * fuse_s:.1f} ms")
    return bodies


def phase_ties(theta, contribs, card):
    """One iteration of 4 contributors into a ties Repository; returns the
    base and the cohort for the CPU comparison."""
    repo = Repository(theta, fusion_op="ties", fusion_kwargs={"density": TIES_DENSITY})
    base = repo.download()
    bodies = [c.contribute(base) for c in contribs]
    for b in bodies:
        repo.upload(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = repo.fuse_pending()
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    print(f"[main] ties iteration (density {TIES_DENSITY}): fused {rec.n_accepted}/"
          f"{rec.n_contributions} (diff norms {[f'{n:.4g}' for n in rec.diff_norms]})")
    check((rec.n_accepted, rec.n_contributions) == (4, 4), "the ties cohort must fuse 4/4")
    check(all_finite(repo.download()), "the ties base is not finite")
    print(f"[time] ties fuse on {card} (screen + per-leaf fuse of 4, synchronised): "
          f"{1e3 * fuse_s:.1f} ms")
    return base, bodies, repo.download()


def check_fisher_ones(bodies):
    """With all-ones Fishers the fisher fuse is the plain average."""
    ones = tree_map(lambda x: torch.ones(x.shape, dtype=torch.float32, device=x.device),
                    bodies[0])
    spec = FlatSpec.from_tree(bodies[0])
    got = spec.flatten(fusion.fisher_weighted(bodies, [ones] * len(bodies)))
    want = spec.flatten(fusion.average(bodies))
    err = (got.float() - want.float()).abs()
    ok = bool((err <= bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))).all())
    check(ok, f"all-ones fisher differs from average by more than 1 bf16 ulp "
              f"(max |d| {err.max().item():.3g})")
    print(f"[check] fisher fuse with all-ones Fishers vs average (cold_fuse) over "
          f"{spec.size:,} bf16: max|d| {err.max().item():.3g}, "
          f"{int(torch.count_nonzero(err))} elements differ, all within 1 bf16 ulp")


def check_ties_on_cpu(base, bodies, fused, card):
    """ties on the CPU against the card's published leaves, and the kept
    elements per contributor; then the threshold's two selections timed."""
    def leaf(tree, path):
        return dict(tree_leaves_with_path(tree))[path]

    for path in TIES_LEAVES:
        b_card, m_card = leaf(base, path), [leaf(b, path) for b in bodies]
        b_cpu, m_cpu = b_card.cpu(), [m.cpu() for m in m_card]
        want = fusion.ties({"w": b_cpu}, [{"w": m} for m in m_cpu], density=TIES_DENSITY)["w"]
        got = leaf(fused, path).cpu()
        err = (got.float() - want.float()).abs()
        ok = bool((err <= bf16_ulp(torch.maximum(got.float().abs(),
                                                 want.float().abs()))).all())
        check(ok, f"ties {path}: card and CPU differ by more than 1 bf16 ulp "
                  f"(max |d| {err.max().item():.3g})")
        kept_card = [int(torch.count_nonzero(fusion.ties_trim(
            m.float() - b_card.float(), TIES_DENSITY))) for m in m_card]
        kept_cpu = [int(torch.count_nonzero(fusion.ties_trim(
            m.float() - b_cpu.float(), TIES_DENSITY))) for m in m_cpu]
        check(kept_card == kept_cpu, f"ties {path}: kept {kept_card} on the card, "
                                     f"{kept_cpu} on the CPU")
        print(f"[check] ties {path} {tuple(got.shape)}: card vs CPU max|d| "
              f"{err.max().item():.3g} (bound 1 bf16 ulp), nonzero kept per contributor "
              f"{kept_card} on both (k = {max(1, int(TIES_DENSITY * got.numel())):,}; a delta "
              "with fewer nonzeros keeps them all)")
    mag = (bodies[0]["embed"].float() - base["embed"].float()).abs().reshape(-1)
    n, k = mag.numel(), max(1, int(TIES_DENSITY * mag.numel()))
    check(fusion.ties_threshold(mag, k).item() == torch.kthvalue(mag, n - k + 1).values.item(),
          "topk's and kthvalue's thresholds differ")
    t_topk = time_ms(lambda: fusion.ties_threshold(mag, k), iters=5)
    t_kth = time_ms(lambda: torch.kthvalue(mag, n - k + 1), iters=5)
    print(f"[time] ties threshold on embed ({n:,} f32, k {k:,}) on {card}: topk {t_topk:.3f} ms, "
          f"kthvalue {t_kth:.3f} ms (the same value)")


def phase_main_path(card):
    suite = SyntheticSuite(vocab_size=CONFIG.vocab_size, num_tasks=16, seed=0)
    theta0 = phase_pretrain(suite, card)
    repo = Repository(theta0)
    spec = FlatSpec.from_tree(repo.download())
    check(spec.size == N_ROBERTA and spec.dtype == "bfloat16",
          f"RoBERTa-base body is {spec.size} {spec.dtype}, expected {N_ROBERTA} bfloat16")
    seq, batch = SEQ_MAIN, BATCH_MAIN
    contribs = main_contributors(suite, range(4))
    t0 = time.perf_counter()
    with timed(FT, "train_step") as ft_s:
        run_cold_fusion(CONFIG, repo, contribs, iterations=2, progress=True)
    torch.cuda.synchronize()
    print(f"[main] 2 iterations x 4 contributors x 3 steps (batch {batch}, seq {seq}) from "
          f"theta_0: {time.perf_counter() - t0:.1f} s")
    print(f"[time] contributor finetune step on {card} (body + head, AdamW): {median_ms(ft_s)}")

    base = repo.download()
    for c in contribs[:3]:
        repo.upload(c.contribute(base))
    repo.upload(tree_map(lambda x: torch.full_like(x, float("nan")), base))
    noise = torch.Generator(device=repo.device).manual_seed(1)
    repo.upload(tree_map(lambda x: x + (100.0 * torch.randn(
        x.shape, generator=noise, device=x.device)).to(x.dtype), base))
    rec = repo.fuse_pending()
    print(f"[main] adversarial cohort: fused {rec.n_accepted}/{rec.n_contributions} "
          f"(diff norms {[f'{n:.4g}' for n in rec.diff_norms]})")
    check((rec.n_accepted, rec.n_contributions) == (3, 5), "the screen must reject NaN and runaway")

    tasks = []
    for tid in (4, 5):
        d = suite.dataset(tid, 64, 64, seq, split_seed=1)
        tasks.append(EvalTask(tid, suite.tasks[tid].num_classes, d["x_train"], d["y_train"],
                              d["x_test"], d["y_test"]))
    acc = evaluate_base_model(CONFIG, repo.download(), tasks, frozen=True, steps=3)
    check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in acc.values()), f"accuracy {acc}")
    print(f"[main] frozen-probe accuracy on tasks 4, 5 after 3 head steps: {acc}")

    pub = repo.download()
    pspec = FlatSpec.from_tree(pub)
    row = pspec.flatten(pub)
    check(pspec.size == N_ROBERTA and row.dtype == torch.bfloat16, "published base shape/dtype")
    check(bool(torch.isfinite(row).all()), "published base is not finite")
    print(f"[main] published base: {pspec.size} bf16 elements, all finite")

    # the paper's centralised baseline (Fig. 2) over the same 4 tasks
    datasets = [(c.task_id, c.x, c.y, c.num_classes) for c in contribs]
    with timed(FT, "train_step") as mt_s:
        mt_body, heads = train_multitask(CONFIG, theta0, datasets, steps=MULTITASK_STEPS,
                                         batch_size=batch)
    check(all_finite(mt_body) and all(all_finite(h) for h in heads.values()),
          "multitask body or heads not finite")
    print(f"[main] train_multitask {MULTITASK_STEPS} steps over tasks {sorted(heads)}: body "
          f"and {len(heads)} heads finite")
    print(f"[time] multitask step on {card}: {median_ms(mt_s)}")
    del mt_body, heads

    fisher_bodies = phase_fisher(pub, suite, card)
    ties_held = phase_ties(pub, contribs, card)
    return fisher_bodies, ties_held

def graph_windows(fn, iters: int):
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, five windows of one replay each (median ms, all windows).
    Without the host's per-call work, this is the kernels' own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    runs = [time_ms(graph.replay, iters=1, warmup=0) / iters for _ in range(5)]
    del graph
    return sorted(runs)[2], runs


def median_windows(fn, iters: int, warmup: int = 2):
    """Five timing windows: (median ms, all windows)."""
    runs = [time_ms(fn, iters=iters, warmup=warmup) for _ in range(5)]
    return sorted(runs)[2], runs


def bound_of(nbytes: float, flops: float, peak: float = F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes at 3.35 TB/s and the
    operations at ``peak`` (f32 67 TFLOP/s unless given)."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(b, o), "bytes" if b >= o else "operations"


def payloads_on_card(C, size, block, kb, gen, nan_row=None, topk=False):
    """Random codec arrays on the card: offsets drawn at random with slot 1
    repeating slot 0 or, with ``topk``, as ``delta_encode`` writes them: a
    row's kb distinct offsets in the order of a top-k of random magnitudes
    (``topk`` of random keys, a chunk of rows at a time); int8 values,
    small f32 scales, weights in [0.5, 1.5)."""
    dev = torch.device("cuda")
    nb = -(-size // block)
    if topk:
        idx = torch.empty((C, nb, kb), dtype=torch.int16, device=dev)
        rows = idx.view(-1, kb)
        chunk = max(1, (1 << 26) // block)  # 256 MB of f32 keys at a time
        for r0 in range(0, rows.shape[0], chunk):
            keys = torch.rand((min(chunk, rows.shape[0] - r0), block), generator=gen, device=dev)
            rows[r0:r0 + keys.shape[0]] = keys.topk(kb, dim=1).indices.to(torch.int16)
        del keys
    else:
        idx = torch.randint(0, block, (C, nb, kb), generator=gen, device=dev).to(torch.int16)
        if kb >= 2:
            idx[:, :, 1] = idx[:, :, 0]
    val = torch.randint(-127, 128, (C, nb, kb), generator=gen, device=dev).to(torch.int8)
    scl = torch.rand((C, nb), generator=gen, device=dev) * 1e-4
    w = torch.rand(C, generator=gen, device=dev) + 0.5
    if nan_row is not None:
        scl[nan_row] = float("nan")
        w[nan_row] = 0.0
    return idx, val, scl, w


# decode_accum's payload kinds: random offsets with slot 1 repeating slot 0
# (every row takes the kernel's path for repeats; the kind the record's
# `ms` has always timed), and the codec's top-k offsets (no repeats, the
# service's traffic)
DECODE_KINDS = ("repeats", "top-k")


def decode_error(got, want):
    """(max |d acc|, max relative d sq), checked against 1e-6·max|acc| and 1e-5."""
    (acc, sq), (acc_p, sq_p) = got, want
    check(bool(torch.isfinite(acc).all()), "decode_accum acc is not finite")
    err = (acc - acc_p).abs().max().item()
    scale = acc_p.abs().max().item()
    check(err <= 1e-6 * scale, f"decode_accum acc max|d| {err:.3g} > 1e-6 x {scale:.3g}")
    nan, nan_p = torch.isnan(sq), torch.isnan(sq_p)
    check(bool(torch.equal(nan, nan_p)), "decode_accum sq NaN pattern differs")
    rel = ((sq - sq_p).abs() / sq_p.abs().clamp_min(1e-30))[~nan_p]
    worst = rel.max().item() if rel.numel() else 0.0
    check(worst <= 1e-5, f"decode_accum sq relative error {worst:.3g} > 1e-5")
    return err, worst


def decode_repeats(args, size, block):
    """Whether two calls on the same inputs give the same bits (sq may hold a
    NaN, which equals nothing as a float, so the bits are compared)."""
    first = decode_accum(*args, size=size, block=block)
    again = decode_accum(*args, size=size, block=block)
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(first, again))


def phase_decode_checks(gen):
    """decode_accum against decode_accum_plain on the card, on both payload
    kinds, and called twice on the same inputs, which must give the same
    bits.  Returns the service shape's inputs by (C, kind) and the largest
    acc error."""
    nb = -(-N_ROBERTA // CODEC_BLOCK)
    print(f"[check] decode_accum vs plain, C={C_SERVICE}+1 nb={nb} kb={CODEC_KB} "
          f"block={CODEC_BLOCK} size={N_ROBERTA}, row {C_SERVICE} NaN scale with weight 0")
    inputs, err = {}, 0.0
    for kind in DECODE_KINDS:
        args = payloads_on_card(C_SERVICE + 1, N_ROBERTA, CODEC_BLOCK, CODEC_KB, gen,
                                nan_row=C_SERVICE, topk=kind == "top-k")
        got = decode_accum(*args, size=N_ROBERTA, block=CODEC_BLOCK)
        want = decode_accum_plain(*args, size=N_ROBERTA, block=CODEC_BLOCK)
        e, rel = decode_error(got, want)
        check(decode_repeats(args, N_ROBERTA, CODEC_BLOCK),
              f"decode_accum ({kind} offsets): two calls on the same inputs differ")
        print(f"  service shape, {kind} offsets: acc max|d| {e:.3g} (bound 1e-6 x max|acc| = "
              f"{1e-6 * want[0].abs().max().item():.3g}), sq max rel err {rel:.3g} (bound "
              f"1e-5), sq[{C_SERVICE}]={got[1][C_SERVICE].item()}; called twice: bit-identical")
        err = max(err, e)
        inputs[C_SERVICE, kind] = tuple(t[:C_SERVICE].contiguous() for t in args)
        del got, want, args
    for kind in DECODE_KINDS:
        wide = payloads_on_card(C_MAX_COHORT, N_ROBERTA, CODEC_BLOCK, CODEC_KB, gen,
                                topk=kind == "top-k")
        e, r = decode_error(decode_accum(*wide, size=N_ROBERTA, block=CODEC_BLOCK),
                            decode_accum_plain(*wide, size=N_ROBERTA, block=CODEC_BLOCK))
        check(decode_repeats(wide, N_ROBERTA, CODEC_BLOCK),
              f"decode_accum (C={C_MAX_COHORT}, {kind} offsets): two calls differ")
        err = max(err, e)
        inputs[C_MAX_COHORT, kind] = wide
        print(f"  C={C_MAX_COHORT} (the service's max_cohort) at the service shape, {kind} "
              f"offsets: acc max|d| {e:.3g}, sq max rel err {r:.3g}; called twice: "
              "bit-identical")
        torch.cuda.empty_cache()
    for C, size, block, kb, nan_row in ((3, 10_000_019, 32768, 100, 1),
                                        (1, 1_000_003, 1024, 64, None),
                                        (2, 3_000_001, 2048, 2048, None)):
        args = payloads_on_card(C, size, block, kb, gen, nan_row=nan_row)
        e, r = decode_error(decode_accum(*args, size=size, block=block),
                            decode_accum_plain(*args, size=size, block=block))
        print(f"  ragged C={C} size={size} block={block} kb={kb}: acc max|d| {e:.3g}, "
              f"sq max rel err {r:.3g}")
    return inputs, err


def decode_bound(C, nb, kb):
    """decode_accum's bound at the service size: the payloads read once, the
    f32 accumulator and sq written once."""
    nbytes = C * nb * kb * 3 + C * nb * 4 + C * 4 + N_ROBERTA * 4 + C * 4
    flops = 4 * C * nb * kb  # per entry: dequantise, square-add (2), weight, add
    return bound_of(nbytes, flops) + (nbytes,)


def decode_floor(card):
    """The write floor: ``torch.zeros`` of the f32 accumulator (ms)."""
    floor, runs = median_windows(
        lambda: torch.zeros(N_ROBERTA, dtype=torch.float32, device="cuda"), iters=20)
    print(f"[time] decode_accum write floor: torch.zeros({N_ROBERTA}) f32 on {card}: "
          f"{floor:.4f} ms (windows {[round(r, 4) for r in runs]})")
    return floor


def decode_time(args, kind, card):
    """Eager and CUDA-graph (device) times of one payload at the service
    size, beside its bound: {"ms", "graph_ms", "bound_ms", "bound_by"}."""
    C, nb, kb = args[0].shape
    call = lambda: decode_accum(*args, size=N_ROBERTA, block=CODEC_BLOCK)  # noqa: E731
    bound, bound_by, nbytes = decode_bound(C, nb, kb)
    iters = 20 if C <= C_SERVICE else 5
    ms, runs = median_windows(call, iters=iters)
    g_ms, g_runs = graph_windows(call, iters)
    print(f"[time] decode_accum C={C} nb={nb} kb={kb}, {kind} offsets, on {card}: "
          f"kernel_ms {ms:.4f} (windows {[round(r, 4) for r in runs]}), from a CUDA graph "
          f"(device) {g_ms:.4f} (windows {[round(r, 4) for r in g_runs]}), bound_ms "
          f"{bound:.4f} ({nbytes / 1e6:.1f} MB at 3.35 TB/s), device/bound "
          f"{g_ms / bound:.2f}x")
    return {"ms": ms, "graph_ms": g_ms, "bound_ms": bound, "bound_by": bound_by}


def phase_decode_timing(inputs, card):
    """Eager and CUDA-graph (device) times at C=4 and C=64 on both payload
    kinds beside the bound and the write floor.  The record's ``ms`` and
    ``graph_ms`` are those of the repeated offsets, the kind earlier
    records timed; ``codec_ms`` and ``codec_graph_ms`` those of the codec's
    top-k offsets.  Returns the C=4 (ms, plain_ms, bound_ms, bound_by) and
    the extra numbers."""
    floor = decode_floor(card)
    out = {key: decode_time(a, key[1], card) for key, a in inputs.items()}
    idx, val, scl, w = inputs[C_SERVICE, "repeats"]
    plain, plain_runs = median_windows(
        lambda: decode_accum_plain(idx, val, scl, w, size=N_ROBERTA, block=CODEC_BLOCK),
        iters=3, warmup=1)
    print(f"[time] decode_accum plain C={C_SERVICE}, repeats offsets: plain_ms {plain:.4f} "
          f"(windows {[round(r, 3) for r in plain_runs]})")
    print("[time] decode_accum library_ms: none — no single PyTorch call computes the "
          "weighted scatter acc and the per-row sq together")

    def numbers(C):
        rep, top = out[C, "repeats"], out[C, "top-k"]
        return {"graph_ms": rep["graph_ms"], "codec_ms": top["ms"],
                "codec_graph_ms": top["graph_ms"]}

    main = out[C_SERVICE, "repeats"]
    wide = out[C_MAX_COHORT, "repeats"]
    extra = dict(numbers(C_SERVICE), write_floor_ms=floor,
                 wide=dict(numbers(C_MAX_COHORT), C=C_MAX_COHORT, ms=wide["ms"],
                           bound_ms=wide["bound_ms"]))
    return (main["ms"], plain, main["bound_ms"], main["bound_by"]), extra


def sketch_error(got, want, x):
    """max |d| over the sketch, checked per bucket: sums against 1e-5 x the
    bucket's sum of |x|, sums of squares against 1e-5 relative."""
    nb = got.shape[1]
    pad = (-x.shape[0]) % LANE
    tiles = torch.cat([x.float().abs(), x.new_zeros(pad, dtype=torch.float32)]).view(-1, LANE)
    abs_sum = torch.zeros(nb, device=x.device).index_add_(
        0, torch.arange(tiles.shape[0], device=x.device) % nb, tiles.sum(1))
    check(bool(torch.isfinite(got).all()), "row_sketch output is not finite")
    check(bool(((got[0] - want[0]).abs() <= 1e-5 * abs_sum).all()),
          "row_sketch sums differ by more than 1e-5 x the bucket's sum of |x|")
    rel = ((got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-30)).max().item()
    check(rel <= 1e-5, f"row_sketch sums of squares relative error {rel:.3g} > 1e-5")
    return (got - want).abs().max().item(), rel


def phase_sketch_checks(gen):
    """row_sketch against row_sketch_plain on the card.  Returns the bf16
    body-sized row and the largest error there."""
    dev = torch.device("cuda")
    out = None
    for dtype, N, nb in ((torch.bfloat16, N_ROBERTA, 32), (torch.float32, 1_000_003, 7),
                         (torch.float32, 100, 32)):
        x = (0.05 * torch.randn(N, generator=gen, device=dev) + 0.01).to(dtype)
        e, r = sketch_error(row_sketch(x, nb), row_sketch_plain(x, nb), x)
        print(f"[check] row_sketch vs plain, N={N} {str(dtype).removeprefix('torch.')} "
              f"n_buckets={nb}: max|d| {e:.3g} (sums bound 1e-5 x bucket sum|x|), "
              f"sq-sums max rel err {r:.3g} (bound 1e-5)")
        if out is None:
            out = (x, e)
    return out


def phase_sketch_timing(x, card):
    N = x.shape[0]
    nbytes = N * x.element_size() + 2 * 32 * 4
    bound, bound_by = bound_of(nbytes, 3 * N)  # per element: add, fma (2)
    ms, runs = median_windows(lambda: row_sketch(x, 32), iters=20)
    plain, plain_runs = median_windows(lambda: row_sketch_plain(x, 32), iters=3, warmup=1)
    print(f"[time] row_sketch N={N} bf16 32 buckets on {card}: kernel_ms {ms:.4f} "
          f"(windows {[round(r, 4) for r in runs]}), bound_ms {bound:.4f} "
          f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), kernel/bound {ms / bound:.2f}x, "
          f"plain_ms {plain:.4f} (windows {[round(r, 3) for r in plain_runs]})")
    print("[time] row_sketch library_ms: none — no single PyTorch call computes the "
          "tile-bucketed sums and sums of squares")
    return ms, plain, bound, bound_by


def copy_into_queue(src: str, name: str) -> str:
    """A byte-identical copy of a queue file under another name, made
    visible atomically (the scan ignores ``.tmp-`` names)."""
    dst = os.path.join(os.path.dirname(src), name)
    shutil.copyfile(src, dst + ".tmp-copy")
    os.replace(dst + ".tmp-copy", dst)
    return dst


def run_until(svc, target: int, timeout: float = 600.0):
    """Poll the service until it has published ``target`` and is idle."""
    t0 = time.perf_counter()
    while True:
        st = svc.run_once()
        check(st["last_error"] is None, f"service error: {st['last_error']}")
        if st["iteration"] >= target and not st["inflight"] and st["queue_depth"] == 0:
            return st
        check(time.perf_counter() - t0 < timeout,
              f"service did not publish iteration {target} in {timeout} s: {st}")


def nearest_pair(repo, iteration: int, n: int) -> float:
    """The smallest novelty distance between the newest ``n`` admissions,
    against the base they were admitted under."""
    sk = repo.cohort_sketch
    at = CohortSketch(sk.size, sk.n_buckets)
    at.set_base(sk.bases[iteration])
    ents = [e[2] for e in sk.entries[-n:]]
    return min(at.distance(a, b) for i, a in enumerate(ents) for b in ents[i + 1:])


def drain_small(device, root, rows, spec, b0):
    """A small queue (2 dense rows, one without a rider sketch, 3
    compressed rows, one a runaway, and a replay) drained on ``device``."""
    body = spec.unflatten(b0.to(device))
    repo = Repository(tree_map(lambda x: x.clone(), body), root=root, spill=True)
    svc = ColdService(repo, policy=AdmissionPolicy(min_cohort=5, novelty_threshold=NOVELTY))
    for i, r in enumerate(rows):
        sid = ContributorClient(root, f"c{i}").submit(
            row=r, spec=spec, base_iteration=0, compress=i >= 2, base=b0, sketch=i != 1)
        if i == 2:
            copy_into_queue(os.path.join(root, "queue", sid + ".npz"), "replay-000000.npz")
    st = run_until(svc, 1, timeout=120)
    rec = repo.history[-1]
    return (rec.n_accepted, rec.n_contributions, st["recent_rejects"],
            repo.flat_base_host().float())


def phase_small_service(workdir):
    """The same small queue drained by the service on the CPU and on the card."""
    gen = torch.Generator().manual_seed(3)
    body = init_encoder_body(TINY, gen, device="cpu")
    spec = FlatSpec.from_tree(body)
    b0 = spec.flatten(body)
    rows = [b0 + 0.01 * torch.randn(b0.shape, generator=gen) for _ in range(4)]
    rows.append(b0 + 100.0 * torch.randn(b0.shape, generator=gen))  # the runaway
    out = [drain_small(dev, os.path.join(workdir, f"small-{dev}"), rows, spec, b0)
           for dev in ("cpu", "cuda")]
    (acc_c, k_c, rej_c, base_c), (acc_g, k_g, rej_g, base_g) = out
    d = (base_c - base_g).abs().max().item()
    check((acc_c, k_c) == (acc_g, k_g) == (4, 5), f"small queue: fused {acc_g}/{k_g}, "
          f"CPU {acc_c}/{k_c}, expected 4/5")
    check(rej_c == rej_g and [r["file"] for r in rej_g] == ["replay-000000.npz"],
          f"small queue rejections differ: CPU {rej_c}, card {rej_g}")
    check(d <= 1e-5, f"small queue: card and CPU published bases differ by {d:.3g} > 1e-5")
    print(f"[small] TINY f32 queue (2 dense, 3 compressed incl. a runaway, 1 replay): fused "
          f"{acc_g}/{k_g} and the replay rejected on both; card vs CPU base max|d| {d:.3g} "
          "(bound 1e-5)")


def phase_service_path(workdir):
    """The contributor service loop at RoBERTa-base width (phase 7)."""
    seq, batch = 128, 32
    root = os.path.join(workdir, "service")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    repo = Repository(init_encoder_body(CONFIG, gen, device="cuda"), root=root, spill=True)
    spec = FlatSpec.from_tree(repo.download())
    check(spec.size == N_ROBERTA and spec.dtype == "bfloat16",
          f"RoBERTa-base body is {spec.size} {spec.dtype}, expected {N_ROBERTA} bfloat16")
    svc = ColdService(repo, policy=AdmissionPolicy(min_cohort=4, novelty_threshold=NOVELTY))
    print(f"[service] root with base_iter0000.npz and the base sketch: "
          f"{time.perf_counter() - t0:.1f} s")
    suite = SyntheticSuite(vocab_size=CONFIG.vocab_size, num_tasks=16, seed=0)
    contribs = []
    for tid in range(8, 12):
        d = suite.dataset(tid, 128, 32, seq)
        contribs.append(Contributor(CONFIG, tid, suite.tasks[tid].num_classes, d["x_train"],
                                    d["y_train"], steps=3, batch_size=batch, seed=tid))
    clients = [ContributorClient(root, f"c{i}") for i in range(4)]
    sizes = {"dense": [], "compressed": []}
    submit_s = {"dense": [], "compressed": []}
    # per round: seconds of finetune, of submit and of serving the queue
    split = {"finetune": [], "submit": [], "serve": []}

    def submit(i, body, base, it, *, compress=False, sketch=None):
        t = time.perf_counter()
        sid = clients[i].submit(body, base_iteration=it, compress=compress,
                                base=base if compress else None, sketch=sketch)
        kind = "compressed" if compress else "dense"
        submit_s[kind].append(time.perf_counter() - t)
        path = os.path.join(root, "queue", sid + ".npz")
        sizes[kind].append(os.path.getsize(path))
        return path

    def finetune():
        t_ft = time.perf_counter()
        base = repo.download()
        bodies = [c.contribute(base) for c in contribs]
        torch.cuda.synchronize()
        split["finetune"].append(time.perf_counter() - t_ft)
        return base, bodies

    def serve(target):
        split["submit"].append(sum(submit_s["dense"]) + sum(submit_s["compressed"])
                               - sum(split["submit"]))
        t_sv = time.perf_counter()
        st = run_until(svc, target)
        split["serve"].append(time.perf_counter() - t_sv)
        return st

    # round 1: 2 dense (one unsketched), 2 compressed and a replay
    t = time.perf_counter()
    base, bodies = finetune()
    b0 = spec.flatten(base)
    paths = [submit(0, bodies[0], base, 0), submit(1, bodies[1], base, 0, sketch=False),
             submit(2, bodies[2], base, 0, compress=True),
             submit(3, bodies[3], base, 0, compress=True)]
    copy_into_queue(paths[2], "replay-000000.npz")
    host_b0 = b0.cpu()
    expect_rows = [spec.flatten(bodies[i]).float() for i in (0, 1)]
    t_dec = time.perf_counter()
    for p in paths[2:]:
        (payload,), _ = ckpt.load_flat_delta(p)
        expect_rows.append(torch.from_numpy(delta_decode(payload, host_b0)).cuda())
    decode_s = time.perf_counter() - t_dec
    st = serve(1)
    round_s = [time.perf_counter() - t]
    rec = repo.history[-1]
    check((rec.n_accepted, rec.n_contributions) == (4, 4),
          f"round 1 fused {rec.n_accepted}/{rec.n_contributions}, expected 4/4")
    rej = st["recent_rejects"]
    check([r["file"] for r in rej] == ["replay-000000.npz"]
          and rej[0]["reason"].startswith("near-duplicate of c2-000000"),
          f"round 1 must reject exactly the replay as a near-duplicate: {rej}")
    want, _ = cold_fuse_plain(b0.float(), torch.stack(expect_rows),
                              torch.ones(4, device="cuda"))
    err = fused_error(spec.flatten(repo.download()), want.to(torch.bfloat16))
    print(f"[service] round 1: fused {rec.n_accepted}/{rec.n_contributions} (2 dense, 2 "
          f"compressed), replay rejected ({rej[0]['reason']}); published base vs "
          f"cold_fuse_plain over the dense and host-decoded rows: max|d| {err:.3g} "
          f"(bound 1 bf16 ulp); nearest novelty distance between the 4 admitted "
          f"{nearest_pair(repo, 0, 4):.4f} (threshold {NOVELTY}); {round_s[-1]:.1f} s")
    del expect_rows, want

    # round 2: an all-dense cohort
    t = time.perf_counter()
    base, bodies = finetune()
    for i in range(4):
        submit(i, bodies[i], base, 1)
    serve(2)
    round_s.append(time.perf_counter() - t)
    rec = repo.history[-1]
    check((rec.n_accepted, rec.n_contributions) == (4, 4),
          f"round 2 fused {rec.n_accepted}/{rec.n_contributions}, expected 4/4")
    print(f"[service] round 2: all-dense cohort fused {rec.n_accepted}/{rec.n_contributions}; "
          f"nearest novelty distance {nearest_pair(repo, 1, 4):.4f}; {round_s[-1]:.1f} s")

    # round 3: 3 honest compressed and a runaway compressed submission
    t = time.perf_counter()
    base, bodies = finetune()
    noise = torch.Generator(device="cuda").manual_seed(1)
    runaway = tree_map(lambda x: x + (100.0 * torch.randn(
        x.shape, generator=noise, device=x.device)).to(x.dtype), base)
    for i in range(3):
        submit(i, bodies[i], base, 2, compress=True)
    submit(3, runaway, base, 2, compress=True)
    serve(3)
    round_s.append(time.perf_counter() - t)
    rec = repo.history[-1]
    check((rec.n_accepted, rec.n_contributions) == (3, 4),
          f"round 3 fused {rec.n_accepted}/{rec.n_contributions}, expected 3/4")
    print(f"[service] round 3: adversarial compressed cohort fused "
          f"{rec.n_accepted}/{rec.n_contributions} (diff norms "
          f"{[f'{n:.4g}' for n in rec.diff_norms]}); {round_s[-1]:.1f} s")

    svc.close()
    row = spec.flatten(repo.download())
    check(row.dtype == torch.bfloat16 and bool(torch.isfinite(row).all()),
          "published base is not finite bf16")
    mean = {k: sum(v) / len(v) for k, v in sizes.items()}
    print(f"[service] queue bytes per submission: dense {mean['dense'] / 1e6:.1f} MB, "
          f"compressed {mean['compressed'] / 1e6:.1f} MB ({mean['dense'] / mean['compressed']:.1f}x "
          "smaller)")
    print(f"[service] submit seconds (flatten, copy to host, sketch, encode, npz write): "
          f"dense {[round(x, 2) for x in submit_s['dense']]}, compressed "
          f"{[round(x, 2) for x in submit_s['compressed']]}")
    t_enc = time.perf_counter()
    delta_encode(spec.flatten(bodies[0]).cpu(), spec.flatten(base).cpu(),
                 k_per_block=CODEC_KB, block=CODEC_BLOCK)
    print(f"[service] host delta_encode of one body: {time.perf_counter() - t_enc:.2f} s; "
          f"host delta_decode of two payloads: {decode_s:.2f} s")
    print(f"[service] wall time per round (finetune + submit + serve): "
          f"{[round(x, 1) for x in round_s]} s; published base iteration {repo.iteration}, "
          "all finite")
    print(f"[service] per round, finetune {[round(x, 2) for x in split['finetune']]} s, "
          f"submit {[round(x, 2) for x in split['submit']]} s, serve (admit, stage, fuse, "
          f"publish) {[round(x, 2) for x in split['serve']]} s")
    return err


# ---------------------------------------------------------------------------
# slice 3: the serving path (flash_attention, rwkv6_scan)
# ---------------------------------------------------------------------------


def bf16_close(got, want, what):
    """max |got - want| (f32), checked elementwise against 1 bf16 ulp of
    the larger side plus 2e-5 x max(1, max |want|): both sides sum in f32
    in another order (the f32 bound, which matters where the sum cancels
    to a small value) and round once."""
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: kernel output is not finite")
    err = (g - w).abs()
    tol = bf16_ulp(torch.maximum(g.abs(), w.abs())) + 2e-5 * max(1.0, w.abs().max().item())
    ok = bool((err <= tol).all())
    check(ok, f"{what}: differs by more than 1 bf16 ulp + 2e-5 x max(1, max|plain|) "
          f"(max |d| {err.max().item():.3g})")
    return err.max().item()


def f32_close(got, want, what, rel=2e-5):
    """max |got - want|, checked against rel x max(1, max |want|): f32 sums
    in another order."""
    check(bool(torch.isfinite(got).all()), f"{what}: kernel output is not finite")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    check(err <= rel * scale, f"{what}: max |d| {err:.3g} > {rel} x {scale:.3g}")
    return err


def qkv_on_card(B, Sq, Sk, Hq, Hkv, hd, dtype, gen):
    dev = torch.device("cuda")
    return (torch.randn((B, Sq, Hq, hd), generator=gen, device=dev).to(dtype),
            torch.randn((B, Sk, Hkv, hd), generator=gen, device=dev).to(dtype),
            torch.randn((B, Sk, Hkv, hd), generator=gen, device=dev).to(dtype))


def flash_routed(want_route, q, k, v, **kw):
    """flash_attention on the card, checked to launch once through
    ``want_route`` (the route ``fa_mod.route`` names for these shapes)."""
    check(fa_mod.route(q.dtype, q.shape[1], q.shape[2], k.shape[2]) == want_route,
          f"flash: {tuple(q.shape)} {q.dtype} is not routed to {want_route}")
    before = dict(flash_attention.launches_by_route)
    out = flash_attention(q, k, v, **kw)
    after = flash_attention.launches_by_route
    check(after[want_route] == before[want_route] + 1
          and sum(after[r] for r in fa_mod.ROUTES) == sum(before[r] for r in fa_mod.ROUTES) + 1,
          f"flash: the call did not launch once through the {want_route} route")
    return out


def phase_flash_checks(gen):
    """flash_attention against flash_attention_plain on the card, each
    call through the route it must take.  Returns gemma3-1b's
    prefill-shaped bf16 inputs and the largest error there."""
    B, Sq, Sk, Hq, Hkv, hd = FLASH_PREFILL
    q, k, v = qkv_on_card(B, Sq, Sk, Hq, Hkv, hd, torch.bfloat16, gen)
    worst = 0.0
    for window in (GEMMA_WINDOW, None):
        e = bf16_close(flash_routed("prefill_tc", q, k, v, causal=True, window=window),
                       flash_attention_plain(q, k, v, causal=True, window=window),
                       f"flash prefill window={window}")
        worst = max(worst, e)
        print(f"[check] flash_attention vs plain, gemma3-1b prefill B={B} Sq={Sq} Sk={Sk} "
              f"Hq={Hq} Hkv={Hkv} hd={hd} bf16 window={window}, route prefill_tc: max|d| "
              f"{e:.3g} (bound 1 bf16 ulp + 2e-5 x max(1, max|o|))")
        qd = q[:, :1].contiguous()
        e = bf16_close(flash_routed("decode", qd, k, v, causal=True, window=window,
                                    q_offset=1100),
                       flash_attention_plain(qd, k, v, causal=True, window=window,
                                             q_offset=1100), f"flash decode window={window}")
        worst = max(worst, e)
        print(f"[check] flash_attention vs plain, decode Sq=1 q_offset=1100 Sk={Sk} bf16 "
              f"window={window}, route decode: max|d| {e:.3g} (bound 1 bf16 ulp + 2e-5 x "
              "max(1, max|o|))")
        qf, kf, vf = q[:, :1].float(), k.float(), v.float()
        e = f32_close(flash_routed("decode", qf, kf, vf, causal=True, window=window,
                                   q_offset=1100),
                      flash_attention_plain(qf, kf, vf, causal=True, window=window,
                                            q_offset=1100), f"flash f32 decode window={window}")
        print(f"[check] flash_attention vs plain, decode Sq=1 q_offset=1100 Sk={Sk} f32 "
              f"window={window}, route decode: max|d| {e:.3g} (bound 2e-5 x max(1, max|o|))")
    for (b, sq, sk, hq, hkv, d, causal, window, off) in (
            (2, 96, 160, 4, 1, 256, True, 64, 0), (2, 77, 133, 8, 2, 64, True, None, 56),
            (3, 45, 45, 4, 4, 128, False, None, 0),
            (2, 70, 101, 4, 1, 128, True, 17, 31), (1, 33, 40, 4, 2, 32, True, 8, 7)):
        qs, ks, vs = qkv_on_card(b, sq, sk, hq, hkv, d, torch.float32, gen)
        e = f32_close(flash_routed("prefill_fma", qs, ks, vs, causal=causal, window=window,
                                   q_offset=off),
                      flash_attention_plain(qs, ks, vs, causal=causal, window=window,
                                            q_offset=off), f"flash f32 hd={d}")
        print(f"[check] flash_attention vs plain, f32 B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} "
              f"hd={d} causal={causal} window={window} q_offset={off}, route prefill_fma: "
              f"max|d| {e:.3g} (bound 2e-5 x max(1, max|o|))")
        qb, kb, vb = qs.bfloat16(), ks.bfloat16(), vs.bfloat16()
        e = bf16_close(flash_routed("prefill_tc", qb, kb, vb, causal=causal, window=window,
                                    q_offset=off),
                       flash_attention_plain(qb, kb, vb, causal=causal, window=window,
                                             q_offset=off), f"flash bf16 hd={d}")
        print(f"[check] flash_attention vs plain, the same in bf16, route prefill_tc: max|d| "
              f"{e:.3g} (bound 1 bf16 ulp + 2e-5 x max(1, max|o|))")
    qs, ks, vs = qkv_on_card(1, 40, 64, 4, 1, 64, torch.float32, gen)
    for dtype, rt in ((torch.float32, "prefill_fma"), (torch.bfloat16, "prefill_tc")):
        qq, kk, vv = qs.to(dtype), ks.to(dtype), vs.to(dtype)
        got = flash_routed(rt, qq, kk, vv, causal=True, window=8, q_offset=66)
        want = flash_attention_plain(qq, kk, vv, causal=True, window=8, q_offset=66)
        (f32_close if dtype == torch.float32 else bf16_close)(got, want, "flash partly masked")
        check(bool((got[:, 6:] == 0).all()) and bool((got[:, :5] != 0).any()),
              "flash: rows that see no key must be 0, the others not")
    got = flash_routed("decode", qs[:, :1].bfloat16(), ks.bfloat16(), vs.bfloat16(),
                       causal=True, window=8, q_offset=100)
    check(bool((got == 0).all()), "flash decode: a row that sees no key must be 0")
    print("[check] flash_attention fully masked rows (q_offset 66, window 8, Sk 64: rows 6.. "
          "see no key): exactly 0 in f32 and bf16, rows 0..4 match the plain version; "
          "decode at q_offset 100: exactly 0")
    return (q, k, v), worst


def visible_entries(Sq, Sk, causal, window, q_offset):
    """Score entries the masks leave visible, summed over the query rows."""
    qp = torch.arange(Sq, dtype=torch.int64) + q_offset
    hi = torch.clamp(qp + 1, max=Sk) if causal else torch.full_like(qp, Sk)
    lo = torch.clamp(qp - window + 1, min=0) if window is not None else torch.zeros_like(qp)
    return int(torch.clamp(hi - lo, min=0).sum())


def visible_keys(Sq, Sk, causal, window, q_offset):
    """Keys that some query row sees: the K and V rows a call must read."""
    lo = max(0, q_offset - window + 1) if window is not None else 0
    hi = min(Sk, q_offset + Sq) if causal else Sk
    return max(0, hi - lo)


def phase_flash_timing(inputs, card):
    """Kernel, plain version and SDPA at gemma3-1b's prefill shape (both
    layer kinds) and at decode.  Returns the global-layer prefill numbers
    and, per line, its route and numbers."""
    q, k, v = inputs
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out, lines = None, []
    for label, qq, window, off in (("prefill global", q, None, 0),
                                   ("prefill local", q, GEMMA_WINDOW, 0),
                                   ("decode global", q[:, :1].contiguous(), None, 1100),
                                   ("decode local", q[:, :1].contiguous(), GEMMA_WINDOW, 1100)):
        sq = qq.shape[1]
        rt = fa_mod.route(qq.dtype, sq, Hq, Hkv)
        # q read and o written once; each visible K and V row read once
        nbytes = (2 * qq.numel() * qq.element_size()
                  + 2 * B * Hkv * hd * k.element_size() * visible_keys(sq, Sk, True, window, off))
        flops = 4 * hd * B * Hq * visible_entries(sq, Sk, True, window, off)
        bound, bound_by = bound_of(nbytes, flops, BF16_FLOPS)
        iters = 20 if sq > 1 else 200
        ms, runs = median_windows(lambda: flash_attention(qq, k, v, causal=True, window=window,
                                                          q_offset=off), iters=iters)
        plain, plain_runs = median_windows(lambda: flash_attention_plain(
            qq, k, v, causal=True, window=window, q_offset=off), iters=5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (qq, k, v))
        qp = torch.arange(sq, device=q.device)[:, None] + off
        kp = torch.arange(Sk, device=q.device)[None, :]
        mask = kp <= qp
        if window is not None:
            mask &= kp > qp - window
        lib, lib_runs = median_windows(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=iters)
        g_ms, g_runs = graph_windows(lambda: flash_attention(qq, k, v, causal=True, window=window,
                                                             q_offset=off), iters)
        g_lib, g_lib_runs = graph_windows(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
        print(f"[time] flash_attention {label} B={B} Sq={sq} Sk={Sk} Hq={Hq} Hkv={Hkv} hd={hd} "
              f"bf16 on {card}: route {rt} ({FLASH_SOURCE[rt]}.cu), kernel_ms {ms:.4f} "
              f"(windows {[round(r, 4) for r in runs]}), "
              f"bound_ms {bound:.4f} ({bound_by}: {nbytes / 1e6:.1f} MB at 3.35 TB/s, "
              f"{flops / 1e9:.2f} GFLOP at 989 TFLOP/s), kernel/bound {ms / bound:.2f}x, "
              f"plain_ms {plain:.4f} (windows {[round(r, 3) for r in plain_runs]}), "
              f"library_ms {lib:.4f} (scaled_dot_product_attention, same mask, windows "
              f"{[round(r, 4) for r in lib_runs]})")
        print(f"[time] flash_attention {label} replayed from a CUDA graph of {iters} calls "
              f"(device time, no host work per call): kernel {g_ms:.4f} ms (windows "
              f"{[round(r, 4) for r in g_runs]}), kernel/bound {g_ms / bound:.2f}x, "
              f"scaled_dot_product_attention {g_lib:.4f} ms (windows "
              f"{[round(r, 4) for r in g_lib_runs]})")
        lines.append({"label": label, "route": rt, "graph_ms": g_ms, "library_graph_ms": g_lib,
                      "source": f"src/repro_torch/kernels/csrc/{FLASH_SOURCE[rt]}.cu",
                      "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                      "library_ms": lib})
        if out is None:
            out = (ms, plain, bound, bound_by, lib)
    return out, lines


def rwkv_on_card(B, T, H, hd, dtype, gen, lo=-20.0):
    """Random r, k, v, logw (in [lo, -0.0025], log-uniform magnitudes), u,
    s0 on the card."""
    dev = torch.device("cuda")
    r, k, v = (torch.randn((B, T, H, hd), generator=gen, device=dev).to(dtype)
               for _ in range(3))
    mag = torch.rand((B, T, H, hd), generator=gen, device=dev)
    logw = (-torch.exp(-6.0 + mag * (math.log(-lo) + 6.0))).to(dtype)
    u = 0.5 * torch.randn((H, hd), generator=gen, device=dev)
    s0 = 0.3 * torch.randn((B, H, hd, hd), generator=gen, device=dev)
    return r, k, v, logw, u, s0


def rwkv_routed(want_route, *args):
    """rwkv6_scan on the card, checked to launch once through ``want_route``
    (the route ``rs_mod.route`` names for this T)."""
    check(rs_mod.route(args[0].shape[1]) == want_route,
          f"rwkv: T={args[0].shape[1]} is not routed to {want_route}")
    before = dict(rwkv6_scan.launches_by_route)
    out = rwkv6_scan(*args)
    after = rwkv6_scan.launches_by_route
    check(after[want_route] == before[want_route] + 1
          and sum(after.values()) == sum(before.values()) + 1,
          f"rwkv: the call did not launch once through the {want_route} route")
    return out


def phase_rwkv_checks(gen):
    """rwkv6_scan against rwkv6_scan_plain on the card, each call through
    the route it must take.  Returns rwkv6-7b's prefill-shaped f32 inputs
    and the largest error there."""
    B, T, H, hd = RWKV_PREFILL
    args = rwkv_on_card(B, T, H, hd, torch.float32, gen)
    check(args[3].min().item() < -19.0, "the logw draw must reach -20")
    (y, s), (yp, sp) = rwkv_routed("scan", *args), rwkv6_scan_plain(*args)
    ey, es = f32_close(y, yp, "rwkv y"), f32_close(s, sp, "rwkv state")
    print(f"[check] rwkv6_scan vs plain, rwkv6-7b prefill B={B} T={T} H={H} hd={hd} f32, logw "
          f"in [{args[3].min().item():.2f}, {args[3].max().item():.4f}], route scan: y max|d| "
          f"{ey:.3g}, state max|d| {es:.3g} (bound 2e-5 x max(1, max|plain|))")
    worst = max(ey, es)
    r, k, v, logw, u, s0 = args
    y1, s1 = rwkv_routed("scan", *(t[:, :100].contiguous() for t in (r, k, v, logw)), u, s0)
    y2, s2 = rwkv_routed("scan", *(t[:, 100:].contiguous() for t in (r, k, v, logw)), u, s1)
    e = max(f32_close(torch.cat([y1, y2], 1), yp, "rwkv chained y"),
            f32_close(s2, sp, "rwkv chained state"))
    print(f"[check] rwkv6_scan state chained across two calls (T=100 then 156) vs one plain "
          f"call: max|d| {e:.3g}")
    # decode: one step at rwkv6-7b's decode shape, then 32 chained steps
    # against one plain call of T=32
    one = [t[:, :1].contiguous() for t in (r, k, v, logw)] + [u, s0]
    (y, s), (yp1, sp1) = rwkv_routed("step", *one), rwkv6_scan_plain(*one)
    e = max(f32_close(y, yp1, "rwkv step y"), f32_close(s, sp1, "rwkv step state"))
    print(f"[check] rwkv6_scan vs plain, rwkv6-7b decode B={B} T=1 H={H} hd={hd} f32, logw in "
          f"[{one[3].min().item():.2f}, {one[3].max().item():.4f}], route step: max|d| {e:.3g} "
          "(bound 2e-5 x max(1, max|plain|))")
    n = SERVE_NEW
    yp32, sp32 = rwkv6_scan_plain(*(t[:, :n] for t in (r, k, v, logw)), u, s0)
    st, ys = s0, []
    for t in range(n):
        yt, st = rwkv_routed("step", *(x[:, t:t + 1].contiguous() for x in (r, k, v, logw)), u,
                             st)
        ys.append(yt)
    e = max(f32_close(torch.cat(ys, 1), yp32, "rwkv 32 chained steps y"),
            f32_close(st, sp32, "rwkv 32 chained steps state"))
    print(f"[check] rwkv6_scan {n} chained T=1 calls (route step) vs one plain call of T={n}: "
          f"every y and the state max|d| {e:.3g}")
    rb, kb, vb, wb, ub, sb = rwkv_on_card(2, 45, 8, 64, torch.bfloat16, gen)
    (y, s), (yp2, sp2) = (rwkv_routed("scan", rb, kb, vb, wb, ub, sb),
                          rwkv6_scan_plain(rb, kb, vb, wb, ub, sb))
    check(y.dtype == torch.bfloat16, "rwkv6_scan must keep r's dtype")
    e = bf16_close(y, yp2, "rwkv bf16 y")
    es = f32_close(s, sp2, "rwkv bf16-input state")
    one = [t[:, :1].contiguous() for t in (rb, kb, vb, wb)] + [ub, sb]
    (y, s), (yp2, sp2) = rwkv_routed("step", *one), rwkv6_scan_plain(*one)
    e1 = max(bf16_close(y, yp2, "rwkv bf16 step y"), f32_close(s, sp2, "rwkv bf16 step state"))
    print(f"[check] rwkv6_scan bf16 inputs B=2 T=45 H=8 hd=64: y max|d| {e:.3g} (bound 1 bf16 "
          f"ulp + 2e-5 x max(1, max|y|)), f32 state max|d| {es:.3g}; T=1 (route step) max|d| "
          f"{e1:.3g}")
    a32 = rwkv_on_card(3, 37, 4, 32, torch.float32, gen)
    (y, s), (yp3, sp3) = rwkv_routed("scan", *a32), rwkv6_scan_plain(*a32)
    e = max(f32_close(y, yp3, "rwkv hd32 y"), f32_close(s, sp3, "rwkv hd32 state"))
    one = [t[:, :1].contiguous() for t in a32[:4]] + list(a32[4:])
    (y, s), (yp3, sp3) = rwkv_routed("step", *one), rwkv6_scan_plain(*one)
    e1 = max(f32_close(y, yp3, "rwkv hd32 step y"), f32_close(s, sp3, "rwkv hd32 step state"))
    print(f"[check] rwkv6_scan f32 B=3 T=37 H=4 hd=32: route scan max|d| {e:.3g}, T=1 route step "
          f"max|d| {e1:.3g}")
    return args, worst


def host_us(fn, iters: int = 500) -> float:
    """Host time per call in microseconds: ``iters`` calls on the host
    clock with no synchronisation inside the loop (the device runs behind;
    a call's time is what the host spends issuing it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def phase_rwkv_timing(args, card):
    """Kernel and plain version at rwkv6-7b's prefill and decode shapes,
    eager and replayed from a CUDA graph; the wrapper's host time per call.  Returns the prefill numbers and, per
    line, its route and numbers."""
    r, k, v, logw, u, s0 = args
    B, T, H, hd = r.shape
    out, lines = None, []
    for label, sl in (("prefill", slice(None)), ("decode", slice(0, 1))):
        a = [t[:, sl].contiguous() for t in (r, k, v, logw)] + [u, s0]
        t_steps = a[0].shape[1]
        rt = rs_mod.route(t_steps)
        # r, k, v, logw read and y written once; u read; the state read and written
        nb = 5 * a[0].numel() * 4 + u.numel() * 4 + 2 * s0.numel() * 4
        flops = 5 * B * t_steps * H * hd * hd  # per state element and step: y 2, k v, S 2
        bd, bd_by = bound_of(nb, flops)
        iters = 20 if t_steps > 1 else 200
        ms, runs = median_windows(lambda: rwkv6_scan(*a), iters=iters)
        g_ms, g_runs = graph_windows(lambda: rwkv6_scan(*a), iters)
        plain, plain_runs = median_windows(lambda: rwkv6_scan_plain(*a), iters=3, warmup=1)
        h_us = host_us(lambda: rwkv6_scan(*a))
        print(f"[time] rwkv6_scan {label} B={B} T={t_steps} H={H} hd={hd} f32 on {card}: route "
              f"{rt} ({RWKV_SOURCE[rt]}.cu), kernel_ms {ms:.4f} (windows "
              f"{[round(x, 4) for x in runs]}), bound_ms {bd:.4f} ({bd_by}: {nb / 1e6:.1f} MB at "
              f"3.35 TB/s, {flops / 1e9:.3f} GFLOP at 67 TFLOP/s), kernel/bound {ms / bd:.2f}x, "
              f"plain_ms {plain:.4f} (windows {[round(x, 3) for x in plain_runs]})")
        print(f"[time] rwkv6_scan {label} replayed from a CUDA graph of {iters} calls (device "
              f"time, no host work per call): kernel {g_ms:.4f} ms (windows "
              f"{[round(x, 4) for x in g_runs]}), kernel/bound {g_ms / bd:.2f}x")
        line = {"label": label, "route": rt, "graph_ms": g_ms, "host_us": h_us}
        if rt == "step":
            # the replay above finds the 4.2 MB state in L2; serving does not
            # (32 layers' states are 134 MB): rotate over 16 states (67 MB)
            # and keep every output, as the cache keeps each layer's
            states = [s0.clone() for _ in range(16)]
            outs = []
            c_ms, c_runs = graph_windows(
                lambda: outs.append(rwkv6_scan(*a[:5], states[len(outs) % 16])), iters)
            del states, outs
            line["graph_cold_ms"] = c_ms
            print(f"[time] rwkv6_scan decode replayed from a CUDA graph, the state cold in L2 "
                  f"(16 states, 67 MB, in turn; every output kept): kernel {c_ms:.4f} ms "
                  f"(windows {[round(x, 4) for x in c_runs]}), kernel/bound {c_ms / bd:.2f}x")
            # the C entry point alone, with the wrapper's arguments prepared once
            y, s_fin = torch.empty_like(a[0]), torch.empty_like(s0)
            lib = rs_mod._lib("rwkv6_step")
            stream = torch._C._cuda_getCurrentRawStream(a[0].get_device())
            c_args = [t.data_ptr() for t in a] + [y.data_ptr(), s_fin.data_ptr(), B, H, hd, 0,
                                                  stream]
            c_us = host_us(lambda: lib.rwkv6_step_launch(*c_args))
            a_us = host_us(lambda: (torch.empty_like(a[0]), torch.empty_like(s0)))
            k_us = host_us(lambda: rs_mod._check(*a))
            print(f"[time] rwkv6_scan decode host time per call on {card}: wrapper "
                  f"{h_us:.2f} us (checks, two outputs, ctypes, launch), of which the C entry "
                  f"point through ctypes (with the launch) {c_us:.2f} us, the two output "
                  f"allocations {a_us:.2f} us, the shape/device checks {k_us:.2f} us")
        else:
            print(f"[time] rwkv6_scan {label} host time per call on {card}: {h_us:.2f} us")
        lines.append({**line, "source": f"src/repro_torch/kernels/csrc/{RWKV_SOURCE[rt]}.cu",
                      "ms": ms, "plain_ms": plain, "bound_ms": bd, "bound_by": bd_by,
                      "library_ms": None})
        if out is None:
            out = (ms, plain, bd, bd_by, None)
    print("[time] rwkv6_scan library_ms: none — no single PyTorch call computes the RWKV6 "
          "recurrence")
    return out, lines


class plain_kernels:
    """Inside the block the serving path computes with the kernels' plain
    versions (the reference run of the comparison): the module globals the
    model calls are swapped, and put back on exit.  ``nudge`` scales their
    f32 result by (1 + nudge) before it is rounded to the working dtype: a
    perturbation of the size of an f32 summation-order difference, whose
    effect on the logits is the yardstick for the kernel's."""

    def __init__(self, nudge: float = 0.0):
        self.nudge = nudge

    def __enter__(self):
        self.saved = (kops.flash_attention, rwkv_mod.rwkv6_scan)
        f = 1.0 + self.nudge

        def flash(q, k, v, **kw):
            return (flash_attention_plain(q.float(), k.float(), v.float(), **kw) * f).to(q.dtype)

        def scan(r, k, v, logw, u, s0):
            y, s = rwkv6_scan_plain(r.float(), k.float(), v.float(), logw.float(), u, s0)
            return (y * f).to(r.dtype), s

        kops.flash_attention = flash
        rwkv_mod.rwkv6_scan = scan
        return self

    def __exit__(self, *exc):
        kops.flash_attention, rwkv_mod.rwkv6_scan = self.saved


@torch.inference_mode()
def teacher_forced(cfg, params, prompts, gen_tokens, max_len):
    """(prefill logits [B, P, V], decode logits [B, n-1, V]) with the
    decode steps fed the given generated tokens."""
    dev = torch.device("cuda")
    B, P = prompts.shape
    cache = init_cache(cfg, B, max_len, device=dev)
    logits, _, cache = forward_lm(cfg, params, torch.as_tensor(prompts, device=dev),
                                  cache=cache, cache_index=0)
    serve = make_serve_step(cfg)
    gen = torch.as_tensor(gen_tokens, device=dev)
    dec = []
    for t in range(1, gen.shape[1]):
        lg, cache = serve(params, cache, gen[:, t - 1:t], P + t - 1)
        dec.append(lg)
    return logits, torch.stack(dec, 1)


def logit_diff(a, b):
    """(max |a - b|, mean |a - b|) over bf16 logits, in f32, row by row."""
    mx, tot, n = 0.0, 0.0, 0
    for i in range(a.shape[0]):
        d = (a[i].float() - b[i].float()).abs()
        mx, tot, n = max(mx, d.max().item()), tot + d.sum().item(), n + d.numel()
        del d
    return mx, tot / n


def logits_agreement(kern, plain, floor, what):
    """Kernel-path logits against the plain path's: max and mean |d| must
    stay within 4x those between the plain path and its nudged run
    (``floor``), the spread that rounding the same f32 values to bf16 at a
    different last bit produces through the whole model."""
    check(bool(torch.isfinite(kern).all()), f"{what}: logits not finite")
    mx, mean = logit_diff(kern, plain)
    check(mx <= 4 * floor[0], f"{what}: max|d| {mx:.3g} > 4 x the nudged plain run's "
          f"{floor[0]:.3g}")
    check(mean <= 4 * floor[1], f"{what}: mean|d| {mean:.3g} > 4 x the nudged plain run's "
          f"{floor[1]:.3g}")
    return mx, mean


def phase_serve(arch, cfg, prompt_len, new_tokens, max_len, kernel, least, card,
                routes_least):
    """One model at full width through ``launch.serve.main`` and then
    ``Engine.generate``, with the launches of ``kernel`` counted over both,
    and per route, each at least its entry of ``routes_least``; then the
    same prompts through the plain versions, compared."""
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):  # it prints every prompt: keep its summary line
        res_cli = serve_main(["--arch", arch, "--batch", "4", "--prompt-len", str(prompt_len),
                              "--new-tokens", str(new_tokens), "--seed", "0",
                              "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    print(out.getvalue().splitlines()[0])
    check(res_cli.tokens.shape == (4, prompt_len + new_tokens), "launcher output shape")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_lm(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    eng = Engine(cfg, params, max_len=max_len)
    prompts = np.random.default_rng(1).integers(3, cfg.vocab_size, (4, prompt_len))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = launches()
    check(counts[kernel] >= least, f"{kernel} launched {counts[kernel]} times serving {arch}, "
          f"expected >= {least}")
    by_route = dict({"flash_attention": flash_attention,
                     "rwkv6_scan": rwkv6_scan}[kernel].launches_by_route)
    for rt, n in routes_least.items():
        check(by_route[rt] >= n, f"{kernel}'s {rt} route launched {by_route[rt]} times "
              f"serving {arch}, expected >= {n}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[serve] {arch} ({cfg.num_layers} layers, d {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.3f} B params bf16, init {init_s:.2f} s): launcher 4 x {prompt_len} "
          f"-> {new_tokens} in {cli_s:.1f} s (with its own init); Engine.generate 4 x "
          f"{prompt_len} -> {new_tokens} (max_len {max_len}) {gen_s:.3f} s; launches "
          f"{counts}; peak {peak:.2f} GiB")
    print(f"[serve] {arch} {kernel} launches by route: {by_route}, total {counts[kernel]} (each "
          f"route at least {routes_least})")

    # timing split (after the counted run): prefill alone, then whole generates
    with torch.inference_mode():
        toks = torch.as_tensor(prompts, device=dev)

        def prefill():
            eng._prefill(params, toks, init_cache(cfg, 4, max_len, device=dev))

        pre_ms, pre_runs = median_windows(prefill, iters=3, warmup=1)
    gen_runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        gen_runs.append((time.perf_counter() - t0) * 1e3)
    gen_ms = sorted(gen_runs)[1]
    dec_ms = (gen_ms - pre_ms) / (new_tokens - 1)
    print(f"[serve] {arch} on {card}: prefill 4 x {prompt_len} {pre_ms:.2f} ms (windows "
          f"{[round(x, 2) for x in pre_runs]}); generate {gen_ms:.1f} ms (runs "
          f"{[round(x, 1) for x in gen_runs]}); decode {dec_ms:.2f} ms per step of 4 tokens; "
          f"{4 * new_tokens / gen_ms * 1e3:.1f} tokens/s, {4 * prompt_len / pre_ms * 1e3:.0f} "
          "prompt tokens/s in prefill")

    # where the time goes: the kernels' device time in one prefill and in 8
    # decode steps, against the unprofiled wall times above
    with torch.inference_mode():
        cache = init_cache(cfg, 4, max_len, device=dev)
        logits, cache = eng._prefill(params, toks, cache)
        nxt = torch.argmax(logits, dim=-1)[:, None]
        step = make_serve_step(cfg)

        def decode8():
            for t in range(8):
                step(params, cache, nxt, prompt_len + t)

        print_split(arch, f"prefill 4 x {prompt_len}", pre_ms, device_split(prefill))
        print_split(arch, "8 decode steps", 8 * dec_ms, device_split(decode8))
        del cache, logits

    # agreement with the plain versions, teacher-forced on the kernel path's tokens
    gen_k = res.tokens[:, prompt_len:]
    pre_k, dec_k = teacher_forced(cfg, params, prompts, gen_k, max_len)
    check(np.array_equal(torch.argmax(torch.cat([pre_k[:, -1:], dec_k], 1), -1).cpu().numpy(),
                         gen_k), "teacher-forced kernel path must repeat Engine.generate")
    with plain_kernels():
        pre_p, dec_p = teacher_forced(cfg, params, prompts, gen_k, max_len)
    with plain_kernels(nudge=NUDGE):
        pre_n, dec_n = teacher_forced(cfg, params, prompts, gen_k, max_len)
    floor_pre, floor_dec = logit_diff(pre_n, pre_p), logit_diff(dec_n, dec_p)
    del pre_n, dec_n
    a_pre = logits_agreement(pre_k, pre_p, floor_pre, f"{arch} prefill logits")
    a_dec = logits_agreement(dec_k, dec_p, floor_dec, f"{arch} decode logits")
    mean_logit = pre_p[:, -1].float().abs().mean().item()
    steps_k = torch.cat([pre_k[:, -1:], dec_k], 1).float()
    steps_p = torch.cat([pre_p[:, -1:], dec_p], 1).float()
    d_step = (steps_k - steps_p).abs().amax(-1)            # [B, n]
    top2 = torch.topk(steps_p, 2, dim=-1)
    margin = top2.values[..., 0] - top2.values[..., 1]
    decided = margin > 2 * d_step
    agree = top2.indices[..., 0].cpu().numpy() == gen_k
    dec_np = decided.cpu().numpy()
    check(bool(agree[dec_np].all()), f"{arch}: greedy tokens differ from the plain path where "
          "its top-2 margin exceeds twice the logit difference")
    print(f"[serve] {arch} kernel vs plain (teacher-forced): prefill logits max|d| {a_pre[0]:.4g} "
          f"mean|d| {a_pre[1]:.3g}, decode logits max|d| {a_dec[0]:.4g} mean|d| {a_dec[1]:.3g} "
          f"(mean |logit| {mean_logit:.3g}); the plain path nudged by {NUDGE:g} moves them by "
          f"max {floor_pre[0]:.4g} / mean {floor_pre[1]:.3g} (prefill) and max "
          f"{floor_dec[0]:.4g} / mean {floor_dec[1]:.3g} (decode), bound 4x; tokens: "
          f"{int(dec_np.sum())}/{dec_np.size} decided by a margin > 2 x max|d| and all agree; "
          f"{int(agree.sum())}/{agree.size} agree overall")
    del pre_k, dec_k, pre_p, dec_p, params, eng
    torch.cuda.empty_cache()
    return counts[kernel], by_route, {"prefill_ms": pre_ms, "decode_ms": dec_ms,
                                      "tokens_per_s": 4 * new_tokens / gen_ms * 1e3}


def device_split(fn):
    """One call of ``fn`` under ``torch.profiler``: (device-busy ms, top 6
    kernels and the port's own kernels, each as (name, ms, count)), or None
    when the profiler recorded no device event.  Busy is the sum of the
    kernels' device intervals (one stream, so they do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        return None
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    ours = [(re.search(r"(\w+_kernel)", k).group(1), ms, n) for k, (ms, n) in ranked
            if re.search(r"(flash|rwkv6)\w*_kernel", k)]
    return (sum(ms for ms, _ in by_name.values()), [(k[:70], ms, n) for k, (ms, n) in ranked[:6]],
            ours)


def print_split(arch, what, wall_ms, split):
    if split is None:
        print(f"[profile] {arch} {what}: device time not measured (the profiler recorded no "
              "device event)")
        return
    busy, top, ours = split
    print(f"[profile] {arch} {what}: kernels busy {busy:.2f} ms of {wall_ms:.2f} ms wall "
          f"(unprofiled), device idle {max(0.0, 1 - busy / wall_ms) * 100:.1f} %; top kernels "
          + "; ".join(f"{name} {ms:.3f} ms x{n}" for name, ms, n in top)
          + "; the port's kernels " + "; ".join(f"{name} {ms:.3f} ms x{n}" for name, ms, n in ours))


def small_lm_cfg(arch):
    cfg = reduce_config(get_config(arch))
    if arch == "gemma3-1b":
        pattern = tuple(dataclasses.replace(b, window=8) if b.window else b for b in cfg.pattern)
        cfg = dataclasses.replace(cfg, num_layers=8, pattern=pattern)
    return cfg


def phase_small_lm():
    """Reduced f32 gemma3 (window 8, 8 layers) and rwkv6 on the card and on
    the CPU (whose path the CPU tests hold against the JAX package)."""
    for arch in ("gemma3-1b", "rwkv6-7b"):
        cfg = small_lm_cfg(arch)
        params = init_lm(cfg, torch.Generator().manual_seed(5), device="cpu")
        prompts = np.random.default_rng(6).integers(3, cfg.vocab_size, (3, 12))
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda x: x.to(dev), params)
            res = Engine(cfg, p, max_len=32).generate(prompts, max_new_tokens=16)
            with torch.inference_mode():
                lg, _, _ = forward_lm(cfg, p, torch.as_tensor(res.tokens, device=dev))
            out[dev] = (res.tokens, lg.cpu())
        d = (out["cpu"][1] - out["cuda"][1]).abs().max().item()
        check(np.array_equal(out["cpu"][0], out["cuda"][0]), f"small {arch}: tokens differ")
        check(d <= 1e-4, f"small {arch}: card and CPU logits differ by {d:.3g} > 1e-4")
        print(f"[small] reduced f32 {cfg.name} ({cfg.num_layers} layers): 3 x 12 -> 16 tokens "
              f"identical on card and CPU; logits over all 28 positions max|d| {d:.3g} "
              "(bound 1e-4)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count, smi = torch.cuda.get_device_name(0), torch.cuda.device_count(), nvidia_smi()
    print(f"[card] {name}, {count} device(s); nvidia-smi: {smi}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    built = _build.build_all(SOURCES)
    print(f"[build] {len(SOURCES)} sources, one nvcc each, started together: "
          f"{time.perf_counter() - t0:.1f} s")
    for source in SOURCES:
        b = built[source]
        took = f"nvcc {b.seconds:.1f} s" if b.seconds else "built earlier in this checkout"
        print(f"[build] {source}.cu -> {b.path.name}: {took}")
        for line in ptxas_summary(b.log):
            print(f"  ptxas {line}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs, max_err = phase_kernel_checks(gen)
    ms, plain_ms, bound_ms, bound_by = phase_timing(inputs, smi)
    del inputs
    torch.cuda.empty_cache()
    dec_inputs, dec_err = phase_decode_checks(gen)
    dec, dec_extra = phase_decode_timing(dec_inputs, smi)
    del dec_inputs
    torch.cuda.empty_cache()
    sk_row, sk_err = phase_sketch_checks(gen)
    sk = phase_sketch_timing(sk_row, smi)
    del sk_row
    torch.cuda.empty_cache()
    fl_inputs, fl_err = phase_flash_checks(gen)
    fl, fl_lines = phase_flash_timing(fl_inputs, smi)
    del fl_inputs
    rw_inputs, rw_err = phase_rwkv_checks(gen)
    rw, rw_lines = phase_rwkv_timing(rw_inputs, smi)
    del rw_inputs
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        phase_small_agreement()
        phase_small_per_leaf()
        phase_small_service(workdir)
        phase_small_lm()

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        fisher_bodies, ties_held = phase_main_path(smi)
        loop = launches()
        print(f"[main] launches on the training path: {loop}")
        check(loop["cold_fuse"] >= 4,
              f"cold_fuse launched {loop['cold_fuse']} times on the loop, expected >= 4")
        print(f"[main] torch.cuda.max_memory_allocated: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_fisher_ones(fisher_bodies)
        check_ties_on_cpu(*ties_held, smi)
        del fisher_bodies, ties_held
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t_service = time.perf_counter()
        phase_service_path(workdir)
        counts = launches()
        print(f"[service] launches on the service path: {counts}; "
              f"{time.perf_counter() - t_service:.1f} s")
        print(f"[service] torch.cuda.max_memory_allocated: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for kernel, least in (("decode_accum", 3), ("row_sketch", 5), ("cold_fuse", 1)):
        check(counts[kernel] >= least, f"{kernel} launched {counts[kernel]} times on the "
              f"service path, expected >= {least}")

    # the serving path (slice 3), one model at a time, counts reset before each
    # prefill: one launch per layer and generate; decode: one per layer and step
    counts["flash_attention"], fl_routes, _ = phase_serve(
        "gemma3-1b", GEMMA, GEMMA_PROMPT, SERVE_NEW, GEMMA_MAX_LEN, "flash_attention",
        GEMMA.num_layers * SERVE_NEW, smi,
        routes_least={"prefill_tc": GEMMA.num_layers,
                      "decode": GEMMA.num_layers * (SERVE_NEW - 1)})
    counts["rwkv6_scan"], rw_routes, _ = phase_serve(
        "rwkv6-7b", RWKV, RWKV_PROMPT, SERVE_NEW, RWKV_MAX_LEN, "rwkv6_scan",
        RWKV.num_layers * SERVE_NEW, smi,
        routes_least={"scan": RWKV.num_layers, "step": RWKV.num_layers * (SERVE_NEW - 1)})
    print(f"[done] {time.perf_counter() - t0:.1f} s after the card check")

    def record(name, replaces, err, timing, source=None):
        k_ms, k_plain, k_bound, k_by = timing[:4]
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source or name}.cu",
                "replaces": replaces, "launches": counts[name], "max_abs_err": err,
                "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound, "bound_by": k_by,
                "library_ms": timing[4] if len(timing) > 4 else None}

    # flash_attention's numbers are those of its first [time] line (prefill,
    # global layer); "routes" holds every [time] line and the serving
    # phase's launches per route
    flash = record("flash_attention", "src/repro/kernels/flash_attention.py:28", fl_err, fl,
                   source=FLASH_SOURCE[fl_lines[0]["route"]])
    flash["launches_by_route"] = fl_routes
    flash["routes"] = fl_lines
    # rwkv6_scan's likewise: the prefill line (scan route), then every line
    rwkv = record("rwkv6_scan", "src/repro/kernels/rwkv6_scan.py:35", rw_err, rw)
    rwkv["launches_by_route"] = rw_routes
    rwkv["routes"] = rw_lines

    print(json.dumps({"kernels": [
        record("cold_fuse", "src/repro/kernels/cold_fuse.py:61", max_err,
               (ms, plain_ms, bound_ms, bound_by)),
        dict(record("decode_accum", "src/repro/kernels/cold_fuse.py:170", dec_err, dec),
             **dec_extra),
        record("row_sketch", "src/repro/kernels/cold_fuse.py:253", sk_err, sk),
        flash, rwkv]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
