#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases (any failed check raises, so the script exits non-zero):

1. the card: name, count, and ``nvidia-smi``'s name and power limit;
2. build every kernel from ``src/repro_torch/kernels/csrc`` (``cold_fuse``,
   ``decode_accum``, ``row_sketch``: one ``nvcc`` each, all started
   together; time, and ptxas' registers and spills per kernel);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and on ragged shapes: ``cold_fuse`` at K=5 x
   N=123,969,792 bf16 (one NaN row of weight 0, alpha 1.0 and 0.3);
   ``decode_accum`` at the service shape (C=4 compressed RoBERTa-base
   deltas, block 1024, kb 64, duplicates, plus a NaN-scale row of weight
   0), at block 32768, at a ragged size and at C=1; ``row_sketch`` of the
   bf16 body with 32 buckets, of 1,000,003 f32 with 7 and of 100 elements;
4. kernel and plain-version times (CUDA events, five windows after a
   warm-up, the median printed) beside each kernel's bound;
5. small-input checks: the same screen + fuse, and the same small queue
   drained by the contributor service, on the card and on the CPU (whose
   paths the CPU tests hold against the JAX package) must agree;
6. the ColD Fusion loop (slice 1), through the entry points a user calls:
   a Repository over a RoBERTa-base body at full width (random weights from
   a seed), two iterations of 4 contributors x 3 finetune steps, an
   adversarial cohort (3 honest, one NaN, one runaway upload) that must
   fuse 3/5, and a frozen-probe evaluation;
7. the contributor service loop (slice 2) at the same width, in a
   temporary root: ``Repository(root, spill=True)`` behind a
   ``ColdService`` with the novelty screen on; round 1 takes 2 dense
   submissions (one without a rider sketch, so the service sketches it on
   the card), 2 compressed ones and a byte-identical replay that must be
   rejected; round 2 an all-dense cohort; round 3 three honest compressed
   submissions and a runaway one that must fuse 3/4.  Round 1's published
   base is held against ``cold_fuse_plain`` over the host-decoded rows.

Before each of phases 6 and 7 every kernel's launch counter is set to 0; it
is read just after.  The last lines are the kernels' JSON record (launches
from phase 7), ``nvidia-smi``'s line and ``{"ok": true, "device": {...}}``.
Without a card (or without the rest of the repository beside it) the script
exits non-zero and prints no result.
"""
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import CONFIG, TINY  # noqa: E402
from repro_torch.core import (Contributor, EvalTask, Repository,  # noqa: E402
                              evaluate_base_model, run_cold_fusion)
from repro_torch.data.synthetic import SyntheticSuite  # noqa: E402
from repro_torch.checkpoint import io as ckpt  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cold_fuse import cold_fuse, cold_fuse_plain  # noqa: E402
from repro_torch.kernels.decode_accum import decode_accum, decode_accum_plain  # noqa: E402
from repro_torch.kernels.row_sketch import row_sketch, row_sketch_plain  # noqa: E402
from repro_torch.models.encoder import init_encoder_body  # noqa: E402
from repro_torch.serve.cold_service import (AdmissionPolicy, ColdService,  # noqa: E402
                                            ContributorClient)
from repro_torch.utils.flat import (LANE, CohortSketch, FlatSpec, delta_decode,  # noqa: E402
                                    delta_encode)
from repro_torch.utils.pytree import tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
N_ROBERTA = 123_969_792     # elements of the RoBERTa-base body (FlatSpec.size)
K_MAIN = 5
KERNELS = ("cold_fuse", "decode_accum", "row_sketch")
CODEC_BLOCK, CODEC_KB = 1024, 64   # the service's default delta codec
C_SERVICE = 4
# novelty threshold of the service phases: a replay scores 0; three Adam
# steps from a random-init body move nearly every element by about lr, a
# shared isotropic growth that shrinks the relative distance of distinct
# contributions (docs/service_loop.md puts random-like finetunes near
# 0.03; this script's run on an H100 printed 0.056 for the nearest distinct
# pair), so the screen is set at the documented safe floor, not at 0.1
NOVELTY = 0.01


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


def launches():
    return {"cold_fuse": cold_fuse.launches, "decode_accum": decode_accum.launches,
            "row_sketch": row_sketch.launches}


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


def phase_main_path():
    seq, batch = 128, 32
    gen = torch.Generator(device="cuda").manual_seed(0)
    repo = Repository(init_encoder_body(CONFIG, gen, device="cuda"))
    spec = FlatSpec.from_tree(repo.download())
    check(spec.size == N_ROBERTA and spec.dtype == "bfloat16",
          f"RoBERTa-base body is {spec.size} {spec.dtype}, expected {N_ROBERTA} bfloat16")
    suite = SyntheticSuite(vocab_size=CONFIG.vocab_size, num_tasks=16, seed=0)
    contribs = []
    for tid in range(4):
        d = suite.dataset(tid, 128, 32, seq)
        contribs.append(Contributor(CONFIG, tid, suite.tasks[tid].num_classes,
                                    d["x_train"], d["y_train"], steps=3, batch_size=batch,
                                    seed=tid))
    t0 = time.perf_counter()
    run_cold_fusion(CONFIG, repo, contribs, iterations=2, progress=True)
    torch.cuda.synchronize()
    print(f"[main] 2 iterations x 4 contributors x 3 steps (batch {batch}, seq {seq}): "
          f"{time.perf_counter() - t0:.1f} s")

    base = repo.download()
    for c in contribs[:3]:
        repo.upload(c.contribute(base))
    repo.upload(tree_map(lambda x: torch.full_like(x, float("nan")), base))
    noise = torch.Generator(device="cuda").manual_seed(1)
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

def median_windows(fn, iters: int, warmup: int = 2):
    """Five timing windows: (median ms, all windows)."""
    runs = [time_ms(fn, iters=iters, warmup=warmup) for _ in range(5)]
    return sorted(runs)[2], runs


def bound_of(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes at 3.35 TB/s and f32
    operations at 67 TFLOP/s."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(b, o), "bytes" if b >= o else "operations"


def payloads_on_card(C, size, block, kb, gen, nan_row=None):
    """Random codec arrays on the card: offsets with duplicates (slot 1
    repeats slot 0), int8 values, small f32 scales, weights in [0.5, 1.5)."""
    dev = torch.device("cuda")
    nb = -(-size // block)
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


def phase_decode_checks(gen):
    """decode_accum against decode_accum_plain on the card.  Returns the
    service shape's C=4 inputs and the largest acc error there."""
    nb = -(-N_ROBERTA // CODEC_BLOCK)
    print(f"[check] decode_accum vs plain, C={C_SERVICE}+1 nb={nb} kb={CODEC_KB} "
          f"block={CODEC_BLOCK} size={N_ROBERTA}, duplicates, row {C_SERVICE} NaN scale "
          "with weight 0")
    idx, val, scl, w = payloads_on_card(C_SERVICE + 1, N_ROBERTA, CODEC_BLOCK, CODEC_KB, gen,
                                        nan_row=C_SERVICE)
    got = decode_accum(idx, val, scl, w, size=N_ROBERTA, block=CODEC_BLOCK)
    want = decode_accum_plain(idx, val, scl, w, size=N_ROBERTA, block=CODEC_BLOCK)
    err, rel = decode_error(got, want)
    print(f"  service shape: acc max|d| {err:.3g} (bound 1e-6 x max|acc| = "
          f"{1e-6 * want[0].abs().max().item():.3g}), sq max rel err {rel:.3g} (bound 1e-5), "
          f"sq[{C_SERVICE}]={got[1][C_SERVICE].item()}")
    del got, want
    for C, size, block, kb, nan_row in ((3, 10_000_019, 32768, 100, 1),
                                        (1, 1_000_003, 1024, 64, None),
                                        (2, 3_000_001, 2048, 2048, None)):
        args = payloads_on_card(C, size, block, kb, gen, nan_row=nan_row)
        e, r = decode_error(decode_accum(*args, size=size, block=block),
                            decode_accum_plain(*args, size=size, block=block))
        print(f"  ragged C={C} size={size} block={block} kb={kb}: acc max|d| {e:.3g}, "
              f"sq max rel err {r:.3g}")
    return (idx[:C_SERVICE].contiguous(), val[:C_SERVICE].contiguous(),
            scl[:C_SERVICE].contiguous(), w[:C_SERVICE].contiguous()), err


def phase_decode_timing(inputs, card):
    idx, val, scl, w = inputs
    C, nb, kb = idx.shape
    nbytes = idx.numel() * 2 + val.numel() + scl.numel() * 4 + C * 4 + N_ROBERTA * 4 + C * 4
    flops = 4 * C * nb * kb  # per entry: dequantise, square-add (2), weight, add
    bound, bound_by = bound_of(nbytes, flops)
    ms, runs = median_windows(
        lambda: decode_accum(idx, val, scl, w, size=N_ROBERTA, block=CODEC_BLOCK), iters=20)
    plain, plain_runs = median_windows(
        lambda: decode_accum_plain(idx, val, scl, w, size=N_ROBERTA, block=CODEC_BLOCK),
        iters=3, warmup=1)
    print(f"[time] decode_accum C={C} nb={nb} kb={kb} on {card}: kernel_ms {ms:.4f} "
          f"(windows {[round(r, 4) for r in runs]}), bound_ms {bound:.4f} "
          f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), kernel/bound {ms / bound:.2f}x, "
          f"plain_ms {plain:.4f} (windows {[round(r, 3) for r in plain_runs]})")
    print("[time] decode_accum library_ms: none — no single PyTorch call computes the "
          "weighted scatter acc and the per-row sq together")
    return ms, plain, bound, bound_by


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
    built = _build.build_all(KERNELS)
    print(f"[build] {len(KERNELS)} sources, one nvcc each, started together: "
          f"{time.perf_counter() - t0:.1f} s")
    for kernel in KERNELS:
        b = built[kernel]
        took = f"nvcc {b.seconds:.1f} s" if b.seconds else "built earlier in this checkout"
        print(f"[build] {kernel}.cu -> {b.path.name}: {took}")
        for line in ptxas_summary(b.log):
            print(f"  ptxas {line}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs, max_err = phase_kernel_checks(gen)
    ms, plain_ms, bound_ms, bound_by = phase_timing(inputs, smi)
    del inputs
    torch.cuda.empty_cache()
    dec_inputs, dec_err = phase_decode_checks(gen)
    dec = phase_decode_timing(dec_inputs, smi)
    del dec_inputs
    torch.cuda.empty_cache()
    sk_row, sk_err = phase_sketch_checks(gen)
    sk = phase_sketch_timing(sk_row, smi)
    del sk_row
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        phase_small_agreement()
        phase_small_service(workdir)

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        phase_main_path()
        loop = launches()
        print(f"[main] launches on the ColD Fusion loop: {loop}")
        check(loop["cold_fuse"] >= 4,
              f"cold_fuse launched {loop['cold_fuse']} times on the loop, expected >= 4")
        print(f"[main] torch.cuda.max_memory_allocated: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    print(f"[done] {time.perf_counter() - t0:.1f} s after the card check")

    def record(name, replaces, err, timing):
        k_ms, k_plain, k_bound, k_by = timing
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": counts[name], "max_abs_err": err,
                "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound, "bound_by": k_by,
                "library_ms": None}

    print(json.dumps({"kernels": [
        record("cold_fuse", "src/repro/kernels/cold_fuse.py:61", max_err,
               (ms, plain_ms, bound_ms, bound_by)),
        record("decode_accum", "src/repro/kernels/cold_fuse.py:170", dec_err, dec),
        record("row_sketch", "src/repro/kernels/cold_fuse.py:253", sk_err, sk)]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
