#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases (any failed check raises, so the script exits non-zero):

1. the card: name, count, and ``nvidia-smi``'s name and power limit;
2. build every kernel of the main path from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (time, and ptxas' registers and spills per kernel);
3. each kernel against its plain PyTorch version on the card, at the main
   path's shape (K=5 x N=123,969,792 bf16, one NaN row of weight 0,
   alpha 1.0 and 0.3) and on ragged shapes;
4. kernel and plain-version times (CUDA events, after a warm-up) beside the
   kernel's bound;
5. a small-input check: the same screen + fuse on the card and on the CPU
   (whose path the CPU tests hold against the JAX package) must agree;
6. the main path, through the entry points a user calls: a Repository over
   a RoBERTa-base body at full width (random weights from a seed), two
   ColD Fusion iterations of 4 contributors x 3 finetune steps, an
   adversarial cohort (3 honest, one NaN, one runaway upload) that must
   fuse 3/5, and a frozen-probe evaluation.  Kernel launch counters are set
   to 0 just before and read just after.

The last lines are the kernels' JSON record, ``nvidia-smi``'s line and
``{"ok": true, "device": {...}}``.  Without a card (or without the rest of
the repository beside it) the script exits non-zero and prints no result.
"""
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import CONFIG, TINY  # noqa: E402
from repro_torch.core import (Contributor, EvalTask, Repository,  # noqa: E402
                              evaluate_base_model, run_cold_fusion)
from repro_torch.data.synthetic import SyntheticSuite  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cold_fuse import cold_fuse, cold_fuse_plain  # noqa: E402
from repro_torch.models.encoder import init_encoder_body  # noqa: E402
from repro_torch.utils.flat import FlatSpec  # noqa: E402
from repro_torch.utils.pytree import tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
N_ROBERTA = 123_969_792     # elements of the RoBERTa-base body (FlatSpec.size)
K_MAIN = 5


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
    built = _build.build("cold_fuse")
    took = f"nvcc {built.seconds:.1f} s" if built.seconds else "built earlier in this checkout"
    print(f"[build] cold_fuse.cu -> {built.path.name}: {took}")
    for line in ptxas_summary(built.log):
        print(f"  ptxas {line}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs, max_err = phase_kernel_checks(gen)
    ms, plain_ms, bound_ms, bound_by = phase_timing(inputs, smi)
    del inputs
    torch.cuda.empty_cache()
    phase_small_agreement()

    torch.cuda.reset_peak_memory_stats()
    cold_fuse.launches = 0
    phase_main_path()
    launches = cold_fuse.launches
    print(f"[main] cold_fuse launches on the main path: {launches}")
    check(launches >= 4, f"cold_fuse launched {launches} times on the main path, expected >= 4")
    print(f"[main] torch.cuda.max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[done] {time.perf_counter() - t0:.1f} s after the card check")

    print(json.dumps({"kernels": [{
        "name": "cold_fuse", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cold_fuse.cu",
        "replaces": "src/repro/kernels/cold_fuse.py:61",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
