"""Launch the queue-driven fusion daemon over an on-disk repository (port of
``repro.launch.serve_repository``).

Opens (or initialises) a spill-enabled Repository at ``--root`` on
``--device`` (default ``cuda``; the daemon raises without a card unless
``--device cpu`` is given), wraps it in a ``ColdService`` and polls the
contribution queue until SIGINT/SIGTERM (clean quiesce), ``--max-iterations``
(every family member) or ``--idle-timeout`` seconds without progress.
``--max-bases B`` above 1 opens (or creates, or migrates in place) a
``RepositoryFamily`` instead and routes each submission to its nearest
member by sketch distance, spawning one beyond ``--split-threshold``.

  # serve an existing repository (written by either package)
  PYTHONPATH=src python -m repro_torch.launch.serve_repository --root repo/

  # initialise from a base checkpoint, fuse cohorts of >= 2, stop after 3
  PYTHONPATH=src python -m repro_torch.launch.serve_repository --root repo/ \\
      --init-npz base.npz --min-cohort 2 --max-iterations 3

  # gate every publish, keep two bases on disk, write rows on two threads
  PYTHONPATH=src python -m repro_torch.launch.serve_repository --root repo/ \\
      --gate --compact-keep 2 --spill-workers 2

  # route over a family of up to 3 bases, cross-fuse after every 4 publishes
  PYTHONPATH=src python -m repro_torch.launch.serve_repository --root repo/ \\
      --max-bases 3 --split-threshold 0.8 --cross-fuse-every 4

``--serve-arch NAME`` also serves the evolving base in this process: a
hot-swap ``ServingWorker`` subscribed to the repository's publishes keeps an
``Engine`` (NAME's reduced config; the repository's base must be that
config's parameter tree) on the latest published base, on the repository's
device, and writes ``serving_state.json`` and swap records beside the
daemon's status.  ``--serve-workers N`` serves from N worker processes
instead (``serve/worker_pool.py``, each on ``--device`` with its own
``serving_state-<id>.json``, following the root cross-process);
``--serve-batch`` gives each of them a ``BatchScheduler`` and
``--serve-queue-depth`` bounds its queue.  ``status()`` aggregates every
worker's state file.

  # fuse and serve on the CPU (the root holds a reduced gemma3-1b tree)
  PYTHONPATH=src python -m repro_torch.launch.serve_repository --root repo/ \
      --device cpu --serve-arch gemma3-1b --serve-workers 2 --serve-batch

``--mesh N`` opens the repository on an N-shard ``("model",)`` mesh of
``--device`` (``launch.mesh.make_mesh``): the sharded fuse, sketch and
per-shard spill files.  Shard ``i`` sits on card ``i % cards``, so with
fewer cards than shards several shards share a card; ``--device cpu`` puts
every shard on the CPU, as the reference's fake CPU devices do.

  # the sharded daemon on the CPU, as the reference's CI runs it
  PYTHONPATH=src python -m repro_torch.launch.serve_repository --root repo/ \
      --device cpu --mesh 8 --min-cohort 2

``REPRO_HOST_TUNING=1`` applies the opt-in host tuning
(``launch/host_tuning.py``): the tcmalloc preload where it is installed
(the daemon re-executes itself once to pick it up) and the same environment
for the pool children.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys

from repro_torch.checkpoint import io as ckpt
from repro_torch.core.repository import Repository, RepositoryFamily
from repro_torch.launch import host_tuning
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve.cold_service import AdmissionPolicy, ColdService
from repro_torch.serve.probes import ProbeSuite, RegressionGate
from repro_torch.utils.device import resolve_device

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="queue-driven ColD Fusion daemon (PyTorch port)")
    p.add_argument("--root", required=True, help="repository npz root")
    p.add_argument("--init-npz", default=None,
                   help="base checkpoint to initialise a NEW repository from")
    p.add_argument("--device", default="cuda", help="where the repository lives (cuda, cpu)")
    p.add_argument("--fusion-op", default="average")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="open on an N-shard mesh of --device (sharded fuse; shards share "
                        "a card where there are fewer cards)")
    p.add_argument("--no-screen", action="store_true",
                   help="disable the §9 MAD screen (new repositories only)")
    p.add_argument("--spill-workers", type=int, default=0,
                   help="threads that write staged rows and published bases")
    p.add_argument("--min-cohort", type=int, default=1)
    p.add_argument("--max-cohort", type=int, default=64)
    p.add_argument("--max-wait", type=float, default=0.0,
                   help="fuse an undersized cohort after this many seconds")
    p.add_argument("--max-staleness", type=int, default=None,
                   help="reject dense submissions finetuned from a base more than this "
                        "many iterations old")
    p.add_argument("--verify-checksums", action="store_true")
    p.add_argument("--novelty-threshold", type=float, default=None, metavar="D",
                   help="reject submissions whose content sketch sits within this relative "
                        "distance of a recent admission (default off)")
    p.add_argument("--sketch-window", type=int, default=32,
                   help="recent admissions the novelty screen remembers")
    p.add_argument("--compact-keep", type=int, default=None, metavar="M",
                   help="compact after each publish, keeping M bases")
    p.add_argument("--max-bases", type=int, default=1, metavar="B",
                   help="serve a base family of up to B members, routing each submission "
                        "to its nearest base by sketch distance (default 1: one base)")
    p.add_argument("--split-threshold", type=float, default=0.8, metavar="D",
                   help="relative sketch distance beyond which a submission founds a new "
                        "family member (--max-bases > 1)")
    p.add_argument("--cross-fuse-every", type=int, default=0, metavar="K",
                   help="after every K member publishes, fuse the family members into "
                        "each other (0: never)")
    p.add_argument("--gate", action="store_true",
                   help="arm the forgetting regression gate: probe every publish against "
                        "the last known-good base; on a regression, quarantine the cohort "
                        "and roll the base back")
    p.add_argument("--probe-tasks", type=int, default=4,
                   help="synthetic tasks in the gate's probe suite")
    p.add_argument("--probe-examples", type=int, default=32,
                   help="eval examples per probe task")
    p.add_argument("--probe-tolerance", type=float, default=0.5, metavar="T",
                   help="per-task probe-loss increase that counts as a regression")
    p.add_argument("--probe-seed", type=int, default=0,
                   help="seed fixing the probe batches and readouts")
    p.add_argument("--poll", type=float, default=0.02, metavar="S",
                   help="idle poll interval (seconds)")
    p.add_argument("--max-iterations", type=int, default=None,
                   help="stop once this base iteration is published")
    p.add_argument("--idle-timeout", type=float, default=None,
                   help="stop after this many seconds without progress")
    p.add_argument("--serve-arch", default=None, metavar="NAME",
                   help="also serve the evolving base: run a hot-swap ServingWorker for this "
                        "arch (reduced config; the repository base must be that arch's "
                        "parameter tree)")
    p.add_argument("--serve-max-len", type=int, default=64,
                   help="serving engine KV-cache length (--serve-arch)")
    p.add_argument("--serve-workers", type=int, default=0, metavar="N",
                   help="serve from N worker processes behind their own state files "
                        "(requires --serve-arch; 0: one in-process worker)")
    p.add_argument("--serve-batch", action="store_true",
                   help="coalesce compatible requests per worker with the BatchScheduler "
                        "(--serve-workers)")
    p.add_argument("--serve-queue-depth", type=int, default=64,
                   help="bounded per-worker request queue; overflow is shed as "
                        "rejected:queue_full (--serve-workers)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)
    if args.mesh < 0:
        p.error(f"--mesh must be >= 0, got {args.mesh}")
    if args.serve_workers and not args.serve_arch:
        p.error("--serve-workers requires --serve-arch")
    return args


def build_service(args) -> ColdService:
    device = resolve_device(args.device)
    kw = dict(spill=True, spill_workers=args.spill_workers)
    if args.mesh:
        kw["mesh"] = make_mesh((args.mesh,), ("model",), device=device)
    routed = args.max_bases > 1
    family = None
    if os.path.exists(os.path.join(args.root, "repository.json")):
        if routed:
            family = RepositoryFamily.open(args.root, device=device, **kw)
            repo = family.members["main"]
        else:
            repo = Repository.open(args.root, device=device, **kw)
    else:
        if not args.init_npz:
            raise SystemExit(f"{args.root} holds no repository.json — pass --init-npz to "
                             "initialise a new repository")
        base = ckpt.load(args.init_npz, device=device)
        init = dict(screen=not args.no_screen, fusion_op=args.fusion_op, **kw)
        if routed:
            family = RepositoryFamily.create(base, root=args.root, device=device, **init)
            repo = family.members["main"]
        else:
            repo = Repository(base, root=args.root, **init)
    policy = AdmissionPolicy(
        min_cohort=args.min_cohort,
        max_cohort=args.max_cohort,
        max_wait_s=args.max_wait,
        max_staleness=args.max_staleness,
        verify_checksums=args.verify_checksums,
        novelty_threshold=args.novelty_threshold,
        sketch_window=args.sketch_window,
        compact_keep_bases=args.compact_keep,
        max_bases=args.max_bases,
        split_threshold=args.split_threshold,
        cross_fuse_every=args.cross_fuse_every,
    )
    gate = None
    if args.gate:
        gate = RegressionGate(
            ProbeSuite(repo.flat_base().numel(), n_tasks=args.probe_tasks,
                       n_examples=args.probe_examples, seed=args.probe_seed),
            tolerance=args.probe_tolerance)
    if routed:
        return ColdService(family=family, policy=policy, gate=gate)
    return ColdService(repo, policy=policy, gate=gate)


def main(argv=None) -> int:
    args = parse_args(argv)
    svc = build_service(args)

    def _stop(signum, frame):
        svc.request_stop()

    worker = pool = None
    if args.serve_workers:
        from repro_torch.serve.worker_pool import WorkerPool
        pool = WorkerPool(svc.repo.root, args.serve_workers, arch=args.serve_arch,
                          device=args.device, max_len=args.serve_max_len, poll=args.poll,
                          batch=args.serve_batch, queue_depth=args.serve_queue_depth,
                          env=host_tuning.host_tuning_env() if host_tuning.enabled() else {})
        pool.start()
        print(f"[cold-service] {args.serve_workers} pool workers serving {args.serve_arch} on "
              f"{args.device} (max_len={args.serve_max_len}, batch={args.serve_batch}, "
              f"queue_depth={args.serve_queue_depth})", flush=True)
    elif args.serve_arch:
        from repro_torch.configs import get_config, reduce_config
        from repro_torch.serve.hot_swap import ServingWorker
        worker = ServingWorker(reduce_config(get_config(args.serve_arch)), svc.repo.root,
                               repo=svc.repo, max_len=args.serve_max_len)
        worker.start(interval=args.poll)
        print(f"[cold-service] hot-swap worker serving {args.serve_arch} on {worker.device} "
              f"(max_len={args.serve_max_len})", flush=True)

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    where = svc.repo.mesh if svc.repo.mesh is not None else svc.repo.device
    print(f"[cold-service] serving {args.root} on {where} from iteration "
          f"{svc.repo.iteration} (min_cohort={svc.policy.min_cohort})", flush=True)
    try:
        st = svc.serve_forever(poll_interval=args.poll, max_iterations=args.max_iterations,
                               idle_timeout=args.idle_timeout)
    finally:
        if worker is not None:
            ws = worker.stop()
            print(f"[cold-service] worker stopped at iteration {ws['iteration']}: "
                  f"{ws['swaps_total']} swaps ({ws['live_swaps']} live), "
                  f"{ws['requests_total']} requests ({ws['requests_pinned_across_swaps']} "
                  "pinned across swaps)", flush=True)
        if pool is not None:
            states = pool.states()
            codes = pool.stop()
            detail = ", ".join(f"{wid}@it{(s or {}).get('iteration')}"
                               f"({(s or {}).get('requests_total', 0)} req)"
                               for wid, s in sorted(states.items()))
            print(f"[cold-service] pool stopped (exit={codes}): {detail}", flush=True)
    fams = st.get("families")
    if fams:
        detail = ", ".join(f"{n}@it{f['iteration']}" for n, f in sorted(fams.items()))
        print(f"[cold-service] family: {detail} ({st['families_spawned_total']} spawned, "
              f"{st['cross_fuses_total']} cross-fuses)", flush=True)
    print(f"[cold-service] stopped at iteration {st['iteration']}: {st['fuses']} fuses, "
          f"{st['fused_contributions']} contributions fused, {st['rejected_total']} rejected "
          f"({st['novelty_rejected_total']} near-duplicates), {st['quarantined_total']} "
          f"quarantined, {st['rollbacks_total']} rollbacks", flush=True)
    return 0


if __name__ == "__main__":
    host_tuning.maybe_reexec()  # LD_PRELOAD acts only at process start
    sys.exit(main())
