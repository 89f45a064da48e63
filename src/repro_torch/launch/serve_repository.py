"""Launch the queue-driven fusion daemon over an on-disk repository (port of
``repro.launch.serve_repository``, single base, single device).

Opens (or initialises) a spill-enabled Repository at ``--root`` on
``--device`` (default ``cuda``; the daemon raises without a card unless
``--device cpu`` is given), wraps it in a ``ColdService`` and polls the
contribution queue until SIGINT/SIGTERM (clean quiesce), ``--max-iterations``
or ``--idle-timeout`` seconds without progress.

  # serve an existing repository (written by either package)
  PYTHONPATH=src python -m repro_torch.launch.serve_repository --root repo/

  # initialise from a base checkpoint, fuse cohorts of >= 2, stop after 3
  PYTHONPATH=src python -m repro_torch.launch.serve_repository --root repo/ \\
      --init-npz base.npz --min-cohort 2 --max-iterations 3

  # gate every publish, keep two bases on disk, write rows on two threads
  PYTHONPATH=src python -m repro_torch.launch.serve_repository --root repo/ \\
      --gate --compact-keep 2 --spill-workers 2

The reference's ``--mesh``, ``--max-bases`` above 1, ``--cross-fuse-every``
and the ``--serve-*`` flags are accepted by the parser only to be refused:
their paths are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys

from repro_torch.checkpoint import io as ckpt
from repro_torch.core.repository import Repository
from repro_torch.serve.cold_service import AdmissionPolicy, ColdService
from repro_torch.serve.probes import ProbeSuite, RegressionGate
from repro_torch.utils.device import resolve_device

# flags of the reference whose paths are not ported yet: dest -> what
_NOT_PORTED = {
    "mesh": "--mesh (the multi-device slice)",
    "serve_arch": "--serve-arch (the serving slice)",
    "serve_workers": "--serve-workers (the serving slice)",
    "serve_batch": "--serve-batch (the serving slice)",
    "cross_fuse_every": "--cross-fuse-every (routing)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="queue-driven ColD Fusion daemon (PyTorch port)")
    p.add_argument("--root", required=True, help="repository npz root")
    p.add_argument("--init-npz", default=None,
                   help="base checkpoint to initialise a NEW repository from")
    p.add_argument("--device", default="cuda", help="where the repository lives (cuda, cpu)")
    p.add_argument("--fusion-op", default="average")
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
                   help="base family size; only 1 (the single-base loop) is ported")
    p.add_argument("--split-threshold", type=float, default=0.8, metavar="D",
                   help="routing split distance (with --max-bases > 1, not ported)")
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
    # refused below: kept so a reference command line fails with a reason
    p.add_argument("--mesh", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--serve-arch", default=None, help=argparse.SUPPRESS)
    p.add_argument("--serve-workers", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--serve-batch", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--cross-fuse-every", type=int, default=0, help=argparse.SUPPRESS)
    return p


def parse_args(argv=None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)
    for dest, what in _NOT_PORTED.items():
        if getattr(args, dest):
            p.error(f"{what} is not ported yet")
    if args.max_bases > 1:
        p.error("--max-bases > 1 (similarity routing) is not ported yet")
    return args


def build_service(args) -> ColdService:
    device = resolve_device(args.device)
    kw = dict(spill=True, spill_workers=args.spill_workers)
    if os.path.exists(os.path.join(args.root, "repository.json")):
        repo = Repository.open(args.root, device=device, **kw)
    else:
        if not args.init_npz:
            raise SystemExit(f"{args.root} holds no repository.json — pass --init-npz to "
                             "initialise a new repository")
        repo = Repository(ckpt.load(args.init_npz, device=device), root=args.root,
                          screen=not args.no_screen, fusion_op=args.fusion_op, **kw)
    policy = AdmissionPolicy(
        min_cohort=args.min_cohort,
        max_cohort=args.max_cohort,
        max_wait_s=args.max_wait,
        max_staleness=args.max_staleness,
        verify_checksums=args.verify_checksums,
        novelty_threshold=args.novelty_threshold,
        sketch_window=args.sketch_window,
        compact_keep_bases=args.compact_keep,
    )
    gate = None
    if args.gate:
        gate = RegressionGate(
            ProbeSuite(repo.flat_base().numel(), n_tasks=args.probe_tasks,
                       n_examples=args.probe_examples, seed=args.probe_seed),
            tolerance=args.probe_tolerance)
    return ColdService(repo, policy=policy, gate=gate)


def main(argv=None) -> int:
    args = parse_args(argv)
    svc = build_service(args)

    def _stop(signum, frame):
        svc.request_stop()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    print(f"[cold-service] serving {args.root} on {svc.repo.device} from iteration "
          f"{svc.repo.iteration} (min_cohort={svc.policy.min_cohort})", flush=True)
    st = svc.serve_forever(poll_interval=args.poll, max_iterations=args.max_iterations,
                           idle_timeout=args.idle_timeout)
    print(f"[cold-service] stopped at iteration {st['iteration']}: {st['fuses']} fuses, "
          f"{st['fused_contributions']} contributions fused, {st['rejected_total']} rejected "
          f"({st['novelty_rejected_total']} near-duplicates), {st['quarantined_total']} "
          f"quarantined, {st['rollbacks_total']} rollbacks", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
