"""ColD Fusion as an always-on service on the PyTorch port
(``src/repro_torch``): a fusion daemon + N contributor processes recycling
"finetuned" models through the durable contribution queue; the twin of
``cold_service_demo.py`` (docs/service_loop.md).

The coordinator (``--role driver``) initializes an on-disk repository,
launches the daemon (``python -m repro_torch.launch.serve_repository``)
and ``--contributors`` independent contributor subprocesses.  Each contributor loops for
``--rounds``: wait for the base of its round to publish, download it,
apply a deterministic "finetune" delta, and submit — so the run is fully
checkable: the coordinator verifies the final base against the closed-form
expectation and reports queue throughput.

  PYTHONPATH=src python examples/cold_service_demo_torch.py [--device cpu]
  PYTHONPATH=src python examples/cold_service_demo_torch.py --duplicates 1  # novelty screen
  PYTHONPATH=src python examples/cold_service_demo_torch.py --compress  # delta codec

``--device`` defaults to ``cuda``: the daemon fuses on the card and every
contributor downloads its base there (each raises without a card unless
``--device cpu``).  The reference's ``--mesh`` is refused, as the port's
launcher refuses it: the multi-device path is not ported yet.

With ``--compress`` every contributor enqueues its round as a
delta-compressed submission (top-k int8 payload against the base it just
downloaded) instead of a dense row; the daemon decodes it in the
``decode_accum`` kernel and the coordinator checks the same closed form —
compression must be invisible to the result.

``--duplicates D`` additionally launches D *shadow* contributors, each
replaying contributor 0's exact submission every round under its own
name, and arms the daemon's content-based novelty screen
(``--novelty-threshold``).  The coordinator then verifies the planted
near-duplicates were all rejected at the queue boundary while every
distinct contribution was admitted.

``--regress R`` launches R *saboteur* contributors and arms the daemon's
forgetting regression gate (``--gate``).  Each saboteur waits for the last
benign round to publish, then submits a full cohort of large-noise rows;
the coordinator verifies the gate rolled every harmful publish back on disk (the
final base still matches the closed form), moved every planted row into
``<root>/quarantine/``, and logged the verdicts to ``metrics.jsonl``.

``--tasks T`` runs T *dissimilar* contributor streams against a routed
multi-base daemon (``--max-bases``): each task's finetune delta carries a
distinct per-lane-tile sign pattern, every contributor declares
``family="main"`` in round 0 and then follows wherever the sketch router
sent it (``route_of``).  The coordinator verifies the streams separate: exactly
T family members, each close to the closed-form fuse of only its own
task's stream, then runs one in-process ``cross_fuse`` and checks every
member lands on the closed-form inter-family average.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

import numpy as np  # noqa: E402
import torch  # noqa: E402

W, B = 2048, 17  # tiny deterministic base: every element moves identically
LANE = 1024      # repro_torch.utils.flat.LANE — the sketch's bucket granularity


def _expected_w(contributors: int, rounds: int) -> float:
    """w starts at 0; round r adds mean_c((c+1) * 0.1 * (r+1))."""
    mean_c = sum(c + 1 for c in range(contributors)) / contributors
    return sum(0.1 * (r + 1) * mean_c for r in range(rounds))


def _task_pattern(t: int):
    """Task t's finetune direction: alternating per-LANE-tile signs on w
    (offset by t, so adjacent tasks are near-orthogonal in every sketch
    bucket), all-positive b.  Signs must be constant per tile — random
    per-element signs would cancel inside the sketch's bucket sums and
    make every task look alike to the router."""
    w = np.ones((W,), np.float32)
    for j in range((W + LANE - 1) // LANE):
        if (j + t) % 2:
            w[j * LANE:(j + 1) * LANE] = -1.0
    return {"w": w, "b": np.ones((B,), np.float32)}


def _on(tree, device):
    """A numpy tree as f32 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device) for k, v in tree.items()}


def contributor_main(args) -> int:
    from repro_torch.serve.cold_service import ContributorClient
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.pytree import tree_map

    device = resolve_device(args.device)

    if args.regressor:
        # the saboteur: wait for every benign round to land, then submit a
        # full cohort of large-noise rows.  All the rows' diff norms agree,
        # so the §9 MAD screen admits them; the noise wrecks the probe
        # readouts, so the regression gate must roll the publish back and
        # quarantine every row (docs/observability.md).
        name = f"bad{args.index}"
        client = ContributorClient(args.root, name=name)
        client.wait_for_iteration(args.rounds, timeout=args.timeout)
        base = client.download_base(device=device)
        for j in range(args.contributors):
            rng = np.random.default_rng((4242, args.index, j))
            harmful = tree_map(
                lambda x: x + torch.from_numpy(
                    rng.normal(0.0, 10.0, tuple(x.shape)).astype(np.float32)).to(x),
                base)
            sub = client.submit(harmful, weight=1.0,
                                base_iteration=args.rounds)
            print(f"[{name}] submitted harmful row {sub}", flush=True)
        return 0

    if args.tasks > 1:
        # a routed-stream contributor: round 0 declares main (the base is
        # all-zeros, so the finetune IS the task-patterned delta) and then
        # follows wherever the router actually sent it — the member name
        # is discovered from the status routes ring, never assumed.
        t, c = args.task, args.index
        name = f"t{t}c{c}"
        client = ContributorClient(args.root, name=name)
        pat = _task_pattern(t)
        home = "main"
        for r in range(args.rounds):
            delta = (c + 1) * 0.1 * (r + 1)
            if r == 0:
                client.wait_for_iteration(0, timeout=args.timeout)
                finetuned = _on({k: delta * v for k, v in pat.items()}, device)
                sub = client.submit(finetuned, weight=1.0, base_iteration=0,
                                    family="main")
                deadline = time.time() + args.timeout
                route = None
                while route is None and time.time() < deadline:
                    route = client.route_of(sub)
                    if route is None:
                        time.sleep(0.05)
                if route is None:
                    print(f"[{name}] round-0 route never landed", flush=True)
                    return 1
                home = route["family"]
            else:
                client.wait_for_family(home, r, timeout=args.timeout)
                base = client.download_base(family=home, device=device)
                finetuned = {k: base[k] + torch.from_numpy(delta * pat[k]).to(device)
                             for k in pat}
                sub = client.submit(finetuned, weight=1.0, base_iteration=r,
                                    family=home)
            print(f"[{name}] round {r}: submitted {sub} -> {home} "
                  f"(delta=+{delta:.2f})", flush=True)
        return 0

    # a shadow contributor replays contributor --shadow-of's round-r
    # finetune under its own name: content the novelty screen must reject,
    # submission ids it must not.  The replay is rebuilt from the run's
    # closed form rather than download_base() — the real base may already
    # have advanced past round r by the time a slow shadow downloads, and a
    # replay against the wrong base would be genuinely novel content.
    shadow = args.shadow_of is not None
    index = args.shadow_of if shadow else args.index
    name = f"dup{args.index}" if shadow else f"c{args.index}"
    client = ContributorClient(args.root, name=name)
    for r in range(args.rounds):
        # a shadow replays round r only once round r has FUSED (iteration
        # r+1 published): the original's row is then guaranteed to be in
        # the novelty screen's window, so the replay is deterministically
        # the duplicate.  Replaying as soon as round r opens can win the
        # race instead — the replay is admitted as novel and the original
        # rejected, and the original's NEXT round then re-finetunes a
        # newer base, leaving a genuinely-novel row staged forever.
        st = client.wait_for_iteration(r + 1 if shadow else r,
                                       timeout=args.timeout)
        delta = (index + 1) * 0.1 * (r + 1)
        if shadow:
            val = _expected_w(args.contributors, r) + delta
            finetuned = _on({"w": np.full((W,), val, np.float32),
                             "b": np.full((B,), val, np.float32)}, device)
        else:
            base = client.download_base(device=device)
            finetuned = tree_map(lambda x: x + delta, base)
        if args.compress and not shadow:
            # a uniform finetune delta has every entry live, so keep the
            # whole block (k_per_block=LANE) — the only loss is int8
            # quantization, invisible at the coordinator's closed-form atol
            from repro_torch.utils.flat import LANE
            sub = client.submit(finetuned, weight=1.0, base_iteration=r,
                                compress=True, base=base, k_per_block=LANE)
        else:
            sub = client.submit(finetuned, weight=1.0, base_iteration=r)
        print(f"[{name}] round {r}: submitted {sub} "
              f"(delta=+{delta:.2f}{' REPLAY' if shadow else ''}"
              f"{' COMPRESSED' if args.compress and not shadow else ''})",
              flush=True)
    return 0


def _routed_checks(args, root, st, elapsed) -> int:
    """Verify the routed run separated: exactly --tasks members, each
    bit-close to the closed-form fuse of only its own task's stream
    (membership decided by CONTENT, not by name — which stream ends up on
    'main' depends on arrival order), then one in-process cross-fuse
    round landing every member on the inter-family average."""
    from repro_torch.checkpoint import io as ckpt
    from repro_torch.core.repository import RepositoryFamily, family_member_root

    fams = st.get("families") or {}
    want_w = _expected_w(args.contributors, args.rounds)
    per_member = args.contributors * args.rounds
    ok = len(fams) == args.tasks
    if not ok:
        print(f"[demo] expected {args.tasks} members, have {sorted(fams)}",
              flush=True)
    got = {}
    for n, f in sorted(fams.items()):
        ok = ok and (f["iteration"] == args.rounds
                     and f["fused_contributions"] == per_member)
        got[n] = {k: v.numpy() for k, v in ckpt.load(os.path.join(
            family_member_root(root, n),
            f"base_iter{f['iteration']:04d}.npz")).items()}
    matched = {}
    for t in range(args.tasks):
        want = {k: want_w * v for k, v in _task_pattern(t).items()}
        hits = [n for n, bb in got.items()
                if all(np.allclose(np.asarray(bb[k]), want[k], atol=1e-5)
                       for k in want)]
        if len(hits) == 1:
            matched[t] = hits[0]
        else:
            print(f"[demo] task {t}: want exactly one member at closed "
                  f"form, matched {hits}", flush=True)
            ok = False
    ok = ok and len(set(matched.values())) == args.tasks
    cross_ok = False
    if ok:
        # one inter-cluster merge round: every member must land exactly on
        # the mean of the pre-cross bases (closed form of cross_fuse at
        # alpha=1), one iteration further on
        pre = {n: {k: np.asarray(v) for k, v in bb.items()}
               for n, bb in got.items()}
        RepositoryFamily.open(root, device=args.device).cross_fuse()
        mean = {k: np.mean([bb[k] for bb in pre.values()], axis=0)
                for k in ("w", "b")}
        cross_ok = True
        for n in fams:
            bb = ckpt.load(os.path.join(
                family_member_root(root, n),
                f"base_iter{args.rounds + 1:04d}.npz"))
            cross_ok = cross_ok and all(
                np.allclose(bb[k].numpy(), mean[k], atol=1e-5)
                for k in mean)
        ok = ok and cross_ok
    print(f"[demo] {args.tasks} tasks x {args.contributors} contributors x "
          f"{args.rounds} rounds -> members {sorted(fams)} "
          f"({st.get('families_spawned_total', 0)} spawned), "
          f"task->member {matched}, "
          f"{st['fused_contributions']} contributions fused in "
          f"{elapsed:.1f}s", flush=True)
    print(f"[demo] separation + cross-fuse -> "
          f"{'OK' if ok else 'MISMATCH'}", flush=True)
    return 0 if ok else 1


def driver_main(args) -> int:
    from repro_torch.checkpoint import io as ckpt
    from repro_torch.serve.cold_service import ContributorClient

    root = args.root or tempfile.mkdtemp(prefix="cold_service_demo_")
    os.makedirs(root, exist_ok=True)
    base_npz = os.path.join(root, "seed_base.npz")
    ckpt.save(base_npz, {"w": np.zeros((W,), np.float32),
                         "b": np.zeros((B,), np.float32)})

    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    daemon_cmd = [
        sys.executable, "-m", "repro_torch.launch.serve_repository",
        "--root", root, "--init-npz", base_npz, "--device", args.device,
        "--min-cohort", str(args.contributors), "--poll", "0.02",
    ]
    routed = args.tasks > 1
    # drain mode: the daemon gets NO --max-iterations, because a
    # counter the coordinator asserts on can land *after* the stop condition —
    # the --duplicates flake was exactly that race (the replayer's last
    # planted near-duplicate raced the final round's publish, so the
    # daemon quiesced with novelty_rejected_total one short).  Instead
    # the coordinator polls status until every asserted counter reaches its
    # closed form AND the queue is fully drained, then asks for a clean
    # shutdown; the idle timeout is only a backstop.
    drain = not args.regress and (routed or args.duplicates > 0)
    if args.regress:
        # no --max-iterations: the daemon would quiesce at the benign fixed
        # point (iteration == rounds, empty queue) before the saboteurs'
        # rows arrive — and after a rollback it sits there again.  The
        # coordinator watches status for the gate verdict and asks for a clean
        # shutdown; the idle timeout is only a backstop.
        daemon_cmd += ["--gate", "--idle-timeout", str(args.timeout)]
    elif drain:
        daemon_cmd += ["--idle-timeout", str(args.timeout)]
    else:
        daemon_cmd += ["--max-iterations", str(args.rounds),
                       "--idle-timeout", "30"]
    if routed:
        max_bases = (args.max_bases if args.max_bases is not None
                     else args.tasks + 1)
        daemon_cmd += ["--max-bases", str(max_bases)]
    if args.duplicates:
        # planted replays ride the queue alongside the real contributors;
        # the novelty screen must keep them out of every cohort
        daemon_cmd += ["--novelty-threshold", "0.1",
                       "--sketch-window",
                       str(4 * (args.contributors + args.duplicates))]

    def _spawn(i, shadow_of=None, regressor=False, task=None):
        cmd = [sys.executable, os.path.abspath(__file__),
               "--role", "contributor", "--root", root, "--index", str(i),
               "--contributors", str(args.contributors),
               "--rounds", str(args.rounds), "--timeout", str(args.timeout),
               "--device", args.device]
        if shadow_of is not None:
            cmd += ["--shadow-of", str(shadow_of)]
        if regressor:
            cmd += ["--regressor"]
        if args.compress:
            cmd += ["--compress"]
        if task is not None:
            cmd += ["--tasks", str(args.tasks), "--task", str(task)]
        return subprocess.Popen(cmd, env=env)

    def _wait(name, proc):
        try:
            rc = proc.wait(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "timeout"
        if rc != 0:
            print(f"[demo] {name} FAILED (rc={rc})", flush=True)
        return rc != 0

    t0 = time.time()
    daemon = subprocess.Popen(daemon_cmd, env=env)
    if routed:
        workers = [(f"t{t}c{i}", _spawn(i, task=t))
                   for t in range(args.tasks)
                   for i in range(args.contributors)]
    else:
        workers = [(f"c{i}", _spawn(i)) for i in range(args.contributors)]
        workers += [(f"dup{i}", _spawn(i, shadow_of=i % args.contributors))
                    for i in range(args.duplicates)]
        workers += [(f"bad{i}", _spawn(i, regressor=True))
                    for i in range(args.regress)]
    failed = any([_wait(name, proc) for name, proc in workers])
    if drain:
        # every submission is on the queue; wait for the daemon to have
        # fully processed them — every member at its final iteration,
        # every planted replay rejected, nothing queued/staged/in flight —
        # before asking it to quiesce (the closed-form checks below only
        # hold once the drain condition does)
        client = ContributorClient(root)
        n_dup = args.duplicates * args.rounds
        deadline = time.time() + args.timeout
        while not failed and time.time() < deadline:
            st = client.status()
            if st is not None:
                fams = st.get("families") or {}
                settled = (len(fams) == args.tasks
                           and all(f["iteration"] >= args.rounds
                                   for f in fams.values())
                           if routed else st["iteration"] >= args.rounds)
                if (settled and st["queue_depth"] == 0 and st["staged"] == 0
                        and not st["inflight"]
                        and st["novelty_rejected_total"] == n_dup):
                    break
            time.sleep(0.1)
        else:
            if not failed:
                print("[demo] daemon never drained", flush=True)
                failed = True
        daemon.terminate()
    if args.regress:
        # every saboteur row is in the queue; wait for the gate to finish
        # quarantining them all, then ask the daemon to quiesce
        client = ContributorClient(root)
        want_q = args.regress * args.contributors
        deadline = time.time() + args.timeout
        while not failed and time.time() < deadline:
            st = client.status()
            if (st is not None and st["quarantined_total"] == want_q
                    and st["iteration"] == args.rounds
                    and st["queue_depth"] == 0):
                break
            time.sleep(0.1)
        else:
            if not failed:
                print("[demo] gate verdict never landed", flush=True)
                failed = True
        daemon.terminate()
    failed |= _wait("daemon", daemon)
    elapsed = time.time() - t0
    if failed:
        return 1

    st = ContributorClient(root).status()
    if routed:
        return _routed_checks(args, root, st, elapsed)
    want_w = _expected_w(args.contributors, args.rounds)
    got = {k: v.numpy() for k, v in ckpt.load(os.path.join(
        root, f"base_iter{st['iteration']:04d}.npz")).items()}
    n_contrib = args.contributors * args.rounds
    n_dup = args.duplicates * args.rounds
    ok = (st["iteration"] == args.rounds
          and st["fused_contributions"] == n_contrib
          and np.allclose(np.asarray(got["w"]), want_w, atol=1e-5)
          and np.allclose(np.asarray(got["b"]), want_w, atol=1e-5))
    if args.duplicates:
        # every planted replay was screened out at the queue boundary
        # (exactly one of each identical-content pair fused, so the base
        # check above already proves none slipped through)
        ok = ok and st["novelty_rejected_total"] == n_dup
    if args.regress:
        # the base check above already proves every harmful publish was
        # rolled back on disk; here: every planted row sits in quarantine
        # (never deleted, never re-fused) and the verdicts were logged
        from repro_torch.checkpoint.io import read_jsonl
        n_bad = args.regress * args.contributors
        qdir = os.path.join(root, "quarantine")
        qfiles = os.listdir(qdir) if os.path.isdir(qdir) else []
        events = [r.get("event") for r in
                  read_jsonl(os.path.join(root, "metrics.jsonl"))]
        ok = (ok and st["quarantined_total"] == n_bad
              and len(qfiles) == n_bad
              and st["rollbacks_total"] >= 1
              and (args.regress > 1 or st["rollbacks_total"] == 1)
              and "quarantine" in events and "rollback" in events)
        print(f"[demo] gate: {st['rollbacks_total']} rollbacks, "
              f"{st['quarantined_total']}/{n_bad} harmful rows quarantined, "
              f"{len(events)} metrics records", flush=True)
    print(f"[demo] {args.contributors} contributors x {args.rounds} rounds "
          f"(+{args.duplicates} replayers) -> iteration {st['iteration']}, "
          f"{st['fused_contributions']} contributions fused, "
          f"{st['novelty_rejected_total']} near-duplicates rejected in "
          f"{elapsed:.1f}s ({n_contrib / elapsed:.1f} contrib/s end-to-end)",
          flush=True)
    print(f"[demo] final base w={float(np.asarray(got['w'])[0]):.4f} "
          f"(expected {want_w:.4f}) -> {'OK' if ok else 'MISMATCH'}", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--role", choices=("driver", "contributor"), default="driver")
    p.add_argument("--root", default=None)
    p.add_argument("--contributors", type=int, default=2)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="where the daemon and the contributors run (cuda, cpu)")
    # refused below, as the port's launcher refuses it
    p.add_argument("--mesh", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--duplicates", type=int, default=0,
                   help="launch this many replaying shadow contributors and "
                        "arm the daemon's novelty screen against them")
    p.add_argument("--regress", type=int, default=0,
                   help="launch this many harmful saboteur contributors and "
                        "arm the daemon's forgetting regression gate")
    p.add_argument("--compress", action="store_true",
                   help="contributors enqueue delta-compressed submissions "
                        "(top-k int8 vs their downloaded base) instead of "
                        "dense rows")
    p.add_argument("--tasks", type=int, default=1,
                   help="run this many dissimilar contributor streams "
                        "against a routed multi-base daemon and verify "
                        "they separate (1 = the single-base demo)")
    p.add_argument("--max-bases", type=int, default=None,
                   help="family member cap for the routed daemon "
                        "(default: --tasks + 1)")
    p.add_argument("--timeout", type=float, default=180.0)
    p.add_argument("--index", type=int, default=0, help="(contributor role)")
    p.add_argument("--task", type=int, default=0,
                   help="(contributor role) task stream index")
    p.add_argument("--shadow-of", type=int, default=None,
                   help="(contributor role) replay this index's submissions")
    p.add_argument("--regressor", action="store_true",
                   help="(contributor role) submit a harmful cohort after "
                        "the benign rounds finish")
    args = p.parse_args(argv)
    if args.mesh:
        p.error("--mesh (the multi-device slice) is not ported yet")
    if args.tasks > 1 and (args.duplicates or args.regress or args.compress):
        p.error("--tasks > 1 does not combine with "
                "--duplicates/--regress/--compress")
    if args.role == "contributor":
        return contributor_main(args)
    return driver_main(args)


if __name__ == "__main__":
    sys.exit(main())
