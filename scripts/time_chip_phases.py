#!/usr/bin/env python3
"""Run one checkout's ``chip_smoke.py`` with its phase functions timed.

    python3 scripts/time_chip_phases.py                   # this checkout's script
    python3 scripts/time_chip_phases.py --tree OTHER      # another checkout's

Imports the tree's ``chip_smoke`` (from the tree's root, which it makes the
working directory), wraps every ``phase_*`` function and the parts of a
phase named in ``PARTS`` so that each call prints ``[ptime] <name> <seconds>
s`` (indented by its depth) when it returns, runs ``chip_smoke.main()``, then
prints every call again as a ``[ptime-sum]`` line and the total.  For a tree
whose script prints no ``[phase]`` lines of its own: the wall seconds a
phase takes are those of its ``phase_*`` function (phases 9 and 10 add
``real_finetune_scores`` and ``time_cohort_fuse`` beside them).  Needs a
CUDA card; the exit code is the script's.
"""
import argparse
import functools
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("real_finetune_scores", "time_cohort_fuse", "pserve_model", "pmoe_serve",
         "pmoe_train", "cp_model", "cp_timing", "cpt_train", "cpt_serve_qwen",
         "cpt_slot_checks", "mesh_service", "serve_whisper", "train_whisper", "serve_qwen",
         "ring_cache", "mamba_layer_check", "train_and_serve", "serve_arch", "pool_run",
         "cold_whole", "cold_partitioned_sgd", "dryrun_serve", "dryrun_train", "dryrun_sweep",
         "run_twins", "serve_trained", "train_via_launcher", "pwhisper_train",
         "pwhisper_serve", "pwhisper_slot_checks", "cpw_slot_checks", "pgrid_slot_checks",
         "pgrid_train", "pgrid_serve")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs

    depth, rows = [0], []

    def timed(name, fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                seconds = time.perf_counter() - t0
                depth[0] -= 1
                rows.append((depth[0], name, seconds))
                print(f"[ptime] {'  ' * depth[0]}{name} {seconds:.1f} s", flush=True)
        return inner

    for name in [n for n in dir(cs) if n.startswith("phase_")] + list(PARTS):
        fn = getattr(cs, name, None)
        if callable(fn) and not isinstance(fn, type):
            setattr(cs, name, timed(name, fn))
    t0 = time.perf_counter()
    rc = cs.main()
    for d, name, seconds in rows:
        print(f"[ptime-sum] {'  ' * d}{name} {seconds:.1f}")
    print(f"[ptime] total {time.perf_counter() - t0:.1f} s, rc {rc}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
