"""Fault-injection points for kill-at-checkpoint tests (port of
``repro.utils.faults``, same environment variable, exit code and seam
names, so one harness can drive either package).

A *crash point* is a named seam in a durability-critical sequence (queue
admit, fuse dispatch, base publish, manifest rewrite).  In production the
hooks are one-comparison no-ops; a test arms exactly one point by exporting
``REPRO_CRASH_POINT=<name>`` in a child process, and the child dies there
with ``os._exit`` — no cleanup, no atexit, no flushing.

The armed name is read once at import: children receive the variable
before the interpreter starts, and a hot-path hook must not pay a getenv
per call.

Seams in the port: ``client.mid_submit``, ``service.post_route``,
``service.post_ingest``, ``service.post_sketch``,
``service.post_dispatch``, ``service.post_publish``,
``service.post_probe``, ``service.post_quarantine``, ``service.mid_gc``,
``repo.post_publish_pre_manifest``, ``repo.mid_rollback``,
``repo.post_family_spawn``, and the hot-swap worker's three:
``worker.pre_transfer`` (before the next base is loaded),
``worker.post_transfer_pre_flip`` (resident, the pointer not yet flipped)
and ``worker.post_flip`` (flipped, the serving state not yet persisted).
"""
from __future__ import annotations

import os
import sys

ENV = "REPRO_CRASH_POINT"
EXIT_CODE = 17  # distinguishes an armed crash from ordinary failures

_ARMED = os.environ.get(ENV)


def crash_point(name: str) -> None:
    """Die abruptly iff this point is the armed one (no-op otherwise)."""
    if _ARMED is not None and _ARMED == name:
        print(f"CRASH_POINT {name}", file=sys.stderr, flush=True)
        os._exit(EXIT_CODE)
