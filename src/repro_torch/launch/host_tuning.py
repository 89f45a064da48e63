"""Opt-in host tuning for the port's serving and fusion processes (port of
``repro.launch.host_tuning``).

Preloading tcmalloc, where it is installed, takes glibc malloc's lock out
of the host's large short-lived allocations (codec scratch, npz reads and
writes, request buffers); ``TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD`` is
raised so steady large allocations do not fill stderr.  Everything here is
opt-in behind ``REPRO_HOST_TUNING=1`` and a no-op where the library is
absent.

``LD_PRELOAD`` acts only at process start, so ``host_tuning_env`` builds
an environment for child processes and ``maybe_reexec`` applies it to the
current process by re-executing it once.

The reference also forces XLA's count of fake CPU devices
(``device_count=``, ``--device-count``); the port's mesh names its devices
itself (``launch.mesh.make_mesh``, ``--mesh N``), so that knob is not
here and the CLI refuses ``--device-count``.

  # print the exports for a shell (nothing when tuning is off)
  REPRO_HOST_TUNING=1 PYTHONPATH=src python -m repro_torch.launch.host_tuning
"""
from __future__ import annotations

import argparse
import os
import shlex
import sys
from typing import Dict, Optional

ENV_FLAG = "REPRO_HOST_TUNING"
_APPLIED_MARKER = "REPRO_HOST_TUNING_APPLIED"

# well-known install paths, most specific first
TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)
LARGE_ALLOC_THRESHOLD = "60000000000"


def enabled(environ: Optional[Dict[str, str]] = None) -> bool:
    env = os.environ if environ is None else environ
    return env.get(ENV_FLAG, "") == "1"


def tcmalloc_path() -> Optional[str]:
    """The installed tcmalloc shared object, or None."""
    for path in TCMALLOC_CANDIDATES:
        if os.path.exists(path):
            return path
    return None


def host_tuning_env() -> Dict[str, str]:
    """Environment overrides for a child process: the tcmalloc preload and
    its report threshold when tcmalloc is installed, else ``{}``."""
    env: Dict[str, str] = {}
    lib = tcmalloc_path()
    if lib is not None:
        prior = os.environ.get("LD_PRELOAD", "")
        if lib not in prior.split(":"):
            env["LD_PRELOAD"] = f"{prior}:{lib}".strip(":")
        env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] = LARGE_ALLOC_THRESHOLD
    return env


def maybe_reexec() -> None:
    """With ``REPRO_HOST_TUNING=1``, re-execute the current process once
    with the tuned environment (the applied marker stops a second
    re-exec).  A no-op when tuning is off or nothing would change."""
    if not enabled() or os.environ.get(_APPLIED_MARKER) == "1":
        return
    env = host_tuning_env()
    if not env:
        return
    os.environ.update(env)
    os.environ[_APPLIED_MARKER] = "1"
    sys.stdout.flush()
    sys.stderr.flush()
    os.execve(sys.executable, [sys.executable] + sys.argv, os.environ)


def _main(argv=None) -> int:
    """Print ``export KEY=VALUE`` lines for the tuning environment; nothing
    (exit 0) when tuning is off or there is nothing to apply."""
    p = argparse.ArgumentParser(description="emit shell exports for the opt-in host tuning")
    p.add_argument("--force", action="store_true",
                   help="emit even when REPRO_HOST_TUNING is unset")
    p.add_argument("--device-count", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.device_count is not None:
        p.error("--device-count forces XLA's fake CPU devices, which the port does not "
                "use: its mesh names its devices itself (--mesh N on the daemon)")
    if not (enabled() or args.force):
        return 0
    for key, val in host_tuning_env().items():
        print(f"export {key}={shlex.quote(val)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
