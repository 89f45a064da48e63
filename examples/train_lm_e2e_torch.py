"""End-to-end LM training on the PyTorch port (``src/repro_torch``); the
twin of ``train_lm_e2e.py``.

Runs ``python -m repro_torch.launch.train`` with the reference example's
arguments: a ~1M-parameter reduced gemma3 for 200 real optimizer steps of
8 x 64 tokens.  Any further arguments go to the launcher after those (the
last value of a flag wins), e.g. ``--steps 20``.

  PYTHONPATH=src python examples/train_lm_e2e_torch.py [--device cpu] [launcher flags]

``--device`` defaults to ``cuda``: the launcher trains on the card and
raises without one unless ``--device cpu``.
"""
import argparse
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, extra = ap.parse_known_args(argv)
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "gemma3-1b", "--reduced",
           "--steps", "200", "--batch", "8", "--seq", "64", "--log-every", "20",
           "--device", args.device, *extra]
    print("+", " ".join(cmd), flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.call(cmd, env=env)


if __name__ == "__main__":
    raise SystemExit(main())
