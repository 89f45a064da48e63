"""Quickstart on the PyTorch port (``src/repro_torch``): the whole ColD
Fusion loop in a few minutes; the twin of ``quickstart.py``.

Builds the synthetic multitask suite, MLM-pretrains a tiny RoBERTa-style
encoder, runs 3 ColD Fusion iterations with 4 contributors, and shows the
base model improving under linear probing — the paper's Fig. 2 in miniature.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``--device`` defaults to ``cuda``: the script runs on the card and raises
without one unless ``--device cpu``.
"""
import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import TINY  # noqa: E402
from repro_torch.core import (Contributor, EvalTask, Repository,  # noqa: E402
                              evaluate_base_model, run_cold_fusion)
from repro_torch.data.synthetic import SyntheticSuite  # noqa: E402
from repro_torch.train import pretrain_mlm  # noqa: E402

SEQ = 24


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(TINY, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
                              d_ff=128, vocab_size=256, max_seq_len=SEQ + 8)
    suite = SyntheticSuite(vocab_size=256, num_tasks=12, seed=0, noise=0.15)

    print("1) MLM-pretraining the tiny encoder (the 'RoBERTa' of this demo)...")
    body, metrics = pretrain_mlm(cfg, suite, steps=150, seq_len=SEQ, device=args.device)
    print(f"   mlm loss {metrics['loss'][0]:.2f} -> {metrics['loss'][-1]:.2f}")

    print("2) Building 4 contributors with private datasets...")
    contribs = []
    for tid in range(4):
        d = suite.dataset(tid, 1024, 64, SEQ)
        contribs.append(Contributor(cfg, tid, suite.tasks[tid].num_classes,
                                    d["x_train"], d["y_train"], steps=30, lr=2e-3, seed=tid))

    d0 = suite.dataset(0, 512, 256, SEQ)
    ev = [EvalTask(0, suite.tasks[0].num_classes, d0["x_train"], d0["y_train"],
                   d0["x_test"], d0["y_test"])]
    before = np.mean(list(evaluate_base_model(cfg, body, ev, frozen=True, steps=40,
                                              lr=2e-3).values()))
    print(f"   pretrained linear-probe accuracy on task 0: {before:.3f}")

    print("3) Running 3 ColD Fusion iterations (download -> finetune -> upload -> fuse)...")
    repo = Repository(body)
    log = run_cold_fusion(cfg, repo, contribs, iterations=3, eval_seen=ev,
                          eval_every=1, eval_steps=40, eval_lr=2e-3, progress=True)
    for i, acc in enumerate(log.mean("seen_frozen")):
        print(f"   after iter {i+1}: linear-probe acc = {acc:.3f}")
    print(f"\nColD Fusion improved the base model: {before:.3f} -> "
          f"{log.mean('seen_frozen')[-1]:.3f}")


if __name__ == "__main__":
    main()
