"""Federated-learning flavour of ColD Fusion (paper §6, Fig. 6a) on the
PyTorch port (``src/repro_torch``); the twin of
``federated_single_dataset.py``.

Several contributors ("hospitals / banks / silos") hold disjoint shards of
ONE dataset, fresh private examples stream in every round, each silo
finetunes the shared base locally, and only weights travel to the
Repository — the fused model's linear-probe accuracy keeps improving while
no raw example ever leaves a silo (the paper's §2.3 constraint).

  PYTHONPATH=src python examples/federated_single_dataset_torch.py [--dry-run] [--device cpu]

``--dry-run`` shrinks rounds/steps/data so the script finishes in seconds.
``--device`` defaults to ``cuda``: the script runs on the card and raises
without one unless ``--device cpu``.  Each silo's head is drawn from a
torch generator seeded with the silo's index, so it is not the
reference's draw.
"""
import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import TINY  # noqa: E402
from repro_torch.core import EvalTask, Repository, evaluate_base_model  # noqa: E402
from repro_torch.data.synthetic import SyntheticSuite  # noqa: E402
from repro_torch.models import encoder as E  # noqa: E402
from repro_torch.train import finetune as FT  # noqa: E402
from repro_torch.train import pretrain_mlm  # noqa: E402

SEQ = 24
TASK = 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dry-run", action="store_true",
                    help="minimal rounds/steps for a seconds-long smoke run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.dry_run:
        knobs = dict(pretrain=8, n_contrib=2, per_iter=64, iters=1,
                     ft_steps=3, eval_steps=5, n_eval=96)
    else:
        knobs = dict(pretrain=150, n_contrib=4, per_iter=800, iters=4,
                     ft_steps=25, eval_steps=50, n_eval=512)

    cfg = dataclasses.replace(TINY, d_model=64, num_heads=2, num_kv_heads=2,
                              head_dim=32, d_ff=128, vocab_size=256,
                              max_seq_len=SEQ + 8)
    suite = SyntheticSuite(vocab_size=256, num_tasks=4, seed=0, noise=0.15)
    body, _ = pretrain_mlm(cfg, suite, steps=knobs["pretrain"], seq_len=SEQ,
                           device=args.device)

    d_eval = suite.dataset(TASK, knobs["n_eval"], knobs["n_eval"], SEQ, split_seed=9)
    ev = EvalTask(TASK, suite.tasks[TASK].num_classes,
                  d_eval["x_train"], d_eval["y_train"],
                  d_eval["x_test"], d_eval["y_test"])

    repo = Repository(body)
    heads = {c: E.init_cls_head(cfg, torch.Generator().manual_seed(c),
                                suite.tasks[TASK].num_classes, device=args.device)
             for c in range(knobs["n_contrib"])}
    print(f"{knobs['n_contrib']} hospitals / banks / silos, "
          f"{knobs['per_iter']} fresh private examples each per round\n")
    for it in range(knobs["iters"]):
        base = repo.download()
        for c in range(knobs["n_contrib"]):
            d = suite.dataset(TASK, knobs["per_iter"], 8, SEQ,
                              split_seed=1000 + it * 10 + c)
            b, h, _ = FT.finetune(cfg, base, heads[c], d["x_train"], d["y_train"],
                                  steps=knobs["ft_steps"], lr=2e-3, seed=it * 10 + c)
            heads[c] = h
            repo.upload(b)
        rec = repo.fuse_pending()
        acc = np.mean(list(evaluate_base_model(cfg, repo.download(), [ev], frozen=True,
                                               steps=knobs["eval_steps"], lr=2e-3).values()))
        print(f"round {it+1}: fused {rec.n_accepted}/{rec.n_contributions}, "
              f"fused-model linear-probe accuracy = {acc:.3f}")
    print("\nNo raw example ever left a silo; only weights moved (paper §2.3).")


if __name__ == "__main__":
    main()
