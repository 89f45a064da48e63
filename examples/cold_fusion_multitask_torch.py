"""Multitask ColD Fusion with baselines + a malicious contributor, on the
PyTorch port (``src/repro_torch``); the twin of ``cold_fusion_multitask.py``.

Demonstrates the paper's main loop end-to-end on the synthetic multitask
suite: (1) the §5.1 collaborative schedule — several contributors finetune
the shared base on their own tasks, the Repository screens and fuses every
cohort, and both seen- and unseen-task accuracy improve across iterations;
then (2) the §9 robustness story — one contributor uploads NaN weights and
another a runaway update, the Repository's MAD screen rejects both, and the
fused model is unaffected.

  PYTHONPATH=src python examples/cold_fusion_multitask_torch.py [--dry-run] [--device cpu]

``--dry-run`` shrinks every knob (steps, cohort size, eval budget) so the
whole script finishes in seconds.  ``--device`` defaults to ``cuda``: the
script runs on the card and raises without one unless ``--device cpu``.
"""
import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import TINY  # noqa: E402
from repro_torch.core import (Contributor, EvalTask, Repository,  # noqa: E402
                              evaluate_base_model, run_cold_fusion)
from repro_torch.data.synthetic import SyntheticSuite  # noqa: E402
from repro_torch.train import pretrain_mlm  # noqa: E402
from repro_torch.utils.pytree import tree_map  # noqa: E402

SEQ = 24


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dry-run", action="store_true",
                    help="minimal steps/cohort for a seconds-long smoke run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.dry_run:
        knobs = dict(pretrain=8, n_contrib=3, ft_steps=4, iters=1,
                     per_iter=3, eval_steps=8, n_train=96, n_eval=48)
    else:
        knobs = dict(pretrain=150, n_contrib=8, ft_steps=30, iters=3,
                     per_iter=4, eval_steps=60, n_train=1024, n_eval=256)

    cfg = dataclasses.replace(TINY, d_model=64, num_heads=2, num_kv_heads=2,
                              head_dim=32, d_ff=128, vocab_size=256,
                              max_seq_len=SEQ + 8)
    suite = SyntheticSuite(vocab_size=256, num_tasks=16, seed=0, noise=0.15)
    body, _ = pretrain_mlm(cfg, suite, steps=knobs["pretrain"], seq_len=SEQ,
                           device=args.device)

    contribs = []
    for tid in range(knobs["n_contrib"]):
        d = suite.dataset(tid, knobs["n_train"], 64, SEQ)
        contribs.append(Contributor(cfg, tid, suite.tasks[tid].num_classes,
                                    d["x_train"], d["y_train"],
                                    steps=knobs["ft_steps"], lr=2e-3, seed=tid))

    def ev_tasks(tids):
        return [EvalTask(t, suite.tasks[t].num_classes,
                         *(suite.dataset(t, knobs["n_eval"], knobs["n_eval"], SEQ,
                                         split_seed=1)[k]
                           for k in ("x_train", "y_train", "x_test", "y_test")))
                for t in tids]

    ev_seen, ev_unseen = ev_tasks((0, 1)), ev_tasks((12, 13))

    print("== honest cohort ==")
    repo = Repository(body)
    log = run_cold_fusion(cfg, repo, contribs, iterations=knobs["iters"],
                          contributors_per_iter=knobs["per_iter"],
                          eval_seen=ev_seen, eval_unseen=ev_unseen,
                          eval_every=knobs["iters"], eval_steps=knobs["eval_steps"],
                          eval_lr=2e-3, progress=True)
    print(f"seen  finetuned: {log.mean('seen_finetuned')[-1]:.3f}  "
          f"frozen: {log.mean('seen_frozen')[-1]:.3f}")
    print(f"unseen finetuned: {log.mean('unseen_finetuned')[-1]:.3f}  "
          f"frozen: {log.mean('unseen_frozen')[-1]:.3f}")

    print("\n== adversarial iteration: NaN + runaway contributions get screened ==")
    base = repo.download()
    for c in contribs[:3]:
        repo.upload(c.contribute(base))
    repo.upload(tree_map(lambda x: torch.full_like(x, float("nan")), base))   # malicious NaN
    noise = torch.Generator(device=repo.device).manual_seed(0)
    repo.upload(tree_map(lambda x: x + 100.0 * torch.randn(
        x.shape, generator=noise, device=x.device, dtype=x.dtype), base))    # runaway
    rec = repo.fuse_pending()
    print(f"fused {rec.n_accepted}/{rec.n_contributions} contributions "
          f"(rejected {rec.n_contributions - rec.n_accepted} anomalous uploads)")
    acc = np.mean(list(evaluate_base_model(cfg, repo.download(), ev_seen, frozen=True,
                                           steps=knobs["eval_steps"], lr=2e-3).values()))
    print(f"post-adversarial frozen accuracy still healthy: {acc:.3f}")
    if rec.n_accepted != rec.n_contributions - 2:
        raise SystemExit("the screen must reject both attacks")


if __name__ == "__main__":
    main()
