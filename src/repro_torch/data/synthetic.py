"""Synthetic multitask suite — the stand-in for the paper's 36 datasets.

A numpy copy of ``repro.data.synthetic`` (the port imports nothing from the
JAX package).  Its output is bit-identical to the reference's for the same
arguments: the same generator calls in the same order.

* A fixed random token->motif map  Φ ∈ R^{V x M}  (the latent skill every
  task shares).
* Task k draws a label rule  W_k ∈ R^{M x C_k}: the label of a sequence is
  ``argmax(W_kᵀ · mean_t Φ[tok_t] + noise)``.
* Each task has its own Dirichlet-sampled unigram token distribution.

Everything is deterministic in (suite seed, task id).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

DEFAULT_VOCAB = 512
DEFAULT_MOTIFS = 24
# Reserved token ids (mirror RoBERTa special tokens).
PAD, CLS, MASK = 0, 1, 2
N_SPECIAL = 3


@dataclass(frozen=True)
class TaskSpec:
    task_id: int
    name: str
    num_classes: int
    seed: int


@dataclass
class SyntheticSuite:
    """Container for the shared latent structure + task pool."""

    vocab_size: int = DEFAULT_VOCAB
    num_motifs: int = DEFAULT_MOTIFS
    num_tasks: int = 36
    seed: int = 0
    noise: float = 0.35

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        phi = rng.normal(0, 1, (self.vocab_size, self.num_motifs))
        gate = rng.random((self.vocab_size, self.num_motifs)) < 0.25
        self.phi = (phi * gate).astype(np.float32)
        self.phi[:N_SPECIAL] = 0.0
        self.tasks: List[TaskSpec] = []
        kinds = ["nli", "sentiment", "topic", "twitter", "qa", "accept"]
        for t in range(self.num_tasks):
            c = int(rng.integers(2, 6))
            self.tasks.append(
                TaskSpec(t, f"{kinds[t % len(kinds)]}-{t:02d}", c, int(rng.integers(2**31)))
            )
        self._task_params: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def task_params(self, task_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(W [M, C], unigram distribution [V]) for a task, cached."""
        if task_id not in self._task_params:
            spec = self.tasks[task_id]
            rng = np.random.default_rng(spec.seed)
            W = rng.normal(0, 1, (self.num_motifs, spec.num_classes)).astype(np.float32)
            alpha = np.full(self.vocab_size - N_SPECIAL, 0.3)
            unigram = rng.dirichlet(alpha).astype(np.float64)
            full = np.zeros(self.vocab_size)
            full[N_SPECIAL:] = unigram
            full = full / full.sum()
            self._task_params[task_id] = (W, full)
        return self._task_params[task_id]

    def sample(
        self, task_id: int, n: int, seq_len: int, *, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Draw (tokens [n, seq_len] int32, labels [n] int32) for a task."""
        spec = self.tasks[task_id]
        W, unigram = self.task_params(task_id)
        toks = rng.choice(self.vocab_size, size=(n, seq_len), p=unigram).astype(np.int32)
        toks[:, 0] = CLS
        profile = self.phi[toks].mean(axis=1)  # [n, M]
        logits = profile @ W + self.noise * rng.normal(0, 1, (n, spec.num_classes))
        labels = logits.argmax(axis=1).astype(np.int32)
        return toks, labels

    def dataset(
        self, task_id: int, n_train: int, n_test: int, seq_len: int, *, split_seed: int = 0
    ) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.tasks[task_id].seed, split_seed, 7))
        xtr, ytr = self.sample(task_id, n_train, seq_len, rng=rng)
        xte, yte = self.sample(task_id, n_test, seq_len, rng=rng)
        return {"x_train": xtr, "y_train": ytr, "x_test": xte, "y_test": yte}

    def lm_stream(self, n: int, seq_len: int, *, seed: int = 123) -> np.ndarray:
        """Token sequences from the task-mixture distribution (MLM input)."""
        rng = np.random.default_rng(seed)
        task_ids = rng.integers(0, self.num_tasks, size=n)
        out = np.empty((n, seq_len), np.int32)
        for i, t in enumerate(task_ids):
            _, unigram = self.task_params(int(t))
            out[i] = rng.choice(self.vocab_size, size=seq_len, p=unigram)
        out[:, 0] = CLS
        return out


def mask_for_mlm(tokens: np.ndarray, rng: np.random.Generator, p: float = 0.15):
    """BERT-style masking.  Returns (inputs, targets, mask)."""
    inputs = tokens.copy()
    mask = (rng.random(tokens.shape) < p) & (tokens >= N_SPECIAL)
    inputs[mask] = MASK
    return inputs, tokens, mask.astype(np.float32)
