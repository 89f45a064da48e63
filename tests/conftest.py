"""Shared test fixtures.  NOTE: no XLA_FLAGS here — tests run on the single
real CPU device; distributed tests spawn subprocesses that set the fake
device count themselves."""
import dataclasses
import random

import jax
import numpy as np
import pytest

from repro.configs import get_config, reduce_config
from repro.configs.roberta_base import TINY


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-second subprocess tests (forced fake-device jax init); "
        "deselect with -m 'not slow' when they already ran in the same CI pass")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips without one")


@pytest.fixture(autouse=True)
def _seed_global_rngs():
    """Flake hardening (PR 4 audit): every jax draw in the suite threads an
    explicit PRNGKey and numpy goes through the seeded ``rng`` fixture, but
    the *global* numpy/python RNGs (reachable from library internals and
    future tests) were unpinned.  Seed them per test so any draw is
    identical run-to-run and failures reproduce."""
    random.seed(0)
    np.random.seed(0)


@pytest.fixture(scope="session")
def tiny_cfg():
    """The tiny RoBERTa-style encoder used by the paper reproduction."""
    return dataclasses.replace(
        TINY, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=256, max_seq_len=32,
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def smoke_config(arch_id: str):
    return reduce_config(get_config(arch_id))
