"""Test configuration: force JAX onto a virtual 8-device CPU platform.

This is the JAX equivalent of the reference's laptop-runnable test strategy
(SURVEY.md §4): unit tests run on CPU, and multi-chip sharding is exercised
on a single host via ``--xla_force_host_platform_device_count=8``.

Must run before the first ``import jax`` anywhere in the test process.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# If jax was imported before conftest runs, the env vars above are too
# late; jax.config still applies before any backend initializes.
import jax

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", (
    "tests must run on the virtual CPU mesh, got " + jax.devices()[0].platform
)

import numpy as np
import pandas as pd
import pytest


@pytest.fixture(scope="session")
def synthetic_data():
    """Small deterministic MovieLens-format dataset shared across tests."""
    from recommendit_tpu.data.synthetic import make_synthetic_movielens

    return make_synthetic_movielens(
        n_users=60, n_items=120, n_ratings=3000, seed=42
    )


@pytest.fixture(scope="session")
def engineered_features(synthetic_data):
    """FeatureEngineer with user/item features built."""
    from recommendit_tpu.features.engineering import FeatureEngineer

    fe = FeatureEngineer(seed=0)
    fe.set_data(synthetic_data)
    fe.build_user_features()
    fe.build_item_features()
    return fe
