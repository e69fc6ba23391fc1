"""Utils + config tests: latency tracker, stage timer, checkpoint
round-trip, env-override parsing."""
import os
import time

import numpy as np
import pytest

from recommendit_tpu.config import Settings
from recommendit_tpu.utils.latency import LatencyTracker
from recommendit_tpu.utils.profiling import StageTimer, time_jitted


class TestLatencyTracker:
    def test_percentiles(self):
        t = LatencyTracker(window=100)
        for v in range(1, 101):
            t.record(float(v))
        assert t.p50 == pytest.approx(50.5)
        assert t.p99 == pytest.approx(99.01)
        assert t.count == 100

    def test_rolling_window_evicts(self):
        t = LatencyTracker(window=10)
        for v in [1000.0] * 10 + [1.0] * 10:
            t.record(v)
        assert t.p99 == pytest.approx(1.0)
        assert t.count == 10

    def test_empty(self):
        assert LatencyTracker().p50 == 0.0


class TestStageTimer:
    def test_accumulates(self):
        st = StageTimer()
        with st.stage("a"):
            time.sleep(0.01)
        with st.stage("a"):
            time.sleep(0.01)
        with st.stage("b"):
            pass
        rep = st.report()
        assert rep["a"] >= 0.02 and "b" in rep


class TestTimeJitted:
    def test_returns_stats(self):
        import jax
        import jax.numpy as jnp

        f = jax.jit(lambda x: x * 2)
        out = time_jitted(f, jnp.ones((4, 4)), iters=5, warmup=1)
        assert out["median_ms"] >= 0 and out["iters"] == 5


class TestCheckpoint:
    def test_roundtrip_with_template(self, tmp_path):
        import jax.numpy as jnp
        import optax

        from recommendit_tpu.utils.checkpoint import (
            load_train_state,
            save_train_state,
        )

        params = {"w": jnp.arange(6.0).reshape(2, 3)}
        tx = optax.adam(1e-3)
        state = {"params": params, "opt_state": tx.init(params),
                 "epoch": jnp.asarray(3)}
        path = str(tmp_path / "ckpt")
        save_train_state(path, state)

        template = {"params": params, "opt_state": tx.init(params),
                    "epoch": jnp.asarray(0)}
        restored = load_train_state(path, template=template)
        np.testing.assert_allclose(restored["params"]["w"],
                                   np.arange(6.0).reshape(2, 3))
        assert int(restored["epoch"]) == 3
        # restored opt_state still works with tx.update
        grads = {"w": jnp.ones((2, 3))}
        updates, _ = tx.update(grads, restored["opt_state"], restored["params"])
        assert updates["w"].shape == (2, 3)

    def test_missing_raises(self, tmp_path):
        from recommendit_tpu.utils.checkpoint import load_train_state

        with pytest.raises(FileNotFoundError):
            load_train_state(str(tmp_path / "nope"))


class TestSettings:
    def test_env_override_types(self, monkeypatch):
        monkeypatch.setenv("TOP_K_CANDIDATES", "42")
        monkeypatch.setenv("LEARNING_RATE", "0.5")
        monkeypatch.setenv("FILTER_SEEN", "false")
        monkeypatch.setenv("RANKER_HIDDEN_DIMS", "32,16")
        monkeypatch.setenv("MODEL_VERSION", "9.9.9")
        s = Settings.from_env(env_file="/nonexistent")
        assert s.TOP_K_CANDIDATES == 42
        assert s.LEARNING_RATE == 0.5
        assert s.FILTER_SEEN is False
        assert s.RANKER_HIDDEN_DIMS == (32, 16)
        assert s.MODEL_VERSION == "9.9.9"

    def test_env_file(self, tmp_path, monkeypatch):
        monkeypatch.delenv("EMBEDDING_DIM", raising=False)
        f = tmp_path / ".env"
        f.write_text("# comment\nEMBEDDING_DIM=32\nLOG_LEVEL=DEBUG\n")
        s = Settings.from_env(env_file=str(f))
        assert s.EMBEDDING_DIM == 32 and s.LOG_LEVEL == "DEBUG"

    def test_env_var_beats_file(self, tmp_path, monkeypatch):
        f = tmp_path / ".env"
        f.write_text("EMBEDDING_DIM=32\n")
        monkeypatch.setenv("EMBEDDING_DIM", "16")
        assert Settings.from_env(env_file=str(f)).EMBEDDING_DIM == 16

    def test_replace_and_hashable(self):
        s = Settings()
        s2 = s.replace(EMBEDDING_DIM=128)
        assert s2.EMBEDDING_DIM == 128 and s.EMBEDDING_DIM == 64
        hash(s2)  # frozen dataclass → usable as jit static arg
