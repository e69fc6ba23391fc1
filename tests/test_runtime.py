"""Process runtime setup (compile cache) and the benchmark's peak table."""
import os
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    from recommendit_tpu.utils.runtime import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo_dir(monkeypatch, restore_cache_dir):
    from recommendit_tpu.utils.runtime import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # a fixed path: the same on every call
    assert enable_compile_cache() == path


@pytest.fixture
def bench():
    sys.path.insert(0, REPO)
    try:
        import bench as mod
    finally:
        sys.path.remove(REPO)
    return mod


def test_peak_table_known_kind(bench):
    p = bench.peaks_for("NVIDIA H100 80GB HBM3")
    assert p == {"bf16_tflops": 989.0, "tf32_tflops": 495.0,
                 "fp32_tflops": 67.0, "hbm_gbps": 3350.0}
    out = {}
    # 3.35 GB of traffic at 3.35 TB/s is 1 ms: memory-bound at 100%
    bench.speed_of_light(out, "x", 1.0, flops=1e9, hbm_bytes=3.35e9,
                         peaks=p)
    assert out["sol_x_bound"] == "hbm"
    assert out["sol_x_pct"] == pytest.approx(100.0)


def test_peak_table_unknown_kind_raises(bench):
    with pytest.raises(ValueError, match="no peak rates"):
        bench.peaks_for("cpu")


def test_device_loop_time_takes_corpus_as_argument(bench):
    """The timing loop runs a searcher whose corpus (an int8 pair, or an
    f32 matrix with ``scales`` None) arrives through ``args``, and
    returns the per-iteration and the first-call seconds."""
    import jax.numpy as jnp
    import numpy as np

    from recommendit_tpu.models.retrieval import MIPSIndex

    rng = np.random.default_rng(0)
    for mode, dtype in (("fused", "int8"), ("exact", "float32")):
        index = MIPSIndex(embedding_dim=8, mode=mode, dtype=dtype)
        index.build(rng.normal(size=(512, 8)).astype(np.float32),
                    np.arange(1, 513))
        q0 = jnp.asarray(rng.normal(size=(4, 8)), jnp.float32)
        per_iter, first_s = bench.device_loop_time(
            jax, jnp, index.make_device_searcher(10), q0,
            index.device_corpus, iters=2, rounds=1)
        assert per_iter > 0 and first_s > 0
