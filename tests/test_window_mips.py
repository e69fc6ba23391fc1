"""Window-segment MIPS engine (``ops.topk.mips_topk_window``, the
``MIPSIndex(mode="fused")`` path) against numpy, its window routing
(``mips_topk_window_auto``), and every valid (mode, dtype) pair of
``MIPSIndex`` through build, search, save and load."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recommendit_tpu.models.retrieval import MIPSIndex
from recommendit_tpu.ops import topk as topk_mod
from recommendit_tpu.ops.quantize import quantize_int8_jnp
from recommendit_tpu.ops.topk import (
    mips_topk_int8,
    mips_topk_numpy,
    mips_topk_window,
    mips_topk_window_auto,
    window_for,
)


def _run_window(Q, N, D, K, W, seed=0):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.normal(size=(Q, D)), jnp.float32)
    items = jnp.asarray(rng.normal(size=(N, D)), jnp.float32)
    v, i = mips_topk_window(q, items, K, W)
    return np.asarray(q), np.asarray(items), np.asarray(v), np.asarray(i)


def _recall(got, ref):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / ref.shape[1]
                    for a, b in zip(got, ref)])


def _window_reference(scores, k, window):
    """numpy window engine: per-window max + first argmax, exact top-k of
    the maxima (stable: ties by window index)."""
    q, n = scores.shape
    n_win = -(-n // window)
    s = np.full((q, n_win * window), -np.inf)
    s[:, :n] = scores
    s3 = s.reshape(q, n_win, window)
    wmax = s3.max(axis=2)
    warg = s3.argmax(axis=2)
    sel = np.argsort(-wmax, axis=1, kind="stable")[:, :k]
    idx = sel * window + np.take_along_axis(warg, sel, axis=1)
    return np.take_along_axis(wmax, sel, axis=1), idx


def _quantized_corpus(n, d, seed=0):
    rng = np.random.default_rng(seed)
    embs = rng.normal(size=(n, d)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    i8, scales = quantize_int8_jnp(jnp.asarray(embs), jax.random.PRNGKey(0))
    return embs, i8, scales


@pytest.mark.parametrize("window", [1, 8, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_engine_matches_numpy(dtype, window):
    """The engine returns exactly numpy's window-maxima top-k over the
    scores it defines: f32 scores, bf16 operands accumulated in f32, or
    the int8 x int8 scores times both scale vectors."""
    rng = np.random.default_rng(11)
    n, d, k = 3001, 16, 20
    q = rng.normal(size=(6, d)).astype(np.float32)
    embs = rng.normal(size=(n, d)).astype(np.float32)
    if dtype == "int8":
        i8, scales = quantize_int8_jnp(jnp.asarray(embs),
                                       jax.random.PRNGKey(3))
        v, i = mips_topk_window(jnp.asarray(q), i8, k, window, scales)
        q_i8, q_scale = topk_mod._quantize_queries(jnp.asarray(q))
        qf = np.asarray(q_i8, np.float64) * np.asarray(q_scale)[:, None]
        cf = np.asarray(i8, np.float64) * np.asarray(scales)[:, None]
    elif dtype == "bfloat16":
        items = jnp.asarray(embs, jnp.bfloat16)
        v, i = mips_topk_window(jnp.asarray(q), items, k, window)
        qf = np.asarray(jnp.asarray(q, jnp.bfloat16), np.float64)
        cf = np.asarray(items, np.float64)
    else:
        v, i = mips_topk_window(jnp.asarray(q), jnp.asarray(embs), k, window)
        qf, cf = q.astype(np.float64), embs.astype(np.float64)
    ref_v, ref_i = _window_reference(qf @ cf.T, k, window)
    np.testing.assert_array_equal(np.asarray(i), ref_i)
    np.testing.assert_allclose(np.asarray(v), ref_v, rtol=1e-5, atol=1e-5)


class TestWindowMIPS:
    """Contiguous windows of W items, one candidate (the window max) per
    window, exact top-k over the candidates."""

    def test_values_match_indices(self):
        q, items, v, i = _run_window(8, 5000, 32, 100, 8)
        gathered = np.take_along_axis(q @ items.T, i, axis=1)
        np.testing.assert_allclose(gathered, v, atol=1e-4)

    def test_sorted_descending(self):
        _, _, v, _ = _run_window(8, 4096, 16, 64, 8)
        assert (np.diff(v, axis=1) <= 1e-6).all()

    def test_indices_in_bounds_with_padding(self):
        _, _, v, i = _run_window(8, 3001, 16, 100, 4)
        assert (i >= 0).all() and (i < 3001).all()
        assert np.isfinite(v).all()

    def test_window_one_is_exact(self):
        q, items, v, i = _run_window(4, 2048, 16, 50, 1)
        vn, idxn = mips_topk_numpy(q, items, 50)
        np.testing.assert_array_equal(i, idxn)
        np.testing.assert_allclose(v, vn, rtol=1e-4)

    def test_recall_matches_bin_model(self):
        q, items, v, i = _run_window(16, 8192, 32, 100, 8)
        _, idxn = mips_topk_numpy(q, items, 100)
        # bin model: recall ≈ 1 - (k-1)·W/(2N) ≈ 0.95
        assert _recall(i, idxn) > 0.85

    def test_lane_width_window(self):
        """W=128: every candidate is its window's maximum."""
        q, items, v, i = _run_window(8, 16384, 32, 64, 128)
        gathered = np.take_along_axis(q @ items.T, i, axis=1)
        np.testing.assert_allclose(gathered, v, atol=1e-4)
        _, idxn = mips_topk_numpy(q, items, 1)
        assert (i[:, 0] == idxn[:, 0]).all()  # global argmax always kept

    def test_no_duplicate_indices(self):
        _, _, _, i = _run_window(8, 4096, 32, 200, 4)
        for row in i:
            assert len(set(row.tolist())) == len(row)

    @pytest.mark.parametrize("n,w", [(4096, 8), (3001, 4), (8192, 64)])
    def test_chunked_scan_identical(self, n, w, monkeypatch):
        """The column-chunked scan (corpus wider than the score budget)
        returns what the single-shot path returns."""
        rng = np.random.default_rng(7)
        q = jnp.asarray(rng.normal(size=(8, 32)), jnp.float32)
        items = jnp.asarray(rng.normal(size=(n, 32)), jnp.float32)
        v1, i1 = mips_topk_window(q, items, 100, w)
        monkeypatch.setattr(topk_mod, "_REDUCE_CHUNK", 1024)
        monkeypatch.setattr(topk_mod, "_SCORE_BUDGET", 8 * 1024)
        # the unjitted body reads the patched sizes (the jit cache holds
        # the single-shot program for these shapes)
        v2, i2 = mips_topk_window.__wrapped__(q, items, 100, w)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(v1), np.asarray(v2),
                                   atol=1e-5)

    def test_bf16_corpus(self):
        """bf16 corpus storage: values stay within bf16 quantization error
        of the f32 truth for the returned items."""
        rng = np.random.default_rng(5)
        q = jnp.asarray(rng.normal(size=(8, 32)), jnp.float32)
        items_f32 = rng.normal(size=(4096, 32)).astype(np.float32)
        items_f32 /= np.linalg.norm(items_f32, axis=1, keepdims=True)
        items = jnp.asarray(items_f32, jnp.bfloat16)
        v, i = mips_topk_window(q, items, 100, 8)
        gathered = np.take_along_axis(
            np.asarray(q) @ items_f32.T, np.asarray(i), axis=1)
        np.testing.assert_allclose(gathered, np.asarray(v), atol=3e-2)

    def test_bad_window_raises(self):
        rng = np.random.default_rng(0)
        q = jnp.asarray(rng.normal(size=(4, 16)), jnp.float32)
        items = jnp.asarray(rng.normal(size=(1024, 16)), jnp.float32)
        with pytest.raises(ValueError):
            mips_topk_window(q, items, 200, 32)  # N/W < k
        with pytest.raises(ValueError):
            mips_topk_window(q, items, 10, 0)    # window < 1


class TestFusedAuto:
    """mips_topk_window_auto: window sizing + small-corpus fallback (the
    production ``MIPSIndex(mode="fused")`` entry)."""

    def test_small_corpus_falls_back_to_windowed(self):
        rng = np.random.default_rng(0)
        q = jnp.asarray(rng.normal(size=(4, 16)), jnp.float32)
        items = jnp.asarray(rng.normal(size=(3952, 16)), jnp.float32)
        v, i = mips_topk_window_auto(q, items, 500)
        vn, idxn = mips_topk_numpy(np.asarray(q), np.asarray(items), 500)
        # fallback path is exact
        np.testing.assert_array_equal(np.asarray(i), idxn)

    def test_large_corpus_uses_window_engine(self):
        rng = np.random.default_rng(1)
        q = jnp.asarray(rng.normal(size=(4, 16)), jnp.float32)
        items = jnp.asarray(rng.normal(size=(65536, 16)), jnp.float32)
        assert window_for(65536, 100) == 8
        v, i = mips_topk_window_auto(q, items, 100)
        v8, i8 = mips_topk_window(q, items, 100, 8)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(i8))
        gathered = np.take_along_axis(
            np.asarray(q) @ np.asarray(items).T, np.asarray(i), axis=1)
        np.testing.assert_allclose(gathered, np.asarray(v), atol=1e-3)
        _, idxn = mips_topk_numpy(np.asarray(q), np.asarray(items), 100)
        assert _recall(np.asarray(i), idxn) > 0.85

    def test_mid_corpus_window_shrinks(self):
        """16k corpus with k=500: window must shrink so N/W >= max(k, 4W)."""
        rng = np.random.default_rng(2)
        q = jnp.asarray(rng.normal(size=(4, 16)), jnp.float32)
        items = jnp.asarray(rng.normal(size=(16384, 16)), jnp.float32)
        v, i = mips_topk_window_auto(q, items, 500)
        assert np.asarray(i).shape == (4, 500)
        assert (np.asarray(i) >= 0).all() and (np.asarray(i) < 16384).all()

    def test_auto_window_rounds_up_at_decimal_million(self):
        """The window rule rounds UP so the final top-k sees <= 16384
        candidates: window 64 at both the decimal and the binary million,
        512 (the clamp) at 10M."""
        assert window_for(1_000_000, 500) == 64
        assert window_for(1 << 20, 500) == 64
        assert window_for(10_000_000, 500) == 512
        for n in (150_000, 400_000, 1_000_000, 3_000_000, 7_500_000):
            w = window_for(n, 500)
            assert -(-n // w) <= 16384, (n, w)
        # k must still be covered: at 16k rows and k=500 the window halves
        assert 16384 // window_for(16384, 500) >= 500

    def test_k_guard_counts_the_ragged_window(self):
        """k may reach the window count, the ragged tail window included;
        one more raises."""
        rng = np.random.default_rng(4)
        q = jnp.asarray(rng.normal(size=(4, 16)), jnp.float32)
        # 300 rows -> 3 windows of 128, the last holding 44 rows
        items = jnp.asarray(rng.normal(size=(300, 16)), jnp.float32)
        with pytest.raises(ValueError, match="candidate count 3"):
            mips_topk_window(q, items, 4, 128)
        v, i = mips_topk_window(q, items, 3, 128)
        assert np.isfinite(np.asarray(v)).all()
        assert (np.asarray(i) < 300).all()
        assert sorted(np.asarray(i)[0] // 128) == [0, 1, 2]

    def test_small_batch_uses_window_engine(self):
        """Every batch size takes the same engine (no batch crossover):
        one query gets the rows of a batch of eight."""
        rng = np.random.default_rng(5)
        n = 70_000
        q = jnp.asarray(rng.normal(size=(8, 16)), jnp.float32)
        items = jnp.asarray(rng.normal(size=(n, 16)), jnp.float32)
        v8, i8 = mips_topk_window_auto(q, items, 50)
        v1, i1 = mips_topk_window_auto(q[:1], items, 50)
        np.testing.assert_array_equal(np.asarray(i1)[0], np.asarray(i8)[0])
        np.testing.assert_allclose(np.asarray(v1)[0], np.asarray(v8)[0],
                                   rtol=1e-6)


class TestInt8WindowKernel:
    """Int8 corpus through the window engine: int8 x int8 -> int32 scores
    times both scale vectors, the same scores as ``mips_topk_int8``."""

    def test_matches_xla_int8_scores(self):
        """window=1 is exact over the int8 scores."""
        embs, i8, scales = _quantized_corpus(2048, 32)
        rng = np.random.default_rng(1)
        q = jnp.asarray(rng.normal(size=(8, 32)), jnp.float32)
        v_k, i_k = mips_topk_window(q, i8, 50, 1, scales)
        v_x, i_x = mips_topk_int8(q, i8, scales, 50, 1024, "exact")
        np.testing.assert_array_equal(np.asarray(i_k), np.asarray(i_x))
        np.testing.assert_allclose(np.asarray(v_k), np.asarray(v_x),
                                   rtol=1e-5, atol=1e-6)

    def test_windowed_recall_and_values(self):
        embs, i8, scales = _quantized_corpus(8192, 32, seed=2)
        rng = np.random.default_rng(3)
        q = jnp.asarray(rng.normal(size=(8, 32)), jnp.float32)
        v, i = mips_topk_window(q, i8, 100, 8, scales)
        assert (np.asarray(i) >= 0).all() and (np.asarray(i) < 8192).all()
        _, idxn = mips_topk_numpy(np.asarray(q), embs, 100)
        assert _recall(np.asarray(i), idxn) > 0.8

    def test_index_fused_int8_end_to_end(self, tmp_path):
        """MIPSIndex(mode='fused', dtype='int8'): build, search, save,
        reload, search again — identical."""
        rng = np.random.default_rng(6)
        n, d = 3000, 16
        embs = rng.normal(size=(n, d)).astype(np.float32)
        idx = MIPSIndex(embedding_dim=d, block_size=1024, mode="fused",
                        dtype="int8")
        idx.build(embs, np.arange(1, n + 1))
        assert idx._embs.shape[0] == n              # stored unpadded
        q = rng.normal(size=(4, d)).astype(np.float32)
        s1, ids1 = idx.batch_search(q, 20)
        assert set(np.unique(ids1)).issubset(set(range(1, n + 1)))
        idx.save(str(tmp_path / "i8f.npz"))
        idx2 = MIPSIndex.load(str(tmp_path / "i8f.npz"))
        assert idx2.mode == "fused" and idx2.dtype == "int8"
        s2, ids2 = idx2.batch_search(q, 20)
        np.testing.assert_array_equal(ids1, ids2)
        np.testing.assert_allclose(s1, s2, rtol=1e-6)


INDEX_PAIRS = [(m, d) for m in ("exact", "verified", "approx", "fused")
               for d in ("float32", "bfloat16", "int8")
               if not (m == "verified" and d == "int8")]


@pytest.mark.parametrize("mode,dtype", INDEX_PAIRS,
                         ids=[f"{m}-{d}" for m, d in INDEX_PAIRS])
def test_index_pair_build_search_save_load(mode, dtype, tmp_path):
    """Every valid (INDEX_MODE, INDEX_DTYPE) pair: recall against numpy
    exact over the scores the index ranks (1.0 for exact and verified,
    the window bin model for fused), and identical answers after a save
    and load."""
    rng = np.random.default_rng(8)
    n, d, k = 20_000, 16, 20
    embs = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(8, d)).astype(np.float32)
    idx = MIPSIndex(embedding_dim=d, mode=mode, dtype=dtype)
    idx.build(embs, np.arange(1, n + 1))
    scores, ids = idx.batch_search(q, k)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    if dtype == "int8":
        q_i8, q_scale = topk_mod._quantize_queries(jnp.asarray(qn))
        qf = np.asarray(q_i8, np.float64) * np.asarray(q_scale)[:, None]
        cf = (np.asarray(idx._embs, np.float64)
              * np.asarray(idx._scales)[:, None])
    else:
        qf = qn.astype(np.float64)
        cf = np.asarray(idx._embs, np.float32).astype(np.float64)
    _, ref_pos = mips_topk_numpy(qf, cf, k)
    need = 1.0 if mode in ("exact", "verified") else 0.98
    assert _recall(ids - 1, ref_pos) >= need
    idx.save(str(tmp_path / "i.npz"))
    again = MIPSIndex.load(str(tmp_path / "i.npz"))
    assert (again.mode, again.dtype) == (mode, dtype)
    s2, ids2 = again.batch_search(q, k)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_allclose(scores, s2, rtol=1e-6)


@pytest.mark.parametrize("mode,dtype", INDEX_PAIRS,
                         ids=[f"{m}-{d}" for m, d in INDEX_PAIRS])
def test_jitted_searcher_keeps_corpus_out_of_program(mode, dtype):
    """The serving searcher takes the corpus as an argument: jitting it
    gives a program whose size does not grow with the corpus (a closure
    over the corpus would bake every row in as a constant)."""
    rng = np.random.default_rng(9)
    sizes = []
    for n in (20_000, 40_000):
        idx = MIPSIndex(embedding_dim=16, mode=mode, dtype=dtype)
        idx.build(rng.normal(size=(n, 16)).astype(np.float32),
                  np.arange(1, n + 1))
        q = jnp.asarray(rng.normal(size=(4, 16)), jnp.float32)
        text = jax.jit(idx.make_device_searcher(20)).lower(
            q, idx.device_corpus).as_text()
        sizes.append(len(text))
    # 20,000 extra rows would add >= 20,000 * 16 bytes of constant
    assert abs(sizes[1] - sizes[0]) < 20_000, sizes
    assert sizes[0] < 20_000 * 16, sizes
