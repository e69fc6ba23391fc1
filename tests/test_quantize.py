"""Int8 quantized retrieval: the stochastic-rounding quantizer, the int8
MIPS scan, and MIPSIndex(dtype='int8') round-trips.

No reference equivalent (FAISS IVFFlat stores f32); strategy mirrors the
repo's kernel tests: numpy/f32 exact search as the oracle, recall bounds
instead of exact-match where quantization legitimately perturbs ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recommendit_tpu.models.retrieval import MIPSIndex
from recommendit_tpu.ops.quantize import (
    dequantize_int8,
    quantize_int8_jnp,
)
from recommendit_tpu.ops.topk import mips_topk_int8, mips_topk_numpy


def _normalized(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


class TestQuantizers:
    def test_jnp_roundtrip_error_bound(self):
        x = jnp.asarray(_normalized(512, 64))
        v, s = quantize_int8_jnp(x, jax.random.PRNGKey(0))
        assert v.dtype == jnp.int8 and s.shape == (512,)
        # SR error is at most one quantization step per element
        err = jnp.abs(dequantize_int8(v, s) - x)
        assert float((err <= s[:, None] * 1.0001).all())

    def test_jnp_unbiased(self):
        x = jnp.asarray(_normalized(32, 16, seed=1))
        acc = jnp.zeros_like(x)
        n = 300
        for i in range(n):
            v, s = quantize_int8_jnp(x, jax.random.PRNGKey(i))
            acc = acc + dequantize_int8(v, s)
        bias = jnp.abs(acc / n - x)
        # SR noise shrinks as 1/sqrt(n); scale/sqrt(300) ~ 0.06*scale
        scales = jnp.max(jnp.abs(x), axis=1, keepdims=True) / 127.0
        assert float(bias.max()) < float(scales.max()) * 0.3

    def test_deterministic_mode(self):
        x = jnp.asarray(_normalized(64, 32))
        v1, s1 = quantize_int8_jnp(x, stochastic=False)
        v2, s2 = quantize_int8_jnp(x, stochastic=False)
        assert jnp.array_equal(v1, v2) and jnp.array_equal(s1, s2)
        # RTN error bound: half a step
        err = jnp.abs(dequantize_int8(v1, s1) - x)
        assert float((err <= s1[:, None] * 0.5001).all())


class TestInt8Search:
    def test_recall_vs_exact(self):
        corpus = _normalized(4096, 64, seed=4)
        queries = _normalized(32, 64, seed=5)
        _, exact_idx = mips_topk_numpy(queries, corpus, 50)
        v, s = quantize_int8_jnp(jnp.asarray(corpus), jax.random.PRNGKey(0))
        vals, idx = mips_topk_int8(jnp.asarray(queries), v, s, 50,
                                   block_size=1024)
        idx = np.asarray(idx)
        recalls = [
            len(set(idx[i]) & set(exact_idx[i])) / 50
            for i in range(len(queries))
        ]
        assert np.mean(recalls) >= 0.95
        # scores are descending and close to the true inner products
        assert (np.diff(np.asarray(vals), axis=1) <= 1e-6).all()

    def test_blocked_matches_single_block(self):
        corpus = _normalized(1000, 32, seed=6)
        queries = _normalized(8, 32, seed=7)
        v, s = quantize_int8_jnp(jnp.asarray(corpus), jax.random.PRNGKey(1))
        q = jnp.asarray(queries)
        v1, i1 = mips_topk_int8(q, v, s, 20, block_size=2048)
        v2, i2 = mips_topk_int8(q, v, s, 20, block_size=128)
        assert jnp.allclose(v1, v2, atol=1e-5)
        assert jnp.array_equal(i1, i2)

    def test_k_exceeds_corpus_raises(self):
        v, s = quantize_int8_jnp(jnp.asarray(_normalized(10, 8)))
        with pytest.raises(ValueError):
            mips_topk_int8(jnp.ones((1, 8)), v, s, 11)


class TestInt8Index:
    @pytest.fixture(scope="class")
    def built(self):
        embs = _normalized(500, 64, seed=8)
        ids = np.arange(100, 600, dtype=np.int64)
        idx = MIPSIndex(embedding_dim=64, dtype="int8", quant_seed=3)
        idx.build(embs, ids)
        return idx, embs, ids

    def test_self_retrieval(self, built):
        idx, embs, ids = built
        scores, got = idx.batch_search(embs[:20], k=1)
        assert (got[:, 0] == ids[:20]).mean() >= 0.9
        assert (scores[:, 0] > 0.9).all()

    def test_save_load_search_identity(self, built, tmp_path):
        idx, embs, _ = built
        p = tmp_path / "mips.index.npz"
        idx.save(str(p))
        idx2 = MIPSIndex.load(str(p))
        assert idx2.dtype == "int8" and idx2.n_total == 500
        s1, i1 = idx.batch_search(embs[:5], k=10)
        s2, i2 = idx2.batch_search(embs[:5], k=10)
        assert np.array_equal(i1, i2)
        assert np.allclose(s1, s2, atol=1e-6)

    def test_file_smaller_than_f32(self, built, tmp_path):
        idx, embs, ids = built
        p8 = tmp_path / "i8.npz"
        p32 = tmp_path / "f32.npz"
        idx.save(str(p8))
        full = MIPSIndex(embedding_dim=64)
        full.build(embs, ids)
        full.save(str(p32))
        assert p8.stat().st_size < p32.stat().st_size / 2

    def test_stats_and_searcher(self, built):
        idx, embs, _ = built
        st = idx.stats()
        assert st["dtype"] == "int8" and st["recall"] is None
        fn = idx.make_device_searcher(5)
        vals, pos = fn(jnp.asarray(embs[:3]), idx.device_corpus)
        assert vals.shape == (3, 5) and pos.shape == (3, 5)

    def test_bad_dtype_raises(self):
        with pytest.raises(ValueError):
            MIPSIndex(dtype="int4")
