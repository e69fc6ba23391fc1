"""Model-layer tests (strategy mirrors reference tests/test_models.py:
real small models, shape/norm invariants, loss-decreases smoke training,
save/load round-trips, index self-retrieval and persistence)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recommendit_tpu.models.retrieval import MIPSIndex
from recommendit_tpu.models.two_tower import (
    TwoTowerModel,
    init_params,
    item_tower,
    user_tower,
)


class TestTowers:
    @pytest.fixture
    def params(self):
        return init_params(jax.random.PRNGKey(0), n_users=50, n_items=80,
                           embed_dim=16, hidden_dim=32)

    def test_user_tower_shape_and_norm(self, params):
        ids = jnp.asarray([1, 2, 3, 49])
        out = user_tower(params, ids)
        assert out.shape == (4, 16)
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(out), axis=1), 1.0, atol=1e-5
        )

    def test_item_tower_uses_genres(self, params):
        ids = jnp.asarray([5, 5])
        g1 = jnp.zeros((2, 18)).at[0, 0].set(1.0)
        out = item_tower(params, ids, g1)
        # same id, different genre vec → different embedding
        assert not np.allclose(np.asarray(out[0]), np.asarray(out[1]))

    def test_dropout_only_with_rng(self, params):
        ids = jnp.asarray([1, 2, 3])
        a = user_tower(params, ids, dropout_rate=0.5, rng=None)
        b = user_tower(params, ids)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
        c = user_tower(params, ids, dropout_rate=0.5, rng=jax.random.PRNGKey(1))
        assert not np.allclose(np.asarray(b), np.asarray(c))

    def test_training_decreases_loss(self, params):
        """20-step smoke training on random interactions (reference
        tests/test_models.py:93-112)."""
        import optax

        from recommendit_tpu.ops.bpr import in_batch_bpr_loss

        rng = np.random.default_rng(0)
        u_ids = jnp.asarray(rng.integers(1, 51, size=64))
        i_ids = jnp.asarray(rng.integers(1, 81, size=64))
        genres = jnp.asarray((rng.random((64, 18)) < 0.2).astype(np.float32))

        tx = optax.adam(1e-2)
        opt_state = tx.init(params)

        @jax.jit
        def step(params, opt_state):
            def loss_fn(p):
                ue = user_tower(p, u_ids)
                ie = item_tower(p, i_ids, genres)
                return in_batch_bpr_loss(ue, ie)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        first = None
        for _ in range(20):
            params, opt_state, loss = step(params, opt_state)
            if first is None:
                first = float(loss)
        assert float(loss) < first


class TestTwoTowerModel:
    def test_save_load_roundtrip(self, tmp_path):
        m = TwoTowerModel(n_users=30, n_items=40, embed_dim=8, hidden_dim=16)
        path = str(tmp_path / "model.npz")
        m.save(path)
        m2 = TwoTowerModel.load(path)
        assert m2.n_users == 30 and m2.embed_dim == 8
        for k in m.params:
            np.testing.assert_allclose(
                np.asarray(m.params[k]), np.asarray(m2.params[k])
            )
        # identical outputs
        np.testing.assert_allclose(
            m.get_user_embedding(7), m2.get_user_embedding(7), atol=1e-6
        )

    def test_user_id_bounds(self):
        m = TwoTowerModel(n_users=10, n_items=10, embed_dim=8, hidden_dim=8)
        with pytest.raises(ValueError):
            m.get_user_embedding(11)

    def test_load_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            TwoTowerModel.load(str(tmp_path / "nope.npz"))


class TestMIPSIndex:
    @pytest.fixture
    def built(self):
        rng = np.random.default_rng(7)
        embs = rng.normal(size=(500, 32)).astype(np.float32)
        embs /= np.linalg.norm(embs, axis=1, keepdims=True)
        ids = np.arange(1000, 1500)
        idx = MIPSIndex(embedding_dim=32, block_size=128)
        idx.build(embs, ids)
        return idx, embs, ids

    def test_search_returns_k(self, built):
        idx, embs, ids = built
        scores, got = idx.search(embs[0], k=10)
        assert scores.shape == (10,) and got.shape == (10,)
        assert got[0] == 1000  # self-retrieval
        assert scores[0] == pytest.approx(1.0, abs=1e-4)

    def test_scores_monotonic(self, built):
        idx, embs, _ = built
        scores, _ = idx.search(embs[3], k=50)
        assert (np.diff(scores) <= 1e-6).all()

    def test_k_capped_at_ntotal(self, built):
        idx, embs, _ = built
        scores, got = idx.search(embs[0], k=10_000)
        assert len(got) == 500

    def test_verified_mode_matches_exact(self, built):
        """mode='verified' (certified two-pass + escalation) must return
        the same ids/scores as the exact scan — recall 1.0, by proof."""
        idx, embs, ids = built
        vidx = MIPSIndex(embedding_dim=32, block_size=128, mode="verified")
        vidx.build(embs, ids)
        assert vidx.stats()["recall"] == 1.0
        qs = embs[:9] + 0.01 * np.random.default_rng(3).normal(
            size=(9, 32)).astype(np.float32)
        sv, iv = vidx.batch_search(qs, k=40)
        se, ie = idx.batch_search(qs, k=40)
        np.testing.assert_array_equal(iv, ie)
        np.testing.assert_allclose(sv, se, rtol=1e-5)

    def test_batch_search(self, built):
        idx, embs, ids = built
        scores, got = idx.batch_search(embs[:7], k=5)
        assert scores.shape == (7, 5)
        np.testing.assert_array_equal(got[:, 0], ids[:7])

    def test_query_normalized_internally(self, built):
        idx, embs, _ = built
        s1, i1 = idx.search(embs[0], k=5)
        s2, i2 = idx.search(embs[0] * 7.3, k=5)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(s1, s2, atol=1e-5)

    def test_save_load_search_identity(self, built, tmp_path):
        idx, embs, _ = built
        path = str(tmp_path / "index.npz")
        idx.save(path)
        idx2 = MIPSIndex.load(path)
        s1, i1 = idx.batch_search(embs[:4], k=20)
        s2, i2 = idx2.batch_search(embs[:4], k=20)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(s1, s2, atol=1e-6)

    def test_unbuilt_raises(self):
        with pytest.raises(RuntimeError):
            MIPSIndex(embedding_dim=8).search(np.zeros(8), k=1)

    def test_stats(self, built):
        idx, _, _ = built
        st = idx.stats()
        assert st["n_total"] == 500 and st["recall"] == 1.0

    def test_bfloat16_corpus(self, built):
        """bf16 corpus storage: half the HBM, recall preserved at top-k
        (scores still accumulate in f32)."""
        _, embs, ids = built
        bf = MIPSIndex(embedding_dim=32, block_size=128, dtype="bfloat16")
        bf.build(embs, ids)
        s32, i32 = built[0].batch_search(embs[:10], k=10)
        s16, i16 = bf.batch_search(embs[:10], k=10)
        # self-retrieval must survive quantization
        np.testing.assert_array_equal(i16[:, 0], ids[:10])
        # top-10 overlap stays high
        overlap = np.mean([
            len(set(i32[r]) & set(i16[r])) / 10 for r in range(10)
        ])
        assert overlap > 0.8
        # dtype survives save/load
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            bf.save(f"{d}/i.npz")
            re = MIPSIndex.load(f"{d}/i.npz")
            assert re.dtype == "bfloat16"
            assert str(re._embs.dtype) == "bfloat16"

    def test_fused_mode_self_retrieval(self, built):
        """mode='fused' routes through the window engine (exact scan at
        this corpus size) and still self-retrieves."""
        _, embs, ids = built
        fused = MIPSIndex(embedding_dim=32, block_size=128, mode="fused")
        fused.build(embs, ids)
        scores, got = fused.batch_search(embs[:5], k=3)
        np.testing.assert_array_equal(got[:, 0], ids[:5])


class TestEmbeddingTrainer:
    def test_end_to_end_small(self, synthetic_data, tmp_path):
        from recommendit_tpu.config import Settings
        from recommendit_tpu.training.train_embeddings import EmbeddingTrainer

        cfg = Settings(
            EMBEDDING_DIM=16, HIDDEN_DIM=32, BATCH_SIZE=128,
            TRAIN_EPOCHS=3, SEED=0,
        )
        trainer = EmbeddingTrainer(
            synthetic_data, cfg,
            model_output_path=str(tmp_path / "tt.npz"),
            ckpt_dir=str(tmp_path / "ckpt"),
        )
        model = trainer.train()
        assert len(trainer.history) == 3
        losses = [h["loss"] for h in trainer.history]
        assert losses[-1] < losses[0]
        assert model._item_embeddings.shape == (synthetic_data.n_items, 16)
        # checkpoint was written and restores
        from recommendit_tpu.utils.checkpoint import load_train_state

        state = load_train_state(str(tmp_path / "ckpt" / "best"))
        assert "params" in state and "opt_state" in state

    def test_resume_from_checkpoint(self, synthetic_data, tmp_path):
        """Mid-training resume restores params + optimizer state + epoch."""
        from recommendit_tpu.config import Settings
        from recommendit_tpu.training.train_embeddings import EmbeddingTrainer

        cfg = Settings(EMBEDDING_DIM=8, HIDDEN_DIM=16, BATCH_SIZE=128,
                       TRAIN_EPOCHS=4, SEED=0)
        t1 = EmbeddingTrainer(
            synthetic_data, cfg,
            model_output_path=str(tmp_path / "a.npz"),
            ckpt_dir=str(tmp_path / "ckpt"),
        )
        t1.train(epochs=2)
        assert (tmp_path / "ckpt" / "best").exists()

        t2 = EmbeddingTrainer(
            synthetic_data, cfg,
            model_output_path=str(tmp_path / "b.npz"),
            ckpt_dir=None,
        )
        t2.train(epochs=4, resume_from=str(tmp_path / "ckpt" / "best"))
        # resumed run only executes the remaining epochs
        epochs_run = [h["epoch"] for h in t2.history]
        assert epochs_run[0] > 1 and epochs_run[-1] == 4

    def test_step_jit_scope_matches_epoch_scan(self, synthetic_data, tmp_path):
        """TRAIN_JIT_SCOPE='step' (the remote-compile-hang workaround,
        ROADMAP §3) runs the same math as the epoch lax.scan."""
        from recommendit_tpu.config import Settings
        from recommendit_tpu.training.train_embeddings import EmbeddingTrainer

        base = dict(EMBEDDING_DIM=8, HIDDEN_DIM=16, BATCH_SIZE=128,
                    TRAIN_EPOCHS=2, SEED=0, DROPOUT=0.0)
        t_epoch = EmbeddingTrainer(
            synthetic_data, Settings(**base),
            model_output_path=str(tmp_path / "e.npz"),
        )
        t_epoch.train()
        t_step = EmbeddingTrainer(
            synthetic_data, Settings(TRAIN_JIT_SCOPE="step", **base),
            model_output_path=str(tmp_path / "s.npz"),
        )
        t_step.train()
        le = [h["loss"] for h in t_epoch.history]
        ls = [h["loss"] for h in t_step.history]
        np.testing.assert_allclose(le, ls, rtol=1e-4)

    def test_chunk_jit_scope_matches_epoch_scan(self, synthetic_data,
                                                tmp_path):
        """TRAIN_JIT_SCOPE='chunk' (jitted scan over N-batch chunks — the
        dispatch-amortizing middle ground) runs the same math as the epoch
        lax.scan, including the non-divisible remainder chunk."""
        from recommendit_tpu.config import Settings
        from recommendit_tpu.training.train_embeddings import EmbeddingTrainer

        base = dict(EMBEDDING_DIM=8, HIDDEN_DIM=16, BATCH_SIZE=128,
                    TRAIN_EPOCHS=2, SEED=0, DROPOUT=0.0)
        t_epoch = EmbeddingTrainer(
            synthetic_data, Settings(**base),
            model_output_path=str(tmp_path / "e.npz"),
        )
        t_epoch.train()
        # chunk=3 guarantees a remainder chunk unless n_batches % 3 == 0
        t_chunk = EmbeddingTrainer(
            synthetic_data,
            Settings(TRAIN_JIT_SCOPE="chunk", TRAIN_CHUNK_BATCHES=3, **base),
            model_output_path=str(tmp_path / "c.npz"),
        )
        t_chunk.train()
        le = [h["loss"] for h in t_epoch.history]
        lc = [h["loss"] for h in t_chunk.history]
        np.testing.assert_allclose(le, lc, rtol=1e-4)

    def test_pairwise_mode(self, synthetic_data, tmp_path):
        from recommendit_tpu.config import Settings
        from recommendit_tpu.training.train_embeddings import EmbeddingTrainer

        cfg = Settings(
            EMBEDDING_DIM=8, HIDDEN_DIM=16, BATCH_SIZE=128,
            TRAIN_EPOCHS=2,
        )
        trainer = EmbeddingTrainer(
            synthetic_data, cfg, loss_mode="pairwise",
            model_output_path=str(tmp_path / "tt.npz"),
        )
        model = trainer.train()
        losses = [h["loss"] for h in trainer.history]
        assert losses[-1] < losses[0]
