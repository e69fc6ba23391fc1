"""Host-table (>HBM offload) training driver tests.

The parity test is the load-bearing one: the offload path — host gather →
device fwd/bwd on rows → host sparse update — must reproduce the in-HBM
trainer's math exactly (same losses, same final tables) when run with
synchronous prefetch and SGD rows. That validates the gather/scatter/dedup
machinery end-to-end rather than just "loss goes down".
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from recommendit_tpu.config import Settings
from recommendit_tpu.data.synthetic import make_synthetic_movielens
from recommendit_tpu.models.two_tower import (
    item_tower_from_embed,
    user_tower_from_embed,
)
from recommendit_tpu.ops.bpr import in_batch_bpr_loss
from recommendit_tpu.training.host_train import HostTableEmbeddingTrainer


def _tiny_cfg(**kw):
    base = dict(
        EMBEDDING_DIM=16, HIDDEN_DIM=24, BATCH_SIZE=64, TRAIN_EPOCHS=2,
        DROPOUT=0.0, WEIGHT_DECAY=0.0, LOSS_MODE="in_batch",
        HOST_TABLE=True, HOST_TABLE_OPTIMIZER="sgd", HOST_TABLE_LR=0.1,
        HOST_TABLE_PREFETCH=0, SEED=3,
    )
    base.update(kw)
    return Settings(**base)


@pytest.fixture(scope="module")
def data():
    return make_synthetic_movielens(n_users=80, n_items=60, n_ratings=4000,
                                    seed=1)


class TestOffloadMatchesInHBM:
    def test_sgd_offload_equals_dense_table_training(self, data, tmp_path):
        """Two epochs through the offload driver == the same schedule run
        with full device-resident tables and dense autodiff."""
        cfg = _tiny_cfg(EMBEDDING_MODEL_PATH=str(tmp_path / "m.ckpt"))
        trainer = HostTableEmbeddingTrainer(data, cfg)
        u_tab0 = np.array(trainer.user_table.table)  # pre-training snapshot
        i_tab0 = np.array(trainer.item_table.table)
        genre = jnp.asarray(trainer.genre_table)

        trainer.train(epochs=2)
        host_losses = [h["loss"] for h in trainer.history]

        # --- in-HBM reference: identical batch schedule (same seed ->
        # same permutations), full tables as device arrays, grads via
        # autodiff through the gather, raw-SGD row updates, identical
        # dense tx ---
        ref = HostTableEmbeddingTrainer(data, cfg)  # fresh, same init
        np.testing.assert_array_equal(np.array(ref.user_table.table), u_tab0)
        dense = ref._init_dense()
        n = len(ref.pos_users)
        batch_size = min(cfg.BATCH_SIZE, max(8, n // 2))
        n_batches = max(1, n // batch_size)
        schedule = optax.cosine_decay_schedule(
            cfg.LEARNING_RATE, decay_steps=2 * n_batches
        )
        wd_mask = {k: k != "item_bias" for k in dense}
        tx = optax.chain(
            optax.clip_by_global_norm(cfg.GRAD_CLIP_NORM),
            optax.adamw(schedule, weight_decay=cfg.WEIGHT_DECAY, mask=wd_mask),
        )
        opt_state = tx.init(dense)
        u_tab = jnp.asarray(u_tab0)
        i_tab = jnp.asarray(i_tab0)

        def loss_fn(dense, u_tab, i_tab, u_ids, i_ids):
            ue = user_tower_from_embed(dense, jnp.take(u_tab, u_ids, axis=0))
            ie = item_tower_from_embed(
                dense, jnp.take(i_tab, i_ids, axis=0),
                jnp.take(genre, i_ids, axis=0),
            )
            return in_batch_bpr_loss(ue, ie)

        @jax.jit
        def ref_step(dense, opt_state, u_tab, i_tab, u_ids, i_ids):
            loss, (dg, ug, ig) = jax.value_and_grad(
                loss_fn, argnums=(0, 1, 2)
            )(dense, u_tab, i_tab, u_ids, i_ids)
            updates, opt_state = tx.update(dg, opt_state, dense)
            dense = optax.apply_updates(dense, updates)
            # raw SGD on the (scatter-added) table grads — the offload
            # path's exact spec (row grads are not in the clip norm)
            u_tab = u_tab - cfg.HOST_TABLE_LR * ug
            i_tab = i_tab - cfg.HOST_TABLE_LR * ig
            return dense, opt_state, u_tab, i_tab, loss

        host_rng = np.random.default_rng(cfg.SEED)
        ref_losses = []
        for epoch in range(1, 3):
            keys = np.asarray(jax.random.split(
                jax.random.PRNGKey(cfg.SEED + 1 + epoch), n_batches
            ))
            ep = []
            for ids, _rows, _batch in ref._epoch_stream(
                host_rng, batch_size, keys
            ):
                dense, opt_state, u_tab, i_tab, loss = ref_step(
                    dense, opt_state, u_tab, i_tab,
                    jnp.asarray(ids["u"]), jnp.asarray(ids["i"]),
                )
                ep.append(float(loss))
            ref_losses.append(float(np.mean(ep)))

        np.testing.assert_allclose(host_losses, ref_losses, rtol=1e-5)
        np.testing.assert_allclose(
            np.array(trainer.user_table.table), np.asarray(u_tab),
            atol=2e-6,
        )
        np.testing.assert_allclose(
            np.array(trainer.item_table.table), np.asarray(i_tab),
            atol=2e-6,
        )

    def test_ref_stream_reads_tables_lazily(self, data):
        # guard for the reference-run trick above: _epoch_stream gathers
        # from ref's (never-updated) tables, but the ids are what matters —
        # assert the id schedule is deterministic across instances
        cfg = _tiny_cfg()
        a = HostTableEmbeddingTrainer(data, cfg)
        b = HostTableEmbeddingTrainer(data, cfg)
        keys = np.zeros((len(a.pos_users) // 32 + 1, 2), np.uint32)
        ra, rb = np.random.default_rng(5), np.random.default_rng(5)
        ia = [ids for ids, _, _ in a._epoch_stream(ra, 32, keys)]
        ib = [ids for ids, _, _ in b._epoch_stream(rb, 32, keys)]
        for x, y in zip(ia, ib):
            np.testing.assert_array_equal(x["u"], y["u"])
            np.testing.assert_array_equal(x["i"], y["i"])


class TestHostTrainerEndToEnd:
    def test_softmax_default_loss_decreases_and_model_works(self, data,
                                                            tmp_path):
        cfg = _tiny_cfg(
            LOSS_MODE="softmax", HOST_TABLE_OPTIMIZER="adagrad",
            HOST_TABLE_PREFETCH=2, TRAIN_EPOCHS=5,
            EMBEDDING_MODEL_PATH=str(tmp_path / "m.ckpt"),
        )
        trainer = HostTableEmbeddingTrainer(data, cfg)
        model = trainer.train()
        losses = [h["loss"] for h in trainer.history]
        assert losses[-1] < losses[0]
        assert model is not None
        emb = model.get_user_embedding(1)
        assert emb.shape == (16,)
        np.testing.assert_allclose(np.linalg.norm(emb), 1.0, rtol=1e-4)
        # streamed catalog == the assembled model's catalog
        streamed = trainer.embed_catalog(batch_size=17)
        ids = np.arange(1, data.n_items + 1, dtype=np.int32)
        assembled = model.get_item_embeddings(ids, trainer.genre_table[1:])
        np.testing.assert_allclose(streamed, assembled, atol=1e-6)
        # embed_users agrees with the model's user tower
        us = trainer.embed_users(np.array([1, 2, 3], np.int32))
        for j, uid in enumerate([1, 2, 3]):
            np.testing.assert_allclose(
                us[j], model.get_user_embedding(uid), atol=1e-6
            )

    def test_pairwise_mode_runs(self, data, tmp_path):
        cfg = _tiny_cfg(
            LOSS_MODE="pairwise", TRAIN_EPOCHS=2,
            EMBEDDING_MODEL_PATH=str(tmp_path / "m.ckpt"),
        )
        trainer = HostTableEmbeddingTrainer(data, cfg)
        trainer.train()
        assert len(trainer.history) == 2
        assert np.isfinite(trainer.history[-1]["loss"])

    def test_memmap_tables(self, data, tmp_path):
        cfg = _tiny_cfg(TRAIN_EPOCHS=1,
                        EMBEDDING_MODEL_PATH=str(tmp_path / "m.ckpt"))
        trainer = HostTableEmbeddingTrainer(
            data, cfg, table_dir=str(tmp_path / "tables")
        )
        assert (tmp_path / "tables" / "user_table.npy").exists()
        trainer.train()
        # memmap-backed table was actually updated on disk
        on_disk = np.load(tmp_path / "tables" / "item_table.npy",
                          mmap_mode="r")
        assert not np.allclose(on_disk[1:], 0.0)

    def test_padding_row_stays_zero(self, data, tmp_path):
        cfg = _tiny_cfg(TRAIN_EPOCHS=2,
                        EMBEDDING_MODEL_PATH=str(tmp_path / "m.ckpt"))
        trainer = HostTableEmbeddingTrainer(data, cfg)
        trainer.train()
        np.testing.assert_array_equal(trainer.user_table.table[0], 0.0)
        np.testing.assert_array_equal(trainer.item_table.table[0], 0.0)


class TestPipelineDispatch:
    def test_pipeline_embeddings_stage_uses_host_path(self, tmp_path):
        from recommendit_tpu.pipelines.run_pipeline import (
            PipelineOrchestrator,
        )

        cfg = Settings(
            DATA_DIR=str(tmp_path / "nodata"), HOST_TABLE=True,
            HOST_TABLE_PREFETCH=0, EMBEDDING_DIM=8, HIDDEN_DIM=12,
            TRAIN_EPOCHS=1, BATCH_SIZE=32,
        )
        orch = PipelineOrchestrator(cfg, synthetic=True,
                                    models_dir=str(tmp_path / "models"))
        hist = orch.run_stage("embeddings")
        assert len(hist) == 1
        assert (tmp_path / "models" / "two_tower.npz").exists()

    def test_index_stage_streams_catalog_at_hbm_scale(self, tmp_path,
                                                      monkeypatch):
        """When the tables exceed the in-HBM budget (to_model() -> None),
        the index stage must stream the catalog through embed_catalog
        instead of loading a model artifact (which doesn't exist)."""
        from recommendit_tpu.models.retrieval import MIPSIndex
        from recommendit_tpu.pipelines.run_pipeline import (
            PipelineOrchestrator,
        )
        from recommendit_tpu.training.host_train import (
            HostTableEmbeddingTrainer,
        )

        # force the >HBM branch without an actual 200M-element table
        monkeypatch.setattr(
            HostTableEmbeddingTrainer, "to_model",
            lambda self, max_elements=0: None,
        )
        cfg = Settings(
            DATA_DIR=str(tmp_path / "nodata"), HOST_TABLE=True,
            HOST_TABLE_PREFETCH=0, EMBEDDING_DIM=8, HIDDEN_DIM=12,
            TRAIN_EPOCHS=1, BATCH_SIZE=32, LOSS_MODE="softmax",
        )
        orch = PipelineOrchestrator(cfg, synthetic=True,
                                    models_dir=str(tmp_path / "models"))
        orch.run_stage("embeddings")
        assert not (tmp_path / "models" / "two_tower.npz").exists()
        orch.run_stage("index")
        idx = MIPSIndex.load(str(tmp_path / "models" / "mips.index.npz"))
        assert idx.n_total == orch._host_trainer.n_items
        # the persisted corpus is the streamed catalog (normalized)
        streamed = orch._host_trainer.embed_catalog()
        with np.load(tmp_path / "models" / "mips.index.npz") as z:
            np.testing.assert_allclose(
                z["embeddings"], streamed / np.linalg.norm(
                    streamed, axis=1, keepdims=True), atol=1e-5,
            )
        assert idx.has_bias  # softmax run -> learned bias column carried
