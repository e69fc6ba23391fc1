"""Distributed tests on the virtual 8-device CPU mesh (the JAX equivalent
of multi-node tests without a cluster — SURVEY.md §4)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from recommendit_tpu.models.two_tower import init_params, item_tower, user_tower
from recommendit_tpu.ops.bpr import in_batch_bpr_loss
from recommendit_tpu.ops.topk import mips_topk_numpy
from recommendit_tpu.parallel import (
    create_mesh,
    init_sharded_state,
    make_sharded_train_step,
    pad_to_multiple,
    row_sharded,
    sharded_embedding_lookup,
    sharded_mips_topk,
    sharded_mips_topk_ring,
    shard_params,
)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() == 8, "tests expect the virtual 8-device mesh"
    return create_mesh(shape=(2, 4))


class TestShardedLookup:
    def test_matches_dense_take(self, mesh):
        rng = np.random.default_rng(0)
        table = rng.normal(size=(64, 16)).astype(np.float32)  # 64 % 4 == 0
        ids = rng.integers(0, 64, size=32)
        t = jax.device_put(jnp.asarray(table), row_sharded(mesh))
        out = sharded_embedding_lookup(t, jnp.asarray(ids), mesh)
        np.testing.assert_allclose(np.asarray(out), table[ids], atol=1e-6)

    def test_gradient_matches_dense(self, mesh):
        rng = np.random.default_rng(1)
        table = jnp.asarray(rng.normal(size=(32, 8)), jnp.float32)
        ids = jnp.asarray(rng.integers(0, 32, size=16))
        cot = jnp.asarray(rng.normal(size=(16, 8)), jnp.float32)

        def dense(t):
            return (jnp.take(t, ids, axis=0) * cot).sum()

        def sharded(t):
            return (sharded_embedding_lookup(t, ids, mesh) * cot).sum()

        g_dense = jax.grad(dense)(table)
        t_sharded = jax.device_put(table, row_sharded(mesh))
        g_sharded = jax.grad(sharded)(t_sharded)
        np.testing.assert_allclose(
            np.asarray(g_sharded), np.asarray(g_dense), atol=1e-5
        )

    def test_indivisible_rows_raise_and_pad_fixes(self, mesh):
        table = np.ones((30, 4), np.float32)
        padded = pad_to_multiple(table, 4)
        assert padded.shape == (32, 4)
        np.testing.assert_array_equal(padded[30:], 0.0)


class TestShardedRetrieval:
    @pytest.mark.parametrize("fn", [sharded_mips_topk, sharded_mips_topk_ring])
    def test_matches_single_device(self, mesh, fn):
        rng = np.random.default_rng(2)
        q = rng.normal(size=(8, 16)).astype(np.float32)
        items = rng.normal(size=(512, 16)).astype(np.float32)
        items_dev = jax.device_put(jnp.asarray(items), row_sharded(mesh))
        vals, idx = fn(jnp.asarray(q), items_dev, 20, mesh, block_size=64)
        vn, idxn = mips_topk_numpy(q, items, 20)
        np.testing.assert_allclose(np.asarray(vals), vn, rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(idx), idxn)

    @pytest.mark.parametrize("fn", [sharded_mips_topk, sharded_mips_topk_ring])
    def test_tied_scores_match_single_device(self, mesh, fn):
        """Exact f32 score ties across shards (real corpora produce them —
        round-3 quality-at-scale hit ~12/batch at 62k items) must come back
        in the canonical (value desc, index asc) order on every path."""
        rng = np.random.default_rng(4)
        base = rng.normal(size=(64, 16)).astype(np.float32)
        # each row duplicated 8x, shuffled -> duplicates land on different
        # shards; every top-k boundary then sits inside a tie group
        items = np.repeat(base, 8, axis=0)
        perm = rng.permutation(512)
        items = items[perm]
        q = rng.normal(size=(8, 16)).astype(np.float32)
        items_dev = jax.device_put(jnp.asarray(items), row_sharded(mesh))
        # k=24 = 3 full tie-groups of 8: the k-th score's whole group is
        # included, so even the boundary is set-unambiguous here
        vals, idx = fn(jnp.asarray(q), items_dev, 24, mesh, block_size=64,
                       canonical=True)
        vn, idxn = mips_topk_numpy(q, items, 24)
        np.testing.assert_allclose(np.asarray(vals), vn, rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(idx), idxn)

    def test_k_larger_than_shard(self, mesh):
        """k > rows-per-shard exercises the per-shard padding path."""
        rng = np.random.default_rng(3)
        q = rng.normal(size=(4, 8)).astype(np.float32)
        items = rng.normal(size=(64, 8)).astype(np.float32)  # 16 rows/shard
        items_dev = jax.device_put(jnp.asarray(items), row_sharded(mesh))
        vals, idx = sharded_mips_topk(jnp.asarray(q), items_dev, 40, mesh,
                                      block_size=16)
        vn, idxn = mips_topk_numpy(q, items, 40)
        np.testing.assert_array_equal(np.asarray(idx), idxn)


class TestShardedTrainStep:
    def test_loss_matches_single_device_and_decreases(self, mesh):
        rng = np.random.default_rng(4)
        n_users, n_items, d, h, b = 64, 64, 16, 32, 32
        params = init_params(jax.random.PRNGKey(0), n_users - 1, n_items - 1,
                             d, h)
        genre_table = jnp.asarray(
            (rng.random((n_items, 18)) < 0.2).astype(np.float32)
        )
        u_ids = jnp.asarray(rng.integers(1, n_users, size=b))
        i_ids = jnp.asarray(rng.integers(1, n_items, size=b))
        key = jax.random.PRNGKey(7)

        tx = optax.adam(1e-2)

        # single-device reference step
        def ref_loss(p):
            ue = user_tower(p, u_ids)
            ie = item_tower(p, i_ids, jnp.take(genre_table, i_ids, axis=0))
            return in_batch_bpr_loss(ue, ie)

        ref_l, ref_grads = jax.value_and_grad(ref_loss)(params)

        step = make_sharded_train_step(mesh, tx, genre_table, dropout_rate=0.0)
        sp, so = init_sharded_state(mesh, tx, params)
        sp2, so2, loss = step(sp, so, (u_ids, i_ids), key)
        assert float(loss) == pytest.approx(float(ref_l), abs=1e-5)

        # several steps decrease the loss
        losses = [float(loss)]
        for t in range(5):
            sp2, so2, loss = step(sp2, so2, (u_ids, i_ids),
                                  jax.random.fold_in(key, t))
            losses.append(float(loss))
        assert losses[-1] < losses[0]

    def test_optimizer_moments_are_sharded(self, mesh):
        """jit(tx.init) alone lands the whole opt state on device 0 —
        init_sharded_state must pin the table moments to the table's
        row sharding and everything else replicated (global)."""
        params = init_params(jax.random.PRNGKey(1), 31, 31, 8, 16)
        tx = optax.adam(1e-2)
        sp, so = init_sharded_state(mesh, tx, params)
        n_dev = len(jax.devices())
        for leaf in jax.tree_util.tree_leaves(so):
            assert len(leaf.sharding.device_set) == n_dev, leaf
        # adam mu of the row-sharded table mirrors the param sharding
        mu = so[0].mu if hasattr(so[0], "mu") else so[1].mu
        assert mu["user_embed"].sharding == sp["user_embed"].sharding

    def test_table_sharding_preserved_across_steps(self, mesh):
        params = init_params(jax.random.PRNGKey(1), 31, 31, 8, 16)
        genre_table = jnp.zeros((32, 18))
        tx = optax.sgd(1e-2)
        step = make_sharded_train_step(mesh, tx, genre_table)
        sp, so = init_sharded_state(mesh, tx, params)
        u = jnp.arange(8) + 1
        sp, so, _ = step(sp, so, (u, u), jax.random.PRNGKey(0))
        spec = sp["user_embed"].sharding.spec
        assert spec == P("model") or spec == P("model", None)


class TestShardedServe:
    def test_full_serve_path_on_mesh(self, mesh):
        """The complete two-stage serve program (sharded corpus, DP users)
        runs on the mesh and matches a single-device reference."""
        import jax
        from recommendit_tpu.features.schema import (
            ITEM_PACKED_DIM,
            USER_PACKED_DIM,
            assemble_packed_jnp,
        )
        from recommendit_tpu.models.ranker import init_mlp, mlp_score
        from recommendit_tpu.models.two_tower import init_params, user_tower
        from recommendit_tpu.ops.topk import fast_topk, mips_topk
        from recommendit_tpu.parallel import make_sharded_serve_fn, row_sharded

        rng = np.random.default_rng(0)
        n_users, n_items, d = 64, 128, 16
        params = init_params(jax.random.PRNGKey(0), n_users - 1, n_items - 1,
                             d, 32)
        corpus = rng.normal(size=(n_items, d)).astype(np.float32)
        corpus_dev = jax.device_put(jnp.asarray(corpus), row_sharded(mesh))
        ids = jnp.arange(1, n_items + 1, dtype=jnp.int32)
        user_packed = jnp.asarray(
            rng.normal(size=(n_users, USER_PACKED_DIM)), jnp.float32)
        item_packed = jnp.asarray(
            rng.normal(size=(n_items + 1, ITEM_PACKED_DIM)), jnp.float32)
        rparams = init_mlp(jax.random.PRNGKey(1), 50, (16,))
        score_fn = lambda f: mlp_score(rparams, f)  # noqa: E731

        serve = make_sharded_serve_fn(
            mesh, params, corpus_dev, ids, user_packed, item_packed,
            score_fn, n_candidates=32, k_out=8, block_size=32,
        )
        uids = jnp.asarray(rng.integers(1, n_users, size=16), jnp.int32)
        got_ids, got_scores, got_rvals = serve(uids)

        # single-device reference
        q = user_tower(params, uids)
        rvals, pos = mips_topk(q, jnp.asarray(corpus), 32, 32)
        cand = jnp.take(ids, pos)
        feats = jax.vmap(
            lambda uv, ci: assemble_packed_jnp(
                uv, jnp.take(item_packed, ci, axis=0))
        )(jnp.take(user_packed, uids, axis=0), cand)
        scores = score_fn(feats)
        tv, sel = fast_topk(scores, 8)
        ref_ids = jnp.take_along_axis(cand, sel, axis=1)

        np.testing.assert_array_equal(np.asarray(got_ids), np.asarray(ref_ids))
        np.testing.assert_allclose(np.asarray(got_scores), np.asarray(tv),
                                   atol=1e-5)


class TestBucketedLookup:
    """Ring all-to-all lookup variant for large batches (ROADMAP §6)."""

    def test_matches_dense_take(self, mesh):
        from recommendit_tpu.parallel import bucketed_embedding_lookup

        rng = np.random.default_rng(2)
        table = rng.normal(size=(64, 16)).astype(np.float32)
        ids = rng.integers(0, 64, size=32)  # 32 % 4 == 0
        t = jax.device_put(jnp.asarray(table), row_sharded(mesh))
        out = bucketed_embedding_lookup(t, jnp.asarray(ids), mesh,
                                        replicate_out=True)
        np.testing.assert_allclose(np.asarray(out), table[ids], atol=1e-6)

    def test_sharded_out_matches(self, mesh):
        from recommendit_tpu.parallel import bucketed_embedding_lookup

        rng = np.random.default_rng(3)
        table = rng.normal(size=(32, 8)).astype(np.float32)
        ids = rng.integers(0, 32, size=16)
        t = jax.device_put(jnp.asarray(table), row_sharded(mesh))
        out = bucketed_embedding_lookup(t, jnp.asarray(ids), mesh)
        np.testing.assert_allclose(np.asarray(out), table[ids], atol=1e-6)

    def test_matches_masked_psum(self, mesh):
        from recommendit_tpu.parallel import bucketed_embedding_lookup

        rng = np.random.default_rng(4)
        table = rng.normal(size=(64, 4)).astype(np.float32)
        ids = rng.integers(0, 64, size=64)
        t = jax.device_put(jnp.asarray(table), row_sharded(mesh))
        a = bucketed_embedding_lookup(t, jnp.asarray(ids), mesh,
                                      replicate_out=True)
        b = sharded_embedding_lookup(t, jnp.asarray(ids), mesh)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    def test_gradient_matches_dense(self, mesh):
        from recommendit_tpu.parallel import bucketed_embedding_lookup

        rng = np.random.default_rng(5)
        table = jnp.asarray(rng.normal(size=(32, 8)), jnp.float32)
        ids = jnp.asarray(rng.integers(0, 32, size=16))
        cot = jnp.asarray(rng.normal(size=(16, 8)), jnp.float32)

        def dense(t):
            return (jnp.take(t, ids, axis=0) * cot).sum()

        def ring(t):
            return (
                bucketed_embedding_lookup(t, ids, mesh, replicate_out=True)
                * cot
            ).sum()

        g_dense = jax.grad(dense)(table)
        t_sharded = jax.device_put(table, row_sharded(mesh))
        g_ring = jax.grad(ring)(t_sharded)
        np.testing.assert_allclose(
            np.asarray(g_ring), np.asarray(g_dense), atol=1e-5
        )

    def test_indivisible_batch_raises(self, mesh):
        from recommendit_tpu.parallel import bucketed_embedding_lookup

        table = jnp.zeros((32, 4))
        t = jax.device_put(table, row_sharded(mesh))
        with pytest.raises(ValueError, match="divide"):
            bucketed_embedding_lookup(t, jnp.zeros(30, jnp.int32), mesh)
