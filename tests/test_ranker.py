"""Ranker tests (strategy mirrors reference tests/test_models.py:253-364:
synthetic query-grouped data, train/predict/importance/save-load/
untrained-raises), plus LambdaRank loss unit properties."""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from recommendit_tpu.models.ranker import (
    LambdaRankScorer,
    group_ndcg_at_k,
    lambdarank_loss,
    pack_groups,
)


def make_ranker_data(n_queries=40, group=30, n_features=10, seed=0):
    """Synthetic LTR data where the label depends on a known feature mix
    (reference _make_ranker_data, tests/test_models.py:253-273)."""
    rng = np.random.default_rng(seed)
    rows = []
    for q in range(n_queries):
        X = rng.normal(size=(group, n_features)).astype(np.float32)
        relevance = X[:, 0] * 2.0 + X[:, 1] - 0.5 * X[:, 2]
        thresh = np.quantile(relevance, 0.8)
        label = (relevance >= thresh).astype(np.int64)
        for i in range(group):
            row = {f"f{j}": X[i, j] for j in range(n_features)}
            row.update({"label": label[i], "query_id": q, "item_id": q * group + i})
            rows.append(row)
    return pd.DataFrame(rows)


FEATURES = [f"f{j}" for j in range(10)]


class TestLambdaRankLoss:
    def test_perfect_ranking_lower_loss(self):
        gains = jnp.asarray([3.0, 1.0, 0.0, 0.0])
        mask = jnp.ones(4)
        good = lambdarank_loss(jnp.asarray([3.0, 2.0, 1.0, 0.0]), gains, mask)
        bad = lambdarank_loss(jnp.asarray([0.0, 1.0, 2.0, 3.0]), gains, mask)
        assert float(good) < float(bad)

    def test_mask_ignores_padding(self):
        gains = jnp.asarray([1.0, 0.0, 5.0, 5.0])
        scores = jnp.asarray([2.0, 1.0, -3.0, 7.0])
        mask = jnp.asarray([1.0, 1.0, 0.0, 0.0])
        l1 = lambdarank_loss(scores, gains, mask)
        # padding values must not matter
        l2 = lambdarank_loss(
            jnp.asarray([2.0, 1.0, 100.0, -100.0]),
            jnp.asarray([1.0, 0.0, 2.0, 0.0]),
            mask,
        )
        assert float(l1) == pytest.approx(float(l2), abs=1e-6)

    def test_no_valid_pairs_zero(self):
        gains = jnp.zeros(4)
        loss = lambdarank_loss(jnp.asarray([1.0, 2.0, 3.0, 4.0]), gains,
                               jnp.ones(4))
        assert float(loss) == 0.0

    def test_group_ndcg(self):
        gains = jnp.asarray([1.0, 1.0, 0.0, 0.0])
        mask = jnp.ones(4)
        perfect, valid = group_ndcg_at_k(
            jnp.asarray([4.0, 3.0, 2.0, 1.0]), gains, mask, 4
        )
        assert bool(valid) and float(perfect) == pytest.approx(1.0)


class TestPackGroups:
    def test_shapes_and_masks(self):
        rng = np.random.default_rng(0)
        X = rng.normal(size=(100, 5)).astype(np.float32)
        y = rng.integers(0, 2, size=100)
        q = np.repeat(np.arange(10), 10)
        xs, gs, ms = pack_groups(X, y, q, group_size=16)
        assert xs.shape == (10, 16, 5)
        assert (ms.sum(axis=1) == 10).all()

    def test_long_query_chunked(self):
        X = np.zeros((50, 3), np.float32)
        y = np.zeros(50, np.int64)
        q = np.zeros(50, np.int64)
        xs, gs, ms = pack_groups(X, y, q, group_size=16)
        assert len(xs) == 4  # 16+16+16+2
        assert ms.sum() == 50

    def test_label_gain_applied(self):
        X = np.zeros((3, 2), np.float32)
        y = np.asarray([0, 1, 4])
        q = np.zeros(3, np.int64)
        _, gs, _ = pack_groups(X, y, q, group_size=4,
                               label_gain=(0, 1, 3, 7, 15))
        assert sorted(gs[0][:3].tolist()) == [0.0, 1.0, 15.0]


class TestLambdaRankScorer:
    @pytest.fixture(scope="class")
    def trained(self):
        df = make_ranker_data()
        valid = make_ranker_data(n_queries=10, seed=1)
        r = LambdaRankScorer(hidden_dims=(32, 16), epochs=15, group_size=32,
                             learning_rate=1e-2, seed=0)
        r.train(df, FEATURES, valid_df=valid, verbose_eval=100)
        return r, df

    def test_learns_ranking(self, trained):
        """Scores must rank relevant items above irrelevant within queries."""
        r, df = trained
        test = make_ranker_data(n_queries=10, seed=9)
        scores = r.predict(test)
        test = test.copy()
        test["score"] = scores
        ndcgs = []
        from recommendit_tpu.evaluation.metrics import ndcg_at_k

        for _, g in test.groupby("query_id"):
            ranked = g.sort_values("score", ascending=False)["item_id"].tolist()
            rel = g[g["label"] == 1]["item_id"].tolist()
            ndcgs.append(ndcg_at_k(ranked, rel, 10))
        assert np.mean(ndcgs) > 0.6  # random ≈ 0.25 on this data

    def test_predict_shape(self, trained):
        r, df = trained
        assert r.predict(df.head(17)).shape == (17,)

    def test_feature_importance_finds_signal(self, trained):
        r, _ = trained
        imp = r.feature_importance()
        assert set(imp.keys()) == set(FEATURES)
        top = [f for f, _ in r.top_features(3)]
        assert "f0" in top  # strongest synthetic signal

    def test_save_load_predict_identity(self, trained, tmp_path):
        r, df = trained
        p = str(tmp_path / "ranker.npz")
        r.save(p)
        r2 = LambdaRankScorer.load(p)
        np.testing.assert_allclose(
            r.predict(df.head(50)), r2.predict(df.head(50)), atol=1e-6
        )
        assert r2.feature_names == r.feature_names

    def test_untrained_raises(self):
        with pytest.raises(RuntimeError):
            LambdaRankScorer().predict(np.zeros((3, 5)))
        with pytest.raises(FileNotFoundError):
            LambdaRankScorer.load("/nonexistent/ranker.npz")

    def test_model_info(self, trained):
        r, _ = trained
        info = r.model_info()
        assert info["trained"] and info["n_features"] == 10
        assert len(info["top_features"]) == 10

    def test_early_stopping_recorded(self, trained):
        r, _ = trained
        assert r.best_iteration >= 1
        assert len(r.evals_result["valid_ndcg@10"]) >= r.best_iteration


class TestLossVariants:
    """New group losses (lambdaloss NDCG-Loss2, listwise softmax) and
    per-candidate-set normalization."""

    @pytest.mark.parametrize("loss_type", ["lambdaloss", "softmax"])
    def test_variant_learns_ranking(self, loss_type):
        df = make_ranker_data()
        valid = make_ranker_data(n_queries=10, seed=1)
        r = LambdaRankScorer(hidden_dims=(32, 16), epochs=15, group_size=32,
                             learning_rate=1e-2, seed=0, loss_type=loss_type)
        r.train(df, FEATURES, valid_df=valid, verbose_eval=100)
        test = make_ranker_data(n_queries=10, seed=9)
        test = test.copy()
        test["score"] = r.predict(test)
        from recommendit_tpu.evaluation.metrics import ndcg_at_k

        ndcgs = []
        for _, g in test.groupby("query_id"):
            ranked = g.sort_values("score", ascending=False)["item_id"].tolist()
            rel = g[g["label"] == 1]["item_id"].tolist()
            ndcgs.append(ndcg_at_k(ranked, rel, 10))
        assert np.mean(ndcgs) > 0.6

    def test_variant_ordering_properties(self):
        from recommendit_tpu.models.ranker import (
            lambdaloss_ndcg2,
            softmax_listwise_loss,
        )

        gains = jnp.asarray([3.0, 1.0, 0.0, 0.0])
        mask = jnp.ones(4)
        good = jnp.asarray([3.0, 2.0, 1.0, 0.0])
        bad = jnp.asarray([0.0, 1.0, 2.0, 3.0])
        for fn in (lambdaloss_ndcg2, softmax_listwise_loss):
            assert float(fn(good, gains, mask)) < float(fn(bad, gains, mask))

    def test_softmax_mask_ignores_padding(self):
        from recommendit_tpu.models.ranker import softmax_listwise_loss

        gains = jnp.asarray([1.0, 0.0, 5.0, 5.0])
        scores = jnp.asarray([2.0, 1.0, -3.0, 7.0])
        mask = jnp.asarray([1.0, 1.0, 0.0, 0.0])
        l1 = softmax_listwise_loss(scores, gains, mask)
        l2 = softmax_listwise_loss(
            jnp.asarray([2.0, 1.0, 50.0, -50.0]),
            jnp.asarray([1.0, 0.0, 9.0, 9.0]),
            mask,
        )
        assert float(l1) == pytest.approx(float(l2), abs=1e-5)

    def test_unknown_loss_raises(self):
        with pytest.raises(ValueError):
            LambdaRankScorer(loss_type="bogus")


class TestQueryNorm:
    def test_per_query_normalize_stats(self):
        from recommendit_tpu.models.ranker import per_query_normalize

        rng = np.random.default_rng(0)
        X = rng.normal(3.0, 5.0, size=(60, 4)).astype(np.float32)
        q = np.repeat(np.arange(3), 20)
        Xn = per_query_normalize(X, q)
        for qid in range(3):
            block = Xn[q == qid]
            assert np.allclose(block.mean(axis=0), 0.0, atol=1e-4)
            assert np.allclose(block.std(axis=0), 1.0, atol=1e-3)

    def test_constant_column_normalizes_to_zero(self):
        """A column constant within each group (every user-level feature)
        normalizes to exactly 0 whatever the row order, so no rounding
        residue of its mean is blown up by the std floor; the other columns
        still come out with mean 0 and std 1 per group."""
        from recommendit_tpu.models.ranker import per_query_normalize

        rng = np.random.default_rng(0)
        n_q, group = 8, 500
        q = np.repeat(np.arange(n_q), group)
        X = rng.normal(3.0, 5.0, size=(n_q * group, 6)).astype(np.float32)
        X[:, :3] = rng.normal(0.0, 7.0, size=(n_q, 3)).astype(np.float32)[q]
        perm = rng.permutation(len(q))
        for Xp, qp in ((X, q), (X[perm], q[perm])):
            Xn = per_query_normalize(Xp, qp)
            assert (Xn[:, :3] == 0.0).all()
            for qid in range(n_q):
                block = Xn[qp == qid, 3:]
                assert np.allclose(block.mean(axis=0), 0.0, atol=1e-4)
                assert np.allclose(block.std(axis=0), 1.0, atol=1e-3)

    def test_device_scorer_constant_column_is_zero(self):
        """On the device path a set-constant column contributes exactly
        what any other constant does (its normalized value is 0), rows in
        another order score the same, and the host path agrees."""
        df = make_ranker_data(n_queries=6)
        r = LambdaRankScorer(hidden_dims=(16,), epochs=2, group_size=32,
                             seed=0, query_norm=True)
        r.train(df, FEATURES, verbose_eval=100)
        fn = r.make_device_scorer()
        rng = np.random.default_rng(2)
        base = rng.normal(size=(500, 10)).astype(np.float32)
        ref = None
        for _ in range(4):
            cand = base.copy()
            cand[:, :3] = rng.normal(0.0, 7.0, size=3).astype(np.float32)
            out = np.asarray(fn(jnp.asarray(cand)))
            if ref is None:
                ref = out
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
            perm = rng.permutation(len(cand))
            np.testing.assert_allclose(
                np.asarray(fn(jnp.asarray(cand[perm]))), out[perm],
                rtol=0, atol=1e-5)
            np.testing.assert_allclose(r.predict(cand), out, rtol=0,
                                       atol=1e-4)

    def test_query_norm_train_predict_save_load(self, tmp_path):
        df = make_ranker_data()
        r = LambdaRankScorer(hidden_dims=(16,), epochs=5, group_size=32,
                             seed=0, query_norm=True, loss_type="softmax")
        r.train(df, FEATURES, verbose_eval=100)
        test = make_ranker_data(n_queries=4, seed=3)
        s1 = r.predict(test)
        assert s1.shape == (len(test),)
        p = tmp_path / "r.npz"
        r.save(str(p))
        r2 = LambdaRankScorer.load(str(p))
        assert r2.query_norm and r2.loss_type == "softmax"
        assert np.allclose(r2.predict(test), s1, atol=1e-5)

    def test_device_scorer_matches_host_single_set(self):
        """make_device_scorer on one candidate set == predict (no query col)."""
        df = make_ranker_data(n_queries=6)
        r = LambdaRankScorer(hidden_dims=(16,), epochs=4, group_size=32,
                             seed=0, query_norm=True)
        r.train(df, FEATURES, verbose_eval=100)
        one_set = make_ranker_data(n_queries=1, seed=5)
        host = r.predict(one_set[FEATURES].values)
        dev = np.asarray(
            r.make_device_scorer()(
                jnp.asarray(one_set[FEATURES].values.astype(np.float32))
            )
        )
        assert np.allclose(host, dev, atol=1e-4)

    def test_device_scorer_batched_axis(self):
        """(B, C, F) scoring normalizes over C independently per row."""
        df = make_ranker_data(n_queries=6)
        r = LambdaRankScorer(hidden_dims=(16,), epochs=4, group_size=32,
                             seed=0, query_norm=True)
        r.train(df, FEATURES, verbose_eval=100)
        rng = np.random.default_rng(1)
        batch = rng.normal(size=(3, 20, 10)).astype(np.float32)
        fn = r.make_device_scorer()
        out = np.asarray(fn(jnp.asarray(batch)))
        rows = np.stack(
            [np.asarray(fn(jnp.asarray(batch[i]))) for i in range(3)]
        )
        assert out.shape == (3, 20)
        assert np.allclose(out, rows, atol=1e-5)


class TestHardNegativeMining:
    """RANKER_HARD_NEG_FRAC: negatives mined from the tower's top unrated
    candidates (train distribution ≈ serving candidate sets)."""

    @pytest.fixture(scope="class")
    def mined(self, synthetic_data, tmp_path_factory):
        from recommendit_tpu.config import Settings
        from recommendit_tpu.features.engineering import FeatureEngineer
        from recommendit_tpu.models.two_tower import TwoTowerModel
        from recommendit_tpu.training.train_ranker import RankerTrainer

        tmp = tmp_path_factory.mktemp("hardneg")
        model_path = str(tmp / "tower.npz")
        TwoTowerModel(
            n_users=synthetic_data.n_users, n_items=synthetic_data.n_items,
            embed_dim=8, hidden_dim=16, seed=0,
        ).save(model_path)

        cfg = Settings(
            EMBEDDING_MODEL_PATH=model_path, RANKER_HARD_NEG_FRAC=0.5,
            RANKER_HARD_NEG_POOL=40, N_NEGATIVES=4, SEED=0,
        )
        fe = FeatureEngineer(seed=0)
        fe.set_data(synthetic_data)
        trainer = RankerTrainer(synthetic_data, cfg, feature_engineer=fe)
        pairs, _ = fe.build_training_pairs(n_negatives=4, seed=0)
        mined = trainer._mine_hard_negatives(pairs.copy())
        return synthetic_data, pairs, mined

    def test_positives_untouched(self, mined):
        _, pairs, out = mined
        p0 = pairs[pairs["label"] == 1].reset_index(drop=True)
        p1 = out[out["label"] == 1].reset_index(drop=True)
        assert np.array_equal(p0["item_id"].values, p1["item_id"].values)
        assert np.array_equal(pairs["label"].values, out["label"].values)

    def test_negatives_changed_but_unrated(self, mined):
        data, pairs, out = mined
        changed = (pairs["item_id"].values != out["item_id"].values)
        assert changed.sum() > 0
        rated = set(
            zip(data.ratings["user_id"].values, data.ratings["item_id"].values)
        )
        neg = out[out["label"] == 0]
        assert not any(
            (u, i) in rated
            for u, i in zip(neg["user_id"].values, neg["item_id"].values)
        )

    def test_no_duplicate_items_within_query(self, mined):
        _, _, out = mined
        dup = out.groupby(["query_id", "item_id"]).size()
        # positives can repeat items across labels only if the random
        # sampler produced them; hard mining must not introduce dups among
        # negatives of one query
        neg = out[out["label"] == 0]
        assert neg.groupby(["query_id", "item_id"]).size().max() == 1

    def test_missing_model_keeps_pairs(self, synthetic_data):
        from recommendit_tpu.config import Settings
        from recommendit_tpu.features.engineering import FeatureEngineer
        from recommendit_tpu.training.train_ranker import RankerTrainer

        cfg = Settings(
            EMBEDDING_MODEL_PATH="/nonexistent/tower.npz",
            RANKER_HARD_NEG_FRAC=0.5,
        )
        fe = FeatureEngineer(seed=0)
        fe.set_data(synthetic_data)
        trainer = RankerTrainer(synthetic_data, cfg, feature_engineer=fe)
        pairs, _ = fe.build_training_pairs(n_negatives=2, seed=0)
        out = trainer._mine_hard_negatives(pairs.copy())
        assert np.array_equal(pairs["item_id"].values, out["item_id"].values)


class TestCandidateFolds:
    """Multi-fold candidate training (RANKER_CAND_FOLDS > 1): pooled
    frames from several inner temporal splits, each with its own tower."""

    @pytest.fixture(scope="class")
    def frames(self, tmp_path_factory):
        from recommendit_tpu.config import Settings
        from recommendit_tpu.data.synthetic import make_synthetic_movielens
        from recommendit_tpu.training.train_ranker import RankerTrainer

        data = make_synthetic_movielens(
            n_users=80, n_items=120, n_ratings=6000, seed=7
        )
        cfg = Settings(
            EMBEDDING_DIM=16, HIDDEN_DIM=32, BATCH_SIZE=128, TRAIN_EPOCHS=2,
            SEED=0, TOP_K_CANDIDATES=40,
            RANKER_CAND_FOLDS=2, RANKER_LABEL_FRACTION=0.15,
            EMBEDDING_MODEL_PATH="",
        )
        trainer = RankerTrainer(data, cfg)
        train_f, test_f, extra = trainer._build_candidate_frames()
        return data, cfg, train_f, test_f, extra

    def test_two_folds_distinct_query_spaces(self, frames):
        data, cfg, train_f, test_f, _ = frames
        import pandas as pd

        all_f = pd.concat([train_f, test_f])
        fold_of = all_f["query_id"].values // (data.n_users + 1)
        assert set(np.unique(fold_of)) == {0, 1}

    def test_user_never_straddles_holdout(self, frames):
        _, _, train_f, test_f, _ = frames
        assert not set(train_f["user_id"]) & set(test_f["user_id"])

    def test_extra_columns_present(self, frames):
        _, _, train_f, _, extra = frames
        assert extra == ["retrieval_score", "retrieval_rank"]
        assert {"retrieval_score", "retrieval_rank"} <= set(train_f.columns)

    def test_query_id_recovers_user(self, frames):
        data, _, train_f, _, _ = frames
        qid = train_f["query_id"].values % (data.n_users + 1)
        assert np.array_equal(qid, train_f["user_id"].values)

    def test_labels_match_fold_windows(self, frames):
        """Each fold's positives come from its own label slice."""
        data, cfg, train_f, test_f, _ = frames
        import pandas as pd

        r = data.ratings.sort_values("timestamp")
        f = cfg.RANKER_LABEL_FRACTION
        all_f = pd.concat([train_f, test_f])
        for j in (0, 1):
            hi = int(len(r) * (1.0 - j * f))
            lo = int(len(r) * (1.0 - (j + 1) * f))
            window = r.iloc[lo:hi]
            pos_pairs = set(
                zip(window[window["rating"] >= 4]["user_id"],
                    window[window["rating"] >= 4]["item_id"])
            )
            fold_rows = all_f[all_f["query_id"] // (data.n_users + 1) == j]
            pos = fold_rows[fold_rows["label"] == 1]
            assert len(pos) > 0
            assert all(
                (u, i) in pos_pairs
                for u, i in zip(pos["user_id"], pos["item_id"])
            )
