"""Pipeline orchestrator CLI.

Stage parity with the reference orchestrator
(``src/pipelines/run_pipeline.py:21,269-287``):
``all | data | features | load_features | embeddings | index | ranker |
evaluate`` with per-stage timing (:41-50) and fail-fast ``all`` (:243-267).

The evaluate stage uses the SAME serving pipeline object as the HTTP path
(the reference re-implements feature assembly inline, :189-213 — its own
skew hazard, fixed here by construction).
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from recommendit_tpu.config import Settings, settings as default_settings
from recommendit_tpu.data.movielens import (
    MovieLensData,
    download_movielens,
    load_or_synthesize,
    save_movielens,
    verify_dataset,
)
from recommendit_tpu.data.synthetic import make_synthetic_movielens
from recommendit_tpu.evaluation.metrics import evaluate_model
from recommendit_tpu.features.engineering import FeatureEngineer
from recommendit_tpu.features.store import FeatureStore
from recommendit_tpu.utils.logging import setup_logging

logger = logging.getLogger(__name__)

STAGES = ["all", "data", "features", "load_features", "embeddings", "index",
          "ranker", "evaluate", "skew"]


class PipelineOrchestrator:
    def __init__(
        self,
        cfg: Optional[Settings] = None,
        data_dir: Optional[str] = None,
        models_dir: str = "models",
        features_dir: str = "data/features",
        synthetic: bool = False,
        eval_users: int = 200,
        respect_cfg_paths: bool = False,
    ):
        self.cfg = cfg or default_settings
        self.data_dir = data_dir or self.cfg.DATA_DIR
        self.models_dir = Path(models_dir)
        self.features_dir = features_dir
        self.synthetic = synthetic
        self.eval_users = eval_users
        self.stage_times: Dict[str, float] = {}
        # each stage's return value (e.g. the embeddings stage's per-epoch
        # history), for callers that check a run beyond its artifacts
        self.stage_results: Dict[str, Any] = {}
        self._data: Optional[MovieLensData] = None
        # remap artifact paths into models_dir; respect_cfg_paths=True
        # keeps any path the caller set away from its Settings default
        # (e.g. scripts/ranker_ab.py's per-variant ranker files)
        remap = {
            "EMBEDDING_MODEL_PATH": str(self.models_dir / "two_tower.npz"),
            "INDEX_PATH": str(self.models_dir / "mips.index.npz"),
            "RANKER_MODEL_PATH": str(self.models_dir / "ranker.npz"),
        }
        if respect_cfg_paths:
            defaults = Settings()
            remap = {k: v for k, v in remap.items()
                     if getattr(self.cfg, k) == getattr(defaults, k)}
        self.cfg = self.cfg.replace(**remap, DATA_DIR=self.data_dir)

    # ------------------------------------------------------------------ #

    def _timed(self, name: str, fn):
        logger.info("=== stage: %s ===", name)
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        self.stage_times[name] = dt
        self.stage_results[name] = out
        logger.info("=== stage %s done in %.2fs ===", name, dt)
        return out

    def _load_data(self) -> MovieLensData:
        if self._data is None:
            if self.synthetic and not verify_dataset(Path(self.data_dir)):
                data = make_synthetic_movielens(
                    n_users=self.cfg.SYNTH_USERS,
                    n_items=self.cfg.SYNTH_ITEMS,
                    n_ratings=self.cfg.SYNTH_RATINGS, seed=self.cfg.SEED,
                )
                save_movielens(data, self.data_dir)
            self._data = load_or_synthesize(self.data_dir, seed=self.cfg.SEED)
        return self._data

    def _train_view(self) -> MovieLensData:
        """The temporal train split visible to the training stages.

        The reference README documents a 90/10 time split but its
        implementation trains on the full ratings file
        (``train_embeddings.py:134-143``), leaking the test window into
        the towers (per-ID embeddings memorize test positives, erasing
        any measurable re-ranker lift). ``TRAIN_SPLIT_FRACTION=1.0``
        reproduces that behavior; the 0.9 default follows the documented
        protocol. Users/movies tables stay full so model table sizes and
        the catalog are unchanged.
        """
        data = self._load_data()
        frac = self.cfg.TRAIN_SPLIT_FRACTION
        if frac >= 1.0:
            return data
        r = data.ratings.sort_values("timestamp")
        cut = int(len(r) * frac)
        return MovieLensData(
            ratings=r.iloc[:cut].reset_index(drop=True),
            users=data.users,
            movies=data.movies,
        )

    # ------------------------------------------------------------------ #
    # Stages                                                               #
    # ------------------------------------------------------------------ #

    def run_data(self):
        if self.synthetic:
            data = make_synthetic_movielens(
                    n_users=self.cfg.SYNTH_USERS,
                    n_items=self.cfg.SYNTH_ITEMS,
                    n_ratings=self.cfg.SYNTH_RATINGS, seed=self.cfg.SEED,
                )
            save_movielens(data, self.data_dir)
            self._data = data
            logger.info("Synthetic dataset written to %s", self.data_dir)
        else:
            download_movielens(str(Path(self.data_dir).parent))

    def run_features(self):
        data = self._train_view()
        fe = FeatureEngineer(self.data_dir, seed=self.cfg.SEED)
        fe.set_data(data)
        fe.build_user_features()
        fe.build_item_features()
        fe.save_features(self.features_dir)

    def run_load_features(self):
        import pandas as pd

        store = FeatureStore(self.cfg.REDIS_URL,
                             ttl=self.cfg.FEATURE_CACHE_TTL_SECONDS)
        uf = pd.read_parquet(Path(self.features_dir) / "user_features.parquet")
        itf = pd.read_parquet(Path(self.features_dir) / "item_features.parquet")
        store.load_all_features(uf, itf)
        # zero-copy snapshot alongside the KV load: serving processes mmap
        # this and skip the bulk load entirely on warm starts
        from recommendit_tpu.features.snapshot import write_snapshot_from_frames

        write_snapshot_from_frames(
            str(Path(self.features_dir) / "features.fsnap"), uf, itf
        )
        logger.info("Store stats: %s", store.stats())

    def run_embeddings(self, resume: bool = True):
        """Train embeddings; auto-resumes from the last train-state
        checkpoint when one exists (elastic recovery — a pre-empted or
        crashed run continues instead of restarting, SURVEY.md §5.3/§5.4)."""
        data = self._train_view()
        if self.cfg.HOST_TABLE:
            # beyond-device-memory path: tables live in host RAM/memmap,
            # only batch rows ship to the device (training/host_train.py)
            from recommendit_tpu.training.host_train import (
                HostTableEmbeddingTrainer,
            )

            trainer = HostTableEmbeddingTrainer(
                data, self.cfg,
                model_output_path=self.cfg.EMBEDDING_MODEL_PATH,
            )
            model = trainer.train()
            if model is None:
                # tables beyond device memory: no model artifact exists — keep
                # the trainer so run_index can stream the catalog through
                # embed_catalog instead of loading EMBEDDING_MODEL_PATH
                self._host_trainer = trainer
            return trainer.history
        from recommendit_tpu.training.train_embeddings import EmbeddingTrainer

        ckpt_dir = self.models_dir / "two_tower_ckpt"
        trainer = EmbeddingTrainer(
            data, self.cfg,
            model_output_path=self.cfg.EMBEDDING_MODEL_PATH,
            ckpt_dir=str(ckpt_dir),
        )
        resume_from = None
        best = ckpt_dir / "best"
        if resume and best.exists():
            logger.info("Found checkpoint at %s — resuming", best)
            resume_from = str(best)
        trainer.train(resume_from=resume_from)
        return trainer.history

    def run_index(self):
        from recommendit_tpu.training.build_index import IndexBuilder

        data = self._train_view()
        builder = IndexBuilder(
            data, self.cfg,
            model_path=self.cfg.EMBEDDING_MODEL_PATH,
            index_output_path=self.cfg.INDEX_PATH,
        )
        ht = getattr(self, "_host_trainer", None)
        if ht is not None:
            # host-table run: stream the catalog through the device
            # MLP head chunk-by-chunk; the table never goes on device
            bias = ht._dense.get("item_bias")
            builder.build(
                embeddings=ht.embed_catalog(),
                bias=np.asarray(bias)[1:] if bias is not None else None,
            )
            return
        builder.build()

    def run_ranker(self):
        from recommendit_tpu.training.train_ranker import RankerTrainer

        data = self._train_view()
        trainer = RankerTrainer(
            data, self.cfg,
            ranker_output_path=self.cfg.RANKER_MODEL_PATH,
            features_dir=self.features_dir,
        )
        trainer.run()
        return trainer.holdout_metrics

    def run_evaluate(self) -> Dict:
        """Temporal-split offline evaluation through the serving pipeline
        (reference protocol: last 10% by time, relevance = rating >= 4,
        K ∈ {5,10,20}, first N test users — ``run_pipeline.py:154-173``)."""
        from recommendit_tpu.serving.recommender import RecommendationPipeline

        data = self._load_data()
        r = data.ratings.sort_values("timestamp")
        cut = int(len(r) * 0.9)
        train_r, test_r = r.iloc[:cut], r.iloc[cut:]

        truth = (
            test_r[test_r["rating"] >= 4]
            .groupby("user_id")["item_id"]
            .apply(list)
            .to_dict()
        )
        users = list(truth.keys())[: self.eval_users]

        pipeline = RecommendationPipeline(
            model_path=self.cfg.EMBEDDING_MODEL_PATH,
            index_path=self.cfg.INDEX_PATH,
            ranker_path=self.cfg.RANKER_MODEL_PATH,
            redis_url=self.cfg.REDIS_URL,
            data_dir=self.data_dir,
            features_dir=self.features_dir,
            cfg=self.cfg,
        )
        # the serving pipeline may only see train-time data (popularity
        # fallback, seen-filter, packed features) — the truth split above
        # intentionally comes from the full timeline
        pipeline.load(self._train_view())
        recs = pipeline.batch_recommend(users, k=20)

        # popularity + retrieval-only baselines for the report (the
        # reference publishes all three rows, README.md:36-38). When
        # FILTER_SEEN is on, every ladder row filters the user's train-time
        # items the same way the serving path does — already-rated pairs
        # cannot be test hits under the temporal protocol, and comparing a
        # filtered pipeline against unfiltered baselines would be apples to
        # oranges.
        seen_train = (
            {u: set(g.values)
             for u, g in train_r.groupby("user_id")["item_id"]}
            if self.cfg.FILTER_SEEN else {}
        )

        def _filtered(u, ordered_ids, k=20):
            s = seen_train.get(u, ())
            return [int(i) for i in ordered_ids if i not in s][:k]

        pop_all = (
            train_r.groupby("item_id").size().sort_values(ascending=False)
            .index.tolist()
        )
        report = evaluate_model(
            recs, truth, k_values=[5, 10, 20], catalog_size=data.n_items
        )
        pop_report = evaluate_model(
            {u: _filtered(u, pop_all) for u in users}, truth, k_values=[10, 20]
        )
        report["popularity_ndcg@10"] = pop_report["ndcg@10"]
        report["popularity_recall@20"] = pop_report["recall@20"]
        report["popularity_mrr"] = pop_report["mrr"]

        known = [u for u in users if 1 <= u <= pipeline.model.n_users]
        if known:
            q = np.stack([pipeline.model.get_user_embedding(u) for u in known])
            k_search = (
                min(self.cfg.TOP_K_CANDIDATES, pipeline.index.n_total)
                if self.cfg.FILTER_SEEN else 20
            )
            _, ids = pipeline.index.batch_search(q, k=k_search)
            retr_recs = {
                u: _filtered(u, ids[i].tolist()) for i, u in enumerate(known)
            }
            retr_report = evaluate_model(retr_recs, truth, k_values=[10, 20])
            report["retrieval_only_ndcg@10"] = retr_report["ndcg@10"]
            report["retrieval_only_recall@20"] = retr_report["recall@20"]
            report["retrieval_only_mrr"] = retr_report["mrr"]

            # paired per-user full-vs-retrieval statistic: the two rows
            # score the SAME users, so the honest noise model is the
            # paired difference, not two independent means (per-user NDCG
            # variance at sparse relevance dwarfs the ranker delta)
            from recommendit_tpu.evaluation.metrics import ndcg_at_k

            d = np.asarray([
                ndcg_at_k(recs.get(u, []), truth[u], 10)
                - ndcg_at_k(retr_recs[u], truth[u], 10)
                for u in known if truth.get(u)
            ])
            if len(d) > 1:
                se = float(d.std(ddof=1) / np.sqrt(len(d)))
                report["paired_ndcg10_full_minus_retrieval"] = float(d.mean())
                report["paired_ndcg10_se"] = se
                report["paired_ndcg10_t"] = (
                    float(d.mean() / se) if se > 0 else 0.0
                )

        out = self.models_dir / "evaluation.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2, default=float))
        logger.info("Evaluation written to %s", out)
        return report

    def run_skew(self) -> Dict:
        """Training-serving skew check (reference exposes this only as an
        offline utility, ``metrics.py:236``; here it is a pipeline stage):
        compares the offline training feature join against the serving
        path's packed-table assembly for a sample of (user, item) pairs.
        With the shared contract these must agree (max KL ≈ 0) — a nonzero
        report means the contract drifted."""
        from recommendit_tpu.evaluation.metrics import detect_training_serving_skew
        from recommendit_tpu.features.schema import (
            FEATURE_COLUMNS,
            assemble_packed_np,
            pack_item_features,
            pack_user_features,
        )
        import pandas as pd

        # same train view the features stage built from — training pairs
        # sampled from the test window would see ratings the persisted
        # feature tables (correctly) never counted, reading as false skew
        data = self._train_view()
        fe = FeatureEngineer(self.data_dir, seed=self.cfg.SEED)
        fe.set_data(data)
        fe.load_features(self.features_dir)
        if fe.user_features is None or fe.item_features is None:
            fe.build_user_features()
            fe.build_item_features()

        pairs, _ = fe.build_training_pairs(n_negatives=2, seed=self.cfg.SEED)
        sample = pairs.sample(n=min(4000, len(pairs)),
                              random_state=self.cfg.SEED)
        train_feats = fe.build_interaction_features(sample)

        user_table = pack_user_features(fe.user_features, data.n_users)
        item_table = pack_item_features(fe.item_features, data.n_items)
        serving_rows = [
            assemble_packed_np(
                user_table[int(u)], item_table[np.array([int(i)])]
            )[0]
            for u, i in zip(sample["user_id"], sample["item_id"])
        ]
        serving_feats = pd.DataFrame(serving_rows, columns=FEATURE_COLUMNS)

        report = detect_training_serving_skew(
            train_feats[FEATURE_COLUMNS], serving_feats,
            threshold=self.cfg.SKEW_KL_THRESHOLD,
        )
        out = self.models_dir / "skew_report.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2, default=float))
        logger.info(
            "Skew check: max_kl=%.6f detected=%s (report → %s)",
            report["max_kl"], report["skew_detected"], out,
        )
        return report

    # ------------------------------------------------------------------ #

    def run_stage(self, stage: str):
        dispatch = {
            "data": self.run_data,
            "features": self.run_features,
            "load_features": self.run_load_features,
            "embeddings": self.run_embeddings,
            "index": self.run_index,
            "ranker": self.run_ranker,
            "evaluate": self.run_evaluate,
            "skew": self.run_skew,
        }
        if stage == "all":
            return self.run_all()
        if stage not in dispatch:
            raise ValueError(f"Unknown stage {stage}; choose from {STAGES}")
        return self._timed(stage, dispatch[stage])

    def run_all(self):
        out = None
        for stage in ["data", "features", "embeddings", "index", "ranker",
                      "load_features", "skew", "evaluate"]:
            out = self._timed(stage, getattr(self, f"run_{stage}"))
        logger.info("Stage times: %s",
                    {k: round(v, 2) for k, v in self.stage_times.items()})
        return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="recommendit_tpu pipeline")
    parser.add_argument("--stage", choices=STAGES, default="all")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--models-dir", default="models")
    parser.add_argument("--features-dir", default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="generate synthetic MovieLens-format data")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--eval-users", type=int, default=200)
    parser.add_argument("--log-level", default=None)
    args = parser.parse_args(argv)

    from recommendit_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    cfg = default_settings
    if args.epochs:
        cfg = cfg.replace(TRAIN_EPOCHS=args.epochs)
    setup_logging(args.log_level or cfg.LOG_LEVEL)

    orch = PipelineOrchestrator(
        cfg=cfg,
        data_dir=args.data_dir,
        models_dir=args.models_dir,
        features_dir=args.features_dir or (
            str(Path(args.data_dir).parent / "features") if args.data_dir
            else "data/features"
        ),
        synthetic=args.synthetic,
        eval_users=args.eval_users,
    )
    result = orch.run_stage(args.stage)
    if isinstance(result, dict):
        print(json.dumps(result, indent=2, default=float))
    return result


if __name__ == "__main__":
    main()
