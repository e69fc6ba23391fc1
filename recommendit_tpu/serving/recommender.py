"""End-to-end recommendation inference pipeline.

Capability parity with the reference pipeline
(``src/serving/recommender.py``): cache → embed → retrieve top-500 →
feature fetch → rank → top-k → cache, popularity cold-start fallback
(:393-410), rolling p50/p99 latency tracking (:35-62), stats (:416-430).

Design difference: the hot path embed → MIPS top-500 → 50-feature
assembly → MLP scoring → final top-k is ONE jitted device call over packed
dense feature tables — the reference crosses host↔C++ twice (FAISS,
LightGBM) and builds a 500-row python dict loop in between
(:224-261, the worst serving inefficiency named in SURVEY.md §3.3).
The feature-store contract (user:feat:/item:feat:/recs: keys) is kept for
online updates; packed tables mirror it for device residency.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from recommendit_tpu.config import Settings, settings as default_settings
from recommendit_tpu.data.movielens import MovieLensData, load_or_synthesize
from recommendit_tpu.features.engineering import FeatureEngineer
from recommendit_tpu.features.schema import (
    assemble_packed_jnp,
    pack_item_features,
    pack_user_features,
    pad_packed_width,
)
from recommendit_tpu.features.store import FeatureStore
from recommendit_tpu.models.ranker import LambdaRankScorer
from recommendit_tpu.models.retrieval import MIPSIndex
from recommendit_tpu.models.two_tower import TwoTowerModel, user_tower
from recommendit_tpu.utils.latency import LatencyTracker

logger = logging.getLogger(__name__)

MAX_K = 100  # API cap (reference app.py:32 k<=100)


@dataclasses.dataclass
class RecommendationResult:
    item_id: int
    title: str
    score: float
    rank: int
    retrieval_score: float = 0.0
    genres: List[str] = dataclasses.field(default_factory=list)


class RecommendationPipeline:
    """Two-stage serving pipeline with a single-dispatch device hot path."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        index_path: Optional[str] = None,
        ranker_path: Optional[str] = None,
        redis_url: Optional[str] = None,
        data_dir: Optional[str] = None,
        features_dir: Optional[str] = None,
        top_k_candidates: Optional[int] = None,
        cfg: Optional[Settings] = None,
    ):
        self.cfg = cfg or default_settings
        self.model_path = model_path or self.cfg.EMBEDDING_MODEL_PATH
        self.index_path = index_path or self.cfg.INDEX_PATH
        self.ranker_path = ranker_path or self.cfg.RANKER_MODEL_PATH
        self.redis_url = redis_url or self.cfg.REDIS_URL
        self.data_dir = data_dir or self.cfg.DATA_DIR
        self.features_dir = features_dir
        self.top_k_candidates = top_k_candidates or self.cfg.TOP_K_CANDIDATES

        self.model: Optional[TwoTowerModel] = None
        self.index: Optional[MIPSIndex] = None
        self.ranker: Optional[LambdaRankScorer] = None
        self.feature_store: Optional[FeatureStore] = None

        self._item_titles: Dict[int, str] = {}
        self._item_genres: Dict[int, List[str]] = {}
        self._popularity_fallback: List[int] = []

        self.latency_tracker = LatencyTracker(1000)
        self.retrieval_latency = LatencyTracker(1000)
        self.ranking_latency = LatencyTracker(1000)
        self._cache_hits = 0
        self._cache_misses = 0
        self._loaded = False
        self._serve_fn = None
        self._batcher = None

    # alias for reference-name compatibility
    @property
    def faiss_index(self):
        return self.index

    # ------------------------------------------------------------------ #
    # Load                                                                 #
    # ------------------------------------------------------------------ #

    def load(self, data: Optional[MovieLensData] = None) -> None:
        logger.info("Loading recommendation pipeline...")
        t0 = time.time()

        from recommendit_tpu.models import load_ranker

        self.model = TwoTowerModel.load(self.model_path)
        self.index = MIPSIndex.load(self.index_path)
        self.ranker = load_ranker(self.ranker_path)
        self.feature_store = FeatureStore(
            redis_url=self.redis_url, ttl=self.cfg.FEATURE_CACHE_TTL_SECONDS
        )
        if self.features_dir:
            fsnap = Path(self.features_dir) / "features.fsnap"
            if fsnap.exists():
                from recommendit_tpu.features.snapshot import FeatureSnapshot

                self.feature_store.attach_snapshot(FeatureSnapshot(str(fsnap)))
                logger.info("Feature store backed by snapshot %s", fsnap)

        if data is None:
            data = load_or_synthesize(self.data_dir, seed=self.cfg.SEED)
        self._load_item_metadata(data)
        self._build_popularity_fallback(data)
        self._build_packed_tables(data)
        self._build_serve_fn()

        self._loaded = True
        logger.info("Pipeline loaded in %.2fs", time.time() - t0)

    def _load_item_metadata(self, data: MovieLensData) -> None:
        m = data.movies
        self._item_titles = dict(
            zip(m["item_id"].astype(int), m["title"].astype(str))
        )
        self._item_genres = {
            int(i): str(g).split("|")
            for i, g in zip(m["item_id"], m["genres"])
        }

    def _build_popularity_fallback(self, data: MovieLensData) -> None:
        pop = (
            data.ratings.groupby("item_id")["rating"].count()
            .sort_values(ascending=False)
        )
        self._popularity_fallback = [int(i) for i in pop.index]

    def _build_packed_tables(self, data: MovieLensData) -> None:
        """Dense user/item feature tables for device-side assembly.

        Prefers saved parquet features (shared contract with training);
        recomputes from raw data otherwise, and bulk-loads the store so the
        online KV contract stays warm.
        """
        n_users = max(self.model.n_users, data.n_users)
        n_items = max(self.model.n_items, data.n_items)

        # Fast path: binary packed-table snapshot (written on first load) —
        # startup skips the pandas feature recompute entirely.
        snap_u = snap_i = None
        if self.features_dir:
            snap_u = Path(self.features_dir) / "user_packed.npy"
            snap_i = Path(self.features_dir) / "item_packed.npy"
            parquet = Path(self.features_dir) / "user_features.parquet"
            snapshot_fresh = (
                snap_u.exists() and snap_i.exists()
                and (not parquet.exists()
                     or snap_u.stat().st_mtime >= parquet.stat().st_mtime)
            )
            if snapshot_fresh:
                up = np.load(snap_u, mmap_mode="r")
                ip = np.load(snap_i, mmap_mode="r")
                if up.shape[0] >= n_users + 1 and ip.shape[0] >= n_items + 1:
                    self._user_packed = jnp.asarray(up[: n_users + 1])
                    self._item_packed = jnp.asarray(
                        pad_packed_width(np.asarray(ip[: n_items + 1]))
                    )
                    self._n_users = n_users
                    logger.info("Loaded packed feature snapshot from %s",
                                self.features_dir)
                    self._maybe_build_seen(data, n_users, n_items)
                    return

        fe = FeatureEngineer(self.data_dir, seed=self.cfg.SEED)
        fe.set_data(data)
        if self.features_dir and Path(self.features_dir).exists():
            fe.load_features(self.features_dir)
        if fe.user_features is None or fe.item_features is None:
            fe.build_user_features()
            fe.build_item_features()

        user_packed = pack_user_features(fe.user_features, n_users)
        item_packed = pack_item_features(fe.item_features, n_items)
        if snap_u is not None:
            snap_u.parent.mkdir(parents=True, exist_ok=True)
            np.save(snap_u, user_packed)
            np.save(snap_i, item_packed)
        self._user_packed = jnp.asarray(user_packed)
        # width-pad ONCE at load (gather-friendly rows, features/schema.py)
        self._item_packed = jnp.asarray(pad_packed_width(item_packed))
        self._n_users = n_users
        self._maybe_build_seen(data, n_users, n_items)

    def _maybe_build_seen(self, data, n_users: int, n_items: int) -> None:
        self._seen = None
        if self.cfg.FILTER_SEEN:
            # sorted-key (user*stride+item) set: 8 B/rating, one binary
            # search per candidate inside the fused program — scales to
            # ML-25M (200 MB) where the round-1 dense bool mask was 10 GB
            from recommendit_tpu.ops.seen import SeenSet

            self._seen = SeenSet(
                data.ratings["user_id"].values,
                data.ratings["item_id"].values,
                n_items,
            )

    def _build_serve_fn(self) -> None:
        """Compile the fused serve path once.

        user_id → tower → exact top-C retrieval → gather packed features →
        assemble 50 cols → standardize → MLP scores → top-MAX_K.
        """
        params = self.model.params
        user_packed = self._user_packed
        item_packed = self._item_packed

        # ranker-agnostic device scorer: raw (…, C, F) candidate features →
        # (…, C) scores (both ranker families expose make_device_scorer; the
        # MLP one also applies query_norm over the candidate axis when the
        # ranker was trained with it)
        score_fn = self.ranker.make_device_scorer()

        n_cand = min(self.top_k_candidates, self.index.n_total)
        k_out = min(MAX_K, n_cand)
        # dtype/mode-agnostic retrieval closure (f32/bf16/int8, fused)
        retrieve = self.index.make_device_searcher(n_cand)

        from recommendit_tpu.ops.topk import fast_topk
        from recommendit_tpu.ops.seen import seen_mask_jnp

        if self._seen is not None:
            seen_indptr, seen_cols = self._seen.device_arrays()
            seen_steps = self._seen.search_steps
        else:
            seen_indptr = seen_cols = None
            seen_steps = 0
        # extra (beyond the 50-col contract) ranker features, in training
        # order: 'retrieval_score' (tower similarity) and/or
        # 'retrieval_rank' (log1p position among UNSEEN candidates — the
        # calibration-shift-free form of the retrieval signal; training
        # builds it identically in _build_candidate_frames)
        fnames = list(self.ranker.feature_names or [])
        extra_feats = [
            n for n in fnames if n in ("retrieval_score", "retrieval_rank")
        ]

        # Score fusion with the retrieval prior: final = z(ranker) +
        # beta * z(retrieval), both standardized over the UNSEEN candidate
        # axis. The offline ranker trains on candidates from an inner tower
        # (train_ranker._build_candidate_frames) whose distribution is not
        # identical to the serving tower's; the blend keeps the first
        # stage's ordering as a prior so a shifted re-ranker degrades
        # toward retrieval quality instead of below it.
        beta = float(getattr(self.cfg, "RANKER_BLEND_RETRIEVAL", 0.0))

        def _blend(scores, rvals, unseen):
            if beta <= 0.0:
                return scores
            m = unseen.astype(jnp.float32)
            cnt = jnp.maximum(m.sum(-1, keepdims=True), 1.0)

            def _z(x):
                mu = (x * m).sum(-1, keepdims=True) / cnt
                var = (((x - mu) ** 2) * m).sum(-1, keepdims=True) / cnt
                return (x - mu) * jax.lax.rsqrt(var + 1e-9)

            return _z(scores) + beta * _z(rvals)

        def _with_extras(feats, rvals, unseen):
            """Append extra feature columns along the last axis.
            feats (..., C, 50); rvals/unseen (..., C)."""
            cols = []
            for name in extra_feats:
                if name == "retrieval_score":
                    cols.append(rvals)
                else:  # retrieval_rank: position among unseen candidates
                    r = jnp.cumsum(unseen.astype(jnp.float32), axis=-1) - 1.0
                    cols.append(jnp.log1p(jnp.maximum(r, 0.0)))
            if not cols:
                return feats
            return jnp.concatenate(
                [feats] + [c[..., None] for c in cols], axis=-1
            )

        # Packed feature tables are call-time ARGUMENTS (not closure
        # constants) so online feature updates (update_user_features /
        # update_item_features) take effect on the next request without
        # recompiling — matching the reference's read-the-store-per-request
        # freshness semantics at device speed. The retrieval corpus and its
        # item ids are arguments too, so they are never baked into the
        # executables.
        corpus = self.index.device_corpus
        item_ids_dev = self.index._ids_dev

        @jax.jit
        def serve(user_id, user_packed, item_packed, corpus, item_ids_dev):
            q = user_tower(params, user_id[None])
            rvals, pos = retrieve(q, corpus)
            rvals, pos = rvals[0], pos[0]
            cand_ids = jnp.take(item_ids_dev, pos)
            u_vec = user_packed[user_id]
            feats = assemble_packed_jnp(u_vec, jnp.take(item_packed, cand_ids, axis=0))
            if seen_cols is not None:
                seen = seen_mask_jnp(
                    seen_indptr, seen_cols, seen_steps, user_id, cand_ids
                )
            else:
                seen = jnp.zeros(cand_ids.shape, bool)
            feats = _with_extras(feats, rvals, ~seen)
            scores = _blend(score_fn(feats), rvals, ~seen)
            scores = jnp.where(seen, -jnp.inf, scores)
            top_scores, sel = fast_topk(scores, k_out)
            return (
                jnp.take(cand_ids, sel),
                top_scores,
                jnp.take(rvals, sel),
            )

        @jax.jit
        def serve_batch(user_ids, user_packed, item_packed, corpus,
                        item_ids_dev):
            """(B,) user ids → (B, k_out) ranked item ids/scores — bulk
            offline scoring; the whole two-stage pipeline for B users in
            one device program."""
            q = user_tower(params, user_ids)
            rvals, pos = retrieve(q, corpus)
            cand_ids = jnp.take(item_ids_dev, pos)              # (B, C)
            u_vecs = jnp.take(user_packed, user_ids, axis=0)    # (B, 24)
            feats = jax.vmap(
                lambda uv, ci: assemble_packed_jnp(
                    uv, jnp.take(item_packed, ci, axis=0)
                )
            )(u_vecs, cand_ids)                                  # (B, C, 50)
            if seen_cols is not None:
                seen = seen_mask_jnp(
                    seen_indptr, seen_cols, seen_steps,
                    user_ids[:, None], cand_ids,
                )
            else:
                seen = jnp.zeros(cand_ids.shape, bool)
            feats = _with_extras(feats, rvals, ~seen)
            scores = _blend(score_fn(feats), rvals, ~seen)       # (B, C)
            scores = jnp.where(seen, -jnp.inf, scores)
            top_scores, sel = fast_topk(scores, k_out)
            return (
                jnp.take_along_axis(cand_ids, sel, axis=1),
                top_scores,
                jnp.take_along_axis(rvals, sel, axis=1),
            )

        self._serve_fn = lambda uid: serve(
            uid, self._user_packed, self._item_packed, corpus, item_ids_dev
        )
        self._serve_batch_fn = lambda uids: serve_batch(
            uids, self._user_packed, self._item_packed, corpus, item_ids_dev
        )
        # warm the compile cache so first request latency is clean
        ids, _, _ = self._serve_fn(jnp.asarray(1, jnp.int32))
        jax.block_until_ready(ids)

        # Per-stage latency split: the hot path is ONE fused device call,
        # so stage times can't be observed per request without splitting
        # it (which would cost a host round-trip). Instead MEASURE a
        # standalone embed+retrieve sub-program (the reference wraps
        # separate FAISS/LightGBM calls, recommender.py:310-341 — here
        # both run inside one XLA program) and attribute each fused
        # call's device time by the measured ratio. Unlike round 3's
        # load-time-only calibration, the measurement now refreshes
        # periodically during serving (every STAGE_RECAL_EVERY fused
        # calls, on a daemon thread so no request stalls) and its
        # provenance is reported in stats().
        @jax.jit
        def retrieve_only(user_id, corpus):
            q = user_tower(params, user_id[None])
            rvals, pos = retrieve(q, corpus)
            return rvals

        self._retrieve_only_fn = lambda uid: retrieve_only(uid, corpus)
        self._retrieval_fraction = 0.5
        self._stage_calibration = {"measured": False}
        self._calls_since_recal = 0
        self._recal_thread = None
        import threading as _threading

        self._recal_lock = _threading.Lock()
        self.recalibrate_stage_split()

    def recalibrate_stage_split(self) -> dict:
        """(Re-)measure the retrieval/ranking device-time split by timing
        the standalone embed+retrieve sub-program against the full fused
        call. Returns and stores the calibration record
        (also served under ``stats()['stage_split']``)."""
        import time as _time

        try:
            def _med(fn, uids):
                ts = []
                for u in uids:
                    t0 = _time.time()
                    jax.block_until_ready(fn(jnp.asarray(u, jnp.int32)))
                    ts.append(_time.time() - t0)
                return float(np.median(ts))

            uids = [1 + (i % max(1, self._n_users)) for i in range(15)]
            jax.block_until_ready(
                self._retrieve_only_fn(jnp.asarray(1, jnp.int32)))
            t_retr = max(1e-6, _med(self._retrieve_only_fn, uids))
            t_full = max(1e-6, _med(self._serve_fn, uids))
            self._retrieval_fraction = min(0.95, max(0.05, t_retr / t_full))
            self._stage_calibration = {
                "measured": True,
                "retrieval_fraction": round(self._retrieval_fraction, 3),
                "retrieve_only_ms": round(t_retr * 1e3, 3),
                "full_call_ms": round(t_full * 1e3, 3),
                "at_unix": round(_time.time(), 1),
                # background refreshes time _serve_fn while live traffic
                # shares the device, so the split can be skewed by
                # contention — metrics attribution only, hot path unaffected
                "concurrent_with_traffic": self._calls_since_recal > 0,
            }
            logger.info(
                "Stage split measured: retrieval %.0f%% / ranking %.0f%% "
                "(retrieve %.2f ms, full %.2f ms)",
                100 * self._retrieval_fraction,
                100 * (1 - self._retrieval_fraction),
                t_retr * 1e3, t_full * 1e3,
            )
        except Exception:
            logger.warning("Stage-split calibration failed; keeping "
                           "previous split", exc_info=True)
        self._calls_since_recal = 0
        return self._stage_calibration

    def _maybe_recalibrate(self) -> None:
        """Kick a background re-measurement every STAGE_RECAL_EVERY fused
        calls (0 disables). Daemon thread: requests never block on it."""
        every = getattr(self.cfg, "STAGE_RECAL_EVERY", 0)
        if not every:
            return
        import threading

        # counter + thread handoff under a lock: without it two threads
        # racing past the threshold could both spawn a recalibration
        # (round-4 advisor finding)
        with self._recal_lock:
            self._calls_since_recal += 1
            if self._calls_since_recal < every:
                return
            t = self._recal_thread
            if t is not None and t.is_alive():
                return
            self._calls_since_recal = 0
            self._recal_thread = threading.Thread(
                target=self.recalibrate_stage_split, daemon=True)
            self._recal_thread.start()

    # ------------------------------------------------------------------ #
    # Online feature updates                                               #
    # ------------------------------------------------------------------ #

    def update_user_features(self, user_id: int, features: Dict[str, Any]) -> None:
        """Online user-feature update: writes the KV store (reference
        contract) AND the device-resident packed table, and invalidates the
        user's cached recommendations — the next request scores with the
        fresh features."""
        from recommendit_tpu.features.schema import user_dict_to_packed

        self.feature_store.store_user_features(user_id, features)
        if 0 <= user_id <= self._n_users:
            vec = jnp.asarray(user_dict_to_packed(features))
            self._user_packed = self._user_packed.at[user_id].set(vec)
        # drop any cached recs built from the stale features
        self.feature_store.invalidate_recommendations(user_id)

    def update_item_features(self, item_id: int, features: Dict[str, Any]) -> None:
        """Online item-feature update (store + packed table)."""
        from recommendit_tpu.features.schema import item_dict_to_packed

        self.feature_store.store_item_features(item_id, features)
        if 0 <= item_id < self._item_packed.shape[0]:
            vec = jnp.asarray(pad_packed_width(item_dict_to_packed(features),
                                               self._item_packed.shape[1]))
            self._item_packed = self._item_packed.at[item_id].set(vec)

    # ------------------------------------------------------------------ #
    # Micro-batching                                                       #
    # ------------------------------------------------------------------ #

    def enable_micro_batching(
        self, max_batch: int = 256, max_wait_ms: float = 2.0,
        warm_buckets: bool = True,
    ) -> None:
        """Coalesce concurrent requests into one fused device call.

        Requests are padded to power-of-two bucket sizes so at most a few
        executables are compiled; with ``warm_buckets`` (default) every
        bucket shape is compiled HERE, at enable time — otherwise each
        first-hit bucket compile lands as a p99 spike in the serving
        path.
        """
        from recommendit_tpu.serving.batcher import MicroBatcher

        buckets = [b for b in (8, 32, 256, 1024) if b <= max_batch] or [max_batch]

        def batch_fn(user_ids):
            n = len(user_ids)
            bucket = next((b for b in buckets if b >= n), buckets[-1])
            padded = list(user_ids) + [1] * (bucket - n)
            ids, scores, rvals = self._serve_batch_fn(
                jnp.asarray(padded[:bucket], jnp.int32)
            )
            ids = np.asarray(ids)
            scores = np.asarray(scores)
            rvals = np.asarray(rvals)
            return [(ids[i], scores[i], rvals[i]) for i in range(n)]

        if warm_buckets:
            t0 = time.time()
            for b in buckets:
                jax.block_until_ready(self._serve_batch_fn(
                    jnp.ones(b, jnp.int32))[0])
            logger.info("Warmed %d batch buckets in %.1fs", len(buckets),
                        time.time() - t0)
        self._batcher = MicroBatcher(batch_fn, max_batch, max_wait_ms)
        logger.info("Micro-batching enabled (max_batch=%d, wait=%.1fms)",
                    max_batch, max_wait_ms)

    # ------------------------------------------------------------------ #
    # Inference                                                            #
    # ------------------------------------------------------------------ #

    def _get_user_embedding(self, user_id: int) -> Optional[np.ndarray]:
        try:
            return self.model.get_user_embedding(user_id)
        except Exception as exc:
            logger.warning("No embedding for user %d: %s", user_id, exc)
            return None

    def get_recommendations(
        self,
        user_id: int,
        k: Optional[int] = None,
        use_cache: bool = True,
    ) -> List[RecommendationResult]:
        if not self._loaded:
            raise RuntimeError("Pipeline not loaded. Call load() first.")
        k = k or self.cfg.TOP_K_RESULTS
        t_start = time.time()

        if use_cache:
            cached = self.feature_store.get_cached_recommendations(user_id)
            if cached is not None:
                self._cache_hits += 1
                return [RecommendationResult(**it) for it in cached][:k]
        self._cache_misses += 1

        if not (1 <= user_id <= self._n_users):
            logger.warning("Unknown user %d — popularity fallback", user_id)
            return self._popularity_recommendations(k)

        t_retr = time.time()
        try:
            if self._batcher is not None:
                ids, scores, retr_scores = self._batcher.submit(user_id)
            else:
                ids, scores, retr_scores = self._serve_fn(
                    jnp.asarray(user_id, jnp.int32)
                )
            ids = np.asarray(ids)
            scores = np.asarray(scores)
            retr_scores = np.asarray(retr_scores)
        except Exception as exc:
            from recommendit_tpu.serving.batcher import QueueFullError

            if isinstance(exc, QueueFullError):
                # backpressure is a load signal, not a failure — let the
                # HTTP layer shed it (429) instead of masking it with the
                # popularity fallback
                raise
            logger.exception("Serve path failed for user %d", user_id)
            return self._popularity_recommendations(k)
        device_ms = (time.time() - t_retr) * 1000
        # one fused call: split device time by the load-time calibrated
        # retrieval/ranking ratio (see _build_serve_fn)
        frac = getattr(self, "_retrieval_fraction", 0.5)
        self.retrieval_latency.record(device_ms * frac)
        self.ranking_latency.record(device_ms * (1.0 - frac))
        self._maybe_recalibrate()

        # seen candidates carry -inf scores out of the fused call; when a
        # heavy user's candidate set is mostly seen, fewer than k finite
        # rows survive — drop the -inf tail and backfill from unseen
        # popularity so the contract (k items, none seen) holds
        finite = np.isfinite(scores)
        ids, scores, retr_scores = (
            ids[finite], scores[finite], retr_scores[finite]
        )
        results = []
        for rank, (iid, sc, rs) in enumerate(
            zip(ids[:k].tolist(), scores[:k].tolist(), retr_scores[:k].tolist()),
            start=1,
        ):
            results.append(
                RecommendationResult(
                    item_id=int(iid),
                    title=self._item_titles.get(int(iid), f"Item {iid}"),
                    score=float(sc),
                    rank=rank,
                    retrieval_score=float(rs),
                    genres=self._item_genres.get(int(iid), []),
                )
            )
        if len(results) < k:
            for iid in self._unseen_popularity(user_id, k, exclude={
                r.item_id for r in results
            })[: k - len(results)]:
                results.append(
                    RecommendationResult(
                        item_id=int(iid),
                        title=self._item_titles.get(int(iid), f"Item {iid}"),
                        score=float("-inf"),
                        rank=len(results) + 1,
                        retrieval_score=0.0,
                        genres=self._item_genres.get(int(iid), []),
                    )
                )

        if use_cache and results:
            self.feature_store.cache_recommendations(
                user_id,
                [dataclasses.asdict(r) for r in results],
                ttl=self.cfg.CACHE_TTL_SECONDS,
            )

        self.latency_tracker.record((time.time() - t_start) * 1000)
        return results

    def batch_recommend(
        self, user_ids: List[int], k: Optional[int] = None,
        batch_size: int = 256,
    ) -> Dict[int, List[int]]:
        """Offline batched recommendation (eval driver): the full two-stage
        pipeline for many users per device call; returns ranked item-id
        lists. Unknown users get the popularity fallback."""
        k = k or self.cfg.TOP_K_RESULTS
        out: Dict[int, List[int]] = {}
        known = [u for u in user_ids if 1 <= u <= self._n_users]
        for u in user_ids:
            if not (1 <= u <= self._n_users):
                out[u] = self._popularity_fallback[:k]
        for s in range(0, len(known), batch_size):
            chunk = known[s: s + batch_size]
            # pad to a fixed shape so only one executable is compiled
            padded = chunk + [1] * (batch_size - len(chunk))
            ids, scores, _ = self._serve_batch_fn(
                jnp.asarray(padded, jnp.int32)
            )
            ids = np.asarray(ids)
            scores = np.asarray(scores)
            for row, u in enumerate(chunk):
                finite = np.isfinite(scores[row])
                got = ids[row][finite][:k].tolist()
                if len(got) < k:
                    got += self._unseen_popularity(
                        u, k, exclude=set(got)
                    )[: k - len(got)]
                out[u] = got
        return out

    def _unseen_popularity(self, user_id: int, k: int, exclude=()):
        """Top popular items the user has not seen (backfill when the
        candidate set cannot supply k unseen items)."""
        fill = [
            i for i in self._popularity_fallback[: 4 * k + len(exclude)]
            if i not in exclude
        ]
        if self._seen is not None and fill:
            arr = np.asarray(fill, dtype=np.int64)
            seen = self._seen.contains(
                np.full(arr.shape, user_id, dtype=np.int64), arr
            )
            fill = [int(i) for i, s in zip(fill, seen) if not s]
        return fill[:k]

    # ------------------------------------------------------------------ #
    # Cold start + stats                                                   #
    # ------------------------------------------------------------------ #

    def _popularity_recommendations(self, k: int) -> List[RecommendationResult]:
        results = []
        for rank, iid in enumerate(self._popularity_fallback[:k], start=1):
            results.append(
                RecommendationResult(
                    item_id=int(iid),
                    title=self._item_titles.get(int(iid), f"Item {iid}"),
                    score=1.0 - rank / (k + 1),
                    rank=rank,
                    retrieval_score=0.0,
                    genres=self._item_genres.get(int(iid), []),
                )
            )
        return results

    def get_stats(self) -> Dict[str, Any]:
        total = self._cache_hits + self._cache_misses
        return {
            "total_requests": total,
            "cache_hits": self._cache_hits,
            "cache_misses": self._cache_misses,
            "cache_hit_rate": self._cache_hits / max(total, 1),
            "latency_p50_ms": round(self.latency_tracker.p50, 2),
            "latency_p99_ms": round(self.latency_tracker.p99, 2),
            "retrieval_p50_ms": round(self.retrieval_latency.p50, 2),
            "retrieval_p99_ms": round(self.retrieval_latency.p99, 2),
            "ranking_p50_ms": round(self.ranking_latency.p50, 2),
            "ranking_p99_ms": round(self.ranking_latency.p99, 2),
            # provenance: the per-stage numbers above split the fused
            # call's device time by this MEASURED ratio (see
            # recalibrate_stage_split; refreshed during serving)
            "stage_split": getattr(
                self, "_stage_calibration", {"measured": False}),
            **(
                {"micro_batcher": self._batcher.stats}
                if self._batcher is not None
                else {}
            ),
        }
