"""Micro-batcher tests: coalescing, ordering, error propagation, and
integration with the real serving pipeline under concurrent threads."""
import threading
import time

import pytest

from recommendit_tpu.serving.batcher import MicroBatcher


class TestMicroBatcher:
    def test_single_request(self):
        b = MicroBatcher(lambda ids: [i * 10 for i in ids], max_wait_ms=1)
        try:
            assert b.submit(7) == 70
        finally:
            b.close()

    def test_concurrent_requests_coalesce(self):
        calls = []

        def batch_fn(ids):
            calls.append(list(ids))
            time.sleep(0.01)
            return [i + 1000 for i in ids]

        b = MicroBatcher(batch_fn, max_batch=64, max_wait_ms=20)
        try:
            results = {}

            def worker(uid):
                results[uid] = b.submit(uid)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert results == {i: i + 1000 for i in range(32)}
            # coalesced into far fewer dispatches than requests
            assert b.batches_dispatched < 32
            assert b.stats["avg_batch_size"] > 1.5
        finally:
            b.close()

    def test_max_batch_triggers_dispatch(self):
        b = MicroBatcher(lambda ids: ids, max_batch=4, max_wait_ms=5000)
        try:
            results = []
            threads = [
                threading.Thread(target=lambda i=i: results.append(b.submit(i)))
                for i in range(4)
            ]
            t0 = time.monotonic()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=3)
            # dispatched well before the 5s wait because the batch filled
            assert time.monotonic() - t0 < 2.0
            assert len(results) == 4
        finally:
            b.close()

    def test_error_propagates_to_all_waiters(self):
        def boom(ids):
            raise RuntimeError("backend down")

        b = MicroBatcher(boom, max_wait_ms=1)
        try:
            with pytest.raises(RuntimeError, match="backend down"):
                b.submit(1)
        finally:
            b.close()

    def test_timeout(self):
        b = MicroBatcher(lambda ids: time.sleep(5) or ids, max_wait_ms=1)
        try:
            with pytest.raises(TimeoutError):
                b.submit(1, timeout=0.2)
        finally:
            b.close()


class TestPipelineIntegration:
    def test_batched_serving_matches_unbatched(self, tmp_path_factory):
        """Concurrent batched requests return the same recommendations as
        direct single-dispatch serving."""
        from recommendit_tpu.config import Settings
        from recommendit_tpu.pipelines.run_pipeline import PipelineOrchestrator
        from recommendit_tpu.serving.recommender import RecommendationPipeline

        tmp = tmp_path_factory.mktemp("batcher")
        cfg = Settings(
            EMBEDDING_DIM=16, HIDDEN_DIM=32, BATCH_SIZE=128, TRAIN_EPOCHS=2,
            RANKER_EPOCHS=3, SEED=0, TOP_K_CANDIDATES=50,
        )
        orch = PipelineOrchestrator(
            cfg=cfg, data_dir=str(tmp / "ml"), models_dir=str(tmp / "m"),
            features_dir=str(tmp / "f"), synthetic=True,
        )
        for stage in ("data", "features", "embeddings", "index", "ranker"):
            orch.run_stage(stage)

        def load_pipeline():
            p = RecommendationPipeline(
                model_path=orch.cfg.EMBEDDING_MODEL_PATH,
                index_path=orch.cfg.INDEX_PATH,
                ranker_path=orch.cfg.RANKER_MODEL_PATH,
                redis_url="redis://localhost:9999",
                data_dir=str(tmp / "ml"), features_dir=str(tmp / "f"),
                cfg=orch.cfg,
            )
            p.load()
            return p

        direct = load_pipeline()
        batched = load_pipeline()
        batched.enable_micro_batching(max_batch=8, max_wait_ms=10)

        users = [3, 5, 7, 9, 11]
        expected = {
            u: [r.item_id for r in direct.get_recommendations(u, k=5,
                                                              use_cache=False)]
            for u in users
        }
        got = {}
        threads = [
            threading.Thread(
                target=lambda u=u: got.update(
                    {u: [r.item_id for r in batched.get_recommendations(
                        u, k=5, use_cache=False)]}
                )
            )
            for u in users
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert got == expected
        batched._batcher.close()


class TestBackpressureAndDeadlines:
    def test_queue_full_raises(self):
        import threading

        from recommendit_tpu.serving.batcher import MicroBatcher, QueueFullError

        release = threading.Event()
        entered = threading.Event()

        def slow_fn(ids):
            entered.set()
            release.wait(5.0)
            return [i * 2 for i in ids]

        b = MicroBatcher(slow_fn, max_batch=2, max_wait_ms=1.0, max_queue=3)
        try:
            # saturate: the dispatch thread blocks in slow_fn on the first
            # request, then the queue takes 3 more
            threads = [
                threading.Thread(target=lambda: b.submit(1, timeout=5.0))
                for _ in range(4)
            ]
            threads[0].start()
            assert entered.wait(5.0)
            for t in threads[1:]:
                t.start()
            deadline = time.time() + 5.0
            while not b._queue.full() and time.time() < deadline:
                time.sleep(0.01)
            with pytest.raises(QueueFullError):
                b.submit(99, timeout=5.0)
            assert b.requests_rejected == 1
            release.set()
            for t in threads:
                t.join(timeout=5.0)
        finally:
            release.set()
            b.close()

    def test_expired_requests_never_reach_device(self):
        import threading

        from recommendit_tpu.serving.batcher import MicroBatcher

        seen = []
        release = threading.Event()
        first_in = threading.Event()

        def fn(ids):
            first_in.set()
            release.wait(5.0)
            seen.extend(ids)
            return [i for i in ids]

        b = MicroBatcher(fn, max_batch=1, max_wait_ms=0.5)
        try:
            # occupy the dispatch thread with a long call
            t1 = threading.Thread(target=lambda: b.submit(1, timeout=5.0))
            t1.start()
            assert first_in.wait(2.0)
            # this one expires while the thread is busy
            with pytest.raises(TimeoutError):
                b.submit(2, timeout=0.2)
            time.sleep(0.1)
            release.set()
            t1.join(timeout=5.0)
            time.sleep(0.3)  # let the loop drain the expired entry
            assert 2 not in seen
            assert b.requests_expired >= 1
        finally:
            release.set()
            b.close()

    def test_stats_surface(self):
        from recommendit_tpu.serving.batcher import MicroBatcher

        b = MicroBatcher(lambda ids: ids, max_batch=4)
        try:
            assert b.submit(7, timeout=2.0) == 7
            st = b.stats
            assert st["requests_served"] == 1
            assert st["requests_rejected"] == 0
            assert "queue_depth" in st and "requests_expired" in st
        finally:
            b.close()
