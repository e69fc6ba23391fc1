"""End-to-end check of the two-stage recommender on one NVIDIA GPU.

Usage:
    python chip_smoke.py [--seed 0] [--work-dir smoke_work]
    python chip_smoke.py --four-cards     # the sharded paths on four GPUs

One process drives every phase; a phase that fails ends the run with a
non-zero exit code and no result line.

* device    platform, device_kind, count, JAX version, compile-cache
            directory and the card's name and power limit. Anything but a
            GPU exits non-zero: there is no CPU fallback.
* pipeline  ``PipelineOrchestrator`` stage ``all`` on synthetic data of
            MovieLens-1M's published shape, at the shipped model widths;
            only the epoch counts are cut (printed).
* serve     the stdlib HTTP app (``serving/app.py``) in-process on a free
            port: ``GET /health`` and ``POST /recommend``.
* reference retrieval top-500 against float64 numpy, and the ranked
            top-20 against the same serve program on the host CPU.
* engines   every valid (INDEX_MODE, INDEX_DTYPE) pair of ``MIPSIndex`` at
            1,000,000 x 128, k=500, q=256: recall against numpy exact and
            the time of each.
* plain_xla the XLA programs that replaced the removed hand-written
            kernels (in-batch BPR step, row gather), timed.

``--four-cards`` runs only the sharded retrieval (both merges), sharded
training on a (1,4) and a (2,2) mesh, sharded serving and sharded CTR
training, each against the same computation on one card.

The optional packages orbax, prometheus_client, redis, msgpack and flax
are made unimportable first, so the run takes their fallbacks wherever it
runs. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OPTIONAL_PACKAGES = ("orbax", "orbax.checkpoint", "prometheus_client",
                     "redis", "msgpack", "flax")


class SmokeFailure(AssertionError):
    """A phase's check did not hold."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def block_optional_packages() -> None:
    """Make the optional packages unimportable (``import`` raises
    ImportError), so their fallbacks are the path this process takes."""
    for name in OPTIONAL_PACKAGES:
        sys.modules[name] = None


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Scale of one run. ``FULL`` is what ``main`` runs; tests use small
    sizes to drive the same phase code on the CPU."""

    users: int = 6040            # MovieLens-1M's published shape
    items: int = 3952
    ratings: int = 1_000_209
    train_epochs: int = 2        # shipped default: 60
    ranker_epochs: int = 2       # shipped default: 40
    eval_users: int = 200
    http_requests: int = 8
    ref_users: int = 256
    engine_items: int = 1_000_000
    engine_dim: int = 128
    engine_k: int = 500
    engine_q: int = 256
    engine_q_large: int = 1024
    recall_queries: int = 64
    timed_calls: int = 5
    bpr_batches: tuple = (1024, 4096)
    gather_rows: int = 1_000_000
    four_card_items: int = 4_000_000
    four_card_steps: int = 5


FULL = Sizes()

# (INDEX_MODE, INDEX_DTYPE) pairs MIPSIndex accepts: verified has no int8
ENGINE_PAIRS = tuple(
    (mode, dtype)
    for mode in ("exact", "verified", "approx", "fused")
    for dtype in ("float32", "bfloat16", "int8")
    if not (mode == "verified" and dtype == "int8")
)


def recall_contract(mode: str, dtype: str) -> float:
    """Recall each engine promises against numpy exact top-k over the
    scores it ranks: exact and verified are exact; approx (recall target
    0.95) and fused (window bin model) promise 0.98."""
    return 1.0 if mode in ("exact", "verified") else 0.98


# ------------------------------------------------------------------ #
# Device                                                               #
# ------------------------------------------------------------------ #

def phase_device(require: str = "gpu") -> dict:
    import jax

    from recommendit_tpu.utils.runtime import (
        enable_compile_cache,
        gpu_name_and_power_limit,
    )

    cache_dir = enable_compile_cache()
    devs = jax.devices()
    info = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    say(f"[device] platform={info['platform']} kind={info['kind']} "
        f"count={info['count']} jax={jax.__version__} "
        f"compile_cache={cache_dir}")
    if info["platform"] != require:
        raise SystemExit(
            f"chip_smoke needs a {require.upper()}; JAX found "
            f"{info['platform']!r} (no CPU fallback)")
    card = gpu_name_and_power_limit() if require == "gpu" else "n/a"
    for line in card.splitlines():
        say(line)
    info["card"] = card.splitlines()[0] if card else card
    return info


def _timed_calls(fn, n: int):
    """Median wall seconds of ``n`` blocking calls of ``fn()`` (after the
    caller's warm-up)."""
    import jax

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# ------------------------------------------------------------------ #
# Pipeline                                                             #
# ------------------------------------------------------------------ #

def smoke_settings(sizes: Sizes, seed: int, **overrides):
    from recommendit_tpu.config import Settings

    return Settings(
        SYNTH_USERS=sizes.users, SYNTH_ITEMS=sizes.items,
        SYNTH_RATINGS=sizes.ratings, TRAIN_EPOCHS=sizes.train_epochs,
        RANKER_EPOCHS=sizes.ranker_epochs, SEED=seed, **overrides,
    )


def phase_pipeline(work: Path, cfg, eval_users: int):
    """Run stage ``all`` on synthetic data; the training loss must be
    finite and fall. Returns the orchestrator."""
    from recommendit_tpu.config import Settings
    from recommendit_tpu.pipelines.run_pipeline import PipelineOrchestrator

    shipped = Settings()
    widths = {f: getattr(cfg, f) for f in (
        "EMBEDDING_DIM", "HIDDEN_DIM", "RANKER_HIDDEN_DIMS",
        "TOP_K_CANDIDATES", "BATCH_SIZE")}
    say(f"[pipeline] data {cfg.SYNTH_USERS} users x {cfg.SYNTH_ITEMS} "
        f"items x {cfg.SYNTH_RATINGS} ratings (seed {cfg.SEED}); "
        f"widths {widths}")
    for f in ("TRAIN_EPOCHS", "RANKER_EPOCHS"):
        if getattr(cfg, f) != getattr(shipped, f):
            say(f"[pipeline] cut: {f} {getattr(shipped, f)} -> "
                f"{getattr(cfg, f)}")
    orch = PipelineOrchestrator(
        cfg=cfg, data_dir=str(work / "ml"), models_dir=str(work / "models"),
        features_dir=str(work / "features"), synthetic=True,
        eval_users=eval_users,
    )
    report = orch.run_stage("all")
    losses = [h["loss"] for h in orch.stage_results["embeddings"]]
    say(f"[pipeline] stage seconds "
        f"{ {k: round(v, 2) for k, v in orch.stage_times.items()} }")
    say(f"[pipeline] tower loss per epoch {losses}")
    check(all(np.isfinite(losses)), f"non-finite training loss {losses}")
    check(len(losses) >= 2 and losses[-1] < losses[0],
          f"training loss did not fall: {losses}")
    say(f"[pipeline] evaluate ndcg@10={report.get('ndcg@10'):.4f} "
        f"recall@20={report.get('recall@20'):.4f}")
    return orch


def load_serving_pipeline(orch):
    from recommendit_tpu.serving.recommender import RecommendationPipeline

    cfg = orch.cfg
    pipe = RecommendationPipeline(
        model_path=cfg.EMBEDDING_MODEL_PATH, index_path=cfg.INDEX_PATH,
        ranker_path=cfg.RANKER_MODEL_PATH, data_dir=orch.data_dir,
        features_dir=orch.features_dir, cfg=cfg,
    )
    pipe.load()
    return pipe


# ------------------------------------------------------------------ #
# Serve                                                                #
# ------------------------------------------------------------------ #

def _http(url: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def phase_serve(orch, n_requests: int, batch: int, timed_calls: int):
    """Load the pipeline from the artifacts, serve it over HTTP and check
    the answers. Returns the loaded pipeline."""
    from http.server import ThreadingHTTPServer

    import jax
    import jax.numpy as jnp

    from recommendit_tpu.serving.app import create_app, make_handler

    t0 = time.perf_counter()
    pipe = load_serving_pipeline(orch)
    say(f"[serve] pipeline load (incl. serve-fn compile) "
        f"{time.perf_counter() - t0:.2f} s")
    app = create_app(pipeline=pipe, cfg=orch.cfg, load=False)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    ratings = orch._load_data().ratings
    seen = ratings.groupby("user_id")["item_id"].apply(set).to_dict()
    k = orch.cfg.TOP_K_RESULTS
    try:
        status, health = _http(f"{url}/health")
        check(status == 200 and health["status"] == "healthy",
              f"/health: {status} {health}")
        lat = []
        users = [1 + (37 * i) % pipe._n_users for i in range(n_requests + 1)]
        for i, u in enumerate(users):
            t1 = time.perf_counter()
            status, body = _http(f"{url}/recommend",
                                 {"user_id": int(u), "k": k})
            if i:  # the first request is the warm-up
                lat.append((time.perf_counter() - t1) * 1000)
            check(status == 200, f"/recommend user {u}: {status}")
            ids = [r["item_id"] for r in body["recommendations"]]
            check(len(ids) == k and len(set(ids)) == k,
                  f"user {u}: {len(set(ids))} distinct of {k}")
            check(not (set(ids) & seen.get(u, set())),
                  f"user {u}: seen items recommended")
            # the HTTP answer is the device path's answer, not a fallback
            dids, dsc, _ = pipe._serve_fn(jnp.asarray(u, jnp.int32))
            dids = np.asarray(dids)[np.isfinite(np.asarray(dsc))][:k]
            check(ids[:len(dids)] == dids.tolist(),
                  f"user {u}: HTTP answer differs from the serve fn")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "HTTP server thread did not stop")
    say(f"[serve] /recommend p50 {np.percentile(lat, 50):.3f} ms over "
        f"{len(lat)} requests (k={k}, after 1 warm-up)")

    uids = jnp.asarray(1 + np.arange(batch) % pipe._n_users, jnp.int32)
    t0 = time.perf_counter()
    jax.block_until_ready(pipe._serve_batch_fn(uids))
    compile_s = time.perf_counter() - t0
    dt = _timed_calls(lambda: pipe._serve_batch_fn(uids), timed_calls)
    say(f"[serve] serve_batch {batch} users: {dt * 1e3:.3f} ms "
        f"(median of {timed_calls}; first call incl. compile "
        f"{compile_s:.2f} s)")
    return pipe


# ------------------------------------------------------------------ #
# Reference                                                            #
# ------------------------------------------------------------------ #

def _near_tie_mismatch(got_ids, got_scores, ref_ids, ref_scores, tol):
    """Rows where the two top lists differ by more than ties at the list
    boundary: an item in one list but not the other must score within
    ``tol`` of the other list's last score. ``got_scores``/``ref_scores``
    are each list's own scores, sorted descending."""
    bad = []
    for r in range(len(got_ids)):
        g = dict(zip(got_ids[r].tolist(), got_scores[r].tolist()))
        f = dict(zip(ref_ids[r].tolist(), ref_scores[r].tolist()))
        for a, b, last in ((g, f, ref_scores[r][-1]),
                           (f, g, got_scores[r][-1])):
            for item in set(a) - set(b):
                if a[item] > last + tol:
                    bad.append(r)
    return sorted(set(bad))


def phase_reference(pipe, orch, n_users: int, cpu_device=None):
    """Retrieval top-k against float64 numpy; the ranked top-20 of the
    serve program at ``highest`` matmul precision on the card against the
    same program on the host CPU; the served (default-precision) top-20
    against the card's ``highest`` run."""
    import jax
    import jax.numpy as jnp

    from recommendit_tpu.models.two_tower import user_tower
    from recommendit_tpu.ops.topk import mips_topk_numpy

    users = 1 + np.arange(n_users) % pipe._n_users
    index = pipe.index
    k = min(orch.cfg.TOP_K_CANDIDATES, index.n_total)
    q = np.asarray(user_tower(pipe.model.params, jnp.asarray(users)))
    vals, ids = index.batch_search(q, k)
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    if index.has_bias:
        qn = np.concatenate([qn, np.ones((len(qn), 1), qn.dtype)], axis=1)
    corpus = np.asarray(index._embs, np.float64)
    ref_vals, ref_pos = mips_topk_numpy(qn, corpus, k)
    ref_ids = index.item_ids[ref_pos]
    scale = max(1.0, float(np.abs(ref_vals).max()))
    tol = 1e-4 * scale
    say(f"[reference] retrieval {index.mode}/{index.dtype}: tolerance "
        f"{tol:.2e} = 1e-4 x max|score| (precision HIGHEST, true fp32 "
        f"products and f32 accumulation over {corpus.shape[1]} terms "
        f"against float64)")
    err = float(np.abs(vals - ref_vals).max())
    say(f"[reference] retrieval {n_users} users x top-{k}: max |value "
        f"error| {err:.3e}")
    check(err <= tol, f"retrieval values off by {err:.3e} > {tol:.2e}")
    bad = _near_tie_mismatch(ids, vals, ref_ids, ref_vals, tol)
    check(not bad, f"retrieval ids differ beyond k-th-score ties in rows "
          f"{bad[:10]}")

    # ranked top-20. (1) The serve program at 'highest' matmul precision
    # on the card against the same program on the host CPU: both true
    # fp32, so only summation order differs. (2) The served program
    # (default precision) against (1) on the card: what TF32 changes.
    top = orch.cfg.TOP_K_RESULTS
    uids = jnp.asarray(users, jnp.int32)

    def ranked(device):
        with jax.default_device(device), \
                jax.default_matmul_precision("highest"):
            p = load_serving_pipeline(orch)
            ids_, sc_, _ = p._serve_batch_fn(uids)
        return np.asarray(ids_)[:, :top], np.asarray(sc_)[:, :top]

    def compare(ids_a, sc_a, ids_b, sc_b, tol):
        fin = np.isfinite(sc_a)
        check((fin == np.isfinite(sc_b)).all(),
              "seen-item masks differ between the two runs")
        err_ = float(np.abs(np.where(fin, sc_a - sc_b, 0.0)).max())
        overlap_ = float(np.mean([len(set(a) & set(b)) / top
                                  for a, b in zip(ids_a, ids_b)]))
        bad_ = _near_tie_mismatch(
            np.where(fin, ids_a, -1), np.where(fin, sc_a, -1e30),
            np.where(fin, ids_b, -1), np.where(fin, sc_b, -1e30), tol)
        return err_, overlap_, bad_

    h_ids, h_sc = ranked(jax.devices()[0])
    c_ids, c_sc = ranked(cpu_device or jax.devices("cpu")[0])
    rank_tol = 1e-3
    rerr, overlap, bad = compare(h_ids, h_sc, c_ids, c_sc, rank_tol)
    say(f"[reference] ranked top-{top}, card vs host CPU, both at "
        f"'highest' (true fp32): max |score error| {rerr:.3e} (tolerance "
        f"{rank_tol} on the blended z-scores: summation order only), mean "
        f"id overlap {overlap:.4f}")
    check(rerr <= rank_tol, f"ranked scores off by {rerr:.3e}")
    check(not bad, f"ranked ids differ beyond near-ties in rows {bad[:10]}")

    s_ids, s_sc, _ = pipe._serve_batch_fn(uids)
    s_ids, s_sc = np.asarray(s_ids)[:, :top], np.asarray(s_sc)[:, :top]
    serr, soverlap, sbad = compare(s_ids, s_sc, h_ids, h_sc, 5e-2)
    say(f"[reference] ranked top-{top}, served (default precision: TF32 "
        f"tower and ranker matmuls) vs 'highest' on the card: max |score "
        f"diff| {serr:.3e}, mean id overlap {soverlap:.4f}, {len(sbad)} of "
        f"{len(users)} users differ beyond near-ties at 5e-2 (retrieval "
        f"boundary items move with TF32 noise; required overlap >= 0.9)")
    check(soverlap >= 0.9, f"served top-{top} overlap {soverlap:.4f}")
    return {"retrieval_err": err, "rank_err": rerr, "overlap": overlap,
            "served_overlap": soverlap}


# ------------------------------------------------------------------ #
# Engines                                                              #
# ------------------------------------------------------------------ #

def engine_reference(index, queries: np.ndarray, k: int):
    """float64 operands whose product is exactly the score ``index``
    ranks — its stored corpus (f32 or bf16 values) against the normalized
    queries, or for int8 both int8 operands times their scales — and the
    numpy exact top-k (``mips_topk_numpy``) over them."""
    import jax.numpy as jnp

    from recommendit_tpu.ops.topk import _quantize_queries, mips_topk_numpy

    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    if index.dtype == "int8":
        q_i8, q_scale = _quantize_queries(jnp.asarray(qn, jnp.float32))
        qf = (np.asarray(q_i8, np.float64)
              * np.asarray(q_scale, np.float64)[:, None])
        cf = (np.asarray(index._embs, np.float64)
              * np.asarray(index._scales, np.float64)[:, None])
    else:
        qf = qn.astype(np.float64)
        cf = np.asarray(index._embs, np.float32).astype(np.float64)
    ref_vals, ref_pos = mips_topk_numpy(qf, cf, k)
    return qf, cf, ref_vals, ref_pos


def engine_recall(got_pos, qf, cf, ref_vals, ref_pos,
                  tol: float = 1e-6) -> float:
    """Mean recall@k against the reference top-k; a returned item whose
    reference score ties the k-th one (within ``tol``, the f32-vs-f64
    rounding of a normalized score) counts as a hit."""
    hits = 0
    for r in range(len(ref_pos)):
        ref = set(ref_pos[r].tolist())
        got = got_pos[r]
        score = cf[got] @ qf[r]
        hit = np.fromiter((p in ref for p in got.tolist()), bool, len(got))
        hits += int((hit | (score >= ref_vals[r, -1] - tol)).sum())
    return hits / ref_pos.size


def engine_data(sizes: Sizes, seed: int):
    """Seeded corpus and query batches shared by every engine."""
    rng = np.random.default_rng(seed)
    d = sizes.engine_dim
    return (rng.standard_normal((sizes.engine_items, d), dtype=np.float32),
            rng.standard_normal((sizes.engine_q, d), dtype=np.float32),
            rng.standard_normal((sizes.engine_q_large, d), dtype=np.float32))


def run_engine(mode: str, dtype: str, data, sizes: Sizes, seed: int,
               card: str, refs: dict) -> dict:
    """Build ``MIPSIndex(mode, dtype)`` over the shared corpus, check its
    recall against numpy exact on ``recall_queries`` queries (``refs``
    caches the reference per dtype) and time an ``engine_q`` batch."""
    import jax
    import jax.numpy as jnp

    from recommendit_tpu.models.retrieval import MIPSIndex

    corpus, queries, large_q = data
    k, nq = sizes.engine_k, sizes.recall_queries
    index = MIPSIndex(embedding_dim=sizes.engine_dim, mode=mode, dtype=dtype,
                      quant_seed=seed)
    index.build(corpus, np.arange(len(corpus)))
    if dtype not in refs:
        refs[dtype] = engine_reference(index, queries[:nq], k)
    # the searcher as serving and the bench jit it, with the corpus as an
    # argument (compile_s would show a corpus baked in as a constant)
    searcher = jax.jit(index.make_device_searcher(k))

    def search(q):
        return searcher(q, index.device_corpus)

    qn = jnp.asarray(queries / np.linalg.norm(queries, axis=1, keepdims=True))
    t0 = time.perf_counter()
    vals, pos = jax.block_until_ready(search(qn))
    compile_s = time.perf_counter() - t0
    dt = _timed_calls(lambda: search(qn), sizes.timed_calls)
    pos = np.asarray(pos)
    check(pos.shape == (len(queries), k)
          and np.isfinite(np.asarray(vals)).all(),
          f"{mode}/{dtype}: bad output")
    rec = engine_recall(pos[:nq], *refs[dtype])
    need = recall_contract(mode, dtype)
    row = {"mode": mode, "dtype": dtype, "recall": rec,
           "batch_ms": dt * 1e3, "compile_s": compile_s}
    say(f"[engines] {mode:8s} {dtype:8s} recall@{k} {rec:.4f} "
        f"(contract >= {need}) {dt * 1e3:.3f} ms/batch of {len(queries)} "
        f"= {len(queries) / dt:.0f} QPS (compile {compile_s:.2f} s) "
        f"on {card}")
    check(rec >= need, f"{mode}/{dtype}: recall {rec:.4f} < {need}")
    if dtype == "bfloat16" and mode in ("exact", "approx", "fused"):
        ql = jnp.asarray(large_q / np.linalg.norm(large_q, axis=1,
                                                  keepdims=True))
        jax.block_until_ready(search(ql))
        dtl = _timed_calls(lambda: search(ql), sizes.timed_calls)
        row["batch_ms_large_q"] = dtl * 1e3
        say(f"[engines] {mode:8s} {dtype:8s} q={len(large_q)}: "
            f"{dtl * 1e3:.3f} ms/batch = {len(large_q) / dtl:.0f} QPS "
            f"on {card}")
    return row


def phase_engines(sizes: Sizes, seed: int, card: str):
    """Every (mode, dtype) pair of MIPSIndex over one seeded corpus."""
    data = engine_data(sizes, seed)
    refs = {}
    return [run_engine(mode, dtype, data, sizes, seed, card, refs)
            for mode, dtype in ENGINE_PAIRS]


# ------------------------------------------------------------------ #
# Plain XLA replacements of the removed kernels                        #
# ------------------------------------------------------------------ #

def _loop_in_batch_bpr(u, v) -> float:
    """Literal per-row loop of the in-batch BPR loss, float64."""
    s = np.asarray(u, np.float64) @ np.asarray(v, np.float64).T
    total = 0.0
    for i in range(s.shape[0]):
        m = s[i, i] - np.delete(s[i], i)
        total += np.mean(np.logaddexp(0.0, -m))
    return total / s.shape[0]


def phase_plain_xla(sizes: Sizes, seed: int, card: str):
    """Time the XLA in-batch BPR step (forward + backward) and the
    serving row gather, each checked against numpy."""
    import jax
    import jax.numpy as jnp

    from recommendit_tpu.ops.bpr import in_batch_bpr_loss

    rng = np.random.default_rng(seed)
    out = {}
    step = jax.jit(jax.value_and_grad(in_batch_bpr_loss, argnums=(0, 1)))
    for b in sizes.bpr_batches:
        u = rng.standard_normal((b, 64)).astype(np.float32)
        v = rng.standard_normal((b, 64)).astype(np.float32)
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        ud, vd = jnp.asarray(u), jnp.asarray(v)
        loss, grads = jax.block_until_ready(step(ud, vd))
        ref = _loop_in_batch_bpr(u, v)
        check(abs(float(loss) - ref) <= 1e-3,
              f"BPR loss {float(loss)} vs loop {ref}")
        check(all(np.isfinite(np.asarray(g)).all() for g in grads),
              "non-finite BPR gradient")
        dt = _timed_calls(lambda: step(ud, vd), 20)
        out[f"bpr_b{b}_ms"] = dt * 1e3
        say(f"[plain_xla] in-batch BPR fwd+bwd B={b} d=64: {dt * 1e3:.3f} ms "
            f"(loss {float(loss):.6f} vs loop {ref:.6f}, tol 1e-3 for TF32 "
            f"scores) on {card}")
    table = rng.standard_normal((sizes.gather_rows, 64), dtype=np.float32)
    idx = rng.integers(0, sizes.gather_rows, size=(256, 500), dtype=np.int32)
    td, idd = jnp.asarray(table), jnp.asarray(idx)
    take = jax.jit(lambda t, i: jnp.take(t, i, axis=0))
    got = np.asarray(jax.block_until_ready(take(td, idd)))
    check(np.array_equal(got, table[idx]), "row gather differs from numpy")
    dt = _timed_calls(lambda: take(td, idd), 20)
    out["gather_ms"] = dt * 1e3
    say(f"[plain_xla] jnp.take 256x500 rows of ({sizes.gather_rows}, 64) "
        f"f32: {dt * 1e3:.3f} ms on {card}")
    return out


# ------------------------------------------------------------------ #
# Four cards                                                           #
# ------------------------------------------------------------------ #

def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _mesh(devices, shape):
    from recommendit_tpu.parallel.mesh import create_mesh

    return create_mesh(shape=shape, devices=devices[: shape[0] * shape[1]])


def four_card_retrieval(devices, sizes: Sizes, seed: int):
    import jax
    import jax.numpy as jnp

    from recommendit_tpu.ops.topk import mips_topk
    from recommendit_tpu.parallel.mesh import row_sharded
    from recommendit_tpu.parallel.retrieval import (
        sharded_mips_topk,
        sharded_mips_topk_ring,
    )

    n, d, k = sizes.four_card_items, sizes.engine_dim, sizes.engine_k
    key = jax.random.PRNGKey(seed)
    with jax.default_device(devices[0]):
        corpus = jax.random.normal(key, (n, d), jnp.float32)
        q = jax.random.normal(jax.random.fold_in(key, 1),
                              (sizes.engine_q, d), jnp.float32)
        ref_v, ref_i = mips_topk(q, corpus, k, 4096, "exact", True)
        ref_v, ref_i = np.asarray(ref_v), np.asarray(ref_i)
    mesh = _mesh(devices, (1, 4))
    sharded = jax.device_put(corpus, row_sharded(mesh))
    for name, fn in (("all-gather", sharded_mips_topk),
                     ("ring", sharded_mips_topk_ring)):
        v, i = fn(q, sharded, k, mesh, 4096, canonical=True)
        v, i = np.asarray(v), np.asarray(i)
        err = float(np.abs(v - ref_v).max())
        same = float((i == ref_i).mean())
        say(f"[four_cards] sharded retrieval ({name} merge) {n} x {d} "
            f"k={k} over 4 cards: id match {same:.6f}, max |value diff| "
            f"{err:.3e} (tol 1e-5: same fp32 HIGHEST scores)")
        check(err <= 1e-5, f"{name}: values differ by {err}")
        bad = _near_tie_mismatch(i, v, ref_i, ref_v, 1e-5)
        check(not bad, f"{name}: ids differ beyond ties in rows {bad[:5]}")


def four_card_train(devices, sizes: Sizes, seed: int):
    import jax
    import jax.numpy as jnp
    import optax

    from recommendit_tpu.models.two_tower import init_params
    from recommendit_tpu.parallel.train import (
        init_sharded_state,
        make_sharded_train_step,
    )

    cfg = smoke_settings(sizes, seed)
    rng = np.random.default_rng(seed)
    # table rows padded to a multiple of the model axis (ids never reach
    # the pad rows)
    n_u = _round_up(sizes.users + 1, 4) - 1
    n_i = _round_up(sizes.items + 1, 4) - 1
    genre = jnp.asarray((rng.random((n_i + 1, 18)) < 0.2).astype(np.float32))
    b = cfg.BATCH_SIZE
    batches = [(jnp.asarray(rng.integers(1, sizes.users + 1, b), jnp.int32),
                jnp.asarray(rng.integers(1, sizes.items + 1, b), jnp.int32))
               for _ in range(sizes.four_card_steps)]
    tol = 1e-3

    def run(shape):
        mesh = _mesh(devices, shape)
        tx = optax.adamw(cfg.LEARNING_RATE)
        params = init_params(jax.random.PRNGKey(seed), n_u, n_i,
                             cfg.EMBEDDING_DIM, cfg.HIDDEN_DIM)
        p, o = init_sharded_state(mesh, tx, params)
        step = make_sharded_train_step(mesh, tx, genre, dropout_rate=0.0)
        losses = []
        for t, bt in enumerate(batches):
            p, o, loss = step(p, o, bt, jax.random.PRNGKey(t))
            losses.append(float(loss))
        return losses

    ref = run((1, 1))
    check(all(np.isfinite(ref)), f"non-finite one-card loss {ref}")
    for shape in ((1, 4), (2, 2)):
        got = run(shape)
        err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
        say(f"[four_cards] sharded train mesh {shape}: {len(got)} steps, "
            f"loss {got[0]:.6f} -> {got[-1]:.6f}, max |diff| vs one card "
            f"{err:.3e} (tol {tol}: TF32 matmuls, other reduction order)")
        check(err <= tol, f"train {shape}: loss differs by {err}")


def four_card_serve(devices, sizes: Sizes, seed: int):
    import jax
    import jax.numpy as jnp

    from recommendit_tpu.features.schema import (
        ITEM_PACKED_DIM,
        USER_PACKED_DIM,
        pad_packed_width,
    )
    from recommendit_tpu.models.ranker import init_mlp, mlp_score
    from recommendit_tpu.models.two_tower import init_params
    from recommendit_tpu.parallel.mesh import row_sharded
    from recommendit_tpu.parallel.serve import make_sharded_serve_fn

    cfg = smoke_settings(sizes, seed)
    rng = np.random.default_rng(seed)
    n_items = _round_up(sizes.items, 4)
    params = init_params(jax.random.PRNGKey(seed), sizes.users, n_items,
                         cfg.EMBEDDING_DIM, cfg.HIDDEN_DIM)
    corpus = rng.standard_normal((n_items, cfg.EMBEDDING_DIM)).astype(
        np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    ids = jnp.arange(1, n_items + 1, dtype=jnp.int32)
    user_packed = jnp.asarray(
        rng.standard_normal((sizes.users + 1, USER_PACKED_DIM)), jnp.float32)
    item_packed = jnp.asarray(pad_packed_width(
        rng.standard_normal((n_items + 1, ITEM_PACKED_DIM)).astype(
            np.float32)))
    rparams = init_mlp(jax.random.PRNGKey(seed + 1), 50,
                       cfg.RANKER_HIDDEN_DIMS)
    uids = jnp.asarray(1 + np.arange(sizes.ref_users) % sizes.users,
                       jnp.int32)
    k_cand = min(cfg.TOP_K_CANDIDATES, n_items // 4)

    def run(shape):
        mesh = _mesh(devices, shape)
        serve = make_sharded_serve_fn(
            mesh, params, jax.device_put(jnp.asarray(corpus),
                                         row_sharded(mesh)),
            ids, user_packed, item_packed,
            lambda f: mlp_score(rparams, f), n_candidates=k_cand, k_out=20)
        got_ids, got_sc, _ = serve(uids)
        return np.asarray(got_ids), np.asarray(got_sc)

    ref_ids, ref_sc = run((1, 1))
    got_ids, got_sc = run((2, 2))
    err = float(np.abs(got_sc - ref_sc).max())
    same = float((got_ids == ref_ids).mean())
    say(f"[four_cards] sharded serve mesh (2, 2): top-20 id match "
        f"{same:.6f}, max |score diff| {err:.3e} (tol 1e-3: TF32 tower and "
        f"ranker matmuls)")
    check(err <= 1e-3, f"serve scores differ by {err}")
    bad = _near_tie_mismatch(got_ids, got_sc, ref_ids, ref_sc, 1e-3)
    check(not bad, f"serve ids differ beyond ties in rows {bad[:5]}")


def four_card_ctr(devices, sizes: Sizes, seed: int):
    import jax
    import jax.numpy as jnp
    import optax

    from recommendit_tpu.config import Settings
    from recommendit_tpu.data.ctr import N_USER_FIELDS, make_ctr_dataset
    from recommendit_tpu.models.ctr import CTRModel, init_ctr_params
    from recommendit_tpu.parallel.ctr import (
        init_ctr_sharded_state,
        make_ctr_sharded_train_step,
    )

    cfg = Settings()
    b = cfg.CTR_BATCH_SIZE
    data = make_ctr_dataset(n_examples=b * sizes.four_card_steps, seed=seed)
    model = CTRModel(data.vocab_sizes, embed_dim=cfg.CTR_EMBED_DIM)
    ids = model.stack_ids(data.sparse)
    batches = [(jnp.asarray(data.dense[s:s + b]),
                jnp.asarray(ids[s:s + b]),
                jnp.asarray(data.labels[s:s + b]))
               for s in range(0, b * sizes.four_card_steps, b)]
    tol = 1e-3

    def run(shape):
        mesh = _mesh(devices, shape)
        params = init_ctr_params(
            jax.random.PRNGKey(seed), data.vocab_sizes,
            embed_dim=cfg.CTR_EMBED_DIM, top_hidden=cfg.CTR_TOP_HIDDEN,
            retrieval_dim=cfg.CTR_RETRIEVAL_DIM, pad_rows_to=4)
        tx = optax.adam(cfg.CTR_LEARNING_RATE)
        p, o = init_ctr_sharded_state(mesh, tx, params)
        step = make_ctr_sharded_train_step(
            mesh, tx, N_USER_FIELDS, joint=cfg.CTR_JOINT,
            retrieval_weight=cfg.CTR_RETRIEVAL_WEIGHT,
            temperature=cfg.CTR_SOFTMAX_TEMPERATURE)
        losses = []
        for bt in batches:
            p, o, loss = step(p, o, bt)
            losses.append(float(loss))
        return losses

    ref = run((1, 1))
    got = run((2, 2))
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    say(f"[four_cards] sharded CTR mesh (2, 2): {len(got)} steps of {b}, "
        f"loss {got[0]:.6f} -> {got[-1]:.6f}, max |diff| vs one card "
        f"{err:.3e} (tol {tol}: TF32 matmuls, other reduction order)")
    check(all(np.isfinite(got)), f"non-finite CTR loss {got}")
    check(err <= tol, f"CTR loss differs by {err}")


def phase_four_cards(devices, sizes: Sizes, seed: int):
    check(len(devices) >= 4, f"--four-cards needs 4 devices, "
          f"found {len(devices)}")
    devices = list(devices[:4])
    for fn in (four_card_retrieval, four_card_train, four_card_serve,
               four_card_ctr):
        t0 = time.perf_counter()
        fn(devices, sizes, seed)
        say(f"[four_cards] {fn.__name__} {time.perf_counter() - t0:.2f} s")


# ------------------------------------------------------------------ #

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--work-dir", default=str(REPO / "smoke_work"))
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four GPUs")
    args = ap.parse_args(argv)
    block_optional_packages()
    t_start = time.perf_counter()
    info = phase_device("gpu")
    import jax

    sizes = FULL
    if args.four_cards:
        phase_four_cards(jax.devices(), sizes, args.seed)
    else:
        work = Path(args.work_dir)
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        phases = []
        t0 = time.perf_counter()
        orch = phase_pipeline(
            work, smoke_settings(sizes, args.seed), sizes.eval_users)
        phases.append(("pipeline", time.perf_counter() - t0))
        t0 = time.perf_counter()
        pipe = phase_serve(orch, sizes.http_requests, sizes.ref_users,
                           sizes.timed_calls)
        phases.append(("serve", time.perf_counter() - t0))
        t0 = time.perf_counter()
        phase_reference(pipe, orch, sizes.ref_users)
        phases.append(("reference", time.perf_counter() - t0))
        del pipe
        t0 = time.perf_counter()
        phase_engines(sizes, args.seed, info["card"])
        phases.append(("engines", time.perf_counter() - t0))
        t0 = time.perf_counter()
        phase_plain_xla(sizes, args.seed, info["card"])
        phases.append(("plain_xla", time.perf_counter() - t0))
        say(f"[smoke] phase seconds "
            f"{ {k: round(v, 2) for k, v in phases} }")
    say(f"[smoke] total {time.perf_counter() - t_start:.2f} s on "
        f"{info['card']}")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
