"""Two-stage quality ladder at ML-25M-shaped scale (BASELINE #3 quality).

Round 2 proved the >HBM host-table path's THROUGHPUT at real row counts
(RESULTS.md); this driver proves the QUALITY machinery survives the same
scale: generate an ml25m-shaped synthetic dataset (162,541 users x 62,423
items), train the tower through the HOST_TABLE=1 offload driver, build the
index from streamed catalog embeddings, train the candidates-mode ranker,
and run the temporal-protocol evaluation — then cross-check the corpus on
the 8-device virtual mesh: sharded retrieval (all-gather merge AND ppermute
ring) must return the single-device ordering identically, with measured
QPS for both.

Usage (runs ~1-3 h on a 2-core CPU host; all stages platform-agnostic):
  JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 PYTHONPATH=. \
    python scripts/quality_at_scale.py --ratings 4000000 --epochs 10 \
      --work-dir /tmp/qscale [--users 162541] [--items 62423]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=162_541)   # ml25m rows
    ap.add_argument("--items", type=int, default=62_423)
    ap.add_argument("--ratings", type=int, default=4_000_000)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--eval-users", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--embedding-dim", type=int, default=64)
    ap.add_argument("--work-dir", default="/tmp/qscale")
    ap.add_argument("--out", default="/tmp/qscale/report.json")
    ap.add_argument("--cfg", action="append",
                    help="Settings override KEY=VALUE (repeatable)")
    args = ap.parse_args()

    from recommendit_tpu.config import Settings
    from recommendit_tpu.data.movielens import save_movielens, verify_dataset
    from recommendit_tpu.data.synthetic import make_synthetic_movielens
    from recommendit_tpu.pipelines.run_pipeline import PipelineOrchestrator
    from recommendit_tpu.utils.logging import setup_logging

    setup_logging("INFO")
    cfg = Settings(
        SEED=args.seed,
        HOST_TABLE=True,
        HOST_TABLE_PREFETCH=2,
        TRAIN_EPOCHS=args.epochs,
        EMBEDDING_DIM=args.embedding_dim,
        SYNTH_USERS=args.users, SYNTH_ITEMS=args.items,
        SYNTH_RATINGS=args.ratings,
        # candidate-mode ranker: cap queries so the feature frame stays
        # bounded; inner tower inherits TRAIN_EPOCHS
        RANKER_MAX_QUERIES=8000,
    )
    overrides = {}
    for kv in args.cfg or []:
        k, v = kv.split("=", 1)
        cur = getattr(cfg, k)
        overrides[k] = (v.lower() in ("1", "true")) if isinstance(cur, bool) \
            else type(cur)(v)
    if overrides:
        cfg = cfg.replace(**overrides)
    data_dir = f"{args.work_dir}/ml"
    t_gen = time.time()
    from pathlib import Path

    if not verify_dataset(Path(data_dir)):
        data = make_synthetic_movielens(
            n_users=args.users, n_items=args.items, n_ratings=args.ratings,
            seed=args.seed,
        )
        save_movielens(data, data_dir)
    t_gen = time.time() - t_gen

    orch = PipelineOrchestrator(
        cfg=cfg, data_dir=data_dir, models_dir=f"{args.work_dir}/models",
        features_dir=f"{args.work_dir}/features", synthetic=False,
        eval_users=args.eval_users,
    )
    hist = orch.run_stage("features") or {}
    hist = orch.run_stage("embeddings")
    train_ex_s = float(np.mean([h["examples_per_s"] for h in hist])) \
        if hist else 0.0
    orch.run_stage("index")
    orch.run_stage("ranker")
    rep = orch.run_stage("evaluate")

    report = {
        "config": {
            "users": args.users, "items": args.items,
            "ratings": args.ratings, "epochs": args.epochs,
            "eval_users": args.eval_users, "dim": args.embedding_dim,
            "host_table": True, "gen_seconds": round(t_gen, 1),
        },
        "ladder": {
            "popularity_ndcg@10": rep.get("popularity_ndcg@10"),
            "retrieval_only_ndcg@10": rep.get("retrieval_only_ndcg@10"),
            "full_ndcg@10": rep.get("ndcg@10"),
            "popularity_recall@20": rep.get("popularity_recall@20"),
            "retrieval_only_recall@20": rep.get("retrieval_only_recall@20"),
            "full_recall@20": rep.get("recall@20"),
            "mrr": rep.get("mrr"),
        },
        "host_table_train_examples_per_s": round(train_ex_s, 1),
        "stage_seconds": {k: round(v, 1) for k, v in orch.stage_times.items()},
    }

    # ---- sharded retrieval identity + QPS on the virtual mesh ---------- #
    import jax
    import jax.numpy as jnp

    from recommendit_tpu.models.retrieval import MIPSIndex
    from recommendit_tpu.parallel.mesh import create_mesh
    from recommendit_tpu.parallel.retrieval import (
        sharded_mips_topk,
        sharded_mips_topk_ring,
    )

    idx = MIPSIndex.load(orch.cfg.INDEX_PATH)
    embs = np.asarray(idx._embs, np.float32)          # (N, D[+bias])
    n, dcol = embs.shape
    n_dev = len(jax.devices())
    pad = (-n) % n_dev
    if pad:
        # padding rows must never win: zero vector + strongly negative bias
        pad_rows = np.zeros((pad, dcol), np.float32)
        pad_rows[:, -1] = -1e9 if idx.has_bias else 0.0
        if not idx.has_bias:
            # no bias column: append one (real rows 0, pad rows -1e9)
            embs = np.concatenate(
                [embs, np.zeros((n, 1), np.float32)], axis=1
            )
            pad_rows = np.zeros((pad, dcol + 1), np.float32)
            pad_rows[:, -1] = -1e9
        embs = np.concatenate([embs, pad_rows], axis=0)

    rng = np.random.default_rng(1)
    batch, k = 256, min(500, n // 2)
    q = rng.normal(size=(batch, embs.shape[1] - 1)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q = np.concatenate([q, np.ones((batch, 1), np.float32)], axis=1)
    qd, ed = jnp.asarray(q), jnp.asarray(embs)

    mesh = create_mesh(shape=(1, n_dev))
    from recommendit_tpu.ops.topk import mips_topk

    ref_v, ref_i = jax.jit(
        lambda a, b: mips_topk(a, b, k, 4096)
    )(qd, ed)
    timings = {}
    for name, fn in (
        ("allgather", sharded_mips_topk),
        ("ring", sharded_mips_topk_ring),
    ):
        call = jax.jit(lambda a, b, _f=fn: _f(a, b, k, mesh, 4096))
        v, i = call(qd, ed)

        def _canon(vv, ii):
            # host-side canonical (value desc, index asc) tie order — the
            # device paths keep canonical=False so the TIMED rows measure
            # the production configuration (no extra tie-order sort)
            order = np.lexsort((ii, -vv), axis=-1)
            return (np.take_along_axis(vv, order, axis=-1),
                    np.take_along_axis(ii, order, axis=-1))

        cv, ci = _canon(np.asarray(v), np.asarray(i))
        rv, ri = _canon(np.asarray(ref_v), np.asarray(ref_i))
        # canonical tie order makes paths element-identical except when
        # distinct items tie EXACTLY at the k-th f32 score — there the sets
        # may legitimately differ, but the values must still be identical
        mism = ci != ri
        vals_equal = cv == rv
        # where indices differ, the scores must be exact f32 ties; any
        # value divergence (tied or not) is a real bug
        assert bool(vals_equal[mism].all()) if mism.any() else True, \
            f"sharded {name} index mismatch at non-tied scores"
        assert bool(vals_equal.all()), \
            f"sharded {name} values diverged from single-device"
        jax.block_until_ready(call(qd, ed))
        t0 = time.perf_counter()
        for _ in range(5):
            v, i = call(qd, ed)
        jax.block_until_ready(v)
        dt = (time.perf_counter() - t0) / 5
        timings[name] = {
            "qps": round(batch / dt, 1), "batch_ms": round(dt * 1000, 2),
            "identical_to_single_device": bool(not mism.any()),
            "index_mismatches_at_tied_scores": int(mism.sum()),
        }
    report["sharded_retrieval"] = {
        "n_devices": n_dev, "corpus": int(embs.shape[0]), "k": k,
        "platform": jax.devices()[0].platform, **timings,
    }

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2, default=float)
    print(json.dumps(report, indent=2, default=float))


if __name__ == "__main__":
    main()
