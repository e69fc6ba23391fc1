"""Retrieval-only tower hyperparameter sweep on the canonical benchmark.

The full quality ladder (``scripts/ladder_sweep.py``) costs ~20 min/seed
because the candidates-mode ranker dominates the run. When the question is
only "does this tower setting lift retrieval-only NDCG@10?" the ranker is
dead weight: this driver trains embeddings + builds the index and scores
the retrieval-only row directly with the reference's temporal protocol
(same logic as ``run_pipeline.run_evaluate:294-308``), ~4x faster.

Usage:
  JAX_PLATFORMS=cpu PYTHONPATH=. \
    python scripts/tower_sweep.py --name dim128 --seeds 2 \
      --cfg EMBEDDING_DIM=128 [--cfg TRAIN_EPOCHS=90]

Appends one JSON line per (name, seed) + an aggregate line to --log
(default /tmp/tower_sweep.jsonl). The q3k dataset (3,000 x 2,000 x 400k,
data seed 0 — identical to quality_ladder.jsonl) is generated once and
shared across configs so rows are comparable.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def _apply_cfg(cfg, pairs):
    overrides = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            overrides[k] = v.lower() in ("1", "true")
        elif isinstance(cur, tuple):
            overrides[k] = tuple(type(cur[0])(x) for x in v.split(","))
        else:
            overrides[k] = type(cur)(v)
    return cfg.replace(**overrides) if overrides else cfg


def run_one(name, seed, args):
    from recommendit_tpu.config import Settings
    from recommendit_tpu.data.movielens import save_movielens
    from recommendit_tpu.data.synthetic import make_synthetic_movielens
    from recommendit_tpu.evaluation.metrics import evaluate_model
    from recommendit_tpu.models.retrieval import MIPSIndex
    from recommendit_tpu.models.two_tower import TwoTowerModel
    from recommendit_tpu.pipelines.run_pipeline import PipelineOrchestrator

    cfg = _apply_cfg(
        Settings(SEED=seed, SYNTH_USERS=args.users, SYNTH_ITEMS=args.items,
                 SYNTH_RATINGS=args.ratings),
        args.cfg,
    )
    data_dir = f"{args.work_dir}/data"
    if not os.path.exists(f"{data_dir}/ratings.dat"):
        data = make_synthetic_movielens(
            n_users=args.users, n_items=args.items, n_ratings=args.ratings,
            seed=args.data_seed,
        )
        save_movielens(data, data_dir)

    work = f"{args.work_dir}/{name}_s{seed}"
    orch = PipelineOrchestrator(
        cfg=cfg, data_dir=data_dir, models_dir=f"{work}/models",
        features_dir=f"{work}/features", synthetic=False,
        eval_users=args.eval_users,
    )
    t0 = time.time()
    orch.run_stage("embeddings")
    orch.run_stage("index")

    # retrieval-only + popularity rows, reference temporal protocol
    data = orch._load_data()
    r = data.ratings.sort_values("timestamp")
    cut = int(len(r) * 0.9)
    train_r, test_r = r.iloc[:cut], r.iloc[cut:]
    truth = (
        test_r[test_r["rating"] >= 4]
        .groupby("user_id")["item_id"].apply(list).to_dict()
    )
    users = list(truth.keys())[: args.eval_users]
    seen_train = (
        {u: set(g.values) for u, g in train_r.groupby("user_id")["item_id"]}
        if cfg.FILTER_SEEN else {}
    )

    def _filtered(u, ordered_ids, k=20):
        s = seen_train.get(u, ())
        return [int(i) for i in ordered_ids if i not in s][:k]

    model = TwoTowerModel.load(orch.cfg.EMBEDDING_MODEL_PATH)
    index = MIPSIndex.load(orch.cfg.INDEX_PATH)
    known = [u for u in users if 1 <= u <= model.n_users]
    q = np.stack([model.get_user_embedding(u) for u in known])
    k_search = (min(cfg.TOP_K_CANDIDATES, index.n_total)
                if cfg.FILTER_SEEN else 20)
    _, ids = index.batch_search(q, k=k_search)
    retr = evaluate_model(
        {u: _filtered(u, ids[i].tolist()) for i, u in enumerate(known)},
        truth, k_values=[10, 20],
    )
    pop_all = (
        train_r.groupby("item_id").size().sort_values(ascending=False)
        .index.tolist()
    )
    # evaluate popularity over the SAME user subset as retrieval — mixing
    # populations biases the ratio when eval users fall outside the model's
    # id range (advisor round-3 finding)
    pop = evaluate_model(
        {u: _filtered(u, pop_all) for u in known}, truth, k_values=[10, 20]
    )
    return {
        "name": name, "seed": seed,
        "retrieval_ndcg@10": retr["ndcg@10"],
        "retrieval_recall@20": retr["recall@20"],
        "retrieval_mrr": retr["mrr"],
        "popularity_ndcg@10": pop["ndcg@10"],
        "ret_over_pop": retr["ndcg@10"] / max(pop["ndcg@10"], 1e-12),
        "cfg": {kv.split("=", 1)[0]: kv.split("=", 1)[1]
                for kv in (args.cfg or [])},
        "seconds": round(time.time() - t0, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", required=True)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--users", type=int, default=3000)
    ap.add_argument("--items", type=int, default=2000)
    ap.add_argument("--ratings", type=int, default=400_000)
    ap.add_argument("--eval-users", type=int, default=500)
    ap.add_argument("--cfg", action="append",
                    help="Settings override KEY=VALUE (repeatable)")
    ap.add_argument("--work-dir", default="/tmp/tower_sweep")
    ap.add_argument("--log", default="/tmp/tower_sweep.jsonl")
    args = ap.parse_args()

    from recommendit_tpu.utils.logging import setup_logging

    setup_logging("WARNING")
    rows = []
    for s in range(args.seed_base, args.seed_base + args.seeds):
        row = run_one(args.name, s, args)
        rows.append(row)
        line = json.dumps(row, default=float)
        print(line, flush=True)
        with open(args.log, "a") as f:
            f.write(line + "\n")
    if len(rows) > 1:
        agg = {
            "name": args.name, "agg": True, "n_seeds": len(rows),
            "retrieval_ndcg@10": float(
                np.mean([r["retrieval_ndcg@10"] for r in rows])),
            "std": float(np.std([r["retrieval_ndcg@10"] for r in rows])),
            "popularity_ndcg@10": rows[0]["popularity_ndcg@10"],
            "ret_over_pop": float(
                np.mean([r["ret_over_pop"] for r in rows])),
        }
        line = json.dumps(agg, default=float)
        print(line, flush=True)
        with open(args.log, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
