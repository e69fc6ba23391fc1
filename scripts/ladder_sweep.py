"""Two-stage quality-ladder sweep over synthetic-generator weights.

The benchmark generator (``data/synthetic.py``) mixes tower-learnable
signal (bilinear latent, genre match), ranker-only signal (item quality,
nonlinear loyalty) and a popularity-quality exposure correlation. This
harness runs the FULL pipeline (features -> tower -> index -> candidates-
mode ranker -> temporal eval) for a given weight mix and reports the
three-row ladder (popularity / retrieval-only / full two-stage), so the
mix can be calibrated until both reference margins reproduce
(``/root/reference/README.md:36-38``: retrieval 2.2x popularity NDCG@10,
full +61% over retrieval).

Usage:
  JAX_PLATFORMS=cpu PYTHONPATH=. \
    python scripts/ladder_sweep.py --name base --seeds 2 \
      --weights '{"exposure_quality": 0.2, "latent": 1.1}' \
      [--epochs 60] [--eval-users 300] [--ranker-type mlp]

Prints one JSON line per seed and a final aggregate line; appends every
line to --log (default /tmp/ladder_sweep.jsonl) so runs accumulate.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def run_one(name, weights, seed, args):
    from recommendit_tpu.config import Settings
    from recommendit_tpu.data.movielens import save_movielens
    from recommendit_tpu.data.synthetic import make_synthetic_movielens
    from recommendit_tpu.pipelines.run_pipeline import PipelineOrchestrator

    cfg = Settings(SEED=seed)
    overrides = {}
    if args.epochs:
        overrides["TRAIN_EPOCHS"] = args.epochs
    if args.ranker_type:
        overrides["RANKER_TYPE"] = args.ranker_type
    for kv in args.cfg or []:
        k, v = kv.split("=", 1)
        cur = getattr(cfg, k)
        overrides[k] = type(cur)(v) if not isinstance(cur, bool) \
            else v.lower() in ("1", "true")
    if overrides:
        cfg = cfg.replace(**overrides)

    work = f"{args.work_dir}/{name}_s{seed}"
    data_dir = f"{args.work_dir}/{name}_data"
    if not os.path.exists(f"{data_dir}/ratings.dat"):
        data = make_synthetic_movielens(
            n_users=cfg.SYNTH_USERS, n_items=cfg.SYNTH_ITEMS,
            n_ratings=cfg.SYNTH_RATINGS, seed=args.data_seed,
            weights=weights,
        )
        save_movielens(data, data_dir)
    orch = PipelineOrchestrator(
        cfg=cfg, data_dir=data_dir, models_dir=f"{work}/models",
        features_dir=f"{work}/features", synthetic=False,
        eval_users=args.eval_users,
    )
    t0 = time.time()
    holdout = {}
    for stage in ("features", "embeddings", "index", "ranker"):
        out = orch.run_stage(stage)
        if stage == "ranker" and isinstance(out, dict):
            holdout = {f"holdout_{k}": v for k, v in out.items()}
    rep = orch.run_stage("evaluate")
    rep = {k: v for k, v in rep.items() if isinstance(v, (int, float))}
    rep.update(holdout)
    rep["seconds"] = round(time.time() - t0, 1)
    return rep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", required=True)
    ap.add_argument("--weights", default="{}",
                    help="JSON dict of SynthWeights field overrides")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--eval-users", type=int, default=300)
    ap.add_argument("--ranker-type", default=None)
    ap.add_argument("--cfg", action="append",
                    help="extra Settings override KEY=VALUE (repeatable)")
    ap.add_argument("--work-dir", default="/tmp/ladder")
    ap.add_argument("--log", default="/tmp/ladder_sweep.jsonl")
    args = ap.parse_args()

    from recommendit_tpu.utils.logging import setup_logging

    setup_logging("WARNING")
    weights = json.loads(args.weights)

    keys = ["ndcg@10", "recall@20", "mrr", "retrieval_only_ndcg@10",
            "retrieval_only_recall@20", "retrieval_only_mrr",
            "popularity_ndcg@10", "popularity_recall@20", "popularity_mrr"]
    reports = []
    for s in range(args.seed_base, args.seed_base + args.seeds):
        rep = run_one(args.name, weights, s, args)
        reports.append(rep)
        line = {"name": args.name, "seed": s, "weights": weights,
                **{k: round(rep.get(k, float("nan")), 4) for k in keys},
                **{k: round(v, 4) for k, v in rep.items()
                   if k.startswith("holdout_")},
                "seconds": rep["seconds"]}
        print(json.dumps(line), flush=True)
        with open(args.log, "a") as f:
            f.write(json.dumps(line) + "\n")

    agg = {k: float(np.nanmean([r.get(k, np.nan) for r in reports]))
           for k in keys}
    pop, ret, full = (agg["popularity_ndcg@10"],
                      agg["retrieval_only_ndcg@10"], agg["ndcg@10"])
    summary = {
        "name": args.name, "agg": True, "n_seeds": args.seeds,
        "weights": weights,
        **{k: round(v, 4) for k, v in agg.items()},
        "ret_over_pop": round(ret / max(pop, 1e-9), 3),
        "full_over_ret": round(full / max(ret, 1e-9), 3),
        "std_ndcg@10": round(float(np.nanstd(
            [r.get("ndcg@10", np.nan) for r in reports])), 4),
    }
    print(json.dumps(summary), flush=True)
    with open(args.log, "a") as f:
        f.write(json.dumps(summary) + "\n")


if __name__ == "__main__":
    main()
