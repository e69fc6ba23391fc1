"""Multi-seed joint-vs-plain CTR comparison (closes PARITY's single-seed
claim: 'joint beats plain CTR on AUC AND logloss').

For each seed: generate the Criteo-shaped synthetic log, train (a) the
plain DLRM CTR model and (b) the joint two-stage model (retrieval towers
sharing the stacked table, loss = BCE + lambda * click-weighted in-batch
softmax), evaluate AUC / logloss / retrieval Recall@K, and print the
mean +/- std table.

Usage:
  JAX_PLATFORMS=cpu PYTHONPATH=. \
    python scripts/ctr_variance.py --seeds 3 --examples 300000
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--examples", type=int, default=300_000)
    ap.add_argument("--users", type=int, default=20_000)
    ap.add_argument("--items", type=int, default=5_000)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--out", default="/tmp/ctr_variance.json")
    args = ap.parse_args()

    from recommendit_tpu.config import settings
    from recommendit_tpu.data.ctr import make_ctr_dataset
    from recommendit_tpu.training.train_ctr import CTRTrainer
    from recommendit_tpu.utils.logging import setup_logging

    setup_logging("WARNING")

    rows = []
    for seed in range(args.seeds):
        data = make_ctr_dataset(
            n_examples=args.examples, n_users=args.users,
            n_items=args.items, seed=seed,
        )
        cfg = settings.replace(
            SEED=seed,
            **({"CTR_EPOCHS": args.epochs} if args.epochs else {}),
        )
        for joint in (False, True):
            trainer = CTRTrainer(data, cfg=cfg, joint=joint,
                                 model_output_path=None)
            trainer.train()
            rep = trainer.evaluate()
            rep.update(seed=seed, joint=joint,
                       examples_per_s=round(trainer.examples_per_s))
            rows.append(rep)
            print(json.dumps(rep, default=float), flush=True)

    print("\n=== joint vs plain (n=%d seeds) ===" % args.seeds)
    agg = {}
    for joint in (False, True):
        sel = [r for r in rows if r["joint"] == joint]
        name = "joint" if joint else "plain"
        agg[name] = {}
        for key in ("auc", "logloss", "recall@10", "recall@50"):
            vals = np.array([r[key] for r in sel if key in r], float)
            if len(vals):
                agg[name][key] = {"mean": float(vals.mean()),
                                  "std": float(vals.std())}
                print(f"{name:<6} {key:<10} {vals.mean():.4f} ± {vals.std():.4f}")
    # per-seed paired wins (the claim is per-seed, not just on the mean)
    wins = {"auc": 0, "logloss": 0}
    for seed in range(args.seeds):
        p = next(r for r in rows if r["seed"] == seed and not r["joint"])
        j = next(r for r in rows if r["seed"] == seed and r["joint"])
        wins["auc"] += int(j["auc"] > p["auc"])
        wins["logloss"] += int(j["logloss"] < p["logloss"])
    print(f"joint wins AUC on {wins['auc']}/{args.seeds} seeds, "
          f"logloss on {wins['logloss']}/{args.seeds}")
    with open(args.out, "w") as f:
        json.dump({"rows": rows, "agg": agg, "wins": wins}, f, indent=2,
                  default=float)


if __name__ == "__main__":
    main()
