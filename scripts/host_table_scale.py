"""Host-table (>HBM) training scale runs — BASELINE configs #3/#4 at real
row counts (VERDICT round-1 item #3).

Unlike scale_smoke.py (which validates the SHARDED in-HBM step at scaled
rows), this drives the actual ``HostTableEmbeddingTrainer`` end-to-end:
tables in host RAM (or memmap), only batch rows on the device. The
web100m config's user table (100M x 128 f32 = 51.2 GB) exceeds any single
chip's HBM — the point of the driver.

Usage (CPU backend shown; drop the env overrides on a real chip):
  JAX_PLATFORMS=cpu PYTHONPATH=. \
      python scripts/host_table_scale.py --config ml25m --mode both
  ... --config web100m --ratings 2000000 --epochs 1
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CONFIGS = {
    # name: (n_users, n_items, dim, hidden, batch)
    "ml1m": (6_040, 3_952, 64, 128, 1024),
    "ml25m": (162_541, 62_423, 256, 512, 2048),
    "web100m": (100_000_000, 10_000_000, 128, 256, 4096),
}


def sparse_synthetic(n_users: int, n_items: int, n_ratings: int, seed: int):
    """MovieLensData whose id RANGE spans the full table but whose rating
    count is the training-stream length — table scale and stream length
    are independent knobs (a real 100M-user log would also touch a tiny
    fraction of users per training window)."""
    import numpy as np
    import pandas as pd

    from recommendit_tpu.data.movielens import MovieLensData

    rng = np.random.default_rng(seed)
    # zipf-ish skew on items, uniform users; pin the max ids so the table
    # spans [0, n] regardless of sampling
    u = rng.integers(1, n_users + 1, size=n_ratings)
    i = (n_items * rng.random(size=n_ratings) ** 3).astype(np.int64) + 1
    u[0], i[0] = n_users, n_items
    ratings = pd.DataFrame({
        "user_id": u, "item_id": i,
        "rating": rng.integers(4, 6, size=n_ratings),  # all positives
        "timestamp": pd.to_datetime(
            rng.integers(9e8, 1e9, size=n_ratings), unit="s"
        ),
    })
    users = pd.DataFrame({
        "user_id": [n_users], "gender": ["F"], "age": [25],
        "occupation": [0], "zip_code": ["00000"],
    })
    movies = pd.DataFrame({
        "item_id": [n_items], "title": ["x (1999)"], "genres": ["Drama"],
    })
    return MovieLensData(ratings=ratings, users=users, movies=movies)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=CONFIGS, default="ml25m")
    ap.add_argument("--mode", choices=["host", "hbm", "both"], default="host")
    ap.add_argument("--ratings", type=int, default=1_000_000)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=0, help="override batch")
    ap.add_argument("--dim", type=int, default=0, help="override dim")
    ap.add_argument("--memmap-dir", default="", help="disk-backed tables")
    ap.add_argument("--prefetch", type=int, default=2)
    args = ap.parse_args()

    import jax
    import numpy as np

    from recommendit_tpu.config import Settings

    n_users, n_items, dim, hidden, batch = CONFIGS[args.config]
    if args.batch:
        batch = args.batch
    if args.dim:
        dim = args.dim
    platform = jax.devices()[0].platform
    table_gb = (n_users + n_items + 2) * dim * 4 / 2**30
    print(f"config={args.config} users={n_users} items={n_items} dim={dim} "
          f"hidden={hidden} batch={batch} ratings={args.ratings} "
          f"tables={table_gb:.1f} GiB platform={platform}", flush=True)

    t0 = time.time()
    data = sparse_synthetic(n_users, n_items, args.ratings, seed=0)
    print(f"synthetic stream built in {time.time() - t0:.1f}s", flush=True)

    cfg = Settings(
        EMBEDDING_DIM=dim, HIDDEN_DIM=hidden, BATCH_SIZE=batch,
        TRAIN_EPOCHS=args.epochs, LOSS_MODE="softmax", DROPOUT=0.0,
        HOST_TABLE=True, HOST_TABLE_PREFETCH=args.prefetch,
        HOST_TABLE_DIR=args.memmap_dir,
        EMBEDDING_MODEL_PATH="",  # don't serialize a 50 GB model
        TRAIN_JIT_SCOPE="step",
    )
    out = {"config": args.config, "platform": platform,
           "table_gib": round(table_gb, 2), "batch": batch, "dim": dim}

    if args.mode in ("host", "both"):
        from recommendit_tpu.training.host_train import (
            HostTableEmbeddingTrainer,
        )

        t0 = time.time()
        tr = HostTableEmbeddingTrainer(data, cfg, model_output_path="")
        print(f"tables allocated+initialized in {time.time() - t0:.1f}s",
              flush=True)
        model = tr.train()
        del model
        losses = [h["loss"] for h in tr.history]
        # steady-state ex/s: skip epoch 1 (compile) when there is one
        steady = tr.history[1:] or tr.history
        out["host_ex_per_s"] = round(
            float(np.mean([h["examples_per_s"] for h in steady]))
        )
        out["host_losses"] = [round(x, 4) for x in losses]

    if args.mode in ("hbm", "both"):
        from recommendit_tpu.training.train_embeddings import EmbeddingTrainer

        cfg2 = cfg.replace(HOST_TABLE=False)
        tr = EmbeddingTrainer(data, cfg2, model_output_path="")
        tr.train()
        steady = tr.history[1:] or tr.history
        out["hbm_ex_per_s"] = round(
            float(np.mean([h["examples_per_s"] for h in steady]))
        )
        out["hbm_losses"] = [round(h["loss"], 4) for h in tr.history]

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
