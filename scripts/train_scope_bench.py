"""Realized two-tower training throughput vs TRAIN_JIT_SCOPE.

Measures what the trainer actually delivers end-to-end per epoch (host
batch sampling + device compute + readback), not the bare kernel step —
the gap between bench.py's chained-scan kernel number and this one is the
dispatch overhead each scope amortizes differently:

- 'step':  one dispatch per batch (~1k dispatches/epoch).
- 'chunk': one dispatch per TRAIN_CHUNK_BATCHES (default 32) batches via a
           jitted lax.scan — a smaller XLA program than the epoch scan.
- 'epoch': whole-epoch scan (the default).

Usage (on the GPU):
  python scripts/train_scope_bench.py chunk 5
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    scope = sys.argv[1] if len(sys.argv) > 1 else "chunk"
    epochs = int(sys.argv[2]) if len(sys.argv) > 2 else 5

    import jax

    from recommendit_tpu.config import Settings
    from recommendit_tpu.data.synthetic import make_synthetic_movielens
    from recommendit_tpu.training.train_embeddings import EmbeddingTrainer

    print("platform:", jax.devices()[0].platform, flush=True)
    # ML-1M shapes — same corpus scale as bench.py's kernel number
    data = make_synthetic_movielens(
        n_users=6040, n_items=3952, n_ratings=1_000_000, seed=0
    )
    cfg = Settings(TRAIN_JIT_SCOPE=scope, TRAIN_EPOCHS=epochs,
                   EMBEDDING_MODEL_PATH="")
    tr = EmbeddingTrainer(data, cfg=cfg, model_output_path="")
    t0 = time.time()
    tr.train(epochs=epochs)
    steady = [h["examples_per_s"] for h in tr.history[1:]]
    print(json.dumps({
        "scope": scope,
        "epochs": epochs,
        "ex_s_epoch1_incl_compile": round(tr.history[0]["examples_per_s"]),
        "ex_s_steady_mean": round(float(np.mean(steady))),
        "ex_s_steady_max": round(float(np.max(steady))),
        "total_s": round(time.time() - t0, 1),
    }), flush=True)


if __name__ == "__main__":
    main()
