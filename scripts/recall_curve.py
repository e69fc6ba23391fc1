"""Recall vs QPS curves for the non-exact retrieval modes.

The reference exposes IVF ``n_lists``/``n_probe`` as its recall/speed knob
(``/root/reference/src/models/faiss_index.py:68-74,113``; ``config.py:
22-23``) but publishes no curve. Here the knobs are ``recall_target`` (the
``approx_max_k`` contract) and the corpus dtype (f32 / bf16 / int8); this
script MEASURES recall@k against the exact path and QPS at each setting on
the same corpus, replacing asserted recall claims with data.

Kept separate from bench.py on purpose: each setting is one more XLA
compile.

Usage (on the GPU):
  python scripts/recall_curve.py [--n-items 1000000] [--dim 128] [--k 500] \
      [--out recall_curve.json]
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
    ap.add_argument("--n-items", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--block", type=int, default=65536)
    ap.add_argument("--recall-targets", default="0.80,0.90,0.95,0.99")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default="recall_curve.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import device_loop_time, log
    from recommendit_tpu.ops.quantize import quantize_int8_jnp
    from recommendit_tpu.ops.topk import (
        fast_topk,
        mips_topk,
        mips_topk_certified,
        mips_topk_int8,
    )

    n, d, k, b = args.n_items, args.dim, args.k, args.batch
    rng = np.random.default_rng(0)
    # normalized tower-like corpus: recall numbers must reflect the serving
    # distribution (cosine scores in a narrow band), not easy random blobs
    items_np = rng.normal(size=(n, d)).astype(np.float32)
    items_np /= np.linalg.norm(items_np, axis=1, keepdims=True)
    items = jnp.asarray(items_np)
    q0 = rng.normal(size=(b, d)).astype(np.float32)
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    q0 = jnp.asarray(q0)

    log(f"platform: {jax.devices()[0].platform}; corpus {n}x{d}, k={k}")

    # ground truth from the exact device path (element-identical to f64
    # numpy — asserted in bench.py's run; recomputing f64 numpy at 1M x 128
    # here would dominate the runtime)
    exact_fn = lambda q, it: mips_topk(q, it, k, args.block)  # noqa: E731
    tv, ti = jax.jit(exact_fn)(q0, items)
    truth = np.asarray(ti)
    rows = []

    def measure(name, fn, operands=None):
        """fn(q, *operands) -> (vals, idx); operands default to (items,)."""
        operands = (items,) if operands is None else operands
        t0 = time.time()
        vals, idx = jax.jit(fn)(q0, *operands)
        recall = float(
            np.mean([
                len(set(np.asarray(idx)[i].tolist())
                    & set(truth[i].tolist())) / k
                for i in range(b)
            ])
        )
        dt = device_loop_time(jax, jnp, fn, q0, *operands,
                              iters=args.iters)
        row = {
            "mode": name,
            "recall@k": round(recall, 5),
            "qps": round(b / dt, 1),
            "batch_ms": round(dt * 1000, 3),
            "setup_s": round(time.time() - t0, 1),
        }
        rows.append(row)
        log(json.dumps(row))

    # exact + certified-exact anchors
    measure("exact", exact_fn)
    measure("verified", lambda q, it: mips_topk_certified(q, it, k,
                                                          args.block))

    # recall-target curve (approx_max_k contract on the full score row)
    for rt in [float(x) for x in args.recall_targets.split(",")]:
        measure(
            f"approx_rt{rt}",
            lambda q, it, _rt=rt: fast_topk(
                jnp.dot(q, it.T, preferred_element_type=jnp.float32), k, _rt
            ),
        )

    # int8 corpus (quarter HBM traffic; stochastic-rounding quantization)
    items_i8, scales = quantize_int8_jnp(items, jax.random.PRNGKey(0))
    measure(
        "int8_exact",
        lambda q, it_i8, sc: mips_topk_int8(q, it_i8, sc, k, args.block),
        operands=(items_i8, scales),
    )

    out = {
        "n_items": n, "dim": d, "k": k, "batch": b,
        "platform": jax.devices()[0].platform,
        "rows": rows,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    log(f"written -> {args.out}")
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
