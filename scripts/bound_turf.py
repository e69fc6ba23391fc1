"""Bound-certificate home turf measurement (VERDICT r3 #7).

`method='bound'` exists because the count certificate pays a SECOND
full-corpus pass at precision=HIGHEST (~6x matmul cost), while the bound
proof rides the single bf16 pass it already made. Its claimed home turf
is high-d, where the HIGHEST-precision scan dominates — this script
measures exact / count-verified / bound-verified at d in {128, 512, 1024}
on the same normalized corpus, one process, chained device loops.

Usage (on the GPU):
    python scripts/bound_turf.py --out bound_turf.json
"""
import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--dims", type=int, nargs="+", default=[128, 512, 1024])
    ap.add_argument("--q", type=int, default=256)
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--m", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="bound_turf.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from recommendit_tpu.ops.topk import (
        mips_topk,
        mips_topk_bound_verified,
        mips_topk_verified,
    )

    def timeit(fn, q0, items, iters):
        @jax.jit
        def run(qq, it):
            def body(_, carry):
                qq, acc = carry
                out = fn(qq, it)
                vv = out[0]
                return (qq + 1e-6 * vv[:, :1], acc + vv[0, 0])
            _, acc = jax.lax.fori_loop(0, iters, body, (qq, jnp.float32(0)))
            return acc
        acc = float(run(q0, items))
        best = 1e9
        for _ in range(3):
            q0 = q0 + jnp.float32(1e-6 * (acc % 1.0))
            t0 = time.perf_counter()
            acc = float(run(q0, items))
            best = min(best, time.perf_counter() - t0)
        return best / iters * 1000

    rows = []
    rng = np.random.default_rng(0)
    for d in args.dims:
        # keep the corpus slab ~constant bytes across dims
        n = args.n * 128 // d
        items_np = rng.normal(size=(n, d)).astype(np.float32)
        items_np /= np.linalg.norm(items_np, axis=1, keepdims=True)
        items = jnp.asarray(items_np)
        q0 = jnp.asarray(rng.normal(size=(args.q, d)), np.float32)
        q0 = q0 / jnp.linalg.norm(q0, axis=1, keepdims=True)
        jax.block_until_ready(items)

        variants = {
            "exact": lambda qq, it: mips_topk(qq, it, args.k, 65536),
            "count_verified": lambda qq, it: mips_topk_verified(
                qq, it, args.k, 65536),
            "bound_verified": lambda qq, it: mips_topk_bound_verified(
                qq, it, args.k, args.m),
        }
        for name, fn in variants.items():
            ms = timeit(fn, q0, items, args.iters)
            row = {"dim": d, "n": n, "variant": name,
                   "batch_ms": round(ms, 2),
                   "qps": round(args.q / (ms / 1000), 1)}
            if name.endswith("verified"):
                out = fn(q0, items)
                row["certified_frac"] = float(jnp.mean(
                    out[2].astype(jnp.float32)))
            rows.append(row)
            print(json.dumps(row), flush=True)
        del items

    with open(args.out, "w") as f:
        json.dump({"q": args.q, "k": args.k, "m": args.m,
                   "platform": jax.devices()[0].platform, "rows": rows}, f,
                  indent=1)


if __name__ == "__main__":
    main()
