"""Benchmark harness — prints ONE JSON line for the driver.

Headline metric: retrieval queries/s at top-500 over an ML-1M-sized catalog
(3,952 items x dim 64), the reference's FAISS IVF workload
(/root/reference/README.md:42: 6 ms p50 → ~166.7 QPS single-stream).
Also measures BPR training examples/s/chip, large-corpus retrieval, and the
fused serving path; details go to stderr and bench_details.json.

Methodology note: every timed iteration's input depends on the previous
iteration's output (a tiny perturbation), so XLA cannot hoist any
iteration's work out of the timed loop. Timings are wall-clock over the
dependency chain, blocking only at the end (throughput) or per call
(latency). The run needs a GPU whose ``device_kind`` is in ``PEAKS``.
"""
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_RETRIEVAL_QPS = 1000.0 / 6.0  # reference 6ms p50 top-500

# Published peaks keyed by ``jax.devices()[0].device_kind``. Source: NVIDIA
# H100 Tensor Core GPU data sheet, SXM part, dense rates without sparsity,
# at the full 700 W power limit (a card set below it cannot hold its top
# clock under matmul-heavy load; the run prints the card's power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "fp32_tflops": 67.0,
        "hbm_gbps": 3350.0,
    },
}


def peaks_for(device_kind: str) -> dict:
    """Peak table row for ``device_kind``; an unknown device is an error,
    never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device_kind {device_kind!r}; add its "
            f"data-sheet row to bench.PEAKS (known: {sorted(PEAKS)})"
        ) from None


def speed_of_light(results, name, measured_ms, flops, hbm_bytes, peaks):
    """Attach roofline context: the floor time implied by the compute and
    HBM roofs for the declared FLOP/traffic model, which roof binds, and
    the fraction of that floor actually achieved ("floor %").

    The traffic model counts MANDATORY HBM bytes only (inputs that cannot
    stay resident + outputs); intermediates that XLA may or may not
    materialize are excluded, so the floor is a true lower bound. The
    compute roof is the bf16 tensor-core peak (optimistic for f32 inputs),
    so sol_*_pct is a conservative lower bound."""
    t_mem_ms = hbm_bytes / (peaks["hbm_gbps"] * 1e9) * 1e3
    t_cmp_ms = flops / (peaks["bf16_tflops"] * 1e12) * 1e3
    floor_ms = max(t_mem_ms, t_cmp_ms)
    results[f"sol_{name}_floor_ms"] = floor_ms
    results[f"sol_{name}_pct"] = round(100.0 * floor_ms / measured_ms, 1)
    results[f"sol_{name}_bound"] = "hbm" if t_mem_ms >= t_cmp_ms else "compute"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _chain_perturb(jnp, q0, out_vals):
    """New query batch that depends on the previous output (keeps the value
    distribution intact; forces real execution of every iteration)."""
    return q0 + 1e-6 * out_vals[:, :1]


def device_loop_time(jax, jnp, step, q0, *args, iters: int = 50,
                     rounds: int = 3):
    """Seconds per iteration of ``step(q, *args) -> (vals, ...)`` measured
    with the iteration chain INSIDE one jitted fori_loop: the median over
    ``rounds`` timed calls after one warm-up call. Returns that and the
    seconds of the warm-up call (compile included).

    Each iteration's input depends on the previous output, there is
    exactly ONE dispatch per timed round, and the returned scalar is
    fetched to host, which cannot complete before every chained
    iteration has executed. Arrays go in through ``args``, never through
    ``step``'s closure: a jitted closure constant is baked into the
    executable.
    """
    @jax.jit
    def run(q0, *args):
        def body(i, carry):
            q, acc = carry
            out = step(q, *args)
            v = out[0] if isinstance(out, (tuple, list)) else out
            return (q0 + 1e-6 * v[:, :1].astype(q0.dtype),
                    acc + v[0, 0].astype(jnp.float32))
        _, acc = jax.lax.fori_loop(0, iters, body, (q0, jnp.float32(0)))
        return acc

    t0 = time.perf_counter()
    acc = float(run(q0, *args))  # compile + warm
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(rounds):
        q0 = q0 + jnp.asarray(1e-6 * (acc % 1.0), q0.dtype)
        t0 = time.perf_counter()
        acc = float(run(q0, *args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / iters, first_s


def bench_retrieval(jnp, jax, peaks):
    from recommendit_tpu.ops.topk import mips_topk

    n_items, dim, k, batch = 3952, 64, 500, 256
    rng = np.random.default_rng(0)
    items = jnp.asarray(rng.normal(size=(n_items, dim)), jnp.float32)
    items = items / jnp.linalg.norm(items, axis=1, keepdims=True)
    q0 = jnp.asarray(rng.normal(size=(batch, dim)), jnp.float32)

    block = 2048
    dt_iter, _ = device_loop_time(
        jax, jnp, lambda q, it: mips_topk(q, it, k, block), q0, items
    )
    qps = batch / dt_iter

    # single-query latency, blocking per call, varied inputs (includes
    # the host dispatch — the client-observed latency)
    fn1 = jax.jit(lambda q, it: mips_topk(q, it, k, block))
    q1 = q0[:1]
    v, _ = fn1(q1, items)
    jax.block_until_ready(v)
    lat = []
    for _ in range(75):
        t1 = time.perf_counter()
        v, _ = fn1(q1, items)
        jax.block_until_ready(v)
        lat.append((time.perf_counter() - t1) * 1000)
        q1 = _chain_perturb(jnp, q0[:1], v)
    out = {
        "retrieval_qps_top500": qps,
        "retrieval_batch256_ms": dt_iter * 1000,
        "retrieval_single_query_p50_ms": float(np.percentile(lat, 50)),
        "retrieval_single_query_p99_ms": float(np.percentile(lat, 99)),
        "retrieval_single_query_min_ms": float(np.min(lat)),
    }
    # roofline: corpus + queries read, top-k values+indices written. The
    # tiny 1 MB corpus means this shape is overhead-bound by construction —
    # a low floor % here is expected, not a defect (see 1M rows for the
    # bandwidth-limited regime).
    speed_of_light(out, "retrieval_ml1m", dt_iter * 1000,
                   flops=2 * batch * n_items * dim,
                   hbm_bytes=4 * (n_items * dim + batch * dim
                                  + 2 * batch * k), peaks=peaks)
    return out


def bench_dispatch_rtt(jnp, jax):
    """Host→device dispatch round-trip (the latency floor for blocking
    single calls; throughput numbers are unaffected by it)."""
    f = jax.jit(lambda a, b: a + b)
    x = jnp.ones((8, 8))
    y = f(x, x)
    jax.block_until_ready(y)
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        y = f(x, y)  # varied input via chain
        jax.block_until_ready(y)
        lat.append((time.perf_counter() - t0) * 1000)
    return {"dispatch_rtt_p50_ms": float(np.percentile(lat, 50))}


def bench_retrieval_large(jnp, jax, peaks):
    """Scaling config: 1M-item corpus, dim 128 (beyond ML-1M scale)."""
    from recommendit_tpu.ops.topk import mips_topk

    n_items, dim, k, batch = 1_000_000, 128, 500, 256
    rng = np.random.default_rng(0)
    items = jnp.asarray(rng.normal(size=(n_items, dim)), jnp.float32)
    q0 = jnp.asarray(rng.normal(size=(batch, dim)), jnp.float32)
    block = 65536

    from recommendit_tpu.ops.topk import mips_topk_certified

    out = {}
    variants = {
        "exact": lambda q, it: mips_topk(q, it, k, block),
        # certified: verified two-pass fast path (recall-target prefilter +
        # exactness certificate), lax.cond escalation — recall 1.0 always
        "verified": lambda q, it: mips_topk_certified(q, it, k, block),
        "approx": lambda q, it: mips_topk(q, it, k, block, "approx"),
        "full_approx": lambda q, it: jax.lax.approx_max_k(
            jnp.dot(q, it.T, preferred_element_type=jnp.float32), k
        ),
    }
    for name, fn in variants.items():
        dt_iter, _ = device_loop_time(jax, jnp, fn, q0, items, iters=30)
        out[f"retrieval_1M_dim128_{name}_qps"] = batch / dt_iter
        out[f"retrieval_1M_dim128_{name}_batch_ms"] = dt_iter * 1000
        # mandatory traffic: 512 MB corpus read + queries + k out; the
        # scores intermediate (1 GB if materialized) is NOT mandatory —
        # closing the gap to this floor is exactly what fusing the
        # reduction into the matmul buys (docs/KERNELS.md)
        speed_of_light(out, f"retrieval_1M_{name}", dt_iter * 1000,
                       flops=2 * batch * n_items * dim,
                       hbm_bytes=4 * (n_items * dim + batch * dim
                                      + 2 * batch * k), peaks=peaks)

    # exactness spot check: exact mode must be element-identical to the
    # f64 numpy reference on this corpus
    from recommendit_tpu.ops.topk import mips_topk_numpy

    v, i = jax.jit(lambda q, it: mips_topk(q, it, k, block))(q0, items)
    items_np = np.asarray(items)
    vn, idxn = mips_topk_numpy(np.asarray(q0)[:8], items_np, k)
    out["retrieval_1M_exact_matches_numpy"] = bool(
        (np.asarray(i)[:8] == idxn).all()
    )
    vv, vi = mips_topk_certified(q0, items, k, block)
    out["retrieval_1M_verified_matches_numpy"] = bool(
        (np.asarray(vi)[:8] == idxn).all()
        and np.allclose(np.asarray(vv)[:8], vn, rtol=1e-5, atol=1e-5)
    )
    return out


def bench_retrieval_fused(jnp, jax, peaks):
    """``MIPSIndex(mode="fused", dtype="bfloat16")`` at 1M×128: the plain
    window-segment engine (window 64 at this size)."""
    from recommendit_tpu.models.retrieval import MIPSIndex

    n_items, dim, k = 1_000_000, 128, 500
    rng = np.random.default_rng(0)
    index = MIPSIndex(embedding_dim=dim, mode="fused", dtype="bfloat16")
    index.build(rng.normal(size=(n_items, dim)).astype(np.float32),
                np.arange(1, n_items + 1))
    search = index.make_device_searcher(k)

    out = {}
    for batch in (256, 1024):
        q0 = jnp.asarray(rng.normal(size=(batch, dim)), jnp.float32)
        dt_iter, first_s = device_loop_time(jax, jnp, search, q0,
                                            index.device_corpus, iters=20)
        out[f"retrieval_1M_fused_b{batch}_qps"] = batch / dt_iter
        out[f"retrieval_1M_fused_b{batch}_batch_ms"] = dt_iter * 1000
        out[f"retrieval_1M_fused_b{batch}_first_call_s"] = first_s
        speed_of_light(out, f"retrieval_1M_fused_b{batch}", dt_iter * 1000,
                       flops=2 * batch * n_items * dim,
                       hbm_bytes=2 * (n_items * dim) + 4 * (batch * dim
                                                            + 2 * batch * k),
                       peaks=peaks)
    return out


def bench_serve_e2e(jnp, jax, batch: int = 256, iters: int = 50,
                    prefix: str = "serve_e2e"):
    """Fused serving hot path: embed → top-500 of 3952 → assemble 50 feats →
    MLP rank → top-100, batched over ``batch`` users. ``batch=1`` measures
    the true single-request DEVICE time (the chained fori_loop cannot
    overlap requests), decomposing the blocking single-call latency into
    device compute vs host dispatch."""
    from recommendit_tpu.features.schema import assemble_packed_jnp
    from recommendit_tpu.models.ranker import init_mlp, mlp_score
    from recommendit_tpu.models.two_tower import init_params, user_tower
    from recommendit_tpu.ops.topk import fast_topk, mips_topk

    n_users, n_items, d, h = 6040, 3952, 64, 128
    n_cand, k_out = 500, 100
    rng = np.random.default_rng(0)
    params = init_params(jax.random.PRNGKey(0), n_users, n_items, d, h)
    item_embs = jnp.asarray(rng.normal(size=(n_items, d)), jnp.float32)
    user_packed = jnp.asarray(rng.normal(size=(n_users + 1, 24)), jnp.float32)
    # production layout: gather-padded rows (features/schema.py)
    item_packed = jnp.pad(
        jnp.asarray(rng.normal(size=(n_items + 1, 23)), jnp.float32),
        ((0, 0), (0, 41)))
    rparams = init_mlp(jax.random.PRNGKey(1), 50, (128, 64))
    ids_dev = jnp.arange(1, n_items + 1, dtype=jnp.int32)

    @jax.jit
    def serve_batch(user_ids):
        q = user_tower(params, user_ids)
        rvals, pos = mips_topk(q, item_embs, n_cand, 2048)
        cand = jnp.take(ids_dev, pos)
        u_vecs = jnp.take(user_packed, user_ids, axis=0)
        feats = jax.vmap(
            lambda uv, ci: assemble_packed_jnp(
                uv, jnp.take(item_packed, ci, axis=0)
            )
        )(u_vecs, cand)
        scores = mlp_score(rparams, feats)
        top_scores, sel = fast_topk(scores, k_out)
        return jnp.take_along_axis(cand, sel, axis=1), top_scores

    u0 = rng.integers(1, n_users, size=batch)
    uids0 = jnp.asarray(u0, jnp.int32)

    @jax.jit
    def run(uids0):
        def body(i, carry):
            uids, acc = carry
            cand_ids, scores = serve_batch(uids)
            # id-space perturbation dependent on previous output
            return ((uids0 + cand_ids[:, 0] % 2).astype(jnp.int32),
                    acc + scores[0, 0])
        _, acc = jax.lax.fori_loop(0, iters, body, (uids0, jnp.float32(0)))
        return acc

    acc = float(run(uids0))
    times = []
    for _ in range(3):
        # each round's user ids derive from the previous round's scalar
        uids0 = ((uids0 + jnp.int32(1 + int(abs(acc)) % 97))
                 % (n_users - 1) + 1).astype(jnp.int32)
        t0 = time.perf_counter()
        acc = float(run(uids0))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times)) / iters
    return {
        f"{prefix}_users_per_s": batch / dt,
        f"{prefix}_batch{batch}_ms": dt * 1000,
    }


def bench_serve_e2e_large(jnp, jax, peaks, batch: int = 256,
                          iters: int = 30, prefix: str = "serve_e2e_1M",
                          retrieval: str = "approx"):
    """Fused serving at production corpus scale: embed → top-500 of 1M×128
    through ``MIPSIndex`` (``retrieval`` = its mode: "approx" over an f32
    corpus, "fused" over a bf16 corpus) → assemble 50 feats → MLP rank →
    top-100, batched over ``batch`` users. The packed item table and the
    corpus are passed as arguments."""
    from recommendit_tpu.features.schema import assemble_packed_jnp
    from recommendit_tpu.models.ranker import init_mlp, mlp_score
    from recommendit_tpu.models.retrieval import MIPSIndex
    from recommendit_tpu.models.two_tower import init_params, user_tower
    from recommendit_tpu.ops.topk import fast_topk

    n_users, n_items, d, h = 6040, 1_000_000, 128, 128
    n_cand, k_out = 500, 100
    rng = np.random.default_rng(0)
    params = init_params(jax.random.PRNGKey(0), n_users, 1, d, h)
    index = MIPSIndex(
        embedding_dim=d, block_size=65536, mode=retrieval,
        dtype="bfloat16" if retrieval == "fused" else "float32")
    index.build(rng.normal(size=(n_items, d)).astype(np.float32),
                np.arange(1, n_items + 1))
    search = index.make_device_searcher(n_cand)
    user_packed = jnp.asarray(rng.normal(size=(n_users + 1, 24)), jnp.float32)
    item_packed = jnp.pad(jnp.asarray(
        rng.normal(size=(n_items + 1, 23)), jnp.float32
    ), ((0, 0), (0, 41)))  # gather-padded rows (features/schema.py)
    rparams = init_mlp(jax.random.PRNGKey(1), 50, (128, 64))

    def serve_batch(user_ids, item_packed, corpus):
        q = user_tower(params, user_ids)
        rvals, pos = search(q, corpus)
        cand = pos.astype(jnp.int32) + 1  # item ids are 1-based rows
        u_vecs = jnp.take(user_packed, user_ids, axis=0)
        feats = jax.vmap(
            lambda uv, ci: assemble_packed_jnp(
                uv, jnp.take(item_packed, ci, axis=0)
            )
        )(u_vecs, cand)
        scores = mlp_score(rparams, feats)
        top_scores, sel = fast_topk(scores, k_out)
        return jnp.take_along_axis(cand, sel, axis=1), top_scores

    u0 = rng.integers(1, n_users, size=batch)
    uids0 = jnp.asarray(u0, jnp.int32)

    @jax.jit
    def run(uids0, item_packed, corpus):
        def body(i, carry):
            uids, acc = carry
            cand_ids, scores = serve_batch(uids, item_packed, corpus)
            return ((uids0 + cand_ids[:, 0] % 2).astype(jnp.int32),
                    acc + scores[0, 0])
        _, acc = jax.lax.fori_loop(0, iters, body, (uids0, jnp.float32(0)))
        return acc

    corpus = index.device_corpus
    t0 = time.perf_counter()
    acc = float(run(uids0, item_packed, corpus))  # compile + warm
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        # chained rounds — see bench_serve_e2e
        uids0 = ((uids0 + jnp.int32(1 + int(abs(acc)) % 97))
                 % (n_users - 1) + 1).astype(jnp.int32)
        t0 = time.perf_counter()
        acc = float(run(uids0, item_packed, corpus))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times)) / iters
    out = {
        f"{prefix}_users_per_s": batch / dt,
        f"{prefix}_batch{batch}_ms": dt * 1000,
        f"{prefix}_first_call_s": first_s,
    }
    # mandatory traffic: corpus scan + packed-feature gather for the 500
    # candidates per user; ranker MLP flops on 50 features
    bytes_per_coord = 2 if retrieval == "fused" else 4
    mlp_flops = 2 * batch * n_cand * (50 * 128 + 128 * 64 + 64)
    speed_of_light(out, prefix.replace("serve_e2e", "serve"), dt * 1000,
                   flops=2 * batch * n_items * d + mlp_flops,
                   hbm_bytes=bytes_per_coord * n_items * d
                   + 4 * batch * n_cand * (23 + 1), peaks=peaks)
    return out


def bench_bpr_train(jnp, jax, peaks):
    import functools

    import optax

    from recommendit_tpu.models.two_tower import (
        init_params,
        item_tower,
        user_tower,
    )
    from recommendit_tpu.ops.bpr import in_batch_bpr_loss

    n_users, n_items, d, h, b = 6040, 3952, 64, 128, 1024
    params = init_params(jax.random.PRNGKey(0), n_users, n_items, d, h)
    rng = np.random.default_rng(0)
    genre_table = jnp.asarray(
        (rng.random((n_items + 1, 18)) < 0.2).astype(np.float32)
    )
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))
    opt_state = tx.init(params)

    steps_per_call = 50  # scan over steps inside one jit, like the trainer

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def run_steps(params, opt_state, u_b, i_b, key):
        def step(carry, batch):
            params, opt_state, key = carry
            key, sub = jax.random.split(key)
            u, i = batch

            def loss_fn(p):
                ue = user_tower(p, u, 0.2, sub)
                ie = item_tower(p, i, jnp.take(genre_table, i, axis=0),
                                0.2, sub)
                return in_batch_bpr_loss(ue, ie)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state, key), loss

        (params, opt_state, key), losses = jax.lax.scan(
            step, (params, opt_state, key), (u_b, i_b)
        )
        return params, opt_state, losses.mean()

    u_b = jnp.asarray(
        rng.integers(1, n_users, size=(steps_per_call, b)), jnp.int32
    )
    i_b = jnp.asarray(
        rng.integers(1, n_items, size=(steps_per_call, b)), jnp.int32
    )
    key = jax.random.PRNGKey(0)
    # Per-call timing with a median: donated-buffer layout changes cause a
    # couple of recompiles in the first calls; the median is steady state.
    # (params evolve every call, so there is no same-input caching here.)
    per_call = []
    for t in range(8):
        t0 = time.perf_counter()
        params, opt_state, loss = run_steps(params, opt_state, u_b, i_b,
                                            jax.random.fold_in(key, t))
        jax.block_until_ready(loss)
        per_call.append(time.perf_counter() - t0)
    dt = float(np.median(per_call))
    out = {
        "bpr_examples_per_s_per_chip": steps_per_call * b / dt,
        "bpr_step_ms": dt / steps_per_call * 1000,
    }
    # FLOP model: both tower MLPs fwd + BxB logits, x3 for backward;
    # traffic model: adamw touches 6 floats per parameter (read+write of
    # p/m/v) — at ML-1M table sizes the step is overhead-bound, which the
    # low floor % makes visible
    n_params = sum(int(np.prod(x.shape))
                   for x in jax.tree_util.tree_leaves(params))
    step_flops = 3 * (2 * 2 * b * 2 * d * h + 2 * b * b * d)
    step_bytes = 6 * 4 * n_params + 4 * 2 * b * (d + 18)
    speed_of_light(out, "bpr_step", dt / steps_per_call * 1000,
                   step_flops, step_bytes, peaks=peaks)
    return out


def main():
    from recommendit_tpu.utils.runtime import (
        enable_compile_cache,
        gpu_name_and_power_limit,
    )

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench needs a GPU; JAX found {dev.platform!r}")
        sys.exit(1)
    peaks = peaks_for(dev.device_kind)
    card = gpu_name_and_power_limit()
    log(f"bench device: {dev.device_kind} x{len(jax.devices())} ({card})")

    results = {"platform": dev.platform, "device_kind": dev.device_kind,
               "device_count": len(jax.devices()), "card": card}
    results.update(bench_dispatch_rtt(jnp, jax))
    log(f"dispatch rtt p50: {results['dispatch_rtt_p50_ms']:.2f} ms")
    results.update(bench_retrieval(jnp, jax, peaks))
    log(f"retrieval: {results['retrieval_qps_top500']:.0f} qps "
        f"(batch256 {results['retrieval_batch256_ms']:.2f} ms, "
        f"1-query p50 "
        f"{results['retrieval_single_query_p50_ms']:.2f} ms, "
        f"floor {results['sol_retrieval_ml1m_pct']}% of "
        f"{results['sol_retrieval_ml1m_bound']} roof)")
    results.update(bench_bpr_train(jnp, jax, peaks))
    log(f"bpr train: {results['bpr_examples_per_s_per_chip']:.0f} ex/s "
        f"({results['bpr_step_ms']:.2f} ms/step @1024, "
        f"floor {results['sol_bpr_step_pct']}%)")
    results.update(bench_retrieval_large(jnp, jax, peaks))
    log(f"retrieval 1M x 128: exact "
        f"{results['retrieval_1M_dim128_exact_qps']:.0f} qps "
        f"({results['sol_retrieval_1M_exact_pct']}% of hbm roof), verified "
        f"{results['retrieval_1M_dim128_verified_qps']:.0f}, approx "
        f"{results['retrieval_1M_dim128_approx_qps']:.0f} "
        f"({results['sol_retrieval_1M_approx_pct']}%), full+approx "
        f"{results['retrieval_1M_dim128_full_approx_qps']:.0f}")
    results.update(bench_retrieval_fused(jnp, jax, peaks))
    log(f"retrieval 1M fused (bf16 window engine): "
        f"b256 {results['retrieval_1M_fused_b256_qps']:.0f} qps, "
        f"b1024 {results['retrieval_1M_fused_b1024_qps']:.0f} qps "
        f"({results['sol_retrieval_1M_fused_b1024_pct']}% of "
        f"{results['sol_retrieval_1M_fused_b1024_bound']} roof; first call "
        f"incl. compile {results['retrieval_1M_fused_b256_first_call_s']:.2f}"
        f"/{results['retrieval_1M_fused_b1024_first_call_s']:.2f} s)")
    results.update(bench_serve_e2e(jnp, jax))
    log(f"serve e2e: {results['serve_e2e_users_per_s']:.0f} users/s "
        f"(batch256 {results['serve_e2e_batch256_ms']:.2f} ms)")
    # single-request device time: batch=1 through the SAME fused hot path.
    # Blocking request latency ≈ this + dispatch RTT — decomposing the
    # number the reference publishes as e2e p50 (README.md:44, 18 ms)
    results.update(bench_serve_e2e(jnp, jax, batch=1, iters=200,
                                   prefix="serve_single"))
    log(f"single request: device "
        f"{results['serve_single_batch1_ms']:.3f} ms + dispatch p50 "
        f"{results['dispatch_rtt_p50_ms']:.2f} ms "
        f"(reference e2e p50: 18 ms)")
    results.update(bench_serve_e2e_large(jnp, jax, peaks))
    log(f"serve e2e 1M x 128: "
        f"{results['serve_e2e_1M_users_per_s']:.0f} users/s "
        f"(batch256 {results['serve_e2e_1M_batch256_ms']:.2f} ms, "
        f"floor {results['sol_serve_1M_pct']}%)")
    results.update(bench_serve_e2e_large(
        jnp, jax, peaks, prefix="serve_e2e_1M_fused", retrieval="fused"))
    log(f"serve e2e 1M fused retrieval: "
        f"{results['serve_e2e_1M_fused_users_per_s']:.0f} users/s "
        f"(batch256 {results['serve_e2e_1M_fused_batch256_ms']:.2f} ms, "
        f"floor {results['sol_serve_1M_fused_pct']}%, first call incl. "
        f"compile {results['serve_e2e_1M_fused_first_call_s']:.2f} s)")
    results.update(bench_serve_e2e_large(
        jnp, jax, peaks, batch=1, iters=50, prefix="serve_single_1M"))
    log(f"single request at 1M corpus: device "
        f"{results['serve_single_1M_batch1_ms']:.3f} ms + dispatch")

    Path("bench_details.json").write_text(json.dumps(results, indent=2))

    qps = results["retrieval_qps_top500"]
    print(json.dumps({
        "metric": "retrieval_qps_top500_ml1m",
        "value": round(qps, 1),
        "unit": "queries/s",
        "vs_baseline": round(qps / BASELINE_RETRIEVAL_QPS, 2),
    }))


if __name__ == "__main__":
    main()
