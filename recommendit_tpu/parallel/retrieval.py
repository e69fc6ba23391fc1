"""Sharded-corpus MIPS retrieval.

The item corpus is row-sharded over the 'model' axis; each shard runs the
blocked streaming top-k (``recommendit_tpu.ops.topk``) over its rows, then
the per-shard candidate lists (k each) are combined with one all-gather and
a final exact top-k merge. This is the collective form of the reference's
single-index FAISS search (``src/models/faiss_index.py:113``) — total work
is identical to the single-device exact scan, split N/S rows per chip, with
one (Q, S·k) all-gather on ICI instead of IVF probes.

A bandwidth-shaped alternative for very large k — the ring variant
(``ppermute`` pass with running merge, same pattern as ring attention over
KV blocks) — is provided for meshes where the all-gather buffer would
dominate: it keeps only (Q, k) in flight per step at the cost of S-1 steps.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from recommendit_tpu.ops.topk import canonical_tie_order, fast_topk, mips_topk
from recommendit_tpu.parallel.mesh import MODEL_AXIS


def _local_topk(queries, items_shard, k: int, block_size: int, axis: str):
    rows = items_shard.shape[0]
    k_local = min(k, rows)
    vals, idx = mips_topk(queries, items_shard, k_local, block_size)
    if k_local < k:  # pad so every shard contributes k candidates
        pad = k - k_local
        vals = jnp.pad(vals, ((0, 0), (0, pad)), constant_values=-jnp.inf)
        idx = jnp.pad(idx, ((0, 0), (0, pad)))
    gidx = idx + jax.lax.axis_index(axis) * rows
    return vals, gidx


def _allgather_merge(queries, items_shard, k, block_size, axis, canonical):
    vals, gidx = _local_topk(queries, items_shard, k, block_size, axis)
    all_vals = jax.lax.all_gather(vals, axis, axis=1, tiled=True)   # (Q, S*k)
    all_idx = jax.lax.all_gather(gidx, axis, axis=1, tiled=True)
    mvals, sel = fast_topk(all_vals, k)
    midx = jnp.take_along_axis(all_idx, sel, axis=1)
    # canonical=True: score-tied items across shards come back in the same
    # (value desc, index asc) order as mips_topk(canonical=True) — real
    # corpora produce exact f32 score ties (ops/topk.py
    # canonical_tie_order docstring); off by default: it is an extra sort
    return canonical_tie_order(mvals, midx) if canonical else (mvals, midx)


def sharded_mips_topk(
    queries: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int,
    mesh: Mesh,
    block_size: int = 4096,
    axis: str = MODEL_AXIS,
    canonical: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact top-k over a corpus row-sharded on ``axis``.

    Args:
        queries: (Q, D), replicated.
        item_embs: (N, D), shardable as P(axis, None); N must divide the
            axis size.
        canonical: deterministic (value desc, index asc) tie order,
            element-identical to ``mips_topk(canonical=True)`` — see
            ``ops.topk.canonical_tie_order`` for when ties actually occur
            and why this is opt-in.
    Returns replicated (values (Q, k), global indices (Q, k)).
    """
    fn = shard_map(
        functools.partial(
            _allgather_merge, k=k, block_size=block_size, axis=axis,
            canonical=canonical,
        ),
        mesh=mesh,
        in_specs=(P(), P(axis, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(queries, item_embs)


def _ring_merge(queries, items_shard, k, block_size, axis, canonical):
    """Ring variant: pass each shard's candidate block around the ring,
    merging into a running top-k — (Q, k) in flight per step."""
    s = jax.lax.axis_size(axis)
    vals, gidx = _local_topk(queries, items_shard, k, block_size, axis)
    perm = [(i, (i + 1) % s) for i in range(s)]

    def step(carry, _):
        run_v, run_i, buf_v, buf_i = carry
        buf_v = jax.lax.ppermute(buf_v, axis, perm)
        buf_i = jax.lax.ppermute(buf_i, axis, perm)
        cat_v = jnp.concatenate([run_v, buf_v], axis=1)
        cat_i = jnp.concatenate([run_i, buf_i], axis=1)
        mv, sel = fast_topk(cat_v, k)
        mi = jnp.take_along_axis(cat_i, sel, axis=1)
        return (mv, mi, buf_v, buf_i), None

    (run_v, run_i, _, _), _ = jax.lax.scan(
        step, (vals, gidx, vals, gidx), None, length=s - 1
    )
    # every member of a tie-group whose value beats the global k-th value
    # survives each running 2k-wide merge regardless of tie order, so
    # canonicalizing the FINAL list is sufficient for element-identity
    # with the single-device path (k-th-score ties excepted — values are
    # identical there)
    return canonical_tie_order(run_v, run_i) if canonical else (run_v, run_i)


def sharded_mips_topk_ring(
    queries: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int,
    mesh: Mesh,
    block_size: int = 4096,
    axis: str = MODEL_AXIS,
    canonical: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Ring-merge form of :func:`sharded_mips_topk` (same results)."""
    fn = shard_map(
        functools.partial(_ring_merge, k=k, block_size=block_size, axis=axis,
                          canonical=canonical),
        mesh=mesh,
        in_specs=(P(), P(axis, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(queries, item_embs)
