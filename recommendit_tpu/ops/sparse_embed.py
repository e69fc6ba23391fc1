"""Sparse embedding-table updates — the CTR training hot path.

Naive autodiff through ``jnp.take(table, ids)`` materializes a DENSE
table-shaped gradient via one giant scatter-add (B x n_fields indices) and
then runs the dense optimizer over every row (at a 1.1M-row x 32 table and
batch 8192: 213k scattered indices + dense adam moments over every row).

This module replaces that with the production CTR recipe:

1. **Rows boundary**: gather rows first, differentiate w.r.t. the GATHERED
   rows (B, F, D) — the dense table gradient never exists.
2. **Mixed per-field update** (:func:`sparse_table_update`):
   - small-vocab fields (vocab <= threshold): grad slice via a one-hot
     matmul ``one_hot(ids_f).T @ g_f`` — pure matmul work, no scatter — and a
     dense in-place slice update (the slice is tiny).
   - large-vocab fields: a scatter-add of only that field's B indices.
3. **Row-wise adagrad** (one accumulator scalar per row) instead of dense
   adam moments — the standard sparse-embedding optimizer; no O(table)
   state traffic per step.

Duplicate-id semantics (defined, tested): the weight delta for a row hit
k times in one batch is ``-scale * (g_1 + ... + g_k)`` in both paths —
identical to dedup-then-update. The adagrad ACCUMULATOR differs by path:
small fields add ``mean((Σg)²)`` (summed-gradient form, what a dedup
implementation produces), large fields add ``Σ mean(g_i²)`` (per-example
form, what scatter-add produces). Both are standard adagrad variants; the
distinction only matters for ids duplicated within one batch and decays
as the accumulator grows.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["field_split", "sparse_table_update", "sparse_adagrad_init"]

DEFAULT_SMALL_VOCAB = 4096


def field_split(
    vocab_sizes: Sequence[int], small_threshold: int = DEFAULT_SMALL_VOCAB
) -> Tuple[List[int], List[int]]:
    """Static (small_fields, large_fields) index lists."""
    small = [f for f, v in enumerate(vocab_sizes) if v <= small_threshold]
    large = [f for f, v in enumerate(vocab_sizes) if v > small_threshold]
    return small, large


def sparse_adagrad_init(n_rows: int) -> jnp.ndarray:
    """(n_rows,) row-wise adagrad accumulator."""
    return jnp.zeros((n_rows,), jnp.float32)


def sparse_table_update(
    table: jnp.ndarray,
    accum: jnp.ndarray,
    ids: jnp.ndarray,
    row_grads: jnp.ndarray,
    vocab_sizes: Sequence[int],
    lr: float = 0.05,
    small_threshold: int = DEFAULT_SMALL_VOCAB,
    eps: float = 1e-8,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Apply row-wise adagrad to a stacked multi-field embedding table.

    Args:
        table: (rows, D) stacked table (donate it in the enclosing jit).
        accum: (rows,) adagrad accumulator.
        ids: (B, F) globally-offset ids (the gather's indices).
        row_grads: (B, F, D) d(loss)/d(gathered rows).
        vocab_sizes: static per-field vocabulary sizes (defines the field
            offsets into the stacked table).
        lr / small_threshold / eps: optimizer knobs (static).

    Returns (table, accum) updated.
    """
    vocab_sizes = tuple(int(v) for v in vocab_sizes)
    d = table.shape[1]
    offsets = np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int32)
    small_fields, large_fields = field_split(vocab_sizes, small_threshold)

    for f in small_fields:
        v = vocab_sizes[f]
        off = int(offsets[f])
        # grad slice via one-hot matmul: (v, B) @ (B, D) —
        # duplicate ids sum naturally, no scatter anywhere
        oh = jax.nn.one_hot(ids[:, f] - off, v, dtype=table.dtype)
        g = oh.T @ row_grads[:, f, :]  # (v, D)
        a = jax.lax.dynamic_slice(accum, (off,), (v,)) + jnp.mean(g * g, axis=1)
        accum = jax.lax.dynamic_update_slice(accum, a, (off,))
        rows = jax.lax.dynamic_slice(table, (off, 0), (v, d))
        rows = rows - (lr / (jnp.sqrt(a) + eps))[:, None] * g
        table = jax.lax.dynamic_update_slice(table, rows, (off, 0))

    for f in large_fields:
        g = row_grads[:, f, :]
        idx = ids[:, f]
        accum = accum.at[idx].add(jnp.mean(g * g, axis=1))
        scale = lr / (jnp.sqrt(jnp.take(accum, idx)) + eps)
        table = table.at[idx].add(-scale[:, None] * g)

    return table, accum
