"""Int8 corpus quantization with stochastic rounding.

The retrieval scan is memory-bandwidth bound at large corpus sizes: at
1M x 128 x f32 every full sweep reads 512 MB. Storing the corpus int8
cuts the bytes 4x and moves the matmul to the int8 path; per-row
symmetric scales restore magnitude at O(N) extra reads. Stochastic
rounding keeps the quantizer unbiased (E[q] = x/scale), which matters
because retrieval compares scores ACROSS items — a biased rounder would
systematically favor items whose coordinates land near round-up
boundaries.

``quantize_int8_jnp`` runs once per index build, off the serving path.

No reference equivalent: FAISS IVFFlat (``src/models/faiss_index.py``)
stores full f32 vectors; the quantized-index analogue there would be a
separate IndexIVFPQ, which the reference does not use.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def _row_scales(x: jnp.ndarray) -> jnp.ndarray:
    """Per-row symmetric scale so that x / scale fits in [-127, 127]."""
    abs_max = jnp.max(jnp.abs(x), axis=-1)
    return jnp.maximum(abs_max, 1e-12) / 127.0


@functools.partial(jax.jit, static_argnames=("stochastic",))
def quantize_int8_jnp(
    x: jnp.ndarray,
    key: Optional[jax.Array] = None,
    stochastic: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(N, D) f32 → ((N, D) int8, (N,) f32 per-row scales).

    stochastic=True floors ``x/scale + u`` with u ~ U[0,1) (unbiased);
    stochastic=False rounds to nearest (lower variance, biased at .5).
    """
    scales = _row_scales(x)
    scaled = x / scales[:, None]
    if stochastic:
        if key is None:
            key = jax.random.PRNGKey(0)
        u = jax.random.uniform(key, x.shape, jnp.float32)
        q = jnp.floor(scaled + u)
    else:
        q = jnp.round(scaled)
    return jnp.clip(q, -127, 127).astype(jnp.int8), scales


def dequantize_int8(vals: jnp.ndarray, scales: jnp.ndarray) -> jnp.ndarray:
    return vals.astype(jnp.float32) * scales[..., None]
