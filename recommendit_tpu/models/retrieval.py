"""On-device exact MIPS retrieval index.

Replaces the reference FAISS IVFFlat wrapper (``src/models/faiss_index.py``)
with a device-resident item matrix scanned exactly by the blocked matmul
top-k (``recommendit_tpu.ops.topk``). Public surface parity: build (:45-82),
search with query normalization + k capping + id mapping (:88-124),
batch_search (:126-153), save/load with metadata (:159-205), stats (:211).

The IVF recall knobs (n_lists/n_probe, reference :224) are intentionally
gone: the full-corpus scan is exact, so recall == 1.0 by construction. For
corpora beyond one device's memory, the sharded variant in
``recommendit_tpu.parallel.retrieval`` splits rows across the mesh.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from recommendit_tpu.ops.topk import (
    mips_topk,
    mips_topk_certified,
    mips_topk_int8,
    mips_topk_window_auto,
)

logger = logging.getLogger(__name__)


def _l2_normalize_np(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


class MIPSIndex:
    """Exact maximum-inner-product index over a device-resident corpus."""

    def __init__(
        self,
        embedding_dim: int = 64,
        block_size: int = 4096,
        mode: str = "exact",
        dtype: str = "float32",
        quant_seed: int = 0,
    ):
        """Args:
            mode: 'exact' | 'verified' (certified exact) | 'approx'
                (``approx_max_k``) | 'fused' (window-segment maxima,
                :func:`~recommendit_tpu.ops.topk.mips_topk_window_auto`).
            dtype: corpus storage dtype — 'float32', 'bfloat16' (halves
                device memory; scores still accumulate in f32) or 'int8'
                (quarter memory + int8 matmul; per-row symmetric scales
                with stochastic rounding, seeded by ``quant_seed``).
        """
        if dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"unsupported corpus dtype: {dtype!r}")
        if mode not in ("exact", "verified", "approx", "fused"):
            raise ValueError(
                f"unsupported index mode: {mode!r} "
                "(exact | verified | approx | fused)"
            )
        if dtype == "int8" and mode == "verified":
            raise ValueError(
                "mode='verified' is not available for the int8 corpus "
                "path (the exactness certificate is defined on f32 "
                "scores; use exact, approx or fused)"
            )
        self.embedding_dim = embedding_dim
        self.block_size = block_size
        self.mode = mode
        self.dtype = dtype
        self.quant_seed = quant_seed
        self.item_ids: Optional[np.ndarray] = None       # (N,) int64
        self._embs: Optional[jnp.ndarray] = None          # (N, D[+1]) on device
        self._scales: Optional[jnp.ndarray] = None        # (N,) f32 (int8)
        self._ids_dev: Optional[jnp.ndarray] = None
        self._bias_np: Optional[np.ndarray] = None        # (N,) f32 score bias

    # ------------------------------------------------------------------ #
    # Build                                                                #
    # ------------------------------------------------------------------ #

    def build(
        self,
        embeddings: np.ndarray,
        item_ids: np.ndarray,
        bias: Optional[np.ndarray] = None,
    ) -> None:
        """Normalize and place the catalog on device
        (replaces IVF train+add, reference ``faiss_index.py:45-82``).

        ``bias``: optional (N,) per-item additive score — the two-tower's
        learned popularity bias, pre-scaled by the softmax temperature.
        Stored as an extra matrix column so the score ``q·e + b`` is ONE
        MIPS dot against ``[q, 1]``; every search path (exact / windowed /
        approx / int8 / fused window / sharded ring) handles it untouched.
        """
        if embeddings.ndim != 2 or embeddings.shape[1] != self.embedding_dim:
            raise ValueError(
                f"embeddings must be (N, {self.embedding_dim}), "
                f"got {embeddings.shape}"
            )
        if len(item_ids) != len(embeddings):
            raise ValueError("item_ids and embeddings length mismatch")
        embs = _l2_normalize_np(np.asarray(embeddings, np.float32))
        if bias is not None:
            if len(bias) != len(embs):
                raise ValueError("bias and embeddings length mismatch")
            self._bias_np = np.asarray(bias, np.float32)
            embs = np.concatenate([embs, self._bias_np[:, None]], axis=1)
        else:
            self._bias_np = None
        self.item_ids = np.asarray(item_ids, np.int64)
        if self.dtype == "int8":
            from recommendit_tpu.ops.quantize import quantize_int8_jnp

            self._embs, self._scales = quantize_int8_jnp(
                jnp.asarray(embs),
                jax.random.PRNGKey(self.quant_seed),
            )
        else:
            dev_dtype = (
                jnp.bfloat16 if self.dtype == "bfloat16" else jnp.float32
            )
            self._embs = jnp.asarray(embs, dev_dtype)
        self._ids_dev = jnp.asarray(self.item_ids, jnp.int32)
        logger.info(
            "Built exact MIPS index: %d items, dim %d", len(item_ids),
            self.embedding_dim,
        )

    # alias matching the reference method name
    build_ivf_index = build

    @property
    def n_total(self) -> int:
        return 0 if self.item_ids is None else len(self.item_ids)

    # ------------------------------------------------------------------ #
    # Search                                                               #
    # ------------------------------------------------------------------ #

    def search(
        self, query: np.ndarray, k: int = 500
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k for one query vector → (scores (k,), item_ids (k,))."""
        scores, ids = self.batch_search(np.asarray(query).reshape(1, -1), k)
        return scores[0], ids[0]

    def batch_search(
        self, queries: np.ndarray, k: int = 500
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k for (Q, D) queries → (scores (Q,k), item_ids (Q,k))."""
        if self._embs is None:
            raise RuntimeError("Index not built. Call build() first.")
        k = min(k, self.n_total)
        q = _l2_normalize_np(np.asarray(queries, np.float32))
        vals, ids = self.search_device(jnp.asarray(q), k)
        return np.asarray(vals), np.asarray(ids).astype(np.int64)

    @property
    def has_bias(self) -> bool:
        return self._bias_np is not None

    def _augment(self, queries: jnp.ndarray) -> jnp.ndarray:
        """Append the ones column matching the stored bias column (no-op
        for bias-free indexes or already-augmented queries)."""
        if self.has_bias and queries.shape[-1] == self.embedding_dim:
            ones = jnp.ones(queries.shape[:-1] + (1,), queries.dtype)
            return jnp.concatenate([queries, ones], axis=-1)
        return queries

    def search_device(self, queries: jnp.ndarray, k: int):
        """Device-to-device search (no host transfer) for jitted serving:
        returns (scores, item_ids) as jnp arrays."""
        vals, idx = self.search_device_positions(queries, k)
        return vals, jnp.take(self._ids_dev, idx)

    def search_device_positions(self, queries: jnp.ndarray, k: int):
        """Like :meth:`search_device` but returns corpus POSITIONS instead
        of item ids (the fused serve fn gathers ids itself)."""
        return self.make_device_searcher(k)(queries, self.device_corpus)

    @property
    def device_corpus(self):
        """``(embs, scales)`` on device (``scales`` is None unless int8):
        the second argument of :meth:`make_device_searcher`'s fn."""
        return self._embs, self._scales

    def make_device_searcher(self, k: int):
        """Retrieval fn for jitted serving: ``(queries (Q, D), corpus)`` →
        (scores (Q,k), positions (Q,k)), with ``corpus`` =
        :attr:`device_corpus`. The corpus is an argument, never a closure
        constant: a jitted closure over it would bake the whole corpus into
        the executable."""
        block, mode = self.block_size, self.mode
        aug = self._augment

        if self.dtype == "int8":
            if mode == "fused":
                return lambda q, c: mips_topk_window_auto(aug(q), c[0], k,
                                                          c[1])
            return lambda q, c: mips_topk_int8(aug(q), c[0], c[1], k, block,
                                               mode)
        if mode == "verified":
            # certified-exact: verified two-pass fast path, lax.cond
            # escalation to the windowed exact path on certificate failure
            # — recall 1.0 always
            return lambda q, c: mips_topk_certified(aug(q), c[0], k, block)
        if mode == "fused":
            return lambda q, c: mips_topk_window_auto(aug(q), c[0], k)
        return lambda q, c: mips_topk(aug(q), c[0], k, block, mode)

    # ------------------------------------------------------------------ #
    # Persistence                                                          #
    # ------------------------------------------------------------------ #

    def save(self, path: str) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        if self.dtype == "int8":
            # persist the quantized corpus exactly (4x smaller file; no
            # re-quantization noise on reload)
            extras = (
                {"bias": self._bias_np} if self._bias_np is not None else {}
            )
            np.savez(
                p,
                embeddings_i8=np.asarray(self._embs),
                scales=np.asarray(self._scales, np.float32),
                item_ids=self.item_ids,
                **extras,
            )
        else:
            extras = (
                {"bias": self._bias_np} if self._bias_np is not None else {}
            )
            np.savez(
                p,
                # persist as f32 regardless of device dtype (npz has no bf16);
                # store the un-augmented matrix — build() re-appends the bias
                embeddings=np.asarray(
                    self._embs, np.float32
                )[: self.n_total, : self.embedding_dim],
                item_ids=self.item_ids,
                **extras,
            )
        meta = {
            "embedding_dim": self.embedding_dim,
            "block_size": self.block_size,
            "mode": self.mode,
            "dtype": self.dtype,
            "quant_seed": self.quant_seed,
            "n_total": self.n_total,
        }
        Path(str(p) + ".meta.json").write_text(json.dumps(meta))
        logger.info("Saved MIPS index to %s", p)

    @classmethod
    def load(cls, path: str) -> "MIPSIndex":
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(f"Index not found: {p}")
        meta = json.loads(Path(str(p) + ".meta.json").read_text())
        idx = cls(
            embedding_dim=meta["embedding_dim"],
            block_size=meta["block_size"],
            mode=meta["mode"],
            dtype=meta.get("dtype", "float32"),
            quant_seed=meta.get("quant_seed", 0),
        )
        with np.load(p) as data:
            if "embeddings_i8" in data.files:
                idx.item_ids = np.asarray(data["item_ids"], np.int64)
                # files from older builds may hold zero pad rows past n
                n = len(idx.item_ids)
                idx._embs = jnp.asarray(data["embeddings_i8"][:n], jnp.int8)
                idx._scales = jnp.asarray(data["scales"][:n], jnp.float32)
                idx._ids_dev = jnp.asarray(idx.item_ids, jnp.int32)
                if "bias" in data.files:
                    idx._bias_np = np.asarray(data["bias"], np.float32)
            else:
                idx.build(
                    data["embeddings"], data["item_ids"],
                    bias=data["bias"] if "bias" in data.files else None,
                )
        return idx

    # ------------------------------------------------------------------ #
    # Introspection                                                        #
    # ------------------------------------------------------------------ #

    def stats(self) -> dict:
        return {
            "index_type": "exact-mips",
            "n_total": self.n_total,
            "embedding_dim": self.embedding_dim,
            "block_size": self.block_size,
            "mode": self.mode,
            "dtype": self.dtype,
            "has_bias": self.has_bias,
            # int8 ranking error is bounded by the quantization step
            "recall": 1.0
            if self.mode in ("exact", "verified") and self.dtype != "int8"
            else None,
        }
