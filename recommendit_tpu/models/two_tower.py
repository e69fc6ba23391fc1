"""Two-Tower embedding model — pure-functional JAX.

Capability parity with the reference model (``src/models/two_tower.py``):
user tower = Embedding → MLP → L2-normalize (:19-42), item tower = Embedding
⊕ 18-d genre vector → MLP → L2-normalize (:45-72), pairwise BPR loss
(:117-130), in-batch BPR loss (:132-160), single-user / batched catalog
embedding (:166-213), checkpoint save/load (:216-251).

Design differences:
* Parameters are a plain pytree of ``jnp`` arrays — shardable with
  ``jax.sharding`` PartitionSpecs, donate-able, and friendly to ``pjit``.
* All compute paths are jittable pure functions; dropout takes an explicit
  PRNG key.
* The in-batch BPR loss is fully vectorized (the reference loops over the
  batch in Python, ``two_tower.py:151-160``; ``recommendit_tpu.ops.bpr``).
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from recommendit_tpu.features.schema import N_GENRES
from recommendit_tpu.ops.bpr import in_batch_bpr_loss, pairwise_bpr_loss

logger = logging.getLogger(__name__)

Params = Dict[str, jnp.ndarray]


def _glorot(rng, shape, dtype=jnp.float32):
    fan_in, fan_out = shape[0], shape[-1]
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return jax.random.uniform(rng, shape, dtype, -limit, limit)


def init_params(
    rng: jax.Array,
    n_users: int,
    n_items: int,
    embed_dim: int = 64,
    hidden_dim: int = 128,
    dtype=jnp.float32,
) -> Params:
    """Initialize both towers. Row 0 of each embedding table is the padding
    row (reference uses ``padding_idx=0``, ``two_tower.py:27``)."""
    keys = jax.random.split(rng, 6)
    params = {
        "user_embed": 0.1 * jax.random.normal(
            keys[0], (n_users + 1, embed_dim), dtype
        ),
        "item_embed": 0.1 * jax.random.normal(
            keys[1], (n_items + 1, embed_dim), dtype
        ),
        "user_w1": _glorot(keys[2], (embed_dim, hidden_dim), dtype),
        "user_b1": jnp.zeros((hidden_dim,), dtype),
        "user_w2": _glorot(keys[3], (hidden_dim, embed_dim), dtype),
        "user_b2": jnp.zeros((embed_dim,), dtype),
        "item_w1": _glorot(keys[4], (embed_dim + N_GENRES, hidden_dim), dtype),
        "item_b1": jnp.zeros((hidden_dim,), dtype),
        "item_w2": _glorot(keys[5], (hidden_dim, embed_dim), dtype),
        "item_b2": jnp.zeros((embed_dim,), dtype),
    }
    # learned per-item score bias (sampling-bias-corrected retrieval, Yi et
    # al. 2019): training logits are cos/T + b − log q, so b absorbs the
    # user-independent (popularity) part of log p(i|u) that an L2-normalized
    # cosine cannot express. Served MIPS-natively via an augmented column
    # ([emb, T·b] · [user, 1]) — no retrieval kernel changes.
    params["item_bias"] = jnp.zeros((n_items + 1,), dtype)
    # zero the padding rows
    params["user_embed"] = params["user_embed"].at[0].set(0.0)
    params["item_embed"] = params["item_embed"].at[0].set(0.0)
    return params


def l2_normalize(x: jnp.ndarray, axis: int = -1, eps: float = 1e-12) -> jnp.ndarray:
    return x * jax.lax.rsqrt(jnp.sum(x * x, axis=axis, keepdims=True) + eps)


def _mlp(x, w1, b1, w2, b2, dropout_rate: float, rng: Optional[jax.Array],
         compute_dtype=None):
    """MLP head; optional reduced-precision compute (params stay f32,
    matmuls run in e.g. bfloat16, output returns to f32 before
    normalization)."""
    if compute_dtype is not None:
        x = x.astype(compute_dtype)
        w1, b1 = w1.astype(compute_dtype), b1.astype(compute_dtype)
        w2, b2 = w2.astype(compute_dtype), b2.astype(compute_dtype)
    h = jnp.maximum(x @ w1 + b1, 0.0)
    if dropout_rate > 0.0 and rng is not None:
        keep = jax.random.bernoulli(rng, 1.0 - dropout_rate, h.shape)
        h = jnp.where(keep, h / (1.0 - dropout_rate), 0.0)
    out = h @ w2 + b2
    return out.astype(jnp.float32)


def user_tower_from_embed(
    params: Params,
    emb: jnp.ndarray,
    dropout_rate: float = 0.0,
    rng: Optional[jax.Array] = None,
    compute_dtype=None,
) -> jnp.ndarray:
    """MLP head over pre-gathered user embedding rows (used by the sharded
    lookup path in ``recommendit_tpu.parallel``)."""
    out = _mlp(emb, params["user_w1"], params["user_b1"],
               params["user_w2"], params["user_b2"], dropout_rate, rng,
               compute_dtype)
    return l2_normalize(out)


def item_tower_from_embed(
    params: Params,
    emb: jnp.ndarray,
    genre_vecs: jnp.ndarray,
    dropout_rate: float = 0.0,
    rng: Optional[jax.Array] = None,
    compute_dtype=None,
) -> jnp.ndarray:
    """MLP head over pre-gathered item embedding rows ⊕ genre vector."""
    x = jnp.concatenate([emb, genre_vecs.astype(emb.dtype)], axis=-1)
    out = _mlp(x, params["item_w1"], params["item_b1"],
               params["item_w2"], params["item_b2"], dropout_rate, rng,
               compute_dtype)
    return l2_normalize(out)


def user_tower(
    params: Params,
    user_ids: jnp.ndarray,
    dropout_rate: float = 0.0,
    rng: Optional[jax.Array] = None,
    compute_dtype=None,
) -> jnp.ndarray:
    """(B,) int ids → (B, D) L2-normalized user embeddings."""
    emb = jnp.take(params["user_embed"], user_ids, axis=0)
    return user_tower_from_embed(params, emb, dropout_rate, rng, compute_dtype)


def item_tower(
    params: Params,
    item_ids: jnp.ndarray,
    genre_vecs: jnp.ndarray,
    dropout_rate: float = 0.0,
    rng: Optional[jax.Array] = None,
    compute_dtype=None,
) -> jnp.ndarray:
    """(B,) int ids + (B, 18) genre multi-hot → (B, D) normalized embeddings."""
    emb = jnp.take(params["item_embed"], item_ids, axis=0)
    return item_tower_from_embed(params, emb, genre_vecs, dropout_rate, rng,
                                 compute_dtype)


class TwoTowerModel:
    """Stateful wrapper: params + catalog metadata + persistence.

    The compute methods delegate to the pure functions above so everything
    stays jittable; this class only manages host-side state the way the
    reference model object does (``two_tower.py:75-251``).
    """

    def __init__(
        self,
        n_users: int,
        n_items: int,
        embed_dim: int = 64,
        hidden_dim: int = 128,
        dropout: float = 0.2,
        params: Optional[Params] = None,
        seed: int = 0,
    ):
        self.n_users = n_users
        self.n_items = n_items
        self.embed_dim = embed_dim
        self.hidden_dim = hidden_dim
        self.dropout = dropout
        self.params = (
            params
            if params is not None
            else init_params(
                jax.random.PRNGKey(seed), n_users, n_items, embed_dim, hidden_dim
            )
        )
        self._item_embeddings: Optional[np.ndarray] = None
        self._item_ids: Optional[np.ndarray] = None
        self._jit_user = jax.jit(lambda p, u: user_tower(p, u))
        self._jit_item = jax.jit(lambda p, i, g: item_tower(p, i, g))

    # --- losses (parity surface) ------------------------------------- #

    @staticmethod
    def bpr_loss(user_emb, pos_item_emb, neg_item_emb):
        return pairwise_bpr_loss(user_emb, pos_item_emb, neg_item_emb)

    @staticmethod
    def in_batch_bpr_loss(user_emb, item_emb):
        return in_batch_bpr_loss(user_emb, item_emb)

    # --- inference ---------------------------------------------------- #

    def get_user_embedding(self, user_id: int) -> np.ndarray:
        """Single-user normalized embedding (reference ``:166-172``)."""
        if not (0 <= user_id <= self.n_users):
            raise ValueError(f"user_id {user_id} out of range [0, {self.n_users}]")
        emb = self._jit_user(self.params, jnp.asarray([user_id]))
        return np.asarray(emb[0], dtype=np.float32)

    def get_item_embeddings(
        self,
        item_ids: np.ndarray,
        genre_matrix: np.ndarray,
        batch_size: int = 8192,
    ) -> np.ndarray:
        """Batched catalog embedding (reference ``:174-196``)."""
        out = []
        for s in range(0, len(item_ids), batch_size):
            ids = jnp.asarray(item_ids[s: s + batch_size])
            g = jnp.asarray(genre_matrix[s: s + batch_size])
            out.append(np.asarray(self._jit_item(self.params, ids, g)))
        return np.concatenate(out, axis=0) if out else np.zeros((0, self.embed_dim))

    def item_bias_np(self, item_ids: np.ndarray) -> np.ndarray:
        """Learned per-item score bias values for the given ids (zeros on
        checkpoints trained without the bias term)."""
        return np.asarray(
            jnp.take(self.params["item_bias"], jnp.asarray(item_ids)),
            dtype=np.float32,
        )

    def precompute_item_embeddings(
        self, item_ids: np.ndarray, genre_matrix: np.ndarray
    ) -> np.ndarray:
        """Compute + cache the full catalog (reference ``:198-213``)."""
        self._item_embeddings = self.get_item_embeddings(item_ids, genre_matrix)
        self._item_ids = np.asarray(item_ids)
        return self._item_embeddings

    # --- persistence --------------------------------------------------- #

    def save(self, path: str) -> None:
        """npz params + json meta sidecar (replaces the torch .pt
        checkpoint at reference ``:216-231``)."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez(p, **{k: np.asarray(v) for k, v in self.params.items()})
        meta = {
            "n_users": self.n_users,
            "n_items": self.n_items,
            "embed_dim": self.embed_dim,
            "hidden_dim": self.hidden_dim,
            "dropout": self.dropout,
        }
        Path(str(p) + ".meta.json").write_text(json.dumps(meta))
        logger.info("Saved two-tower model to %s", p)

    @classmethod
    def load(cls, path: str) -> "TwoTowerModel":
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(f"Two-tower checkpoint not found: {p}")
        meta = json.loads(Path(str(p) + ".meta.json").read_text())
        with np.load(p) as data:
            params = {k: jnp.asarray(data[k]) for k in data.files}
        if "item_bias" not in params:  # pre-bias checkpoints
            params["item_bias"] = jnp.zeros((meta["n_items"] + 1,), jnp.float32)
        model = cls(params=params, **meta)
        logger.info("Loaded two-tower model from %s (dim=%d)", p, model.embed_dim)
        return model
