"""Criteo-style CTR model — DLRM-shaped, with joint two-stage heads.

BASELINE config #5: "Criteo-style CTR features + neural ranker jointly
trained (stretch: end-to-end two-stage)". No reference equivalent exists
(the reference is MovieLens-only); this is a green-field model family.

Design choices:
* All 26 categorical fields share ONE stacked embedding table addressed by
  static per-field offsets — the whole sparse side is a single
  (B·26)-row gather instead of 26 small ones, and the table row-shards
  over the 'model' mesh axis exactly like the two-tower tables
  (``recommendit_tpu.parallel.embedding``).
* Feature interactions are the DLRM pairwise-dot block computed as one
  batched (F+1, D)x(D, F+1) matmul (``einsum bfd,bgd->bfg``);
  the strictly-upper triangle is extracted with a static index gather —
  no dynamic shapes, everything jit-traceable once.
* Optional bfloat16 compute: params stay f32, matmuls run in bf16.

Joint two-stage: the SAME stacked table feeds (a) the DLRM CTR ranker over
all fields and (b) two retrieval towers (mean-pooled user-field /
item-field embeddings -> MLP -> L2-normalize), trained in one optimization
with loss = BCE(click) + lambda * click-weighted in-batch sampled softmax.
This is the end-to-end two-stage the reference trains in two disconnected
phases (two_tower then LightGBM, SURVEY.md §3.1).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from recommendit_tpu.data.ctr import N_DENSE, N_SPARSE, N_USER_FIELDS

Params = Dict[str, jnp.ndarray]


def field_offsets(vocab_sizes: Sequence[int]) -> np.ndarray:
    """Static per-field base offsets into the stacked embedding table."""
    return np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int32)


def total_vocab(vocab_sizes: Sequence[int]) -> int:
    return int(np.sum(vocab_sizes))


def _glorot(rng, shape, dtype=jnp.float32):
    limit = float(np.sqrt(6.0 / (shape[0] + shape[-1])))
    return jax.random.uniform(rng, shape, dtype, -limit, limit)


def _interaction_indices(n_vectors: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static (row, col) indices of the strictly-upper triangle."""
    iu, ig = np.triu_indices(n_vectors, k=1)
    return iu.astype(np.int32), ig.astype(np.int32)


def init_ctr_params(
    rng: jax.Array,
    vocab_sizes: Sequence[int],
    embed_dim: int = 16,
    bottom_hidden: int = 64,
    top_hidden: Tuple[int, ...] = (256, 128),
    retrieval_dim: int = 32,
    n_dense: int = N_DENSE,
    n_sparse: int = N_SPARSE,
    pad_rows_to: int = 1,
) -> Params:
    """Initialize the DLRM + tower parameter pytree.

    ``pad_rows_to``: round the stacked table's row count up to a multiple
    (set to the mesh 'model'-axis size so the table row-shards evenly).
    """
    keys = jax.random.split(rng, 12)
    rows = total_vocab(vocab_sizes)
    rows = rows + ((-rows) % pad_rows_to)
    n_inter = (n_sparse + 1) * n_sparse // 2  # F+1 vectors incl. dense
    top_in = embed_dim + n_inter

    params: Params = {
        "embed": 0.05 * jax.random.normal(keys[0], (rows, embed_dim)),
        # bottom (dense) MLP: 13 -> H -> D
        "bot_w1": _glorot(keys[1], (n_dense, bottom_hidden)),
        "bot_b1": jnp.zeros((bottom_hidden,)),
        "bot_w2": _glorot(keys[2], (bottom_hidden, embed_dim)),
        "bot_b2": jnp.zeros((embed_dim,)),
        # retrieval towers over mean-pooled field embeddings
        "ut_w1": _glorot(keys[7], (embed_dim, 2 * retrieval_dim)),
        "ut_b1": jnp.zeros((2 * retrieval_dim,)),
        "ut_w2": _glorot(keys[8], (2 * retrieval_dim, retrieval_dim)),
        "ut_b2": jnp.zeros((retrieval_dim,)),
        "it_w1": _glorot(keys[9], (embed_dim, 2 * retrieval_dim)),
        "it_b1": jnp.zeros((2 * retrieval_dim,)),
        "it_w2": _glorot(keys[10], (2 * retrieval_dim, retrieval_dim)),
        "it_b2": jnp.zeros((retrieval_dim,)),
    }
    # top MLP: (D + n_inter [+1 joint similarity]) -> hidden... -> 1
    dims = (top_in + 1,) + tuple(top_hidden) + (1,)
    tk = jax.random.split(keys[3], len(dims))
    for li in range(len(dims) - 1):
        params[f"top_w{li + 1}"] = _glorot(tk[li], (dims[li], dims[li + 1]))
        params[f"top_b{li + 1}"] = jnp.zeros((dims[li + 1],))
    return params


def _n_top_layers(params: Params) -> int:
    n = 0
    while f"top_w{n + 1}" in params:
        n += 1
    return n


def _mlp2(x, w1, b1, w2, b2):
    h = jnp.maximum(x @ w1 + b1, 0.0)
    return h @ w2 + b2


def _l2norm(x, eps=1e-12):
    return x * jax.lax.rsqrt(jnp.sum(x * x, axis=-1, keepdims=True) + eps)


def embed_fields(params: Params, stacked_ids: jnp.ndarray,
                 compute_dtype=None) -> jnp.ndarray:
    """(B, F) globally-offset ids -> (B, F, D) embedding rows; the single
    gather that the sharded path replaces with a masked-psum exchange."""
    emb = jnp.take(params["embed"], stacked_ids, axis=0)
    if compute_dtype is not None:
        emb = emb.astype(compute_dtype)
    return emb


def user_tower_ctr(params: Params, field_emb: jnp.ndarray) -> jnp.ndarray:
    """(B, U, D) user-field embeddings -> (B, R) L2-normalized query."""
    pooled = jnp.mean(field_emb, axis=1).astype(jnp.float32)
    out = _mlp2(pooled, params["ut_w1"], params["ut_b1"],
                params["ut_w2"], params["ut_b2"])
    return _l2norm(out)


def item_tower_ctr(params: Params, field_emb: jnp.ndarray) -> jnp.ndarray:
    """(B, I, D) item-field embeddings -> (B, R) L2-normalized corpus vec."""
    pooled = jnp.mean(field_emb, axis=1).astype(jnp.float32)
    out = _mlp2(pooled, params["it_w1"], params["it_b1"],
                params["it_w2"], params["it_b2"])
    return _l2norm(out)


def ctr_forward_from_embed(
    params: Params,
    dense: jnp.ndarray,
    field_emb: jnp.ndarray,
    similarity: Optional[jnp.ndarray] = None,
    compute_dtype=None,
) -> jnp.ndarray:
    """DLRM forward given pre-gathered field embeddings.

    dense: (B, 13); field_emb: (B, 26, D); similarity: optional (B,) tower
    dot product fed as an explicit top-MLP feature (the joint two-stage
    analogue of RANKER_USE_RETRIEVAL_SCORE). Returns (B,) logits.
    """
    cdt = compute_dtype or jnp.float32
    d = _mlp2(
        dense.astype(cdt),
        params["bot_w1"].astype(cdt), params["bot_b1"].astype(cdt),
        params["bot_w2"].astype(cdt), params["bot_b2"].astype(cdt),
    )  # (B, D)
    z = jnp.concatenate([d[:, None, :], field_emb.astype(cdt)], axis=1)
    # pairwise dots as one batched matmul: (B, F+1, F+1)
    s = jnp.einsum("bfd,bgd->bfg", z, z,
                   preferred_element_type=jnp.float32)
    iu, ig = _interaction_indices(z.shape[1])
    inter = s[:, iu, ig]  # (B, n_inter) static gather
    sim = (jnp.zeros(dense.shape[0], jnp.float32) if similarity is None
           else similarity.astype(jnp.float32))
    x = jnp.concatenate(
        [d.astype(jnp.float32), inter, sim[:, None]], axis=1
    )
    n_layers = _n_top_layers(params)
    for li in range(1, n_layers + 1):
        w = params[f"top_w{li}"].astype(cdt)
        b = params[f"top_b{li}"].astype(cdt)
        x = x.astype(cdt) @ w + b
        if li < n_layers:
            x = jnp.maximum(x, 0.0)
        x = x.astype(jnp.float32)
    return x[:, 0]


def ctr_forward(
    params: Params,
    dense: jnp.ndarray,
    stacked_ids: jnp.ndarray,
    joint: bool = False,
    compute_dtype=None,
    n_user_fields: int = N_USER_FIELDS,
):
    """Full forward from globally-offset sparse ids.

    joint=False -> (B,) CTR logits (similarity feature = 0).
    joint=True  -> (logits, user_emb, item_emb): the towers' similarity is
    wired into the top MLP, so ranking and retrieval co-train end-to-end.
    """
    emb = embed_fields(params, stacked_ids, compute_dtype)
    if not joint:
        return ctr_forward_from_embed(params, dense, emb,
                                      compute_dtype=compute_dtype)
    ue = user_tower_ctr(params, emb[:, :n_user_fields])
    ie = item_tower_ctr(params, emb[:, n_user_fields:])
    sim = jnp.sum(ue * ie, axis=-1)
    logits = ctr_forward_from_embed(params, dense, emb, sim, compute_dtype)
    return logits, ue, ie


def bce_loss(logits: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """Mean sigmoid binary cross-entropy (the Criteo objective)."""
    return jnp.mean(
        jnp.maximum(logits, 0.0) - logits * labels
        + jnp.log1p(jnp.exp(-jnp.abs(logits)))
    )


def weighted_in_batch_softmax(
    user_emb: jnp.ndarray,
    item_emb: jnp.ndarray,
    weights: jnp.ndarray,
    log_q: Optional[jnp.ndarray] = None,
    temperature: float = 0.1,
) -> jnp.ndarray:
    """In-batch sampled softmax where only weighted rows (clicks) are
    positives; non-clicked impressions still serve as negatives for other
    rows. logQ correction as in ``ops.bpr.in_batch_softmax_loss``."""
    scores = jnp.dot(user_emb, item_emb.T,
                     preferred_element_type=jnp.float32) / temperature
    if log_q is not None:
        scores = scores - log_q[None, :]
    log_probs = jax.nn.log_softmax(scores, axis=1)
    diag = jnp.diagonal(log_probs)
    denom = jnp.maximum(jnp.sum(weights), 1.0)
    return -jnp.sum(weights * diag) / denom


class CTRModel:
    """Host-side wrapper: params + vocab metadata + persistence (same role
    as ``TwoTowerModel`` for the MovieLens family)."""

    def __init__(
        self,
        vocab_sizes: Sequence[int],
        embed_dim: int = 16,
        retrieval_dim: int = 32,
        top_hidden: Tuple[int, ...] = (256, 128),
        n_user_fields: int = N_USER_FIELDS,
        params: Optional[Params] = None,
        seed: int = 0,
        pad_rows_to: int = 1,
    ):
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.embed_dim = embed_dim
        self.retrieval_dim = retrieval_dim
        self.top_hidden = tuple(top_hidden)
        self.n_user_fields = n_user_fields
        self.offsets = field_offsets(self.vocab_sizes)
        self.params = params if params is not None else init_ctr_params(
            jax.random.PRNGKey(seed), self.vocab_sizes, embed_dim,
            top_hidden=self.top_hidden, retrieval_dim=retrieval_dim,
            pad_rows_to=pad_rows_to,
        )
        self._jit_fwd = jax.jit(
            lambda p, d, s: ctr_forward(p, d, s, joint=False)
        )
        self._jit_joint = jax.jit(
            lambda p, d, s: ctr_forward(
                p, d, s, joint=True, n_user_fields=self.n_user_fields
            )
        )

    def stack_ids(self, sparse: np.ndarray) -> np.ndarray:
        """Field-local (N, 26) ids -> globally-offset ids for the table."""
        return (sparse.astype(np.int64) + self.offsets[None, :]).astype(np.int32)

    def predict_proba(self, dense: np.ndarray, sparse: np.ndarray,
                      batch_size: int = 16384, joint: bool = False) -> np.ndarray:
        """Batched click probabilities."""
        ids = self.stack_ids(sparse)
        out = []
        fwd = self._jit_joint if joint else self._jit_fwd
        for s in range(0, len(dense), batch_size):
            r = fwd(self.params, jnp.asarray(dense[s:s + batch_size]),
                    jnp.asarray(ids[s:s + batch_size]))
            logits = r[0] if joint else r
            out.append(np.asarray(jax.nn.sigmoid(logits)))
        return np.concatenate(out) if out else np.zeros((0,), np.float32)

    def item_corpus_embeddings(self, item_field_values: np.ndarray,
                               batch_size: int = 16384) -> np.ndarray:
        """(n_items, 18) field-local catalog -> (n_items, R) tower corpus."""
        off = self.offsets[self.n_user_fields:]
        ids = (item_field_values.astype(np.int64) + off[None, :]).astype(np.int32)
        fn = jax.jit(lambda p, s: item_tower_ctr(p, embed_fields(p, s)))
        out = []
        for s in range(0, len(ids), batch_size):
            out.append(np.asarray(fn(self.params, jnp.asarray(ids[s:s + batch_size]))))
        return np.concatenate(out) if out else np.zeros((0, self.retrieval_dim))

    def user_query_embeddings(self, user_field_values: np.ndarray,
                              batch_size: int = 16384) -> np.ndarray:
        off = self.offsets[: self.n_user_fields]
        ids = (user_field_values.astype(np.int64) + off[None, :]).astype(np.int32)
        fn = jax.jit(lambda p, s: user_tower_ctr(p, embed_fields(p, s)))
        out = []
        for s in range(0, len(ids), batch_size):
            out.append(np.asarray(fn(self.params, jnp.asarray(ids[s:s + batch_size]))))
        return np.concatenate(out) if out else np.zeros((0, self.retrieval_dim))

    # --- persistence ---------------------------------------------------- #

    def save(self, path: str) -> None:
        # np.savez appends '.npz' when absent; normalize so save(p)/load(p)
        # agree for any p (and the .meta.json sidecar sits next to the
        # real file).
        p = Path(path)
        if p.suffix != ".npz":
            p = Path(str(p) + ".npz")
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez(p, **{k: np.asarray(v) for k, v in self.params.items()})
        meta = {
            "vocab_sizes": list(self.vocab_sizes),
            "embed_dim": self.embed_dim,
            "retrieval_dim": self.retrieval_dim,
            "top_hidden": list(self.top_hidden),
            "n_user_fields": self.n_user_fields,
        }
        Path(str(p) + ".meta.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path: str) -> "CTRModel":
        p = Path(path)
        if p.suffix != ".npz":
            p = Path(str(p) + ".npz")
        if not p.exists():
            raise FileNotFoundError(f"CTR checkpoint not found: {p}")
        meta = json.loads(Path(str(p) + ".meta.json").read_text())
        with np.load(p) as data:
            params = {k: jnp.asarray(data[k]) for k in data.files}
        return cls(
            vocab_sizes=meta["vocab_sizes"],
            embed_dim=meta["embed_dim"],
            retrieval_dim=meta["retrieval_dim"],
            top_hidden=tuple(meta["top_hidden"]),
            n_user_fields=meta["n_user_fields"],
            params=params,
        )
