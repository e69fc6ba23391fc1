"""Neural LambdaRank re-ranker — JAX replacement for LightGBM LambdaMART.

Capability parity with the reference ranker (``src/models/ranker.py``):
query-grouped training with graded label gains ``[0,1,3,7,15]`` and
NDCG@[5,10,20] eval (:115-129), early stopping on validation NDCG (:137),
``predict`` over a feature frame (:161), gain-style feature importance +
``top_features`` (:180-197), text/weights persistence (:203-226),
``model_info`` (:238).

Design: an MLP scorer over the 50-feature contract trained with
the LambdaRank pairwise objective — softplus pairwise logistic loss weighted
by |ΔNDCG| computed from stop-gradient ranks (Burges et al., "From RankNet
to LambdaRank to LambdaMART"). Ragged query groups are packed into fixed
(G,) masked chunks so the whole training step is a static-shape jitted scan;
scoring 500 candidates is a single fused matmul chain on device instead of
a C++ tree-ensemble traversal.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

logger = logging.getLogger(__name__)

DEFAULT_LABEL_GAIN = (0.0, 1.0, 3.0, 7.0, 15.0)


# ------------------------------------------------------------------ #
# Pure model functions                                                 #
# ------------------------------------------------------------------ #

def init_mlp(rng, n_features: int, hidden_dims: Sequence[int]) -> Dict:
    params = {}
    dims = [n_features] + list(hidden_dims) + [1]
    keys = jax.random.split(rng, len(dims) - 1)
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        limit = float(np.sqrt(6.0 / (d_in + d_out)))
        params[f"w{i}"] = jax.random.uniform(
            keys[i], (d_in, d_out), jnp.float32, -limit, limit
        )
        params[f"b{i}"] = jnp.zeros((d_out,), jnp.float32)
    return params


def mlp_score(params: Dict, x: jnp.ndarray) -> jnp.ndarray:
    """(…, F) standardized features → (…,) scores."""
    n_layers = len(params) // 2
    h = x
    for i in range(n_layers - 1):
        h = jnp.maximum(h @ params[f"w{i}"] + params[f"b{i}"], 0.0)
    out = h @ params[f"w{n_layers - 1}"] + params[f"b{n_layers - 1}"]
    return out[..., 0]


def lambdarank_loss(
    scores: jnp.ndarray,       # (G,)
    gains: jnp.ndarray,        # (G,) graded gains (label_gain applied)
    mask: jnp.ndarray,         # (G,) 1 = real item
) -> jnp.ndarray:
    """LambdaRank loss for one padded query group.

    Pairwise logistic loss over pairs (i, j) with gain_i > gain_j, each
    weighted by the |ΔNDCG| of swapping i and j at their current
    (stop-gradient) ranks.
    """
    g = scores.shape[0]
    neg_inf = jnp.asarray(-1e9, scores.dtype)
    masked_scores = jnp.where(mask > 0, scores, neg_inf)

    # Current ranks (1-based) from sorted scores — weight only, no grad.
    order = jnp.argsort(-jax.lax.stop_gradient(masked_scores))
    ranks = jnp.zeros((g,), jnp.float32).at[order].set(
        jnp.arange(1, g + 1, dtype=jnp.float32)
    )
    disc = 1.0 / jnp.log2(1.0 + ranks)

    # Ideal DCG from sorted gains (masked items contribute 0).
    sorted_gains = jnp.sort(jnp.where(mask > 0, gains, 0.0))[::-1]
    ideal_disc = 1.0 / jnp.log2(2.0 + jnp.arange(g, dtype=jnp.float32))
    idcg = jnp.maximum((sorted_gains * ideal_disc).sum(), 1e-9)

    s_diff = masked_scores[:, None] - masked_scores[None, :]
    gain_diff = gains[:, None] - gains[None, :]
    pair_valid = (
        (gain_diff > 0)
        & (mask[:, None] > 0)
        & (mask[None, :] > 0)
    ).astype(jnp.float32)

    delta_ndcg = (
        jnp.abs(gain_diff) * jnp.abs(disc[:, None] - disc[None, :]) / idcg
    )
    pair_loss = jax.nn.softplus(-s_diff) * delta_ndcg * pair_valid
    n_pairs = jnp.maximum(pair_valid.sum(), 1.0)
    return pair_loss.sum() / n_pairs


def lambdaloss_ndcg2(
    scores: jnp.ndarray,       # (G,)
    gains: jnp.ndarray,        # (G,)
    mask: jnp.ndarray,         # (G,)
) -> jnp.ndarray:
    """NDCG-Loss2 from the LambdaLoss framework (Wang et al., CIKM'18).

    Same pairwise logistic structure as :func:`lambdarank_loss` but the pair
    weight uses the *rank-difference* discount gap
    ``|1/log2(1+|ri-rj|) - 1/log2(2+|ri-rj|)|`` — a tighter bound on NDCG
    than the LambdaRank heuristic; often a small but consistent lift."""
    g = scores.shape[0]
    neg_inf = jnp.asarray(-1e9, scores.dtype)
    masked_scores = jnp.where(mask > 0, scores, neg_inf)

    order = jnp.argsort(-jax.lax.stop_gradient(masked_scores))
    ranks = jnp.zeros((g,), jnp.float32).at[order].set(
        jnp.arange(1, g + 1, dtype=jnp.float32)
    )

    sorted_gains = jnp.sort(jnp.where(mask > 0, gains, 0.0))[::-1]
    ideal_disc = 1.0 / jnp.log2(2.0 + jnp.arange(g, dtype=jnp.float32))
    idcg = jnp.maximum((sorted_gains * ideal_disc).sum(), 1e-9)

    s_diff = masked_scores[:, None] - masked_scores[None, :]
    gain_diff = gains[:, None] - gains[None, :]
    pair_valid = (
        (gain_diff > 0) & (mask[:, None] > 0) & (mask[None, :] > 0)
    ).astype(jnp.float32)

    rank_dist = jnp.abs(ranks[:, None] - ranks[None, :])
    delta = jnp.abs(
        1.0 / jnp.log2(1.0 + jnp.maximum(rank_dist, 1.0))
        - 1.0 / jnp.log2(2.0 + rank_dist)
    )
    weight = jnp.abs(gain_diff) * delta / idcg
    pair_loss = jax.nn.softplus(-s_diff) * weight * pair_valid
    n_pairs = jnp.maximum(pair_valid.sum(), 1.0)
    return pair_loss.sum() / n_pairs


def softmax_listwise_loss(
    scores: jnp.ndarray,       # (G,)
    gains: jnp.ndarray,        # (G,)
    mask: jnp.ndarray,         # (G,)
) -> jnp.ndarray:
    """Listwise softmax cross-entropy (ListNet top-1 with graded gains):
    target distribution ∝ gains, O(G) instead of O(G²) pairs."""
    neg_inf = jnp.asarray(-1e9, scores.dtype)
    masked_scores = jnp.where(mask > 0, scores, neg_inf)
    log_probs = jax.nn.log_softmax(masked_scores)
    pos_gain = gains * mask
    total = jnp.maximum(pos_gain.sum(), 1e-9)
    return -(pos_gain / total * jnp.where(mask > 0, log_probs, 0.0)).sum()


GROUP_LOSSES = {
    "lambdarank": lambdarank_loss,
    "lambdaloss": lambdaloss_ndcg2,
    "softmax": softmax_listwise_loss,
}


def batched_group_loss(params, x, gains, mask, loss_type: str = "lambdarank"):
    """(B, G, F) groups → mean group loss over groups with usable labels."""
    scores = mlp_score(params, x)
    loss_fn = GROUP_LOSSES[loss_type]
    losses = jax.vmap(loss_fn)(scores, gains, mask)
    # A group contributes only if it has both a positive-gain and a
    # lower-gain item (pairwise) / any positive gain (listwise).
    if loss_type == "softmax":
        usable = jax.vmap(lambda g, m: ((g * m) > 0).any())(gains, mask)
    else:
        usable = jax.vmap(
            lambda g, m: ((g[:, None] - g[None, :]) > 0).any()
        )(jnp.where(mask > 0, gains, 0.0), mask)
    usable = usable.astype(jnp.float32)
    return (losses * usable).sum() / jnp.maximum(usable.sum(), 1.0)


def batched_lambdarank_loss(params, x, gains, mask):
    """Backward-compatible alias for ``loss_type='lambdarank'``."""
    return batched_group_loss(params, x, gains, mask, "lambdarank")


def group_ndcg_at_k(scores, gains, mask, k: int):
    """NDCG@k for one padded group (metric, not loss)."""
    g = scores.shape[0]
    masked = jnp.where(mask > 0, scores, -1e9)
    order = jnp.argsort(-masked)
    top_gains = jnp.where(mask > 0, gains, 0.0)[order]
    disc = 1.0 / jnp.log2(2.0 + jnp.arange(g, dtype=jnp.float32))
    within_k = (jnp.arange(g) < k).astype(jnp.float32)
    dcg = (top_gains * disc * within_k).sum()
    sorted_gains = jnp.sort(jnp.where(mask > 0, gains, 0.0))[::-1]
    idcg = (sorted_gains * disc * within_k).sum()
    return jnp.where(idcg > 0, dcg / jnp.maximum(idcg, 1e-9), 0.0), idcg > 0


def per_query_normalize(X: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Standardize each feature within its query group (host-side,
    vectorized with bincount/add.at — no per-query Python loop).

    Values are shifted by the group's first row before the mean is taken
    (the shifted-data variance), so a feature constant within a group —
    every user-level column — normalizes to exactly 0 instead of to the
    rounding residue of its mean divided by the 1e-6 floor, which would
    depend on the summation order and so on the device."""
    n_q = int(q.max()) + 1 if len(q) else 0
    if n_q == 0:
        return X.astype(np.float32)
    first = np.zeros(n_q, np.int64)
    uniq, idx = np.unique(q, return_index=True)
    first[uniq] = idx
    D = X.astype(np.float32) - X[first[q]].astype(np.float32)
    counts = np.maximum(
        np.bincount(q, minlength=n_q).astype(np.float32), 1.0
    )[:, None]
    sums = np.zeros((n_q, X.shape[1]), np.float32)
    np.add.at(sums, q, D)
    means = sums / counts
    sq = np.zeros_like(sums)
    np.add.at(sq, q, (D - means[q]) ** 2)
    std = np.sqrt(sq / counts) + 1e-6
    return (D - means[q]) / std[q]


# ------------------------------------------------------------------ #
# Group packing                                                        #
# ------------------------------------------------------------------ #

def pack_groups(
    X: np.ndarray,
    labels: np.ndarray,
    query_ids: np.ndarray,
    group_size: int,
    label_gain: Sequence[float] = DEFAULT_LABEL_GAIN,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ragged query groups → fixed (n_chunks, G, F) padded chunks.

    Queries longer than ``group_size`` are shuffled and split into several
    chunks (pairwise loss then acts within chunks — the standard
    fixed-shape approximation for XLA).
    """
    rng = rng or np.random.default_rng(0)
    gain_table = np.asarray(label_gain, np.float32)
    xs, gs, ms = [], [], []
    order = np.argsort(query_ids, kind="stable")
    Xs, ls, qs = X[order], labels[order], query_ids[order]
    boundaries = np.nonzero(np.diff(qs))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(qs)]])
    for s, e in zip(starts, ends):
        idx = np.arange(s, e)
        rng.shuffle(idx)
        for cs in range(0, len(idx), group_size):
            chunk = idx[cs: cs + group_size]
            n = len(chunk)
            x = np.zeros((group_size, X.shape[1]), np.float32)
            g = np.zeros((group_size,), np.float32)
            m = np.zeros((group_size,), np.float32)
            x[:n] = Xs[chunk]
            lab = np.clip(ls[chunk].astype(np.int64), 0, len(gain_table) - 1)
            g[:n] = gain_table[lab]
            m[:n] = 1.0
            xs.append(x)
            gs.append(g)
            ms.append(m)
    return np.stack(xs), np.stack(gs), np.stack(ms)


# ------------------------------------------------------------------ #
# Ranker                                                               #
# ------------------------------------------------------------------ #

class LambdaRankScorer:
    """Query-grouped learning-to-rank scorer on the 50-feature contract."""

    def __init__(
        self,
        feature_names: Optional[List[str]] = None,
        hidden_dims: Sequence[int] = (128, 64),
        learning_rate: float = 3e-3,
        epochs: int = 40,
        group_size: int = 64,
        label_gain: Sequence[float] = DEFAULT_LABEL_GAIN,
        eval_at: Sequence[int] = (5, 10, 20),
        early_stop_rounds: int = 5,
        batch_groups: int = 256,
        seed: int = 0,
        loss_type: str = "lambdarank",
        query_norm: bool = False,
    ):
        if loss_type not in GROUP_LOSSES:
            raise ValueError(
                f"loss_type must be one of {sorted(GROUP_LOSSES)}, "
                f"got {loss_type!r}"
            )
        self.feature_names = feature_names
        self.hidden_dims = tuple(hidden_dims)
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.group_size = group_size
        self.label_gain = tuple(label_gain)
        self.eval_at = tuple(eval_at)
        self.early_stop_rounds = early_stop_rounds
        self.batch_groups = batch_groups
        self.seed = seed
        self.loss_type = loss_type
        # Per-candidate-set normalization: additionally center/scale each
        # feature WITHIN its query group (train) / candidate set (predict).
        # Makes the scorer see relative standing among the candidates —
        # the quantity that actually decides a re-rank.
        self.query_norm = query_norm

        self.params: Optional[Dict] = None
        self.feat_mean: Optional[np.ndarray] = None
        self.feat_std: Optional[np.ndarray] = None
        self._trained = False
        self.best_iteration = 0
        self.evals_result: Dict[str, List[float]] = {}

    @property
    def n_features(self) -> int:
        return len(self.feature_names) if self.feature_names else 0

    # ------------------------------------------------------------------ #

    def _extract(self, df, feature_cols, label_col, query_col):
        X = df[feature_cols].values.astype(np.float32)
        y = df[label_col].values.astype(np.int64)
        q = df[query_col].values
        _, q = np.unique(q, return_inverse=True)
        return X, y, q

    def train(
        self,
        train_df,
        feature_cols: List[str],
        label_col: str = "label",
        query_col: str = "query_id",
        valid_df=None,
        verbose_eval: int = 10,
    ) -> Dict[str, List[float]]:
        """Train with LambdaRank; early-stops on valid NDCG@10 when a
        validation frame is given (reference ``ranker.py:60-158``)."""
        self.feature_names = list(feature_cols)
        X, y, q = self._extract(train_df, feature_cols, label_col, query_col)
        self.feat_mean = X.mean(axis=0)
        self.feat_std = X.std(axis=0) + 1e-6
        Xn = (X - self.feat_mean) / self.feat_std
        if self.query_norm:
            Xn = per_query_normalize(Xn, q)

        host_rng = np.random.default_rng(self.seed)
        xs, gs, ms = pack_groups(
            Xn, y, q, self.group_size, self.label_gain, host_rng
        )
        n_chunks = len(xs)
        logger.info(
            "LambdaRank: %d rows → %d group-chunks of %d (F=%d)",
            len(X), n_chunks, self.group_size, len(feature_cols),
        )

        valid_packed = None
        if valid_df is not None:
            Xv, yv, qv = self._extract(valid_df, feature_cols, label_col, query_col)
            Xvn = (Xv - self.feat_mean) / self.feat_std
            if self.query_norm:
                Xvn = per_query_normalize(Xvn, qv)
            valid_packed = tuple(
                jnp.asarray(a)
                for a in pack_groups(Xvn, yv, qv, self.group_size,
                                     self.label_gain, host_rng)
            )

        params = init_mlp(
            jax.random.PRNGKey(self.seed), len(feature_cols), self.hidden_dims
        )
        bg = min(self.batch_groups, n_chunks)
        steps_per_epoch = max(1, n_chunks // bg)
        schedule = optax.cosine_decay_schedule(
            self.learning_rate, decay_steps=max(1, self.epochs * steps_per_epoch)
        )
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(schedule))
        opt_state = tx.init(params)

        loss_type = self.loss_type

        @jax.jit
        def epoch_fn(params, opt_state, xb, gb, mb):
            def step(carry, batch):
                params, opt_state = carry
                loss, grads = jax.value_and_grad(
                    lambda p, x, g, m: batched_group_loss(p, x, g, m, loss_type)
                )(params, *batch)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                step, (params, opt_state), (xb, gb, mb)
            )
            return params, opt_state, jnp.mean(losses)

        @jax.jit
        def eval_ndcg(params, xs, gs, ms, k: int = 10):
            scores = mlp_score(params, xs)
            vals, valid = jax.vmap(
                lambda s, g, m: group_ndcg_at_k(s, g, m, 10)
            )(scores, gs, ms)
            v = valid.astype(jnp.float32)
            return (vals * v).sum() / jnp.maximum(v.sum(), 1.0)

        best_metric = -np.inf
        best_params = params
        patience = 0
        self.evals_result = {"train_loss": [], "valid_ndcg@10": []}

        for epoch in range(1, self.epochs + 1):
            perm = host_rng.permutation(n_chunks)
            take = steps_per_epoch * bg
            xb = jnp.asarray(xs[perm[:take]]).reshape(steps_per_epoch, bg,
                                                      self.group_size, -1)
            gb = jnp.asarray(gs[perm[:take]]).reshape(steps_per_epoch, bg,
                                                      self.group_size)
            mb = jnp.asarray(ms[perm[:take]]).reshape(steps_per_epoch, bg,
                                                      self.group_size)
            params, opt_state, loss = epoch_fn(params, opt_state, xb, gb, mb)
            self.evals_result["train_loss"].append(float(loss))

            if valid_packed is not None:
                ndcg = float(eval_ndcg(params, *valid_packed))
                self.evals_result["valid_ndcg@10"].append(ndcg)
                if epoch % verbose_eval == 0:
                    logger.info(
                        "epoch %d | loss %.5f | valid ndcg@10 %.4f",
                        epoch, float(loss), ndcg,
                    )
                if ndcg > best_metric + 1e-5:
                    best_metric = ndcg
                    best_params = jax.tree_util.tree_map(
                        lambda a: a.copy(), params
                    )
                    self.best_iteration = epoch
                    patience = 0
                else:
                    patience += 1
                    if patience >= self.early_stop_rounds:
                        logger.info(
                            "Early stop at epoch %d (best %d, ndcg %.4f)",
                            epoch, self.best_iteration, best_metric,
                        )
                        break
            else:
                best_params = params
                self.best_iteration = epoch

        self.params = best_params
        self._trained = True
        return self.evals_result

    # ------------------------------------------------------------------ #

    def predict(self, features) -> np.ndarray:
        """Score a feature frame/array (reference ``ranker.py:161-178``).

        With ``query_norm``: a frame with a ``query_id`` column is
        normalized per query; otherwise the whole input is treated as ONE
        candidate set (the serving case: 500 candidates of one request)."""
        if not self._trained:
            raise RuntimeError("Ranker not trained. Call train() or load().")
        q = None
        if hasattr(features, "columns"):
            if self.query_norm and "query_id" in features.columns:
                _, q = np.unique(features["query_id"].values, return_inverse=True)
            X = features[self.feature_names].values.astype(np.float32)
        else:
            X = np.asarray(features, np.float32)
        Xn = (X - self.feat_mean) / self.feat_std
        if self.query_norm:
            if q is None:
                q = np.zeros(len(Xn), dtype=np.int64)
            Xn = per_query_normalize(Xn, q)
        return np.asarray(self._predict_jit(self.params, jnp.asarray(Xn)))

    @property
    def _predict_jit(self):
        if not hasattr(self, "_predict_fn"):
            self._predict_fn = jax.jit(mlp_score)
        return self._predict_fn

    def predict_device(self, x_standardized: jnp.ndarray) -> jnp.ndarray:
        """Device-to-device scoring for the jitted serving path; input must
        already be standardized via :meth:`standardize_device`."""
        return mlp_score(self.params, x_standardized)

    def standardize_device(self, x: jnp.ndarray) -> jnp.ndarray:
        return (x - jnp.asarray(self.feat_mean)) / jnp.asarray(self.feat_std)

    def make_device_scorer(self):
        """Raw (…, C, F) candidate features → (…, C) scores, closure-safe
        for the fused jitted serve path (same interface as
        ``HistGBDTRanker.make_device_scorer``). Applies global
        standardization and, when trained with ``query_norm``, per-
        candidate-set normalization over the C axis."""
        params = self.params
        mean = jnp.asarray(self.feat_mean)
        std = jnp.asarray(self.feat_std)
        qn = self.query_norm

        def score(x: jnp.ndarray) -> jnp.ndarray:
            h = (x - mean) / std
            if qn:
                # shifted by the set's first row, as per_query_normalize:
                # constant features normalize to exactly 0 on any device
                h = h - h[..., :1, :]
                m = h.mean(axis=-2, keepdims=True)
                s = h.std(axis=-2, keepdims=True) + 1e-6
                h = (h - m) / s
            return mlp_score(params, h)

        return score

    # ------------------------------------------------------------------ #

    def feature_importance(self, n_samples: int = 512) -> Dict[str, float]:
        """Gradient-magnitude importance (analogue of LightGBM gain
        importance, reference ``ranker.py:180-188``): mean |∂score/∂x_j|
        over random standardized inputs."""
        if not self._trained:
            raise RuntimeError("Ranker not trained.")
        rng = jax.random.PRNGKey(0)
        x = jax.random.normal(rng, (n_samples, self.n_features))
        grads = jax.vmap(jax.grad(lambda xi: mlp_score(self.params, xi)))(x)
        imp = np.asarray(jnp.abs(grads).mean(axis=0))
        return dict(zip(self.feature_names, imp.tolist()))

    def top_features(self, n: int = 10) -> List[Tuple[str, float]]:
        imp = self.feature_importance()
        return sorted(imp.items(), key=lambda kv: -kv[1])[:n]

    # ------------------------------------------------------------------ #

    def save(self, path: str) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            p,
            feat_mean=self.feat_mean,
            feat_std=self.feat_std,
            **{k: np.asarray(v) for k, v in self.params.items()},
        )
        meta = {
            "feature_names": self.feature_names,
            "hidden_dims": list(self.hidden_dims),
            "label_gain": list(self.label_gain),
            "eval_at": list(self.eval_at),
            "group_size": self.group_size,
            "best_iteration": self.best_iteration,
            "loss_type": self.loss_type,
            "query_norm": self.query_norm,
        }
        Path(str(p) + ".meta.json").write_text(json.dumps(meta))
        logger.info("Saved ranker to %s", p)

    @classmethod
    def load(cls, path: str) -> "LambdaRankScorer":
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(f"Ranker not found: {p}")
        meta = json.loads(Path(str(p) + ".meta.json").read_text())
        scorer = cls(
            feature_names=meta["feature_names"],
            hidden_dims=meta["hidden_dims"],
            label_gain=meta["label_gain"],
            eval_at=meta["eval_at"],
            group_size=meta["group_size"],
            loss_type=meta.get("loss_type", "lambdarank"),
            query_norm=meta.get("query_norm", False),
        )
        with np.load(p) as data:
            scorer.feat_mean = data["feat_mean"]
            scorer.feat_std = data["feat_std"]
            scorer.params = {
                k: jnp.asarray(data[k])
                for k in data.files
                if k not in ("feat_mean", "feat_std")
            }
        scorer.best_iteration = meta.get("best_iteration", 0)
        scorer._trained = True
        return scorer

    def model_info(self) -> Dict:
        if not self._trained:
            return {"trained": False}
        n_params = sum(int(np.prod(v.shape)) for v in self.params.values())
        return {
            "trained": True,
            "model_type": f"{self.loss_type}-mlp",
            "query_norm": self.query_norm,
            "n_features": self.n_features,
            "hidden_dims": list(self.hidden_dims),
            "n_parameters": n_params,
            "best_iteration": self.best_iteration,
            "top_features": [
                {"feature": f, "importance": round(v, 6)}
                for f, v in self.top_features(10)
            ],
        }


# Alias matching the reference class name for drop-in familiarity.
LightGBMRanker = LambdaRankScorer
