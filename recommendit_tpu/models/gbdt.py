"""Histogram gradient-boosted decision trees with a LambdaRank objective.

A first-party replacement for LightGBM LambdaMART (reference
``src/models/ranker.py:115-151``): quantile-binned features (≤256 bins),
level-wise tree growth on histogram split finding, LambdaRank
gradients/hessians (|ΔNDCG|-weighted sigmoid pairs, label_gain semantics),
shrinkage, feature subsampling, early stopping on validation NDCG@10.

Training is host-side numpy (tree growth is inherently sequential control
flow); **inference is jittable**: the ensemble is exported to flat arrays
(feature / threshold-bin / children / leaf values) and evaluated on device as
a fixed-depth vectorized descent over all trees — batched scoring of 500
candidates is a handful of gathers per level.

The MLP LambdaRank scorer (``models/ranker.py``) remains the default
ranker; this booster exists for tree-model parity and tabular-data regimes
where GBDTs dominate MLPs.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

DEFAULT_LABEL_GAIN = (0.0, 1.0, 3.0, 7.0, 15.0)


# ------------------------------------------------------------------ #
# LambdaRank gradients                                                 #
# ------------------------------------------------------------------ #

def lambdarank_grad_hess(
    scores: np.ndarray,
    gains: np.ndarray,
    query_offsets: np.ndarray,
    sigma: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row gradient/hessian of the LambdaRank objective.

    Args:
        scores: (n,) current model scores.
        gains: (n,) graded gains (label_gain applied).
        query_offsets: (q+1,) row offsets of each query group (rows must be
            grouped contiguously by query).
    """
    n = len(scores)
    grad = np.zeros(n)
    hess = np.zeros(n)
    for s, e in zip(query_offsets[:-1], query_offsets[1:]):
        g = gains[s:e]
        if (g.max() - g.min()) <= 0:
            continue
        sc = scores[s:e]
        order = np.argsort(-sc)
        ranks = np.empty_like(order)
        ranks[order] = np.arange(1, len(sc) + 1)
        disc = 1.0 / np.log2(1.0 + ranks)
        ideal = np.sort(g)[::-1]
        idcg = (ideal / np.log2(2.0 + np.arange(len(g)))).sum()
        if idcg <= 0:
            continue

        gd = g[:, None] - g[None, :]
        pos_pair = gd > 0          # i more relevant than j
        sdiff = sc[:, None] - sc[None, :]
        rho = 1.0 / (1.0 + np.exp(np.clip(sigma * sdiff, -50, 50)))
        delta = np.abs(gd) * np.abs(disc[:, None] - disc[None, :]) / idcg
        lam = sigma * rho * delta * pos_pair
        h = sigma * sigma * rho * (1.0 - rho) * delta * pos_pair

        grad[s:e] += -(lam.sum(axis=1) - lam.sum(axis=0))
        hess[s:e] += h.sum(axis=1) + h.sum(axis=0)
    return grad, hess


def pack_group_indices(
    query_offsets: np.ndarray,
    group_size: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Row indices of each query packed into fixed (n_chunks, G) chunks
    (queries longer than G are shuffled and split — the same fixed-shape
    approximation as the MLP ranker's pack_groups)."""
    chunks, masks = [], []
    for s, e in zip(query_offsets[:-1], query_offsets[1:]):
        idx = np.arange(s, e)
        rng.shuffle(idx)
        for cs in range(0, len(idx), group_size):
            c = idx[cs: cs + group_size]
            row = np.zeros(group_size, np.int32)
            m = np.zeros(group_size, np.float32)
            row[: len(c)] = c
            m[: len(c)] = 1.0
            chunks.append(row)
            masks.append(m)
    return np.stack(chunks), np.stack(masks)


def _make_grad_fn():
    """Jitted vectorized LambdaRank grad/hess over packed groups."""
    import jax
    import jax.numpy as jnp

    def group_grad(s, g, m):
        gsz = s.shape[0]
        masked = jnp.where(m > 0, s, -1e9)
        order = jnp.argsort(-masked)
        ranks = jnp.zeros((gsz,), jnp.float32).at[order].set(
            jnp.arange(1, gsz + 1, dtype=jnp.float32)
        )
        disc = 1.0 / jnp.log2(1.0 + ranks)
        sorted_gains = jnp.sort(jnp.where(m > 0, g, 0.0))[::-1]
        ideal_disc = 1.0 / jnp.log2(2.0 + jnp.arange(gsz, dtype=jnp.float32))
        idcg = jnp.maximum((sorted_gains * ideal_disc).sum(), 1e-9)

        gd = g[:, None] - g[None, :]
        pair = ((gd > 0) & (m[:, None] > 0) & (m[None, :] > 0)).astype(
            jnp.float32
        )
        sdiff = s[:, None] - s[None, :]
        rho = jax.nn.sigmoid(-sdiff)
        delta = jnp.abs(gd) * jnp.abs(disc[:, None] - disc[None, :]) / idcg
        lam = rho * delta * pair
        h = rho * (1.0 - rho) * delta * pair
        grad = -(lam.sum(axis=1) - lam.sum(axis=0))
        hess = h.sum(axis=1) + h.sum(axis=0)
        return grad, hess

    return jax.jit(jax.vmap(group_grad))


# ------------------------------------------------------------------ #
# Device (jnp) tree growth — catalog-scale backend                     #
# ------------------------------------------------------------------ #

def _make_grow_tree_device(n_feat: int, n_bins: int, max_depth: int,
                           min_child: int, reg_lambda: float):
    """Jitted level-wise histogram tree grower.

    The numpy grower (:func:`_grow_tree`) costs ~3·F·n bincount-adds per
    level per tree on the host — at 6.5M rows × 50 features that is ~1G
    adds/level and a 100-tree catalog-scale fit exceeds the 2-vCPU host
    budget (round-4 RESULTS). This grower runs the whole level on device:
    one (grad, hess, count) segment-sum histogram per feature per level,
    vectorized split-gain search, static shapes throughout (nodes at
    depth d are the implicit ids 0..2^d-1), so XLA compiles ONE program
    reused by every tree of every boosting round.

    Matches the numpy grower's semantics: split requires
    left/right counts >= min_child (counts of SAMPLED rows), strictly
    positive gain, leaf value -G/(H+λ) over sampled rows; unsampled rows
    are still routed for the score update.

    Returns ``fn(binned_T, grad, hess, row_mask, feat_mask) ->
    (levels, row_value)`` where ``binned_T`` is the (F, n) transposed
    bin matrix, ``levels`` is a list of per-depth
    ``(best_f, best_b, do_split, gain, leaf_value)`` arrays of shape
    (2^d,), and ``row_value`` (n,) is each row's leaf value (the tree's
    prediction for every input row).
    """
    import jax
    import jax.numpy as jnp

    def grow(binned_t, grad, hess, row_mask, feat_mask):
        n = grad.shape[0]
        node = jnp.zeros(n, jnp.int32)
        frozen = jnp.zeros(n, jnp.bool_)
        row_value = jnp.zeros(n, jnp.float32)
        ghc = jnp.stack(
            [grad * row_mask, hess * row_mask, row_mask], axis=1
        )  # (n, 3)
        levels = []
        alive = jnp.ones(1, jnp.bool_)
        for depth in range(max_depth + 1):
            n_nodes = 1 << depth
            seg_base = node * n_bins
            # frozen rows keep a STALE node id (from the depth where they
            # froze) that collides with live ids at this depth — zero
            # their weight so they never pollute a live histogram
            ghc_level = ghc * (~frozen)[:, None].astype(jnp.float32)

            def hist_one(col, _seg=seg_base, _ghc=ghc_level,
                         _nn=n_nodes):
                return jax.ops.segment_sum(
                    _ghc, _seg + col.astype(jnp.int32),
                    num_segments=_nn * n_bins,
                )

            hist = jax.lax.map(hist_one, binned_t)  # (F, nodes*bins, 3)
            hist = hist.reshape(n_feat, n_nodes, n_bins, 3)
            gt = hist[..., 0].sum(-1)               # (F, nodes) — same ∀F
            ht = hist[..., 1].sum(-1)
            node_g, node_h = gt[0], ht[0]
            leaf_value = -node_g / (node_h + reg_lambda)

            if depth == max_depth:
                row_value = jnp.where(
                    frozen, row_value, leaf_value[node])
                levels.append({
                    "best_f": jnp.full(n_nodes, -1, jnp.int32),
                    "best_b": jnp.zeros(n_nodes, jnp.int32),
                    "do_split": jnp.zeros(n_nodes, jnp.bool_),
                    "gain": jnp.zeros(n_nodes, jnp.float32),
                    "leaf_value": jnp.where(alive, leaf_value, 0.0),
                })
                break

            gl = jnp.cumsum(hist[..., 0], axis=-1)[..., :-1]
            hl = jnp.cumsum(hist[..., 1], axis=-1)[..., :-1]
            cl = jnp.cumsum(hist[..., 2], axis=-1)[..., :-1]
            gr_ = gt[..., None] - gl
            hr_ = ht[..., None] - hl
            cr_ = hist[..., 2].sum(-1)[..., None] - cl
            parent = node_g**2 / (node_h + reg_lambda)  # (nodes,)
            gain = (
                gl**2 / (hl + reg_lambda) + gr_**2 / (hr_ + reg_lambda)
                - parent[None, :, None]
            )  # (F, nodes, bins-1)
            valid = (
                (cl >= min_child) & (cr_ >= min_child)
                & feat_mask[:, None, None]
            )
            gain = jnp.where(valid, gain, -jnp.inf)
            flat = gain.transpose(1, 0, 2).reshape(n_nodes, -1)
            best = jnp.argmax(flat, axis=1)
            best_gain = jnp.take_along_axis(
                flat, best[:, None], axis=1)[:, 0]
            best_f = (best // (n_bins - 1)).astype(jnp.int32)
            best_b = (best % (n_bins - 1)).astype(jnp.int32)
            do_split = alive & (best_gain > 0.0) & jnp.isfinite(best_gain)

            # rows in alive non-splitting nodes freeze with this leaf value
            newly_leaf = alive & ~do_split
            row_value = jnp.where(
                ~frozen & newly_leaf[node], leaf_value[node], row_value)
            frozen = frozen | newly_leaf[node]

            levels.append({
                "best_f": jnp.where(do_split, best_f, -1),
                "best_b": jnp.where(do_split, best_b, 0),
                "do_split": do_split,
                "gain": jnp.where(do_split, best_gain, 0.0).astype(
                    jnp.float32),
                "leaf_value": jnp.where(newly_leaf, leaf_value, 0.0),
            })

            # route every row (sampled or not) through its node's split
            f_of_row = best_f[node]
            b_of_row = best_b[node]
            bin_of_row = jnp.take_along_axis(
                binned_t, f_of_row[None, :], axis=0
            )[0].astype(jnp.int32)
            go_right = bin_of_row > b_of_row
            stepped = 2 * node + go_right.astype(jnp.int32)
            node = jnp.where(~frozen & do_split[node], stepped, node)
            # frozen rows keep their node id but alive tracking moves on
            alive = jnp.repeat(do_split, 2)
        return levels, row_value

    return jax.jit(grow)


def _tree_from_levels(levels, max_depth: int) -> "_Tree":
    """Convert the device grower's per-level arrays into a `_Tree`
    (host-side, arrays are tiny). Node ids are allocated depth-first to
    mirror the numpy grower's layout."""
    max_nodes = 2 ** (max_depth + 1)
    tree = _Tree(max_nodes)
    lv = [
        {k: np.asarray(v) for k, v in level.items()} for level in levels
    ]
    next_free = [1]

    def emit(depth: int, pos: int, node_id: int):
        L = lv[depth]
        if depth < len(lv) - 1 and L["do_split"][pos]:
            li, ri = next_free[0], next_free[0] + 1
            next_free[0] += 2
            tree.feature[node_id] = L["best_f"][pos]
            tree.bin_threshold[node_id] = L["best_b"][pos]
            tree.gain[node_id] = L["gain"][pos]
            tree.left[node_id] = li
            tree.right[node_id] = ri
            emit(depth + 1, 2 * pos, li)
            emit(depth + 1, 2 * pos + 1, ri)
        else:
            tree.value[node_id] = L["leaf_value"][pos]

    emit(0, 0, 0)
    return tree


# ------------------------------------------------------------------ #
# Histogram tree growth                                                #
# ------------------------------------------------------------------ #

class _Tree:
    __slots__ = ("feature", "bin_threshold", "left", "right", "value", "gain")

    def __init__(self, max_nodes: int):
        self.feature = np.full(max_nodes, -1, np.int32)
        self.bin_threshold = np.zeros(max_nodes, np.int32)
        self.left = np.zeros(max_nodes, np.int32)
        self.right = np.zeros(max_nodes, np.int32)
        self.value = np.zeros(max_nodes, np.float32)
        self.gain = np.zeros(max_nodes, np.float32)


def _grow_tree(
    binned: np.ndarray,        # (n, f) uint8
    grad: np.ndarray,
    hess: np.ndarray,
    rows: np.ndarray,
    n_bins: int,
    max_depth: int,
    min_child: int,
    reg_lambda: float,
    feature_idx: np.ndarray,
) -> _Tree:
    max_nodes = 2 ** (max_depth + 1)
    tree = _Tree(max_nodes)
    next_free = [1]

    def leaf_value(r):
        return -grad[r].sum() / (hess[r].sum() + reg_lambda)

    def split_node(node_id: int, r: np.ndarray, depth: int):
        if depth >= max_depth or len(r) < 2 * min_child:
            tree.value[node_id] = leaf_value(r)
            return
        g, h = grad[r], hess[r]
        parent_score = (g.sum() ** 2) / (h.sum() + reg_lambda)
        best_gain, best_f, best_b = 0.0, -1, -1
        for f in feature_idx:
            b = binned[r, f]
            gh = np.bincount(b, weights=g, minlength=n_bins)
            hh = np.bincount(b, weights=h, minlength=n_bins)
            cnt = np.bincount(b, minlength=n_bins)
            gl, hl, cl = np.cumsum(gh)[:-1], np.cumsum(hh)[:-1], np.cumsum(cnt)[:-1]
            gr_, hr_, cr_ = g.sum() - gl, h.sum() - hl, len(r) - cl
            valid = (cl >= min_child) & (cr_ >= min_child)
            if not valid.any():
                continue
            gain = (
                gl**2 / (hl + reg_lambda) + gr_**2 / (hr_ + reg_lambda)
                - parent_score
            )
            gain = np.where(valid, gain, -np.inf)
            bi = int(np.argmax(gain))
            if gain[bi] > best_gain:
                best_gain, best_f, best_b = float(gain[bi]), int(f), bi
        if best_f < 0:
            tree.value[node_id] = leaf_value(r)
            return
        mask = binned[r, best_f] <= best_b
        li, ri = next_free[0], next_free[0] + 1
        next_free[0] += 2
        tree.feature[node_id] = best_f
        tree.bin_threshold[node_id] = best_b
        tree.gain[node_id] = best_gain
        tree.left[node_id] = li
        tree.right[node_id] = ri
        split_node(li, r[mask], depth + 1)
        split_node(ri, r[~mask], depth + 1)

    split_node(0, rows, 0)
    return tree


# ------------------------------------------------------------------ #
# Booster                                                              #
# ------------------------------------------------------------------ #

class HistGBDTRanker:
    """Histogram GBDT trained with LambdaRank (LightGBM-LambdaMART
    semantics: num_leaves→max_depth, label_gain, subsample/colsample,
    reg_lambda, early stopping)."""

    def __init__(
        self,
        n_estimators: int = 200,
        learning_rate: float = 0.1,
        max_depth: int = 6,
        n_bins: int = 64,
        min_child_samples: int = 20,
        subsample: float = 0.8,
        colsample: float = 0.8,
        reg_lambda: float = 0.1,
        label_gain: Sequence[float] = DEFAULT_LABEL_GAIN,
        early_stop_rounds: int = 30,
        seed: int = 0,
        backend: str = "auto",
    ):
        """``backend``: 'numpy' (host bincount grower), 'device' (jnp
        segment-sum grower — the catalog-scale path), or 'auto' (device
        when rows x features >= 2M, else numpy)."""
        if backend not in ("auto", "numpy", "device"):
            raise ValueError(f"unknown backend {backend!r}")
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.n_bins = n_bins
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.colsample = colsample
        self.reg_lambda = reg_lambda
        self.label_gain = tuple(label_gain)
        self.early_stop_rounds = early_stop_rounds
        self.seed = seed
        self.backend = backend

        self.feature_names: Optional[List[str]] = None
        self.bin_edges: Optional[np.ndarray] = None   # (f, n_bins-1)
        self.trees: List[_Tree] = []
        self.best_iteration = 0
        self._trained = False

    @property
    def n_features(self) -> int:
        return len(self.feature_names) if self.feature_names else 0

    # ------------------------------------------------------------------ #

    def _bin(self, X: np.ndarray, fit: bool) -> np.ndarray:
        if fit:
            qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
            self.bin_edges = np.quantile(X, qs, axis=0).T.astype(np.float32)
        out = np.empty(X.shape, np.uint8)
        for f in range(X.shape[1]):
            out[:, f] = np.searchsorted(self.bin_edges[f], X[:, f])
        return out

    @staticmethod
    def _group(query_ids: np.ndarray):
        order = np.argsort(query_ids, kind="stable")
        q = query_ids[order]
        offs = np.concatenate([[0], np.nonzero(np.diff(q))[0] + 1, [len(q)]])
        return order, offs.astype(np.int64)

    def _ndcg10(self, scores, gains, offsets) -> float:
        total, cnt = 0.0, 0
        for s, e in zip(offsets[:-1], offsets[1:]):
            g = gains[s:e]
            if g.max() <= 0:
                continue
            order = np.argsort(-scores[s:e])[:10]
            disc = 1.0 / np.log2(2.0 + np.arange(len(order)))
            dcg = (g[order] * disc).sum()
            ideal = np.sort(g)[::-1][:10]
            idcg = (ideal * disc[: len(ideal)]).sum()
            if idcg > 0:
                total += dcg / idcg
                cnt += 1
        return total / max(cnt, 1)

    # ------------------------------------------------------------------ #

    def train(
        self,
        train_df,
        feature_cols: List[str],
        label_col: str = "label",
        query_col: str = "query_id",
        valid_df=None,
        verbose_eval: int = 50,
    ) -> Dict[str, List[float]]:
        self.feature_names = list(feature_cols)
        gain_table = np.asarray(self.label_gain, np.float64)

        def prep(df):
            X = df[feature_cols].values.astype(np.float32)
            y = np.clip(df[label_col].values.astype(np.int64), 0,
                        len(gain_table) - 1)
            q = df[query_col].values
            order, offs = self._group(q)
            return X[order], gain_table[y[order]], offs

        X, gains, offsets = prep(train_df)
        binned = self._bin(X, fit=True)
        n, f = binned.shape
        scores = np.zeros(n)

        valid = None
        if valid_df is not None:
            Xv, gv, ov = prep(valid_df)
            valid = (self._bin(Xv, fit=False), gv, ov, np.zeros(len(Xv)))

        rng = np.random.default_rng(self.seed)
        evals = {"train_ndcg@10": [], "valid_ndcg@10": []}
        best_metric, patience = -np.inf, 0
        logger.info(
            "HistGBDT: %d rows, %d features, %d queries",
            n, f, len(offsets) - 1,
        )

        # vectorized grad/hess over fixed-size packed groups (device call)
        import jax.numpy as jnp

        chunk_idx, chunk_mask = pack_group_indices(offsets, 64, rng)
        chunk_idx_d = jnp.asarray(chunk_idx)
        chunk_gains_d = jnp.asarray(gains[chunk_idx] * chunk_mask)
        chunk_mask_d = jnp.asarray(chunk_mask)
        grad_fn = _make_grad_fn()

        def compute_grad_hess(scores_np):
            s = jnp.asarray(scores_np.astype(np.float32))[chunk_idx_d]
            gch, hch = grad_fn(s, chunk_gains_d, chunk_mask_d)
            grad = np.zeros(n, np.float64)
            hess = np.zeros(n, np.float64)
            flat = chunk_idx.ravel()
            mask = chunk_mask.ravel() > 0
            grad[flat[mask]] = np.asarray(gch).ravel()[mask]
            hess[flat[mask]] = np.asarray(hch).ravel()[mask]
            return grad, hess

        if self.backend == "auto":
            # the device grower wins on an accelerator (segment-sum
            # histograms, ~ms/level); on the CPU backend numpy bincount
            # is ~3x faster per tree at 500k rows — measured round 5
            import jax

            use_device = (jax.default_backend() != "cpu"
                          and n * f >= 2_000_000)
        else:
            use_device = self.backend == "device"
        if use_device:
            return self._train_device(
                binned, gains, offsets, n, f, rng, valid, evals,
                chunk_idx, chunk_mask, chunk_idx_d, chunk_gains_d,
                chunk_mask_d, grad_fn, verbose_eval,
            )

        for it in range(1, self.n_estimators + 1):
            grad, hess = compute_grad_hess(scores)
            rows = np.arange(n)
            if self.subsample < 1.0:
                rows = rng.choice(n, size=int(n * self.subsample),
                                  replace=False)
            feats = np.arange(f)
            if self.colsample < 1.0:
                feats = rng.choice(f, size=max(1, int(f * self.colsample)),
                                   replace=False)
            tree = _grow_tree(
                binned, grad, hess, rows, self.n_bins, self.max_depth,
                self.min_child_samples, self.reg_lambda, feats,
            )
            self.trees.append(tree)
            scores += self.learning_rate * self._predict_tree(tree, binned)

            if valid is not None:
                vb, gv, ov, vscores = valid
                vscores += self.learning_rate * self._predict_tree(tree, vb)
                valid = (vb, gv, ov, vscores)
                m = self._ndcg10(vscores, gv, ov)
                evals["valid_ndcg@10"].append(m)
                if it % verbose_eval == 0:
                    logger.info("iter %d | valid ndcg@10 %.4f", it, m)
                if m > best_metric + 1e-6:
                    best_metric, patience = m, 0
                    self.best_iteration = it
                else:
                    patience += 1
                    if patience >= self.early_stop_rounds:
                        logger.info("Early stop at iter %d (best %d)",
                                    it, self.best_iteration)
                        self.trees = self.trees[: self.best_iteration]
                        break
            else:
                self.best_iteration = it

        self._trained = True
        evals["train_ndcg@10"].append(self._ndcg10(scores, gains, offsets))
        return evals

    def _train_device(self, binned, gains, offsets, n, f, rng, valid,
                      evals, chunk_idx, chunk_mask, chunk_idx_d,
                      chunk_gains_d, chunk_mask_d, grad_fn, verbose_eval):
        """Device boosting loop: grad/hess, subsampling, histogram tree
        growth, and score updates all stay on the accelerator; only the
        finished per-tree arrays (KBs) come back per round. This is the
        catalog-scale path — the numpy grower's ~3·F·n bincount-adds per
        level put a 6.5M-row 100-tree fit beyond the 2-vCPU host budget
        (round-4 RESULTS; reference trains its LambdaMART on the same
        frame in C++, src/models/ranker.py:115-151)."""
        import jax
        import jax.numpy as jnp

        grow_fn = _make_grow_tree_device(
            f, self.n_bins, self.max_depth, self.min_child_samples,
            float(self.reg_lambda),
        )
        binned_t_d = jnp.asarray(binned.T)          # (F, n) uint8
        scores_d = jnp.zeros(n, jnp.float32)
        key = jax.random.PRNGKey(self.seed)
        lr = self.learning_rate
        logger.info("HistGBDT device backend: %d rows x %d features", n, f)

        # process packed groups in fixed slices: a single vmap over ALL
        # groups materializes (n_groups, G, G) pairwise intermediates —
        # ~12 GB at 6.5M rows / G=64 — so map over ~8k-group slices
        # (~1 GB peak) instead
        n_groups, gsz = chunk_idx.shape
        slice_g = min(8192, n_groups)
        n_slices = -(-n_groups // slice_g)
        pad_g = n_slices * slice_g - n_groups
        if pad_g:
            pad_rows = np.zeros((pad_g, gsz), chunk_idx.dtype)
            chunk_idx_sl = jnp.asarray(
                np.concatenate([chunk_idx, pad_rows])
            ).reshape(n_slices, slice_g, gsz)
            zpad = jnp.zeros((pad_g, gsz), jnp.float32)
            chunk_gains_sl = jnp.concatenate(
                [chunk_gains_d, zpad]).reshape(n_slices, slice_g, gsz)
            chunk_mask_sl = jnp.concatenate(
                [chunk_mask_d, zpad]).reshape(n_slices, slice_g, gsz)
        else:
            chunk_idx_sl = chunk_idx_d.reshape(n_slices, slice_g, gsz)
            chunk_gains_sl = chunk_gains_d.reshape(n_slices, slice_g, gsz)
            chunk_mask_sl = chunk_mask_d.reshape(n_slices, slice_g, gsz)
        flat_idx_sl = chunk_idx_sl.reshape(-1)
        flat_mask_sl = chunk_mask_sl.reshape(-1) > 0

        @jax.jit
        def round_grad(scores_dev):
            def one_slice(sl):
                idx, gains, mask = sl
                return grad_fn(scores_dev[idx], gains, mask)
            gch, hch = jax.lax.map(
                one_slice, (chunk_idx_sl, chunk_gains_sl, chunk_mask_sl))
            g = jnp.zeros(n, jnp.float32).at[flat_idx_sl].add(
                gch.reshape(-1) * flat_mask_sl)
            h = jnp.zeros(n, jnp.float32).at[flat_idx_sl].add(
                hch.reshape(-1) * flat_mask_sl)
            return g, h

        best_metric, patience = -np.inf, 0
        for it in range(1, self.n_estimators + 1):
            grad_d, hess_d = round_grad(scores_d)
            key, k1 = jax.random.split(key)
            if self.subsample < 1.0:
                # per-row bernoulli(p) instead of the numpy path's exact
                # floor(n·p) draw — identical in expectation, avoids a
                # host round-trip per round
                row_mask = jax.random.bernoulli(
                    k1, self.subsample, (n,)).astype(jnp.float32)
            else:
                row_mask = jnp.ones(n, jnp.float32)
            feats_mask = np.zeros(f, bool)
            if self.colsample < 1.0:
                feats_mask[rng.choice(
                    f, size=max(1, int(f * self.colsample)),
                    replace=False)] = True
            else:
                feats_mask[:] = True
            levels, row_value = grow_fn(
                binned_t_d, grad_d, hess_d, row_mask,
                jnp.asarray(feats_mask))
            tree = _tree_from_levels(levels, self.max_depth)
            self.trees.append(tree)
            scores_d = scores_d + lr * row_value

            if valid is not None:
                vb, gv, ov, vscores = valid
                vscores += lr * self._predict_tree(tree, vb)
                valid = (vb, gv, ov, vscores)
                m = self._ndcg10(vscores, gv, ov)
                evals["valid_ndcg@10"].append(m)
                if it % verbose_eval == 0:
                    logger.info("iter %d | valid ndcg@10 %.4f", it, m)
                if m > best_metric + 1e-6:
                    best_metric, patience = m, 0
                    self.best_iteration = it
                else:
                    patience += 1
                    if patience >= self.early_stop_rounds:
                        logger.info("Early stop at iter %d (best %d)",
                                    it, self.best_iteration)
                        self.trees = self.trees[: self.best_iteration]
                        break
            else:
                self.best_iteration = it

        self._trained = True
        scores = np.asarray(scores_d, np.float64)
        evals["train_ndcg@10"].append(self._ndcg10(scores, gains, offsets))
        return evals

    # ------------------------------------------------------------------ #

    @staticmethod
    def _predict_tree(tree: _Tree, binned: np.ndarray) -> np.ndarray:
        node = np.zeros(len(binned), np.int32)
        active = tree.feature[node] >= 0
        while active.any():
            f = tree.feature[node[active]]
            go_left = (
                binned[np.nonzero(active)[0], f] <= tree.bin_threshold[node[active]]
            )
            nxt = np.where(go_left, tree.left[node[active]],
                           tree.right[node[active]])
            node[active] = nxt
            active = tree.feature[node] >= 0
        return tree.value[node]

    def predict(self, features) -> np.ndarray:
        if not self._trained:
            raise RuntimeError("Booster not trained. Call train() or load().")
        if hasattr(features, "columns"):
            X = features[self.feature_names].values.astype(np.float32)
        else:
            X = np.asarray(features, np.float32)
        binned = self._bin(X, fit=False)
        out = np.zeros(len(X))
        for t in self.trees:
            out += self.learning_rate * self._predict_tree(t, binned)
        return out

    # --- jittable inference export ------------------------------------ #

    def export_arrays(self) -> Dict[str, np.ndarray]:
        """Flat ensemble arrays for on-device scoring: (T, max_nodes)."""
        T = len(self.trees)
        mn = max(len(t.feature) for t in self.trees)
        stack = lambda attr: np.stack(  # noqa: E731
            [np.pad(getattr(t, attr), (0, mn - len(getattr(t, attr))))
             for t in self.trees]
        )
        return {
            "feature": stack("feature").astype(np.int32),
            "bin_threshold": stack("bin_threshold").astype(np.int32),
            "left": stack("left").astype(np.int32),
            "right": stack("right").astype(np.int32),
            "value": stack("value").astype(np.float32),
            "bin_edges": self.bin_edges,
            "learning_rate": np.float32(self.learning_rate),
            "max_depth": np.int32(self.max_depth),
            "n_trees": np.int32(T),
        }

    def make_device_scorer(self):
        """Build a jittable scorer fn: (B, F) raw float features → (B,)
        ensemble scores.

        Fixed-depth descent over all trees at once: at each of max_depth
        levels, gather (feature, threshold, children) for every (row, tree)
        pair and step — no data-dependent control flow. The ensemble arrays
        are captured once (call this outside jit).
        """
        import jax.numpy as jnp

        a = self.export_arrays()
        feature = jnp.asarray(a["feature"])        # (T, M)
        thresh = jnp.asarray(a["bin_threshold"])
        left = jnp.asarray(a["left"])
        right = jnp.asarray(a["right"])
        value = jnp.asarray(a["value"])
        edges = jnp.asarray(a["bin_edges"])        # (F, n_bins-1)
        depth = int(a["max_depth"])
        lr = float(a["learning_rate"])
        T = feature.shape[0]

        def score(x):
            xb = jnp.sum(
                x[..., None] > edges[(None,) * (x.ndim - 1)], axis=-1
            ).astype(jnp.int32)                    # (..., F) bin ids
            t_ix = jnp.arange(T)
            shape = x.shape[:-1] + (T,)
            node = jnp.zeros(shape, jnp.int32)
            for _ in range(depth):
                f = feature[t_ix, node]
                th = thresh[t_ix, node]
                l_ = left[t_ix, node]
                r_ = right[t_ix, node]
                is_leaf = f < 0
                fb = jnp.take_along_axis(xb, jnp.maximum(f, 0), axis=-1)
                nxt = jnp.where(fb <= th, l_, r_)
                node = jnp.where(is_leaf, node, nxt)
            return lr * value[t_ix, node].sum(axis=-1)

        return score

    def predict_device(self, x):
        """One-shot jittable scoring (convenience; for repeated use build
        the scorer once with :meth:`make_device_scorer`)."""
        return self.make_device_scorer()(x)

    # ------------------------------------------------------------------ #

    def feature_importance(self) -> Dict[str, float]:
        """Gain importance — total split gain per feature, normalized
        (LightGBM's importance_type="gain" semantics,
        reference ranker.py:180-188)."""
        if not self._trained:
            raise RuntimeError("Booster not trained.")
        gains = np.zeros(self.n_features)
        for t in self.trees:
            mask = t.feature >= 0
            np.add.at(gains, t.feature[mask], t.gain[mask])
        total = max(gains.sum(), 1e-12)
        return dict(zip(self.feature_names, (gains / total).tolist()))

    def top_features(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.feature_importance().items(),
                      key=lambda kv: -kv[1])[:n]

    # ------------------------------------------------------------------ #

    def save(self, path: str) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        arrays = {}
        for i, t in enumerate(self.trees):
            for attr in ("feature", "bin_threshold", "left", "right",
                         "value", "gain"):
                arrays[f"t{i}_{attr}"] = getattr(t, attr)
        np.savez(p, bin_edges=self.bin_edges, **arrays)
        meta = {
            "feature_names": self.feature_names,
            "n_trees": len(self.trees),
            "learning_rate": self.learning_rate,
            "max_depth": self.max_depth,
            "n_bins": self.n_bins,
            "label_gain": list(self.label_gain),
            "best_iteration": self.best_iteration,
        }
        Path(str(p) + ".meta.json").write_text(json.dumps(meta))
        logger.info("Saved GBDT (%d trees) to %s", len(self.trees), p)

    @classmethod
    def load(cls, path: str) -> "HistGBDTRanker":
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(f"GBDT model not found: {p}")
        meta = json.loads(Path(str(p) + ".meta.json").read_text())
        model = cls(
            learning_rate=meta["learning_rate"],
            max_depth=meta["max_depth"],
            n_bins=meta["n_bins"],
            label_gain=meta["label_gain"],
        )
        model.feature_names = meta["feature_names"]
        model.best_iteration = meta["best_iteration"]
        with np.load(p) as data:
            model.bin_edges = data["bin_edges"]
            for i in range(meta["n_trees"]):
                t = _Tree(len(data[f"t{i}_feature"]))
                for attr in ("feature", "bin_threshold", "left", "right",
                             "value", "gain"):
                    if f"t{i}_{attr}" in data:
                        getattr(t, attr)[:] = data[f"t{i}_{attr}"]
                model.trees.append(t)
        model._trained = True
        return model

    def model_info(self) -> Dict:
        if not self._trained:
            return {"trained": False}
        return {
            "trained": True,
            "model_type": "hist-gbdt-lambdarank",
            "n_features": self.n_features,
            "n_trees": len(self.trees),
            "max_depth": self.max_depth,
            "best_iteration": self.best_iteration,
            "top_features": [
                {"feature": f, "importance": round(v, 6)}
                for f, v in self.top_features(10)
            ],
        }
