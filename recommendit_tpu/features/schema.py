"""The ranking feature contract — single source of truth.

The reference defines its 50-column ranking feature list in
``src/features/feature_engineering.py:434-443`` and then re-implements the
assembly three separate times (offline join ``:306-370``, serving python
row-loop ``src/serving/recommender.py:224-261``, eval inline copy
``src/pipelines/run_pipeline.py:189-213``) — its own guard against
training-serving skew is that copy-paste. Here the contract lives in ONE
module with three views over the same column order:

* ``assemble_frame``      — offline (pandas) for ranker training,
* ``assemble_online``     — vectorized numpy from feature-store dicts,
* ``assemble_packed_jnp`` — on-device jnp from packed dense tables, so the
  serving path can run retrieval → featurize → rank in one jitted call.

Property tests assert all three produce identical matrices.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

# MovieLens-1M genre vocabulary, in dataset order (public dataset fact;
# reference ``feature_engineering.py:14-21``).
GENRES: List[str] = [
    "Action", "Adventure", "Animation", "Children's", "Comedy",
    "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir",
    "Horror", "Musical", "Mystery", "Romance", "Sci-Fi",
    "Thriller", "War", "Western",
]
GENRE_TO_IDX = {g: i for i, g in enumerate(GENRES)}
N_GENRES = len(GENRES)

USER_SCALAR_COLS = [
    "avg_rating", "log_rating_count", "recency_score",
    "gender_encoded", "age_normalized", "occupation_normalized",
]
ITEM_SCALAR_COLS = [
    "item_avg_rating", "item_log_rating_count", "popularity_score",
    "rating_stddev", "year_normalized",
]
INTERACTION_COLS = ["rating_diff", "user_item_popularity_ratio", "genre_affinity"]
USER_GENRE_COLS = [f"user_genre_{i}" for i in range(N_GENRES)]
ITEM_GENRE_COLS = [f"item_genre_{i}" for i in range(N_GENRES)]

# Serving-time defaults for missing features (reference
# ``recommender.py:229-240``).
USER_DEFAULTS = {
    "avg_rating": 3.5, "log_rating_count": 0.0, "recency_score": 0.5,
    "gender_encoded": 0.0, "age_normalized": 0.3, "occupation_normalized": 0.3,
}
ITEM_DEFAULTS = {
    "item_avg_rating": 3.5, "item_log_rating_count": 0.0,
    "popularity_score": 0.0, "rating_stddev": 0.0, "year_normalized": 0.5,
}

# Packed dense layouts for on-device assembly.
USER_PACKED_DIM = len(USER_SCALAR_COLS) + N_GENRES     # 24
ITEM_PACKED_DIM = len(ITEM_SCALAR_COLS) + N_GENRES     # 23
N_FEATURES = (
    len(USER_SCALAR_COLS) + len(ITEM_SCALAR_COLS) + len(INTERACTION_COLS)
    + 2 * N_GENRES
)  # 50


def feature_columns() -> List[str]:
    """The canonical 50-column ranking feature order
    (reference ``feature_engineering.py:434-443``)."""
    return (
        USER_SCALAR_COLS + ITEM_SCALAR_COLS + INTERACTION_COLS
        + USER_GENRE_COLS + ITEM_GENRE_COLS
    )


FEATURE_COLUMNS = feature_columns()
assert len(FEATURE_COLUMNS) == N_FEATURES == 50


def encode_genres(genre_str: str) -> np.ndarray:
    """Pipe-separated genre string → 18-dim multi-hot
    (reference ``feature_engineering.py:78-85``)."""
    vec = np.zeros(N_GENRES, dtype=np.float32)
    for g in str(genre_str).split("|"):
        idx = GENRE_TO_IDX.get(g)
        if idx is not None:
            vec[idx] = 1.0
    return vec


def encode_genres_matrix(genre_strs: Sequence[str]) -> np.ndarray:
    """Vectorized multi-hot encoding for a whole catalog."""
    dummies = pd.Series(genre_strs).str.get_dummies(sep="|")
    mat = np.zeros((len(genre_strs), N_GENRES), dtype=np.float32)
    for g in dummies.columns:
        idx = GENRE_TO_IDX.get(g)
        if idx is not None:
            mat[:, idx] = dummies[g].values
    return mat


# ------------------------------------------------------------------ #
# Packed dense tables (for on-device assembly)                         #
# ------------------------------------------------------------------ #

def pack_user_features(user_features: pd.DataFrame, n_users: int) -> np.ndarray:
    """Dense [n_users+1, 24] table indexed by user_id (row 0 = defaults).

    Input frame must have USER_SCALAR_COLS + a ``genre_pref`` array column
    (the output of FeatureEngineer.build_user_features).
    """
    out = np.zeros((n_users + 1, USER_PACKED_DIM), dtype=np.float32)
    out[:, : len(USER_SCALAR_COLS)] = [
        USER_DEFAULTS[c] for c in USER_SCALAR_COLS
    ]
    ids = user_features["user_id"].values.astype(np.int64)
    ok = (ids >= 1) & (ids <= n_users)
    ids = ids[ok]
    scal = user_features.loc[ok, USER_SCALAR_COLS].values.astype(np.float32)
    genre = np.stack(user_features.loc[ok, "genre_pref"].values).astype(np.float32)
    out[ids, : len(USER_SCALAR_COLS)] = scal
    out[ids, len(USER_SCALAR_COLS):] = genre
    return out


def pack_item_features(item_features: pd.DataFrame, n_items: int) -> np.ndarray:
    """Dense [n_items+1, 23] table indexed by item_id (row 0 = defaults).

    Input frame has item-side names (avg_rating / log_rating_count /
    popularity_score / rating_stddev / year_normalized + ``genre_vector``).
    """
    out = np.zeros((n_items + 1, ITEM_PACKED_DIM), dtype=np.float32)
    out[:, : len(ITEM_SCALAR_COLS)] = [
        ITEM_DEFAULTS[c] for c in ITEM_SCALAR_COLS
    ]
    src_cols = ["avg_rating", "log_rating_count", "popularity_score",
                "rating_stddev", "year_normalized"]
    ids = item_features["item_id"].values.astype(np.int64)
    ok = (ids >= 1) & (ids <= n_items)
    ids = ids[ok]
    scal = item_features.loc[ok, src_cols].values.astype(np.float32)
    genre = np.stack(item_features.loc[ok, "genre_vector"].values).astype(np.float32)
    out[ids, : len(ITEM_SCALAR_COLS)] = scal
    out[ids, len(ITEM_SCALAR_COLS):] = genre
    return out


def assemble_packed_np(user_vec: np.ndarray, item_mat: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`assemble_packed_jnp` (host-side checks/tests);
    like it, ignores trailing gather-padding columns."""
    nu, ni = len(USER_SCALAR_COLS), len(ITEM_SCALAR_COLS)
    c = item_mat.shape[0]
    u_scal, u_genre = user_vec[:nu], user_vec[nu:nu + N_GENRES]
    i_scal = item_mat[:, :ni]
    i_genre = item_mat[:, ni:ni + N_GENRES]
    rating_diff = u_scal[0] - i_scal[:, 0]
    pop_ratio = u_scal[1] / (i_scal[:, 1] + 1e-8)
    # multiply-then-sum (not BLAS matvec) so the f32 accumulation order is
    # identical to the offline pandas join — the skew stage asserts the two
    # views are bit-equal, and sgemv vs np.sum reduce in different orders
    affinity = np.sum(i_genre * u_genre, axis=1)
    return np.concatenate(
        [
            np.broadcast_to(u_scal, (c, nu)),
            i_scal,
            np.stack([rating_diff, pop_ratio, affinity], axis=1),
            np.broadcast_to(u_genre, (c, N_GENRES)),
            i_genre,
        ],
        axis=1,
    ).astype(np.float32)


GATHER_PAD_WIDTH = 64


def pad_packed_width(table, width: int = GATHER_PAD_WIDTH):
    """Zero-pad packed feature rows to a gather-friendly width.

    The 64-column (256-byte) row width was tuned on the previous
    accelerator, where random row gathers were latency-bound per row; it
    is not yet measured on the H100, whose 32-byte sectors read ~2.7x the
    bytes the 23-column rows need. ``assemble_packed_jnp`` accepts padded
    rows directly.
    """
    w = table.shape[-1]
    if w >= width:
        return table
    pad = [(0, 0)] * (table.ndim - 1) + [(0, width - w)]
    if isinstance(table, np.ndarray):
        return np.pad(table, pad)
    import jax.numpy as jnp

    return jnp.pad(table, pad)


def assemble_packed_jnp(user_vec, item_mat):
    """On-device feature assembly: (24,), (C,23+) → (C,50) in column
    order (trailing item columns beyond the 23-column contract are
    ignored, so gather-padded tables — ``pad_packed_width`` — feed in
    unchanged).

    Pure jnp so it fuses into the jitted serving path; replaces the
    reference's per-candidate python loop (``recommender.py:224-261``).
    """
    import jax.numpy as jnp

    nu, ni = len(USER_SCALAR_COLS), len(ITEM_SCALAR_COLS)
    c = item_mat.shape[0]
    u_scal, u_genre = user_vec[:nu], user_vec[nu:nu + N_GENRES]
    i_scal = item_mat[:, :ni]
    i_genre = item_mat[:, ni:ni + N_GENRES]
    rating_diff = u_scal[0] - i_scal[:, 0]
    pop_ratio = u_scal[1] / (i_scal[:, 1] + 1e-8)
    affinity = i_genre @ u_genre
    return jnp.concatenate(
        [
            jnp.broadcast_to(u_scal, (c, nu)),
            i_scal,
            jnp.stack([rating_diff, pop_ratio, affinity], axis=1),
            jnp.broadcast_to(u_genre, (c, N_GENRES)),
            i_genre,
        ],
        axis=1,
    )


# ------------------------------------------------------------------ #
# Online assembly from feature-store dicts                             #
# ------------------------------------------------------------------ #

def user_dict_to_packed(user_features: Optional[Dict[str, Any]]) -> np.ndarray:
    """Feature-store user dict → packed (24,) vector with serving defaults."""
    uf = user_features or {}
    vec = np.zeros(USER_PACKED_DIM, dtype=np.float32)
    for i, c in enumerate(USER_SCALAR_COLS):
        vec[i] = float(uf.get(c, USER_DEFAULTS[c]))
    pref = np.asarray(uf.get("genre_pref", np.zeros(N_GENRES)), dtype=np.float32)
    vec[len(USER_SCALAR_COLS): len(USER_SCALAR_COLS) + min(N_GENRES, pref.size)] = (
        pref[:N_GENRES]
    )
    return vec


def item_dict_to_packed(item_features: Optional[Dict[str, Any]]) -> np.ndarray:
    """Feature-store item dict → packed (23,) vector with serving defaults."""
    itf = item_features or {}
    vec = np.zeros(ITEM_PACKED_DIM, dtype=np.float32)
    src = ["avg_rating", "log_rating_count", "popularity_score",
           "rating_stddev", "year_normalized"]
    for i, (c, dst) in enumerate(zip(src, ITEM_SCALAR_COLS)):
        vec[i] = float(itf.get(c, ITEM_DEFAULTS[dst]))
    g = np.asarray(itf.get("genre_vector", np.zeros(N_GENRES)), dtype=np.float32)
    vec[len(ITEM_SCALAR_COLS): len(ITEM_SCALAR_COLS) + min(N_GENRES, g.size)] = (
        g[:N_GENRES]
    )
    return vec


def assemble_online(
    user_features: Optional[Dict[str, Any]],
    item_features_batch: Dict[int, Optional[Dict[str, Any]]],
    candidate_item_ids: Sequence[int],
) -> pd.DataFrame:
    """Serving-path feature assembly from store dicts (vectorized).

    Behavior-equivalent to the reference's row loop
    (``recommender.py:213-263``) including its default values, but built as
    one matrix op over all candidates.
    """
    u = user_dict_to_packed(user_features)
    items = np.stack(
        [item_dict_to_packed(item_features_batch.get(i)) for i in candidate_item_ids]
    ) if len(candidate_item_ids) else np.zeros((0, ITEM_PACKED_DIM), np.float32)
    mat = assemble_packed_np(u, items)
    df = pd.DataFrame(mat, columns=FEATURE_COLUMNS)
    df.insert(0, "item_id", list(candidate_item_ids))
    return df


# ------------------------------------------------------------------ #
# Offline assembly (training joins)                                    #
# ------------------------------------------------------------------ #

def assemble_frame(
    pairs_df: pd.DataFrame,
    user_features: pd.DataFrame,
    item_features: pd.DataFrame,
) -> pd.DataFrame:
    """Offline interaction-feature join for ranker training.

    Same outputs as the reference's ``build_interaction_features``
    (``feature_engineering.py:306-370``): user scalars + item scalars
    (renamed ``item_*``) + rating_diff / popularity ratio / genre affinity +
    expanded 2x18 genre columns, NaN→0.
    """
    # scalars round through float32 BEFORE the derived arithmetic so this
    # offline join is bit-identical to the packed f32 online/device paths
    # (the skew stage asserts max KL == 0 across all three views)
    user_scalar = user_features[["user_id"] + USER_SCALAR_COLS].astype(
        {c: np.float32 for c in USER_SCALAR_COLS}
    )
    item_scalar = item_features[
        ["item_id", "avg_rating", "log_rating_count", "popularity_score",
         "rating_stddev", "year_normalized"]
    ].rename(columns={"avg_rating": "item_avg_rating",
                      "log_rating_count": "item_log_rating_count"})
    item_scalar = item_scalar.astype(
        {c: np.float32 for c in item_scalar.columns if c != "item_id"}
    )

    keep = [c for c in ("user_id", "item_id", "label", "query_id") if c in pairs_df]
    merged = pairs_df[keep].merge(user_scalar, on="user_id", how="left")
    merged = merged.merge(item_scalar, on="item_id", how="left")

    merged["rating_diff"] = (
        merged["avg_rating"].to_numpy(np.float32)
        - merged["item_avg_rating"].to_numpy(np.float32)
    )
    merged["user_item_popularity_ratio"] = (
        merged["log_rating_count"].to_numpy(np.float32)
        / (merged["item_log_rating_count"].to_numpy(np.float32)
           + np.float32(1e-8))
    )

    ugm = np.stack(user_features["genre_pref"].values).astype(np.float32)
    user_genre_df = pd.DataFrame(ugm, columns=USER_GENRE_COLS)
    user_genre_df["user_id"] = user_features["user_id"].values
    igm = np.stack(item_features["genre_vector"].values).astype(np.float32)
    item_genre_df = pd.DataFrame(igm, columns=ITEM_GENRE_COLS)
    item_genre_df["item_id"] = item_features["item_id"].values

    merged = merged.merge(user_genre_df, on="user_id", how="left")
    merged = merged.merge(item_genre_df, on="item_id", how="left")
    # same op + dtype + accumulation order as assemble_packed_np (bit-equal
    # across the offline/online views — asserted by the skew stage)
    merged["genre_affinity"] = np.sum(
        merged[USER_GENRE_COLS].fillna(0.0).to_numpy(np.float32)
        * merged[ITEM_GENRE_COLS].fillna(0.0).to_numpy(np.float32),
        axis=1,
    )
    return merged.fillna(0.0)
