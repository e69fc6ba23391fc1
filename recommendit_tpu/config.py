"""Central configuration for the recommender framework.

Mirrors the knob surface of the reference settings object
(``/root/reference/src/config.py:6-38``: 22 fields, env override, singleton)
but is a plain frozen dataclass so it can be hashed into ``jax.jit`` static
arguments and carried through pure functions without pydantic runtime cost.

Env-var override semantics match the reference (case-sensitive field names,
optional ``.env`` file in the working directory).
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional, Tuple


def _load_env_file(path: str = ".env") -> dict:
    """Parse a minimal KEY=VALUE env file (reference: pydantic env_file)."""
    out = {}
    p = Path(path)
    if not p.exists():
        return out
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, v = line.split("=", 1)
        out[k.strip()] = v.strip().strip('"').strip("'")
    return out


@dataclasses.dataclass(frozen=True)
class Settings:
    # --- Storage / artifact paths (reference src/config.py:7-10) ---
    REDIS_URL: str = "redis://localhost:6379"
    INDEX_PATH: str = "models/mips.index.npz"
    RANKER_MODEL_PATH: str = "models/ranker.msgpack"
    EMBEDDING_MODEL_PATH: str = "models/two_tower.ckpt"

    # --- Retrieval / ranking sizes (reference :11-13) ---
    TOP_K_CANDIDATES: int = 500
    TOP_K_RESULTS: int = 20
    EMBEDDING_DIM: int = 64

    # --- Data / service (reference :14-20) ---
    DATA_DIR: str = "data/ml-1m"
    LOG_LEVEL: str = "INFO"
    API_HOST: str = "0.0.0.0"
    API_PORT: int = 8000
    MODEL_VERSION: str = "1.0.0"
    CACHE_TTL_SECONDS: int = 300
    FEATURE_CACHE_TTL_SECONDS: int = 3600

    # --- Training (reference :21-26) ---
    # Fraction of interactions (earliest by time) visible to the training
    # stages. The reference README documents a 90/10 temporal split, but
    # its implementation trains the towers, features, and ranker on the
    # FULL ratings file (``train_embeddings.py:134-143``) — the test tail
    # leaks into the per-ID embeddings, which memorize test positives and
    # mask any re-ranker lift. 0.9 follows the documented protocol
    # (default); 1.0 reproduces the reference implementation's behavior.
    TRAIN_SPLIT_FRACTION: float = 0.9
    N_NEGATIVES: int = 4
    TRAIN_EPOCHS: int = 60   # reference default is 10; the logQ softmax objective
    # keeps improving to ~60+ epochs (retrieval NDCG@10 0.070 -> 0.120 on the
    # synthetic benchmark) and epochs are cheap on-chip
    BATCH_SIZE: int = 1024
    LEARNING_RATE: float = 1e-3
    WEIGHT_DECAY: float = 1e-5
    GRAD_CLIP_NORM: float = 1.0
    HIDDEN_DIM: int = 128
    DROPOUT: float = 0.2
    SEED: int = 0
    LOSS_MODE: str = "softmax"   # softmax (logQ-corrected) | in_batch | pairwise
    SOFTMAX_TEMPERATURE: float = 0.05
    # 'epoch': the whole epoch is one jitted lax.scan (fastest; default).
    # 'chunk': one jitted lax.scan over TRAIN_CHUNK_BATCHES batches —
    # amortizes dispatch ~N x without the epoch-sized XLA program that
    # hangs fragile remote-compile toolchains (the middle ground).
    # 'step': jit per batch — maximum-dispatch fallback; ~same math.
    TRAIN_JIT_SCOPE: str = "epoch"
    TRAIN_CHUNK_BATCHES: int = 32

    # --- Ranker (replaces LightGBM knobs, reference :27-29) ---
    RANKER_TYPE: str = "mlp"             # mlp (LambdaRank MLP) | gbdt (hist GBDT)
    RANKER_HIDDEN_DIMS: Tuple[int, ...] = (128, 64)
    RANKER_EPOCHS: int = 40
    RANKER_LEARNING_RATE: float = 3e-3
    RANKER_GROUP_SIZE: int = 64          # padded query group length
    RANKER_EVAL_AT: Tuple[int, ...] = (5, 10, 20)
    RANKER_LABEL_GAIN: Tuple[float, ...] = (0.0, 1.0, 3.0, 7.0, 15.0)
    RANKER_EARLY_STOP_ROUNDS: int = 5
    # Group loss: lambdarank | lambdaloss (NDCG-Loss2) | softmax (listwise)
    RANKER_LOSS_TYPE: str = "lambdarank"
    # Additionally standardize features within each query/candidate set.
    # Default on: the offline ranker meets a shifted candidate distribution
    # at serve time (inner vs serving tower) and per-set standardization is
    # the cheapest shift equalizer (-17% -> -2% serve NDCG on its own;
    # see RANKER_BLEND_RETRIEVAL for the rest of the story).
    RANKER_QUERY_NORM: bool = True
    # Fraction of each user's training negatives replaced by HARD negatives
    # mined from the retrieval model's top unrated candidates — aligns the
    # ranker's training distribution with the candidate sets it re-ranks at
    # serving time (the reference trains LightGBM on uniform unrated
    # negatives only, feature_engineering.py:260-280).
    # 0.5/300 is the synthetic-benchmark sweet spot: full-pipeline NDCG@10
    # 0.112 -> 0.134 and MRR 0.202 -> 0.245 vs uniform-only negatives
    # (frac=1.0 hurts: all-hard loses easy-negative calibration).
    # How the re-ranker's training set is built:
    #   candidates — the serving distribution: an inner temporal split
    #     trains a second tower on the history slice, retrieves the same
    #     top-K candidate lists serving produces, labels them with the
    #     held-out slice (production log-training, reconstructed offline);
    #   pairs — the reference's scheme (positives + uniform unrated
    #     negatives, feature_engineering.py:225-300), kept for parity.
    RANKER_TRAINING_MODE: str = "candidates"
    # label window within the ranker's data view (candidates mode)
    RANKER_LABEL_FRACTION: float = 0.1
    # Pool candidate frames from this many inner temporal splits, each with
    # its own inner tower (train_ranker._build_candidate_frames). >1 makes
    # the ranker robust to tower retraining — the candidate distribution it
    # meets at serving time comes from a DIFFERENT tower than any it
    # trained against, and single-fold rankers measurably overfit their
    # one inner tower's score geometry.
    RANKER_CAND_FOLDS: int = 2
    # Disk cache for per-fold candidate frames ("" = off): a fold's frame
    # depends on the data slice + inner-tower + candidate-gen knobs only,
    # so ranker-family/loss A/Bs skip the inner-tower retrains entirely.
    RANKER_FOLD_CACHE_DIR: str = ""
    # cap on candidate-mode training queries (users are subsampled past
    # this — keeps the feature frame bounded at ML-25M-scale row counts;
    # ~6k users at ML-1M scale, so a no-op there)
    RANKER_MAX_QUERIES: int = 20_000
    # negatives kept per query in candidates mode: half from the head of
    # the retrieval order (where ranking errors cost NDCG), half sampled
    # uniformly from the tail (score calibration)
    RANKER_CAND_NEGS: int = 200
    RANKER_HARD_NEG_FRAC: float = 0.5
    RANKER_HARD_NEG_POOL: int = 300      # tower top-K pool to mine from
    # Feed the two-tower similarity to the ranker as a 51st feature (the
    # reference's 50-col contract discards the retrieval signal at ranking
    # time; with it the full pipeline dominates retrieval-only).
    RANKER_USE_RETRIEVAL_SCORE: bool = True
    # Also feed log1p(candidate position among unseen candidates) as a
    # feature (candidates mode). Unlike the raw similarity, the rank's
    # distribution is IDENTICAL between ranker training (inner-tower
    # candidates) and serving (outer-tower candidates) — uniform 0..C-1
    # per query — so it transfers across the calibration shift that makes
    # raw-score features brittle.
    RANKER_USE_RETRIEVAL_RANK: bool = True
    # Serving-side score fusion: final = z(ranker) + beta * z(retrieval)
    # per candidate set (0 = pure ranker ordering). The offline ranker is
    # trained on an inner tower's candidates; the blend anchors re-ranking
    # to the serving tower's ordering so a distribution-shifted ranker
    # degrades toward retrieval quality instead of below it.
    # Default 1.0: measured on the 3k-user benchmark it turns a ranker
    # that SUBTRACTS at serve time (-17%) into +19-28% NDCG@10 over
    # retrieval-only (with query_norm + 2 candidate folds; RESULTS.md
    # round-3 quality section).
    RANKER_BLEND_RETRIEVAL: float = 1.0
    # GBDT-specific knobs (mirror the reference's LightGBM surface,
    # src/config.py:27-29)
    GBDT_N_ESTIMATORS: int = 200
    GBDT_LEARNING_RATE: float = 0.1
    GBDT_MAX_DEPTH: int = 6
    GBDT_N_BINS: int = 64

    # --- Skew detection (reference :30) ---
    SKEW_KL_THRESHOLD: float = 0.1

    # --- Synthetic dataset shape (pipeline --synthetic; no reference
    # equivalent — the reference requires the real download) ---
    SYNTH_USERS: int = 1500
    SYNTH_ITEMS: int = 1200
    SYNTH_RATINGS: int = 150_000

    # --- Criteo-style CTR config (BASELINE config #5; no reference
    # equivalent — green-field model family) ---
    CTR_EMBED_DIM: int = 16
    CTR_RETRIEVAL_DIM: int = 32
    CTR_TOP_HIDDEN: Tuple[int, ...] = (256, 128)
    CTR_EPOCHS: int = 5
    CTR_BATCH_SIZE: int = 4096
    CTR_LEARNING_RATE: float = 2e-3
    CTR_JOINT: bool = True               # end-to-end two-stage (towers share
    # the stacked embedding table with the DLRM ranker)
    CTR_RETRIEVAL_WEIGHT: float = 0.5    # lambda on the in-batch softmax term
    CTR_SOFTMAX_TEMPERATURE: float = 0.1
    # Table update path: 'sparse' = rows-boundary grads + mixed per-field
    # row-adagrad (see ops/sparse_embed.py); 'dense' = plain autodiff +
    # adam over the table.
    CTR_TABLE_UPDATE: str = "sparse"
    CTR_TABLE_LR: float = 0.05           # row-adagrad lr (sparse mode)
    CTR_SMALL_VOCAB_THRESHOLD: int = 4096

    # --- Serving options beyond the reference ---
    # Exclude items the user already interacted with (production-standard;
    # CSR sorted-key filter inside the fused serve program). The reference
    # never filters — set False for its exact serving behavior. Under the
    # temporal eval protocol seen items can never be test hits, so the
    # evaluate stage applies the same filter to ALL ladder rows when on.
    FILTER_SEEN: bool = True
    MICRO_BATCH: bool = False    # coalesce concurrent requests into one device call
    # tuned on the previous accelerator, not yet measured on the H100
    MICRO_BATCH_MAX: int = 256
    MICRO_BATCH_WAIT_MS: float = 2.0
    # Re-measure the retrieval/ranking device-time split every N fused
    # serve calls (background thread; 0 = load-time measurement only).
    # See serving/recommender.py::recalibrate_stage_split.
    STAGE_RECAL_EVERY: int = 20_000

    # --- Host-resident (larger than device memory) embedding tables (no reference equivalent;
    # DLRM-style CPU offload — training/host_train.py) ---
    HOST_TABLE: bool = False             # offload embedding tables to host RAM
    HOST_TABLE_OPTIMIZER: str = "adagrad"  # adagrad | sgd (sparse row updates)
    HOST_TABLE_LR: float = 0.05
    HOST_TABLE_DIR: str = ""             # non-empty: disk-memmapped tables
    HOST_TABLE_PREFETCH: int = 2         # gather/H2D double-buffer depth
    # (0 = fully synchronous updates)

    # --- Accelerator knobs (no reference equivalent) ---
    MESH_DATA_AXIS: str = "data"
    MESH_MODEL_AXIS: str = "model"
    # item block per streaming top-k step (tuned on the previous
    # accelerator, not yet measured on the H100)
    RETRIEVAL_BLOCK_ITEMS: int = 2048
    RETRIEVAL_BLOCK_QUERIES: int = 256   # query tile for the MIPS scan
    # corpus storage dtype: float32 | bfloat16 (half the memory) | int8
    # (quarter memory + int8 matmul, stochastic-rounding per-row
    # quantization)
    INDEX_DTYPE: str = "float32"
    # retrieval mode — the recall/speed knob the reference exposes as
    # FAISS_N_LISTS/N_PROBE (src/config.py:22-23, faiss_index.py:224):
    # exact | verified (certified-exact fast path) | approx
    # (lax.approx_max_k) | fused (window-segment maxima, 1M+ corpora)
    INDEX_MODE: str = "exact"
    COMPUTE_DTYPE: str = "float32"       # 'bfloat16' on large configs

    @classmethod
    def from_env(cls, env_file: str = ".env", **overrides) -> "Settings":
        """Build settings with env-var > env-file > default precedence."""
        file_vals = _load_env_file(env_file)
        kwargs = {}
        for f in dataclasses.fields(cls):
            raw: Optional[str] = os.environ.get(f.name, file_vals.get(f.name))
            if raw is None:
                continue
            t = f.type if isinstance(f.type, type) else None
            name = f.name
            default = getattr(cls, name)
            if isinstance(default, bool):
                kwargs[name] = raw.lower() in ("1", "true", "yes", "on")
            elif isinstance(default, int):
                kwargs[name] = int(raw)
            elif isinstance(default, float):
                kwargs[name] = float(raw)
            elif isinstance(default, tuple):
                elem = type(default[0]) if default else float
                kwargs[name] = tuple(elem(x) for x in raw.split(",") if x.strip())
            else:
                kwargs[name] = raw
            del t
        kwargs.update(overrides)
        return cls(**kwargs)

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)


# Module-level singleton, like the reference's ``settings = Settings()``.
settings = Settings.from_env()
