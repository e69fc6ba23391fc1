"""Joint two-stage CTR training (BASELINE config #5).

Trains the DLRM-shaped CTR model (``recommendit_tpu.models.ctr``) on the
synthetic Criteo-style impression log, optionally jointly with the
retrieval towers that share its stacked embedding table:

    loss = BCE(click logits)  +  lambda * click-weighted in-batch softmax

The reference trains its two stages in disconnected phases (two-tower then
LightGBM over frozen candidates, SURVEY.md §3.1); here ranking gradients
flow into the same embedding rows the retrieval towers read — the
"end-to-end two-stage" stretch configuration.

Shape discipline mirrors ``train_embeddings.EmbeddingTrainer``: each
epoch is ONE jitted ``lax.scan`` over a device-resident (n_batches, B, ...)
stack — no per-batch Python dispatch.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from recommendit_tpu.config import Settings, settings as default_settings
from recommendit_tpu.data.ctr import CTRDataset
from recommendit_tpu.evaluation.metrics import binary_auc, binary_logloss
from recommendit_tpu.models.ctr import (
    CTRModel,
    bce_loss,
    ctr_forward,
    ctr_forward_from_embed,
    item_tower_ctr,
    user_tower_ctr,
    weighted_in_batch_softmax,
)
from recommendit_tpu.ops.sparse_embed import (
    sparse_adagrad_init,
    sparse_table_update,
)
from recommendit_tpu.ops.topk import fast_topk

logger = logging.getLogger(__name__)


class CTRTrainer:
    """Trains :class:`CTRModel` on a :class:`CTRDataset`."""

    def __init__(
        self,
        data: CTRDataset,
        cfg: Optional[Settings] = None,
        joint: Optional[bool] = None,
        test_frac: float = 0.1,
        model_output_path: Optional[str] = None,
    ):
        self.cfg = cfg or default_settings
        self.joint = self.cfg.CTR_JOINT if joint is None else joint
        self.model_output_path = model_output_path
        self.train_data, self.test_data = data.split(test_frac)
        self.data = data
        self.model = CTRModel(
            vocab_sizes=data.vocab_sizes,
            embed_dim=self.cfg.CTR_EMBED_DIM,
            retrieval_dim=self.cfg.CTR_RETRIEVAL_DIM,
            top_hidden=self.cfg.CTR_TOP_HIDDEN,
            n_user_fields=data.n_user_fields,
            seed=self.cfg.SEED,
        )
        self.history: List[Dict] = []
        logger.info(
            "CTRTrainer: %d train / %d test impressions, CTR=%.3f, joint=%s",
            len(self.train_data.labels), len(self.test_data.labels),
            float(data.labels.mean()), self.joint,
        )

    # ------------------------------------------------------------------ #

    def _log_q(self) -> np.ndarray:
        """(n_items,) log empirical impression probability per item (logQ
        correction for the in-batch softmax; items enter batches by
        popularity)."""
        counts = np.bincount(self.train_data.item_ids,
                             minlength=self.data.n_items)
        p = counts / max(1, counts.sum())
        return np.log(np.maximum(p, 1e-12)).astype(np.float32)

    def _make_epoch_fn(self, tx):
        cfg = self.cfg
        joint = self.joint
        n_user_fields = self.data.n_user_fields
        lam = cfg.CTR_RETRIEVAL_WEIGHT
        temp = cfg.CTR_SOFTMAX_TEMPERATURE
        log_q_table = jnp.asarray(self._log_q())
        cdt = jnp.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16" else None

        def loss_fn(params, batch):
            dense, ids, labels, item_ids = batch
            if not joint:
                logits = ctr_forward(params, dense, ids, joint=False,
                                     compute_dtype=cdt)
                return bce_loss(logits, labels)
            logits, ue, ie = ctr_forward(
                params, dense, ids, joint=True, compute_dtype=cdt,
                n_user_fields=n_user_fields,
            )
            ret = weighted_in_batch_softmax(
                ue, ie, labels, jnp.take(log_q_table, item_ids), temp
            )
            return bce_loss(logits, labels) + lam * ret

        def epoch_fn(params, opt_state, batches):
            def step(carry, batch):
                params, opt_state = carry
                loss, grads = jax.value_and_grad(loss_fn)(params, batch)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                step, (params, opt_state), batches
            )
            return params, opt_state, jnp.mean(losses)

        return jax.jit(epoch_fn, donate_argnums=(0, 1))

    def _make_sparse_epoch_fn(self, tx):
        """Rows-boundary epoch: the dense table gradient never exists —
        grads flow to the GATHERED rows, the table updates via the mixed
        per-field row-adagrad (``ops.sparse_embed``)."""
        cfg = self.cfg
        joint = self.joint
        n_user_fields = self.data.n_user_fields
        lam = cfg.CTR_RETRIEVAL_WEIGHT
        temp = cfg.CTR_SOFTMAX_TEMPERATURE
        vocab_sizes = self.model.vocab_sizes
        log_q_table = jnp.asarray(self._log_q())

        def loss_from_rows(dense_params, rows, batch):
            dense, _, labels, item_ids = batch
            if not joint:
                logits = ctr_forward_from_embed(dense_params, dense, rows)
                return bce_loss(logits, labels)
            ue = user_tower_ctr(dense_params, rows[:, :n_user_fields])
            ie = item_tower_ctr(dense_params, rows[:, n_user_fields:])
            sim = jnp.sum(ue * ie, axis=-1)
            logits = ctr_forward_from_embed(dense_params, dense, rows, sim)
            ret = weighted_in_batch_softmax(
                ue, ie, labels, jnp.take(log_q_table, item_ids), temp
            )
            return bce_loss(logits, labels) + lam * ret

        def epoch_fn(dense_params, opt_state, table, accum, batches):
            def step(carry, batch):
                dense_params, opt_state, table, accum = carry
                ids = batch[1]
                rows = jnp.take(table, ids, axis=0)
                loss, (dg, rg) = jax.value_and_grad(
                    loss_from_rows, argnums=(0, 1)
                )(dense_params, rows, batch)
                updates, opt_state = tx.update(dg, opt_state, dense_params)
                dense_params = optax.apply_updates(dense_params, updates)
                table, accum = sparse_table_update(
                    table, accum, ids, rg, vocab_sizes,
                    lr=cfg.CTR_TABLE_LR,
                    small_threshold=cfg.CTR_SMALL_VOCAB_THRESHOLD,
                )
                return (dense_params, opt_state, table, accum), loss

            (dense_params, opt_state, table, accum), losses = jax.lax.scan(
                step, (dense_params, opt_state, table, accum), batches
            )
            return dense_params, opt_state, table, accum, jnp.mean(losses)

        return jax.jit(epoch_fn, donate_argnums=(0, 1, 2, 3))

    def _epoch_batches(self, rng: np.random.Generator, batch_size: int):
        d = self.train_data
        n = len(d.labels)
        perm = rng.permutation(n)
        n_batches = max(1, n // batch_size)
        take = n_batches * batch_size
        idx = perm[:take].reshape(n_batches, batch_size)
        ids = self.model.stack_ids(d.sparse)
        return (
            jnp.asarray(d.dense[idx]),
            jnp.asarray(ids[idx]),
            jnp.asarray(d.labels[idx]),
            jnp.asarray(d.item_ids[idx]),
        )

    # ------------------------------------------------------------------ #

    def train(self, epochs: Optional[int] = None) -> CTRModel:
        cfg = self.cfg
        epochs = epochs or cfg.CTR_EPOCHS
        n_train = len(self.train_data.labels)
        # Clamp to the dataset size: with n_train < 8 the floor of 8 would
        # make _epoch_batches try to reshape more rows than exist.
        batch_size = max(1, min(cfg.CTR_BATCH_SIZE,
                                max(8, n_train // 2), n_train))
        n_batches = max(1, len(self.train_data.labels) // batch_size)
        schedule = optax.cosine_decay_schedule(
            cfg.CTR_LEARNING_RATE, decay_steps=max(1, epochs * n_batches)
        )
        tx = optax.chain(
            optax.clip_by_global_norm(cfg.GRAD_CLIP_NORM),
            optax.adamw(schedule, weight_decay=cfg.WEIGHT_DECAY),
        )
        sparse = cfg.CTR_TABLE_UPDATE == "sparse"
        params = self.model.params
        if sparse:
            table = params["embed"]
            dense_params = {k: v for k, v in params.items() if k != "embed"}
            accum = sparse_adagrad_init(table.shape[0])
            opt_state = jax.jit(tx.init)(dense_params)
            epoch_fn = self._make_sparse_epoch_fn(tx)
        else:
            opt_state = jax.jit(tx.init)(params)
            epoch_fn = self._make_epoch_fn(tx)
        host_rng = np.random.default_rng(cfg.SEED)

        t0 = time.time()
        total = 0
        for epoch in range(1, epochs + 1):
            te = time.time()
            batches = self._epoch_batches(host_rng, batch_size)
            if sparse:
                dense_params, opt_state, table, accum, loss = epoch_fn(
                    dense_params, opt_state, table, accum, batches
                )
            else:
                params, opt_state, loss = epoch_fn(params, opt_state, batches)
            dt = time.time() - te
            # The epoch_fn donates its inputs; keep the model holding live
            # buffers after every epoch so an exception mid-training never
            # leaves it with deleted (donated) params.
            if sparse:
                merged = dict(dense_params)
                merged["embed"] = table
                self.model.params = merged
            else:
                self.model.params = params
            n_ex = batches[2].size
            total += n_ex
            self.history.append(
                {"epoch": epoch, "loss": float(loss), "seconds": dt,
                 "examples_per_s": n_ex / dt}
            )
            logger.info("ctr epoch %d/%d | loss %.4f | %.2fs | %.0f ex/s",
                        epoch, epochs, float(loss), dt, n_ex / dt)
        self.examples_per_s = total / (time.time() - t0)
        if sparse:
            params = dict(dense_params)
            params["embed"] = table
        self.model.params = params
        if self.model_output_path:
            self.model.save(self.model_output_path)
        return self.model

    # ------------------------------------------------------------------ #

    def evaluate(self, recall_ks: Tuple[int, ...] = (10, 50)) -> Dict[str, float]:
        """Held-out CTR quality (AUC, logloss) and — in joint mode — full
        catalog retrieval Recall@K of the true item for clicked test
        impressions."""
        d = self.test_data
        probs = self.model.predict_proba(d.dense, d.sparse, joint=self.joint)
        out = {
            "auc": binary_auc(d.labels, probs),
            "logloss": binary_logloss(d.labels, probs),
            "ctr": float(d.labels.mean()),
        }
        if self.joint:
            corpus = self.model.item_corpus_embeddings(
                self.data.item_field_values
            )
            clicked = d.labels > 0.5
            users = d.user_ids[clicked]
            true_items = d.item_ids[clicked]
            queries = self.model.user_query_embeddings(
                self.data.user_field_values[users]
            )
            kmax = max(recall_ks)
            _, top_idx = fast_topk(
                jnp.asarray(queries) @ jnp.asarray(corpus).T, kmax
            )
            top_idx = np.asarray(top_idx)
            for k in recall_ks:
                hits = (top_idx[:, :k] == true_items[:, None]).any(axis=1)
                out[f"recall@{k}"] = float(hits.mean())
        return out
