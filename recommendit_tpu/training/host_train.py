"""Two-tower training with host-resident (>HBM) embedding tables.

Same objective surface as :class:`~recommendit_tpu.training.
train_embeddings.EmbeddingTrainer` (softmax / in_batch / pairwise, Adam +
cosine on the MLP heads, per-item bias), but the user/item embedding
TABLES never live on the device: they sit in host RAM — or a disk-backed
numpy memmap — inside :class:`HostEmbeddingTable`, and only the current
batch's rows are shipped (DLRM-style CPU offload, ``host_table.py``
module docstring). A 100M-user × dim-128 f32 table is ~51 GB — beyond any
single chip's HBM; this driver trains it on one chip.

Data flow per step (``host_table.make_host_offload_step`` with the fused
optax update — one device dispatch per step):

    host: gather rows for batch ids  ──►  device: towers fwd/bwd + dense
    host: sparse adagrad row update  ◄──  device: d(loss)/d(rows), loss

:class:`~recommendit_tpu.training.host_table.PrefetchIterator` keeps
``HOST_TABLE_PREFETCH`` batches of gathered rows in flight (host gather +
H2D overlap the device step). Prefetched gathers may read rows up to
``depth`` batches before the previous step's update lands — standard
bounded-staleness async embedding training; set depth 0 for fully
synchronous updates (the parity tests do).

The device program only ever sees (B, D) row matrices + the dense MLP
params, so the same XLA program serves ML-1M and the 100M-user config —
table scale is purely a host-memory question.

No reference equivalent — the reference's tables live inside torch
Modules on one device (``src/models/two_tower.py:27,54``).
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from recommendit_tpu.config import Settings, settings as default_settings
from recommendit_tpu.data.movielens import MovieLensData
from recommendit_tpu.models.two_tower import (
    TwoTowerModel,
    init_params,
    item_tower_from_embed,
    user_tower_from_embed,
)
from recommendit_tpu.ops.bpr import (
    in_batch_bpr_loss,
    in_batch_softmax_loss,
    pairwise_bpr_loss,
)
from recommendit_tpu.training.host_table import (
    HostEmbeddingTable,
    PrefetchIterator,
    make_host_offload_step,
)
from recommendit_tpu.training.train_embeddings import (
    build_genre_table,
    warm_start_item_bias,
)

logger = logging.getLogger(__name__)


class HostTableEmbeddingTrainer:
    """Trains the two-tower model with host-offloaded embedding tables.

    Drop-in for :class:`EmbeddingTrainer` at shapes where the tables do not
    fit in HBM; selected by ``Settings.HOST_TABLE`` in the pipeline.
    """

    def __init__(
        self,
        data: MovieLensData,
        cfg: Optional[Settings] = None,
        loss_mode: Optional[str] = None,
        model_output_path: Optional[str] = None,
        table_dir: Optional[str] = None,
    ):
        self.cfg = cfg or default_settings
        cfg = self.cfg
        self.data = data
        self.loss_mode = loss_mode or cfg.LOSS_MODE
        # None -> config default; '' -> saving explicitly disabled (a 100M-
        # user model write is ~50 GB — callers must be able to opt out)
        self.model_output_path = (
            cfg.EMBEDDING_MODEL_PATH if model_output_path is None
            else model_output_path
        )
        self.history: List[Dict] = []

        self.n_users = data.n_users
        self.n_items = data.n_items
        r = data.ratings
        pos = r[r["rating"] >= 4]
        self.pos_users = pos["user_id"].values.astype(np.int32)
        self.pos_items = pos["item_id"].values.astype(np.int32)
        self.genre_table = build_genre_table(data.movies, self.n_items)

        tdir = table_dir if table_dir is not None else (cfg.HOST_TABLE_DIR or None)
        upath = str(Path(tdir) / "user_table.npy") if tdir else None
        ipath = str(Path(tdir) / "item_table.npy") if tdir else None
        # init_scale 0.1 matches init_params' 0.1*normal device init
        self.user_table = HostEmbeddingTable(
            self.n_users + 1, cfg.EMBEDDING_DIM,
            optimizer=cfg.HOST_TABLE_OPTIMIZER, lr=cfg.HOST_TABLE_LR,
            init_scale=0.1, seed=cfg.SEED, path=upath,
        )
        self.item_table = HostEmbeddingTable(
            self.n_items + 1, cfg.EMBEDDING_DIM,
            optimizer=cfg.HOST_TABLE_OPTIMIZER, lr=cfg.HOST_TABLE_LR,
            init_scale=0.1, seed=cfg.SEED + 1, path=ipath,
        )
        # padding row 0 is zero, as in init_params; batch ids are >= 1 so
        # no update ever touches it
        self.user_table.table[0] = 0.0
        self.item_table.table[0] = 0.0

        if self.loss_mode == "pairwise":
            from recommendit_tpu.ops.seen import SeenSet

            self._rated = SeenSet(
                r["user_id"].values, r["item_id"].values, self.n_items
            )
        self._log_q = self._log_q_table()
        gb = (self.user_table.table.nbytes + self.item_table.table.nbytes) / 2**30
        logger.info(
            "HostTableTrainer: %d positives, tables (%d+%d) x %d = %.2f GiB "
            "host-side (%s), loss=%s",
            len(self.pos_users), self.n_users + 1, self.n_items + 1,
            cfg.EMBEDDING_DIM, gb, "memmap" if tdir else "RAM", self.loss_mode,
        )

    # ------------------------------------------------------------------ #

    def _log_q_table(self) -> np.ndarray:
        counts = np.bincount(self.pos_items, minlength=self.n_items + 1)
        p = counts / max(1, counts.sum())
        return np.log(np.maximum(p, 1e-12)).astype(np.float32)

    def _init_dense(self):
        """Dense (device-resident) params: the MLP heads + per-item bias.

        The bias is one scalar per item — 400 MB at 100M items vs 51 GB
        for the table — so it stays a dense device param under AdamW,
        exactly like the in-HBM trainer."""
        cfg = self.cfg
        dense = init_params(
            jax.random.PRNGKey(cfg.SEED), 1, 1,
            cfg.EMBEDDING_DIM, cfg.HIDDEN_DIM,
        )
        del dense["user_embed"], dense["item_embed"]
        # only the softmax loss reads the bias — other modes must not carry
        # a dense (n_items+1,) param under AdamW (~1.2 GB of HBM for the
        # param + two moments at a 100M-item config, all dead weight)
        if self.loss_mode == "softmax":
            dense["item_bias"] = jnp.asarray(
                warm_start_item_bias(self.pos_items, self.n_items)
            )
        return dense

    def _make_step(self, tx):
        cfg = self.cfg
        loss_mode = self.loss_mode
        cdt = jnp.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16" else None

        def loss_from_rows(dense, rows, batch):
            k1, k2 = jax.random.split(batch["key"])
            ue = user_tower_from_embed(dense, rows["u"], cfg.DROPOUT, k1, cdt)
            ie = item_tower_from_embed(
                dense, rows["i"], batch["genre_i"], cfg.DROPOUT, k2, cdt
            )
            if loss_mode == "pairwise":
                ne = item_tower_from_embed(
                    dense, rows["n"], batch["genre_n"], cfg.DROPOUT, k2, cdt
                )
                return pairwise_bpr_loss(ue, ie, ne)
            if loss_mode == "softmax":
                return in_batch_softmax_loss(
                    ue, ie, batch["log_q"], cfg.SOFTMAX_TEMPERATURE,
                    item_bias=jnp.take(dense["item_bias"], batch["i_ids"]),
                )
            return in_batch_bpr_loss(ue, ie)

        return make_host_offload_step(loss_from_rows, tx=tx)

    def _epoch_stream(self, rng: np.random.Generator, batch_size: int,
                      keys: np.ndarray):
        """Generator of (host_ids, rows, batch) triples; runs inside the
        prefetch thread so gathers overlap the device step."""
        n = len(self.pos_users)
        perm = rng.permutation(n)
        n_batches = n // batch_size
        take = n_batches * batch_size
        us = self.pos_users[perm[:take]].reshape(n_batches, batch_size)
        is_ = self.pos_items[perm[:take]].reshape(n_batches, batch_size)
        pairwise = self.loss_mode == "pairwise"
        if pairwise:
            neg = rng.integers(
                1, self.n_items + 1, size=(n_batches, batch_size)
            )
            for _ in range(4):
                bad = self._rated.contains(us, neg)
                if not bad.any():
                    break
                neg[bad] = rng.integers(1, self.n_items + 1, size=int(bad.sum()))
            neg = neg.astype(np.int32)
        for b in range(n_batches):
            u_ids, i_ids = us[b], is_[b]
            rows = {
                "u": self.user_table.gather(u_ids),
                "i": self.item_table.gather(i_ids),
            }
            batch = {
                "i_ids": i_ids,
                "genre_i": self.genre_table[i_ids],
                "log_q": self._log_q[i_ids],
                "key": keys[b],
            }
            ids = {"u": u_ids, "i": i_ids}
            if pairwise:
                n_ids = neg[b]
                rows["n"] = self.item_table.gather(n_ids)
                batch["genre_n"] = self.genre_table[n_ids]
                ids["n"] = n_ids
            yield ids, rows, batch

    # ------------------------------------------------------------------ #

    def train(self, epochs: Optional[int] = None) -> Optional[TwoTowerModel]:
        cfg = self.cfg
        epochs = epochs or cfg.TRAIN_EPOCHS
        batch_size = min(cfg.BATCH_SIZE, max(8, len(self.pos_users) // 2))
        n_batches = max(1, len(self.pos_users) // batch_size)

        dense = self._init_dense()
        schedule = optax.cosine_decay_schedule(
            cfg.LEARNING_RATE, decay_steps=max(1, epochs * n_batches)
        )
        wd_mask = {k: k != "item_bias" for k in dense}
        tx = optax.chain(
            optax.clip_by_global_norm(cfg.GRAD_CLIP_NORM),
            optax.adamw(schedule, weight_decay=cfg.WEIGHT_DECAY, mask=wd_mask),
        )
        opt_state = tx.init(dense)
        step = self._make_step(tx)

        host_rng = np.random.default_rng(cfg.SEED)
        total_examples = 0
        t_train = time.time()
        logger.info(
            "Host-table training: %d epochs x %d batches x %d batch (%s, "
            "prefetch=%d)", epochs, n_batches, batch_size, self.loss_mode,
            cfg.HOST_TABLE_PREFETCH,
        )
        for epoch in range(1, epochs + 1):
            t0 = time.time()
            keys = np.asarray(
                jax.random.split(
                    jax.random.PRNGKey(cfg.SEED + 1 + epoch), n_batches
                )
            )
            stream = self._epoch_stream(host_rng, batch_size, keys)
            if cfg.HOST_TABLE_PREFETCH > 0:
                # ship only the device-bound halves through the prefetcher;
                # host ids ride along untouched (device_put on small int
                # arrays is cheap and keeps the pytree uniform)
                stream = PrefetchIterator(
                    stream, depth=cfg.HOST_TABLE_PREFETCH
                )
            losses = []
            for ids, rows, batch in stream:
                dense, opt_state, loss, row_g = step(
                    dense, opt_state, rows, batch
                )
                self.user_table.apply_grad(
                    np.asarray(ids["u"]), np.asarray(row_g["u"])
                )
                if "n" in row_g:
                    # positive + negative item rows in ONE call: an item
                    # appearing as both accumulates into a single
                    # scatter-add, keeping apply_grad's once-per-unique-row
                    # adagrad semantics
                    self.item_table.apply_grad(
                        np.concatenate(
                            [np.asarray(ids["i"]), np.asarray(ids["n"])]
                        ),
                        np.concatenate(
                            [np.asarray(row_g["i"]), np.asarray(row_g["n"])]
                        ),
                    )
                else:
                    self.item_table.apply_grad(
                        np.asarray(ids["i"]), np.asarray(row_g["i"])
                    )
                losses.append(loss)
            loss = float(np.mean([float(x) for x in losses]))
            dt = time.time() - t0
            n_ex = n_batches * batch_size
            total_examples += n_ex
            self.history.append(
                {"epoch": epoch, "loss": loss, "seconds": dt,
                 "examples_per_s": n_ex / dt}
            )
            logger.info(
                "epoch %d/%d | loss %.4f | %.2fs | %.0f ex/s",
                epoch, epochs, loss, dt, n_ex / dt,
            )

        elapsed = time.time() - t_train
        self.examples_per_s = total_examples / max(elapsed, 1e-9)
        self._dense = dense
        logger.info(
            "Host-table training done in %.1fs (%.0f examples/s)",
            elapsed, self.examples_per_s,
        )

        model = self.to_model()
        if model is not None and self.model_output_path:
            model.save(self.model_output_path)
        return model

    # ------------------------------------------------------------------ #

    def to_model(self, max_elements: int = 200_000_000) -> Optional[TwoTowerModel]:
        """Assemble an in-HBM :class:`TwoTowerModel` when the tables fit
        (ML-scale configs); ``None`` at true >HBM scale — use
        :meth:`embed_catalog` / :meth:`embed_users` streaming instead."""
        cfg = self.cfg
        n_el = (self.n_users + self.n_items + 2) * cfg.EMBEDDING_DIM
        if n_el > max_elements:
            logger.warning(
                "to_model(): %d table elements exceed the %d budget — "
                "returning None (stream via embed_catalog)", n_el, max_elements,
            )
            return None
        params = dict(self._dense)
        if "item_bias" not in params:  # non-softmax runs train without one
            params["item_bias"] = jnp.zeros((self.n_items + 1,), jnp.float32)
        params["user_embed"] = jnp.asarray(np.asarray(self.user_table.table))
        params["item_embed"] = jnp.asarray(np.asarray(self.item_table.table))
        model = TwoTowerModel(
            n_users=self.n_users, n_items=self.n_items,
            embed_dim=cfg.EMBEDDING_DIM, hidden_dim=cfg.HIDDEN_DIM,
            dropout=cfg.DROPOUT, params=params,
        )
        item_ids = np.arange(1, self.n_items + 1, dtype=np.int32)
        model.precompute_item_embeddings(item_ids, self.genre_table[1:])
        return model

    def embed_catalog(self, batch_size: int = 8192) -> np.ndarray:
        """(n_items, D) normalized catalog embeddings, streamed through the
        device MLP head chunk-by-chunk — never materializes the table on
        device. Feeds IndexBuilder at >HBM scale."""
        fn = jax.jit(
            lambda d, rows, g: item_tower_from_embed(d, rows, g)
        )
        out = []
        for s in range(1, self.n_items + 1, batch_size):
            ids = np.arange(s, min(s + batch_size, self.n_items + 1))
            out.append(np.asarray(fn(
                self._dense,
                jnp.asarray(self.item_table.gather(ids)),
                jnp.asarray(self.genre_table[ids]),
            )))
        return np.concatenate(out, axis=0)

    def embed_users(self, user_ids: np.ndarray,
                    batch_size: int = 8192) -> np.ndarray:
        """(B, D) normalized user embeddings from host rows."""
        fn = jax.jit(lambda d, rows: user_tower_from_embed(d, rows))
        out = []
        for s in range(0, len(user_ids), batch_size):
            ids = np.asarray(user_ids[s: s + batch_size])
            out.append(np.asarray(fn(
                self._dense, jnp.asarray(self.user_table.gather(ids))
            )))
        return np.concatenate(out, axis=0)
