"""Host-resident embedding tables for training beyond device memory.

A 100M-user x dim-128 f32 table is ~51 GB — with optimizer state beyond a
single card's memory, and a large share of a few cards even row-sharded. The standard recipe (DLRM-style
CPU offload) keeps the TABLE in host RAM (optionally a numpy memmap backed
by disk) and ships only the CURRENT BATCH's rows to the device:

    host: gather rows for batch ids  ──►  device: fwd/bwd on rows
    host: sparse adagrad/sgd row update  ◄──  device: d(loss)/d(rows)

The device program never sees the table — its inputs are (B, D) row
matrices, so the XLA program is tiny and static-shape. The host update is
a dedup + scatter-add (duplicate ids within a batch accumulate, exactly
like autodiff through a gather).

:class:`PrefetchIterator` overlaps the NEXT batch's host gather + H2D copy
with the current device step (double buffering) so the device never waits
on PCIe/host memory.

No reference equivalent — the reference's tables live inside torch Modules
on one device (``src/models/two_tower.py:27,54``).
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, Optional

import jax
import numpy as np

__all__ = ["HostEmbeddingTable", "PrefetchIterator", "prefetch_to_device"]


class HostEmbeddingTable:
    """A host-RAM (or disk-memmapped) embedding table with sparse updates.

    Parameters
    ----------
    n_rows, dim : table shape.
    optimizer : 'adagrad' (default — the standard choice for sparse
        embedding updates: per-row adaptive scaling without dense moments)
        or 'sgd'.
    lr : learning rate.
    path : optional ``.npy`` path — the table is a disk-backed memmap, so
        tables larger than host RAM stream through the page cache.
    """

    def __init__(
        self,
        n_rows: int,
        dim: int,
        optimizer: str = "adagrad",
        lr: float = 0.05,
        init_scale: float = 0.05,
        seed: int = 0,
        path: Optional[str] = None,
        eps: float = 1e-8,
    ):
        self.n_rows, self.dim = int(n_rows), int(dim)
        if optimizer not in ("adagrad", "sgd"):
            raise ValueError(f"unknown optimizer {optimizer!r}")
        self.optimizer = optimizer
        self.lr = float(lr)
        self.eps = float(eps)
        # SFC64: ~14x PCG64's f32-normal fill rate on shared vCPUs — table
        # init is the startup cost at 10^10-element scale
        rng = np.random.Generator(np.random.SFC64(seed))
        if path is not None:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self.table = np.lib.format.open_memmap(
                str(p), mode="w+", dtype=np.float32,
                shape=(self.n_rows, self.dim),
            )
        else:
            self.table = np.empty((self.n_rows, self.dim), np.float32)
        # chunked f32 init: no f64 intermediate, peak extra RAM bounded —
        # a 100M x 128 table would otherwise allocate a 102 GB f64 temp
        chunk = max(1, min(self.n_rows, 1 << 20))
        for s in range(0, self.n_rows, chunk):
            e = min(self.n_rows, s + chunk)
            rng.standard_normal((e - s, self.dim), dtype=np.float32,
                                out=self.table[s:e])
            self.table[s:e] *= init_scale
        # adagrad accumulator: one scalar per row (row-wise variant — the
        # memory-frugal form used for embedding tables)
        self._accum = (
            np.zeros((self.n_rows,), np.float32)
            if optimizer == "adagrad" else None
        )
        # gather vs apply_grad can race when a PrefetchIterator thread
        # gathers ahead of the consumer's updates; the lock guarantees a
        # prefetched gather sees a CONSISTENT (possibly `depth`-stale) row
        # version, never a torn half-written one. Uncontended cost is ~100ns
        # per call — noise next to the row copies themselves.
        self._lock = threading.Lock()

    def gather(self, ids: np.ndarray) -> np.ndarray:
        """(B,) ids -> (B, D) rows (a copy — safe to ship to device)."""
        with self._lock:
            return np.ascontiguousarray(self.table[ids])

    def apply_grad(self, ids: np.ndarray, grad: np.ndarray) -> None:
        """Sparse row update. Duplicate ids within the batch accumulate
        (matching autodiff-through-gather scatter-add semantics) and each
        unique row is updated ONCE."""
        ids = np.asarray(ids)
        grad = np.asarray(grad, np.float32)
        uniq, inv = np.unique(ids, return_inverse=True)
        g = np.zeros((len(uniq), self.dim), np.float32)
        np.add.at(g, inv, grad)
        with self._lock:
            if self.optimizer == "adagrad":
                self._accum[uniq] += np.mean(g * g, axis=1)
                scale = self.lr / (np.sqrt(self._accum[uniq]) + self.eps)
                self.table[uniq] -= scale[:, None] * g
            else:
                self.table[uniq] -= self.lr * g

    # --- persistence ---------------------------------------------------- #

    def save(self, path: str) -> None:
        # np.save appends '.npy' when absent; normalize so save/load_state
        # agree for any path.
        p = Path(path)
        if p.suffix != ".npy":
            p = Path(str(p) + ".npy")
        p.parent.mkdir(parents=True, exist_ok=True)
        np.save(p, np.asarray(self.table))
        if self._accum is not None:
            np.save(str(p) + ".accum.npy", self._accum)

    def load_state(self, path: str) -> None:
        p = Path(path)
        if p.suffix != ".npy":
            p = Path(str(p) + ".npy")
        self.table[:] = np.load(p, mmap_mode="r")
        accum = Path(str(p) + ".accum.npy")
        if self._accum is not None and accum.exists():
            self._accum[:] = np.load(accum)


class PrefetchIterator:
    """Double-buffered host->device prefetcher.

    Wraps a host iterator of pytrees of numpy arrays; a background thread
    stays ``depth`` batches ahead, running the host-side work (table
    gathers, batch assembly) AND the ``jax.device_put`` H2D copy while the
    device executes the current step. Exceptions from the source iterator
    propagate on the consumer side.
    """

    _END = object()

    def __init__(self, source: Iterable, depth: int = 2,
                 device=None):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._device = device
        self._thread = threading.Thread(
            target=self._worker, args=(iter(source),), daemon=True
        )
        self._thread.start()

    def _worker(self, it: Iterator) -> None:
        try:
            for item in it:
                shipped = jax.tree_util.tree_map(
                    lambda x: jax.device_put(x, self._device), item
                )
                self._q.put(shipped)
            self._q.put(self._END)
        except BaseException as exc:  # noqa: BLE001 — re-raised on consumer
            self._q.put(exc)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item


def prefetch_to_device(source: Iterable, depth: int = 2, device=None):
    """Convenience wrapper: ``for batch in prefetch_to_device(gen()): ...``"""
    return PrefetchIterator(source, depth=depth, device=device)


def make_host_offload_step(
    loss_from_rows: Callable,
    tx=None,
) -> Callable:
    """Build the device half of a host-table training step.

    ``loss_from_rows(dense_params, row_inputs, batch) -> loss`` where
    ``row_inputs`` is a pytree of (B, D) gathered-row arrays.

    Without ``tx``: returns a jitted ``step(dense_params, row_inputs,
    batch) -> (loss, row_grads, dense_grads)`` — the caller applies
    ``dense_grads`` with its own optimizer and routes ``row_grads`` to
    :meth:`HostEmbeddingTable.apply_grad`.

    With an optax ``tx``: the dense update is fused into the same XLA
    program (one dispatch per step — dispatch overhead dominates the tiny
    row-matrix program) and the step becomes
    ``step(dense_params, opt_state, row_inputs, batch) ->
    (dense_params, opt_state, loss, row_grads)``.
    """
    if tx is None:

        def step(dense_params, row_inputs, batch):
            def f(dp, rows):
                return loss_from_rows(dp, rows, batch)

            loss, (dense_g, row_g) = jax.value_and_grad(f, argnums=(0, 1))(
                dense_params, row_inputs
            )
            return loss, row_g, dense_g

        return jax.jit(step)

    import optax

    def fused_step(dense_params, opt_state, row_inputs, batch):
        def f(dp, rows):
            return loss_from_rows(dp, rows, batch)

        loss, (dense_g, row_g) = jax.value_and_grad(f, argnums=(0, 1))(
            dense_params, row_inputs
        )
        updates, opt_state = tx.update(dense_g, opt_state, dense_params)
        dense_params = optax.apply_updates(dense_params, updates)
        return dense_params, opt_state, loss, row_g

    return jax.jit(fused_step, donate_argnums=(0, 1))
