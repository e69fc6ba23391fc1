"""MIPS (maximum inner-product search) top-k.

Replaces the reference's FAISS IVFFlat probe (``src/models/faiss_index.py``)
with an exact matmul-first scan. Exact mode scores the corpus with true-f32
matmuls and selects via **window-max pruning** (`_windowed_exact_topk`): a
cheap per-64-item-window max pass finds the <=k windows that can possibly
hold top-k items, only those windows' scores are gathered and reduced — so
the selection cost is O(N/64 + k*64) instead of one full-width top-k.
Exact MIPS ≥ IVF recall by construction (intentional behavior difference;
the n_lists/n_probe recall knobs become unnecessary), and unlike IVF the
pruning is lossless for any input.

Also provides ``approx`` mode via ``jax.lax.approx_max_k`` (recall-targeted
top-k) when a recall-0.95 contract is acceptable, the window-segment
engine (:func:`mips_topk_window`, ``MIPSIndex(mode="fused")``), and two
certified-exact variants: ``mips_topk_certified(method='count')`` (default;
recall-targeted prefilter + count-above certificate) and ``method='bound'``
(ONE bf16-precision full pass + exact rescore of the candidates, certified
by a rigorous rounding-error bound — for high dims / bf16 corpora where
the HIGHEST-precision pass dominates). Both escalate to the windowed exact
path in-program via ``lax.cond`` when the certificate fails, so the result
is always value-exact.

The distributed (sharded-corpus) variant lives in
``recommendit_tpu.parallel.retrieval``.
"""
from __future__ import annotations

import functools
import logging
from typing import Tuple

import jax
import jax.numpy as jnp

logger = logging.getLogger(__name__)

# Exact modes score with true-f32 matmuls: a backend's default matmul
# precision may be reduced (TF32 on the GPU's tensor cores), whose score
# noise reorders deep-top-k tails — "exact" here means exact w.r.t. f32
# scores, so every exact-path dot pins precision=HIGHEST. Approx and window
# modes keep the fast default.
_EXACT = jax.lax.Precision.HIGHEST


def _score(queries, items_t, precision):
    """(Q, D) x (D, blk) score matmul with pinned precision."""
    return jnp.dot(queries, items_t, preferred_element_type=jnp.float32,
                   precision=precision)


def fast_topk(scores, k: int, recall_target: float = 1.0):
    """Top-k via ``lax.approx_max_k``. With ``recall_target=1.0`` it is
    EXACT on every backend; on the GPU and CPU XLA lowers it to an exact
    top-k whatever the target, so recall_target < 1 trades recall for
    speed only where the backend has an approximate reduction."""
    return jax.lax.approx_max_k(scores, k, recall_target=recall_target)


@functools.partial(jax.jit, static_argnums=(2, 3))
def mips_topk_dense(queries, item_embs, k: int, recall_target: float = 1.0):
    """Single-shot top-k: one matmul + top-k over the full score matrix.
    Exact at recall_target=1.0 (f32 scoring); recall_target<1 scores at
    default matmul precision (the approx mode)."""
    if recall_target >= 1.0:
        scores = _score(queries, item_embs.T, _EXACT)
        return _chunked_exact_reduce(scores, k)
    scores = _score(queries, item_embs.T, None)
    return fast_topk(scores, k, recall_target)


def _scan_topk(
    queries: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int,
    block_size: int,
    recall_target: float,
    precision=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming blocked top-k: per-block matmul + partial reduce, running
    exact merge. The full (Q, N) score matrix never materializes."""
    q, d = queries.shape
    n = item_embs.shape[0]
    bs = min(block_size, n)
    n_blocks = -(-n // bs)
    pad = n_blocks * bs - n
    items = jnp.pad(item_embs, ((0, pad), (0, 0))) if pad else item_embs

    block_k = min(k, bs)
    queries = queries.astype(jnp.float32)

    def body(carry, blk):
        vals, idxs = carry
        start = blk * bs
        block = jax.lax.dynamic_slice(items, (start, 0), (bs, d))
        scores = _score(queries, block.T, precision)  # (Q, bs)
        cols = start + jnp.arange(bs, dtype=jnp.int32)
        scores = jnp.where(cols[None, :] < n, scores, -jnp.inf)

        bvals, bsel = fast_topk(scores, block_k, recall_target)
        bidx = cols[bsel]

        cand_vals = jnp.concatenate([vals, bvals], axis=1)
        cand_idx = jnp.concatenate([idxs, bidx], axis=1)
        mvals, msel = fast_topk(cand_vals, k)   # merge is always exact
        midx = jnp.take_along_axis(cand_idx, msel, axis=1)
        return (mvals, midx), None

    init = (
        jnp.full((q, k), -jnp.inf, dtype=jnp.float32),
        jnp.zeros((q, k), dtype=jnp.int32),
    )
    (vals, idxs), _ = jax.lax.scan(body, init, jnp.arange(n_blocks))
    return vals, idxs


# Tuned on the previous accelerator, not yet measured on the H100:
_REDUCE_CHUNK = 16384  # widest row one exact top-k reduces in a single pass
_WINDOW = 64           # items per window in the window-max exact scheme
_SCORE_BUDGET = 320 * 1024 * 1024  # max Q*N f32 score entries per column chunk
# mips_topk_window_auto sizes its window so the final exact top-k sees about
# this many window maxima per query (same provenance)
_WINDOW_TARGET_CAND = 16384


def canonical_tie_order(vals: jnp.ndarray, idxs: jnp.ndarray):
    """Reorder each row's top-k into (value desc, index asc) order.

    Distinct items DO collide at exactly the same f32 score on real
    corpora (pigeonhole: a trained 62k-item catalog packs its scores into
    a ~[-0.3, 0.3] band with only ~2e7 representable f32s — the round-3
    quality-at-scale run hit ~12 such ties per 256-query batch), and the
    order ties come back in is merge-path-dependent: the ring merge's
    rotation-dependent concatenation ordered them differently than the
    single-device windowed scan. Canonicalizing makes every exact path
    element-identical (and identical to numpy's stable ``argsort(-s)``)
    wherever the returned SETS agree; only distinct items tying exactly at
    the k-th score remain set-ambiguous — values are still identical there.
    O(k log k) per row on the already-selected candidates.
    """
    order = jnp.lexsort((idxs, -vals), axis=-1)
    return (jnp.take_along_axis(vals, order, axis=-1),
            jnp.take_along_axis(idxs, order, axis=-1))


def _chunked_exact_reduce(scores, k: int):
    """Exact top-k along the last axis: reduce in <=``_REDUCE_CHUNK``-wide
    chunks, then exact-merge the chunk winners (recursing while the merge
    row is itself too wide)."""
    q, w = scores.shape
    if w <= _REDUCE_CHUNK:
        return fast_topk(scores, k, 1.0)
    nc = -(-w // _REDUCE_CHUNK)
    pad = nc * _REDUCE_CHUNK - w
    if pad:
        scores = jnp.pad(scores, ((0, 0), (0, pad)), constant_values=-jnp.inf)
    cv, ci = fast_topk(scores.reshape(q, nc, _REDUCE_CHUNK),
                       min(k, _REDUCE_CHUNK), 1.0)
    base = (jnp.arange(nc, dtype=jnp.int32) * _REDUCE_CHUNK)[None, :, None]
    gi = (ci.astype(jnp.int32) + base).reshape(q, -1)
    mv, ms = _chunked_exact_reduce(cv.reshape(q, -1), k)
    return mv, jnp.take_along_axis(gi, ms, axis=1)


def _window_maxima(scores, window: int):
    """Cut each score row into contiguous windows of ``window`` columns
    (the tail window is ``-inf``-padded) → the (Q, n_win, window) view and
    the per-window maxima (Q, n_win)."""
    q, w = scores.shape
    n_win = -(-w // window)
    pad = n_win * window - w
    if pad:
        scores = jnp.pad(scores, ((0, 0), (0, pad)), constant_values=-jnp.inf)
    s3 = scores.reshape(q, n_win, window)
    return s3, jnp.max(s3, axis=-1)


def _windowed_exact_topk(scores, k: int):
    """Exact top-k over a wide score matrix via window-max pruning.

    The row is cut into W windows of L=64 columns; per-window maxima come
    from one cheap max pass (:func:`_window_maxima`). The top-k items occupy at most k
    distinct windows and every window holding one has window-max >= the
    true k-th score, so the exact top-``wpad`` (>=k) windows BY MAX are
    guaranteed to contain the entire true top-k (ties included — see
    proof in tests/test_ops.py::TestWindowedExact). Only those windows'
    scores are gathered (wpad*L wide) and exact-reduced. No certificate or
    fallback is needed: the result is exact by construction, for any input.

    This replaces the reference's IVF pruning (faiss_index.py:68-74,113)
    with a recall-1.0 pruned scan.
    """
    q, w = scores.shape
    L = _WINDOW
    wpad = max(512, (-(-(k + 1) // 128)) * 128)
    n_win = -(-w // L)
    if n_win <= 4 * wpad:
        # pruning is degenerate: the gathered slab would be >= 1/4 of the
        # full row, so the window-max pass + gather cost more than they
        # save — go straight to the chunked exact reduce. (Logged so a
        # caller pushing k toward n/256 sees the perf envelope it's in;
        # shapes are static under jit, so this fires at trace time only.)
        if n_win > wpad:
            logger.info(
                "windowed exact top-k: k=%d keeps %d of %d windows — "
                "pruning degenerate, using chunked exact reduce", k, wpad,
                n_win,
            )
        return _chunked_exact_reduce(scores, k)
    s3, wmax = _window_maxima(scores, L)                       # (Q, n_win)
    _, widx = _chunked_exact_reduce(wmax, wpad)
    widx = widx.astype(jnp.int32)
    slab = jnp.take_along_axis(s3, widx[:, :, None], axis=1)   # (Q, wpad, L)
    mv, ms = _chunked_exact_reduce(slab.reshape(q, wpad * L), k)
    win = jnp.take_along_axis(widx, ms // L, axis=1)
    return mv, win * L + (ms % L)


def _exact_topk(queries, item_embs, k: int):
    """Exact MIPS top-k at any corpus size: f32 (HIGHEST) scoring, windowed
    pruned selection, column-chunked so the live score slab never exceeds
    ``_SCORE_BUDGET`` entries."""
    q, d = queries.shape
    n = item_embs.shape[0]
    queries = queries.astype(jnp.float32)
    chunk = max(_REDUCE_CHUNK,
                (_SCORE_BUDGET // q) // _REDUCE_CHUNK * _REDUCE_CHUNK)
    if n <= chunk:
        scores = _score(queries, item_embs.T, _EXACT)
        return _windowed_exact_topk(scores, k)

    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    items = jnp.pad(item_embs, ((0, pad), (0, 0))) if pad else item_embs

    def body(carry, blk):
        vals, idxs = carry
        start = blk * chunk
        block = jax.lax.dynamic_slice(items, (start, 0), (chunk, d))
        scores = _score(queries, block.T, _EXACT)
        cols = start + jnp.arange(chunk, dtype=jnp.int32)
        scores = jnp.where(cols[None, :] < n, scores, -jnp.inf)
        bv, bi = _windowed_exact_topk(scores, min(k, chunk))
        cand_v = jnp.concatenate([vals, bv], axis=1)
        cand_i = jnp.concatenate([idxs, bi + start], axis=1)
        mv, ms = _chunked_exact_reduce(cand_v, k)
        return (mv, jnp.take_along_axis(cand_i, ms, axis=1)), None

    init = (jnp.full((q, k), -jnp.inf, dtype=jnp.float32),
            jnp.zeros((q, k), dtype=jnp.int32))
    (vals, idxs), _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    return vals, idxs


def _count_above(
    queries: jnp.ndarray,
    item_embs: jnp.ndarray,
    tau: jnp.ndarray,
    block_size: int,
    dense: bool,
) -> jnp.ndarray:
    """Per-query count of corpus items with score STRICTLY above ``tau``.

    One extra streaming pass over the corpus (pure matmul + compare-reduce,
    memory-bound) — the price of a *proof* of exactness.
    """
    q, d = queries.shape
    n = item_embs.shape[0]
    queries = queries.astype(jnp.float32)
    if dense:
        scores = _score(queries, item_embs.T, _EXACT)
        return jnp.sum(scores > tau[:, None], axis=1).astype(jnp.int32)

    bs = min(block_size, n)
    n_blocks = -(-n // bs)
    pad = n_blocks * bs - n
    items = jnp.pad(item_embs, ((0, pad), (0, 0))) if pad else item_embs

    def body(count, blk):
        start = blk * bs
        block = jax.lax.dynamic_slice(items, (start, 0), (bs, d))
        scores = _score(queries, block.T, _EXACT)
        cols = start + jnp.arange(bs, dtype=jnp.int32)
        above = (scores > tau[:, None]) & (cols[None, :] < n)
        return count + jnp.sum(above, axis=1).astype(jnp.int32), None

    count, _ = jax.lax.scan(
        body, jnp.zeros((q,), jnp.int32), jnp.arange(n_blocks)
    )
    return count


def _verified_topk(
    queries: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int,
    block_size: int,
    oversample: int = 4,
    recall_target: float = 0.95,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Two-pass exact top-k with a machine-checked proof.

    Pass A: a recall-targeted top-k prefilter selects m=oversample*k
    candidates per query.
    Pass B: with tau = the k-th candidate's TRUE score (approx_max_k returns
    real scores of real items, it only ever *misses* items), count every
    corpus item scoring strictly above tau. The candidate top-k is exact iff
    that global count equals the count inside the candidate top-k: every
    item beating tau is accounted for, and anything tied at tau cannot
    change the top-k VALUES (replaces the reference's IVF pruning,
    ``src/models/faiss_index.py:68-74,113``, with recall-1.0 certainty).

    Returns (values (Q,k), indices (Q,k), exact (Q,) bool).
    """
    q, d = queries.shape
    n = item_embs.shape[0]
    m = min(n, max(k + 1, oversample * k))
    dense = q * n <= 256 * 1024 * 1024
    # Both passes pin precision=HIGHEST so pass-A candidate values (and tau)
    # agree bit-for-bit with pass-B scores of the same items; an ulp-level
    # divergence could only FAIL the certificate (safe fallback), never
    # falsely pass it for a genuinely missed item.
    if dense:
        scores = _score(queries.astype(jnp.float32), item_embs.T, _EXACT)
        vals_m, idx_m = fast_topk(scores, m, recall_target)
        tau = vals_m[:, k - 1]
        count = jnp.sum(scores > tau[:, None], axis=1).astype(jnp.int32)
    else:
        # keep the per-block selection ratio small: blocks at least 4x the
        # candidate count so the prefilter stays reduce-bound, not
        # select-bound
        bs_a = min(n, max(block_size, 4 * m))
        vals_m, idx_m = _scan_topk(queries, item_embs, m, bs_a,
                                   recall_target, precision=_EXACT)
        tau = vals_m[:, k - 1]
        count = _count_above(queries, item_embs, tau, block_size, dense=False)
    exact = certify_topk(vals_m, count, k)
    return vals_m[:, :k], idx_m[:, :k].astype(jnp.int32), exact


# Rigorous |f32_score - bf16_score| bound coefficient for the bound-certified
# fast path: inputs rounded to bf16 (round-to-nearest, unit roundoff u=2^-8)
# give per-product relative error <= 2u+u^2 ~= 2^-7 of |q_i||c_i|, summed and
# Cauchy-Schwarz'd to ||q||*||c||; bf16xbf16 products are exact in f32 and the
# matmul accumulates in f32 (error <= d*2^-24*||q||*||c||, absorbed — with the
# norm-computation rounding — into the 1.25 safety factor).
_BOUND_C = 1.25 * 2.0 ** -7


def _bound_verified_topk(
    queries: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int,
    m: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One cheap full pass + tiny exact rescore, with a rounding-error proof.

    Pass A scores the WHOLE corpus once at bf16 input precision (the fast
    single-pass bf16 matmul, far cheaper than the HIGHEST-precision scan)
    and selects the exact top-``m`` OF THOSE bf16 SCORES via the windowed
    pruned selection. Every non-candidate item's bf16 score is then <= theta
    (the m-th candidate's bf16 score), so its TRUE f32 score is <= theta +
    eps with eps = ``_BOUND_C * ||q|| * max_c ||c||`` — a rigorous bound on
    bf16 input-rounding error. Pass B rescores only the m candidates at
    precision=HIGHEST and takes their exact top-k; with tau = the k-th true
    score, the certificate ``theta + eps <= tau`` proves no non-candidate
    can beat (or tie past) the returned top-k values.

    Unlike :func:`_verified_topk` (count-above certificate), NEITHER pass
    runs the HIGHEST-precision matmul over the full corpus — the expensive
    proof pass is replaced by arithmetic on bounds that pass A already paid
    for. Returns (values (Q,k), indices (Q,k), exact (Q,) bool).
    """
    q, d = queries.shape
    n = item_embs.shape[0]
    queries = queries.astype(jnp.float32)
    # explicit round-to-nearest bf16 casts: the error model must not depend
    # on what a backend's DEFAULT matmul precision happens to do to f32
    # inputs (CPU keeps full f32 — actual error below the bound is fine)
    q_bf = queries.astype(jnp.bfloat16)
    chunk = max(_REDUCE_CHUNK,
                (_SCORE_BUDGET // q) // _REDUCE_CHUNK * _REDUCE_CHUNK)

    if n <= chunk:
        items_bf = item_embs.astype(jnp.bfloat16)
        scores = _score(q_bf, items_bf.T, None)            # (Q, N) f32
        pv, pi = _windowed_exact_topk(scores, m)
        max_sq = jnp.max(
            jnp.sum(jnp.square(items_bf.astype(jnp.float32)), axis=1)
        )
    else:
        n_chunks = -(-n // chunk)
        pad = n_chunks * chunk - n
        items_p = jnp.pad(item_embs, ((0, pad), (0, 0))) if pad else item_embs

        def body(carry, blk):
            vals, idxs, mx = carry
            start = blk * chunk
            block_bf = jax.lax.dynamic_slice(
                items_p, (start, 0), (chunk, d)
            ).astype(jnp.bfloat16)
            scores = _score(q_bf, block_bf.T, None)
            cols = start + jnp.arange(chunk, dtype=jnp.int32)
            scores = jnp.where(cols[None, :] < n, scores, -jnp.inf)
            bv, bi = _windowed_exact_topk(scores, min(m, chunk))
            cand_v = jnp.concatenate([vals, bv], axis=1)
            cand_i = jnp.concatenate([idxs, bi + start], axis=1)
            mv, ms = _chunked_exact_reduce(cand_v, m)
            sq = jnp.sum(jnp.square(block_bf.astype(jnp.float32)), axis=1)
            sq = jnp.where(cols < n, sq, 0.0)
            return (mv, jnp.take_along_axis(cand_i, ms, axis=1),
                    jnp.maximum(mx, jnp.max(sq))), None

        init = (jnp.full((q, m), -jnp.inf, jnp.float32),
                jnp.zeros((q, m), jnp.int32), jnp.float32(0.0))
        (pv, pi, max_sq), _ = jax.lax.scan(body, init, jnp.arange(n_chunks))

    pi = pi.astype(jnp.int32)
    theta = pv[:, m - 1]                                   # (Q,)
    q_norm = jnp.sqrt(jnp.sum(jnp.square(q_bf.astype(jnp.float32)), axis=1))
    eps = _BOUND_C * q_norm * jnp.sqrt(max_sq)             # (Q,)

    cand = jnp.take(item_embs, pi, axis=0).astype(jnp.float32)  # (Q, m, D)
    true = jnp.einsum("qmd,qd->qm", cand, queries,
                      precision=_EXACT, preferred_element_type=jnp.float32)
    tv, tsel = fast_topk(true, k, 1.0)                     # m <= 16k: exact
    ti = jnp.take_along_axis(pi, tsel, axis=1)
    tau = tv[:, k - 1]
    exact = theta + eps <= tau
    return tv, ti, exact


@functools.partial(jax.jit, static_argnums=(2, 3))
def mips_topk_bound_verified(
    queries: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int,
    m: int = 2048,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Jitted :func:`_bound_verified_topk` (exposes the per-query exactness
    certificate for callers that want to escalate themselves)."""
    return _bound_verified_topk(queries, item_embs, k, m)


def certify_topk(cand_vals: jnp.ndarray, count_above: jnp.ndarray,
                 k: int) -> jnp.ndarray:
    """Exactness certificate for a candidate top-k.

    ``cand_vals`` (Q, m>=k) are TRUE scores of candidate items sorted
    descending; ``count_above`` (Q,) is the global count of corpus items
    scoring strictly above tau = cand_vals[:, k-1]. The candidate top-k is
    value-exact iff every global above-tau item is inside the candidate
    top-k — i.e. the two counts agree (anything tied at tau is
    interchangeable by value).
    """
    tau = cand_vals[:, k - 1]
    in_cand = jnp.sum(cand_vals[:, :k] > tau[:, None], axis=1).astype(jnp.int32)
    return count_above.astype(jnp.int32) == in_cand


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def mips_topk_verified(
    queries: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int,
    block_size: int = 4096,
    oversample: int = 4,
    recall_target: float = 0.95,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Jitted :func:`_verified_topk` (exposes the per-query exactness
    certificate for callers that want to escalate themselves)."""
    return _verified_topk(queries, item_embs, k, block_size, oversample,
                          recall_target)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7))
def mips_topk_certified(
    queries: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int,
    block_size: int = 4096,
    oversample: int = 4,
    recall_target: float = 0.95,
    method: str = "count",
    canonical: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Certified-exact top-k: verified fast path with automatic escalation.

    ``method='count'`` (default) runs :func:`_verified_topk` —
    recall-targeted prefilter + count-above certificate, two full passes at
    precision=HIGHEST. ``method='bound'`` runs :func:`_bound_verified_topk`
    — ONE bf16-precision full pass + exact rescore of ``oversample*k``
    candidates, certified by a rigorous rounding-error bound, with NO
    HIGHEST-precision full-corpus matmul at all.

    Kept as API surface and as the only certified path usable on a corpus
    stored ONLY in bf16; its speed against 'count' is not yet measured on
    the H100.

    Only when ANY query's certificate fails is the whole batch recomputed
    through the windowed exact path. The escalation is a ``lax.cond``
    inside one jitted program, so the common case pays zero host
    round-trips and the result is ALWAYS value-exact — the same recall-1.0
    contract as ``mode='exact'`` at near-approx speed (replaces the
    reference's lossy IVF pruning, ``src/models/faiss_index.py:68-74,113``).

    Note: ties at the k-th score may order differently than the windowed
    path; *values* are certified exact (see :func:`certify_topk`).
    """
    n = item_embs.shape[0]
    if method == "bound":
        m = max(k + 512, oversample * k)
        if m >= n:
            ev, ei = _exact_topk(queries, item_embs, k)
            ev, ei = (ev, ei.astype(jnp.int32))
            return canonical_tie_order(ev, ei) if canonical else (ev, ei)
        vals, idx, exact = _bound_verified_topk(queries, item_embs, k, m)
    elif method == "count":
        vals, idx, exact = _verified_topk(
            queries, item_embs, k, block_size, oversample, recall_target
        )
    else:
        raise ValueError(f"unknown certified method {method!r}")

    def _keep(_):
        return vals, idx

    def _escalate(_):
        ev, ei = _exact_topk(queries, item_embs, k)
        return ev, ei.astype(idx.dtype)

    out = jax.lax.cond(jnp.all(exact), _keep, _escalate, operand=None)
    return canonical_tie_order(*out) if canonical else out


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def mips_topk(
    queries: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int,
    block_size: int = 4096,
    mode: str = "exact",
    canonical: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k over the item corpus.

    Args:
        queries: (Q, D) query vectors (L2-normalized upstream for cosine).
        item_embs: (N, D) item matrix.
        k: number of results per query (must be <= N).
        block_size: items per streamed block (approx mode only; the exact
            path sizes its own column chunks from the score-memory budget).
        mode: 'exact' — always returns the true top-k w.r.t. f32 scores
            (precision=HIGHEST matmul), via window-max pruned selection —
            exact by construction at any corpus size, no recall knob.
            'approx' — recall-0.95 ``approx_max_k`` at default (fast)
            matmul precision.
        canonical: reorder score-tied items into the deterministic
            (value desc, index asc) order (see
            :func:`canonical_tie_order`). Off by default: the lexsort is an
            extra sort per call and any tie completion is equally exact;
            turn on where cross-path element-identity matters (tests,
            sharded-vs-single-device checks, reproducibility audits).

    Returns:
        (values (Q, k), indices (Q, k)) sorted descending per query.
    """
    q, d = queries.shape
    n = item_embs.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds corpus size {n}")
    if mode == "exact":
        vals, idx = _exact_topk(queries, item_embs, k)
        return canonical_tie_order(vals, idx) if canonical else (vals, idx)
    if mode != "approx":
        # 'verified' lives in mips_topk_certified (3 outputs / cond
        # escalation); anything else is a typo — never silently degrade
        # to the 0.95-recall path
        raise ValueError(f"unknown mips_topk mode {mode!r}")

    bs = min(block_size, n)
    dense_limit = 512 * 1024 * 1024
    if n <= max(bs, k) or q * n <= dense_limit:
        return mips_topk_dense(queries, item_embs, k, 0.95)
    return _scan_topk(queries, item_embs, k, bs, 0.95)


def _quantize_queries(queries):
    """Per-row symmetric round-to-nearest int8 quantization."""
    q_abs = jnp.maximum(jnp.max(jnp.abs(queries), axis=1), 1e-12)
    q_scale = q_abs / 127.0                          # (Q,)
    q_i8 = jnp.clip(
        jnp.round(queries / q_scale[:, None]), -127, 127
    ).astype(jnp.int8)
    return q_i8, q_scale


def _score_int8(q_i8, q_scale, block_i8, s_blk):
    """int8 x int8 -> int32 matmul, magnitudes restored from the outer
    product of the per-row scale vectors."""
    raw = jax.lax.dot_general(
        q_i8, block_i8,
        (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )                                                # (Q, blk) int32
    return raw.astype(jnp.float32) * (q_scale[:, None] * s_blk[None, :])


def _exact_topk_int8(q_i8, q_scale, items_i8, item_scales, k):
    """Exact-on-int8-scores top-k, structured like :func:`_exact_topk`:
    full-row scoring in budget-sized column chunks + ONE windowed pruned
    selection per chunk. Selecting per wide row (not per 65k block) is what
    makes the f32 exact path fast — 16 per-block selections + merges cost
    ~10x the single pruned pass at (256, 1M)."""
    q, d = q_i8.shape
    n = items_i8.shape[0]
    chunk = max(_REDUCE_CHUNK,
                (_SCORE_BUDGET // q) // _REDUCE_CHUNK * _REDUCE_CHUNK)
    if n <= chunk:
        scores = _score_int8(q_i8, q_scale, items_i8, item_scales)
        return _windowed_exact_topk(scores, k)

    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    items = jnp.pad(items_i8, ((0, pad), (0, 0))) if pad else items_i8
    scales = jnp.pad(item_scales, (0, pad)) if pad else item_scales

    def body(carry, blk):
        vals, idxs = carry
        start = blk * chunk
        block = jax.lax.dynamic_slice(items, (start, 0), (chunk, d))
        s_blk = jax.lax.dynamic_slice(scales, (start,), (chunk,))
        scores = _score_int8(q_i8, q_scale, block, s_blk)
        cols = start + jnp.arange(chunk, dtype=jnp.int32)
        scores = jnp.where(cols[None, :] < n, scores, -jnp.inf)
        bv, bi = _windowed_exact_topk(scores, min(k, chunk))
        cand_v = jnp.concatenate([vals, bv], axis=1)
        cand_i = jnp.concatenate([idxs, bi + start], axis=1)
        mv, ms = _chunked_exact_reduce(cand_v, k)
        return (mv, jnp.take_along_axis(cand_i, ms, axis=1)), None

    init = (jnp.full((q, k), -jnp.inf, dtype=jnp.float32),
            jnp.zeros((q, k), dtype=jnp.int32))
    (vals, idxs), _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    return vals, idxs


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def mips_topk_int8(
    queries: jnp.ndarray,       # (Q, D) f32
    items_i8: jnp.ndarray,      # (N, D) int8 (per-row symmetric quant)
    item_scales: jnp.ndarray,   # (N,) f32
    k: int,
    block_size: int = 4096,
    mode: str = "exact",
    canonical: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k over an int8-quantized corpus.

    Queries are round-to-nearest quantized per row on the fly, the score
    is an int8 x int8 -> int32 matmul, and magnitudes are restored with
    the outer product of the two scale vectors. 4x less HBM traffic than
    the f32 scan; ranking error is bounded by the per-row quantization
    step.

    'exact' mode selects the true top-k OF THE INT8 SCORES via the same
    windowed pruning as the f32 exact path; 'approx' streams blocks
    through the recall-0.95 ``approx_max_k``.
    """
    q, d = queries.shape
    n = items_i8.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds corpus size {n}")

    q_i8, q_scale = _quantize_queries(queries)

    if mode != "approx":
        vals, idx = _exact_topk_int8(q_i8, q_scale, items_i8, item_scales, k)
        return canonical_tie_order(vals, idx) if canonical else (vals, idx)

    bs = min(block_size, n)
    n_blocks = -(-n // bs)
    pad = n_blocks * bs - n
    items = jnp.pad(items_i8, ((0, pad), (0, 0))) if pad else items_i8
    scales = jnp.pad(item_scales, (0, pad)) if pad else item_scales
    block_k = min(k, bs)

    def body(carry, blk):
        vals, idxs = carry
        start = blk * bs
        block = jax.lax.dynamic_slice(items, (start, 0), (bs, d))
        s_blk = jax.lax.dynamic_slice(scales, (start,), (bs,))
        scores = _score_int8(q_i8, q_scale, block, s_blk)
        cols = start + jnp.arange(bs, dtype=jnp.int32)
        scores = jnp.where(cols[None, :] < n, scores, -jnp.inf)
        bvals, bsel = fast_topk(scores, block_k, 0.95)
        bidx = cols[bsel]
        cand_vals = jnp.concatenate([vals, bvals], axis=1)
        cand_idx = jnp.concatenate([idxs, bidx], axis=1)
        mvals, msel = fast_topk(cand_vals, k)
        midx = jnp.take_along_axis(cand_idx, msel, axis=1)
        return (mvals, midx), None

    init = (
        jnp.full((q, k), -jnp.inf, dtype=jnp.float32),
        jnp.zeros((q, k), dtype=jnp.int32),
    )
    if n_blocks == 1:
        (vals, idxs), _ = body(init, jnp.asarray(0, jnp.int32))
        return vals, idxs
    (vals, idxs), _ = jax.lax.scan(body, init, jnp.arange(n_blocks))
    return vals, idxs


def _window_argmax(scores, window: int):
    """Per-window maxima and first-occurrence in-window argmax of each score
    row: (Q, N) → ((Q, n_win) f32, (Q, n_win) int32)."""
    s3, wmax = _window_maxima(scores, window)
    return wmax, jnp.argmax(s3, axis=-1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "window"))
def mips_topk_window(
    queries: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int,
    window: int = 64,
    scales: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Window-segment MIPS top-k (the ``MIPSIndex(mode="fused")`` engine).

    The corpus is cut into contiguous windows of ``window`` items. Each
    query scores every item at default matmul precision, keeps each
    window's maximum and its first-occurrence position, then takes the
    exact top-k over the N/W window maxima. A top-k item is lost only when
    a larger top-k item shares its window, so the expected recall is the
    bin model ≈ 1 − (k−1)·W/(2N) (``window=1`` is exact). The column
    chunking bounds the live score slab like :func:`_exact_topk`.

    Args:
        queries: (Q, D) float queries.
        item_embs: (N, D) corpus: float32, bfloat16 (queries are cast to
            bf16 and accumulate in f32), or int8 with ``scales``.
        scales: (N,) f32 per-row dequantization scales of an int8 corpus
            (``ops.quantize``); the scores are then the int8 x int8 scores
            of :func:`mips_topk_int8`.

    Returns (values (Q, k), indices (Q, k)), sorted descending.
    """
    q = queries.shape[0]
    n = item_embs.shape[0]
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if k > -(-n // window):
        raise ValueError(
            f"k={k} exceeds candidate count {-(-n // window)} "
            f"(N={n}, window={window}); lower `window`"
        )
    if scales is not None:
        if scales.shape[0] != n:
            raise ValueError("scales length mismatch")
        q_i8, q_scale = _quantize_queries(queries.astype(jnp.float32))

        def score(block, s_blk):
            return _score_int8(q_i8, q_scale, block, s_blk)
    else:
        qv = queries.astype(
            jnp.bfloat16 if item_embs.dtype == jnp.bfloat16 else jnp.float32)

        def score(block, _):
            return _score(qv, block.T, None)

    chunk = max(_REDUCE_CHUNK,
                (_SCORE_BUDGET // q) // _REDUCE_CHUNK * _REDUCE_CHUNK)
    chunk = max(window, chunk // window * window)
    if n <= chunk:
        scores = score(item_embs, scales)
        wmax, warg = _window_argmax(scores, window)
    else:
        n_chunks = -(-n // chunk)
        pad = n_chunks * chunk - n
        d = item_embs.shape[1]
        items = jnp.pad(item_embs, ((0, pad), (0, 0))) if pad else item_embs
        if scales is not None and pad:
            scales = jnp.pad(scales, (0, pad))

        def body(_, blk):
            start = blk * chunk
            block = jax.lax.dynamic_slice(items, (start, 0), (chunk, d))
            s_blk = (None if scales is None
                     else jax.lax.dynamic_slice(scales, (start,), (chunk,)))
            cols = start + jnp.arange(chunk, dtype=jnp.int32)
            scores = jnp.where(cols[None, :] < n, score(block, s_blk),
                               -jnp.inf)
            return None, _window_argmax(scores, window)

        _, (wmax, warg) = jax.lax.scan(body, None, jnp.arange(n_chunks))
        # (n_chunks, Q, chunk/W) → (Q, n_chunks*chunk/W): column c is the
        # global window id c
        wmax = wmax.transpose(1, 0, 2).reshape(q, -1)
        warg = warg.transpose(1, 0, 2).reshape(q, -1)
    vals, sel = _chunked_exact_reduce(wmax, k)
    idx = sel * window + jnp.take_along_axis(warg, sel, axis=1)
    return vals, idx.astype(jnp.int32)


def window_for(n: int, k: int) -> int:
    """Window size :func:`mips_topk_window_auto` uses for an ``n``-row
    corpus: the power of two that leaves at most ``_WINDOW_TARGET_CAND``
    window maxima per query, clamped to [8, 512], then halved until the
    candidates cover ``max(k, 4·window)``. Below 8 the caller scans
    exactly. The recall model ≈ 1 − (k−1)·W/(2N) improves with N at a
    fixed N/W."""
    ratio = -(-n // _WINDOW_TARGET_CAND)
    window = 1 << max(0, ratio - 1).bit_length()
    window = max(8, min(512, window))
    while window > 1 and n // window < max(k, 4 * window):
        window //= 2
    return window


def mips_topk_window_auto(
    queries: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int,
    scales: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``MIPSIndex(mode="fused")`` entry: sizes the window from the corpus
    (:func:`window_for`) and runs :func:`mips_topk_window`; corpora too
    small for a window of 8 take the exact scan (recall 1.0). With
    ``scales`` the corpus is int8. Shape logic is Python on static
    shapes, so it is safe under jit."""
    window = window_for(item_embs.shape[0], k)
    if window < 8:
        if scales is not None:
            return mips_topk_int8(queries, item_embs, scales, k, 4096,
                                  "exact")
        return mips_topk(queries, item_embs.astype(jnp.float32), k, 4096,
                         "exact")
    return mips_topk_window(queries, item_embs, k, window, scales)


def mips_topk_numpy(queries, item_embs, k: int):
    """Host-side numpy reference for tests."""
    import numpy as np

    scores = np.asarray(queries, np.float64) @ np.asarray(item_embs, np.float64).T
    # stable sort -> score-tied items come back index-ascending, matching
    # canonical_tie_order's (value desc, index asc) contract
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, idx, axis=1)
    return vals.astype(np.float32), idx.astype(np.int32)
