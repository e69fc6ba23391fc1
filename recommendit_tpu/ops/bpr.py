"""BPR and in-batch softmax losses.

The reference computes the in-batch BPR loss with a Python loop over the
batch building a fresh bool mask per row (``src/models/two_tower.py:132-160``)
— untraceable and O(B) kernel launches. Here :func:`in_batch_bpr_loss`
is one (B,B) matmul + masked softplus, fused by XLA, differentiated by
autodiff.

Math: with s = U Vᵀ (rows L2-normalized upstream), margins m_ij = s_ii −
s_ij, the loss is  L = Σ_{i≠j} softplus(−m_ij) / (B(B−1)) and the score
gradient is  ∂L/∂s_ij = σ(−m_ij)/(B(B−1)) for i≠j,
∂L/∂s_ii = −Σ_{j≠i} σ(−m_ij)/(B(B−1)).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def pairwise_bpr_loss(user_emb, pos_item_emb, neg_item_emb):
    """Explicit-negative BPR: −mean log σ(s_pos − s_neg)
    (reference ``two_tower.py:117-130``)."""
    pos = jnp.sum(user_emb * pos_item_emb, axis=-1)
    neg = jnp.sum(user_emb * neg_item_emb, axis=-1)
    return -jnp.mean(jax.nn.log_sigmoid(pos - neg))


def in_batch_bpr_loss(user_emb, item_emb):
    """Vectorized in-batch BPR (diagonal positives, all others negatives):
    the ``loss_mode='in_batch'`` objective."""
    b = user_emb.shape[0]
    scores = jnp.dot(user_emb, item_emb.T, preferred_element_type=jnp.float32)
    pos = jnp.diagonal(scores)
    margins = pos[:, None] - scores
    sp = jax.nn.softplus(-margins)
    off_diag = 1.0 - jnp.eye(b, dtype=sp.dtype)
    return (sp * off_diag).sum() / (b * (b - 1))


def in_batch_softmax_loss(
    user_emb,
    item_emb,
    log_q=None,
    temperature: float = 0.05,
    item_bias=None,
):
    """In-batch sampled softmax with logQ correction.

    The strongest standard retrieval objective for two-tower models
    (Yi et al. 2019, "Sampling-Bias-Corrected Neural Modeling"): each row's
    positive is the diagonal, all other in-batch items are negatives whose
    scores are corrected by their sampling probability (items enter the
    batch ∝ popularity, so ``score − log q`` de-biases the softmax).
    Temperature scaling matters because tower outputs are L2-normalized —
    raw cosine logits in [−1, 1] are too flat to separate.

    Args:
        user_emb / item_emb: (B, D) L2-normalized tower outputs.
        log_q: (B,) log sampling probability of each in-batch item (None →
            uniform, no correction).
        temperature: cosine logit divisor.
        item_bias: (B,) learned per-item score bias added to the logits —
            absorbs the user-independent (popularity) component of
            log p(i|u) that normalized cosines cannot express; served via
            the MIPS-augmented column (``MIPSIndex.build(bias=...)``).
    """
    b = user_emb.shape[0]
    scores = jnp.dot(
        user_emb, item_emb.T, preferred_element_type=jnp.float32
    ) / temperature
    if item_bias is not None:
        scores = scores + item_bias[None, :]
    if log_q is not None:
        scores = scores - log_q[None, :]
    log_probs = jax.nn.log_softmax(scores, axis=1)
    return -jnp.mean(jnp.diagonal(log_probs))
