"""Gather-friendly packed feature rows (``features/schema.pad_packed_width``):
padding must not change the assembled features."""
import jax.numpy as jnp
import numpy as np

from recommendit_tpu.features.schema import (
    GATHER_PAD_WIDTH,
    assemble_packed_jnp,
    assemble_packed_np,
    pad_packed_width,
)


class TestPadPackedWidth:
    def test_pad_and_assembly_invariance(self):
        """Feature assembly from a gather-padded table must be IDENTICAL
        to assembly from the natural-width table (the training/serving
        skew contract extends to the padded layout)."""
        rng = np.random.default_rng(4)
        user_vec = rng.normal(size=(24,)).astype(np.float32)
        item_mat = rng.normal(size=(50, 23)).astype(np.float32)
        padded = pad_packed_width(item_mat)
        assert padded.shape == (50, GATHER_PAD_WIDTH)
        np.testing.assert_array_equal(
            assemble_packed_np(user_vec, item_mat),
            assemble_packed_np(user_vec, padded))
        np.testing.assert_array_equal(
            np.asarray(assemble_packed_jnp(jnp.asarray(user_vec),
                                           jnp.asarray(item_mat))),
            np.asarray(assemble_packed_jnp(jnp.asarray(user_vec),
                                           jnp.asarray(padded))))

    def test_noop_when_wide_enough(self):
        x = np.zeros((3, 64), np.float32)
        assert pad_packed_width(x) is x
