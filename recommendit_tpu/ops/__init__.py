from recommendit_tpu.ops.bpr import (  # noqa: F401
    in_batch_bpr_loss,
    in_batch_softmax_loss,
    pairwise_bpr_loss,
)
from recommendit_tpu.ops.quantize import (  # noqa: F401
    dequantize_int8,
    quantize_int8_jnp,
)
from recommendit_tpu.ops.topk import (  # noqa: F401
    fast_topk,
    mips_topk,
    mips_topk_bound_verified,
    mips_topk_certified,
    mips_topk_dense,
    mips_topk_int8,
    mips_topk_numpy,
    mips_topk_verified,
    mips_topk_window,
    mips_topk_window_auto,
)
from recommendit_tpu.ops.sparse_embed import (  # noqa: F401
    field_split,
    sparse_adagrad_init,
    sparse_table_update,
)
