"""Device mesh + distributed initialization.

The reference is single-process/single-device (SURVEY.md §2: no
torch.distributed anywhere); scaling here is green-field:
``jax.distributed`` for multi-host process groups, a ``jax.sharding.Mesh``
with named axes ``('data', 'model')`` over the devices, and XLA
collectives over the device interconnect inserted by ``jit``/``shard_map`` from sharding
annotations.

Axis semantics:
* ``data``  — batch (data parallel); gradients all-reduce over ICI.
* ``model`` — rows of the user/item embedding tables and rows of the item
  corpus (the scaling axis of this workload is table/corpus size, not
  sequence length — SURVEY.md §5.7).
"""
from __future__ import annotations

import logging
import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-host JAX (no-op on a single host).

    Replaces the NCCL/MPI process-group layer a torch framework would
    carry; with JAX the runtime handles cross-host device visibility.
    """
    if num_processes is None or num_processes <= 1:
        logger.info("Single-process run; skipping jax.distributed init")
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    logger.info(
        "jax.distributed initialized: process %d/%d, %d local / %d global devices",
        process_id, num_processes, jax.local_device_count(), jax.device_count(),
    )


def _factor_2d(n: int, prefer_model: int) -> Tuple[int, int]:
    """Split n devices into (data, model) with model as close to
    ``prefer_model`` as divisibility allows."""
    model = math.gcd(n, prefer_model) if prefer_model > 0 else 1
    for m in range(min(prefer_model, n), 0, -1):
        if n % m == 0:
            model = m
            break
    return n // model, model


def create_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
    devices: Optional[Sequence] = None,
    prefer_model: int = 1,
) -> Mesh:
    """Build a 2-D ('data','model') mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = _factor_2d(n, prefer_model)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.asarray(devices).reshape(shape)
    mesh = Mesh(arr, tuple(axis_names))
    logger.info("Mesh %s over %d %s devices", dict(zip(axis_names, shape)),
                n, devices[0].platform)
    return mesh


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh, axis: str = MODEL_AXIS) -> NamedSharding:
    """First-dimension (row) sharding — embedding tables / item corpus."""
    return NamedSharding(mesh, P(axis))


def batch_sharded(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def params_shardings(params: dict, mesh: Mesh) -> dict:
    """Sharding tree for two-tower params: embedding tables row-sharded on
    'model', dense MLP weights replicated (they are tiny; DP handles them)."""
    out = {}
    for k in params:
        if k.endswith("_embed"):
            out[k] = row_sharded(mesh)
        else:
            out[k] = replicated(mesh)
    return out


def opt_shardings_like(params, opt_abstract, mesh: Mesh):
    """Sharding pytree for an optax state: any subtree that mirrors the
    param tree (adam's mu/nu, sgd's trace, …) inherits the param
    shardings element-wise; every other leaf (step counters, schedule
    state) is replicated.

    Needed because ``jax.jit(tx.init)(sharded_params)`` does NOT reliably
    propagate input shardings to the output — measured on the 8-device
    CPU mesh AND the 2-process cluster, the entire init output (including
    the row-sharded table's moments) lands on global device 0, silently
    un-sharding the largest state in the job. Pass the result as
    ``out_shardings`` to pin it.
    """
    pdef = jax.tree_util.tree_structure(params)
    pshard = jax.tree_util.tree_map(lambda x: x.sharding, params)
    rep = replicated(mesh)

    def rec(node):
        if jax.tree_util.tree_structure(node) == pdef:
            return pshard
        if isinstance(node, tuple):          # incl. optax NamedTuples
            children = [rec(c) for c in node]
            return (type(node)(*children) if hasattr(node, "_fields")
                    else tuple(children))
        if isinstance(node, list):
            return [rec(c) for c in node]
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return rep

    return rec(opt_abstract)


def init_opt_sharded(tx, params, mesh: Mesh):
    """``tx.init`` with every output leaf pinned to the right sharding
    (see :func:`opt_shardings_like`)."""
    abstract = jax.eval_shape(tx.init, params)
    shardings = opt_shardings_like(params, abstract, mesh)
    return jax.jit(tx.init, out_shardings=shardings)(params)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad a table so its sharded dimension divides the mesh axis."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad)
