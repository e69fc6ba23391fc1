"""Multi-process ``jax.distributed`` smoke run (SURVEY.md §5.8).

Executes the code paths the virtual single-process mesh cannot:
``parallel.mesh.distributed_init`` → a REAL two-process JAX cluster (CPU
backend, 4 virtual devices per process → 8 global devices), then over a
mesh whose devices span process boundaries (collectives cross the
inter-process transport, the structural stand-in for DCN):

* the sharded DP×MP two-tower train step,
* both sharded-retrieval merge schedules (all-gather + ppermute ring),
* the sharded CTR/joint train step (row-sharded 26-field table),
* the sharded two-stage SERVE path — digest-compared against the same
  program on a single-process 8-device mesh (run separately), so the
  cross-process answer is pinned to the single-host one,
* Orbax checkpoint-resume ACROSS A CLUSTER RESTART: phase A trains 4 CTR
  steps straight and saves state at step 2; a freshly spawned cluster
  (phase B) restores and re-runs steps 2-3 — losses must match phase A's
  exactly.

Parent mode orchestrates the three cluster launches and writes
``MULTIHOST.json``; child mode joins a cluster and runs the work.

Usage:
  python scripts/multiproc_smoke.py              # parent (spawns clusters)
  python scripts/multiproc_smoke.py --out f.json # custom artifact path
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PORT = 29517
N_PROC = 2
LOCAL_DEVICES = 4
CTR_STEPS = 4
CTR_SAVE_AT = 2


# --------------------------------------------------------------------- #
# Deterministic workloads shared by the cluster children and the
# single-process reference run (everything seeded, no wall-clock).
# --------------------------------------------------------------------- #

def _ctr_setup(mesh):
    import jax
    import optax

    from recommendit_tpu.models.ctr import init_ctr_params
    from recommendit_tpu.parallel.ctr import (
        init_ctr_sharded_state,
        make_ctr_sharded_train_step,
    )

    vocab = [32] * 26
    params = init_ctr_params(
        jax.random.PRNGKey(1), vocab, embed_dim=16, bottom_hidden=32,
        top_hidden=(64, 32), retrieval_dim=16,
        pad_rows_to=int(mesh.shape["model"]),
    )
    tx = optax.adam(1e-3)
    step = make_ctr_sharded_train_step(mesh, tx, n_user_fields=8)
    params, opt_state = init_ctr_sharded_state(mesh, tx, params)
    return step, params, opt_state, tx


def _ctr_batch(step_idx: int, n_rows: int, batch: int = 16):
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(1000 + step_idx)
    dense = jnp.asarray(rng.normal(size=(batch, 13)), jnp.float32)
    ids = jnp.asarray(rng.integers(0, n_rows, size=(batch, 26)), jnp.int32)
    labels = jnp.asarray(rng.integers(0, 2, size=(batch,)), jnp.float32)
    log_q = jnp.asarray(rng.normal(size=(batch,)) - 3.0, jnp.float32)
    return dense, ids, labels, log_q




def _serve_digest(mesh) -> str:
    """Build a deterministic sharded serve call on ``mesh`` and digest its
    output — identical meshes must produce identical digests regardless of
    how many processes the devices span."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from recommendit_tpu.models.ranker import init_mlp, mlp_score
    from recommendit_tpu.models.two_tower import init_params
    from recommendit_tpu.parallel.mesh import row_sharded
    from recommendit_tpu.parallel.serve import make_sharded_serve_fn

    rng = np.random.default_rng(7)
    n_users, n_items, d = 64, 256, 16
    params = init_params(jax.random.PRNGKey(0), n_users, n_items, d, 32)
    corpus_np = rng.normal(size=(n_items, d)).astype(np.float32)
    corpus_np /= np.linalg.norm(corpus_np, axis=1, keepdims=True)
    corpus = jax.make_array_from_callback(
        corpus_np.shape, row_sharded(mesh), lambda idx: corpus_np[idx]
    )
    item_ids = jnp.arange(1, n_items + 1, dtype=jnp.int32)
    user_packed = jnp.asarray(
        rng.normal(size=(n_users + 1, 24)), jnp.float32)
    item_packed = jnp.asarray(
        rng.normal(size=(n_items + 1, 23)), jnp.float32)
    rparams = init_mlp(jax.random.PRNGKey(1), 50, (32, 16))

    serve = make_sharded_serve_fn(
        mesh, params, corpus, item_ids, user_packed, item_packed,
        lambda f: mlp_score(rparams, f), n_candidates=32, k_out=8,
        block_size=64,
    )
    uids = jnp.asarray(rng.integers(1, n_users, size=16), jnp.int32)
    outs = serve(uids)
    if jax.process_count() > 1:
        # outputs are data-sharded across processes; gather the global view
        from jax.experimental import multihost_utils

        outs = multihost_utils.process_allgather(outs, tiled=True)
    ids, scores, rvals = (np.asarray(jax.device_get(x)) for x in outs)
    h = hashlib.sha1()
    h.update(ids.astype(np.int64).tobytes())
    h.update(np.round(scores, 5).astype(np.float32).tobytes())
    h.update(np.round(rvals, 5).astype(np.float32).tobytes())
    return h.hexdigest()


def child(process_id: int, phase: str, ckpt_dir: str) -> None:
    import jax

    from recommendit_tpu.parallel.mesh import distributed_init

    distributed_init(
        coordinator_address=f"localhost:{PORT + (1 if phase == 'b' else 0)}",
        num_processes=N_PROC,
        process_id=process_id,
    )
    assert jax.process_count() == N_PROC, jax.process_count()
    assert jax.device_count() == N_PROC * LOCAL_DEVICES, jax.device_count()

    import jax.numpy as jnp
    import numpy as np
    import optax

    from recommendit_tpu.models.two_tower import init_params
    from recommendit_tpu.parallel import (
        create_mesh,
        init_sharded_state,
        make_sharded_train_step,
        row_sharded,
        sharded_mips_topk,
        sharded_mips_topk_ring,
    )

    n_dev = jax.device_count()
    mesh = create_mesh(shape=(n_dev // 4, 4))   # (data=2, model=4)

    if phase == "b":
        # ---- resume-across-restart: restore, rerun steps 2..3 -------- #
        # sharding-aware Orbax restore: every process participates, the
        # template (freshly sharded init state) carries the shardings
        from recommendit_tpu.utils.checkpoint import load_train_state

        step, p_tmpl, o_tmpl, _tx = _ctr_setup(mesh)
        n_rows = p_tmpl["embed"].shape[0]
        with open(os.path.join(ckpt_dir, "step.json")) as f:
            saved_step = json.load(f)["step"]
        assert saved_step == CTR_SAVE_AT, saved_step
        state = load_train_state(
            os.path.join(ckpt_dir, "ctr_state"),
            template={"params": p_tmpl, "opt_state": o_tmpl},
        )

        import numpy as np

        def fix(t, v):
            # Orbax restores rank-0 leaves (e.g. adam's count) onto the
            # process-local default device; re-place anything not global
            # onto the template's sharding (each process holds the full
            # local value for exactly these leaves)
            if isinstance(v, jax.Array) and \
                    len(v.sharding.device_set) == jax.device_count():
                return v
            arr = np.asarray(v)
            return jax.make_array_from_callback(
                arr.shape, t.sharding, lambda idx: arr[idx]
            )

        cparams = jax.tree_util.tree_map(fix, p_tmpl, state["params"])
        copt = jax.tree_util.tree_map(fix, o_tmpl, state["opt_state"])
        resumed = []
        for s in range(saved_step, CTR_STEPS):
            cparams, copt, loss = step(cparams, copt,
                                       _ctr_batch(s, n_rows))
            resumed.append(float(loss))
        print(json.dumps({
            "process_id": process_id,
            "process_count": jax.process_count(),
            "resumed_ctr_losses": resumed,
        }), flush=True)
        return

    n_users = n_items = 64
    d, h, batch = 16, 32, 16
    params = init_params(jax.random.PRNGKey(0), n_users - 1, n_items - 1, d, h)
    rng = np.random.default_rng(0)
    genre_table = jnp.asarray(
        (rng.random((n_items, 18)) < 0.2).astype(np.float32)
    )
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))

    step = make_sharded_train_step(mesh, tx, genre_table, dropout_rate=0.2)
    sp, so = init_sharded_state(mesh, tx, params)
    u_ids = jnp.asarray(rng.integers(1, n_users, size=batch), jnp.int32)
    i_ids = jnp.asarray(rng.integers(1, n_items, size=batch), jnp.int32)
    losses = []
    for s in range(3):
        sp, so, loss = step(sp, so, (u_ids, i_ids), jax.random.PRNGKey(s))
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"

    corpus_np = rng.normal(size=(16 * n_dev, d)).astype(np.float32)
    sharding = row_sharded(mesh)
    corpus = jax.make_array_from_callback(
        corpus_np.shape, sharding, lambda idx: corpus_np[idx]
    )
    queries = jnp.asarray(rng.normal(size=(4, d)), jnp.float32)
    vals, idx = sharded_mips_topk(queries, corpus, 8, mesh, block_size=16)
    rvals, ridx = sharded_mips_topk_ring(queries, corpus, 8, mesh,
                                         block_size=16)
    idx_h = np.asarray(jax.device_get(idx))
    ridx_h = np.asarray(jax.device_get(ridx))
    assert (idx_h == ridx_h).all(), "ring merge != all-gather merge"

    # ground truth on the host
    want = np.argsort(-(queries @ corpus_np.T), axis=1)[:, :8]
    assert (np.sort(want) == np.sort(idx_h)).all(), "sharded top-k wrong"

    # ---- sharded CTR/joint step + mid-run Orbax save ------------------ #
    cstep, cparams, copt, _tx = _ctr_setup(mesh)
    n_rows = cparams["embed"].shape[0]
    ctr_losses = []
    for s in range(CTR_STEPS):
        if s == CTR_SAVE_AT:
            # ALL processes call save (Orbax coordinates multihost writes
            # internally — a single-process save deadlocks on its global
            # barrier); the step counter rides in a plain sidecar file
            from recommendit_tpu.utils.checkpoint import save_train_state

            save_train_state(
                os.path.join(ckpt_dir, "ctr_state"),
                {"params": cparams, "opt_state": copt},
            )
            if process_id == 0:
                with open(os.path.join(ckpt_dir, "step.json"), "w") as f:
                    json.dump({"step": s}, f)
        cparams, copt, loss = cstep(cparams, copt, _ctr_batch(s, n_rows))
        ctr_losses.append(float(loss))
    assert all(np.isfinite(ctr_losses)), ctr_losses
    assert ctr_losses[-1] < ctr_losses[0], ctr_losses

    # ---- sharded two-stage serve -------------------------------------- #
    serve_digest = _serve_digest(mesh)

    print(json.dumps({
        "process_id": process_id,
        "process_count": jax.process_count(),
        "global_devices": jax.device_count(),
        "local_devices": jax.local_device_count(),
        "mesh": {"data": int(mesh.shape["data"]),
                 "model": int(mesh.shape["model"])},
        "train_losses": losses,
        "retrieval_ok": True,
        "ctr_losses": ctr_losses,
        "serve_digest": serve_digest,
    }), flush=True)


def local_ref() -> None:
    """Single-process 8-device reference: same serve program + straight
    CTR run, to pin the cross-process cluster's answers."""
    import jax

    from recommendit_tpu.parallel.mesh import create_mesh

    n_dev = jax.device_count()
    assert n_dev == N_PROC * LOCAL_DEVICES, n_dev
    mesh = create_mesh(shape=(n_dev // 4, 4))
    step, cparams, copt, _tx = _ctr_setup(mesh)
    n_rows = cparams["embed"].shape[0]
    ctr_losses = []
    for s in range(CTR_STEPS):
        cparams, copt, loss = step(cparams, copt, _ctr_batch(s, n_rows))
        ctr_losses.append(float(loss))
    print(json.dumps({
        "serve_digest": _serve_digest(mesh),
        "ctr_losses": ctr_losses,
    }), flush=True)


def _spawn(extra_args, env, n: int, timeout: int = 900):
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *extra_args(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(n)
    ]
    outs, ok = [], True
    for i, p in enumerate(procs):
        try:
            stdout, stderr = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
            ok = False
        if p.returncode != 0:
            ok = False
            print(f"--- process {i} FAILED (rc={p.returncode}) ---")
            print(stderr[-3000:])
        line = next(
            (ln for ln in stdout.splitlines() if ln.startswith("{")), None
        )
        outs.append(json.loads(line) if line else None)
    return ok and all(o is not None for o in outs), outs


def parent(out_path: str) -> None:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES}"
    )
    env["PYTHONPATH"] = REPO
    ref_env = dict(env)
    ref_env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={N_PROC * LOCAL_DEVICES}"
    )
    ckpt_dir = tempfile.mkdtemp(prefix="multihost_ckpt_")

    t0 = time.time()
    # single-process reference (8 local devices, same mesh shape)
    ok_ref, ref = _spawn(lambda i: ["--local-ref"], ref_env, 1)
    # phase A: 2-process cluster — full workload + mid-run checkpoint
    ok_a, outs = _spawn(
        lambda i: ["--process-id", str(i), "--phase", "a",
                   "--ckpt-dir", ckpt_dir], env, N_PROC)
    # phase B: FRESH 2-process cluster — restore + rerun steps 2..3
    ok_b, outs_b = _spawn(
        lambda i: ["--process-id", str(i), "--phase", "b",
                   "--ckpt-dir", ckpt_dir], env, N_PROC)

    report = {
        "ok": ok_ref and ok_a and ok_b,
        "wall_s": round(time.time() - t0, 2),
        "n_processes": N_PROC,
        "local_devices_per_process": LOCAL_DEVICES,
        "processes": outs,
        "resume_processes": outs_b,
        "single_process_reference": ref[0] if ref else None,
    }
    if report["ok"]:
        import numpy as np

        l0 = outs[0]["train_losses"]
        assert all(o["train_losses"] == l0 for o in outs), (
            "processes disagree on the global loss"
        )
        c0 = outs[0]["ctr_losses"]
        assert all(o["ctr_losses"] == c0 for o in outs), (
            "processes disagree on the CTR loss"
        )
        d0 = outs[0]["serve_digest"]
        assert all(o["serve_digest"] == d0 for o in outs), (
            "processes disagree on the serve output"
        )
        assert ref[0]["serve_digest"] == d0, (
            "cross-process serve != single-process serve"
        )
        assert np.allclose(ref[0]["ctr_losses"], c0, rtol=0, atol=1e-6), (
            "cross-process CTR losses != single-process"
        )
        r0 = outs_b[0]["resumed_ctr_losses"]
        assert all(o["resumed_ctr_losses"] == r0 for o in outs_b), (
            "resume processes disagree"
        )
        assert np.allclose(r0, c0[CTR_SAVE_AT:], rtol=0, atol=1e-6), (
            f"resumed losses {r0} != straight-run tail {c0[CTR_SAVE_AT:]}"
        )
        report["losses_identical_across_processes"] = True
        report["ctr_losses_identical_across_processes"] = True
        report["serve_digest_matches_single_process"] = True
        report["orbax_resume_across_restart_matches"] = True
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    sys.exit(0 if report["ok"] else 1)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--phase", default="a", choices=["a", "b"])
    ap.add_argument("--ckpt-dir", default="/tmp/multihost_ckpt")
    ap.add_argument("--local-ref", action="store_true")
    ap.add_argument("--out", default=os.path.join(REPO, "MULTIHOST.json"))
    args = ap.parse_args()
    if args.local_ref:
        local_ref()
    elif args.process_id is None:
        parent(args.out)
    else:
        child(args.process_id, args.phase, args.ckpt_dir)
