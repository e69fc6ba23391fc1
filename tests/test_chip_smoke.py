"""``chip_smoke.py`` phases at tiny sizes on the CPU.

The script's GPU run is its own check; here every phase function runs
the same code on small shapes (the four-card phase on 4 of the 8 virtual
CPU devices), and ``main`` must refuse a machine without a GPU.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402

TINY = cs.Sizes(
    users=150, items=120, ratings=6000, eval_users=20, http_requests=5,
    ref_users=16, engine_items=20_000, engine_dim=16, engine_k=20,
    engine_q=16, engine_q_large=32, recall_queries=8, timed_calls=2,
    bpr_batches=(64, 96), gather_rows=1000, four_card_items=4096,
    four_card_steps=3,
)
TINY_WIDTHS = dict(EMBEDDING_DIM=16, HIDDEN_DIM=32, BATCH_SIZE=128,
                   TOP_K_CANDIDATES=50, RANKER_GROUP_SIZE=32)


def _env(tmp_path, **extra):
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"), **extra)
    return env


@pytest.fixture(scope="module")
def orch(tmp_path_factory):
    work = tmp_path_factory.mktemp("smoke")
    return cs.phase_pipeline(
        work, cs.smoke_settings(TINY, 0, **TINY_WIDTHS), TINY.eval_users)


@pytest.fixture(scope="module")
def served(orch):
    return cs.phase_serve(orch, TINY.http_requests, TINY.ref_users,
                          TINY.timed_calls)


def test_pipeline_phase_trains_and_writes_artifacts(orch):
    losses = [h["loss"] for h in orch.stage_results["embeddings"]]
    assert len(losses) == TINY.train_epochs and losses[-1] < losses[0]
    for path in (orch.cfg.EMBEDDING_MODEL_PATH, orch.cfg.INDEX_PATH,
                 orch.cfg.RANKER_MODEL_PATH):
        assert Path(path).exists(), path


def test_serve_phase_answers_over_http(served):
    assert served._loaded and served._n_users == TINY.users


def test_reference_phase_agrees(served, orch):
    out = cs.phase_reference(served, orch, TINY.ref_users,
                             cpu_device=jax.devices("cpu")[0])
    assert out["retrieval_err"] <= 1e-4 and out["overlap"] > 0.9


@pytest.fixture(scope="module")
def engine_state():
    return cs.engine_data(TINY, 0), {}


@pytest.mark.parametrize("mode,dtype", cs.ENGINE_PAIRS,
                         ids=[f"{m}-{d}" for m, d in cs.ENGINE_PAIRS])
def test_engine_phase_pair(mode, dtype, engine_state):
    data, refs = engine_state
    row = cs.run_engine(mode, dtype, data, TINY, 0, "cpu", refs)
    assert row["recall"] >= cs.recall_contract(mode, dtype)


def test_engine_pairs_cover_every_valid_index():
    assert len(cs.ENGINE_PAIRS) == 11
    assert ("verified", "int8") not in cs.ENGINE_PAIRS


def test_near_tie_mismatch_rule():
    import numpy as np

    ids = np.array([[1, 2, 3]])
    sc = np.array([[3.0, 2.0, 1.0]])
    # item 4 replaces item 3 at a tie with the last score: allowed
    assert cs._near_tie_mismatch(ids, sc, np.array([[1, 2, 4]]),
                                 np.array([[3.0, 2.0, 1.0]]), 1e-3) == []
    # item 9 scores far above the other list's last score: a real miss
    assert cs._near_tie_mismatch(np.array([[9, 1, 2]]),
                                 np.array([[5.0, 3.0, 2.0]]), ids, sc,
                                 1e-3) == [0]


def test_plain_xla_phase():
    out = cs.phase_plain_xla(TINY, 0, "cpu")
    assert set(out) == {"bpr_b64_ms", "bpr_b96_ms", "gather_ms"}


def test_four_card_phase_on_virtual_devices():
    assert len(jax.devices()) >= 4
    cs.phase_four_cards(jax.devices()[:4], TINY, 0)


def test_four_card_phase_needs_four_devices():
    with pytest.raises(cs.SmokeFailure, match="4 devices"):
        cs.phase_four_cards(jax.devices()[:2], TINY, 0)


def test_device_phase_refuses_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with pytest.raises(SystemExit):
        cs.phase_device("gpu")


def test_main_exits_nonzero_on_cpu(tmp_path):
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       env=_env(tmp_path), capture_output=True, text=True,
                       timeout=300, cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_main_fails_without_the_repo(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    env = _env(tmp_path)
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=str(alone))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


SERVE_WITHOUT_OPTIONALS = """
import importlib, sys
from pathlib import Path
import chip_smoke as cs
cs.block_optional_packages()
for name in cs.OPTIONAL_PACKAGES:
    try:
        importlib.import_module(name)
    except ImportError:
        pass
    else:
        raise SystemExit(name + " still importable")
sizes = cs.Sizes(users=60, items=200, ratings=1500, eval_users=10,
                 http_requests=5, ref_users=8, timed_calls=1)
cfg = cs.smoke_settings(sizes, 0, EMBEDDING_DIM=8, HIDDEN_DIM=16,
                        BATCH_SIZE=64, TOP_K_CANDIDATES=30,
                        RANKER_GROUP_SIZE=16)
orch = cs.phase_pipeline(Path(sys.argv[1]), cfg, sizes.eval_users)
cs.phase_serve(orch, sizes.http_requests, sizes.ref_users, 1)
print("SERVE_OK")
"""


def test_serve_phase_without_optional_packages(tmp_path):
    """orbax, prometheus_client, redis, msgpack and flax unimportable:
    the pipeline and the HTTP serve phase take their fallbacks."""
    r = subprocess.run(
        [sys.executable, "-c", SERVE_WITHOUT_OPTIONALS, str(tmp_path)],
        env=_env(tmp_path), capture_output=True, text=True, timeout=600,
        cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "SERVE_OK" in r.stdout
