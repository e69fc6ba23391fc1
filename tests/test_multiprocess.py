"""Multi-process jax.distributed cluster test (SURVEY.md §5.8).

Spawns the 2-process CPU cluster driver as subprocesses — the only way to
exercise ``parallel.mesh.distributed_init`` and cross-process collectives
without real multi-host hardware. Marked slow-ish (~60 s): the cluster
bootstraps two fresh JAX runtimes.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "multiproc_smoke.py")


@pytest.mark.slow
def test_two_process_cluster(tmp_path):
    out = tmp_path / "multihost.json"
    env = dict(os.environ)
    r = subprocess.run(
        [sys.executable, SCRIPT, "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rep = json.loads(out.read_text())
    assert rep["ok"]
    assert rep["n_processes"] == 2
    assert rep["losses_identical_across_processes"]
    for p in rep["processes"]:
        assert p["global_devices"] == 8
        assert p["retrieval_ok"]
        assert p["train_losses"][-1] < p["train_losses"][0]
