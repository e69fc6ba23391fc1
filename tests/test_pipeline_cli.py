"""Orchestrator/CLI tests: stage dispatch, unknown stage, skew stage,
argparse surface."""
import json

import pytest

from recommendit_tpu.config import Settings
from recommendit_tpu.pipelines.run_pipeline import (
    STAGES,
    PipelineOrchestrator,
    main,
)


class TestDispatch:
    def test_unknown_stage_raises(self, tmp_path):
        orch = PipelineOrchestrator(
            data_dir=str(tmp_path / "ml"), models_dir=str(tmp_path / "m"),
            synthetic=True,
        )
        with pytest.raises(ValueError):
            orch.run_stage("nope")

    def test_stage_list_matches_reference_plus_skew(self):
        for s in ("all", "data", "features", "load_features", "embeddings",
                  "index", "ranker", "evaluate"):
            assert s in STAGES
        assert "skew" in STAGES

    def test_stage_timing_recorded(self, tmp_path):
        orch = PipelineOrchestrator(
            data_dir=str(tmp_path / "ml"), models_dir=str(tmp_path / "m"),
            features_dir=str(tmp_path / "f"), synthetic=True,
        )
        orch.run_stage("data")
        orch.run_stage("features")
        assert orch.stage_times["data"] >= 0
        assert (tmp_path / "f" / "user_features.parquet").exists()


class TestSkewStage:
    def test_shared_contract_has_zero_skew(self, tmp_path):
        cfg = Settings(SEED=0)
        orch = PipelineOrchestrator(
            cfg=cfg,
            data_dir=str(tmp_path / "ml"), models_dir=str(tmp_path / "m"),
            features_dir=str(tmp_path / "f"), synthetic=True,
        )
        orch.run_stage("data")
        orch.run_stage("features")
        report = orch.run_stage("skew")
        assert report["max_kl"] == pytest.approx(0.0, abs=1e-9)
        assert not report["skew_detected"]
        saved = json.loads((tmp_path / "m" / "skew_report.json").read_text())
        assert saved["n_features_checked"] == 50


class TestMissingArtifacts:
    def test_evaluate_without_models_raises_clearly(self, tmp_path):
        orch = PipelineOrchestrator(
            data_dir=str(tmp_path / "ml"), models_dir=str(tmp_path / "m"),
            features_dir=str(tmp_path / "f"), synthetic=True,
        )
        orch.run_stage("data")
        with pytest.raises(FileNotFoundError):
            orch.run_stage("evaluate")


class TestCLI:
    def test_main_features_stage(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        # main() turns on the persistent compile cache; point it at a
        # temp dir so the test process keeps its own settings
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
        main([
            "--stage", "data", "--synthetic",
            "--data-dir", str(tmp_path / "ml"),
            "--models-dir", str(tmp_path / "m"),
            "--features-dir", str(tmp_path / "f"),
        ])
        assert (tmp_path / "ml" / "ratings.dat").exists()

    def test_main_rejects_bad_stage(self):
        with pytest.raises(SystemExit):
            main(["--stage", "bogus"])
