# recommendit_tpu — stage targets mirror the reference Makefile surface
# (train/serve/test/docker/lint; reference Makefile:29-123).

PY ?= python
DATA_DIR ?= data/ml-1m
MODELS_DIR ?= models
FEATURES_DIR ?= data/features
CPU_ENV = env JAX_PLATFORMS=cpu
MESH_ENV = env JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8

.PHONY: help data features load-features embeddings index ranker evaluate \
        train all serve test test-features test-models test-api test-parallel \
        test-coverage bench smoke smoke-four-cards dryrun lint format type-check clean native \
        docker-up docker-down docker-build docker-logs docker-restart

help:
	@grep -E '^[a-z-]+:' Makefile | sed 's/:.*//' | sort -u

# ---- pipeline stages -------------------------------------------------- #
data:
	$(PY) -m recommendit_tpu.pipelines.run_pipeline --stage data --data-dir $(DATA_DIR) --models-dir $(MODELS_DIR) --features-dir $(FEATURES_DIR)

features:
	$(PY) -m recommendit_tpu.pipelines.run_pipeline --stage features --data-dir $(DATA_DIR) --models-dir $(MODELS_DIR) --features-dir $(FEATURES_DIR)

load-features:
	$(PY) -m recommendit_tpu.pipelines.run_pipeline --stage load_features --data-dir $(DATA_DIR) --models-dir $(MODELS_DIR) --features-dir $(FEATURES_DIR)

embeddings:
	$(PY) -m recommendit_tpu.pipelines.run_pipeline --stage embeddings --data-dir $(DATA_DIR) --models-dir $(MODELS_DIR) --features-dir $(FEATURES_DIR)

index:
	$(PY) -m recommendit_tpu.pipelines.run_pipeline --stage index --data-dir $(DATA_DIR) --models-dir $(MODELS_DIR) --features-dir $(FEATURES_DIR)

ranker:
	$(PY) -m recommendit_tpu.pipelines.run_pipeline --stage ranker --data-dir $(DATA_DIR) --models-dir $(MODELS_DIR) --features-dir $(FEATURES_DIR)

evaluate:
	$(PY) -m recommendit_tpu.pipelines.run_pipeline --stage evaluate --data-dir $(DATA_DIR) --models-dir $(MODELS_DIR) --features-dir $(FEATURES_DIR)

train: all
all:
	$(PY) -m recommendit_tpu.pipelines.run_pipeline --stage all --data-dir $(DATA_DIR) --models-dir $(MODELS_DIR) --features-dir $(FEATURES_DIR)

# turnkey real-data parity run: download -> full pipeline -> REALDATA.json
# parity report vs the reference ladder (README.md:34-38). Falls back to
# the golden ml-1m-format fixture when egress is blocked so the whole
# code path still executes (report marked non-comparable).
real-data:
	$(CPU_ENV) $(PY) scripts/real_data.py --data-dir $(DATA_DIR) \
	  --models-dir $(MODELS_DIR)/real --features-dir $(FEATURES_DIR)-real

# end-to-end on synthetic data (air-gapped dev)
all-synthetic:
	$(CPU_ENV) $(PY) -m recommendit_tpu.pipelines.run_pipeline --stage all --synthetic \
	  --data-dir /tmp/rtpu/ml-synth --models-dir /tmp/rtpu/models --features-dir /tmp/rtpu/features

# ---- serving ---------------------------------------------------------- #
serve:
	$(PY) -m recommendit_tpu.serving.app

# ---- tests ------------------------------------------------------------ #
test: native
	$(PY) -m pytest tests/ -x -q

test-features:
	$(PY) -m pytest tests/test_features.py -q

test-models:
	$(PY) -m pytest tests/test_models.py tests/test_ops.py tests/test_ranker.py -q

test-api:
	$(PY) -m pytest tests/test_api.py tests/test_pipeline_e2e.py -q

test-parallel:
	$(PY) -m pytest tests/test_parallel.py -q

test-coverage:
	$(PY) -m pytest tests/ --cov=recommendit_tpu --cov-report=term-missing -q

# ---- perf / multi-chip (GPU) ------------------------------------------ #
bench:
	$(PY) bench.py

smoke:
	$(PY) chip_smoke.py

smoke-four-cards:
	$(PY) chip_smoke.py --four-cards

dryrun:
	$(MESH_ENV) $(PY) __graft_entry__.py dryrun 8

# ---- docker lifecycle (reference Makefile:93-110) --------------------- #
docker-up:
	docker compose up -d
	@echo "Services started:"
	@echo "  API:        http://localhost:8000"
	@echo "  Prometheus: http://localhost:9090"
	@echo "  Grafana:    http://localhost:3000 (admin/admin)"

docker-down:
	docker compose down

docker-build:
	docker compose build --no-cache

docker-logs:
	docker compose logs -f api

docker-restart:
	docker compose restart api

# ---- hygiene ---------------------------------------------------------- #
lint:
	$(PY) -m ruff check recommendit_tpu/ tests/ || true

format:
	$(PY) -m ruff format recommendit_tpu/ tests/ || true

type-check:
	@$(PY) -c "import mypy" 2>/dev/null \
	  && $(PY) -m mypy recommendit_tpu/ --ignore-missing-imports \
	  || $(PY) -m compileall -q recommendit_tpu/  # fallback: syntax check

clean:
	rm -rf __pycache__ .pytest_cache bench_details.json smoke_work
	find . -name "*.pyc" -delete

# ---- native ----------------------------------------------------------- #
native:
	$(MAKE) -C native

variance:
	$(CPU_ENV) $(PY) scripts/seed_variance.py --seeds 3

scale-smoke:
	$(MESH_ENV) $(PY) scripts/scale_smoke.py --config ml25m

load-test:
	$(PY) scripts/load_test.py --url http://localhost:$${API_PORT:-8000}

ctr:  ## Criteo-style jointly-trained two-stage CTR config (BASELINE #5)
	$(PY) scripts/ctr_train.py --examples 500000 --epochs 5

ctr-smoke:
	$(CPU_ENV) $(PY) scripts/ctr_train.py --examples 50000 --users 2000 --items 1000 --epochs 3
