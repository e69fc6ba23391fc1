"""recommendit_tpu — a JAX two-stage recommender framework.

A from-scratch JAX/XLA/pjit re-design of the capabilities of the
reference two-stage recommender (Two-Tower retrieval + learning-to-rank
re-ranking over MovieLens-style data): pure-functional models, a vectorized
in-batch BPR loss and blocked MIPS top-k retrieval, sharded
embedding tables and corpus over a ``jax.sharding.Mesh``, and a serving path
where embed → retrieve → featurize → rank is a single jitted device call.
"""

__version__ = "0.1.0"

from recommendit_tpu.config import Settings, settings  # noqa: F401


def __getattr__(name):
    """Lazy top-level re-exports (keeps `import recommendit_tpu` light —
    jax/pandas load only when a component is touched)."""
    from importlib import import_module

    _exports = {
        "FeatureEngineer": "recommendit_tpu.features.engineering",
        "FeatureStore": "recommendit_tpu.features.store",
        "TwoTowerModel": "recommendit_tpu.models.two_tower",
        "MIPSIndex": "recommendit_tpu.models.retrieval",
        "LambdaRankScorer": "recommendit_tpu.models.ranker",
        "HistGBDTRanker": "recommendit_tpu.models.gbdt",
        "load_ranker": "recommendit_tpu.models",
        "EmbeddingTrainer": "recommendit_tpu.training.train_embeddings",
        "IndexBuilder": "recommendit_tpu.training.build_index",
        "RankerTrainer": "recommendit_tpu.training.train_ranker",
        "RecommendationPipeline": "recommendit_tpu.serving.recommender",
        "PipelineOrchestrator": "recommendit_tpu.pipelines.run_pipeline",
        "create_app": "recommendit_tpu.serving.app",
        "make_synthetic_movielens": "recommendit_tpu.data.synthetic",
        "load_movielens": "recommendit_tpu.data.movielens",
        "CTRModel": "recommendit_tpu.models.ctr",
        "CTRTrainer": "recommendit_tpu.training.train_ctr",
        "make_ctr_dataset": "recommendit_tpu.data.ctr",
    }
    if name in _exports:
        return getattr(import_module(_exports[name]), name)
    raise AttributeError(f"module 'recommendit_tpu' has no attribute {name!r}")
