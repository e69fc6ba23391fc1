# Serving image: CPU JAX. GPU runs use a CUDA host with jax[cuda]
# (see README: `python chip_smoke.py`).
FROM python:3.11-slim

ENV PYTHONUNBUFFERED=1 \
    PYTHONDONTWRITEBYTECODE=1 \
    JAX_PLATFORMS=cpu

WORKDIR /app

RUN pip install --no-cache-dir "jax[cpu]" numpy pandas pyarrow optax \
    prometheus-client msgpack redis

COPY recommendit_tpu/ recommendit_tpu/
COPY pyproject.toml ./

RUN useradd -m appuser && chown -R appuser /app
USER appuser

EXPOSE 8000
ENV API_HOST=0.0.0.0 API_PORT=8000

CMD ["python", "-m", "recommendit_tpu.serving.app"]
