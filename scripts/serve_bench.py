"""Concurrent HTTP serving benchmark.

Boots the serving stack as a subprocess (threaded stdlib server or the
asyncio ASGI server), drives it with N concurrent closed-loop clients at
each concurrency level, and reports QPS + latency percentiles per level —
the measured counterpart of the reference's published 18 ms p50 / 43 ms
p99 end-to-end serving latency (``/root/reference/README.md:42-44``).

Also (--overload) drives the micro-batcher past its bounded queue to
demonstrate 429 backpressure instead of an unbounded latency tail.

Usage:
  JAX_PLATFORMS=cpu PYTHONPATH=. \
    python scripts/serve_bench.py --artifacts /tmp/ladder/c4_s0 \
      --data-dir /tmp/ladder/c4_data --variant threaded \
      --levels 1,16,64,256 [--micro-batch] [--overload]

Prints one JSON line per level plus a summary line; appends to --log.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_server(args, port: int) -> subprocess.Popen:
    # the parent stays off JAX: the one server process owns the device
    env = dict(os.environ)
    if getattr(args, "platform", "cpu") == "gpu":
        env.pop("JAX_PLATFORMS", None)
    else:
        env["JAX_PLATFORMS"] = env.get("JAX_PLATFORMS", "cpu")
    env.update(
        PYTHONPATH=REPO,
        EMBEDDING_MODEL_PATH=f"{args.artifacts}/models/two_tower.npz",
        INDEX_PATH=f"{args.artifacts}/models/mips.index.npz",
        RANKER_MODEL_PATH=f"{args.artifacts}/models/ranker.npz",
        DATA_DIR=args.data_dir,
        API_PORT=str(port),
        API_HOST="127.0.0.1",
        LOG_LEVEL="WARNING",
        MICRO_BATCH="true" if args.micro_batch else "false",
        MICRO_BATCH_MAX=str(args.micro_batch_max),
        MICRO_BATCH_WAIT_MS=str(args.micro_batch_wait_ms),
    )
    mod = (
        "recommendit_tpu.serving.asgi_server" if args.variant == "asgi"
        else "recommendit_tpu.serving.app"
    )
    cmd = [sys.executable, "-m", mod]
    slog = open(f"/tmp/serve_bench_server_{port}.log", "wb")
    proc = subprocess.Popen(
        cmd, env=env, cwd=REPO,
        stdout=slog, stderr=subprocess.STDOUT,
        start_new_session=True,
    )
    deadline = time.time() + args.startup_timeout
    url = f"http://127.0.0.1:{port}/health"
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                body = json.loads(r.read())
                if body.get("pipeline_loaded"):
                    return proc
        except Exception:
            pass
        if proc.poll() is not None:
            raise RuntimeError(f"server exited early rc={proc.returncode}")
        time.sleep(0.25)
    # don't leak the subprocess on health timeout
    os.killpg(proc.pid, signal.SIGTERM)
    raise RuntimeError("server did not become healthy in time")


def run_level(url: str, threads: int, n_requests: int, k: int,
              max_user: int, use_cache: bool, timeout_s: float = 30.0):
    rng = np.random.default_rng(threads)
    uids = rng.integers(1, max_user + 1, size=n_requests).tolist()
    lat: list = []
    codes: dict = {}
    lock = threading.Lock()
    cursor = [0]

    def worker():
        local, lcodes = [], {}
        while True:
            with lock:
                i = cursor[0]
                if i >= n_requests:
                    break
                cursor[0] += 1
            payload = json.dumps(
                {"user_id": uids[i], "k": k, "use_cache": use_cache}
            ).encode()
            req = urllib.request.Request(
                f"{url}/recommend", data=payload,
                headers={"Content-Type": "application/json"}, method="POST",
            )
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=timeout_s) as r:
                    r.read()
                    code = r.status
            except urllib.error.HTTPError as e:
                e.read()
                code = e.code
            except Exception:
                code = -1
            local.append((time.perf_counter() - t0) * 1000)
            lcodes[code] = lcodes.get(code, 0) + 1
        with lock:
            lat.extend(local)
            for c, n in lcodes.items():
                codes[c] = codes.get(c, 0) + n

    ts = [threading.Thread(target=worker) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    a = np.asarray(lat)
    ok = codes.get(200, 0)
    return {
        "clients": threads,
        "requests": n_requests,
        "ok": ok,
        "codes": {str(c): n for c, n in sorted(codes.items())},
        "qps": round(n_requests / wall, 1),
        "p50_ms": round(float(np.percentile(a, 50)), 2),
        "p95_ms": round(float(np.percentile(a, 95)), 2),
        "p99_ms": round(float(np.percentile(a, 99)), 2),
        "mean_ms": round(float(a.mean()), 2),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", required=True,
                    help="dir holding models/{two_tower,mips.index,ranker}.npz")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--variant", choices=["threaded", "asgi"],
                    default="threaded")
    ap.add_argument("--levels", default="1,16,64,256")
    ap.add_argument("--requests-per-client", type=int, default=40)
    ap.add_argument("--min-requests", type=int, default=200)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--max-user", type=int, default=1500)
    ap.add_argument("--use-cache", action="store_true")
    ap.add_argument("--micro-batch", action="store_true")
    ap.add_argument("--micro-batch-max", type=int, default=256)
    ap.add_argument("--micro-batch-wait-ms", type=float, default=2.0)
    ap.add_argument("--overload", action="store_true",
                    help="extra phase: saturate a tiny-queue micro-batcher "
                    "and report the 429 share")
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="cpu",
                    help="gpu: the SERVER process runs its jitted hot "
                         "path on the GPU")
    ap.add_argument("--startup-timeout", type=float, default=300.0)
    ap.add_argument("--log", default="serve_bench.jsonl")
    args = ap.parse_args()

    port = free_port()
    proc = start_server(args, port)
    url = f"http://127.0.0.1:{port}"
    rows = []
    try:
        # one warmup pass (jit compile of the serve fn at each batch shape)
        run_level(url, 8, 64, args.k, args.max_user, args.use_cache)
        for lvl in [int(x) for x in args.levels.split(",")]:
            n = max(args.min_requests, lvl * args.requests_per_client)
            row = run_level(url, lvl, n, args.k, args.max_user,
                            args.use_cache)
            row.update(variant=args.variant, micro_batch=args.micro_batch,
                       platform=args.platform)
            rows.append(row)
            print(json.dumps(row), flush=True)
            with open(args.log, "a") as f:
                f.write(json.dumps(row) + "\n")
    finally:
        os.killpg(proc.pid, signal.SIGTERM)
        proc.wait(timeout=10)

    if args.overload:
        # tiny queue + slow drain -> submit() must shed with 429s, and the
        # accepted requests must stay fast (bounded tail)
        o = argparse.Namespace(**vars(args))
        o.micro_batch = True
        o.micro_batch_max = 8
        o.micro_batch_wait_ms = 20.0
        port = free_port()
        proc = start_server(o, port)
        url = f"http://127.0.0.1:{port}"
        try:
            run_level(url, 8, 64, args.k, args.max_user, False)
            row = run_level(url, 256, 4096, args.k, args.max_user, False,
                            timeout_s=60.0)
            row.update(variant=args.variant, phase="overload",
                       queue=8 * 8)
            shed = row["codes"].get("429", 0)
            row["shed_429_share"] = round(shed / row["requests"], 3)
            print(json.dumps(row), flush=True)
            with open(args.log, "a") as f:
                f.write(json.dumps(row) + "\n")
        finally:
            os.killpg(proc.pid, signal.SIGTERM)
            proc.wait(timeout=10)


if __name__ == "__main__":
    main()
