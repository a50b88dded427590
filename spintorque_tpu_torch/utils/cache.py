"""Host-side result caching: LRU+TTL, adaptive sizing, registry, decorator.

PyTorch counterpart of ``spintorque_tpu/utils/cache.py``: one cache stack
for HOST-side results (material lookups, analysis products, benchmark
reports). Device compute is not cached, and thermal or otherwise
stochastic results must not be: a cached noisy trajectory would replay.
``LRUCache.make_key`` hashes the FULL argument structure: numpy arrays and
torch tensors by dtype, shape and bytes (a tensor also by its device; one
on the card is copied to the host for its key), so no two different
inputs share a key.
"""

from __future__ import annotations

import hashlib
import pickle
import threading
import time
from dataclasses import dataclass
from functools import wraps
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

__all__ = [
    "CacheStats",
    "LRUCache",
    "AdaptiveCache",
    "CacheManager",
    "cached",
    "get_cache_manager",
]


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    expirations: int = 0

    @property
    def total(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.total if self.total else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "expirations": self.expirations,
            "hit_rate": self.hit_rate,
        }


class LRUCache:
    """Thread-safe LRU cache with optional TTL expiry.

    Keys are built with ``make_key``, which hashes the full pickled argument
    structure (numpy arrays and torch tensors by bytes), so no rounded or
    partial key can make two inputs collide.
    """

    def __init__(self, max_size: int = 1024, ttl_s: Optional[float] = 300.0):
        if max_size < 1:
            raise ValueError("max_size >= 1")
        self.max_size = max_size
        self.ttl_s = ttl_s
        self._data: Dict[str, Any] = {}
        self._expiry: Dict[str, float] = {}
        self._lock = threading.RLock()
        self.stats = CacheStats()

    @staticmethod
    def make_key(*args, **kwargs) -> str:
        def canon(x):
            if isinstance(x, np.ndarray):
                return ("ndarray", x.dtype.str, x.shape, x.tobytes())
            if isinstance(x, torch.Tensor):
                host = x.detach().cpu().contiguous()
                raw = host.reshape(-1).view(torch.uint8) if host.numel() else host
                return ("tensor", str(x.dtype), tuple(x.shape), str(x.device),
                        raw.numpy().tobytes())
            if isinstance(x, dict):
                return tuple(sorted((k, canon(v)) for k, v in x.items()))
            if isinstance(x, (list, tuple)):
                return tuple(canon(v) for v in x)
            return x

        payload = pickle.dumps((canon(args), canon(kwargs)), protocol=4)
        return hashlib.sha256(payload).hexdigest()

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            if key in self._data:
                if self.ttl_s is not None and time.monotonic() > self._expiry[key]:
                    del self._data[key]
                    del self._expiry[key]
                    self.stats.expirations += 1
                    self.stats.misses += 1
                    return default
                # move to MRU position
                value = self._data.pop(key)
                self._data[key] = value
                self.stats.hits += 1
                return value
            self.stats.misses += 1
            return default

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            if key in self._data:
                self._data.pop(key)
            elif len(self._data) >= self.max_size:
                oldest = next(iter(self._data))
                del self._data[oldest]
                self._expiry.pop(oldest, None)
                self.stats.evictions += 1
            self._data[key] = value
            if self.ttl_s is not None:
                self._expiry[key] = time.monotonic() + self.ttl_s

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._expiry.clear()


class AdaptiveCache(LRUCache):
    """LRU cache that resizes itself from the observed hit rate.

    Every ``adapt_interval`` accesses: hit rate above ``grow_threshold``
    grows capacity (cache is earning its keep), below ``shrink_threshold``
    shrinks it (churn without reuse).
    """

    def __init__(
        self,
        max_size: int = 1024,
        ttl_s: Optional[float] = 300.0,
        min_size: int = 64,
        cap_size: int = 65536,
        adapt_interval: int = 500,
        grow_threshold: float = 0.8,
        shrink_threshold: float = 0.3,
    ):
        super().__init__(max_size, ttl_s)
        self.min_size = min_size
        self.cap_size = cap_size
        self.adapt_interval = adapt_interval
        self.grow_threshold = grow_threshold
        self.shrink_threshold = shrink_threshold
        self._last_total = 0

    def _maybe_adapt(self) -> None:
        if self.stats.total - self._last_total < self.adapt_interval:
            return
        self._last_total = self.stats.total
        rate = self.stats.hit_rate
        if rate > self.grow_threshold and self.max_size < self.cap_size:
            self.max_size = min(self.cap_size, self.max_size * 2)
        elif rate < self.shrink_threshold and self.max_size > self.min_size:
            self.max_size = max(self.min_size, self.max_size // 2)
            with self._lock:
                while len(self._data) > self.max_size:
                    oldest = next(iter(self._data))
                    del self._data[oldest]
                    self._expiry.pop(oldest, None)
                    self.stats.evictions += 1

    def get(self, key: str, default: Any = None) -> Any:
        out = super().get(key, default)
        self._maybe_adapt()
        return out


class CacheManager:
    """Named-cache registry."""

    def __init__(self):
        self._caches: Dict[str, LRUCache] = {}
        self._lock = threading.Lock()

    def get_cache(
        self, name: str, max_size: int = 1024, ttl_s: Optional[float] = 300.0,
        adaptive: bool = False,
    ) -> LRUCache:
        with self._lock:
            if name not in self._caches:
                cls = AdaptiveCache if adaptive else LRUCache
                self._caches[name] = cls(max_size=max_size, ttl_s=ttl_s)
            return self._caches[name]

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {n: c.stats.as_dict() for n, c in self._caches.items()}

    def clear_all(self) -> None:
        with self._lock:
            for c in self._caches.values():
                c.clear()


_global_manager: Optional[CacheManager] = None
_global_lock = threading.Lock()


def get_cache_manager() -> CacheManager:
    global _global_manager
    with _global_lock:
        if _global_manager is None:
            _global_manager = CacheManager()
        return _global_manager


def cached(
    cache_name: str = "default", max_size: int = 1024,
    ttl_s: Optional[float] = 300.0,
):
    """Memoize a HOST-side function through the global cache manager.

    Do not wrap device computations or anything stochastic: the former
    would pin device results in host memory, the latter must not replay.
    """

    def decorator(fn: Callable) -> Callable:
        cache = get_cache_manager().get_cache(cache_name, max_size, ttl_s)
        sentinel = object()

        @wraps(fn)
        def wrapper(*args, **kwargs):
            key = LRUCache.make_key(fn.__module__, fn.__qualname__, *args, **kwargs)
            value = cache.get(key, sentinel)
            if value is sentinel:
                value = fn(*args, **kwargs)
                cache.put(key, value)
            return value

        wrapper.cache = cache  # type: ignore[attr-defined]
        return wrapper

    return decorator
