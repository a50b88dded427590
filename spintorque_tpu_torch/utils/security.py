"""Input sanitization and rate limiting for external-facing surfaces.

The port's own copy of ``spintorque_tpu/utils/security.py`` (the standard
library only, as there): sanitizers for untrusted config, CLI and API
inputs, a token-bucket rate limiter for the serving endpoint, and hashing
helpers. The env step never sees untrusted strings; these guards sit at
the host boundary (config files, CLI arguments, service endpoints).
"""

from __future__ import annotations

import hashlib
import hmac
import math
import re
import threading
import time
from typing import Any, Dict, Optional

_SAFE_KEY_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,128}$")


class SecurityError(Exception):
    pass


class InputSanitizer:
    """String / numeric / mapping sanitization."""

    MAX_STRING = 4096
    MAX_DICT_DEPTH = 8
    MAX_DICT_KEYS = 256

    @staticmethod
    def sanitize_string(value: Any, max_length: Optional[int] = None) -> str:
        if not isinstance(value, str):
            raise SecurityError(f"Expected string, got {type(value).__name__}")
        limit = max_length or InputSanitizer.MAX_STRING
        if len(value) > limit:
            raise SecurityError(f"String exceeds maximum length {limit}")
        # strip control characters
        cleaned = "".join(c for c in value if c.isprintable() or c in "\n\t")
        return cleaned

    @staticmethod
    def sanitize_key(value: Any) -> str:
        s = InputSanitizer.sanitize_string(value, 128)
        if not _SAFE_KEY_RE.match(s):
            raise SecurityError(f"Invalid identifier: {s!r}")
        return s

    @staticmethod
    def sanitize_number(
        value: Any,
        lo: float = -1e30,
        hi: float = 1e30,
        allow_nan: bool = False,
    ) -> float:
        try:
            v = float(value)
        except (TypeError, ValueError) as e:
            raise SecurityError(f"Expected number, got {value!r}") from e
        if not allow_nan and (math.isnan(v) or math.isinf(v)):
            raise SecurityError("Non-finite number rejected")
        if not lo <= v <= hi:
            raise SecurityError(f"Number {v} outside [{lo}, {hi}]")
        return v

    @classmethod
    def sanitize_dict(cls, data: Any, _depth: int = 0) -> Dict[str, Any]:
        if not isinstance(data, dict):
            raise SecurityError(f"Expected dict, got {type(data).__name__}")
        if _depth >= cls.MAX_DICT_DEPTH:
            raise SecurityError("Dict nesting too deep")
        if len(data) > cls.MAX_DICT_KEYS:
            raise SecurityError("Too many keys")
        out: Dict[str, Any] = {}
        for k, v in data.items():
            key = cls.sanitize_key(k)
            if isinstance(v, dict):
                out[key] = cls.sanitize_dict(v, _depth + 1)
            elif isinstance(v, str):
                out[key] = cls.sanitize_string(v)
            elif isinstance(v, bool):
                out[key] = v
            elif isinstance(v, (int, float)):
                out[key] = cls.sanitize_number(v)
            elif isinstance(v, (list, tuple)):
                out[key] = [
                    cls.sanitize_number(x) if isinstance(x, (int, float)) and not isinstance(x, bool)
                    else cls.sanitize_string(x) if isinstance(x, str)
                    else x
                    for x in v
                ]
            else:
                out[key] = v
        return out


class RateLimiter:
    """Token-bucket rate limiter."""

    def __init__(self, rate_per_s: float = 100.0, burst: int = 100):
        self.rate = rate_per_s
        self.burst = burst
        self._tokens = float(burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def allow(self, cost: float = 1.0) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= cost:
                self._tokens -= cost
                return True
            return False


class SecureHasher:
    """Stable hashing of configs/params."""

    @staticmethod
    def hash_dict(data: Dict[str, Any]) -> str:
        import json

        payload = json.dumps(data, sort_keys=True, default=str).encode()
        return hashlib.sha256(payload).hexdigest()

    @staticmethod
    def hmac_sign(data: bytes, key: bytes) -> str:
        return hmac.new(key, data, hashlib.sha256).hexdigest()

    @staticmethod
    def verify(data: bytes, key: bytes, signature: str) -> bool:
        return hmac.compare_digest(SecureHasher.hmac_sign(data, key), signature)


class SecurityAuditor:
    """Collects security-relevant events."""

    def __init__(self, max_events: int = 1000):
        self.max_events = max_events
        self.events: list = []
        self._lock = threading.Lock()

    def record(self, kind: str, detail: str) -> None:
        with self._lock:
            self.events.append({"time": time.time(), "kind": kind, "detail": detail})
            if len(self.events) > self.max_events:
                self.events = self.events[-self.max_events // 2 :]

    def report(self) -> Dict[str, Any]:
        with self._lock:
            kinds: Dict[str, int] = {}
            for e in self.events:
                kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
            return {"total_events": len(self.events), "by_kind": kinds}
