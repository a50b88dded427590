"""Structured logging setup.

PyTorch counterpart of ``spintorque_tpu/utils/logging_config.py``: a
JSON-structured formatter, per-subsystem loggers under
``spintorque_tpu_torch``, and a context manager for scoped metadata.
Multi-process aware: a record carries the process's rank in the default
process group (``torch.distributed.get_rank()``), 0 when there is none.
"""

from __future__ import annotations

import contextlib
import json
import logging
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

_CONTEXT: Dict[str, Any] = {}


class StructuredFormatter(logging.Formatter):
    """One JSON object per line."""

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        try:
            import torch.distributed as dist

            payload["process"] = dist.get_rank() if dist.is_initialized() else 0
        except Exception:  # noqa: BLE001 - logging must never fail
            pass
        if record.exc_info:
            payload["exception"] = self.formatException(record.exc_info)
        payload.update(_CONTEXT)
        extra = getattr(record, "metrics", None)
        if extra:
            payload["metrics"] = extra
        return json.dumps(payload, default=str)


def setup_logging(
    level: str = "INFO",
    structured: bool = False,
    log_file: Optional[str] = None,
) -> logging.Logger:
    """Configure the 'spintorque_tpu_torch' logger tree."""
    logger = logging.getLogger("spintorque_tpu_torch")
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.handlers.clear()

    handler = logging.StreamHandler(sys.stderr)
    if structured:
        handler.setFormatter(StructuredFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
    logger.addHandler(handler)

    if log_file:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(StructuredFormatter())
        logger.addHandler(fh)
    return logger


def get_logger(subsystem: str = "") -> logging.Logger:
    name = f"spintorque_tpu_torch.{subsystem}" if subsystem else "spintorque_tpu_torch"
    return logging.getLogger(name)


@contextlib.contextmanager
def LoggingContext(**fields):
    """Scoped structured-log metadata."""
    saved = dict(_CONTEXT)
    _CONTEXT.update(fields)
    try:
        yield
    finally:
        _CONTEXT.clear()
        _CONTEXT.update(saved)


class PerformanceLogger:
    """Metric-oriented logger facade."""

    def __init__(self, subsystem: str = "perf"):
        self.logger = get_logger(subsystem)

    def log_metrics(self, message: str, **metrics) -> None:
        self.logger.info(message, extra={"metrics": metrics})
