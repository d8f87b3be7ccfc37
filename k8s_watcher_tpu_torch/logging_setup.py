"""Logging set-up (the JAX package's ``logging_setup.py``).

The level comes from ``watcher.log_level``; production gets structured JSON
records (``json.dumps``, so a quote in a message stays valid JSON), other
environments a human-readable ``[ENV] ts - name - level - msg`` format.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional


class JsonFormatter(logging.Formatter):
    """Structured JSON log records for production."""

    def __init__(self, environment: str):
        super().__init__()
        self.environment = environment

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "timestamp": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
            "environment": self.environment,
        }
        # correlation key with the tracing plane: any log call made with
        # extra={"trace_id": ...} (trace.Tracer.finish does) joins this
        # line against /debug/trace and the trace_* metrics
        trace_id = getattr(record, "trace_id", None)
        if trace_id is not None:
            payload["trace_id"] = trace_id
        if record.exc_info:
            payload["exc_info"] = self.formatException(record.exc_info)
        return json.dumps(payload, ensure_ascii=False)

    def formatTime(self, record: logging.LogRecord, datefmt: Optional[str] = None) -> str:
        ct = time.gmtime(record.created)
        return time.strftime("%Y-%m-%dT%H:%M:%S", ct) + f".{int(record.msecs):03d}Z"


def setup_logging(environment: str, log_level: str = "INFO", *, force: bool = True) -> logging.Logger:
    """Configure root logging for ``environment`` and return this package's logger."""
    level = getattr(logging, log_level.upper(), logging.INFO)
    handler = logging.StreamHandler()
    if environment == "production":
        handler.setFormatter(JsonFormatter(environment))
    else:
        handler.setFormatter(
            logging.Formatter(f"[{environment.upper()}] %(asctime)s - %(name)s - %(levelname)s - %(message)s")
        )
    root = logging.getLogger()
    if force:
        for h in list(root.handlers):
            root.removeHandler(h)
    root.addHandler(handler)
    root.setLevel(level)
    logger = logging.getLogger("k8s_watcher_tpu_torch")
    logger.info("Starting k8s-watcher-tpu (PyTorch port) in %s environment", environment)
    return logger
