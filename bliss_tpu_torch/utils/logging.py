"""Structured logging (a copy of ``bliss_tpu/utils/logging.py``).

The reference's observability is fprintf(stderr) on errors (SURVEY.md §5);
here every pipeline event is a structured record: human-readable on the
console, machine-readable (JSON lines) when BLISS_TPU_LOG_JSON is set.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "event", None)
        if extra:
            payload.update(extra)
        return json.dumps(payload)


def get_logger(name: str = "bliss_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        if os.environ.get("BLISS_TPU_LOG_JSON"):
            handler.setFormatter(_JsonFormatter())
        else:
            handler.setFormatter(
                logging.Formatter("[%(asctime)s] %(name)s %(levelname)s %(message)s")
            )
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("BLISS_TPU_LOG_LEVEL", "INFO"))
        logger.propagate = False
    return logger


def log_event(logger: logging.Logger, msg: str, **fields) -> None:
    """Log with structured fields attached (JSON mode emits them verbatim)."""
    logger.info(msg, extra={"event": fields})
