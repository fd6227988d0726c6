"""Structured logging.

The port's copy of ``vhr_tpu/utils/logging.py``, line for line below this
docstring: plain lines for humans on stderr, an optional JSONL sink for
machines, no global state beyond the standard ``logging`` registry.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional

__all__ = ["get_logger", "JsonlHandler"]


class JsonlHandler(logging.Handler):
    """Append one JSON object per record to a file."""

    def __init__(self, path: str):
        super().__init__()
        self._f = open(path, "a")

    def emit(self, record: logging.LogRecord) -> None:
        payload = {
            "t": time.time(),
            "level": record.levelname,
            "name": record.name,
            "msg": record.getMessage(),
        }
        if record.args and isinstance(record.args, dict):
            payload.update(record.args)
        self._f.write(json.dumps(payload) + "\n")
        self._f.flush()


def get_logger(name: str = "vhr_tpu", jsonl_path: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(level)
    if jsonl_path and not any(isinstance(h, JsonlHandler)
                              for h in logger.handlers):
        logger.addHandler(JsonlHandler(jsonl_path))
    return logger
