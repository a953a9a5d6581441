"""Structured logging setup.

The reference logs via a bare ``logging.basicConfig(INFO)`` at launch
(launch.py:1-2) with most output going through ``print``.  Here logging is
uniform and machine-parseable: one line per event with stage timings, and an
optional JSON mode for ingestion.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload)


def setup_logging(level: int = logging.INFO, json_lines: bool = False) -> None:
    handler = logging.StreamHandler(sys.stderr)
    if json_lines:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)
