"""Logging, per-stage wall clock and JSONL per-frame metrics.

The port's own copy of ``vio360_tpu/utils/logging.py``.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import IO, Any

_FMT = "[%(levelname).1s] %(message)s"


def get_logger(name: str = "vio360", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class MetricsWriter:
    """Appends one JSON object per frame to a .jsonl file (or any stream)."""

    def __init__(self, path_or_stream: str | IO[str] | None):
        self._own = False
        if path_or_stream is None:
            self._f: IO[str] | None = None
        elif isinstance(path_or_stream, str):
            self._f = open(path_or_stream, "a")
            self._own = True
        else:
            self._f = path_or_stream

    def write(self, **fields: Any) -> None:
        if self._f is None:
            return
        fields.setdefault("wall_time", time.time())
        self._f.write(json.dumps(fields, default=float) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None and self._own:
            self._f.close()
        self._f = None


class StageTimer:
    """Accumulates wall-clock seconds per pipeline stage."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def add(self, stage: str, seconds: float) -> None:
        self.totals[stage] = self.totals.get(stage, 0.0) + seconds
        self.counts[stage] = self.counts.get(stage, 0) + 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_ms": 1e3 * v / self.counts[k]}
            for k, v in self.totals.items()
        }
