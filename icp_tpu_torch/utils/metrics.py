"""Structured metrics logging (JSON lines).

Port of :mod:`icp_tpu.utils.metrics` (pure Python, the same records).  The
long-running entry points (the odometry streams, scan-to-map) take a
:class:`MetricsLogger` as ``metrics=`` and append one JSON record per step
to its sink, stamped with the seconds since the logger was made.
"""

from __future__ import annotations

import json
import time
from typing import IO, Any


class MetricsLogger:
    """Append-only JSONL metrics writer with wall-clock stamping.

    ``sink`` is a path (opened for append and closed by :meth:`close`), an
    open text stream (left open), or None (records are dropped).
    """

    def __init__(self, sink: str | IO | None):
        self._own = isinstance(sink, str)
        self._fh: IO | None = open(sink, "a") if isinstance(sink, str) else sink
        self._t0 = time.time()

    def log(self, event: str, **fields: Any) -> None:
        if self._fh is None:
            return
        record = {"event": event, "t": round(time.time() - self._t0, 6), **fields}
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._own and self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def null_logger() -> MetricsLogger:
    """A logger that drops every record."""
    return MetricsLogger(None)
