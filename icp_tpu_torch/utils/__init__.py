"""Host-side utilities: structured metrics logging (``metrics``)."""

from . import metrics
from .metrics import MetricsLogger, null_logger

__all__ = ["MetricsLogger", "metrics", "null_logger"]
