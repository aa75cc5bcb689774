"""Host-side utilities: structured metrics logging (``metrics``), the
profiler, NVTX ranges and timers (``profiling``), and the optional native
C++ loader (``native``)."""

from . import metrics, native, profiling
from .metrics import MetricsLogger, null_logger

__all__ = ["MetricsLogger", "metrics", "native", "null_logger", "profiling"]
