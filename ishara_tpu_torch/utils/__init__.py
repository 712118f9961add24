from .logging import MetricLogger
from .profiling import Throughput, trace

__all__ = ["MetricLogger", "Throughput", "trace"]
