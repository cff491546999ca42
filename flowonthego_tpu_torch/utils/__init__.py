from . import graphs
from .metrics import angular_error, average_epe, endpoint_error
from .profiling import annotate, device_memory_stats, trace

__all__ = ["average_epe", "endpoint_error", "angular_error", "graphs",
           "trace", "annotate", "device_memory_stats"]
