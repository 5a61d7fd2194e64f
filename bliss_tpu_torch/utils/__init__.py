"""Structured logging, stage timers, profiler hooks and numerical
debugging (counterparts of ``bliss_tpu/utils``)."""

from bliss_tpu_torch.utils.logging import get_logger, log_event
from bliss_tpu_torch.utils.profiling import StageTimer, trace_annotation
from bliss_tpu_torch.utils.debug import nan_debugging, validate_features

__all__ = [
    "get_logger",
    "log_event",
    "StageTimer",
    "trace_annotation",
    "nan_debugging",
    "validate_features",
]
