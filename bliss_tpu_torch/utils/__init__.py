"""Structured logging and stage timers (copies of ``bliss_tpu/utils``'s
``logging.py`` and ``StageTimer``)."""

from bliss_tpu_torch.utils.logging import get_logger, log_event
from bliss_tpu_torch.utils.profiling import StageTimer

__all__ = ["get_logger", "log_event", "StageTimer"]
