"""Loggers: metric streaming and status tracking for optimization runs
(port of mythos_tpu.ui.loggers; its aim and jupyter loggers are not ported)."""

from mythos_tpu_torch.ui.loggers.logger import Logger, NullLogger, Status, StatusKind
from mythos_tpu_torch.ui.loggers.sinks import (
    ConsoleLogger,
    DiskLogger,
    FileLogger,
    MultiLogger,
    PerMetricFileLogger,
)

__all__ = [
    "ConsoleLogger",
    "DiskLogger",
    "FileLogger",
    "Logger",
    "MultiLogger",
    "NullLogger",
    "PerMetricFileLogger",
    "Status",
    "StatusKind",
]
