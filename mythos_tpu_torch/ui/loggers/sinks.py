"""Logger sinks: console, single-file CSV, per-metric CSV, fan-out.

Counterpart of mythos_tpu/ui/loggers/sinks.py.
"""

from __future__ import annotations

from datetime import UTC, datetime
from pathlib import Path
from typing import TextIO

from mythos_tpu_torch.ui.loggers.logger import Logger, Status, StatusKind


def convert_to_fname(name: str) -> str:
    """Metric name -> safe CSV filename."""
    return name.replace("/", "_").replace(" ", "_") + ".csv"


def tsnow() -> str:
    """Current UTC timestamp string."""
    return datetime.now(tz=UTC).isoformat()


class ConsoleLogger(Logger):
    """Print metrics/status to stdout."""

    def log_metric(self, name: str, value: float, step: int) -> None:
        print(f"Step: {step}, {name}: {value}")  # noqa: T201 - console sink

    def update_status(self, name: str, kind: StatusKind, status: Status) -> None:
        print(name, status)  # noqa: T201 - console sink


class FileLogger(Logger):
    """Append all metrics/status lines to one CSV file."""

    def __init__(self, log_file: str | Path, mode: str = "a") -> None:
        self.log_file = Path(log_file).open(mode=mode)

    def log_metric(self, name: str, value: float, step: int) -> None:
        self.log_file.write(f"{step},{tsnow()},{name},{value}\n")
        self.log_file.flush()

    def update_status(self, name: str, kind: StatusKind, status: Status) -> None:
        self.log_file.write(f"{tsnow()},{name},{status}\n")
        self.log_file.flush()


class PerMetricFileLogger(Logger):
    """One CSV file per metric/status name, under log_dir."""

    def __init__(self, log_dir: str | Path) -> None:
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.file_handles: dict[str, TextIO] = {}

    def _handle(self, name: str) -> TextIO:
        if name not in self.file_handles:
            self.file_handles[name] = (self.log_dir / convert_to_fname(name)).open(mode="a")
        return self.file_handles[name]

    def log_metric(self, name: str, value: float, step: int) -> None:
        fh = self._handle(name)
        fh.write(f"{step},{tsnow()},{value}\n")
        fh.flush()

    def update_status(self, name: str, kind: StatusKind, status: Status) -> None:
        fh = self._handle(name)
        fh.write(f"{tsnow()},{status}\n")
        fh.flush()


#: alias matching the reference's DiskLogger naming
DiskLogger = PerMetricFileLogger


class MultiLogger(Logger):
    """Fan out every call to a list of loggers.

    The per-kind status helpers are forwarded by name (not collapsed through
    ``update_status``) so sub-loggers that override a specific helper still
    see their override called.
    """

    def __init__(self, loggers: list[Logger]) -> None:
        self.loggers = loggers

    def log_metric(self, name: str, value: float, step: int) -> None:
        for logger in self.loggers:
            logger.log_metric(name, value, step)

    def update_status(self, name: str, kind: StatusKind, status: Status) -> None:
        for logger in self.loggers:
            logger.update_status(name, kind, status)


def _install_multi_forwarding(cls: type) -> type:
    """Forward every update_*_status helper to sub-loggers by name."""

    def make_forward(method: str):
        def forward(self, name: str, status: Status) -> None:
            for logger in self.loggers:
                getattr(logger, method)(name, status)

        forward.__doc__ = f"Fan out {method} to all loggers."
        return forward

    for kind in StatusKind:
        method = f"update_{kind.name.lower()}_status"
        setattr(cls, method, make_forward(method))
    return cls


_install_multi_forwarding(MultiLogger)
