"""Logger protocol: metric streaming + component status lifecycle.

Counterpart of mythos_tpu/ui/loggers/logger.py. The status convenience
API (set_{simulator,objective,observable}_{started,running,complete,error})
is generated programmatically instead of 12 hand-written methods.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from enum import Enum


class Status(Enum):
    """Lifecycle status of a simulator, objective, or observable."""

    STARTED = 0
    RUNNING = 1
    COMPLETE = 2
    ERROR = 3


class StatusKind(Enum):
    """Which component a status update refers to."""

    SIMULATOR = 0
    OBJECTIVE = 1
    OBSERVABLE = 2


class Logger(ABC):
    """Base Logger abstract class."""

    @abstractmethod
    def log_metric(self, name: str, value: float, step: int) -> None:
        """Record `value` for metric `name` at `step`."""

    @abstractmethod
    def update_status(self, name: str, kind: StatusKind, status: Status) -> None:
        """Update the status of a simulator, objective, or observable."""


def _install_status_api(cls: type) -> type:
    """Attach update_<kind>_status and set_<kind>_<status> helpers."""

    def make_update(kind: StatusKind):
        def update(self, name: str, status: Status) -> None:
            self.update_status(name, kind, status)

        update.__doc__ = f"Update the status of a {kind.name.lower()}."
        return update

    def make_set(kind: StatusKind, status: Status):
        def setter(self, name: str) -> None:
            getattr(self, f"update_{kind.name.lower()}_status")(name, status)

        setter.__doc__ = f"Set a {kind.name.lower()}'s status to {status.name}."
        return setter

    for kind in StatusKind:
        setattr(cls, f"update_{kind.name.lower()}_status", make_update(kind))
        for status in Status:
            name = "complete" if status is Status.COMPLETE else status.name.lower()
            setattr(cls, f"set_{kind.name.lower()}_{name}", make_set(kind, status))
    return cls


_install_status_api(Logger)


class NullLogger(Logger):
    """A logger that does nothing."""

    def log_metric(self, name: str, value: float, step: int) -> None:
        """Intentionally does nothing."""

    def update_status(self, name: str, kind: StatusKind, status: Status) -> None:
        """Intentionally does nothing."""
