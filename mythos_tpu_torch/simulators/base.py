"""Simulator output container.

Counterpart of ``SimulatorOutput`` in mythos_tpu/simulators/base.py.
"""

from __future__ import annotations

import dataclasses as dc
from typing import Any


@dc.dataclass(frozen=True)
class SimulatorOutput:
    """Observables (by position) plus simulator state."""

    observables: list[Any]
    state: dict[str, Any] = dc.field(default_factory=dict)
