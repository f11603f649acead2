"""The SimulatorTrajectory currency.

Counterpart of mythos_tpu/simulators/io.py: a stacked (S, N, ...) rigid
body with optional per-state box size, temperature and metadata. File
output and concatenation are not ported yet.
"""

from __future__ import annotations

import dataclasses as dc

import torch


@dc.dataclass(frozen=True)
class SimulatorTrajectory:
    """States of a run: ``center`` (S, N, 3), ``orientation`` (S, N, 4),
    and, for periodic runs, ``box_size`` (S, 3)."""

    center: torch.Tensor
    orientation: torch.Tensor
    box_size: torch.Tensor | None = None
    temperature: torch.Tensor | None = None
    metadata: dict[str, torch.Tensor] | None = None

    def length(self) -> int:
        return self.center.shape[0]

    def with_state_metadata(self, **metadata) -> "SimulatorTrajectory":
        """Attach the same metadata value to every state."""
        new = dict(self.metadata or {})
        for key, value in metadata.items():
            v = torch.as_tensor(value)
            new[key] = v.expand(self.length(), *v.shape).clone()
        return dc.replace(self, metadata=new)
