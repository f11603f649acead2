"""The SimulatorTrajectory currency.

Counterpart of mythos_tpu/simulators/io.py: a stacked (S, N, ...) rigid
body with optional per-state box size, temperature (kT, which drives the
DiffTRe reweighting) and metadata (a dict of per-state tensors), sliced,
filtered, concatenated along the state axis and written as an oxDNA
trajectory.
"""

from __future__ import annotations

import dataclasses as dc
from collections.abc import Callable
from pathlib import Path
from typing import Any

import numpy as np
import torch

from mythos_tpu_torch.io.trajectory import _write_state
from mythos_tpu_torch.soa import Quat, quat_frame_soa
from mythos_tpu_torch.utils.helpers import tree_concatenate, tree_map


@dc.dataclass(frozen=True)
class SimulatorTrajectory:
    """States of a run: ``center`` (S, N, 3), ``orientation`` (S, N, 4),
    and optionally ``box_size`` (S, ...), ``temperature`` (S,) and
    ``metadata`` (a dict of (S, ...) tensors)."""

    center: torch.Tensor
    orientation: torch.Tensor
    box_size: torch.Tensor | None = None
    temperature: torch.Tensor | None = None
    metadata: dict[str, torch.Tensor] | None = None

    def replace(self, **kw) -> "SimulatorTrajectory":
        return dc.replace(self, **kw)

    def length(self) -> int:
        """Number of states."""
        return self.center.shape[0]

    def with_state_metadata(self, **metadata) -> "SimulatorTrajectory":
        """Attach the same metadata value to every state."""
        new = dict(self.metadata or {})
        for key, value in metadata.items():
            v = torch.as_tensor(value)
            new[key] = v.expand(self.length(), *v.shape).clone()
        return self.replace(metadata=new)

    def filter(self, filter_fn: Callable[[Any], torch.Tensor]) -> "SimulatorTrajectory":
        """Keep the states where ``filter_fn(metadata)`` is True."""
        return self.slice(torch.nonzero(torch.as_tensor(filter_fn(self.metadata))).reshape(-1))

    def slice(self, key) -> "SimulatorTrajectory":
        """Slice along the state axis (an int keeps a length-1 axis)."""
        if isinstance(key, int):
            key = slice(key, key + 1)
        if not isinstance(key, slice):
            key = torch.as_tensor(np.asarray(key), device=self.center.device).long()

        def take(x):
            return None if x is None else x[key, ...]

        metadata = None if self.metadata is None else tree_map(take, self.metadata)
        return self.replace(center=take(self.center), orientation=take(self.orientation),
                            box_size=take(self.box_size), temperature=take(self.temperature), metadata=metadata)

    @classmethod
    def concat(cls, trajectories: list["SimulatorTrajectory"]) -> "SimulatorTrajectory":
        """Concatenate along the state axis, NaN-filling missing metadata."""
        if not trajectories:
            raise ValueError("Cannot concatenate an empty list of trajectories.")
        if len(trajectories) == 1:
            return trajectories[0]
        return trajectories[0].replace(
            center=torch.cat([t.center for t in trajectories]),
            orientation=torch.cat([t.orientation for t in trajectories]),
            box_size=_concat_optional_field([t.box_size for t in trajectories], "box sizes"),
            temperature=_concat_optional_field([t.temperature for t in trajectories], "temperatures"),
            metadata=_merge_metadata([t.metadata for t in trajectories], [t.length() for t in trajectories]),
        )

    def __add__(self, other: "SimulatorTrajectory") -> "SimulatorTrajectory":
        return self.__class__.concat([self, other])

    def to_file(self, filepath, box_size=(0, 0, 0)) -> None:
        """Write in oxDNA text format (times synthesized, velocities and
        energies zeroed); each state's box where the trajectory has one."""
        a1, _, a3 = (torch.stack(tuple(v), -1) for v in quat_frame_soa(Quat(*self.orientation.unbind(-1))))
        center = self.center.detach().double().cpu().numpy()
        a1, a3 = a1.detach().double().cpu().numpy(), a3.detach().double().cpu().numpy()
        boxes = None if self.box_size is None else self.box_size.detach().cpu().numpy()
        with Path(filepath).open("w") as f:
            for i in range(self.length()):
                state = np.hstack([center[i], a1[i], a3[i], np.zeros((center.shape[1], 6))])
                _write_state(f, time=float(i), energies=np.zeros(3), state=state,
                             box_size=boxes[i] if boxes is not None else box_size)


def _concat_optional_field(values: list, label: str):
    if all(v is None for v in values):
        return None
    if any(v is None for v in values):
        raise ValueError(f"Cannot concatenate, trajectories have incompatible {label}.")
    return torch.cat(values)


def _merge_metadata(metadata_list: list, lengths: list[int]):
    if all(not m for m in metadata_list):
        return None
    dicts = [dict(m) if m else {} for m in metadata_list]
    for key in {k for d in dicts for k in d}:
        present = [d[key] for d in dicts if key in d]
        shape = present[0].shape[1:]
        if any(p.shape[1:] != shape for p in present[1:]):
            raise ValueError(f"Metadata key '{key}' has mismatched shapes when adding trajectories.")
        # NaN needs a floating type: the fill of a missing boolean flag is
        # floating, and the concatenation promotes the flag to it
        dtype = present[0].dtype if present[0].is_floating_point() else torch.get_default_dtype()
        for d, length in zip(dicts, lengths, strict=True):
            d.setdefault(key, torch.full((length, *shape), torch.nan, dtype=dtype, device=present[0].device))
    return tree_concatenate(dicts)
