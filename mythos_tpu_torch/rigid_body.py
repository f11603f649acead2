"""Rigid-body container: centers (..., 3) and unit quaternions (..., 4).

Counterpart of the AoS ``RigidBody`` of mythos_tpu/rigid_body.py.
Quaternions are scalar-first (w, x, y, z).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RigidBody(NamedTuple):
    """Rigid bodies: ``center`` (..., 3), ``orientation`` (..., 4)."""

    center: torch.Tensor
    orientation: torch.Tensor

