"""Propeller twist observable.

Counterpart of mythos_tpu/observables/propeller.py: the mean, over the
hydrogen-bonded base pairs, of 180 degrees minus the angle between the two
base normals (a3), per trajectory state.
"""

from __future__ import annotations

import dataclasses as dc
import math

import torch

from mythos_tpu_torch.observables.base import BaseObservable
from mythos_tpu_torch.rigid_body import RigidBody
from mythos_tpu_torch.soa import vdot
from mythos_tpu_torch.utils.math import safe_arccos

TARGETS = {
    "oxDNA": 21.7,  # degrees
}


@dc.dataclass(frozen=True)
class PropellerTwist(BaseObservable):
    """Mean propeller twist (degrees) per state. ``rigid_body_transform_fn``
    maps a RigidBody to nucleotides with base normals ``a3`` (e.g.
    energy.dna2.default_transform_soa_fn()); ``h_bonded_base_pairs`` is a
    (P, 2) index array."""

    h_bonded_base_pairs: torch.Tensor = dc.field(default=None, hash=False)

    def __call__(self, trajectory) -> torch.Tensor:
        """(S,) propeller twist in degrees."""
        nuc = self.rigid_body_transform_fn(RigidBody(trajectory.center, trajectory.orientation))
        bps = torch.as_tensor(self.h_bonded_base_pairs, device=trajectory.center.device).long()
        a3 = nuc.a3  # Vec3 of (S, N)
        nv1 = type(a3)(*(c[:, bps[:, 0]] for c in a3))
        nv2 = type(a3)(*(c[:, bps[:, 1]] for c in a3))
        twist = 180.0 - safe_arccos(vdot(nv1, nv2)) * (180.0 / math.pi)
        return twist.mean(dim=1)
