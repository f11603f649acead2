"""Membrane observables: area per lipid and thickness.

Counterpart of mythos_tpu/observables/membranes.py:27-72. Leaflets are
assigned by the sign of a head bead's z relative to the membrane midplane
(the mean head z; valid for flat bilayers). The melting temperature
(``MembraneMeltingTemp``) waits for the port of utils/fits.py.
"""

from __future__ import annotations

import dataclasses as dc

import torch


@dc.dataclass(frozen=True)
class AreaPerLipid:
    """Mean area per lipid (nm^2) per state.

    ``head_indices``: bead indices used for leaflet assignment (one per
    lipid, e.g. the PO4 beads).
    """

    head_indices: object

    def __call__(self, trajectory) -> torch.Tensor:
        """(n_states,) area per lipid: the lateral box area over the lipids
        of each leaflet, averaged over both leaflets."""
        heads = torch.as_tensor(self.head_indices, device=trajectory.center.device).long()
        z = trajectory.center[:, heads, 2]
        upper = z > z.mean(dim=1, keepdim=True)
        n_upper = upper.sum(1).to(z.dtype)
        n_lower = heads.shape[0] - n_upper
        box = trajectory.box_size
        lateral_area = box[:, 0] * box[:, 1]
        return 0.5 * (lateral_area / n_upper + lateral_area / n_lower)


@dc.dataclass(frozen=True)
class MembraneThickness:
    """Mean membrane thickness (nm) per state: the mean z of the reference
    beads above the midplane minus that of those below."""

    thickness_indices: object

    def __call__(self, trajectory) -> torch.Tensor:
        """(n_states,) thickness."""
        beads = torch.as_tensor(self.thickness_indices, device=trajectory.center.device).long()
        z = trajectory.center[:, beads, 2]
        upper = z > z.mean(dim=1, keepdim=True)
        zero = torch.zeros_like(z)
        z_up = torch.where(upper, z, zero).sum(1) / upper.sum(1)
        z_lo = torch.where(upper, zero, z).sum(1) / (~upper).sum(1)
        return z_up - z_lo
