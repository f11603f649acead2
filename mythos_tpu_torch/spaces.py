"""Simulation spaces: free and periodic displacement/shift functions.

Counterpart of mythos_tpu/spaces.py (``free`` and ``periodic``). The
convention is jax-md's: ``displacement(ra, rb)`` is the minimum-image
vector from rb to ra, ``ra - rb`` in free space. Both broadcast over
leading axes. The periodic box may be a tensor that requires grad: the
minimum image ``dr - box * round(dr / box)`` then differentiates in the
box, with ``round`` contributing nothing (its derivative is zero, in
PyTorch as in JAX) -- the image term of a virial.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

Displacement = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Shift = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Space = tuple[Displacement, Shift]


def free() -> Space:
    """Unbounded space."""

    def displacement(ra: torch.Tensor, rb: torch.Tensor) -> torch.Tensor:
        return ra - rb

    def shift(r: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
        return r + dr

    displacement.is_periodic = shift.is_periodic = False
    return displacement, shift


def periodic(box_size) -> Space:
    """Orthorhombic periodic box (a scalar or (3,)) with minimum-image
    displacements; ``shift`` wraps into [0, box)."""

    def displacement(ra: torch.Tensor, rb: torch.Tensor) -> torch.Tensor:
        dr = ra - rb
        box = torch.as_tensor(box_size, dtype=dr.dtype, device=dr.device)
        return dr - box * torch.round(dr / box)

    def shift(r: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
        box = torch.as_tensor(box_size, dtype=r.dtype, device=r.device)
        return torch.remainder(r + dr, box)

    displacement.is_periodic = shift.is_periodic = True
    return displacement, shift
