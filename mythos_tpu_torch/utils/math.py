"""Numerics helpers: smooth primitives and the polynomial arccos.

Counterpart of mythos_tpu/utils/math.py. Clamps and branches are written
with ``torch.where`` (not ``torch.clamp``/``torch.abs``) so that autograd
takes the same branch at ties as JAX does: JAX differentiates |x| as
select(x >= 0, 1, -1), torch.abs as sign(x), which is 0 at x = 0.
"""

from __future__ import annotations

import math

import torch

#: Abramowitz & Stegun 4.4.45 coefficients, highest degree first
_ACOS_COEFFS = (
    -0.0012624911,
    0.0066700901,
    -0.0170881256,
    0.0308918810,
    -0.0501743046,
    0.0889789874,
    -0.2145988016,
    1.5707963050,
)


def smooth_abs(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """|x| with continuous first derivatives (sqrt(x^2 + eps))."""
    return torch.sqrt(x * x + eps)


def clamp(x: torch.Tensor, lo: float = -1.0, hi: float = 1.0) -> torch.Tensor:
    """Clamp into [lo, hi] with zero gradient outside (JAX's where form)."""
    clipped = torch.where(x >= hi, torch.full_like(x, hi), x)
    return torch.where(clipped <= lo, torch.full_like(x, lo), clipped)


def _clamp_eps(x: torch.Tensor) -> float:
    dtype = x.dtype if x.dtype in (torch.float32, torch.float64) else torch.float32
    return 8 * torch.finfo(dtype).eps


def safe_arccos(x: torch.Tensor) -> torch.Tensor:
    """arccos clamped a few ulps inside (-1, 1): finite gradient at |x|=1."""
    eps = _clamp_eps(x)
    return torch.arccos(clamp(x, -1.0 + eps, 1.0 - eps))


def arccos_poly(x: torch.Tensor) -> torch.Tensor:
    """Polynomial arccos (|abs error| <= 2e-8), the stencil kernels' acos.

    Same approximant, clamp and branch structure as the reference
    ``mythos_tpu.utils.math.arccos_poly``.
    """
    eps = _clamp_eps(x)
    xc = clamp(x, -1.0 + eps, 1.0 - eps)
    a = torch.where(xc < 0, -xc, xc)
    p = torch.full_like(a, _ACOS_COEFFS[0])
    for c in _ACOS_COEFFS[1:]:
        p = p * a + c
    r = torch.sqrt(1.0 - a) * p
    return torch.where(xc < 0, math.pi - r, r)
