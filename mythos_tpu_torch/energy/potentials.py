"""Analytic potential primitives of the oxDNA models.

Counterpart of mythos_tpu/energy/potentials.py (eqs. 2.1-2.6 of the oxDNA
thesis), elementwise on tensors.
"""

import torch


def v_morse(r, eps, r0, a):
    """Morse well for stacking / hydrogen bonding (eq. 2.2)."""
    return eps * (1 - torch.exp(-(r - r0) * a)) ** 2


def v_harmonic(r, k, r0):
    """Harmonic well for cross/coaxial stacking (eq. 2.3)."""
    return k / 2 * (r - r0) ** 2


def v_lj(r, eps, sigma):
    """Lennard-Jones repulsion (eq. 2.4)."""
    return 4 * eps * ((sigma / r) ** 12 - (sigma / r) ** 6)


def v_mod(theta, a, theta0):
    """Quadratic angular modulation (eq. 2.5)."""
    return 1 - a * (theta - theta0) ** 2


def v_smooth(x, b, x_c):
    """Quadratic truncation smoothing (eq. 2.6)."""
    return b * (x_c - x) ** 2
