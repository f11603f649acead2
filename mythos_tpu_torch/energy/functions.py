"""Piecewise smoothed base functions f1-f6 of the oxDNA models.

Counterpart of mythos_tpu/energy/functions.py, with the same nested
``where`` branch order. The CUDA kernels carry hand-written value and
derivative twins of these (``ops/csrc/stencil_physics.cuh``).
"""

from __future__ import annotations

import torch

import mythos_tpu_torch.energy.potentials as pot


def _w(cond, a, b):
    return torch.where(cond, a, b)


def f1(r, r_low, r_high, r_c_low, r_c_high, eps, a, r0, r_c, b_low, b_high):
    """Radial part of stacking / hydrogen bonding (Morse, smoothed tails)."""
    zero = torch.zeros_like(r)
    oob = _w(
        (r_c_low < r) & (r < r_low),
        eps * pot.v_smooth(r, b_low, r_c_low),
        _w((r_high < r) & (r < r_c_high), eps * pot.v_smooth(r, b_high, r_c_high), zero),
    )
    return _w(
        (r_low < r) & (r < r_high),
        pot.v_morse(r, eps, r0, a) - pot.v_morse(r_c, eps, r0, a),
        oob,
    )


def f2(r, r_low, r_high, r_c_low, r_c_high, k, r0, r_c, b_low, b_high):
    """Radial part of cross/coaxial stacking (harmonic, smoothed tails)."""
    zero = torch.zeros_like(r)
    oob = _w(
        (r_c_low < r) & (r < r_low),
        k * pot.v_smooth(r, b_low, r_c_low),
        _w((r_high < r) & (r < r_c_high), k * pot.v_smooth(r, b_high, r_c_high), zero),
    )
    return _w(
        (r_low < r) & (r < r_high),
        pot.v_harmonic(r, k, r0) - pot.v_harmonic(r_c, k, r0),
        oob,
    )


def f3(r, r_star, r_c, eps, sigma, b):
    """Radial part of excluded volume (LJ with smoothed cutoff)."""
    oob = _w((r_star < r) & (r < r_c), eps * pot.v_smooth(r, b, r_c), torch.zeros_like(r))
    return _w(r < r_star, pot.v_lj(r, eps, sigma), oob)


def f4(theta, theta0, delta_theta_star, delta_theta_c, a, b):
    """Angular modulation used by every anisotropic term."""
    zero = torch.zeros_like(theta)
    oob = _w(
        (theta0 - delta_theta_c < theta) & (theta < theta0 - delta_theta_star),
        pot.v_smooth(theta, b, theta0 - delta_theta_c),
        _w(
            (theta0 + delta_theta_star < theta) & (theta < theta0 + delta_theta_c),
            pot.v_smooth(theta, b, theta0 + delta_theta_c),
            zero,
        ),
    )
    return _w(
        (theta0 - delta_theta_star < theta) & (theta < theta0 + delta_theta_star),
        pot.v_mod(theta, a, theta0),
        oob,
    )


def f5(x, x_star, x_c, a, b):
    """One-sided modulation imposing right-handedness."""
    zero = torch.zeros_like(x)
    return _w(
        x > 0.0,
        torch.ones_like(x),
        _w(
            (x_star < x) & (x < 0.0),
            pot.v_mod(x, a, 0),
            _w((x_c < x) & (x < x_star), pot.v_smooth(x, b, x_c), zero),
        ),
    )


def f6(theta, a, theta0):
    """One-sided quadratic modulation (oxDNA2 coaxial stacking)."""
    return _w(theta > theta0, 0.5 * a * (theta - theta0) ** 2, torch.zeros_like(theta))
