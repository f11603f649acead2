"""Closed-form smoothing-parameter solvers for the piecewise base functions.

Counterpart of mythos_tpu/energy/smoothing.py: a truncation quadratic
``s(r) = B (x_s - r)^2`` matching the target's value g and slope g' at x has
B = g'^2 / (4 g) and x_s = x - 2 g / g'. Runs on tensors, so parameter
gradients flow through the derivation under autograd.
"""

from __future__ import annotations

import torch


def _match_quadratic(g, gp):
    return gp * gp / (4.0 * g), -2.0 * g / gp


def _morse_shifted(x, a, x0, xc):
    ex = torch.exp(-a * (x - x0))
    exc = torch.exp(-a * (xc - x0))
    return (1.0 - ex) ** 2 - (1.0 - exc) ** 2, 2.0 * a * ex * (1.0 - ex)


def get_f1_smoothing_params(x0, a, xc, x_low, x_high):
    """(b_low, x_c_low, b_high, x_c_high) for the Morse-based f1."""
    b_lo, off_lo = _match_quadratic(*_morse_shifted(x_low, a, x0, xc))
    b_hi, off_hi = _match_quadratic(*_morse_shifted(x_high, a, x0, xc))
    return b_lo, x_low + off_lo, b_hi, x_high + off_hi


def _harmonic_shifted(x, x0, xc):
    return 0.5 * ((x - x0) ** 2 - (xc - x0) ** 2), x - x0


def get_f2_smoothing_params(x0, xc, x_low, x_high):
    """(b_low, x_c_low, b_high, x_c_high) for the harmonic-based f2."""
    b_lo, off_lo = _match_quadratic(*_harmonic_shifted(x_low, x0, xc))
    b_hi, off_hi = _match_quadratic(*_harmonic_shifted(x_high, x0, xc))
    return b_lo, x_low + off_lo, b_hi, x_high + off_hi


def get_f3_smoothing_params(r_star, sigma):
    """(b, x_c) for the LJ-based f3, matching v_lj at r_star."""
    s6 = (sigma / r_star) ** 6
    g = 4.0 * (s6 * s6 - s6)
    gp = 4.0 * (-12.0 * s6 * s6 + 6.0 * s6) / r_star
    b, off = _match_quadratic(g, gp)
    return b, r_star + off


def get_f4_smoothing_params(a, x0, delta_x_star):
    """(b, delta_x_c) for the angular-modulation f4."""
    g = 1.0 - a * delta_x_star**2
    gp = -2.0 * a * delta_x_star
    b, off = _match_quadratic(g, gp)
    return b, delta_x_star + off


def get_f5_smoothing_params(a, x_star):
    """(b, x_c) for the one-sided f5, matching v_mod(., a, 0) at x_star."""
    g = 1.0 - a * x_star**2
    gp = -2.0 * a * x_star
    b, off = _match_quadratic(g, gp)
    return b, x_star + off
