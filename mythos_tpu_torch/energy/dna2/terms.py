"""oxDNA2-specific terms: stacking site override, the f4+f6 coaxial
stacking, and Debye-Hueckel electrostatics.

Counterpart of mythos_tpu/energy/dna2/terms.py; FENE, excluded volumes, HB
and cross stacking are the dna1 terms with dna2 parameter values.
"""

from __future__ import annotations

import math

import torch

import mythos_tpu_torch.energy.dna1.terms as t1
import mythos_tpu_torch.energy.functions as bf
import mythos_tpu_torch.energy.smoothing as sm
from mythos_tpu_torch.energy.base import BaseConfiguration
from mythos_tpu_torch.energy.dna1 import geometry as geom
from mythos_tpu_torch.soa import vnorm


class Stacking(t1.Stacking):
    """dna1 stacking evaluated against the dna1-compatible backbone site."""

    site = "back_dna1"


_COAX_ANGLES = (4, 1, 5, 6)


class CoaxialStackingConfiguration(BaseConfiguration):
    """oxDNA2 coax: f4(theta1) augmented by the one-sided quadratic f6."""

    required_params = (
        "dr_low_coax", "dr_high_coax", "k_coax", "dr0_coax", "dr_c_coax",
        *(f"{pre}_coax_{k}" for k in _COAX_ANGLES for pre in ("theta0", "delta_theta_star", "a")),
        "a_coax_1_f6", "b_coax_1_f6",
    )
    dependent_params = (
        "b_low_coax", "dr_c_low_coax", "b_high_coax", "dr_c_high_coax",
        *(f for k in _COAX_ANGLES for f in (f"b_coax_{k}", f"delta_theta_coax_{k}_c")),
    )

    def derive(self) -> dict:
        b_low, dr_c_low, b_high, dr_c_high = sm.get_f2_smoothing_params(
            self.dr0_coax, self.dr_c_coax, self.dr_low_coax, self.dr_high_coax
        )
        out = {
            "b_low_coax": b_low, "dr_c_low_coax": dr_c_low,
            "b_high_coax": b_high, "dr_c_high_coax": dr_c_high,
        }
        for k in _COAX_ANGLES:
            b, dth_c = sm.get_f4_smoothing_params(
                getattr(self, f"a_coax_{k}"), getattr(self, f"theta0_coax_{k}"),
                getattr(self, f"delta_theta_star_coax_{k}"),
            )
            out[f"b_coax_{k}"], out[f"delta_theta_coax_{k}_c"] = b, dth_c
        return out


def coax_value(p, g: geom.CoaxGeometry):
    """oxDNA2 coaxial stacking of one pair (no phi modulations)."""
    f2_r = bf.f2(
        torch.clamp(g.r_stack, min=1e-8), r_low=p.dr_low_coax, r_high=p.dr_high_coax,
        r_c_low=p.dr_c_low_coax, r_c_high=p.dr_c_high_coax, k=p.k_coax,
        r0=p.dr0_coax, r_c=p.dr_c_coax, b_low=p.b_low_coax, b_high=p.b_high_coax,
    )

    def sym(k, t):
        return t1.f4_of(p, "coax", k, t) + t1.f4_of(p, "coax", k, math.pi - t)

    return (
        f2_r
        * t1.f4_of(p, "coax", 4, g.theta4)
        * (t1.f4_of(p, "coax", 1, g.theta1) + bf.f6(g.theta1, p.a_coax_1_f6, p.b_coax_1_f6))
        * sym(5, g.theta5)
        * sym(6, g.theta6)
    )


class CoaxialStacking(t1._UnbondedPairs):
    """oxDNA2 coaxial stacking over unbonded pairs."""

    def pair_cutoff(self) -> float:
        return float(self.params.dr_c_high_coax)

    def pair_energies(self, si, sj) -> torch.Tensor:
        return coax_value(self.params, geom.coax_geometry_vec(si.stack, sj.stack, si.a1, sj.a1, si.a3, sj.a3,
                                                              disp=self.disp))


def debye_potential(r, kappa, prefactor, smoothing_coeff, r_cut, r_high):
    """Screened Coulomb with quadratic smoothing to r_cut."""
    r_safe = torch.clamp(r, min=1e-8)
    energy_full = torch.exp(-kappa * r_safe) * (prefactor / r_safe)
    energy_smooth = smoothing_coeff * (r - r_cut) ** 2
    energy = torch.where(r < r_high, energy_full, energy_smooth)
    return torch.where(r < r_cut, energy, torch.zeros_like(r))


class DebyeConfiguration(BaseConfiguration):
    """Debye-Hueckel: lambda/kappa/prefactor/r_cut derived from kt and salt."""

    required_params = ("q_eff", "lambda_factor", "prefactor_coeff", "kt", "salt_conc", "half_charged_ends")
    dependent_params = ("lambda_", "kappa", "r_high", "prefactor", "smoothing_coeff", "r_cut")

    def derive(self) -> dict:
        # kt and salt may come as Python floats (with_params(salt_conc=0.1))
        kt, salt = (torch.as_tensor(v, dtype=self.lambda_factor.dtype, device=self.lambda_factor.device)
                    for v in (self.kt, self.salt_conc))
        lambda_ = self.lambda_factor * torch.sqrt(kt / 0.1) / torch.sqrt(salt)
        r_high = 3.0 * lambda_
        prefactor = self.prefactor_coeff * self.q_eff**2
        smoothing_coeff = -(torch.exp(-r_high / lambda_) * prefactor * (r_high + lambda_) ** 2) / (
            -4.0 * r_high**3 * lambda_**2
        )
        r_cut = r_high * (prefactor * r_high + 3.0 * prefactor * lambda_) / (prefactor * (r_high + lambda_))
        return {
            "lambda_": lambda_, "kappa": 1.0 / lambda_, "r_high": r_high,
            "prefactor": prefactor, "smoothing_coeff": smoothing_coeff, "r_cut": r_cut,
        }


def debye_of(p, r):
    return debye_potential(r, p.kappa, p.prefactor, p.smoothing_coeff, p.r_cut, p.r_high)


class Debye(t1._UnbondedPairs):
    """Debye-Hueckel electrostatics between backbone sites."""

    def charge_factors(self, like: torch.Tensor) -> torch.Tensor:
        """(n,) per-nucleotide charge factor: 0.5 at strand ends when
        ``half_charged_ends``, else 1."""
        is_end = torch.as_tensor(self.topology.is_end, device=like.device).bool()
        half = torch.where(is_end, 0.5, 1.0).to(like.dtype)
        return half if bool(self.params.half_charged_ends) else torch.ones_like(half)

    def pair_cutoff(self) -> float:
        return float(self.params.r_cut)

    def pair_energies(self, si, sj) -> torch.Tensor:
        r = vnorm(self.disp(sj.back, si.back))
        qf = self.charge_factors(r)
        return debye_of(self.params, r) * qf[si.idx] * qf[sj.idx]
