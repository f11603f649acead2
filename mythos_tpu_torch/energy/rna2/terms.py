"""oxRNA2-specific terms: stacking (theta5, 6, 9, 10 on the 3'/5' sites)
and cross stacking (no theta4).

Counterpart of mythos_tpu/energy/rna2/terms.py. The other terms are shared:
FENE, excluded volumes, hydrogen bonding and coaxial stacking from dna1,
Debye-Hueckel from dna2, with rna2 parameter values. Each term's pair
physics is a module-level function of its parameters and a geometry tuple,
shared by the pair-list path here and the stencil's plain versions
(ops/stencil.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

import mythos_tpu_torch.energy.dna1.terms as t1
import mythos_tpu_torch.energy.functions as bf
import mythos_tpu_torch.energy.smoothing as sm
from mythos_tpu_torch.energy import seqdep
from mythos_tpu_torch.energy.base import BaseConfiguration
from mythos_tpu_torch.energy.dna1 import geometry as geom
from mythos_tpu_torch.soa import Vec3, vdot, vnorm
from mythos_tpu_torch.utils.math import safe_arccos

_STACK_ANGLES = (5, 6, 9, 10)


class StackingConfiguration(BaseConfiguration):
    """f1(r) x f4(theta5, 6, 9, 10) x f5(-cos phi1) x f5(-cos phi2); the
    sequence weights ``(eps_stack_base + eps_stack_kt_coeff kt)`` times the
    sequence-averaged table, or with ``ss_stack_weights`` that table x (1 +
    kt eps_stack_kt_coeff) (oxRNA2's temperature law)."""

    required_params = (
        "eps_stack_base", "eps_stack_kt_coeff", "dr_low_stack", "dr_high_stack", "a_stack", "dr0_stack",
        "dr_c_stack",
        *(f"{pre}_stack_{k}" for k in _STACK_ANGLES for pre in ("theta0", "delta_theta_star", "a")),
        "neg_cos_phi1_star_stack", "a_stack_1", "neg_cos_phi2_star_stack", "a_stack_2", "kt",
    )
    dependent_params = (
        "b_low_stack", "dr_c_low_stack", "b_high_stack", "dr_c_high_stack",
        *(f for k in _STACK_ANGLES for f in (f"b_stack_{k}", f"delta_theta_stack_{k}_c")),
        "b_neg_cos_phi1_stack", "neg_cos_phi1_c_stack", "b_neg_cos_phi2_stack", "neg_cos_phi2_c_stack",
        "eps_stack",
    )

    optional_params = (*t1.PSEQ_FIELDS, "ss_stack_weights")

    def derive(self) -> dict:
        t1._check_pseq(self)
        if self.ss_stack_weights is None:
            eps = self.eps_stack_base + self.eps_stack_kt_coeff * self.kt
            eps_stack = eps * t1._table(seqdep.STACK_WEIGHTS_SA, eps)
        else:
            eps_stack = t1._table(self.ss_stack_weights, self.kt) * (1.0 + self.kt * self.eps_stack_kt_coeff)
        b_low, dr_c_low, b_high, dr_c_high = sm.get_f1_smoothing_params(
            self.dr0_stack, self.a_stack, self.dr_c_stack, self.dr_low_stack, self.dr_high_stack
        )
        out = {
            "b_low_stack": b_low, "dr_c_low_stack": dr_c_low,
            "b_high_stack": b_high, "dr_c_high_stack": dr_c_high,
            "eps_stack": eps_stack,
        }
        for k in _STACK_ANGLES:
            b, dth_c = sm.get_f4_smoothing_params(
                getattr(self, f"a_stack_{k}"), getattr(self, f"theta0_stack_{k}"),
                getattr(self, f"delta_theta_star_stack_{k}"),
            )
            out[f"b_stack_{k}"], out[f"delta_theta_stack_{k}_c"] = b, dth_c
        for k in (1, 2):
            b, c = sm.get_f5_smoothing_params(getattr(self, f"a_stack_{k}"), getattr(self, f"neg_cos_phi{k}_star_stack"))
            out[f"b_neg_cos_phi{k}_stack"], out[f"neg_cos_phi{k}_c_stack"] = b, c
        return out


class StackGeometry(NamedTuple):
    """Angle set of oxRNA2 stacking of a bond (i the 3'-side)."""

    r_stack: torch.Tensor
    theta5: torch.Tensor
    theta6: torch.Tensor
    theta9: torch.Tensor
    theta10: torch.Tensor
    cosphi1: torch.Tensor
    cosphi2: torch.Tensor


def stack_geometry_vec(
    stack5_i: Vec3, stack3_j: Vec3, back_i: Vec3, back_j: Vec3, n_i: Vec3, n_j: Vec3,
    p5_i: Vec3, p3_j: Vec3, a2_i: Vec3, a2_j: Vec3, arccos=safe_arccos,
) -> StackGeometry:
    """dr_stack = stack5[i] - stack3[j], dr_back = back[i] - back[j] (i the
    3'-side); ``p5_i``/``p3_j`` the p5 axis of i and the p3 axis of j."""
    dr_stack = stack5_i - stack3_j
    r_stack = vnorm(dr_stack)
    u = dr_stack * (1.0 / r_stack)
    dr_back = back_i - back_j
    ub = dr_back * (1.0 / vnorm(dr_back))
    return StackGeometry(
        r_stack=r_stack,
        theta5=math.pi - arccos(vdot(n_j, u)),
        theta6=math.pi - arccos(vdot(n_i, u)),
        theta9=arccos(-vdot(p3_j, ub)),
        theta10=arccos(-vdot(p5_i, ub)),
        cosphi1=-vdot(a2_i, ub),
        cosphi2=-vdot(a2_j, ub),
    )


def stack_product(p, g: StackGeometry):
    """The sequence-independent stacking product (eps = 1)."""
    val = bf.f1(
        g.r_stack, r_low=p.dr_low_stack, r_high=p.dr_high_stack,
        r_c_low=p.dr_c_low_stack, r_c_high=p.dr_c_high_stack, eps=1.0,
        a=p.a_stack, r0=p.dr0_stack, r_c=p.dr_c_stack,
        b_low=p.b_low_stack, b_high=p.b_high_stack,
    )
    for k, theta in zip(_STACK_ANGLES, (g.theta5, g.theta6, g.theta9, g.theta10), strict=True):
        val = val * t1.f4_of(p, "stack", k, theta)
    return (
        val
        * bf.f5(-g.cosphi1, p.neg_cos_phi1_star_stack, p.neg_cos_phi1_c_stack, p.a_stack_1, p.b_neg_cos_phi1_stack)
        * bf.f5(-g.cosphi2, p.neg_cos_phi2_star_stack, p.neg_cos_phi2_c_stack, p.a_stack_2, p.b_neg_cos_phi2_stack)
    )


class Stacking(t1._BondedPairs):
    """oxRNA2 stacking over bonded pairs (3'-side stack5 to 5'-side stack3);
    under a probabilistic sequence each bond's expected weight
    (``seqdep.pair_weights``), as the reference's pair list."""

    def bond_energies(self, nuc) -> torch.Tensor:
        i, j = self.bond_index(nuc.back.x.device)
        g = stack_geometry_vec(
            geom.gather(nuc.stack5, i), geom.gather(nuc.stack3, j),
            geom.gather(nuc.back, i), geom.gather(nuc.back, j),
            geom.gather(nuc.a3, i), geom.gather(nuc.a3, j),
            geom.gather(nuc.bb_p5, i), geom.gather(nuc.bb_p3, j),
            geom.gather(nuc.a2, i), geom.gather(nuc.a2, j),
        )
        p = self.params
        if p.pseq is not None:
            w = seqdep.pair_weights(p.pseq, i, j, p.eps_stack, p.pseq_constraints)
        else:
            seq = self.seq_index(g.r_stack.device)
            w = p.eps_stack[seq[i], seq[j]]
        return w * stack_product(p, g)


_CROSS_ANGLES = (1, 2, 3, 7, 8)


class CrossStackingConfiguration(BaseConfiguration):
    """oxRNA2 cross stacking: dna1's without the theta4 modulation."""

    required_params = (
        "dr_low_cross", "dr_high_cross", "k_cross", "r0_cross", "dr_c_cross",
        *(f"{pre}_cross_{k}" for k in _CROSS_ANGLES for pre in ("theta0", "delta_theta_star", "a")),
    )
    dependent_params = (
        "b_low_cross", "dr_c_low_cross", "b_high_cross", "dr_c_high_cross",
        *(f for k in _CROSS_ANGLES for f in (f"b_cross_{k}", f"delta_theta_cross_{k}_c")),
    )

    def derive(self) -> dict:
        b_low, dr_c_low, b_high, dr_c_high = sm.get_f2_smoothing_params(
            self.r0_cross, self.dr_c_cross, self.dr_low_cross, self.dr_high_cross
        )
        out = {
            "b_low_cross": b_low, "dr_c_low_cross": dr_c_low,
            "b_high_cross": b_high, "dr_c_high_cross": dr_c_high,
        }
        for k in _CROSS_ANGLES:
            b, dth_c = sm.get_f4_smoothing_params(
                getattr(self, f"a_cross_{k}"), getattr(self, f"theta0_cross_{k}"),
                getattr(self, f"delta_theta_star_cross_{k}"),
            )
            out[f"b_cross_{k}"], out[f"delta_theta_cross_{k}_c"] = b, dth_c
        return out


def cross_value(p, g: geom.UnbondedGeometry):
    """f2 x f4(theta1..3) x symmetrized f4(theta7, theta8); theta4 unused."""
    f2_r = bf.f2(
        torch.clamp(g.r_base, min=1e-8), r_low=p.dr_low_cross, r_high=p.dr_high_cross,
        r_c_low=p.dr_c_low_cross, r_c_high=p.dr_c_high_cross, k=p.k_cross,
        r0=p.r0_cross, r_c=p.dr_c_cross, b_low=p.b_low_cross, b_high=p.b_high_cross,
    )

    def sym(k, t):
        return t1.f4_of(p, "cross", k, t) + t1.f4_of(p, "cross", k, math.pi - t)

    return (
        f2_r
        * t1.f4_of(p, "cross", 1, g.theta1)
        * t1.f4_of(p, "cross", 2, g.theta2)
        * t1.f4_of(p, "cross", 3, g.theta3)
        * sym(7, g.theta7)
        * sym(8, g.theta8)
    )


class CrossStacking(t1._UnbondedPairs):
    """oxRNA2 cross stacking over unbonded pairs (theta1, 2, 3, 7, 8)."""

    def pair_cutoff(self) -> float:
        return float(self.params.dr_c_high_cross)

    def pair_energies(self, si, sj) -> torch.Tensor:
        return cross_value(self.params, geom.unbonded_geometry_vec(si.base, sj.base, si.a1, sj.a1, si.a3, sj.a3))
