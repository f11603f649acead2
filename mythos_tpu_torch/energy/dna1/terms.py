"""The oxDNA1 terms (several of which oxDNA2 and oxRNA2 share): FENE,
excluded volumes, stacking, hydrogen bonding, cross stacking and coaxial
stacking.

Counterpart of mythos_tpu/energy/dna1/terms.py. Each term's pair physics
is a module-level product function of its parameters (anything with the
configuration's attribute names) and a geometry tuple, shared by the
pair-list and dense paths here and the stencil band twin (ops/stencil.py).
The unbonded terms evaluate either a pair list or, with ``dense_mask``,
every (i, j) by broadcasts under the mask (:class:`_UnbondedPairs`).
Stacking and hydrogen bonding take a probabilistic sequence (``pseq``,
with its ``pseq_constraints``; energy/seqdep.py) in place of the
topology's sequence, and a sequence-dependent weight table
(``ss_stack_weights``/``ss_hb_weights``, io.sequence_dependence).
"""

from __future__ import annotations

import math

import torch

import mythos_tpu_torch.energy.functions as bf
import mythos_tpu_torch.energy.smoothing as sm
from mythos_tpu_torch.energy import blocks, seqdep
from mythos_tpu_torch.energy.base import BaseConfiguration, BaseEnergyFunction
from mythos_tpu_torch.energy.dna1 import geometry as geom
from mythos_tpu_torch.soa import vnorm
from mythos_tpu_torch.utils.math import smooth_abs


ERR_PSEQ_CONSTRAINTS = "pseq_constraints must be provided when pseq is provided."
#: the configuration fields of a probabilistic sequence
PSEQ_FIELDS = ("pseq", "pseq_constraints")


def _table(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def _check_pseq(cfg) -> None:
    if cfg.pseq is not None and cfg.pseq_constraints is None:
        raise ValueError(ERR_PSEQ_CONSTRAINTS)


def v_fene_smooth(r, eps_backbone, r0_backbone, delta_backbone, fmax=500.0, finf=4.0):
    """FENE with the log divergence replaced by a linear tail beyond xmax."""
    eps, r0, delt = eps_backbone, r0_backbone, delta_backbone
    diff = smooth_abs(r - r0)
    xmax = (-eps + torch.sqrt(eps**2 + 4.0 * fmax**2 * delt**2)) / (2.0 * fmax)
    fene_xmax = -(eps / 2.0) * torch.log(1.0 - xmax**2 / delt**2)
    long_xmax = (fmax - finf) * xmax * torch.log(xmax) + finf * xmax
    smoothed = (fmax - finf) * xmax * torch.log(diff) + finf * diff - long_xmax + fene_xmax
    x2 = torch.clamp(diff**2 / delt**2, max=0.99999)
    fene = -eps / 2.0 * torch.log(1.0 - x2)
    return torch.where(diff > xmax, smoothed, fene)


def exc_vol_f3(r, eps_exc, dr_star, sigma, b, dr_c):
    """f3 with the radius floored at 1e-2 (finite at masked zero distances)."""
    return bf.f3(torch.clamp(r, min=1e-2), r_star=dr_star, r_c=dr_c, eps=eps_exc, sigma=sigma, b=b)


# FENE -----------------------------------------------------------------------


class FeneConfiguration(BaseConfiguration):
    required_params = ("eps_backbone", "r0_backbone", "delta_backbone", "fmax", "finf")


class _BondedPairs(BaseEnergyFunction):
    """A bonded term: ``bond_energies(nuc)``, one value a bond of the
    topology (the oxNA hybrid selects among them), summed."""

    def bond_energies(self, nuc) -> torch.Tensor:
        raise NotImplementedError

    def compute_energy(self, nuc) -> torch.Tensor:
        return self.bond_energies(nuc).sum()


class Fene(_BondedPairs):
    """Smoothed FENE backbone springs over bonded pairs."""

    def bond_energies(self, nuc) -> torch.Tensor:
        i, j = self.bond_index(nuc.back.x.device)
        p = self.params
        r = vnorm(self.disp(geom.gather(nuc.back, i), geom.gather(nuc.back, j)), 0.0)
        return v_fene_smooth(r, p.eps_backbone, p.r0_backbone, p.delta_backbone, p.fmax, p.finf)


# Excluded volumes -------------------------------------------------------------


class BondedExcludedVolumeConfiguration(BaseConfiguration):
    required_params = (
        "eps_exc", "dr_star_base", "sigma_base", "sigma_back_base", "sigma_base_back",
        "dr_star_back_base", "dr_star_base_back",
    )
    dependent_params = (
        "b_base", "dr_c_base", "b_back_base", "dr_c_back_base", "b_base_back", "dr_c_base_back",
    )

    def derive(self) -> dict:
        out = {}
        for fam in ("base", "back_base", "base_back"):
            b, dr_c = sm.get_f3_smoothing_params(
                getattr(self, f"dr_star_{fam}"), getattr(self, f"sigma_{fam}")
            )
            out[f"b_{fam}"], out[f"dr_c_{fam}"] = b, dr_c
        return out


def exc_family(p, fam: str, r):
    """One excluded-volume site family (``base``, ``back_base``, ...)."""
    return exc_vol_f3(
        r, p.eps_exc, getattr(p, f"dr_star_{fam}"), getattr(p, f"sigma_{fam}"),
        getattr(p, f"b_{fam}"), getattr(p, f"dr_c_{fam}"),
    )


class BondedExcludedVolume(_BondedPairs):
    """Excluded volume on bonded pairs (3 site pairs, no backbone-backbone)."""

    def bond_energies(self, nuc) -> torch.Tensor:
        i, j = self.bond_index(nuc.back.x.device)
        base_i, base_j = geom.gather(nuc.base, i), geom.gather(nuc.base, j)
        back_i, back_j = geom.gather(nuc.back, i), geom.gather(nuc.back, j)
        p, disp = self.params, self.disp
        return (
            exc_family(p, "base", vnorm(disp(base_i, base_j)))
            + exc_family(p, "back_base", vnorm(disp(back_i, base_j)))
            + exc_family(p, "base_back", vnorm(disp(base_i, back_j)))
        )


class UnbondedExcludedVolumeConfiguration(BaseConfiguration):
    required_params = (
        "eps_exc", "dr_star_base", "sigma_base", "dr_star_back_base", "sigma_back_base",
        "dr_star_base_back", "sigma_base_back", "dr_star_backbone", "sigma_backbone",
    )
    dependent_params = (
        "b_base", "dr_c_base", "b_back_base", "dr_c_back_base", "b_base_back",
        "dr_c_base_back", "b_backbone", "dr_c_backbone",
    )

    def derive(self) -> dict:
        out = {}
        for fam in ("base", "back_base", "base_back", "backbone"):
            b, dr_c = sm.get_f3_smoothing_params(
                getattr(self, f"dr_star_{fam}"), getattr(self, f"sigma_{fam}")
            )
            out[f"b_{fam}"], out[f"dr_c_{fam}"] = b, dr_c
        return out


def unbonded_exc(p, r_ee, r_eb, r_be, r_bb):
    """Unbonded excluded volume from the four site distances (base-base,
    base_j-back_i, back_j-base_i, back-back)."""
    return (
        exc_family(p, "base", r_ee)
        + exc_family(p, "back_base", r_eb)
        + exc_family(p, "base_back", r_be)
        + exc_family(p, "backbone", r_bb)
    )


class _UnbondedPairs(BaseEnergyFunction):
    """An unbonded term over its pairs (i, j). ``pair_energies(side_i,
    side_j)`` is the term's physics on two :class:`energy.blocks.PairSide`
    views of the nucleotide (any broadcastable shapes; ``side.idx`` the
    nucleotide ids); the term sums it over a pair list (the topology's every
    unbonded i<j pair, a static ``unbonded_neighbors``, or a (2, P) tensor
    padded with N), over every (i, j) at once under ``dense_mask`` (rows i
    against columns j), or over a block table's tiles (``block_ids``:
    energy.blocks.block_pair_sums)."""

    def pair_energies(self, side_i: blocks.PairSide, side_j: blocks.PairSide) -> torch.Tensor:
        raise NotImplementedError

    def pair_cutoff(self) -> float:
        """The site distance beyond which every pair energy is zero."""
        raise NotImplementedError

    def compute_energy(self, nuc) -> torch.Tensor:
        if self.block_ids is not None:
            return blocks.block_pair_sum(self.pair_energies, nuc, self.block_ids, self.block_size,
                                         self.topology.n_nucleotides, self.bonded_neighbors, perm=self.block_perm)
        device = _device_of(nuc)
        n = self.topology.n_nucleotides
        if self.dense_mask is not None:
            idx = torch.arange(n, device=device)
            side_i = blocks.PairSide(nuc, idx[:, None], lambda c: c[:, None])
            side_j = blocks.PairSide(nuc, idx[None, :], lambda c: c[None, :])
            values = self.pair_energies(side_i, side_j)
            return torch.where(self.dense_mask_on(device), values, 0.0).sum()
        i, j = self.unbonded_index(device)
        # a padded list's (n, n) entries read the last nucleotide and are masked
        values = self.pair_energies(blocks.gathered_side(nuc, i.clamp(max=n - 1)),
                                    blocks.gathered_side(nuc, j.clamp(max=n - 1)))
        if isinstance(self.unbonded_neighbors, torch.Tensor):
            values = torch.where(i < n, values, 0.0)
        return values.sum()


def _device_of(nuc) -> torch.device:
    """The device of a nucleotide view (nested views too)."""
    field = nuc[0]
    return field.x.device if hasattr(field, "x") else _device_of(field)


class UnbondedExcludedVolume(_UnbondedPairs):
    """Excluded volume over unbonded pairs (4 site pairs incl. backbones)."""

    def pair_cutoff(self) -> float:
        p = self.params
        return float(max(p.dr_c_base, p.dr_c_back_base, p.dr_c_base_back, p.dr_c_backbone))

    def pair_energies(self, si, sj) -> torch.Tensor:
        disp = self.disp
        return unbonded_exc(
            self.params,
            vnorm(disp(sj.base, si.base)),
            vnorm(disp(sj.base, si.back)),
            vnorm(disp(sj.back, si.base)),
            vnorm(disp(sj.back, si.back)),
        )


# Stacking ---------------------------------------------------------------------


def _f4_params(p, name: str, k) -> tuple:
    return (
        getattr(p, f"theta0_{name}_{k}"),
        getattr(p, f"delta_theta_star_{name}_{k}"),
        getattr(p, f"delta_theta_{name}_{k}_c"),
        getattr(p, f"a_{name}_{k}"),
        getattr(p, f"b_{name}_{k}"),
    )


def f4_of(p, name: str, k, theta):
    return bf.f4(theta, *_f4_params(p, name, k))


class StackingConfiguration(BaseConfiguration):
    """Stacking: eps = (eps_stack_base + eps_stack_kt_coeff kt) x the
    sequence-averaged table, or with ``ss_stack_weights`` that table x (1 -
    eps_stack_kt_coeff + 9 kt eps_stack_kt_coeff) (its ``kt`` fixed, not
    optimised)."""

    required_params = (
        "eps_stack_base", "eps_stack_kt_coeff", "dr_low_stack", "dr_high_stack", "a_stack",
        "dr0_stack", "dr_c_stack", "theta0_stack_4", "delta_theta_star_stack_4", "a_stack_4",
        "theta0_stack_5", "delta_theta_star_stack_5", "a_stack_5", "theta0_stack_6",
        "delta_theta_star_stack_6", "a_stack_6", "neg_cos_phi1_star_stack", "a_stack_1",
        "neg_cos_phi2_star_stack", "a_stack_2", "kt",
    )
    dependent_params = (
        "b_low_stack", "dr_c_low_stack", "b_high_stack", "dr_c_high_stack", "b_stack_4",
        "delta_theta_stack_4_c", "b_stack_5", "delta_theta_stack_5_c", "b_stack_6",
        "delta_theta_stack_6_c", "b_neg_cos_phi1_stack", "neg_cos_phi1_c_stack",
        "b_neg_cos_phi2_stack", "neg_cos_phi2_c_stack", "eps_stack",
    )

    optional_params = (*PSEQ_FIELDS, "ss_stack_weights")

    def derive(self) -> dict:
        _check_pseq(self)
        if self.ss_stack_weights is None:
            eps = self.eps_stack_base + self.eps_stack_kt_coeff * self.kt
            eps_stack = eps * _table(seqdep.STACK_WEIGHTS_SA, eps)
        else:
            scale = 1.0 - self.eps_stack_kt_coeff + self.kt * 9.0 * self.eps_stack_kt_coeff
            eps_stack = _table(self.ss_stack_weights, self.kt) * scale
        b_low, dr_c_low, b_high, dr_c_high = sm.get_f1_smoothing_params(
            self.dr0_stack, self.a_stack, self.dr_c_stack, self.dr_low_stack, self.dr_high_stack
        )
        out = {
            "b_low_stack": b_low, "dr_c_low_stack": dr_c_low,
            "b_high_stack": b_high, "dr_c_high_stack": dr_c_high, "eps_stack": eps_stack,
        }
        for k in (4, 5, 6):
            b, dth_c = sm.get_f4_smoothing_params(
                getattr(self, f"a_stack_{k}"), getattr(self, f"theta0_stack_{k}"),
                getattr(self, f"delta_theta_star_stack_{k}"),
            )
            out[f"b_stack_{k}"], out[f"delta_theta_stack_{k}_c"] = b, dth_c
        for k in (1, 2):
            b, c = sm.get_f5_smoothing_params(
                getattr(self, f"a_stack_{k}"), getattr(self, f"neg_cos_phi{k}_star_stack")
            )
            out[f"b_neg_cos_phi{k}_stack"], out[f"neg_cos_phi{k}_c_stack"] = b, c
        return out


def stack_product(p, g: geom.BondedGeometry):
    """The sequence-independent f1 * f4^3 * f5^2 stacking product (eps = 1)."""
    return (
        bf.f1(
            g.r_stack, r_low=p.dr_low_stack, r_high=p.dr_high_stack,
            r_c_low=p.dr_c_low_stack, r_c_high=p.dr_c_high_stack, eps=1.0,
            a=p.a_stack, r0=p.dr0_stack, r_c=p.dr_c_stack,
            b_low=p.b_low_stack, b_high=p.b_high_stack,
        )
        * f4_of(p, "stack", 4, g.theta4)
        * f4_of(p, "stack", 5, g.theta5)
        * f4_of(p, "stack", 6, g.theta6)
        * bf.f5(-g.cosphi1, p.neg_cos_phi1_star_stack, p.neg_cos_phi1_c_stack, p.a_stack_1, p.b_neg_cos_phi1_stack)
        * bf.f5(-g.cosphi2, p.neg_cos_phi2_star_stack, p.neg_cos_phi2_c_stack, p.a_stack_2, p.b_neg_cos_phi2_stack)
    )


class Stacking(_BondedPairs):
    """Stacking over bonded pairs with sequence-dependent epsilon, its cos
    phi sites the backbone sites (``site``; oxDNA2 overrides it)."""

    site = "back"

    def bond_energies(self, nuc) -> torch.Tensor:
        i, j = self.bond_index(nuc.back.x.device)
        back = getattr(nuc, self.site)
        g = geom.bonded_geometry_vec(
            geom.gather(back, i), geom.gather(back, j),
            geom.gather(nuc.stack, i), geom.gather(nuc.stack, j),
            geom.gather(nuc.a3, i), geom.gather(nuc.a3, j),
            geom.gather(nuc.a2, i), geom.gather(nuc.a2, j), disp=self.disp,
        )
        p = self.params
        if p.pseq is not None:
            w = seqdep.pair_weights(p.pseq, i, j, p.eps_stack, p.pseq_constraints)
        else:
            seq = self.seq_index(g.r_stack.device)
            w = p.eps_stack[seq[i], seq[j]]
        return w * stack_product(p, g)


# Hydrogen bonding ---------------------------------------------------------------

_HB_ANGLES = (1, 2, 3, 4, 7, 8)


class HydrogenBondingConfiguration(BaseConfiguration):
    required_params = (
        "eps_hb", "a_hb", "dr0_hb", "dr_c_hb", "dr_low_hb", "dr_high_hb",
        *(f"{pre}_hb_{k}" for k in _HB_ANGLES for pre in ("a", "theta0", "delta_theta_star")),
    )
    dependent_params = (
        "b_low_hb", "dr_c_low_hb", "b_high_hb", "dr_c_high_hb",
        *(f for k in _HB_ANGLES for f in (f"b_hb_{k}", f"delta_theta_hb_{k}_c")),
        "eps_hb_weights",
    )

    optional_params = (*PSEQ_FIELDS, "ss_hb_weights")

    def derive(self) -> dict:
        _check_pseq(self)
        if self.ss_hb_weights is None:
            eps_hb_weights = _table(seqdep.HB_WEIGHTS_SA, self.eps_hb) * self.eps_hb
        else:
            eps_hb_weights = _table(self.ss_hb_weights, self.eps_hb)
        b_low, dr_c_low, b_high, dr_c_high = sm.get_f1_smoothing_params(
            self.dr0_hb, self.a_hb, self.dr_c_hb, self.dr_low_hb, self.dr_high_hb
        )
        out = {
            "b_low_hb": b_low, "dr_c_low_hb": dr_c_low, "b_high_hb": b_high,
            "dr_c_high_hb": dr_c_high, "eps_hb_weights": eps_hb_weights,
        }
        for k in _HB_ANGLES:
            b, dth_c = sm.get_f4_smoothing_params(
                getattr(self, f"a_hb_{k}"), getattr(self, f"theta0_hb_{k}"),
                getattr(self, f"delta_theta_star_hb_{k}"),
            )
            out[f"b_hb_{k}"], out[f"delta_theta_hb_{k}_c"] = b, dth_c
        return out


def hb_product(p, g: geom.UnbondedGeometry):
    """Sequence-independent f1 * prod f4 (eps = 1)."""
    val = bf.f1(
        torch.clamp(g.r_base, min=1e-8), r_low=p.dr_low_hb, r_high=p.dr_high_hb,
        r_c_low=p.dr_c_low_hb, r_c_high=p.dr_c_high_hb, eps=1.0, a=p.a_hb,
        r0=p.dr0_hb, r_c=p.dr_c_hb, b_low=p.b_low_hb, b_high=p.b_high_hb,
    )
    thetas = (g.theta1, g.theta2, g.theta3, g.theta4, g.theta7, g.theta8)
    for k, theta in zip(_HB_ANGLES, thetas, strict=True):
        val = val * f4_of(p, "hb", k, theta)
    return val


class HydrogenBonding(_UnbondedPairs):
    """Hydrogen bonding over unbonded pairs. Under a probabilistic sequence
    the pair list takes the expected weight of each pair
    (``seqdep.pair_weights``), the dense and block paths the factorized
    form (``seqdep.factorized_weights``: marginal factors plus the
    correction on each base pair's partner), as the reference's."""

    def weights(self, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
        """The hb weights of pairs (i, j) of nucleotide ids (broadcastable)."""
        p = self.params
        if p.pseq is None:
            seq = self.seq_index(i.device)
            return p.eps_hb_weights[seq[i], seq[j]]
        if i.dim() == 1:
            return seqdep.pair_weights(p.pseq, i, j, p.eps_hb_weights, p.pseq_constraints)
        left, right, partner, corr = seqdep.factorized_weights(p.pseq, p.eps_hb_weights, p.pseq_constraints)
        partner = torch.as_tensor(partner, device=i.device)
        return (left[i] * right[j]).sum(-1) + torch.where(j == partner[i], corr[i], 0.0)

    def pair_cutoff(self) -> float:
        return float(self.params.dr_c_high_hb)

    def pair_energies(self, si, sj) -> torch.Tensor:
        g = geom.unbonded_geometry_vec(si.base, sj.base, si.a1, sj.a1, si.a3, sj.a3, disp=self.disp)
        return self.weights(si.idx, sj.idx) * hb_product(self.params, g)


# Cross stacking ------------------------------------------------------------------


class CrossStackingConfiguration(BaseConfiguration):
    required_params = (
        "dr_low_cross", "dr_high_cross", "k_cross", "r0_cross", "dr_c_cross",
        *(f"{pre}_cross_{k}" for k in _HB_ANGLES for pre in ("theta0", "delta_theta_star", "a")),
    )
    dependent_params = (
        "b_low_cross", "dr_c_low_cross", "b_high_cross", "dr_c_high_cross",
        *(f for k in _HB_ANGLES for f in (f"b_cross_{k}", f"delta_theta_cross_{k}_c")),
    )

    def derive(self) -> dict:
        b_low, dr_c_low, b_high, dr_c_high = sm.get_f2_smoothing_params(
            self.r0_cross, self.dr_c_cross, self.dr_low_cross, self.dr_high_cross
        )
        out = {
            "b_low_cross": b_low, "dr_c_low_cross": dr_c_low,
            "b_high_cross": b_high, "dr_c_high_cross": dr_c_high,
        }
        for k in _HB_ANGLES:
            b, dth_c = sm.get_f4_smoothing_params(
                getattr(self, f"a_cross_{k}"), getattr(self, f"theta0_cross_{k}"),
                getattr(self, f"delta_theta_star_cross_{k}"),
            )
            out[f"b_cross_{k}"], out[f"delta_theta_cross_{k}_c"] = b, dth_c
        return out


def cross_product(p, g: geom.UnbondedGeometry):
    """f2 x f4(theta1..3) x symmetrized f4(theta4, theta7, theta8)."""
    f2_r = bf.f2(
        torch.clamp(g.r_base, min=1e-8), r_low=p.dr_low_cross, r_high=p.dr_high_cross,
        r_c_low=p.dr_c_low_cross, r_c_high=p.dr_c_high_cross, k=p.k_cross,
        r0=p.r0_cross, r_c=p.dr_c_cross, b_low=p.b_low_cross, b_high=p.b_high_cross,
    )

    def sym(k, t):
        return f4_of(p, "cross", k, t) + f4_of(p, "cross", k, math.pi - t)

    return (
        f2_r
        * f4_of(p, "cross", 1, g.theta1)
        * f4_of(p, "cross", 2, g.theta2)
        * f4_of(p, "cross", 3, g.theta3)
        * sym(4, g.theta4)
        * sym(7, g.theta7)
        * sym(8, g.theta8)
    )


class CrossStacking(_UnbondedPairs):
    """Cross stacking over unbonded pairs (shares geometry with HB)."""

    def pair_cutoff(self) -> float:
        return float(self.params.dr_c_high_cross)

    def pair_energies(self, si, sj) -> torch.Tensor:
        return cross_product(self.params, geom.unbonded_geometry_vec(si.base, sj.base, si.a1, sj.a1, si.a3, sj.a3,
                                                                     disp=self.disp))


# Coaxial stacking ------------------------------------------------------------------

_COAX_ANGLES = (4, 1, 5, 6)


class CoaxialStackingConfiguration(BaseConfiguration):
    """oxDNA1 coax: f2 x f4 modulations x f5(cos phi3) x f5(cos phi4)."""

    required_params = (
        "dr_low_coax", "dr_high_coax", "k_coax", "dr0_coax", "dr_c_coax",
        *(f"{pre}_coax_{k}" for k in _COAX_ANGLES for pre in ("theta0", "delta_theta_star", "a")),
        "cos_phi3_star_coax", "a_coax_3p", "cos_phi4_star_coax", "a_coax_4p",
    )
    dependent_params = (
        "b_low_coax", "dr_c_low_coax", "b_high_coax", "dr_c_high_coax",
        *(f for k in _COAX_ANGLES for f in (f"b_coax_{k}", f"delta_theta_coax_{k}_c")),
        "b_cos_phi3_coax", "cos_phi3_c_coax", "b_cos_phi4_coax", "cos_phi4_c_coax",
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
        for k in (3, 4):
            b, c = sm.get_f5_smoothing_params(getattr(self, f"a_coax_{k}p"), getattr(self, f"cos_phi{k}_star_coax"))
            out[f"b_cos_phi{k}_coax"], out[f"cos_phi{k}_c_coax"] = b, c
        return out


def coax_product(p, g: geom.CoaxGeometry):
    """oxDNA1 coaxial stacking of one pair (``g`` with its phi cosines)."""
    f2_r = bf.f2(
        torch.clamp(g.r_stack, min=1e-8), r_low=p.dr_low_coax, r_high=p.dr_high_coax,
        r_c_low=p.dr_c_low_coax, r_c_high=p.dr_c_high_coax, k=p.k_coax,
        r0=p.dr0_coax, r_c=p.dr_c_coax, b_low=p.b_low_coax, b_high=p.b_high_coax,
    )

    def sym(k, t, period=math.pi):
        return f4_of(p, "coax", k, t) + f4_of(p, "coax", k, period - t)

    return (
        f2_r
        * f4_of(p, "coax", 4, g.theta4)
        * sym(1, g.theta1, 2.0 * math.pi)
        * sym(5, g.theta5)
        * sym(6, g.theta6)
        * bf.f5(g.cosphi3, p.cos_phi3_star_coax, p.cos_phi3_c_coax, p.a_coax_3p, p.b_cos_phi3_coax)
        * bf.f5(g.cosphi4, p.cos_phi4_star_coax, p.cos_phi4_c_coax, p.a_coax_4p, p.b_cos_phi4_coax)
    )


class CoaxialStacking(_UnbondedPairs):
    """oxDNA1 coaxial stacking over unbonded pairs (oxRNA2 composes it)."""

    def pair_cutoff(self) -> float:
        return float(self.params.dr_c_high_coax)

    def pair_energies(self, si, sj) -> torch.Tensor:
        g = geom.coax_geometry_vec(si.stack, sj.stack, si.a1, sj.a1, si.a3, sj.a3, back_i=si.back, back_j=sj.back,
                                   disp=self.disp)
        return coax_product(self.params, g)
