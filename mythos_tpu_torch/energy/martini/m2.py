"""MARTINI 2 terms: harmonic bonds, G96 angles, shifted LJ.

Counterpart of mythos_tpu/energy/martini/m2.py. Bonds and angles are one
gather each over their index lists. The nonbonded LJ runs through K6
(ops/lj.py): the pair energy over each pair once, minus the bonded
(1-2) pairs, with position and box gradients -- on the card the
hand-written kernels, on the CPU their plain versions. K6 forms
(sigma^2 / r^2)^3 under a 1e15 cap where the reference term forms
(sigma / r)^6 with masked r set to 1; the two agree on every real pair.
"""

from __future__ import annotations

import torch

from mythos_tpu_torch.energy.martini.base import MartiniEnergyConfiguration, MartiniEnergyFunction, values_tensor
from mythos_tpu_torch.ops import lj as ops_lj

BOND_K_PREFIX = "bond_k_"
BOND_R0_PREFIX = "bond_r0_"
ANGLE_K_PREFIX = "angle_k_"
ANGLE_THETA0_PREFIX = "angle_theta0_"
LJ_SIGMA_PREFIX = "lj_sigma_"
LJ_EPSILON_PREFIX = "lj_epsilon_"

LJ_CUTOFF = ops_lj.LJ_CUTOFF  # nm, fixed MARTINI cutoff


class BondConfiguration(MartiniEnergyConfiguration):
    """Bond params: paired ``bond_k_NAME`` / ``bond_r0_NAME`` per bond name."""

    def __post_init__(self) -> None:
        for param in self.params:
            if not param.startswith((BOND_K_PREFIX, BOND_R0_PREFIX)):
                raise ValueError(f"Unexpected parameter {param} for BondConfiguration")
        if len(self.params) == 0 or len(self.params) % 2 != 0:
            raise ValueError("BondConfiguration requires pairs of k and r0 parameters")


class Bond(MartiniEnergyFunction):
    """Harmonic bonds: 0.5 k (r - r0)^2, over all bonds at once."""

    def compute_energy(self, trajectory) -> torch.Tensor:
        centers = trajectory.center
        displacement_fn = self.displacement_fn(trajectory.box_size)
        bn = self.index("bonds", self.bonded_neighbors, centers.device)
        dr = displacement_fn(centers.index_select(0, bn[:, 0]), centers.index_select(0, bn[:, 1]))
        r = torch.linalg.vector_norm(dr, dim=-1)
        k = self.per_name("bond_k", BOND_K_PREFIX, self.bond_names, centers)
        r0 = self.per_name("bond_r0", BOND_R0_PREFIX, self.bond_names, centers)
        return (0.5 * k * (r - r0) ** 2).sum()


class AngleConfiguration(MartiniEnergyConfiguration):
    """Angle params: paired ``angle_k_NAME`` / ``angle_theta0_NAME``."""

    def __post_init__(self) -> None:
        for param in self.params:
            if not param.startswith((ANGLE_K_PREFIX, ANGLE_THETA0_PREFIX)):
                raise ValueError(f"Unexpected parameter {param} for AngleConfiguration")
        if len(self.params) == 0 or len(self.params) % 2 != 0:
            raise ValueError("AngleConfiguration requires pairs of k and theta0 parameters")


def compute_angles(r_ij: torch.Tensor, r_kj: torch.Tensor) -> torch.Tensor:
    """Angles at the central atoms, arctan2(|cross|, dot)."""
    nij = r_ij / torch.linalg.vector_norm(r_ij, dim=-1, keepdim=True)
    nkj = r_kj / torch.linalg.vector_norm(r_kj, dim=-1, keepdim=True)
    cross = torch.linalg.cross(nij, nkj, dim=-1)
    dot = (nij * nkj).sum(-1)
    return torch.atan2(torch.linalg.vector_norm(cross, dim=-1), dot)


class Angle(MartiniEnergyFunction):
    """Cosine-harmonic (G96, MARTINI 2) or harmonic angles.

    MARTINI 2 uses the GROMACS type-2 angle: 0.5 k (cos t - cos t0)^2;
    MARTINI 3 flips ``use_G96`` to the plain harmonic form.
    """

    use_G96 = True  # noqa: N815 - GROMACS naming

    def compute_energy(self, trajectory) -> torch.Tensor:
        centers = trajectory.center
        displacement_fn = self.displacement_fn(trajectory.box_size)
        ang = self.index("angles", self.angles, centers.device)
        c1 = centers.index_select(0, ang[:, 1])
        r_ij = displacement_fn(centers.index_select(0, ang[:, 0]), c1)
        r_kj = displacement_fn(centers.index_select(0, ang[:, 2]), c1)
        theta = compute_angles(r_ij, r_kj)
        k = self.per_name("angle_k", ANGLE_K_PREFIX, self.angle_names, centers)
        theta0 = self.per_name("angle_theta0", ANGLE_THETA0_PREFIX, self.angle_names, centers)
        term = torch.cos(theta) - torch.cos(theta0) if self.use_G96 else theta - theta0
        return (0.5 * k * term**2).sum()


class LJConfiguration(MartiniEnergyConfiguration):
    """LJ params ``lj_sigma_A_B`` / ``lj_epsilon_A_B`` per bead-type pair.

    Pair order is ignored unless both orderings are provided. ``bead_types``
    are sorted; :meth:`tables` gives the dense (T, T) sigma and epsilon
    lookup matrices the kernels read.
    """

    def __post_init__(self) -> None:
        bead_types: set[str] = set()
        for param in self.params:
            if not param.startswith((LJ_SIGMA_PREFIX, LJ_EPSILON_PREFIX)):
                raise ValueError(f"Unexpected parameter {param} for LJConfiguration")
            bead_types.update(param.split("_")[2:4])
        self.bead_types = tuple(sorted(bead_types))
        for prefix in ("sigma", "epsilon"):
            for a in self.bead_types:
                for b in self.bead_types:
                    self._get(prefix, a, b)

    def _get(self, prefix: str, a: str, b: str):
        param = self.params.get(f"lj_{prefix}_{a}_{b}", self.params.get(f"lj_{prefix}_{b}_{a}"))
        if param is None:
            raise ValueError(f"Missing LJ {prefix} parameter for pair {a}_{b} ({b}_{a})")
        return param

    def tables(self, device, dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """(sigmas, epsilons), each (T, T) over the sorted bead types."""
        t = self.bead_types

        def table(prefix):
            flat = values_tensor([self._get(prefix, a, b) for a in t for b in t], device, dtype)
            return flat.reshape(len(t), len(t))

        return table("sigma"), table("epsilon")


def lennard_jones(r: torch.Tensor, eps: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Shifted 12-6 LJ: V(r) - V(cutoff) inside the fixed 1.1 nm cutoff."""
    x6 = (sigma / r) ** 6
    v = 4.0 * eps * (x6 * x6 - x6)
    c6 = (sigma / LJ_CUTOFF) ** 6
    v_c = 4.0 * eps * (c6 * c6 - c6)
    return torch.where(r < LJ_CUTOFF, v - v_c, torch.zeros_like(v))


class LJ(MartiniEnergyFunction):
    """Nonbonded shifted LJ over all non-bonded pairs, through K6."""

    def types(self, device) -> torch.Tensor:
        """(N,) int32 indices into the sorted bead types, cached."""
        type_map = {t: i for i, t in enumerate(self.params.bead_types)}
        return self.cached("types", device, None, lambda d, _: torch.tensor(
            [type_map[t] for t in self.atom_types], dtype=torch.int32, device=d))

    def pair_mask(self, device) -> ops_lj.PairMask:
        """The bit-packed symmetric pair mask: all pairs minus the bonded
        ones, built once per topology and device (the copies replace() makes
        share it), never per step."""
        return self.cached("pair_mask", device, None, lambda d, _: ops_lj.PairMask.build(
            len(self.atom_types), self.bonded_neighbors, d), shared=True)

    def tables(self, device, dtype) -> tuple[torch.Tensor, torch.Tensor]:
        return self.cached("tables", device, dtype, self.params.tables)

    def compute_energy(self, trajectory) -> torch.Tensor:
        centers = trajectory.center
        dev = centers.device
        return ops_lj.lj_pair_energy(
            centers, self.types(dev), self.pair_mask(dev), trajectory.box_size, self.tables(dev, centers.dtype)
        )


__all__ = [
    "LJ",
    "Angle",
    "AngleConfiguration",
    "Bond",
    "BondConfiguration",
    "LJConfiguration",
    "compute_angles",
    "lennard_jones",
]
