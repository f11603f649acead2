"""Small built-in MARTINI systems for in-process simulation and tests.

Counterpart of mythos_tpu/energy/martini/systems.py, numpy only: the same
lattice, the same jitter draws from the same seed, so that both packages
build identical systems. A four-bead lipid (two head beads Q0/Qa, two tail
beads C1) on a lattice bilayer, optionally solvated by P4 water slabs, with
MARTINI-2-like interaction levels (kJ/mol, nm).
"""

from __future__ import annotations

import numpy as np

from mythos_tpu_torch.energy.martini import m2
from mythos_tpu_torch.energy.martini.base import MartiniTopology

BEAD_MASS = 72.0  # amu, standard 4-to-1 MARTINI mapping

#: four-bead lipid: NC3 (Q0) - PO4 (Qa) - C1A (C1) - C2A (C1)
LIPID_NAMES = ("NC3", "PO4", "C1A", "C2A")
LIPID_TYPES = ("Q0", "Qa", "C1", "C1")
_Z_SPACING = 0.5  # nm between consecutive beads along the lipid axis

#: MARTINI-2-like LJ levels (sigma nm, epsilon kJ/mol) for {Q0, Qa, C1, P4}
_LJ = {
    ("Q0", "Q0"): (0.47, 3.5),
    ("Q0", "Qa"): (0.47, 4.5),
    ("Qa", "Qa"): (0.47, 5.0),
    ("Q0", "C1"): (0.62, 2.0),
    ("Qa", "C1"): (0.62, 2.0),
    ("C1", "C1"): (0.47, 3.5),
    ("P4", "P4"): (0.47, 5.0),
    ("Q0", "P4"): (0.47, 5.6),
    ("Qa", "P4"): (0.47, 5.6),
    ("C1", "P4"): (0.47, 2.0),
}


def default_lj_params(bead_types: tuple[str, ...]) -> dict:
    """Flat lj_sigma_* / lj_epsilon_* kwargs for the given bead set."""
    out: dict = {}
    for i, a in enumerate(bead_types):
        for b in bead_types[i:]:
            sig, eps = _LJ.get((a, b)) or _LJ[(b, a)]
            out[f"lj_sigma_{a}_{b}"] = sig
            out[f"lj_epsilon_{a}_{b}"] = eps
    return out


def lattice_bilayer(
    n_x: int = 4, n_y: int = 4, *, spacing: float = 0.78, water_layers: int = 0, seed: int = 0
) -> tuple[MartiniTopology, np.ndarray, np.ndarray, np.ndarray]:
    """(topology, positions (N, 3) nm, box (3,) nm, masses (N,)) bilayer.

    ``n_x * n_y`` lipids per leaflet on a square lattice, tails facing;
    ``water_layers`` adds that many P4 planes above and below the membrane.
    ``spacing`` sets the initial area per lipid (spacing^2).
    """
    rng = np.random.default_rng(seed)
    atoms_per_lipid = len(LIPID_NAMES)
    types: list[str] = []
    names: list[str] = []
    residues: list[str] = []
    positions: list[np.ndarray] = []
    bonds: list[list[int]] = []
    angles: list[list[int]] = []

    lz_half = _Z_SPACING * atoms_per_lipid  # leaflet thickness
    box_z = 2 * lz_half + 2 * (water_layers * 0.47 + 0.6)
    box = np.array([n_x * spacing, n_y * spacing, box_z])
    z_mid = box_z / 2.0

    def add_lipid(x: float, y: float, leaflet: int) -> None:
        base = len(types)
        sign = -1.0 if leaflet == 0 else 1.0  # head direction from midplane
        for k, (nm, tp) in enumerate(zip(LIPID_NAMES, LIPID_TYPES, strict=True)):
            types.append(tp)
            names.append(nm)
            residues.append("DLPC")
            # heads outermost: bead 0 farthest from midplane
            z = z_mid + sign * (lz_half - (k + 0.5) * _Z_SPACING)
            jitter = rng.normal(scale=0.02, size=2)
            positions.append(np.array([x + jitter[0], y + jitter[1], z]))
        for k in range(atoms_per_lipid - 1):
            bonds.append([base + k, base + k + 1])
        for k in range(atoms_per_lipid - 2):
            angles.append([base + k, base + k + 1, base + k + 2])

    for leaflet in range(2):
        for i in range(n_x):
            for j in range(n_y):
                add_lipid((i + 0.5) * spacing, (j + 0.5) * spacing, leaflet)

    if water_layers:
        wx = max(3, int(box[0] / 0.47))
        wy = max(3, int(box[1] / 0.47))
        for side in (-1.0, 1.0):
            for layer in range(water_layers):
                z = z_mid + side * (lz_half + 0.4 + layer * 0.47)
                for i in range(wx):
                    for j in range(wy):
                        types.append("P4")
                        names.append("W")
                        residues.append("W")
                        positions.append(np.array([(i + 0.5) * box[0] / wx, (j + 0.5) * box[1] / wy, z]))

    topology = MartiniTopology(
        atom_types=tuple(types),
        atom_names=tuple(names),
        residue_names=tuple(residues),
        angles=np.asarray(angles, dtype=np.int32).reshape(-1, 3),
        bonded_neighbors=np.asarray(bonds, dtype=np.int32).reshape(-1, 2),
    )
    masses = np.full(len(types), BEAD_MASS)
    return topology, np.asarray(positions), box, masses


def default_bilayer_terms(topology: MartiniTopology) -> list:
    """[Bond, Angle, LJ] m2 terms with the built-in parameter set."""
    bond_kwargs: dict = {}
    for name in dict.fromkeys(topology.bond_names):
        bond_kwargs[f"bond_k_{name}"] = 1250.0
        bond_kwargs[f"bond_r0_{name}"] = 0.47
    angle_kwargs: dict = {}
    for name in dict.fromkeys(topology.angle_names):
        angle_kwargs[f"angle_k_{name}"] = 25.0
        angle_kwargs[f"angle_theta0_{name}"] = np.pi
    bead_types = tuple(sorted(set(topology.atom_types)))
    return [
        m2.Bond.from_topology(topology, params=m2.BondConfiguration(**bond_kwargs)),
        m2.Angle.from_topology(topology, params=m2.AngleConfiguration(**angle_kwargs)),
        m2.LJ.from_topology(topology, params=m2.LJConfiguration(**default_lj_params(bead_types))),
    ]
