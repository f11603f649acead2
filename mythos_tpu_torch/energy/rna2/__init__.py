"""oxRNA2 model package (port of mythos_tpu.energy.rna2).

oxRNA2 composes dna1's FENE, excluded volumes, hydrogen bonding and
coaxial stacking with its own stacking and cross stacking and dna2's
Debye-Hueckel, under the rna2 defaults (the data TOML of the JAX package,
read in place; it ships no simulation defaults, so kT 296.15 K x 0.1 / 300,
salt 1.0 and no half-charged ends are the package's).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mythos_tpu_torch.energy.base import BaseConfiguration, ComposedEnergyFunction
from mythos_tpu_torch.energy.blocks import n_blocks_for
from mythos_tpu_torch.energy.defaults import default_configs_for
from mythos_tpu_torch.energy.dna1.terms import (
    BondedExcludedVolume,
    BondedExcludedVolumeConfiguration,
    CoaxialStacking,
    CoaxialStackingConfiguration,
    Fene,
    FeneConfiguration,
    HydrogenBonding,
    HydrogenBondingConfiguration,
    UnbondedExcludedVolume,
    UnbondedExcludedVolumeConfiguration,
)
from mythos_tpu_torch.energy.dna2 import _cast
from mythos_tpu_torch.energy.dna2.terms import Debye, DebyeConfiguration
from mythos_tpu_torch.energy.rna2.nucleotide import NucleotideSoA
from mythos_tpu_torch.energy.rna2.terms import (
    CrossStacking,
    CrossStackingConfiguration,
    Stacking,
    StackingConfiguration,
)
from mythos_tpu_torch.utils import devices

KT = 296.15 * 0.1 / 300.0
SALT_CONC = 1.0

#: transform keyword -> key of the TOML's [geometry] (the backbone's second
#: coefficient is along a3)
_GEOMETRY = {
    "com_to_backbone_x": "pos_back_a1",
    "com_to_backbone_y": "pos_back_a3",
    "com_to_stacking": "pos_stack",
    "com_to_hb": "pos_base",
    **{f"p{e}_{c}": f"p{e}_{c}" for e in (3, 5) for c in "xyz"},
    **{f"pos_stack_{e}_a{k}": f"pos_stack_{e}_a{k}" for e in (3, 5) for k in (1, 2)},
}


def default_configs() -> tuple[dict, dict]:
    """(simulation, energy) default configuration trees for rna2 (the
    simulation tree is empty)."""
    return default_configs_for("rna2")


def geometry() -> dict[str, float]:
    """Default site offsets of the rna2 nucleotide, as transform keywords."""
    _, cfg = default_configs()
    return {k: float(cfg["geometry"][v]) for k, v in _GEOMETRY.items()}


def default_energy_configs(
    dtype: torch.dtype = torch.float32, device: torch.device | str = "cpu"
) -> list[BaseConfiguration]:
    """Default per-term configurations (same order as default_energy_fns)."""
    _, cfg = default_configs()

    def param(x: str) -> dict:
        return _cast(cfg[x], dtype, device)

    all_ = BaseConfiguration.OPT_ALL
    debye_extra = _cast({"kt": KT, "salt_conc": SALT_CONC}, dtype, device)
    debye_extra["half_charged_ends"] = False
    return [
        FeneConfiguration.from_dict(param("fene"), all_),
        BondedExcludedVolumeConfiguration.from_dict(param("bonded_excluded_volume"), all_),
        StackingConfiguration.from_dict(param("stacking") | _cast({"kt": KT}, dtype, device), tuple(cfg["stacking"])),
        UnbondedExcludedVolumeConfiguration.from_dict(param("unbonded_excluded_volume"), all_),
        HydrogenBondingConfiguration.from_dict(param("hydrogen_bonding"), all_),
        CrossStackingConfiguration.from_dict(param("cross_stacking"), all_),
        CoaxialStackingConfiguration.from_dict(param("coaxial_stacking"), all_),
        DebyeConfiguration.from_dict(param("debye") | debye_extra, tuple(cfg["debye"])),
    ]


def default_energy_fns() -> list[type]:
    """Term classes, in the order matching default_energy_configs."""
    return [
        Fene, BondedExcludedVolume, Stacking, UnbondedExcludedVolume,
        HydrogenBonding, CrossStacking, CoaxialStacking, Debye,
    ]


def default_transform_soa_fn():
    """RigidBody -> rna2 NucleotideSoA with the default geometry."""
    return functools.partial(NucleotideSoA.from_rigid_body, **geometry())


def create_default_energy_fn(
    topology,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    block_unbonded: bool = False,
    block_size: int = 16,
) -> ComposedEnergyFunction:
    """The full default oxRNA2 composed energy function for a topology,
    its parameters on ``device`` (the card unless the caller asks for the CPU).

    ``block_unbonded``: the unbonded terms sum over a block table of
    ``block_size`` (energy/blocks.py), bound later with
    ``with_props(block_ids=nbl.idx, block_perm=nbl.perm)`` of a
    non-symmetric BlockNeighborList; until then an empty placeholder that
    raises when evaluated (as the reference's)."""
    device = devices.resolve(device)
    transform = default_transform_soa_fn()
    fns = [
        cls(cfg.init_params(), topology, transform)
        for cls, cfg in zip(default_energy_fns(), default_energy_configs(dtype, device), strict=True)
    ]
    energy = ComposedEnergyFunction(fns)
    if block_unbonded:
        nb = n_blocks_for(topology.n_nucleotides, block_size)
        energy = energy.with_props(block_ids=torch.zeros((nb, 0), dtype=torch.int32, device=device),
                                   block_size=block_size)
    return energy


def max_site_offset() -> float:
    """Largest |site - COM| offset of the default rna2 geometry."""
    g = geometry()
    back = float(np.hypot(g["com_to_backbone_x"], g["com_to_backbone_y"]))
    return max(back, abs(g["com_to_hb"]), abs(g["com_to_stacking"]))


def _params() -> dict:
    """Each term's default configuration, derived in float64 on the CPU."""
    return {
        cls.__name__: cfg.init_params()
        for cls, cfg in zip(default_energy_fns(), default_energy_configs(dtype=torch.float64), strict=True)
    }


def _pair_cutoffs() -> dict[str, float]:
    """Site-level cutoff of each unbonded term."""
    p = _params()
    px = p["UnbondedExcludedVolume"]
    return {
        "UnbondedExcludedVolume": float(max(px.dr_c_base, px.dr_c_back_base, px.dr_c_base_back, px.dr_c_backbone)),
        "HydrogenBonding": float(p["HydrogenBonding"].dr_c_high_hb),
        "CrossStacking": float(p["CrossStacking"].dr_c_high_cross),
        "CoaxialStacking": float(p["CoaxialStacking"].dr_c_high_coax),
        "Debye": float(p["Debye"].r_cut),
    }


def default_neighbor_cutoff() -> float:
    """COM-distance cutoff covering every unbonded term of the default model."""
    return max(_pair_cutoffs().values()) + 2.0 * max_site_offset()


def short_range_neighbor_cutoff() -> float:
    """COM-distance cutoff over every unbonded term except Debye-Hueckel."""
    cut = _pair_cutoffs()
    del cut["Debye"]
    return max(cut.values()) + 2.0 * max_site_offset()


def per_term_site_cutoffs() -> dict:
    """SITE-level radial supports per unbonded term; site coefficients are
    (a1, a2, a3) triples (the backbone spans a1 and a3). Feeds
    simulators.neighbors.stencil_band_for_site_cutoffs."""
    g = geometry()
    sites = {
        "back": (g["com_to_backbone_x"], 0.0, g["com_to_backbone_y"]),
        "base": (g["com_to_hb"], 0.0, 0.0),
        "stack": (g["com_to_stacking"], 0.0, 0.0),
    }
    params = _params()
    px = params["UnbondedExcludedVolume"]
    terms = {
        "UnbondedExcludedVolume": (
            ("base", "base", float(px.dr_c_base)),
            ("back", "base", max(float(px.dr_c_back_base), float(px.dr_c_base_back))),
            ("back", "back", float(px.dr_c_backbone)),
        ),
        "HydrogenBonding": (("base", "base", float(params["HydrogenBonding"].dr_c_high_hb)),),
        "CrossStacking": (("base", "base", float(params["CrossStacking"].dr_c_high_cross)),),
        "CoaxialStacking": (("stack", "stack", float(params["CoaxialStacking"].dr_c_high_coax)),),
        "Debye": (("back", "back", float(params["Debye"].r_cut)),),
    }
    return {"sites": sites, "terms": terms}


def aform_site_slacks() -> dict:
    """Per-family site-distance slacks for sizing the band of an A-form
    duplex (the reference's calibration: the A-form equilibrium under rna2
    physics is far more compact than the ideal helix it starts from)."""
    return {
        ("back", "back"): 3.25,
        ("back", "base"): 2.55,
        ("base", "base"): 2.40,
        ("stack", "stack"): 2.20,
    }


def aform_far_slack() -> float:
    """Gap slack of the far fold-back sweep on A-form systems (~3 su of
    equilibrium approach, against ~0.9 for B-DNA)."""
    return 3.5


__all__ = [
    "aform_far_slack",
    "aform_site_slacks",
    "create_default_energy_fn",
    "default_configs",
    "default_energy_configs",
    "default_energy_fns",
    "default_neighbor_cutoff",
    "default_transform_soa_fn",
    "geometry",
    "per_term_site_cutoffs",
    "short_range_neighbor_cutoff",
]
