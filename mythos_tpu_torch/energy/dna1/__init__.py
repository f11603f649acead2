"""oxDNA1 model package (port of mythos_tpu.energy.dna1).

The oxDNA1 model -- FENE, bonded and unbonded excluded volume, stacking
(its ``kt`` fixed), hydrogen bonding, cross stacking and oxDNA1's coaxial
stacking on the dna1 nucleotide (one backbone site on a1), no
Debye-Hueckel -- under its own defaults (the data TOMLs of the JAX
package, read in place), and the pieces oxDNA2 and oxRNA2 share with it
(``terms``, ``geometry``).

Every tier of the port runs it: the pair list and the dense (N, N) masks
(``create_default_energy_fn(dense_unbonded=True)``; simulators.cuda.
PairSimulator), the banded stencil (K1, K2), the block tier on a
one-level table (K3), and the DiffTRe re-evaluation on that table
(``ComposedEnergyFunction.map`` with ``map_neighbors``: K4, backward K5).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mythos_tpu_torch.energy.base import BaseConfiguration, ComposedEnergyFunction
from mythos_tpu_torch.energy.defaults import default_configs_for
from mythos_tpu_torch.energy.dna1.nucleotide import Nucleotide, NucleotideSoA
from mythos_tpu_torch.energy.dna1.terms import (
    BondedExcludedVolume,
    BondedExcludedVolumeConfiguration,
    CoaxialStacking,
    CoaxialStackingConfiguration,
    CrossStacking,
    CrossStackingConfiguration,
    Fene,
    FeneConfiguration,
    HydrogenBonding,
    HydrogenBondingConfiguration,
    Stacking,
    StackingConfiguration,
    UnbondedExcludedVolume,
    UnbondedExcludedVolumeConfiguration,
)
from mythos_tpu_torch.simulators.neighbors import dense_pair_mask
from mythos_tpu_torch.utils import devices

#: geometry keys of the transform (site offsets along a1)
GEOMETRY_KEYS = ("com_to_backbone", "com_to_hb", "com_to_stacking")


def default_configs() -> tuple[dict, dict]:
    """(simulation, energy) default configuration trees for dna1."""
    return default_configs_for("dna1")


def default_geometry() -> dict[str, float]:
    """Default site offsets of the dna1 nucleotide (not ``geometry``: that
    name is the package's pair-geometry module)."""
    _, cfg = default_configs()
    return {k: float(cfg["geometry"][k]) for k in GEOMETRY_KEYS}


def _cast(values: dict, dtype, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=device) for k, v in values.items()}


def default_energy_configs(
    dtype: torch.dtype = torch.float32, device: torch.device | str = "cpu"
) -> list[BaseConfiguration]:
    """Default per-term configurations (same order as default_energy_fns);
    stacking optimises its TOML parameters, its ``kt`` stays fixed."""
    sim, cfg = default_configs()

    def param(x: str) -> dict:
        return _cast(cfg[x], dtype, device)

    all_ = BaseConfiguration.OPT_ALL
    stacking_opts = tuple(set(cfg["stacking"]) - {"kT", "ss_stack_weights"})
    return [
        FeneConfiguration.from_dict(param("fene"), all_),
        BondedExcludedVolumeConfiguration.from_dict(param("bonded_excluded_volume"), all_),
        StackingConfiguration.from_dict(param("stacking") | _cast({"kt": sim["kT"]}, dtype, device), stacking_opts),
        UnbondedExcludedVolumeConfiguration.from_dict(param("unbonded_excluded_volume"), all_),
        HydrogenBondingConfiguration.from_dict(param("hydrogen_bonding"), all_),
        CrossStackingConfiguration.from_dict(param("cross_stacking"), all_),
        CoaxialStackingConfiguration.from_dict(param("coaxial_stacking"), all_),
    ]


def default_energy_fns() -> list[type]:
    """Term classes, in the order matching default_energy_configs."""
    return [
        Fene, BondedExcludedVolume, Stacking, UnbondedExcludedVolume,
        HydrogenBonding, CrossStacking, CoaxialStacking,
    ]


def default_transform_fn():
    """RigidBody -> dna1 Nucleotide (AoS) with the default geometry."""
    return functools.partial(Nucleotide.from_rigid_body, **default_geometry())


def default_transform_soa_fn():
    """RigidBody -> dna1 NucleotideSoA with the default geometry (the form
    the terms read)."""
    return functools.partial(NucleotideSoA.from_rigid_body, **default_geometry())


def create_default_energy_fn(
    topology,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    dense_unbonded: bool = False,
) -> ComposedEnergyFunction:
    """The full default oxDNA1 composed energy function for a topology, its
    parameters on ``device`` (the card unless the caller asks for the CPU).

    ``dense_unbonded=True`` evaluates the unbonded terms over the dense
    (N, N) mask of ``simulators.neighbors.dense_pair_mask`` (pair it with
    ``DensePairs``), as the reference's; otherwise over the topology's
    pair list. The block and stencil tiers take the pair-list energy and
    carry their own tables."""
    device = devices.resolve(device)
    transform = default_transform_soa_fn()
    fns = [
        cls(cfg.init_params(), topology, transform)
        for cls, cfg in zip(default_energy_fns(), default_energy_configs(dtype, device), strict=True)
    ]
    energy = ComposedEnergyFunction(fns)
    return energy.with_props(dense_mask=dense_pair_mask(topology)) if dense_unbonded else energy


def max_site_offset() -> float:
    """Largest |site - COM| offset of the default dna1 geometry: a site
    cutoff plus twice this is a COM cutoff."""
    return max(abs(v) for v in default_geometry().values())


def _pair_cutoffs() -> dict[str, float]:
    """Site-level cutoff of each unbonded term (float64 derivation)."""
    p = {
        cls.__name__: cfg.init_params()
        for cls, cfg in zip(default_energy_fns(), default_energy_configs(dtype=torch.float64), strict=True)
    }
    px = p["UnbondedExcludedVolume"]
    return {
        "UnbondedExcludedVolume": float(max(px.dr_c_base, px.dr_c_back_base, px.dr_c_base_back, px.dr_c_backbone)),
        "HydrogenBonding": float(p["HydrogenBonding"].dr_c_high_hb),
        "CrossStacking": float(p["CrossStacking"].dr_c_high_cross),
        "CoaxialStacking": float(p["CoaxialStacking"].dr_c_high_coax),
    }


def default_neighbor_cutoff() -> float:
    """COM-distance cutoff covering every unbonded term of the default model
    (mythos_tpu.energy.dna1.default_neighbor_cutoff)."""
    return max(_pair_cutoffs().values()) + 2.0 * max_site_offset()


def per_term_neighbor_cutoffs() -> dict[str, float]:
    """COM-distance cutoff of each unbonded term (no Debye-Hueckel: every
    term is short-range)."""
    return {nm: c + 2.0 * max_site_offset() for nm, c in _pair_cutoffs().items()}


def per_term_site_cutoffs() -> dict:
    """SITE-level radial supports per unbonded term (float64 derivation):
    one backbone site on a1 and no Debye term. Same contract as
    mythos_tpu.energy.dna1.per_term_site_cutoffs; feeds
    simulators.neighbors.stencil_band_for_site_cutoffs."""
    g = default_geometry()
    sites = {
        "back": (g["com_to_backbone"], 0.0),
        "base": (g["com_to_hb"], 0.0),
        "stack": (g["com_to_stacking"], 0.0),
    }
    params = {
        cls.__name__: cfg.init_params()
        for cls, cfg in zip(default_energy_fns(), default_energy_configs(dtype=torch.float64), strict=True)
    }
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
    }
    return {"sites": sites, "terms": terms}


__all__ = [
    "create_default_energy_fn",
    "default_configs",
    "default_energy_configs",
    "default_energy_fns",
    "default_neighbor_cutoff",
    "default_transform_fn",
    "default_transform_soa_fn",
    "default_geometry",
    "max_site_offset",
    "per_term_neighbor_cutoffs",
    "per_term_site_cutoffs",
]
