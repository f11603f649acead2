"""oxDNA2 model package (port of mythos_tpu.energy.dna2).

Shares FENE, excluded volumes, HB and cross-stacking with dna1; adds the
site-override stacking, the f4+f6 coaxial stacking and Debye-Hueckel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mythos_tpu_torch.energy.base import BaseConfiguration, ComposedEnergyFunction
from mythos_tpu_torch.energy.defaults import default_configs_for
from mythos_tpu_torch.energy.dna1.terms import (
    BondedExcludedVolume,
    BondedExcludedVolumeConfiguration,
    CrossStacking,
    CrossStackingConfiguration,
    Fene,
    FeneConfiguration,
    HydrogenBonding,
    HydrogenBondingConfiguration,
    StackingConfiguration,
    UnbondedExcludedVolume,
    UnbondedExcludedVolumeConfiguration,
)
from mythos_tpu_torch.energy.dna2.nucleotide import NucleotideSoA
from mythos_tpu_torch.energy.dna2.terms import (
    CoaxialStacking,
    CoaxialStackingConfiguration,
    Debye,
    DebyeConfiguration,
    Stacking,
)
from mythos_tpu_torch.utils import devices

#: geometry keys of the transform (site offsets along the body frame)
GEOMETRY_KEYS = (
    "com_to_backbone_x", "com_to_backbone_y", "com_to_backbone_dna1", "com_to_hb", "com_to_stacking",
)


def default_configs() -> tuple[dict, dict]:
    """(simulation, energy) default configuration trees for dna2."""
    return default_configs_for("dna2")


def geometry() -> dict[str, float]:
    """Default site offsets of the dna2 nucleotide."""
    _, cfg = default_configs()
    return {k: float(cfg["geometry"][k]) for k in GEOMETRY_KEYS}


def _cast(values: dict, dtype, device) -> dict:
    out = {}
    for k, v in values.items():
        if isinstance(v, bool):
            out[k] = v
        else:
            out[k] = torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=device)
    return out


def default_energy_configs(
    dtype: torch.dtype = torch.float32, device: torch.device | str = "cpu"
) -> list[BaseConfiguration]:
    """Default per-term configurations (same order as default_energy_fns)."""
    sim, cfg = default_configs()

    def param(x: str) -> dict:
        return _cast(cfg[x], dtype, device)

    kt = sim["kT"]
    stacking_opts = tuple(set(cfg["stacking"]) - {"kT"})
    debye_opts = tuple(set(cfg["debye"]) - {"kT", "salt_conc"})
    debye_extra = _cast({"kt": kt, "salt_conc": sim["salt_conc"]}, dtype, device)
    debye_extra["half_charged_ends"] = bool(sim["half_charged_ends"])
    all_ = BaseConfiguration.OPT_ALL
    return [
        FeneConfiguration.from_dict(param("fene"), all_),
        BondedExcludedVolumeConfiguration.from_dict(param("bonded_excluded_volume"), all_),
        StackingConfiguration.from_dict(
            param("stacking") | _cast({"kt": kt}, dtype, device), stacking_opts
        ),
        UnbondedExcludedVolumeConfiguration.from_dict(param("unbonded_excluded_volume"), all_),
        HydrogenBondingConfiguration.from_dict(param("hydrogen_bonding"), all_),
        CrossStackingConfiguration.from_dict(param("cross_stacking"), all_),
        CoaxialStackingConfiguration.from_dict(param("coaxial_stacking"), all_),
        DebyeConfiguration.from_dict(param("debye") | debye_extra, debye_opts),
    ]


def default_energy_fns() -> list[type]:
    """Term classes, in the order matching default_energy_configs."""
    return [
        Fene, BondedExcludedVolume, Stacking, UnbondedExcludedVolume,
        HydrogenBonding, CrossStacking, CoaxialStacking, Debye,
    ]


def default_transform_soa_fn():
    """RigidBody -> dna2 NucleotideSoA with the default geometry."""
    return functools.partial(NucleotideSoA.from_rigid_body, **geometry())


def create_default_energy_fn(
    topology, dtype: torch.dtype = torch.float32, device: torch.device | str = "cuda"
) -> ComposedEnergyFunction:
    """The full default oxDNA2 composed energy function for a topology,
    its parameters on ``device`` (the card unless the caller asks for the CPU)."""
    device = devices.resolve(device)
    transform = default_transform_soa_fn()
    fns = [
        cls(cfg.init_params(), topology, transform)
        for cls, cfg in zip(default_energy_fns(), default_energy_configs(dtype, device), strict=True)
    ]
    return ComposedEnergyFunction(fns)


def max_site_offset() -> float:
    """Largest |site - COM| offset of the default dna2 geometry."""
    g = geometry()
    back = float(np.hypot(g["com_to_backbone_x"], g["com_to_backbone_y"]))
    return max(back, abs(g["com_to_backbone_dna1"]), abs(g["com_to_hb"]), abs(g["com_to_stacking"]))


def _pair_cutoffs() -> dict[str, float]:
    """Site-level cutoff of each unbonded term (float64 derivation)."""
    p = {
        cls.__name__: cfg.init_params()
        for cls, cfg in zip(default_energy_fns(), default_energy_configs(dtype=torch.float64, device="cpu"),
                            strict=True)
    }
    px = p["UnbondedExcludedVolume"]
    return {
        "UnbondedExcludedVolume": float(max(px.dr_c_base, px.dr_c_back_base, px.dr_c_base_back, px.dr_c_backbone)),
        "HydrogenBonding": float(p["HydrogenBonding"].dr_c_high_hb),
        "CrossStacking": float(p["CrossStacking"].dr_c_high_cross),
        "CoaxialStacking": float(p["CoaxialStacking"].dr_c_high_coax),
        "Debye": float(p["Debye"].r_cut),
    }


def default_neighbor_cutoff() -> float:
    """COM-distance cutoff covering every unbonded term of the default model
    (mythos_tpu.energy.dna2.default_neighbor_cutoff)."""
    return max(_pair_cutoffs().values()) + 2.0 * max_site_offset()


def short_range_neighbor_cutoff() -> float:
    """COM-distance cutoff over every unbonded term except Debye-Hueckel:
    the tight table of a two-level block neighbor list."""
    cut = _pair_cutoffs()
    del cut["Debye"]
    return max(cut.values()) + 2.0 * max_site_offset()


def per_term_site_cutoffs() -> dict:
    """SITE-level radial supports per unbonded term (float64 derivation).

    Same contract as mythos_tpu.energy.dna2.per_term_site_cutoffs: feeds
    simulators.neighbors.stencil_band_for_site_cutoffs.
    """
    g = geometry()
    sites = {
        "back": (g["com_to_backbone_x"], g["com_to_backbone_y"]),
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
        "Debye": (("back", "back", float(params["Debye"].r_cut)),),
    }
    return {"sites": sites, "terms": terms}


__all__ = [
    "create_default_energy_fn",
    "default_configs",
    "default_neighbor_cutoff",
    "default_energy_configs",
    "default_energy_fns",
    "default_transform_soa_fn",
    "geometry",
    "per_term_site_cutoffs",
    "short_range_neighbor_cutoff",
]
