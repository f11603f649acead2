"""oxDNA2 model package (port of mythos_tpu.energy.dna2).

Shares FENE, excluded volumes, HB and cross-stacking with dna1; adds the
site-override stacking, the f4+f6 coaxial stacking and Debye-Hueckel.
The constructor takes the reference's options: a displacement (periodic
boxes), dense masks, ``overrides`` (kT, salt, half-charged ends, any
term's parameters) and ``opts``::

    energy_fn = dna2.create_default_energy_fn(
        topology, displacement_fn=spaces.periodic(30.0)[0],
        overrides={"kT": 0.11, "salt_conc": 0.1, "stacking": {"eps_stack_base": 1.4}},
        opts={"hydrogen_bonding": ("eps_hb",)})
"""

from __future__ import annotations

import functools
from types import MappingProxyType

import numpy as np
import torch

from mythos_tpu_torch.energy.base import BaseConfiguration, ComposedEnergyFunction
from mythos_tpu_torch.energy.defaults import (
    cast_params,
    default_configs_for,
    pair_cutoffs,
    term_params,
    unbonded_site_cutoffs,
)
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
from mythos_tpu_torch.simulators.neighbors import dense_pair_mask
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


def default_energy_configs(
    overrides: dict = MappingProxyType({}),
    opts: dict = MappingProxyType({}),
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> list[BaseConfiguration]:
    """Per-term configurations (the order of default_energy_fns), with the
    reference's merge rules (mythos_tpu/energy/dna2/__init__.py:45-86):
    ``overrides[term]`` merges over that term's defaults; ``overrides``'
    ``kT`` goes to stacking and Debye-Hueckel, its ``salt_conc`` and
    ``half_charged_ends`` to Debye-Hueckel (else the simulation defaults);
    ``opts[term]`` names the parameters a fit moves (default: all, but
    stacking's ``kT`` and ``ss_stack_weights`` and Debye's ``kT`` and
    ``salt_conc``)."""
    sim, cfg = default_configs()

    def param(x: str) -> dict:
        return cast_params(cfg[x] | overrides.get(x, {}), dtype, device)

    def get_opts(x: str, defaults: tuple[str, ...] = BaseConfiguration.OPT_ALL) -> tuple[str, ...]:
        return tuple(opts.get(x, defaults))

    kt = overrides.get("kT", sim["kT"])
    stacking_opts = tuple(set(cfg["stacking"]) - {"kT", "ss_stack_weights"})
    debye_opts = tuple(set(cfg["debye"]) - {"kT", "salt_conc"})
    debye_extra = cast_params({
        "kt": kt, "salt_conc": overrides.get("salt_conc", sim["salt_conc"]),
        "half_charged_ends": bool(overrides.get("half_charged_ends", bool(sim["half_charged_ends"]))),
    }, dtype, device)
    return [
        FeneConfiguration.from_dict(param("fene"), get_opts("fene")),
        BondedExcludedVolumeConfiguration.from_dict(param("bonded_excluded_volume"),
                                                    get_opts("bonded_excluded_volume")),
        StackingConfiguration.from_dict(param("stacking") | cast_params({"kt": kt}, dtype, device),
                                        get_opts("stacking", stacking_opts)),
        UnbondedExcludedVolumeConfiguration.from_dict(param("unbonded_excluded_volume"),
                                                      get_opts("unbonded_excluded_volume")),
        HydrogenBondingConfiguration.from_dict(param("hydrogen_bonding"), get_opts("hydrogen_bonding")),
        CrossStackingConfiguration.from_dict(param("cross_stacking"), get_opts("cross_stacking")),
        CoaxialStackingConfiguration.from_dict(param("coaxial_stacking"), get_opts("coaxial_stacking")),
        DebyeConfiguration.from_dict(param("debye") | debye_extra, get_opts("debye", debye_opts)),
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
    topology,
    displacement_fn=None,
    dense_unbonded: bool = False,
    overrides: dict = MappingProxyType({}),
    opts: dict = MappingProxyType({}),
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> ComposedEnergyFunction:
    """The full oxDNA2 composed energy function for a topology, its
    parameters on ``device`` (the card unless the caller asks for the CPU).

    ``displacement_fn``: every term's (``spaces.free()``'s when None;
    ``spaces.periodic(box)[0]`` for a periodic box, which the small-system
    path takes). ``dense_unbonded=True`` evaluates the unbonded terms over
    the dense (N, N) mask of ``simulators.neighbors.dense_pair_mask`` (pair
    it with ``DensePairs``); otherwise over the topology's pair list.
    ``overrides``/``opts``: :func:`default_energy_configs`' (kT, salt,
    half-charged ends, any term's parameters; the parameters a fit moves).
    The stencil and block tiers size their band and tables from this
    energy's bound cutoffs (:func:`per_term_site_cutoffs`,
    :func:`default_neighbor_cutoff`)."""
    device = devices.resolve(device)
    energy = ComposedEnergyFunction([
        cls(cfg.init_params(), topology, default_transform_soa_fn(), displacement_fn)
        for cls, cfg in zip(default_energy_fns(), default_energy_configs(overrides, opts, dtype, device), strict=True)
    ])
    return energy.with_props(dense_mask=dense_pair_mask(topology)) if dense_unbonded else energy


def max_site_offset() -> float:
    """Largest |site - COM| offset of the default dna2 geometry."""
    g = geometry()
    back = float(np.hypot(g["com_to_backbone_x"], g["com_to_backbone_y"]))
    return max(back, abs(g["com_to_backbone_dna1"]), abs(g["com_to_hb"]), abs(g["com_to_stacking"]))


def _site_terms(energy_fn=None) -> dict:
    """The unbonded terms' site cutoffs: ``energy_fn``'s bound ones, or the defaults'."""
    return unbonded_site_cutoffs(term_params(energy_fn, default_energy_fns(), default_energy_configs))


def default_neighbor_cutoff(energy_fn=None) -> float:
    """COM-distance cutoff covering every unbonded term of ``energy_fn`` (a
    composed energy, its bound parameters) or of the default model
    (mythos_tpu.energy.dna2.default_neighbor_cutoff)."""
    return max(pair_cutoffs(_site_terms(energy_fn)).values()) + 2.0 * max_site_offset()


def short_range_neighbor_cutoff(energy_fn=None) -> float:
    """COM-distance cutoff over every unbonded term except Debye-Hueckel
    (of ``energy_fn``, else of the default model): the tight table of a
    two-level block neighbor list."""
    cut = pair_cutoffs(_site_terms(energy_fn))
    cut.pop("Debye", None)
    return max(cut.values()) + 2.0 * max_site_offset()


def per_term_site_cutoffs(energy_fn=None) -> dict:
    """SITE-level radial supports per unbonded term: ``energy_fn``'s bound
    cutoffs (a composed energy: its salt's Debye ``r_cut``, any moved
    cutoff), else the default model's (float64 derivation).

    Same contract as mythos_tpu.energy.dna2.per_term_site_cutoffs: feeds
    simulators.neighbors.stencil_band_for_site_cutoffs, whose band then
    records the cutoffs its reaches were sized for; a stencil context of an
    energy whose bound cutoff passes one raises (StencilBand.bound,
    ERR_BAND_CUTOFF).
    """
    g = geometry()
    sites = {
        "back": (g["com_to_backbone_x"], g["com_to_backbone_y"]),
        "base": (g["com_to_hb"], 0.0),
        "stack": (g["com_to_stacking"], 0.0),
    }
    return {"sites": sites, "terms": _site_terms(energy_fn)}


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
