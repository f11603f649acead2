"""oxDNA1 model package (port of mythos_tpu.energy.dna1).

The oxDNA1 model -- FENE, bonded and unbonded excluded volume, stacking
(its ``kt`` fixed), hydrogen bonding, cross stacking and oxDNA1's coaxial
stacking on the dna1 nucleotide (one backbone site on a1), no
Debye-Hueckel -- under its own defaults (the data TOMLs of the JAX
package, read in place), and the pieces oxDNA2 and oxRNA2 share with it
(``terms``, ``geometry``).

Every tier of the port runs it: the pair list and the dense (N, N) masks
(``create_default_energy_fn(dense_unbonded=True)``; simulators.cuda.
PairSimulator, also in a periodic box: ``displacement_fn``), the banded stencil (K1, K2), the block tier on a
one-level table (K3), and the DiffTRe re-evaluation on that table
(``ComposedEnergyFunction.map`` with ``map_neighbors``: K4, backward K5).
"""

from __future__ import annotations

import functools
from types import MappingProxyType

import torch

from mythos_tpu_torch.energy.base import BaseConfiguration, ComposedEnergyFunction
from mythos_tpu_torch.energy.defaults import (
    cast_params,
    default_configs_for,
    pair_cutoffs,
    term_params,
    unbonded_site_cutoffs,
)
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


def default_energy_configs(
    overrides: dict = MappingProxyType({}),
    opts: dict = MappingProxyType({}),
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> list[BaseConfiguration]:
    """Per-term configurations (the order of default_energy_fns), with the
    reference's merge rules (mythos_tpu/energy/dna1/__init__.py:41-72):
    ``overrides[term]`` merges over that term's defaults, ``overrides``'
    ``kT`` goes to stacking (else the simulation default); ``opts[term]``
    names the parameters a fit moves (default: all, but stacking's ``kT``
    and ``ss_stack_weights``: its ``kt`` stays fixed)."""
    sim, cfg = default_configs()

    def param(x: str) -> dict:
        return cast_params(cfg[x] | overrides.get(x, {}), dtype, device)

    def get_opts(x: str, defaults: tuple[str, ...] = BaseConfiguration.OPT_ALL) -> tuple[str, ...]:
        return tuple(opts.get(x, defaults))

    stacking_opts = tuple(set(cfg["stacking"]) - {"kT", "ss_stack_weights"})
    kt = cast_params({"kt": overrides.get("kT", sim["kT"])}, dtype, device)
    return [
        FeneConfiguration.from_dict(param("fene"), get_opts("fene")),
        BondedExcludedVolumeConfiguration.from_dict(param("bonded_excluded_volume"),
                                                    get_opts("bonded_excluded_volume")),
        StackingConfiguration.from_dict(param("stacking") | kt, get_opts("stacking", stacking_opts)),
        UnbondedExcludedVolumeConfiguration.from_dict(param("unbonded_excluded_volume"),
                                                      get_opts("unbonded_excluded_volume")),
        HydrogenBondingConfiguration.from_dict(param("hydrogen_bonding"), get_opts("hydrogen_bonding")),
        CrossStackingConfiguration.from_dict(param("cross_stacking"), get_opts("cross_stacking")),
        CoaxialStackingConfiguration.from_dict(param("coaxial_stacking"), get_opts("coaxial_stacking")),
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
    displacement_fn=None,
    dense_unbonded: bool = False,
    overrides: dict = MappingProxyType({}),
    opts: dict = MappingProxyType({}),
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> ComposedEnergyFunction:
    """The full oxDNA1 composed energy function for a topology, its
    parameters on ``device`` (the card unless the caller asks for the CPU).

    ``displacement_fn``: every term's (``spaces.free()``'s when None;
    ``spaces.periodic(box)[0]`` for a periodic box, which the small-system
    path takes). ``dense_unbonded=True`` evaluates the unbonded terms over
    the dense (N, N) mask of ``simulators.neighbors.dense_pair_mask`` (pair
    it with ``DensePairs``), as the reference's; otherwise over the
    topology's pair list. The block and stencil tiers take the pair-list
    energy and carry their own tables. ``overrides``/``opts``:
    :func:`default_energy_configs`'."""
    device = devices.resolve(device)
    energy = ComposedEnergyFunction([
        cls(cfg.init_params(), topology, default_transform_soa_fn(), displacement_fn)
        for cls, cfg in zip(default_energy_fns(), default_energy_configs(overrides, opts, dtype, device), strict=True)
    ])
    return energy.with_props(dense_mask=dense_pair_mask(topology)) if dense_unbonded else energy


def max_site_offset() -> float:
    """Largest |site - COM| offset of the default dna1 geometry: a site
    cutoff plus twice this is a COM cutoff."""
    return max(abs(v) for v in default_geometry().values())


def _site_terms(energy_fn=None) -> dict:
    """The unbonded terms' site cutoffs: ``energy_fn``'s bound ones, or the defaults'."""
    return unbonded_site_cutoffs(term_params(energy_fn, default_energy_fns(), default_energy_configs))


def default_neighbor_cutoff(energy_fn=None) -> float:
    """COM-distance cutoff covering every unbonded term of ``energy_fn`` (a
    composed energy, its bound parameters) or of the default model
    (mythos_tpu.energy.dna1.default_neighbor_cutoff)."""
    return max(pair_cutoffs(_site_terms(energy_fn)).values()) + 2.0 * max_site_offset()


def per_term_neighbor_cutoffs(energy_fn=None) -> dict[str, float]:
    """COM-distance cutoff of each unbonded term (no Debye-Hueckel: every
    term is short-range)."""
    return {nm: c + 2.0 * max_site_offset() for nm, c in pair_cutoffs(_site_terms(energy_fn)).items()}


def per_term_site_cutoffs(energy_fn=None) -> dict:
    """SITE-level radial supports per unbonded term, ``energy_fn``'s bound
    ones or (None) the defaults' (float64 derivation): one backbone site on
    a1 and no Debye term. Same contract as
    mythos_tpu.energy.dna1.per_term_site_cutoffs; feeds
    simulators.neighbors.stencil_band_for_site_cutoffs."""
    g = default_geometry()
    sites = {
        "back": (g["com_to_backbone"], 0.0),
        "base": (g["com_to_hb"], 0.0),
        "stack": (g["com_to_stacking"], 0.0),
    }
    return {"sites": sites, "terms": _site_terms(energy_fn)}


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
