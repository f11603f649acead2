"""oxRNA2 model package (port of mythos_tpu.energy.rna2).

oxRNA2 composes dna1's FENE, excluded volumes, hydrogen bonding and
coaxial stacking with its own stacking and cross stacking and dna2's
Debye-Hueckel, under the rna2 defaults (the data TOML of the JAX package,
read in place; it ships no simulation defaults, so kT 296.15 K x 0.1 / 300,
salt 1.0 and no half-charged ends are the package's, which ``overrides``
replaces as the reference's does).
"""

from __future__ import annotations

import functools
from types import MappingProxyType

import numpy as np
import torch

from mythos_tpu_torch.energy.base import BaseConfiguration, ComposedEnergyFunction
from mythos_tpu_torch.energy.blocks import n_blocks_for
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
    CoaxialStacking,
    CoaxialStackingConfiguration,
    Fene,
    FeneConfiguration,
    HydrogenBonding,
    HydrogenBondingConfiguration,
    UnbondedExcludedVolume,
    UnbondedExcludedVolumeConfiguration,
)
from mythos_tpu_torch.energy.dna2.terms import Debye, DebyeConfiguration
from mythos_tpu_torch.energy.rna2.nucleotide import NucleotideSoA
from mythos_tpu_torch.energy.rna2.terms import (
    CrossStacking,
    CrossStackingConfiguration,
    Stacking,
    StackingConfiguration,
)
from mythos_tpu_torch.simulators.neighbors import dense_pair_mask
from mythos_tpu_torch.utils import devices

#: the defaults of kT and salt where ``overrides`` sets none (the package
#: ships no simulation TOML; the reference's _DEFAULT_KT and _DEFAULT_SALT)
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
    overrides: dict = MappingProxyType({}),
    opts: dict = MappingProxyType({}),
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> list[BaseConfiguration]:
    """Per-term configurations (the order of default_energy_fns), with the
    reference's merge rules (mythos_tpu/energy/rna2/__init__.py:120-163):
    ``overrides[term]`` merges over that term's defaults; ``overrides``'
    ``kT`` goes to stacking and Debye-Hueckel, its ``salt_conc`` and
    ``half_charged_ends`` to Debye-Hueckel (else KT, SALT_CONC and no
    half-charged ends); ``opts[term]`` names the parameters a fit moves
    (default: all, stacking's and Debye's TOML parameters)."""
    _, cfg = default_configs()

    def param(x: str) -> dict:
        return cast_params(cfg[x] | overrides.get(x, {}), dtype, device)

    def get_opts(x: str, defaults: tuple[str, ...] = BaseConfiguration.OPT_ALL) -> tuple[str, ...]:
        return tuple(opts.get(x, defaults))

    kt = overrides.get("kT", KT)
    debye_extra = cast_params({
        "kt": kt, "salt_conc": overrides.get("salt_conc", SALT_CONC),
        "half_charged_ends": bool(overrides.get("half_charged_ends", False)),
    }, dtype, device)
    return [
        FeneConfiguration.from_dict(param("fene"), get_opts("fene")),
        BondedExcludedVolumeConfiguration.from_dict(param("bonded_excluded_volume"),
                                                    get_opts("bonded_excluded_volume")),
        StackingConfiguration.from_dict(param("stacking") | cast_params({"kt": kt}, dtype, device),
                                        get_opts("stacking", tuple(cfg["stacking"]))),
        UnbondedExcludedVolumeConfiguration.from_dict(param("unbonded_excluded_volume"),
                                                      get_opts("unbonded_excluded_volume")),
        HydrogenBondingConfiguration.from_dict(param("hydrogen_bonding"), get_opts("hydrogen_bonding")),
        CrossStackingConfiguration.from_dict(param("cross_stacking"), get_opts("cross_stacking")),
        CoaxialStackingConfiguration.from_dict(param("coaxial_stacking"), get_opts("coaxial_stacking")),
        DebyeConfiguration.from_dict(param("debye") | debye_extra, get_opts("debye", tuple(cfg["debye"]))),
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
    displacement_fn=None,
    dense_unbonded: bool = False,
    block_unbonded: bool = False,
    block_size: int = 16,
    overrides: dict = MappingProxyType({}),
    opts: dict = MappingProxyType({}),
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> ComposedEnergyFunction:
    """The full oxRNA2 composed energy function for a topology, its
    parameters on ``device`` (the card unless the caller asks for the CPU).

    ``displacement_fn``: every term's (``spaces.free()``'s when None;
    ``spaces.periodic(box)[0]`` for a periodic box). ``dense_unbonded``:
    the unbonded terms over the dense (N, N) mask (``DensePairs``).
    ``block_unbonded``: the unbonded terms sum over a block table of
    ``block_size`` (energy/blocks.py), bound later with
    ``with_props(block_ids=nbl.idx, block_perm=nbl.perm)`` of a
    non-symmetric BlockNeighborList; until then an empty placeholder that
    raises when evaluated (as the reference's). ``overrides``/``opts``:
    :func:`default_energy_configs`'."""
    device = devices.resolve(device)
    energy = ComposedEnergyFunction([
        cls(cfg.init_params(), topology, default_transform_soa_fn(), displacement_fn)
        for cls, cfg in zip(default_energy_fns(), default_energy_configs(overrides, opts, dtype, device), strict=True)
    ])
    if block_unbonded:
        nb = n_blocks_for(topology.n_nucleotides, block_size)
        return energy.with_props(block_ids=torch.zeros((nb, 0), dtype=torch.int32, device=device),
                                 block_size=block_size)
    return energy.with_props(dense_mask=dense_pair_mask(topology)) if dense_unbonded else energy


def max_site_offset() -> float:
    """Largest |site - COM| offset of the default rna2 geometry."""
    g = geometry()
    back = float(np.hypot(g["com_to_backbone_x"], g["com_to_backbone_y"]))
    return max(back, abs(g["com_to_hb"]), abs(g["com_to_stacking"]))


def _site_terms(energy_fn=None) -> dict:
    """The unbonded terms' site cutoffs: ``energy_fn``'s bound ones, or the defaults'."""
    return unbonded_site_cutoffs(term_params(energy_fn, default_energy_fns(), default_energy_configs))


def default_neighbor_cutoff(energy_fn=None) -> float:
    """COM-distance cutoff covering every unbonded term of ``energy_fn`` (a
    composed energy, its bound parameters) or of the default model."""
    return max(pair_cutoffs(_site_terms(energy_fn)).values()) + 2.0 * max_site_offset()


def short_range_neighbor_cutoff(energy_fn=None) -> float:
    """COM-distance cutoff over every unbonded term except Debye-Hueckel
    (of ``energy_fn``, else of the default model)."""
    cut = pair_cutoffs(_site_terms(energy_fn))
    cut.pop("Debye", None)
    return max(cut.values()) + 2.0 * max_site_offset()


def per_term_site_cutoffs(energy_fn=None) -> dict:
    """SITE-level radial supports per unbonded term (``energy_fn``'s bound
    ones, else the defaults'); site coefficients are (a1, a2, a3) triples
    (the backbone spans a1 and a3). Feeds
    simulators.neighbors.stencil_band_for_site_cutoffs."""
    g = geometry()
    sites = {
        "back": (g["com_to_backbone_x"], 0.0, g["com_to_backbone_y"]),
        "base": (g["com_to_hb"], 0.0, 0.0),
        "stack": (g["com_to_stacking"], 0.0, 0.0),
    }
    return {"sites": sites, "terms": _site_terms(energy_fn)}


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
