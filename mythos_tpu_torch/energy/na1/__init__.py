"""oxNA hybrid DNA/RNA model package (port of mythos_tpu.energy.na1).

Every term evaluates its sub-models -- the dna2 and rna2 parameter sets,
and a DNA<->RNA hybrid set (drh) for unbonded pairs -- over the same pairs
and selects per pair by nucleotide type (``hybrid.make_hybrid_term``).
As the reference, the package has no ``create_default_energy_fn``: terms
are composed from ``default_configs()``' tables, each with ``nt_type``
(the topology's) and the shared kt, salt_conc and half_charged_ends::

    sim, params = na1.default_configs()
    shared = {"stacking": {"kt": kt}, "debye": {"kt": kt, "salt_conc": salt}}
    fns = [cls(cfg_cls(**params_from_numpy(params[key] | shared.get(key, {}), device, dtype),
                       nt_type=top.nt_type, **({"half_charged_ends": False} if key == "debye" else {})
                       ).init_params(), top, na1.default_transform_soa_fn())
           for key, cls, cfg_cls in na1.TERMS]
    energy = ComposedEnergyFunction(fns)

The hybrid runs on pair lists (``NoNeighborList`` or a
``FixedCapacityNeighborList`` under ``simulators.cuda.PairSimulator``) and
on non-symmetric block tables (the block sums under ``BlockSimulator``).
The drh tables are the JAX package's data file
``mythos_tpu/energy/na1/defaults/energy.toml``, read in place.
"""

from __future__ import annotations

import functools

import mythos_tpu_torch.energy.dna1.terms as t1
import mythos_tpu_torch.energy.dna2 as dna2
import mythos_tpu_torch.energy.dna2.terms as t2
import mythos_tpu_torch.energy.rna2 as rna2
import mythos_tpu_torch.energy.rna2.terms as tr
from mythos_tpu_torch.energy.defaults import default_configs_for
from mythos_tpu_torch.energy.na1.hybrid import (
    hybrid_params_from_configs,
    is_dna_rna_pair,
    is_rna_pair,
    make_hybrid_term,
)
from mythos_tpu_torch.energy.na1.nucleotide import HybridNucleotide, HybridNucleotideSoA

Fene, FeneConfiguration = make_hybrid_term(
    "Fene", pairs="bonded",
    subspecs={"dna": (t1.Fene, t1.FeneConfiguration), "rna": (t1.Fene, t1.FeneConfiguration)},
)

BondedExcludedVolume, BondedExcludedVolumeConfiguration = make_hybrid_term(
    "BondedExcludedVolume", pairs="bonded",
    subspecs={
        "dna": (t1.BondedExcludedVolume, t1.BondedExcludedVolumeConfiguration),
        "rna": (t1.BondedExcludedVolume, t1.BondedExcludedVolumeConfiguration),
    },
)

Stacking, StackingConfiguration = make_hybrid_term(
    "Stacking", pairs="bonded",
    subspecs={"dna": (t2.Stacking, t1.StackingConfiguration), "rna": (tr.Stacking, tr.StackingConfiguration)},
    shared=("kt",),
    optional_sub_params=("ss_stack_weights",),
)

UnbondedExcludedVolume, UnbondedExcludedVolumeConfiguration = make_hybrid_term(
    "UnbondedExcludedVolume", pairs="unbonded",
    subspecs={p: (t1.UnbondedExcludedVolume, t1.UnbondedExcludedVolumeConfiguration) for p in ("dna", "rna", "drh")},
)

HydrogenBonding, HydrogenBondingConfiguration = make_hybrid_term(
    "HydrogenBonding", pairs="unbonded",
    subspecs={p: (t1.HydrogenBonding, t1.HydrogenBondingConfiguration) for p in ("dna", "rna", "drh")},
    optional_sub_params=("ss_hb_weights",),
)

CrossStacking, CrossStackingConfiguration = make_hybrid_term(
    "CrossStacking", pairs="unbonded",
    subspecs={
        "dna": (t1.CrossStacking, t1.CrossStackingConfiguration),
        "rna": (tr.CrossStacking, tr.CrossStackingConfiguration),
        "drh": (t1.CrossStacking, t1.CrossStackingConfiguration),
    },
)

CoaxialStacking, CoaxialStackingConfiguration = make_hybrid_term(
    "CoaxialStacking", pairs="unbonded",
    subspecs={
        "dna": (t2.CoaxialStacking, t2.CoaxialStackingConfiguration),
        "rna": (t1.CoaxialStacking, t1.CoaxialStackingConfiguration),
        "drh": (t1.CoaxialStacking, t1.CoaxialStackingConfiguration),
    },
)

Debye, DebyeConfiguration = make_hybrid_term(
    "Debye", pairs="unbonded",
    subspecs={p: (t2.Debye, t2.DebyeConfiguration) for p in ("dna", "rna", "drh")},
    shared=("kt", "salt_conc", "half_charged_ends"),
)

#: (table of default_configs(), term, configuration), in the reference's order
TERMS = (
    ("fene", Fene, FeneConfiguration),
    ("bonded_excluded_volume", BondedExcludedVolume, BondedExcludedVolumeConfiguration),
    ("stacking", Stacking, StackingConfiguration),
    ("unbonded_excluded_volume", UnbondedExcludedVolume, UnbondedExcludedVolumeConfiguration),
    ("hydrogen_bonding", HydrogenBonding, HydrogenBondingConfiguration),
    ("cross_stacking", CrossStacking, CrossStackingConfiguration),
    ("coaxial_stacking", CoaxialStacking, CoaxialStackingConfiguration),
    ("debye", Debye, DebyeConfiguration),
)


def default_configs() -> tuple[dict, dict]:
    """(simulation, hybrid-merged energy) defaults: the dna2 simulation
    tree; the dna2 energy tables under dna_*, rna2's under rna_*, the
    hybrid-pair constants under drh_* leaf keys."""
    sim, dna_energy = dna2.default_configs()
    _, rna_energy = rna2.default_configs()
    _, drh_energy = default_configs_for("na1")
    return sim, hybrid_params_from_configs(dna_energy, rna_energy, drh_energy)


def default_transform_soa_fn():
    """RigidBody -> HybridNucleotideSoA with both default geometries."""
    return functools.partial(HybridNucleotideSoA.from_rigid_body, dna_kwargs=dna2.geometry(),
                             rna_kwargs=rna2.geometry())


default_transform_fn = default_transform_soa_fn

__all__ = [
    "TERMS",
    "BondedExcludedVolume",
    "BondedExcludedVolumeConfiguration",
    "CoaxialStacking",
    "CoaxialStackingConfiguration",
    "CrossStacking",
    "CrossStackingConfiguration",
    "Debye",
    "DebyeConfiguration",
    "Fene",
    "FeneConfiguration",
    "HybridNucleotide",
    "HybridNucleotideSoA",
    "HydrogenBonding",
    "HydrogenBondingConfiguration",
    "Stacking",
    "StackingConfiguration",
    "UnbondedExcludedVolume",
    "UnbondedExcludedVolumeConfiguration",
    "default_configs",
    "default_transform_fn",
    "default_transform_soa_fn",
    "hybrid_params_from_configs",
    "is_dna_rna_pair",
    "is_rna_pair",
]
