"""Generic hybrid-term machinery of the oxNA model.

Counterpart of mythos_tpu/energy/na1/hybrid.py. A hybrid term holds
dna_/rna_(/drh_) prefixed copies of sub-model terms' parameters, builds the
sub-configurations when its own is derived, evaluates each sub-model over
all its pairs and selects per pair by nucleotide type:

* bonded terms, a 2-way select: the rna sub-model where both ends are RNA,
  else the dna one (``is_rna_pair``);
* unbonded terms, a 4-way select: rna where both are RNA, drh where i is
  DNA and j RNA, drh with the bodies swapped where i is RNA and j DNA,
  else dna -- on a pair list by ``is_rna_pair``/``is_dna_rna_pair``
  (hybrid.py:222-237), on a block table's tiles by RNA or not
  (``_tile_select``, hybrid.py:239-264).

The sub-terms are the port's own term classes (dna1, dna2, rna2), whose
``bond_energies`` and ``pair_energies`` give one value a pair. The hybrid
runs on pair lists (static or a ``FixedCapacityNeighborList``'s) and on
block tables (energy/blocks.py), as the reference's; it takes no dense
mask (the reference's hybrid takes pair lists) and has no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from mythos_tpu_torch.energy.base import BaseConfiguration, BaseEnergyFunction
from mythos_tpu_torch.energy.dna1.terms import _BondedPairs, _UnbondedPairs
from mythos_tpu_torch.io.topology import NucleotideType

PREFIXES = ("dna", "rna", "drh")
ERR_DENSE = "the oxNA hybrid terms take pair lists and block tables, not dense masks"


def is_rna_pair(i: torch.Tensor, j: torch.Tensor, nt_type: torch.Tensor) -> torch.Tensor:
    """True where both nucleotides are RNA (over index tensors)."""
    return (nt_type[i] == NucleotideType.RNA) & (nt_type[j] == NucleotideType.RNA)


def is_dna_rna_pair(i: torch.Tensor, j: torch.Tensor, nt_type: torch.Tensor) -> torch.Tensor:
    """True where i is DNA and j is RNA."""
    return (nt_type[i] == NucleotideType.DNA) & (nt_type[j] == NucleotideType.RNA)


def make_hybrid_configuration(
    name: str, subspecs: dict, shared: tuple = (), optional_sub_params: tuple = ()
) -> type[BaseConfiguration]:
    """The hybrid configuration class: ``nt_type`` (not optimised), each
    sub-configuration's required parameters prefixed (``dna_eps_backbone``,
    ``drh_k_cross``), the ``shared`` ones unprefixed (kt, salt_conc, ...),
    ``optional_sub_params`` prefixed (forwarded where set), and one derived
    ``<prefix>_config`` each: the sub-configuration, derived."""
    required = ["nt_type"]
    optional = []
    for prefix, (_, cfg_cls) in subspecs.items():
        required += [f"{prefix}_{p}" for p in cfg_cls.required_params if p not in shared]
        optional += [f"{prefix}_{p}" for p in optional_sub_params if p in cfg_cls.optional_params]
    required += list(shared)

    def derive(self) -> dict:
        out = {}
        for prefix, (_, cfg_cls) in subspecs.items():
            values = {p: getattr(self, p if p in shared else f"{prefix}_{p}") for p in cfg_cls.required_params}
            for p in optional_sub_params:
                if p in cfg_cls.optional_params and getattr(self, f"{prefix}_{p}") is not None:
                    values[p] = getattr(self, f"{prefix}_{p}")
            out[f"{prefix}_config"] = cfg_cls(**values).init_params()
        return out

    return type(name, (BaseConfiguration,), {
        "required_params": tuple(required),
        "non_optimizable_required_params": ("nt_type",),
        "dependent_params": tuple(f"{p}_config" for p in subspecs),
        "optional_params": tuple(optional),
        "derive": derive,
        "__doc__": f"Hybrid oxNA {name}: prefixed sub-model parameters.",
    })


class _HybridTerm(BaseEnergyFunction):
    """What every hybrid term shares: its sub-terms, one a prefix, built from
    the derived sub-configurations (kept until the parameters change)."""

    subspecs: dict = {}

    def sub_term(self, prefix: str):
        subs = self.__dict__.setdefault("_subs", {})
        if prefix not in subs:
            term_cls = self.subspecs[prefix][0]
            subs[prefix] = term_cls(getattr(self.params, f"{prefix}_config"), self.topology, None)
        return subs[prefix]

    def with_params(self, **values) -> "BaseEnergyFunction":
        new = super().with_params(**values)
        new.__dict__.pop("_subs", None)
        new.__dict__["_device_cache"] = {k: v for k, v in self.__dict__.get("_device_cache", {}).items()
                                         if k[0] != "nt_type"}
        return new

    def nt_type(self, device) -> torch.Tensor:
        return self._cached("nt_type", device, lambda: torch.as_tensor(np.asarray(self.params.nt_type)).long())


class _HybridBonded(_HybridTerm, _BondedPairs):
    def bond_energies(self, nuc) -> torch.Tensor:
        device = nuc.dna.back.x.device
        i, j = self.bond_index(device)
        rna = is_rna_pair(i, j, self.nt_type(device))
        return torch.where(rna, self.sub_term("rna").bond_energies(nuc.rna),
                           self.sub_term("dna").bond_energies(nuc.dna))


class _HybridUnbonded(_HybridTerm, _UnbondedPairs):
    def pair_cutoff(self) -> float:
        return max(self.sub_term(p).pair_cutoff() for p in self.subspecs)

    def tile_row_fields(self, device) -> dict:
        """The per-nucleotide fields the selects read: the nucleotide type."""
        return {"nt_type": self.nt_type(device)}

    def compute_energy(self, nuc) -> torch.Tensor:
        if self.dense_mask is not None:
            raise ValueError(ERR_DENSE)
        return super().compute_energy(nuc)

    def pair_energies(self, si, sj) -> torch.Tensor:
        dna, rna, drh = (self.sub_term(p) for p in PREFIXES)
        vals = {
            "dna": dna.pair_energies(si.dna, sj.dna),
            "rna": rna.pair_energies(si.rna, sj.rna),
            "drh": drh.pair_energies(si.dna, sj.rna),
            "rdh": drh.pair_energies(si.rna, sj.dna),
        }
        nt = self.tile_row_fields(si.idx.device)["nt_type"]
        if si.idx.dim() == 1:  # a pair list
            sel = {"rna": is_rna_pair(si.idx, sj.idx, nt), "drh": is_dna_rna_pair(si.idx, sj.idx, nt),
                   "rdh": is_dna_rna_pair(sj.idx, si.idx, nt)}
        else:
            sel = self._tile_select(nt[si.idx] == NucleotideType.RNA, nt[sj.idx] == NucleotideType.RNA)
        return torch.where(sel["rna"], vals["rna"],
                           torch.where(sel["drh"], vals["drh"], torch.where(sel["rdh"], vals["rdh"], vals["dna"])))

    @staticmethod
    def _tile_select(rna_i: torch.Tensor, rna_j: torch.Tensor) -> dict:
        """The block path's selects: RNA or not on either side."""
        return {"rna": rna_i & rna_j, "drh": ~rna_i & rna_j, "rdh": rna_i & ~rna_j}


def make_hybrid_term(
    name: str, pairs: str, subspecs: dict, shared: tuple = (), optional_sub_params: tuple = ()
) -> tuple[type, type[BaseConfiguration]]:
    """(Term, Configuration) of a hybrid oxNA term. ``pairs``: "bonded" (the
    2-way select over bonded pairs) or "unbonded" (the 4-way select; the drh
    sub-model serves DNA->RNA and RNA->DNA with the bodies swapped).
    ``subspecs``: prefix -> (port term class, its configuration class)."""
    cfg_cls = make_hybrid_configuration(f"{name}Configuration", subspecs, shared, optional_sub_params)
    base = _HybridBonded if pairs == "bonded" else _HybridUnbonded
    term_cls = type(name, (base,), {
        "subspecs": dict(subspecs),
        "__doc__": f"Hybrid oxNA {name} (the {'2' if pairs == 'bonded' else '4'}-way nucleotide-type select).",
    })
    return term_cls, cfg_cls


def hybrid_params_from_configs(dna_params: dict, rna_params: dict, drh_params: dict | None = None) -> dict:
    """Merge per-model parameter tables into the prefixed hybrid namespace:
    leaf keys gain dna_/rna_/drh_ prefixes, table names stay (the
    reference's prefix-and-merge)."""

    def prefix_leaves(data, prefix):
        if isinstance(data, dict):
            return {(prefix + k if not isinstance(v, (dict, list)) else k): prefix_leaves(v, prefix)
                    for k, v in data.items()}
        return data

    def merge(d1, d2):
        out = dict(d1)
        for k, v in d2.items():
            out[k] = merge(out[k], v) if isinstance(out.get(k), dict) and isinstance(v, dict) else v
        return out

    merged = merge(prefix_leaves(rna_params, "rna_"), prefix_leaves(dna_params, "dna_"))
    if drh_params is not None:
        merged = merge(merged, prefix_leaves(drh_params, "drh_"))
    return merged

