"""oxNA hybrid nucleotide: a dna2 and an rna2 view of the same rigid body.

Counterpart of mythos_tpu/energy/na1/nucleotide.py. The port's nucleotides
are all component arrays (``NucleotideSoA``), so ``HybridNucleotide`` and
``HybridNucleotideSoA`` are one class.
"""

from __future__ import annotations

from typing import NamedTuple

from mythos_tpu_torch.energy.dna2.nucleotide import NucleotideSoA as Dna2NucleotideSoA
from mythos_tpu_torch.energy.rna2.nucleotide import NucleotideSoA as Rna2NucleotideSoA
from mythos_tpu_torch.soa import BodySoA, to_soa


class HybridNucleotideSoA(NamedTuple):
    """The dna2 and rna2 site systems of every nucleotide, (n,) components."""

    dna: Dna2NucleotideSoA
    rna: Rna2NucleotideSoA

    @staticmethod
    def from_body_soa(body: BodySoA, dna_kwargs: dict, rna_kwargs: dict) -> "HybridNucleotideSoA":
        return HybridNucleotideSoA(
            dna=Dna2NucleotideSoA.from_body_soa(body, **dna_kwargs),
            rna=Rna2NucleotideSoA.from_body_soa(body, **rna_kwargs),
        )

    @staticmethod
    def from_rigid_body(body, dna_kwargs: dict, rna_kwargs: dict) -> "HybridNucleotideSoA":
        return HybridNucleotideSoA.from_body_soa(to_soa(body), dna_kwargs, rna_kwargs)


HybridNucleotide = HybridNucleotideSoA
