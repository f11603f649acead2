"""oxDNA2 nucleotide sites: planar backbone site + dna1-compatible one.

Counterpart of ``NucleotideSoA`` in mythos_tpu/energy/dna2/nucleotide.py.
"""

from __future__ import annotations

from typing import NamedTuple

from mythos_tpu_torch.soa import BodySoA, Vec3, quat_frame_soa, to_soa


class NucleotideSoA(NamedTuple):
    """Interaction sites and frame of every nucleotide, (n,) components."""

    stack: Vec3
    back: Vec3
    back_dna1: Vec3
    base: Vec3
    a1: Vec3
    a2: Vec3
    a3: Vec3

    @staticmethod
    def from_body_soa(
        body: BodySoA,
        com_to_backbone_x: float,
        com_to_backbone_y: float,
        com_to_backbone_dna1: float,
        com_to_hb: float,
        com_to_stacking: float,
    ) -> "NucleotideSoA":
        a1, a2, a3 = quat_frame_soa(body.orientation)
        com = body.center
        return NucleotideSoA(
            stack=com + com_to_stacking * a1,
            back=com + com_to_backbone_x * a1 + com_to_backbone_y * a2,
            back_dna1=com + com_to_backbone_dna1 * a1,
            base=com + com_to_hb * a1,
            a1=a1,
            a2=a2,
            a3=a3,
        )

    @staticmethod
    def from_rigid_body(body, **geometry) -> "NucleotideSoA":
        return NucleotideSoA.from_body_soa(to_soa(body), **geometry)
