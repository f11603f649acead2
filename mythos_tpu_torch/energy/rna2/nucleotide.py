"""oxRNA2 nucleotide sites: the backbone on (a1, a3), the 3'/5' stacking
sites and the p3/p5 backbone axes.

Counterpart of ``NucleotideSoA`` in mythos_tpu/energy/rna2/nucleotide.py.
"""

from __future__ import annotations

from typing import NamedTuple

from mythos_tpu_torch.soa import BodySoA, Vec3, quat_frame_soa, to_soa


class NucleotideSoA(NamedTuple):
    """Interaction sites and frame of every nucleotide, (n,) components.

    ``bb_p3``/``bb_p5`` are frame vectors (no center offset): the 3'/5'
    phosphate directions of the theta9/theta10 stacking modulations.
    """

    stack: Vec3
    back: Vec3
    base: Vec3
    a1: Vec3
    a2: Vec3
    a3: Vec3
    bb_p3: Vec3
    bb_p5: Vec3
    stack3: Vec3
    stack5: Vec3

    @staticmethod
    def from_body_soa(
        body: BodySoA,
        com_to_backbone_x: float,
        com_to_backbone_y: float,
        com_to_stacking: float,
        com_to_hb: float,
        p3_x: float,
        p3_y: float,
        p3_z: float,
        p5_x: float,
        p5_y: float,
        p5_z: float,
        pos_stack_3_a1: float,
        pos_stack_3_a2: float,
        pos_stack_5_a1: float,
        pos_stack_5_a2: float,
    ) -> "NucleotideSoA":
        """``com_to_backbone_y`` is the backbone's a3 coefficient."""
        a1, a2, a3 = quat_frame_soa(body.orientation)
        com = body.center
        return NucleotideSoA(
            stack=com + com_to_stacking * a1,
            back=com + com_to_backbone_x * a1 + com_to_backbone_y * a3,
            base=com + com_to_hb * a1,
            a1=a1,
            a2=a2,
            a3=a3,
            bb_p3=p3_x * a1 + p3_y * a2 + p3_z * a3,
            bb_p5=p5_x * a1 + p5_y * a2 + p5_z * a3,
            stack3=com + pos_stack_3_a1 * a1 + pos_stack_3_a2 * a2,
            stack5=com + pos_stack_5_a1 * a1 + pos_stack_5_a2 * a2,
        )

    @staticmethod
    def from_rigid_body(body, **geometry) -> "NucleotideSoA":
        return NucleotideSoA.from_body_soa(to_soa(body), **geometry)
