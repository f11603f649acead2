"""oxDNA1 nucleotide sites: backbone, hydrogen-bonding and stacking sites
on the a1 axis.

Counterpart of mythos_tpu/energy/dna1/nucleotide.py: ``Nucleotide`` (the
AoS form, (N, 3) fields) and ``NucleotideSoA`` (Vec3 fields of (N,)
components, the form the terms read).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mythos_tpu_torch.rigid_body import RigidBody
from mythos_tpu_torch.soa import BodySoA, Quat, Vec3, quat_frame_soa, to_soa


class Nucleotide(NamedTuple):
    """A rigid body with its sites: site = com + offset x a1; ``cross_prods``
    is a2, ``base_normals`` a3 (the reference's field names)."""

    center: torch.Tensor
    orientation: torch.Tensor
    back_base_vectors: torch.Tensor
    cross_prods: torch.Tensor
    base_normals: torch.Tensor
    stack_sites: torch.Tensor
    back_sites: torch.Tensor
    base_sites: torch.Tensor

    @staticmethod
    def from_rigid_body(
        rigid_body: RigidBody, com_to_backbone: float, com_to_hb: float, com_to_stacking: float
    ) -> "Nucleotide":
        a1, a2, a3 = (torch.stack(tuple(v), dim=-1) for v in quat_frame_soa(Quat(*rigid_body.orientation.unbind(-1))))
        com = rigid_body.center
        return Nucleotide(
            center=com,
            orientation=rigid_body.orientation,
            back_base_vectors=a1,
            cross_prods=a2,
            base_normals=a3,
            stack_sites=com + com_to_stacking * a1,
            back_sites=com + com_to_backbone * a1,
            base_sites=com + com_to_hb * a1,
        )


class NucleotideSoA(NamedTuple):
    """Interaction sites and frame of every nucleotide, (n,) components."""

    stack: Vec3
    back: Vec3
    base: Vec3
    a1: Vec3
    a2: Vec3
    a3: Vec3

    @staticmethod
    def from_body_soa(body: BodySoA, com_to_backbone: float, com_to_hb: float, com_to_stacking: float) -> "NucleotideSoA":
        a1, a2, a3 = quat_frame_soa(body.orientation)
        com = body.center
        return NucleotideSoA(
            stack=com + com_to_stacking * a1,
            back=com + com_to_backbone * a1,
            base=com + com_to_hb * a1,
            a1=a1,
            a2=a2,
            a3=a3,
        )

    @staticmethod
    def from_rigid_body(body, **geometry) -> "NucleotideSoA":
        return NucleotideSoA.from_body_soa(to_soa(body), **geometry)
