"""Pair-geometry of the oxDNA-family terms on Vec3 fields (any shape).

Counterpart of the vector forms in mythos_tpu/energy/dna1/geometry.py
(``unbonded_geometry_vec``, ``coax_geometry_vec`` and the bonded geometry).
One set of formulas serves both evaluation paths of the port: the
pair-list reference (``safe_arccos``) and the stencil band twin
(``arccos_poly``, as the kernels use).

Pair-direction conventions (as in the reference), ``disp`` the term's
displacement over Vec3 fields (plain subtraction in free space):
* bonded pairs:   dr_site = disp(site[i], site[j])  (i the 3'-side)
* unbonded pairs: dr_site = disp(site[j], site[i])
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mythos_tpu_torch.soa import Vec3, vcross, vdot, vnorm
from mythos_tpu_torch.utils.math import safe_arccos


class UnbondedGeometry(NamedTuple):
    """Angle set shared by hydrogen bonding and cross stacking."""

    r_base: torch.Tensor
    theta1: torch.Tensor
    theta2: torch.Tensor
    theta3: torch.Tensor
    theta4: torch.Tensor
    theta7: torch.Tensor
    theta8: torch.Tensor


class CoaxGeometry(NamedTuple):
    """Angle set of coaxial stacking; the phi cosines only where the
    backbone sites were given (oxDNA1's coax reads them, oxDNA2's not)."""

    r_stack: torch.Tensor
    theta1: torch.Tensor
    theta4: torch.Tensor
    theta5: torch.Tensor
    theta6: torch.Tensor
    cosphi3: torch.Tensor | None = None
    cosphi4: torch.Tensor | None = None


class BondedGeometry(NamedTuple):
    """Angle set of bonded stacking."""

    r_stack: torch.Tensor
    theta4: torch.Tensor
    theta5: torch.Tensor
    theta6: torch.Tensor
    cosphi1: torch.Tensor
    cosphi2: torch.Tensor


def unbonded_geometry_vec(base_i, base_j, a1_i, a1_j, n_i, n_j, arccos=safe_arccos, disp=Vec3.__sub__):
    dr = disp(base_j, base_i)
    r = vnorm(dr)
    inv_r = 1.0 / r
    return UnbondedGeometry(
        r_base=r,
        theta1=arccos(-vdot(a1_i, a1_j)),
        theta2=arccos(-vdot(a1_j, dr) * inv_r),
        theta3=arccos(vdot(a1_i, dr) * inv_r),
        theta4=arccos(vdot(n_i, n_j)),
        theta7=arccos(-vdot(n_j, dr) * inv_r),
        theta8=math.pi - arccos(vdot(n_i, dr) * inv_r),
    )


def coax_geometry_vec(stack_i, stack_j, a1_i, a1_j, n_i, n_j, arccos=safe_arccos, back_i=None, back_j=None,
                      disp=Vec3.__sub__):
    dr = disp(stack_j, stack_i)
    r = vnorm(dr)
    u = dr * (1.0 / r)
    cosphi3 = cosphi4 = None
    if back_i is not None:
        db = disp(back_j, back_i)
        ub = db * (1.0 / vnorm(db))
        cosphi3, cosphi4 = vdot(u, vcross(ub, a1_j)), vdot(u, vcross(ub, a1_i))
    return CoaxGeometry(
        r_stack=r,
        theta1=arccos(-vdot(a1_i, a1_j)),
        theta4=arccos(vdot(n_i, n_j)),
        theta5=arccos(vdot(n_i, u)),
        theta6=arccos(-vdot(n_j, u)),
        cosphi3=cosphi3,
        cosphi4=cosphi4,
    )


def bonded_geometry_vec(back_i, back_j, stack_i, stack_j, n_i, n_j, a2_i, a2_j, arccos=safe_arccos,
                        disp=Vec3.__sub__):
    """Stacking geometry of bonded pairs (``back`` = the stacking cosphi site)."""
    dr_back = disp(back_i, back_j)
    inv_rb = 1.0 / vnorm(dr_back)
    dr_stack = disp(stack_i, stack_j)
    r_stack = vnorm(dr_stack)
    inv_rs = 1.0 / r_stack
    return BondedGeometry(
        r_stack=r_stack,
        theta4=arccos(vdot(n_i, n_j)),
        theta5=math.pi - arccos(vdot(n_j, dr_stack) * inv_rs),
        theta6=math.pi - arccos(vdot(n_i, dr_stack) * inv_rs),
        cosphi1=-vdot(a2_i, dr_back) * inv_rb,
        cosphi2=-vdot(a2_j, dr_back) * inv_rb,
    )


def gather(v: Vec3, idx) -> Vec3:
    """Rows ``idx`` of an (n,) Vec3 field. ``index_select``: its backward
    is one ``index_add_``, not the sort of an accumulating ``index_put_``."""
    idx = torch.as_tensor(idx, device=v.x.device)
    return Vec3(*(torch.index_select(c, 0, idx) for c in v))
