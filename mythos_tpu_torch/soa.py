"""Structure-of-arrays rigid-body math on (n,) component tensors.

Counterpart of mythos_tpu/soa.py: ``Vec3``/``Quat``/``BodySoA``, the frame
map, the exact NO_SQUISH free rotor and the quaternion-cotangent to torque
map. The port keeps the JAX package's SoA layout at its public functions
so that tests compare like with like; the CUDA kernels read the same
component rows from one (rows, n) tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mythos_tpu_torch.rigid_body import RigidBody


class Vec3(NamedTuple):
    """A 3-vector field as separate component tensors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)


def vdot(a: Vec3, b: Vec3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def vnorm(a: Vec3, eps: float = 1e-18) -> torch.Tensor:
    """sqrt(|a|^2 + eps): finite gradient at zero distance."""
    return torch.sqrt(vdot(a, a) + eps)


class Quat(NamedTuple):
    """Scalar-first quaternion as separate component tensors."""

    w: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class BodySoA(NamedTuple):
    """Rigid-body state: center Vec3 + orientation Quat, all (n,) leaves."""

    center: Vec3
    orientation: Quat


def to_soa(body: RigidBody) -> BodySoA:
    c, q = body.center, body.orientation
    return BodySoA(Vec3(*c.unbind(-1)), Quat(*q.unbind(-1)))


def quat_multiply_soa(p: Quat, q: Quat) -> Quat:
    """Hamilton product p * q."""
    return Quat(
        p.w * q.w - p.x * q.x - p.y * q.y - p.z * q.z,
        p.w * q.x + p.x * q.w + p.y * q.z - p.z * q.y,
        p.w * q.y - p.x * q.z + p.y * q.w + p.z * q.x,
        p.w * q.z + p.x * q.y - p.y * q.x + p.z * q.w,
    )


def quat_normalize_soa(q: Quat, eps: float = 1e-30) -> Quat:
    inv = torch.rsqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z + eps)
    return Quat(q.w * inv, q.x * inv, q.y * inv, q.z * inv)


def quat_frame_soa(q: Quat) -> tuple[Vec3, Vec3, Vec3]:
    """Rotation-matrix columns (a1, a2, a3), elementwise."""
    q00, q11, q22, q33 = q.w * q.w, q.x * q.x, q.y * q.y, q.z * q.z
    q01, q02, q03 = q.w * q.x, q.w * q.y, q.w * q.z
    q12, q13, q23 = q.x * q.y, q.x * q.z, q.y * q.z
    a1 = Vec3(q00 + q11 - q22 - q33, 2.0 * (q12 + q03), 2.0 * (q13 - q02))
    a2 = Vec3(2.0 * (q12 - q03), q00 - q11 + q22 - q33, 2.0 * (q23 + q01))
    a3 = Vec3(2.0 * (q13 + q02), 2.0 * (q23 - q01), q00 - q11 - q22 + q33)
    return a1, a2, a3


#: NO_SQUISH stage sequence: (axis, dt fraction)
NO_SQUISH_STAGES = ((2, 0.5), (1, 0.5), (0, 1.0), (1, 0.5), (2, 0.5))


def free_rotor_soa(q: Quat, angmom: Vec3, inv_inertia, dt: float) -> tuple[Quat, Vec3]:
    """Exact NO_SQUISH free rigid-rotor flow for time dt (Miller et al. 2002).

    Per principal axis k: q <- q * rho_k(phi/2), L <- R_k(-phi) L with
    phi = dt L_k / I_k; sin/cos are exact at every angle.
    """
    w = q.w
    qs = [q.x, q.y, q.z]
    ls = [angmom.x, angmom.y, angmom.z]
    for axis, frac in NO_SQUISH_STAGES:
        phi = (dt * frac) * ls[axis] * inv_inertia[axis]
        h = 0.5 * phi
        c, s = torch.cos(h), torch.sin(h)
        if axis == 0:
            w, qs[0], qs[1], qs[2] = (
                w * c - qs[0] * s, w * s + qs[0] * c, qs[1] * c + qs[2] * s, qs[2] * c - qs[1] * s,
            )
        elif axis == 1:
            w, qs[0], qs[1], qs[2] = (
                w * c - qs[1] * s, qs[0] * c - qs[2] * s, w * s + qs[1] * c, qs[2] * c + qs[0] * s,
            )
        else:
            w, qs[0], qs[1], qs[2] = (
                w * c - qs[2] * s, qs[0] * c + qs[1] * s, qs[1] * c - qs[0] * s, w * s + qs[2] * c,
            )
        cc, ss = torch.cos(phi), torch.sin(phi)
        j, k = (axis + 1) % 3, (axis + 2) % 3
        lj, lk = ls[j], ls[k]
        ls[j] = cc * lj + ss * lk
        ls[k] = -ss * lj + cc * lk
    return quat_normalize_soa(Quat(w, qs[0], qs[1], qs[2])), Vec3(*ls)


def quat_cotangent_to_torque_soa(q: Quat, g: Quat) -> Vec3:
    """Body-frame torque from dE/dq: tau = -0.5 * vec(q^-1 * g)."""
    prod = quat_multiply_soa(Quat(q.w, -q.x, -q.y, -q.z), g)
    return Vec3(-0.5 * prod.x, -0.5 * prod.y, -0.5 * prod.z)
