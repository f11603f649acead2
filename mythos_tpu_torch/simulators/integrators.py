"""Rigid-body BAOAB Langevin on SoA state.

Counterpart of ``LangevinStateSoA`` and ``nvt_langevin_soa`` in
mythos_tpu/simulators/integrators.py: geodesic BAOAB with the exact
NO_SQUISH free rotor and exact Ornstein-Uhlenbeck momenta,

    B: p += dt/2 F;  L += dt/2 tau      A: x += dt/2 p/m;  (q, L) <- rotor(dt/2)
    O: p <- c p + sqrt((1-c^2) m kT) xi,  c = exp(-gamma dt / m)   (same for L)
    A, then the force refresh and B.

Random numbers come from an explicit ``torch.Generator``. The steps
themselves run in whole chunks in the K1 kernel
(ops.stencil.multistep_chunk) or its twin; this module holds the state
container and the initial state. The reference's generic per-step form is
not ported: the main path has no per-step fallback.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from mythos_tpu_torch import soa


class LangevinStateSoA(NamedTuple):
    """Integrator state: every field an (n,) component tensor."""

    position: soa.BodySoA
    momentum: soa.Vec3
    angmom: soa.Vec3
    force: soa.Vec3
    torque: soa.Vec3
    inv_mass: float
    inv_inertia: tuple


def state_from_numpy(state, device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32) -> LangevinStateSoA:
    """Carry a JAX ``LangevinStateSoA`` across (every leaf via ``np.asarray``)."""

    def t(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    def vec(v):
        return soa.Vec3(*(t(c) for c in v))

    pos = state.position
    return LangevinStateSoA(
        position=soa.BodySoA(vec(pos.center), soa.Quat(*(t(c) for c in pos.orientation))),
        momentum=vec(state.momentum),
        angmom=vec(state.angmom),
        force=vec(state.force),
        torque=vec(state.torque),
        inv_mass=float(np.asarray(state.inv_mass)),
        inv_inertia=tuple(float(np.asarray(c)) for c in state.inv_inertia),
    )


def nvt_langevin_soa(grad_fn: Callable, kT: float) -> Callable:  # noqa: N803 - domain casing
    """The state initialiser for scalar mass/inertia/friction:
    ``init_fn(generator, body, mass, inertia)`` draws thermal momenta and
    takes force and torque from ``grad_fn(body) -> (dE/dcom, dE/dquat)``.
    The steps' OU constants are ops.stencil.ou_constants.
    """

    def force_torque(body: soa.BodySoA):
        g_com, g_quat = grad_fn(body)
        return -g_com, soa.quat_cotangent_to_torque_soa(body.orientation, g_quat)

    def init_fn(generator: torch.Generator, body: soa.BodySoA, mass: float, inertia) -> LangevinStateSoA:
        x = body.center.x
        xi = torch.randn((6, x.shape[0]), generator=generator, device=x.device, dtype=x.dtype)
        sm = float(np.sqrt(mass * kT))
        si = [float(np.sqrt(i * kT)) for i in inertia]
        force, torque = force_torque(body)
        return LangevinStateSoA(
            position=body,
            momentum=soa.Vec3(*(sm * xi[k] for k in range(3))),
            angmom=soa.Vec3(*(si[k] * xi[3 + k] for k in range(3))),
            force=force,
            torque=torque,
            inv_mass=1.0 / float(mass),
            inv_inertia=tuple(1.0 / float(i) for i in inertia),
        )

    return init_fn
