"""Rigid-body BAOAB Langevin on SoA state.

Counterpart of ``LangevinStateSoA`` and ``nvt_langevin_soa`` in
mythos_tpu/simulators/integrators.py: geodesic BAOAB with the exact
NO_SQUISH free rotor and exact Ornstein-Uhlenbeck momenta,

    B: p += dt/2 F;  L += dt/2 tau      A: x += dt/2 p/m;  (q, L) <- rotor(dt/2)
    O: p <- c p + sqrt((1-c^2) m kT) xi,  c = exp(-gamma dt / m)   (same for L)
    A, then the force refresh and B.

Random numbers come from an explicit ``torch.Generator``. The stencil
tier's chunk path runs its steps in whole chunks in the K1 kernel
(ops.stencil.multistep_chunk) and takes only the initial state from here;
its per-step branch (``save_every`` 1) and the block tier step with
:func:`nvt_langevin_soa`'s ``step_fn``, their force from an injected
``grad_fn`` (K2 plus the bonded gradient; ops.tiles.fused_grads_ctx: K3).
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from mythos_tpu_torch import soa
from mythos_tpu_torch.ops.stencil import ou_constants


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


def nvt_langevin_soa(
    grad_fn: Callable, dt: float, kT: float, gamma_t: float = 0.0, gamma_r: float = 0.0  # noqa: N803
) -> tuple[Callable, Callable]:
    """Rigid-body BAOAB for scalar mass/inertia/friction: ``(init_fn, step_fn)``.

    ``grad_fn(body, **kwargs) -> (dE/dcom Vec3, dE/dquat Quat)`` gives the
    force and torque. ``init_fn(generator, body, mass, inertia, **kwargs)``
    draws thermal momenta; ``step_fn(state, generator, **kwargs)`` is one
    B-A-O-A-B step with the exact OU constants of ops.stencil.ou_constants
    and six fresh standard normals per particle from ``generator``, one
    (6, n) draw a step. ``step_fn(state, xi=normals, **kwargs)`` takes that
    draw from the caller instead: a caller that draws each step's normals
    ahead, in the same order, gets the same steps and leaves the generator
    in the same state (a checkpointed stretch of steps replays its normals,
    not the generator).
    """

    def force_torque(body: soa.BodySoA, **kwargs):
        g_com, g_quat = grad_fn(body, **kwargs)
        return -g_com, soa.quat_cotangent_to_torque_soa(body.orientation, g_quat)

    def init_fn(generator: torch.Generator, body: soa.BodySoA, mass: float, inertia, **kwargs) -> LangevinStateSoA:
        x = body.center.x
        xi = torch.randn((6, x.shape[0]), generator=generator, device=x.device, dtype=x.dtype)
        sm = float(np.sqrt(mass * kT))
        si = [float(np.sqrt(i * kT)) for i in inertia]
        force, torque = force_torque(body, **kwargs)
        return LangevinStateSoA(
            position=body,
            momentum=soa.Vec3(*(sm * xi[k] for k in range(3))),
            angmom=soa.Vec3(*(si[k] * xi[3 + k] for k in range(3))),
            force=force,
            torque=torque,
            inv_mass=1.0 / float(mass),
            inv_inertia=tuple(1.0 / float(i) for i in inertia),
        )

    def step_fn(
        state: LangevinStateSoA, generator: torch.Generator | None = None, *, xi: torch.Tensor | None = None, **kwargs
    ) -> LangevinStateSoA:
        ou = ou_constants(dt, kT, [1.0 / state.inv_mass], [[1.0 / i for i in state.inv_inertia]], [gamma_t], [gamma_r])
        half, him = 0.5 * dt, 0.5 * dt * state.inv_mass
        pos = state.position
        # B, A
        p = state.momentum + half * state.force
        ell = state.angmom + half * state.torque
        x = pos.center + him * p
        q, ell = soa.free_rotor_soa(pos.orientation, ell, state.inv_inertia, half)
        # O: exact Ornstein-Uhlenbeck
        if xi is None:
            xi = torch.randn((6, x.x.shape[0]), generator=generator, device=x.x.device, dtype=x.x.dtype)
        p = soa.Vec3(*(ou.c_t * pc + ou.s_t * xi[k] for k, pc in enumerate(p)))
        ell = soa.Vec3(*(ou.c_r[k] * lc + ou.s_r[k] * xi[3 + k] for k, lc in enumerate(ell)))
        # A, force refresh, B
        x = x + him * p
        q, ell = soa.free_rotor_soa(q, ell, state.inv_inertia, half)
        new_pos = soa.BodySoA(x, q)
        force, torque = force_torque(new_pos, **kwargs)
        return state._replace(
            position=new_pos, momentum=p + half * force, angmom=ell + half * torque, force=force, torque=torque
        )

    return init_fn, step_fn
