"""Rigid-body integrators: BAOAB Langevin on AoS and on SoA state, and NVE.

Counterpart of mythos_tpu/simulators/integrators.py: ``LangevinState``,
``free_rotor``, ``nvt_langevin`` and ``nve`` (the AoS forms the
small-system path steps with, the force by autograd of the energy), and
``LangevinStateSoA`` and ``nvt_langevin_soa`` (the kernel tiers'):
geodesic BAOAB with the exact NO_SQUISH free rotor and exact
Ornstein-Uhlenbeck momenta,

    B: p += dt/2 F;  L += dt/2 tau      A: x += dt/2 p/m;  (q, L) <- rotor(dt/2)
    O: p <- c p + sqrt((1-c^2) m kT) xi,  c = exp(-gamma dt / m)   (same for L)
    A, then the force refresh and B.

Random numbers come from an explicit ``torch.Generator`` (the AoS forms
draw (2, N, 3) normals a step: momenta, then angular momenta). The stencil
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
from mythos_tpu_torch.rigid_body import RigidBody


class LangevinState(NamedTuple):
    """AoS integrator state: ``position`` (N, 3)/(N, 4), the (N, 3)
    momenta, body-frame angular momenta, cached force and body torque, and
    ``mass`` (center (N,) masses, orientation (N, 3) principal moments)."""

    position: RigidBody
    momentum: torch.Tensor
    angmom: torch.Tensor
    force: torch.Tensor
    torque: torch.Tensor
    mass: RigidBody


def _aos(v: soa.Vec3) -> torch.Tensor:
    return torch.stack(tuple(v), dim=-1)


def free_rotor(q: torch.Tensor, angmom: torch.Tensor, inertia: torch.Tensor, dt: float):
    """Exact NO_SQUISH free rigid-rotor flow for time dt on (N, 4)
    quaternions and (N, 3) body angular momenta (``inertia`` (N, 3) or (3,))."""
    inv = (1.0 / torch.broadcast_to(torch.as_tensor(inertia, dtype=angmom.dtype, device=angmom.device),
                                    angmom.shape)).unbind(-1)
    q2, ell = soa.free_rotor_soa(soa.Quat(*q.unbind(-1)), soa.Vec3(*angmom.unbind(-1)), inv, dt)
    return torch.stack(tuple(q2), dim=-1), _aos(ell)


def _force_torque(energy_fn: Callable, body: RigidBody, create_graph: bool = False, **kwargs):
    """Force and body-frame torque from one reverse-mode gradient of the
    energy (torch autograd, as the reference's ``jax.grad``). With
    ``create_graph`` they stay differentiable in whatever the body and the
    energy's parameters depend on (direct differentiation through a run)."""
    with torch.enable_grad():
        c, q = body
        if not (create_graph and c.requires_grad):
            c = c.detach().requires_grad_(True)
        if not (create_graph and q.requires_grad):
            q = q.detach().requires_grad_(True)
        e = energy_fn(RigidBody(c, q), **kwargs)
        g_c, g_q = torch.autograd.grad(e, (c, q), create_graph=create_graph)
    if not create_graph:
        q = q.detach()
    torque = soa.quat_cotangent_to_torque_soa(soa.Quat(*q.unbind(-1)), soa.Quat(*g_q.unbind(-1)))
    return -g_c, _aos(torque)


def _mass_of(mass: RigidBody, n: int, like: torch.Tensor) -> RigidBody:
    m = torch.broadcast_to(torch.as_tensor(mass.center, dtype=like.dtype, device=like.device).reshape(-1), (n,))
    inertia = torch.broadcast_to(torch.as_tensor(mass.orientation, dtype=like.dtype, device=like.device), (n, 3))
    return RigidBody(m, inertia)


def nvt_langevin(
    energy_fn: Callable, shift_fn: Callable, dt: float, kT: float, gamma: RigidBody,  # noqa: N803
    create_graph: bool = False,
) -> tuple[Callable, Callable]:
    """(init_fn, step_fn) of rigid-body BAOAB Langevin dynamics on AoS state.

    ``energy_fn(body, **kwargs) -> scalar``; ``gamma`` a RigidBody of
    friction coefficients (center translational, orientation rotational;
    a value or one a particle). ``init_fn(generator, body, mass, **kwargs)``
    draws thermal momenta; ``step_fn(state, generator, **kwargs)`` is one
    B-A-O-A-B step with exact OU momenta, ``step_fn(state, xi=normals)``
    the same with the step's (2, N, 3) normals given (a checkpointed
    stretch replays them). ``create_graph``: forces stay on the autograd
    graph (:func:`_force_torque`)."""

    def init_fn(generator: torch.Generator, body: RigidBody, mass: RigidBody, **kwargs) -> LangevinState:
        c = body.center
        n = c.shape[0]
        m = _mass_of(mass, n, c)
        xi = torch.randn((2, n, 3), generator=generator, device=c.device, dtype=c.dtype)
        force, torque = _force_torque(energy_fn, body, create_graph, **kwargs)
        return LangevinState(
            position=body,
            momentum=xi[0] * torch.sqrt(m.center * kT)[:, None],
            angmom=xi[1] * torch.sqrt(m.orientation * kT),
            force=force,
            torque=torque,
            mass=m,
        )

    def step_fn(state: LangevinState, generator: torch.Generator | None = None, *, xi: torch.Tensor | None = None,
                **kwargs) -> LangevinState:
        m, inertia = state.mass.center[:, None], state.mass.orientation
        half = 0.5 * dt
        pos = state.position
        # B, A
        p = state.momentum + half * state.force
        ell = state.angmom + half * state.torque
        x = shift_fn(pos.center, half * p / m)
        q, ell = free_rotor(pos.orientation, ell, inertia, half)
        # O: exact Ornstein-Uhlenbeck on the momenta
        if xi is None:
            xi = torch.randn((2, *p.shape), generator=generator, device=p.device, dtype=p.dtype)
        g_t = torch.as_tensor(gamma.center, dtype=p.dtype, device=p.device).reshape(-1)[:, None]
        g_r = torch.as_tensor(gamma.orientation, dtype=p.dtype, device=p.device).reshape(-1)[:, None]
        c_t, c_r = torch.exp(-g_t * dt / m), torch.exp(-g_r * dt / inertia)
        p = c_t * p + torch.sqrt((1.0 - c_t**2) * m * kT) * xi[0]
        ell = c_r * ell + torch.sqrt((1.0 - c_r**2) * inertia * kT) * xi[1]
        # A, force refresh, B
        x = shift_fn(x, half * p / m)
        q, ell = free_rotor(q, ell, inertia, half)
        new_pos = RigidBody(x, q)
        force, torque = _force_torque(energy_fn, new_pos, create_graph, **kwargs)
        return state._replace(position=new_pos, momentum=p + half * force, angmom=ell + half * torque, force=force,
                              torque=torque)

    return init_fn, step_fn


def nve(energy_fn: Callable, shift_fn: Callable, dt: float, create_graph: bool = False) -> tuple[Callable, Callable]:
    """Velocity-Verlet rigid-body NVE (the gamma -> 0 limit): ``init_fn(
    generator, body, mass, kT=0.0)`` (thermal momenta only for kT > 0),
    ``step_fn(state)``."""

    def init_fn(generator: torch.Generator, body: RigidBody, mass: RigidBody, kT: float = 0.0,  # noqa: N803
                **kwargs) -> LangevinState:
        c = body.center
        n = c.shape[0]
        m = _mass_of(mass, n, c)
        if kT:
            xi = torch.randn((2, n, 3), generator=generator, device=c.device, dtype=c.dtype)
            momentum, angmom = xi[0] * torch.sqrt(m.center * kT)[:, None], xi[1] * torch.sqrt(m.orientation * kT)
        else:
            momentum = angmom = torch.zeros((n, 3), dtype=c.dtype, device=c.device)
        force, torque = _force_torque(energy_fn, body, create_graph, **kwargs)
        return LangevinState(body, momentum, angmom, force, torque, m)

    def step_fn(state: LangevinState, **kwargs) -> LangevinState:
        m, inertia = state.mass.center[:, None], state.mass.orientation
        p = state.momentum + 0.5 * dt * state.force
        ell = state.angmom + 0.5 * dt * state.torque
        x = shift_fn(state.position.center, dt * p / m)
        q, ell = free_rotor(state.position.orientation, ell, inertia, dt)
        new_pos = RigidBody(x, q)
        force, torque = _force_torque(energy_fn, new_pos, create_graph, **kwargs)
        return state._replace(position=new_pos, momentum=p + 0.5 * dt * force, angmom=ell + 0.5 * dt * torque,
                              force=force, torque=torque)

    return init_fn, step_fn


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
