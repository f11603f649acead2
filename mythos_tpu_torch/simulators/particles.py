"""Point-particle Langevin dynamics + box coupling (the MARTINI MD core).

Counterpart of mythos_tpu/simulators/particles.py: a BAOAB Langevin
integrator over (N, 3) positions with the exact Ornstein-Uhlenbeck O-step,
and a semi-isotropic Berendsen barostat whose virial is one reverse-mode
strain derivative of the energy. Forces come from autograd of the total
energy at a fixed box; on the card the LJ term's backward is K6
(ops/lj.py), whose box gradient carries the virial's image term.

Where grad mode is on and the state is on the autograd graph (a parameter
upstream needs a gradient), the force and the virial are taken with
``create_graph``: positions, box and momenta stay on the graph, so a loss
on the trajectory reaches the parameters through every force and every
barostat step (through mu; the clip to [0.98, 1.02] passes no gradient
outside its range, as the reference's ``jnp.clip``). Otherwise both are
taken on detached leaves, as without gradients.

Noise is an input: ``step_fn`` takes the step's standard normals, which
the caller draws from its ``torch.Generator`` (or replays from elsewhere).
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch


class ParticleLangevinState(NamedTuple):
    """Integrator state over (N, 3) tensors; ``box`` rides along for NPT.
    ``ou`` holds the O-step's (decay, noise scale), fixed by the masses."""

    position: torch.Tensor  # (N, 3)
    momentum: torch.Tensor  # (N, 3)
    force: torch.Tensor  # (N, 3)
    box: torch.Tensor  # (3,)
    inv_mass: torch.Tensor  # scalar or (N, 1)
    ou: tuple


def _on_graph(*tensors) -> bool:
    """Whether grad mode is on and one of ``tensors`` needs a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _force(energy_fn: Callable, position: torch.Tensor, box: torch.Tensor, graph: bool = False) -> torch.Tensor:
    """-dU/dposition at a fixed box; with ``graph`` on the autograd graph of
    the position, the box and whatever the energy's parameters depend on."""
    with torch.enable_grad():
        x = position if graph and position.requires_grad else position.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(energy_fn(x, box if graph else box.detach()), x, create_graph=graph)
    return -g


def nvt_langevin_particles(
    energy_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    shift_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dt: float,
    kT: float,  # noqa: N803 - domain casing
    gamma: float,
) -> tuple[Callable, Callable]:
    """BAOAB Langevin for point particles: ``(init_fn, step_fn)``.

    ``energy_fn(position, box) -> scalar``; ``shift_fn(x, dx)`` applies
    displacements. ``init_fn(position, box, mass, momentum, graph=False)``
    computes the first force (``momentum``: (N, 3), e.g. thermal normals
    times sqrt(m kT)); ``step_fn(state, normals, graph=False)`` is B, A, O
    (exact OU), A, force refresh, B. With ``graph`` the forces stay on the
    autograd graph (direct differentiation through the run).
    """

    def init_fn(position: torch.Tensor, box: torch.Tensor, mass, momentum: torch.Tensor,
                graph: bool = False) -> ParticleLangevinState:
        m = torch.as_tensor(mass, dtype=position.dtype, device=position.device).reshape(-1)
        m = m[0] if m.shape[0] == 1 else m[:, None]
        inv_m = 1.0 / m
        c = torch.exp(-gamma * dt * inv_m)
        s = torch.sqrt((1.0 - c * c) * kT / inv_m)
        return ParticleLangevinState(
            position=position, momentum=momentum, force=_force(energy_fn, position, box, graph), box=box,
            inv_mass=inv_m,
            ou=(c, s),
        )

    def step_fn(state: ParticleLangevinState, normals: torch.Tensor, graph: bool = False) -> ParticleLangevinState:
        half = 0.5 * dt
        inv_m = state.inv_mass
        c, s = state.ou
        p = state.momentum + half * state.force  # B
        x = shift_fn(state.position, (half * inv_m) * p)  # A
        p = c * p + s * normals  # O (exact OU)
        x = shift_fn(x, (half * inv_m) * p)  # A
        f = _force(energy_fn, x, state.box, graph)
        p = p + half * f  # B
        return state._replace(position=x, momentum=p, force=f)

    return init_fn, step_fn


def thermal_momentum(position: torch.Tensor, mass, kT: float, generator: torch.Generator) -> torch.Tensor:  # noqa: N803
    """(N, 3) momenta drawn from the Maxwell distribution at kT."""
    m = torch.as_tensor(mass, dtype=position.dtype, device=position.device).reshape(-1)
    m = m[0] if m.shape[0] == 1 else m[:, None]
    normals = torch.randn(position.shape, generator=generator, dtype=position.dtype, device=position.device)
    return normals * torch.sqrt(m * kT)


def pressure_diag(
    energy_fn: Callable, position: torch.Tensor, momentum: torch.Tensor, inv_mass, box: torch.Tensor,
    graph: bool = False,
) -> torch.Tensor:
    """(3,) diagonal pressure: P_i V = sum(p_i^2 / m) - dU/d eps_i.

    The virial is the strain derivative of the energy under an affine
    per-axis scaling of positions AND box, by one autograd pass: exact for
    every term that respects the minimum image (the LJ term's image part
    comes from K6's box gradient). With ``graph`` it stays on the autograd
    graph of the positions, the box and the parameters (the double backward
    of K6's position and box gradients); the momenta always are.
    """
    with torch.enable_grad():
        eps = torch.zeros(3, dtype=position.dtype, device=position.device, requires_grad=True)
        scale = 1.0 + eps
        x, b = (position, box) if graph else (position.detach(), box.detach())
        (du,) = torch.autograd.grad(energy_fn(x * scale, b * scale), eps, create_graph=graph)
    twice_kinetic = (momentum * momentum * inv_mass).sum(0)
    return (twice_kinetic - du) / torch.prod(box)


def berendsen_semi_isotropic(
    energy_fn: Callable,
    state: ParticleLangevinState,
    *,
    pressure0: float,
    tau: float,
    dt: float,
    compressibility: float = 3e-4,
) -> ParticleLangevinState:
    """One semi-isotropic Berendsen box update (xy coupled, z free).

    mu_i = (1 - dt/tau * kappa * (P0 - P_i))^(1/3), clipped to [0.98, 1.02]
    against catastrophic early-step virials; positions scale affinely with
    the box (momenta and the stored force are kept, as in the reference).
    The virial is on the autograd graph where grad mode is on and the
    state is (a gradient then reaches mu, zero where the clip binds).
    """
    graph = _on_graph(state.position, state.momentum, state.box)
    p_diag = pressure_diag(energy_fn, state.position, state.momentum, state.inv_mass, state.box, graph)
    p_xy = 0.5 * (p_diag[0] + p_diag[1])
    p_eff = torch.stack([p_xy, p_xy, p_diag[2]])
    mu = (1.0 - (dt / tau) * compressibility * (pressure0 - p_eff)) ** (1.0 / 3.0)
    mu = torch.clamp(mu, 0.98, 1.02)
    return state._replace(position=state.position * mu, box=state.box * mu)


def kinetic_kT(state: ParticleLangevinState) -> torch.Tensor:  # noqa: N802
    """Instantaneous kT from the momenta: sum(p^2 / m) / (3 N)."""
    return (state.momentum**2 * state.inv_mass).sum() / (3.0 * state.position.shape[0])


__all__ = [
    "ParticleLangevinState",
    "berendsen_semi_isotropic",
    "kinetic_kT",
    "nvt_langevin_particles",
    "pressure_diag",
    "thermal_momentum",
]

