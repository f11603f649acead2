"""The Langevin simulators of the port: the stencil tier and the block tier.

Counterpart of mythos_tpu.simulators.tpu.TpuSimulator. :class:`CudaSimulator`
is its banded-stencil fused multi-step branch (``build_run_fn``,
simulators/tpu.py:253-296 and 386-450); :class:`BlockSimulator` its
symmetric block-table branch (simulators/tpu.py:297-322 and 451-501).

A stencil run:

* binds the parameters (dependent ones re-derived) and prepares the
  stencil context in slot order;
* computes the initial force with the K2 kernel (+ the bonded gradient);
* steps ``n_steps // neighbor_update_every`` chunks, each: the far
  fold-back sweep on every ``FAR_EVERY``-th chunk, bf16 normals from the
  run's ``torch.Generator``, one K1 call (whose row 19 carries the exact
  in-band checks at the chunk's entry positions);
* un-permutes the saved states once, at the end, and reads the overflow
  flag back once.

There is no per-step fallback: a configuration the chunk kernel cannot run
raises (scalar mass/friction, every bond at slot offset 2, discrete
sequence, ``save_every`` a multiple of ``neighbor_update_every``).

A block run rebuilds its (tight, wide) tables every
``neighbor_update_every`` steps, with the previous tables as ``prev`` (the
missed-interaction detector), and takes each step's force from K3 on each
table plus the bonded gradient by autograd (ops.tiles.fused_grads_ctx).
"""

from __future__ import annotations

import dataclasses as dc

import torch

from mythos_tpu_torch.ops import stencil as ops_stencil
from mythos_tpu_torch.ops import tiles
from mythos_tpu_torch.rigid_body import RigidBody
from mythos_tpu_torch.simulators.base import SimulatorOutput
from mythos_tpu_torch.simulators.integrators import nvt_langevin_soa
from mythos_tpu_torch.simulators.io import SimulatorTrajectory
from mythos_tpu_torch.simulators.neighbors import BlockNeighborList, StencilBand
from mythos_tpu_torch.soa import BodySoA, Quat, Vec3, to_soa

ERR_SAVE_EVERY = "`save_every` must evenly divide n_steps. Got {} and {}."
ERR_UPDATE_EVERY = "`neighbor_update_every` must divide save_every. Got {} and {}."

#: chunks between far fold-back sweeps: fold-backs develop over thousands
#: of steps and the band's site slack covers ~4 chunks of drift; the exact
#: near-band checks run every chunk, in K1 (as the reference, tpu.py:401-407)
FAR_EVERY = 4


def _trajectory(traj: torch.Tensor, kT: float, overflow: torch.Tensor) -> SimulatorTrajectory:  # noqa: N803
    """The SimulatorTrajectory of (S, 7, N) saved states in the original
    order, with the run's overflow flag (read back once)."""
    return SimulatorTrajectory(
        center=traj[:, 0:3].transpose(1, 2).contiguous(),
        orientation=traj[:, 3:7].transpose(1, 2).contiguous(),
        temperature=torch.full((traj.shape[0],), float(kT), device=traj.device),
    ).with_state_metadata(neighbor_overflow=bool(overflow.item()))


@dc.dataclass(frozen=True)
class CudaSimulator:
    """Rigid-body BAOAB Langevin of a composed oxDNA2 or oxRNA2 energy on the
    stencil (the kernels' instance of the energy's family).

    ``run(opt_params, init_state, n_steps, generator)`` returns a
    SimulatorOutput with one SimulatorTrajectory (every ``save_every``-th
    state, original nucleotide order, ``neighbor_overflow`` metadata). The
    device is that of ``init_state``.
    """

    energy_fn: object
    band: StencilBand
    dt: float
    kT: float  # noqa: N815 - domain casing
    mass: float = 1.0
    inertia: tuple = (1.0, 1.0, 1.0)
    gamma_t: float = 0.0
    gamma_r: float = 0.0
    save_every: int = 40
    neighbor_update_every: int = 40

    def replace(self, **kw) -> "CudaSimulator":
        return dc.replace(self, **kw)

    def _context(self, opt_params, device):
        energy = self.energy_fn.with_params(opt_params) if opt_params else self.energy_fn
        ctx = ops_stencil.prepare_stencil_context(energy, self.band, device=device)
        ou = ops_stencil.ou_constants(
            self.dt, self.kT, [self.mass], [self.inertia], [self.gamma_t], [self.gamma_r]
        )
        return ctx, ou.vector(device)

    def initial_state(self, ctx, body: RigidBody, generator: torch.Generator) -> torch.Tensor:
        """(19, n) slot-order state: positions, thermal momenta, and the
        force/torque of K2's unbonded gradient plus the bonded gradient."""
        com = ctx.to_slots(body.center.T.to(torch.float32)).contiguous()
        quat = ctx.to_slots(body.orientation.T.to(torch.float32)).contiguous()
        dyn = torch.cat([com, quat]).contiguous()

        def grad_fn(b: BodySoA):
            rows = torch.stack([*b.center, *b.orientation])
            g = ops_stencil.field_grads(ctx, rows) + ops_stencil.bonded_grads_plain(ctx, rows)
            return Vec3(*g[:3]), Quat(*g[3:])

        init_fn, _ = nvt_langevin_soa(grad_fn, self.dt, self.kT, self.gamma_t, self.gamma_r)
        s = init_fn(generator, BodySoA(Vec3(*dyn[:3]), Quat(*dyn[3:])), self.mass, self.inertia)
        return torch.stack([*dyn, *s.momentum, *s.angmom, *s.force, *s.torque]).contiguous()

    def run(self, opt_params, init_state: RigidBody, n_steps: int, generator: torch.Generator) -> SimulatorOutput:
        u = self.neighbor_update_every
        if n_steps % self.save_every:
            raise ValueError(ERR_SAVE_EVERY.format(self.save_every, n_steps))
        if u < 1 or self.save_every % u:
            raise ValueError(ERR_UPDATE_EVERY.format(u, self.save_every))
        device = init_state.center.device
        ctx, ou = self._context(opt_params, device)
        n = ctx.n
        state = self.initial_state(ctx, init_state, generator)
        overflow = torch.as_tensor(self.band.did_overflow, device=device).clone()
        saves = []
        per_save = self.save_every // u
        for chunk in range(n_steps // u):
            if chunk % FAR_EVERY == 0:
                overflow |= self.band.far_check(Vec3(*state[0:3]), Quat(*state[3:7]))
            noise = torch.randn((u, 6, n), generator=generator, device=device).to(torch.bfloat16)
            out = ops_stencil.multistep_chunk(ctx, ou, noise, state)
            overflow |= out[19].max() > 0
            state = out[:19]
            if (chunk + 1) % per_save == 0:
                saves.append(state[:7].clone())
        trajectory = _trajectory(ctx.from_slots(torch.stack(saves)), self.kT, overflow)
        return SimulatorOutput(observables=[trajectory], state={"final_state": state})


@dc.dataclass(frozen=True)
class BlockSimulator:
    """Rigid-body BAOAB Langevin of a composed oxDNA2 energy on symmetric
    block tables (the block tier: general conformations).

    ``run(opt_params, init_state, n_steps, generator)`` returns a
    SimulatorOutput with one SimulatorTrajectory (every ``save_every``-th
    state, original order, ``neighbor_overflow`` metadata). The device is
    that of ``init_state``; the tables live where ``neighbors`` was built.
    """

    energy_fn: object
    neighbors: BlockNeighborList
    dt: float
    kT: float  # noqa: N815 - domain casing
    mass: float = 1.0
    inertia: tuple = (1.0, 1.0, 1.0)
    gamma_t: float = 0.0
    gamma_r: float = 0.0
    save_every: int = 40
    neighbor_update_every: int = 40

    def replace(self, **kw) -> "BlockSimulator":
        return dc.replace(self, **kw)

    def run(self, opt_params, init_state: RigidBody, n_steps: int, generator: torch.Generator) -> SimulatorOutput:
        u = self.neighbor_update_every
        if n_steps % self.save_every:
            raise ValueError(ERR_SAVE_EVERY.format(self.save_every, n_steps))
        if u < 1 or self.save_every % u:
            raise ValueError(ERR_UPDATE_EVERY.format(u, self.save_every))
        nbl = self.neighbors
        with torch.no_grad():
            energy = self.energy_fn.with_params(opt_params) if opt_params else self.energy_fn
            ctxs = tiles.prepare_contexts(energy, nbl.idx, nbl.block_size, perm=nbl.perm)

        def grad_fn(body: BodySoA, tables):
            return tiles.fused_grads_ctx(energy, ctxs, body, tables)

        init_fn, step_fn = nvt_langevin_soa(grad_fn, self.dt, self.kT, self.gamma_t, self.gamma_r)
        body = to_soa(RigidBody(init_state.center.to(torch.float32), init_state.orientation.to(torch.float32)))
        state = init_fn(generator, body, self.mass, self.inertia, tables=nbl.idx)
        overflow = nbl.did_overflow.clone()
        prev = nbl.idx
        saves = []
        per_save = self.save_every // u
        for chunk in range(n_steps // u):
            ids, ovf = nbl.build(state.position.center, prev=prev)
            overflow |= ovf
            for _ in range(u):
                state = step_fn(state, generator, tables=ids)
            prev = ids
            if (chunk + 1) % per_save == 0:
                saves.append(torch.stack([*state.position.center, *state.position.orientation]))
        trajectory = _trajectory(torch.stack(saves), self.kT, overflow)
        return SimulatorOutput(observables=[trajectory], state={"final_state": state})
