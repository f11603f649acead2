"""The Langevin simulators of the port: the stencil tier, the block tier
and the small-system path.

Counterpart of mythos_tpu.simulators.tpu.TpuSimulator. :class:`CudaSimulator`
is its banded-stencil tier: the fused multi-step branch (``build_run_fn``,
simulators/tpu.py:253-296 and 386-450) and, with ``save_every`` <= 1, the
generic per-step branch (:451-482); :class:`BlockSimulator` its symmetric
block-table branches (simulators/tpu.py:297-331 and 451-501): under
oxDNA2 and oxDNA1 the symmetric tables of the tile kernels, (tight, wide)
or one; under oxRNA2 and the oxNA hybrid, which the kernels do not
implement, one non-symmetric table and the force by autograd of the block
sums (energy/blocks.py), as the reference's ``jax.grad`` of its XLA tile
path -- the family decides, before any launch; :class:`PairSimulator` its
pair-list branches (simulators/tpu.py:194-229, 249-252, 332-335,
367-381, 451-509): ``NoNeighborList``, ``DensePairs`` or a
``FixedCapacityNeighborList`` rebuilt every ``neighbor_update_every``
steps, AoS BAOAB (``integrators.nvt_langevin``) with the force by torch
autograd of the energy, on the card as the reference's is ``jax.grad``
under XLA -- no kernel.

A stencil run:

* binds the parameters (dependent ones re-derived) and prepares the
  stencil context in slot order;
* computes the initial force with the K2 kernel (+ the bonded gradient);
* with ``save_every`` > 1 (the chunk path), steps ``n_steps //
  neighbor_update_every`` chunks, each: the far fold-back sweep on every
  ``FAR_EVERY``-th chunk, bf16 normals from the run's ``torch.Generator``,
  one K1 call (whose row 19 carries the exact in-band checks at the
  chunk's entry positions), a state saved every ``save_every`` steps;
* with ``save_every`` <= 1 (the per-step branch), every
  ``neighbor_update_every`` steps runs the band's exact checks and far
  sweep (``StencilBand.slot_check``, as the reference's band build), then
  that many BAOAB steps of ``integrators.nvt_langevin_soa`` whose force is
  K2 plus the bonded gradient, and saves every state;
* under a probabilistic sequence (hydrogen bonding's ``pseq``), which K1
  does not take (``ops.stencil.ERR_MS_PSEQ``, as the reference's), the
  per-step branch at any ``save_every``, saving every ``save_every``-th
  state (the reference's generic branch, simulators/tpu.py:274-296 and
  484-500); the run decides this from its prepared context, before any
  launch;
* un-permutes the saved states once, at the end, and reads the overflow
  flag back once.

Where grad mode is on and a parameter (or the initial state) needs a
gradient, the same run builds the autograd graph through K1's and K2's
Functions (ops.stencil.MultistepChunk, FieldGrads) and the bonded gradient,
so that ``loss.backward()`` reaches every parameter; ``checkpoint_every``
recomputes the per-step branch's rebuild intervals in the backward.

``save_every`` and the sequence pick the branch. Neither is a fallback of
the other: a configuration the stencil kernels cannot run raises on both
(scalar mass/friction, every bond at slot offset 2, a pseq under
oxRNA2), and so does a ``save_every`` that is not a multiple of
``neighbor_update_every`` (where it is above 1), or an ``n_steps`` that
is not a multiple of the save or rebuild cadence.

A block run rebuilds its tables every ``neighbor_update_every`` steps,
with the previous tables as ``prev`` (the missed-interaction detector),
takes each step's force from K3 on each table plus the bonded gradient by
autograd (ops.tiles.fused_grads_ctx) -- or, outside the kernels' families,
from autograd of the energy bound to the table -- and saves every
``save_every``-th state (every state with ``save_every`` <= 1, under the
same rule). It is differentiable as the stencil run is:
K3 forward through ``ops.tiles.TileForces``, its plain version backward,
and ``checkpoint_every`` on both of its branches.
"""

from __future__ import annotations

import contextlib
import dataclasses as dc

import torch
from torch.utils.checkpoint import checkpoint

from mythos_tpu_torch import spaces
from mythos_tpu_torch.energy.dna1.terms import _UnbondedPairs
from mythos_tpu_torch.ops import stencil as ops_stencil
from mythos_tpu_torch.ops import tiles
from mythos_tpu_torch.rigid_body import RigidBody
from mythos_tpu_torch.simulators.base import SimulatorOutput
from mythos_tpu_torch.simulators.integrators import nvt_langevin, nvt_langevin_soa
from mythos_tpu_torch.simulators.io import SimulatorTrajectory
from mythos_tpu_torch.simulators.neighbors import (
    BlockNeighborList,
    DensePairs,
    FixedCapacityNeighborList,
    NoNeighborList,
    StencilBand,
)
from mythos_tpu_torch.soa import BodySoA, Quat, Vec3, to_soa

ERR_CHKPNT_SCN = "`checkpoint_every` must evenly divide the length of `xs`. Got {} and {}."
ERR_SAVE_EVERY = "`save_every` must evenly divide n_steps. Got {} and {}."
ERR_UPDATE_EVERY = (
    "`neighbor_update_every` must divide save_every (or n_steps when emitting every step). Got {} and {}."
)
#: the reference's refusals of a periodic box (mythos_tpu/simulators/tpu.py:49-61): the stencil kernels
#: (K1, K2) and the tile kernels (K3) compute free-space displacements, and the SoA integrator of the
#: block sums has no periodic shift
ERR_PERIODIC_SOA = (
    "use_soa=True with a periodic space requires space_soa "
    "(spaces.periodic_soa); the SoA path would otherwise silently integrate "
    "in free space."
)
ERR_PERIODIC_FUSED = (
    "the fused Pallas kernels (symmetric block table) compute free-space "
    "displacements; periodic boxes need a non-symmetric table (XLA tile path)."
)
ERR_STENCIL = (
    "StencilBand neighbors require the free-space SoA hot path (use_soa and "
    "a non-periodic space); use block_neighbor_list_for_topology otherwise"
)

#: chunks between far fold-back sweeps: fold-backs develop over thousands
#: of steps and the band's site slack covers ~4 chunks of drift; the exact
#: near-band checks run every chunk, in K1 (as the reference, tpu.py:401-407)
FAR_EVERY = 4


def _periodic(space, energy_fn) -> bool:
    """Whether ``space``'s shift or a term's displacement is periodic."""
    fns = [] if space is None else list(space)
    fns += [getattr(fn, "displacement_fn", None) for fn in getattr(energy_fn, "energy_fns", ())]
    return any(getattr(f, "is_periodic", False) for f in fns)


def _every_step(save_every: int, u: int, n_steps: int) -> bool:
    """Whether a run emits every state (``save_every`` <= 1, as the
    reference's generic branch); raises where the cadence does not divide,
    with the reference's messages (simulators/tpu.py:233-234, 468-469,
    486-487)."""
    if save_every <= 1:
        if u < 1 or n_steps % u:
            raise ValueError(ERR_UPDATE_EVERY.format(u, n_steps))
        return True
    if n_steps % save_every:
        raise ValueError(ERR_SAVE_EVERY.format(save_every, n_steps))
    if u < 1 or save_every % u:
        raise ValueError(ERR_UPDATE_EVERY.format(u, save_every))
    return False


def _tensors(opt_params) -> list:
    """The tensors of ``opt_params``, a pseq tuple's two arrays among them."""
    out = []
    for v in (opt_params or {}).values():
        out += list(v) if isinstance(v, tuple) else [v]
    return [t for t in out if isinstance(t, torch.Tensor)]


def _positions(state) -> torch.Tensor:
    """(7, n) com + quat rows of a LangevinStateSoA."""
    return torch.stack([*state.position.center, *state.position.orientation])


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
    """Rigid-body BAOAB Langevin of a composed oxDNA2, oxRNA2 or oxDNA1
    energy on the stencil (the kernels' instance of the energy's family).

    ``run(opt_params, init_state, n_steps, generator)`` returns a
    SimulatorOutput with one SimulatorTrajectory (every ``save_every``-th
    state, every state with ``save_every`` <= 1; original nucleotide order,
    ``neighbor_overflow`` metadata). The device is that of ``init_state``.

    The run is differentiable: the chunks run through
    ``ops.stencil.MultistepChunk`` and every force through ``FieldGrads``,
    and where grad mode is on and a tensor of ``opt_params`` (or the
    initial state) needs a gradient, the bonded gradient stays on the
    graph, so that ``loss(sim.run(p, body, n, gen)).backward()`` gives
    d loss / d every parameter. The forward is the same kernel call either
    way (the same trajectory, bit for bit, and the same launches); the
    backward runs the kernels' plain versions, as the reference's
    custom-JVP rules run its XLA functions
    (mythos_tpu/ops/stencil.py:1486-1488, 2399-2401). The band checks, the
    overflow flag and K1's row 19 carry no gradient.

    ``checkpoint_every`` has the reference's meaning (simulators/tpu.py:
    110-132, 224-229): iterations of the outer loop -- on the per-step
    branch, rebuild intervals of ``neighbor_update_every`` steps, or saves
    of ``save_every`` steps where it saves every ``save_every``-th state
    (a pseq) -- kept
    under one checkpoint, their inner states recomputed in the backward
    (``torch.utils.checkpoint``, each step's normals drawn before the
    checkpointed stretch so that it replays them); it must divide their
    number (ERR_CHKPNT_SCN). The chunk path
    accepts and ignores it, as the reference's fused branch (a plain
    ``lax.scan``, tpu.py:386-444): K1's Function already keeps only each
    chunk's entry state, which is what checkpointing every chunk keeps.
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
    checkpoint_every: int = 0
    #: (displacement, shift); free space (None) only: K1 and K2 compute
    #: free-space displacements, so a periodic space, or a term with a
    #: periodic displacement, raises ERR_STENCIL, as the reference's
    space: tuple | None = None

    def __post_init__(self) -> None:
        if _periodic(self.space, self.energy_fn):
            raise ValueError(ERR_STENCIL)

    def replace(self, **kw) -> "CudaSimulator":
        return dc.replace(self, **kw)

    def _context(self, opt_params, device):
        """(stencil context, OU constants). The context carries the band at
        the bound cutoffs (``prepare_stencil_context`` raises before any
        launch where a bound cutoff passes the band's reach)."""
        energy = self.energy_fn.with_params(opt_params) if opt_params else self.energy_fn
        ctx = ops_stencil.prepare_stencil_context(energy, self.band, device=device)
        ou = ops_stencil.ou_constants(
            self.dt, self.kT, [self.mass], [self.inertia], [self.gamma_t], [self.gamma_r]
        )
        return ctx, ou.vector(device)

    def _init(self, ctx, body: RigidBody, generator: torch.Generator, graph: bool = False):
        """(initial LangevinStateSoA of the slot-order body, step_fn) of BAOAB
        whose force is K2's unbonded gradient plus the bonded gradient (with
        ``graph``, the bonded gradient on the autograd graph)."""

        def grad_fn(b: BodySoA):
            rows = torch.stack([*b.center, *b.orientation])
            g = ops_stencil.FieldGrads.apply(rows, ctx.params, ctx, ctx.hbf)
            g = g + ops_stencil.bonded_grads_plain(ctx, rows, create_graph=graph)
            return Vec3(*g[:3]), Quat(*g[3:])

        init_fn, step_fn = nvt_langevin_soa(grad_fn, self.dt, self.kT, self.gamma_t, self.gamma_r)
        com = ctx.to_slots(body.center.T.to(torch.float32)).contiguous()
        quat = ctx.to_slots(body.orientation.T.to(torch.float32)).contiguous()
        return init_fn(generator, BodySoA(Vec3(*com), Quat(*quat)), self.mass, self.inertia), step_fn

    def initial_state(self, ctx, body: RigidBody, generator: torch.Generator, graph: bool = False) -> torch.Tensor:
        """(19, n) slot-order state: positions, thermal momenta, and the
        force/torque of K2's unbonded gradient plus the bonded gradient."""
        s, _ = self._init(ctx, body, generator, graph)
        return torch.stack([*_positions(s), *s.momentum, *s.angmom, *s.force, *s.torque]).contiguous()

    def run(self, opt_params, init_state: RigidBody, n_steps: int, generator: torch.Generator) -> SimulatorOutput:
        u = self.neighbor_update_every
        every_step = _every_step(self.save_every, u, n_steps)
        device = init_state.center.device
        graph = torch.is_grad_enabled() and any(t.requires_grad for t in (*_tensors(opt_params), init_state.center,
                                                                          init_state.orientation))
        ctx, ou = self._context(opt_params, device)
        per_save = 1 if every_step else self.save_every // u  # rebuild intervals a save (per-step branch)
        n_outer, ck = n_steps // u // per_save, self.checkpoint_every
        if (every_step or ctx.pseq) and ck > 0 and n_outer % ck:
            raise ValueError(ERR_CHKPNT_SCN.format(ck, n_outer))
        overflow = torch.as_tensor(self.band.did_overflow, device=device).clone()
        if every_step or ctx.pseq:
            if graph and self.checkpoint_every > 0:
                ctx = dc.replace(ctx, checkpointed=True)
            s, step_fn = self._init(ctx, init_state, generator, graph)
            s, saves, overflow = self._every_step_run(ctx, s, step_fn, n_steps, generator, overflow, graph,
                                                      per_save, every_step)
            state = torch.stack([*_positions(s), *s.momentum, *s.angmom, *s.force, *s.torque])
        else:
            state = self.initial_state(ctx, init_state, generator, graph)
            per_save = self.save_every // u
            saves = []
            for chunk in range(n_steps // u):
                if chunk % FAR_EVERY == 0:
                    with torch.no_grad():
                        overflow |= ctx.band.far_check(Vec3(*state[0:3]), Quat(*state[3:7]))
                noise = torch.randn((u, 6, ctx.n), generator=generator, device=device).to(torch.bfloat16)
                out = ops_stencil.MultistepChunk.apply(state, ctx.params, ctx.wstack, ou, noise, ctx)
                with torch.no_grad():
                    overflow |= out[19].max() > 0
                state = out[:19]
                if (chunk + 1) % per_save == 0:
                    saves.append(state[:7].clone())
        trajectory = _trajectory(ctx.from_slots(torch.stack(saves)), self.kT, overflow)
        return SimulatorOutput(observables=[trajectory], state={"final_state": state})

    def _every_step_run(self, ctx, s, step_fn, n_steps, generator, overflow, graph, per_save=1,
                        every_step=True):
        """The per-step branch from state ``s``: (the last state, the saved
        positions -- of every step, or with ``every_step`` False of the last
        step of each ``per_save`` rebuild intervals --, the overflow flag).
        Each group of ``checkpoint_every`` outer iterations (one without it;
        an iteration is ``per_save`` rebuild intervals) draws its steps'
        normals first, then runs its intervals: each the band's exact checks
        and far sweep (``StencilBand.slot_check``), then
        ``neighbor_update_every`` steps. With ``graph`` and
        ``checkpoint_every`` > 0 a group runs under ``torch.utils.checkpoint``:
        its inner states are recomputed (K2 launched again) in the backward."""
        u = self.neighbor_update_every
        group = (self.checkpoint_every if self.checkpoint_every > 0 else 1) * per_save
        n = ctx.n
        device = s.position.center.x.device

        def intervals(s, xis):
            ovf, pos = torch.zeros((), dtype=torch.bool, device=device), []
            for k in range(group):
                with torch.no_grad():
                    ovf = ovf | ctx.band.slot_check(s.position.center, s.position.orientation)
                for xi in xis[k * u : (k + 1) * u]:
                    s = step_fn(s, xi=xi)
                    if every_step:
                        pos.append(_positions(s))
                if not every_step and (k + 1) % per_save == 0:
                    pos.append(_positions(s))
            return s, ovf, pos

        saves = []
        for _ in range(n_steps // u // group):
            xis = [torch.randn((6, n), generator=generator, device=device) for _ in range(group * u)]
            if graph and self.checkpoint_every > 0:
                s, ovf, pos = checkpoint(intervals, s, xis, use_reentrant=False, preserve_rng_state=False)
            else:
                s, ovf, pos = intervals(s, xis)
            overflow |= ovf
            saves += pos
        return s, saves, overflow


@dc.dataclass(frozen=True)
class BlockSimulator:
    """Rigid-body BAOAB Langevin of a composed energy on block tables (the
    block tier: general conformations). Under oxDNA2 and oxDNA1, symmetric
    tables, a (tight, wide) pair or one, and K3's instance of the family on
    each; under any other family (oxRNA2, the oxNA hybrid) one
    non-symmetric table and the force by autograd of the energy bound to it
    (``with_props(block_ids=...)``: the plain block sums, the reference's
    XLA tile path; :meth:`uses_kernels`).

    ``run(opt_params, init_state, n_steps, generator)`` returns a
    SimulatorOutput with one SimulatorTrajectory (every ``save_every``-th
    state, every state with ``save_every`` <= 1; original order,
    ``neighbor_overflow`` metadata). The device is that of ``init_state``;
    the tables live where ``neighbors`` was built.

    The run is differentiable: where grad mode is on and a tensor of
    ``opt_params`` (or the initial state) needs a gradient, the tile
    contexts are prepared on the graph and every force goes through
    ``ops.tiles.TileForces`` (K3 forward, its plain version with
    ``create_graph`` backward) and the bonded gradient with
    ``create_graph`` (``fused_grads_ctx(create_graph=True)``), so that
    ``loss(sim.run(p, body, n, gen)).backward()`` gives d loss / d every
    parameter. The forward is the same K3 call either way (the same
    trajectory, bit for bit, and the same launches); the table builds and
    the overflow flag carry no gradient.

    ``checkpoint_every`` has the reference's meaning (simulators/tpu.py:
    110-132, 224-229, 466-499): iterations of the outer loop kept under one
    checkpoint, their inner states recomputed (K3 launched again) in the
    backward -- on the every-step branch rebuild intervals of
    ``neighbor_update_every`` steps, of which there are ``n_steps //
    neighbor_update_every``; otherwise saves of ``save_every`` steps, of
    which there are ``n_steps // save_every``. It must divide that number
    (ERR_CHKPNT_SCN). Each group of ``checkpoint_every`` outer iterations
    (one without it) draws its steps' normals first, so that a recompute
    replays them and not the generator.
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
    checkpoint_every: int = 0
    #: (displacement, shift); free space (None) only: a periodic space (or
    #: a term with a periodic displacement) raises ERR_PERIODIC_FUSED on a
    #: symmetric table (K3), ERR_PERIODIC_SOA on the block sums' table (the
    #: SoA integrator has no periodic shift), as the reference's
    space: tuple | None = None

    def __post_init__(self) -> None:
        if _periodic(self.space, self.energy_fn):
            raise ValueError(ERR_PERIODIC_FUSED if self.neighbors.symmetric else ERR_PERIODIC_SOA)

    def replace(self, **kw) -> "BlockSimulator":
        return dc.replace(self, **kw)

    def uses_kernels(self) -> bool:
        """Whether the run takes K3 (oxDNA2, oxDNA1) or the plain block sums
        (oxRNA2, the oxNA hybrid): decided from the modules of the energy's
        term classes (``tiles.kernel_family``, which raises for an oxDNA term
        set that K3 does not implement)."""
        return tiles.kernel_family(self.energy_fn) is not None

    def _grad_fn(self, energy, graph: bool, checkpointed: bool):
        """grad_fn(body, tables) of the integrator: K3 on the prepared
        contexts, or autograd of the energy's block sums on the table."""
        nbl = self.neighbors
        if self.uses_kernels():
            if not nbl.symmetric:
                raise ValueError("the tile kernels take symmetric block tables")
            with contextlib.nullcontext() if graph else torch.no_grad():
                ctxs = tiles.prepare_contexts(energy, nbl.idx, nbl.block_size, perm=nbl.perm)

            def grad_fn(body: BodySoA, tables):
                return tiles.fused_grads_ctx(energy, ctxs, body, tables, create_graph=graph,
                                             checkpointed=checkpointed)

            return grad_fn
        if nbl.symmetric:
            raise ValueError("the block sums take a non-symmetric table (each pair once): "
                             "block_neighbor_list_for_topology(..., symmetric=False)")

        def grad_fn(body: BodySoA, tables):
            comps = (*body.center, *body.orientation)
            leaves = [c if graph and c.requires_grad else c.detach().requires_grad_(True) for c in comps]
            bound = energy.with_props(block_ids=tables, block_size=nbl.block_size, block_perm=nbl.perm)
            with torch.enable_grad(), tiles._keep_saves(checkpointed):
                e = bound(RigidBody(torch.stack(leaves[:3], -1), torch.stack(leaves[3:], -1)))
                g = torch.autograd.grad(e, leaves, create_graph=graph)
            return Vec3(*g[:3]), Quat(*g[3:])

        return grad_fn

    def run(self, opt_params, init_state: RigidBody, n_steps: int, generator: torch.Generator) -> SimulatorOutput:
        u = self.neighbor_update_every
        every_step = _every_step(self.save_every, u, n_steps)
        per_save = 1 if every_step else self.save_every // u  # rebuild intervals an outer iteration
        n_outer = n_steps // u // per_save
        ck = self.checkpoint_every
        if ck > 0 and n_outer % ck:
            raise ValueError(ERR_CHKPNT_SCN.format(ck, n_outer))
        nbl = self.neighbors
        graph = torch.is_grad_enabled() and any(t.requires_grad for t in (*_tensors(opt_params), init_state.center,
                                                                          init_state.orientation))
        with contextlib.nullcontext() if graph else torch.no_grad():
            energy = self.energy_fn.with_params(opt_params) if opt_params else self.energy_fn
        checkpointed = graph and ck > 0
        grad_fn = self._grad_fn(energy, graph, checkpointed)
        init_fn, step_fn = nvt_langevin_soa(grad_fn, self.dt, self.kT, self.gamma_t, self.gamma_r)
        body = to_soa(RigidBody(init_state.center.to(torch.float32), init_state.orientation.to(torch.float32)))
        state = init_fn(generator, body, self.mass, self.inertia, tables=nbl.idx)
        n, device = body.center.x.shape[0], body.center.x.device
        group = ck if ck > 0 else 1

        def outer(state, prev, xis):
            """``group`` outer iterations from ``state``: each ``per_save``
            rebuilds, each followed by ``u`` steps taking their normals from
            ``xis``; (state, last tables, overflow, saved positions)."""
            ovf, pos, k = torch.zeros((), dtype=torch.bool, device=device), [], 0
            for _ in range(group):
                for _ in range(per_save):
                    with torch.no_grad():
                        ids, o = nbl.build(state.position.center, prev=prev)
                    ovf = ovf | o
                    for _ in range(u):
                        state = step_fn(state, xi=xis[k], tables=ids)
                        k += 1
                        if every_step:
                            pos.append(_positions(state))
                    prev = ids
                if not every_step:
                    pos.append(_positions(state))
            return state, prev, ovf, pos

        overflow = nbl.did_overflow.clone()
        prev, saves = nbl.idx, []
        for _ in range(n_outer // group):
            xis = [torch.randn((6, n), generator=generator, device=device) for _ in range(group * per_save * u)]
            if checkpointed:
                state, prev, ovf, pos = checkpoint(outer, state, prev, xis, use_reentrant=False,
                                                   preserve_rng_state=False)
            else:
                state, prev, ovf, pos = outer(state, prev, xis)
            overflow |= ovf
            saves += pos
        trajectory = _trajectory(torch.stack(saves), self.kT, overflow)
        return SimulatorOutput(observables=[trajectory], state={"final_state": state})


@dc.dataclass(frozen=True)
class PairSimulator:
    """Rigid-body BAOAB Langevin of a composed energy over pair lists: the
    small-system path (the reference's ``NoNeighborList``/``DensePairs``
    branch of TpuSimulator, the one ``__graft_entry__.entry()`` and
    ``examples/dna1_simulation.py`` run, and its generic branch over a
    ``FixedCapacityNeighborList``). Any model; no kernel: the force is
    torch autograd of the energy, which runs where the state lives.

    ``neighbors``: a ``NoNeighborList`` (the energy's unbonded terms take
    its pair list), ``DensePairs`` (the energy must carry its dense mask:
    ``create_default_energy_fn(dense_unbonded=True)``) or a
    ``FixedCapacityNeighborList`` (allocated; rebuilt every
    ``neighbor_update_every`` steps against the previous list, the
    terms taking its padded (2, capacity) pairs). ``run(opt_params,
    init_state, n_steps, generator)`` returns a SimulatorOutput with one
    SimulatorTrajectory: every ``save_every``-th state (every state with
    ``save_every`` <= 1, the reference's default), in the original order;
    a rebuilt list's trajectory carries ``neighbor_overflow`` metadata
    (the flags of every rebuild ORed), a static list's none, as the
    reference's. The run is differentiable in ``opt_params`` and the
    initial state (the forces with ``create_graph``; the list carries no
    gradient); ``checkpoint_every`` keeps that many outer iterations (steps
    or rebuild intervals, or saves of ``save_every`` steps) under one
    ``torch.utils.checkpoint``, their normals drawn first, and must divide
    their number (ERR_CHKPNT_SCN).
    """

    energy_fn: object
    neighbors: NoNeighborList | DensePairs | FixedCapacityNeighborList
    dt: float
    kT: float  # noqa: N815 - domain casing
    mass: float = 1.0
    inertia: tuple = (1.0, 1.0, 1.0)
    gamma_t: float = 0.0
    gamma_r: float = 0.0
    save_every: int = 1
    checkpoint_every: int = 0
    neighbor_update_every: int = 1
    #: (displacement, shift), the reference's ``space``: free space when
    #: None; ``spaces.periodic(box)`` wraps each step's positions into the
    #: box (the energy's terms take its displacement: create_default_energy_fn(
    #: displacement_fn=...); a FixedCapacityNeighborList its distances)
    space: tuple | None = None

    def replace(self, **kw) -> "PairSimulator":
        return dc.replace(self, **kw)

    def _energy(self, opt_params):
        """The energy with ``opt_params`` bound and the static neighbours'
        pairs: the static list, or the dense mask the energy must carry."""
        energy = self.energy_fn.with_params(opt_params) if opt_params else self.energy_fn
        if isinstance(self.neighbors, NoNeighborList):
            return energy.with_props(unbonded_neighbors=self.neighbors.unbonded_nbrs)
        if isinstance(self.neighbors, DensePairs) and any(
            fn.dense_mask is None for fn in energy.energy_fns if isinstance(fn, _UnbondedPairs)
        ):
            raise ValueError("DensePairs needs an energy with its dense mask (create_default_energy_fn("
                             "dense_unbonded=True))")
        return energy

    def run(self, opt_params, init_state: RigidBody, n_steps: int, generator: torch.Generator) -> SimulatorOutput:
        nbl = self.neighbors if isinstance(self.neighbors, FixedCapacityNeighborList) else None
        u = self.neighbor_update_every if nbl is not None else 1
        every_step = _every_step(self.save_every, u, n_steps)
        per_save = 1 if every_step else self.save_every // u  # intervals of u steps an outer iteration
        n_outer = n_steps // u // per_save
        ck = self.checkpoint_every
        if ck > 0 and n_outer % ck:
            raise ValueError(ERR_CHKPNT_SCN.format(ck, n_outer))
        graph = torch.is_grad_enabled() and any(t.requires_grad for t in (*_tensors(opt_params), init_state.center,
                                                                          init_state.orientation))
        gamma = RigidBody(torch.tensor([self.gamma_t], dtype=torch.float64),
                          torch.tensor([self.gamma_r], dtype=torch.float64))
        energy = self._energy(opt_params)

        def bound(pairs):
            return energy if nbl is None else energy.with_props(unbonded_neighbors=pairs)

        shift = (self.space or spaces.free())[1]
        init_fn, step_fn = nvt_langevin(lambda body, energy: energy(body), shift, self.dt, self.kT, gamma,
                                        create_graph=graph)
        mass = RigidBody(torch.tensor([self.mass], dtype=torch.float64), torch.tensor([self.inertia], dtype=torch.float64))
        prev = None if nbl is None else nbl.idx
        state = init_fn(generator, init_state, mass, energy=bound(prev))
        c = init_state.center
        group = ck if ck > 0 else 1

        def outer(state, prev, xis):
            """``group`` outer iterations: each ``per_save`` intervals of a
            rebuild (a rebuilt list's) and ``u`` steps; (state, last list,
            overflow, saved states)."""
            ovf, pos, k = torch.zeros((), dtype=torch.bool, device=c.device), [], 0
            for _ in range(group):
                for _ in range(per_save):
                    if nbl is not None:
                        prev, o = nbl.build(state.position.center, prev=prev)
                        ovf = ovf | o
                    e_k = bound(prev)
                    for _ in range(u):
                        state = step_fn(state, xi=xis[k], energy=e_k)
                        k += 1
                        if every_step:
                            pos.append(torch.cat([state.position.center, state.position.orientation], dim=-1))
                if not every_step:
                    pos.append(torch.cat([state.position.center, state.position.orientation], dim=-1))
            return state, prev, ovf, pos

        overflow = torch.zeros((), dtype=torch.bool, device=c.device) if nbl is None else nbl.did_overflow.clone()
        saves = []
        for _ in range(n_outer // group):
            xis = [torch.randn((2, *c.shape), generator=generator, device=c.device, dtype=c.dtype)
                   for _ in range(group * per_save * u)]
            if graph and ck > 0:
                state, prev, ovf, pos = checkpoint(outer, state, prev, xis, use_reentrant=False,
                                                   preserve_rng_state=False)
            else:
                state, prev, ovf, pos = outer(state, prev, xis)
            overflow |= ovf
            saves += pos
        traj = torch.stack(saves)
        trajectory = SimulatorTrajectory(
            center=traj[..., :3], orientation=traj[..., 3:],
            temperature=torch.full((traj.shape[0],), float(self.kT), dtype=traj.dtype, device=traj.device),
        )
        if nbl is not None:
            trajectory = trajectory.with_state_metadata(neighbor_overflow=bool(overflow.item()))
        return SimulatorOutput(observables=[trajectory], state={"final_state": state})
