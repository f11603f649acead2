"""User entry points: build the simulator of a ported tier, and the 8-bp
oxDNA1 step of the reference's ``entry()``.

Counterpart of ``__graft_entry__._build_sim`` and ``__graft_entry__.entry``
for every (mode, model) the reference accepts -- models ``dna1``, ``dna2``
and ``rna2`` -- rigid-body BAOAB with dt 5e-3, mass 1, inertia 1 and
friction gamma = (kT/2.5, kT/7.5):

* ``mode="stencil"`` -- the configuration ``bench.py`` runs by default (the
  default here too: stencil dna2): the banded stencil over the
  strand-interleave slot order, a site-mode band sized from the initial
  conformation (kernels K1, K2, each model's instance). Under rna2 the
  band takes the A-form slacks and far slack, and ``site_margin`` 2; dna1
  and dna2 the B-DNA slacks and ``site_margin`` 1, and dna1's band is as
  wide as its widest short-range term (no Debye-Hueckel);
* ``mode="block"`` -- the block tier for general conformations: a
  block-neighbor table over the same slot order, rebuilt every
  ``neighbor_update_every`` steps: under dna2 and dna1 symmetric tables
  and kernel K3 -- a two-level (tight, wide) pair under dna2, one table
  under dna1 (no Debye term) --; under rna2, which the reference's fused
  tiles refuse, one non-symmetric table and the plain block sums
  (energy/blocks.py), the force by autograd, as the reference's XLA tile
  path (``create_default_energy_fn(block_unbonded=True)``);
* ``mode="pairs"`` / ``mode="dense"`` -- the small-system path
  (simulators.cuda.PairSimulator): the static pair list of every unbonded
  pair (``NoNeighborList``), or the dense (N, N) masks (``DensePairs``),
  AoS BAOAB with the force by autograd; no kernel. These save every state
  (the reference's default) and take ``dtype`` float64 too.

The stencil and block simulators save a state every ``save_every`` (40)
steps; callers that want every state take ``sim.replace(save_every=1)``,
and the stencil then steps one step at a time (K2 plus the bonded gradient
each step) instead of in K1's chunks, as the reference's per-step branch
does. Every run is differentiable in its parameters (the stencil: K1 and
K2 forward, their plain versions backward; the block tier: K3 forward
through ``ops.tiles.TileForces``; the small-system path: autograd);
``checkpoint_every`` trades a differentiated run's graph for recompute (at
1,000 nt on an H100 80GB HBM3 at 700 W, the graph a 40-step per-step
stencil forward holds falls from 79.7 to 26.4 MiB with a checkpoint every
10-step interval, while the evaluation's peak, set by the backward's
working set at that length, stays ~104-109 MiB above its start:
``chip_smoke.py`` phase 12c; the block tier's: phase 13c). The DiffTRe fit runs on any of these
simulators through ``simulators.base.BoundSimulator``,
``optimization.DiffTReObjective`` and ``SimpleOptimizer``
(``examples/difftre_propeller_fit.py``).
Everything runs on the card unless ``device="cpu"`` asks for the plain
versions.

Example (one H100)::

    topology, body = synthetic_duplex(5000, dtype=torch.float32)
    energy_fn, sim = build_sim(topology, kT, init_centers=body.center,
                               init_orientation=body.orientation)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = sim.run(energy_fn.opt_params(), body, 2000, gen)

    # every state: the per-step branch
    out = sim.replace(save_every=1).run(energy_fn.opt_params(), body, 400, gen)

    # direct differentiation: d loss / d every parameter through the run
    p = {k: v.clone().requires_grad_(True) for k, v in energy_fn.opt_params().items()}
    loss(sim.run(p, body, 200, gen)).backward()

    # the block tier, differentiated with a checkpoint every save
    energy_fn, sim = build_sim(topology, kT, mode="block", init_centers=body.center, checkpoint_every=1)
    loss(sim.run(p, body, 200, gen)).backward()

    # oxRNA2 starts from the A-form helix; its block tier runs the block sums
    topology, body = synthetic_duplex(5000, form="A", dtype=torch.float32)
    energy_fn, sim = build_sim(topology, kT, model="rna2", init_centers=body.center,
                               init_orientation=body.orientation)
    energy_fn, sim = build_sim(topology, kT, mode="block", model="rna2", init_centers=body.center)

    # a user's oxDNA files under oxDNA1, on the small-system path
    top = topology.from_oxdna_file("sys.top")
    body = trajectory.from_file("init.conf", top.strand_counts).states[0].to_rigid_body(dtype=torch.float32)
    energy_fn, sim = build_sim(top, kT, mode="pairs", model="dna1")
    out = sim.run(energy_fn.opt_params(), body, 1000, gen)
"""

from __future__ import annotations

import torch

import mythos_tpu_torch.energy.dna1 as dna1
import mythos_tpu_torch.energy.dna2 as dna2
import mythos_tpu_torch.energy.rna2 as rna2
from mythos_tpu_torch import spaces
from mythos_tpu_torch.rigid_body import RigidBody
from mythos_tpu_torch.simulators import integrators
from mythos_tpu_torch.simulators.cuda import BlockSimulator, CudaSimulator, PairSimulator
from mythos_tpu_torch.simulators.neighbors import (
    DensePairs,
    NoNeighborList,
    block_neighbor_list_for_topology,
    dense_pair_mask,
    stencil_band_for_site_cutoffs,
    strand_interleave_perm,
)
from mythos_tpu_torch.utils import devices

MODELS = {"dna1": dna1, "dna2": dna2, "rna2": rna2}
MODES = ("stencil", "block", "pairs", "dense")
#: the reference's 8-bp step (__graft_entry__.entry): kT 296.15 K x 0.1 / 300
ENTRY_KT = 296.15 * 0.1 / 300.0


def build_sim(
    topology,
    kT: float,  # noqa: N803 - domain casing
    mode: str = "stencil",
    model: str = "dna2",
    neighbor_update_every: int = 40,
    init_centers=None,
    init_orientation=None,
    site_margin: int | None = None,
    block_size: int = 8,
    checkpoint_every: int = 0,
    device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32,
):
    """(energy_fn, simulator) of one tier; the reference's ``_build_sim``
    arguments less ``dr_threshold`` (the block tables' skin is the
    reference's default 0.5; the site-mode stencil band reads none), plus
    ``device`` and ``dtype`` (float32, the kernels' type; the pairs and dense
    modes also float64). ``block_size`` sizes the block tier's tables;
    ``site_margin`` defaults to 2 under rna2, else 1. ``checkpoint_every``
    has the reference's meaning on every tier: outer iterations a checkpoint
    of a differentiated run -- rebuild intervals on the per-step branches,
    saves of ``save_every`` steps on the block tier's saving branch, steps
    or saves on the small-system path; the stencil's chunk path ignores it,
    as the reference's fused branch."""
    if mode not in MODES or model not in MODELS:
        raise NotImplementedError(f"mode={mode!r}, model={model!r}: modes {MODES}, models {tuple(MODELS)}")
    if dtype != torch.float32 and mode in ("stencil", "block"):
        raise ValueError(f"the {mode} tier's kernels take float32, not {dtype}")
    device = devices.resolve(device)
    pkg = MODELS[model]
    gamma_t, gamma_r = float(kT) / 2.5, float(kT) / 7.5
    if mode in ("pairs", "dense"):
        dense = mode == "dense"
        if model == "dna1":
            energy_fn = pkg.create_default_energy_fn(topology, dtype=dtype, device=device, dense_unbonded=dense)
        else:
            energy_fn = pkg.create_default_energy_fn(topology, dtype=dtype, device=device)
            if dense:
                energy_fn = energy_fn.with_props(dense_mask=dense_pair_mask(topology))
        neighbors = DensePairs() if dense else NoNeighborList(unbonded_nbrs=topology.unbonded_neighbors)
        return energy_fn, PairSimulator(energy_fn=energy_fn, neighbors=neighbors, dt=5e-3, kT=float(kT),
                                        gamma_t=gamma_t, gamma_r=gamma_r, checkpoint_every=checkpoint_every)
    kernels = model != "rna2"  # the tile kernels' families; rna2's block tier runs the block sums
    if mode == "block" and not kernels:
        energy_fn = pkg.create_default_energy_fn(topology, dtype=torch.float32, device=device, block_unbonded=True,
                                                 block_size=block_size)
    else:
        energy_fn = pkg.create_default_energy_fn(topology, dtype=torch.float32, device=device)
    dynamics = dict(
        dt=5e-3, kT=float(kT), mass=1.0, inertia=(1.0, 1.0, 1.0), gamma_t=gamma_t, gamma_r=gamma_r,
        save_every=neighbor_update_every, neighbor_update_every=neighbor_update_every,
    )
    if mode == "block":
        if init_centers is None:
            raise ValueError("the block tables are sized from init_centers")
        neighbors = block_neighbor_list_for_topology(
            topology,
            pkg.default_neighbor_cutoff(),
            block_size=block_size,
            init_centers=torch.as_tensor(init_centers, device=device),
            # oxDNA1 has no Debye term, and the block sums take one table: the reference's r_inner None
            r_cutoff_inner=pkg.short_range_neighbor_cutoff() if model == "dna2" else None,
            perm=strand_interleave_perm(topology),
            symmetric=kernels,
        )
        if not kernels:
            energy_fn = energy_fn.with_props(block_ids=neighbors.idx, block_perm=neighbors.perm)
        return energy_fn, BlockSimulator(energy_fn=energy_fn, neighbors=neighbors, checkpoint_every=checkpoint_every,
                                         **dynamics)
    if init_centers is None or init_orientation is None:
        raise ValueError("the site-mode stencil band is sized from init_centers and init_orientation")
    aform = model == "rna2"
    band = stencil_band_for_site_cutoffs(
        topology,
        pkg.per_term_site_cutoffs(),
        init_centers=init_centers,
        init_orientation=init_orientation,
        perm=strand_interleave_perm(topology),
        site_margin=site_margin if site_margin is not None else (2 if aform else 1),
        fam_slack_overrides=rna2.aform_site_slacks() if aform else None,
        far_slack=rna2.aform_far_slack() if aform else None,
    )
    return energy_fn, CudaSimulator(energy_fn=energy_fn, band=band, checkpoint_every=checkpoint_every, **dynamics)


def entry(device: torch.device | str = "cuda", dtype: torch.dtype = torch.float32, seed: int = 0):
    """``(step_fn, (state0,))``: one rigid-body BAOAB Langevin step of the
    8-bp oxDNA1 duplex on the dense (N, N) masks, as the reference's
    ``__graft_entry__.entry()`` (dt 5e-3, kT 296.15 K x 0.1 / 300, gamma
    (kT/2.5, kT/7.5), mass and inertia 1). ``step_fn(state)`` draws its
    normals from the generator seeded with ``seed`` that also drew
    ``state0``'s thermal momenta; ``step_fn(state, xi=normals)`` takes them
    from the caller ((2, N, 3)). On the card unless ``device="cpu"``."""
    from mythos_tpu_torch.io.synthetic import synthetic_duplex

    device = devices.resolve(device)
    topology, body = synthetic_duplex(8, dtype=dtype, device=device)
    energy_fn, _ = build_sim(topology, ENTRY_KT, mode="dense", model="dna1", device=device, dtype=dtype)
    gamma = RigidBody(torch.tensor([ENTRY_KT / 2.5], dtype=torch.float64),
                      torch.tensor([ENTRY_KT / 7.5], dtype=torch.float64))
    init_fn, step = integrators.nvt_langevin(energy_fn, spaces.free()[1], dt=5e-3, kT=ENTRY_KT, gamma=gamma)
    generator = torch.Generator(device=device).manual_seed(seed)
    mass = RigidBody(torch.tensor([1.0], dtype=torch.float64), torch.tensor([[1.0, 1.0, 1.0]], dtype=torch.float64))
    state0 = init_fn(generator, body, mass)

    def forward_step(state, xi=None):
        return step(state, generator, xi=xi)

    return forward_step, (state0,)
