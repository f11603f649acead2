"""User entry point: build the simulator of a ported tier.

Counterpart of ``__graft_entry__._build_sim`` for ``model="dna2"`` and
``model="rna2"``, rigid-body BAOAB with dt 5e-3, mass 1, inertia 1 and
friction gamma = (kT/2.5, kT/7.5):

* ``mode="stencil"`` -- the configuration ``bench.py`` runs by default: the
  banded stencil over the strand-interleave slot order, a site-mode band
  sized from the initial conformation (kernels K1, K2). Under rna2 the
  band takes the A-form slacks and far slack, and ``site_margin`` 2;
* ``mode="block"`` -- the block tier for general conformations (dna2 only):
  a symmetric two-level (tight, wide) block-neighbor table over the same
  slot order, rebuilt every ``neighbor_update_every`` steps (kernel K3).

Both simulators save a state every ``save_every`` (40) steps; callers that
want every state take ``sim.replace(save_every=1)``, and the stencil then
steps one step at a time (K2 plus the bonded gradient each step) instead
of in K1's chunks, as the reference's per-step branch does. The stencil's
run is differentiable in its parameters on both branches (K1 and K2
forward, their plain versions backward), and so is the block tier's (K3
forward through ``ops.tiles.TileForces``); ``checkpoint_every`` trades a
differentiated run's graph for recompute (at 1,000 nt on an H100 80GB
HBM3 at 700 W, the graph a 40-step per-step stencil forward holds falls
from 79.7 to 26.4 MiB with a checkpoint every 10-step interval, while the
evaluation's peak, set by the backward's working set at that length,
stays ~104-109 MiB above its start: ``chip_smoke.py`` phase 12c; the
block tier's: phase 13c). Other modes and models, and the rna2 block
tier, are not ported yet and raise.
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

    # oxRNA2 starts from the A-form helix
    topology, body = synthetic_duplex(5000, form="A", dtype=torch.float32)
    energy_fn, sim = build_sim(topology, kT, model="rna2", init_centers=body.center,
                               init_orientation=body.orientation)
"""

from __future__ import annotations

import torch

import mythos_tpu_torch.energy.dna2 as dna2
import mythos_tpu_torch.energy.rna2 as rna2
from mythos_tpu_torch.simulators.cuda import BlockSimulator, CudaSimulator
from mythos_tpu_torch.simulators.neighbors import (
    block_neighbor_list_for_topology,
    stencil_band_for_site_cutoffs,
    strand_interleave_perm,
)
from mythos_tpu_torch.utils import devices


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
):
    """(energy_fn, simulator) of one tier in float32 (the kernels' type);
    the reference's ``_build_sim`` arguments less ``dr_threshold`` (the
    block tables' skin is the reference's default 0.5; the site-mode
    stencil band reads none), plus ``device``. ``block_size`` sizes the
    block tier's tables; ``site_margin`` defaults to 2 under rna2, else 1.
    ``checkpoint_every`` has the reference's meaning on both tiers: outer
    iterations a checkpoint of a differentiated run -- rebuild intervals on
    the per-step branches, saves of ``save_every`` steps on the block
    tier's saving branch; the stencil's chunk path ignores it, as the
    reference's fused branch."""
    if (mode, model) not in (("stencil", "dna2"), ("block", "dna2"), ("stencil", "rna2")):
        raise NotImplementedError(
            f"mode={mode!r}, model={model!r} is not ported yet (stencil dna2 or rna2, block dna2)"
        )
    device = devices.resolve(device)
    pkg = rna2 if model == "rna2" else dna2
    energy_fn = pkg.create_default_energy_fn(topology, dtype=torch.float32, device=device)
    dynamics = dict(
        dt=5e-3, kT=float(kT), mass=1.0, inertia=(1.0, 1.0, 1.0), gamma_t=float(kT) / 2.5, gamma_r=float(kT) / 7.5,
        save_every=neighbor_update_every, neighbor_update_every=neighbor_update_every,
    )
    if mode == "block":
        if init_centers is None:
            raise ValueError("the block tables are sized from init_centers")
        neighbors = block_neighbor_list_for_topology(
            topology,
            dna2.default_neighbor_cutoff(),
            block_size=block_size,
            init_centers=torch.as_tensor(init_centers, device=device),
            r_cutoff_inner=dna2.short_range_neighbor_cutoff(),
            perm=strand_interleave_perm(topology),
        )
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
