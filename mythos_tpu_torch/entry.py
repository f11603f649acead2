"""User entry point: build the simulator of the ported main path.

Counterpart of ``__graft_entry__._build_sim`` for ``mode="stencil"``,
``model="dna2"`` -- the configuration ``bench.py`` runs by default: an
oxDNA2 energy on the banded stencil over the strand-interleave slot order,
a site-mode band sized from the initial conformation, and rigid-body BAOAB
with dt 5e-3, mass 1, inertia 1 and friction gamma = (kT/2.5, kT/7.5).
Other modes and models are not ported yet and raise.

Example (one H100)::

    topology, body = synthetic_duplex(5000, dtype=torch.float32, device="cuda")
    energy_fn, sim = build_sim(topology, kT, init_centers=body.center,
                               init_orientation=body.orientation, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = sim.run(energy_fn.opt_params(), body, 2000, gen)
"""

from __future__ import annotations

import torch

import mythos_tpu_torch.energy.dna2 as dna2
from mythos_tpu_torch.simulators.cuda import CudaSimulator
from mythos_tpu_torch.simulators.neighbors import stencil_band_for_site_cutoffs, strand_interleave_perm


def build_sim(
    topology,
    kT: float,  # noqa: N803 - domain casing
    mode: str = "stencil",
    model: str = "dna2",
    neighbor_update_every: int = 40,
    init_centers=None,
    init_orientation=None,
    site_margin: int = 1,
    device: torch.device | str = "cpu",
):
    """(energy_fn, CudaSimulator) of the stencil tier in float32 (the
    kernels' type); the reference's ``_build_sim`` arguments, less
    ``dr_threshold`` (the site-mode band never reads it) and
    ``block_size``/``checkpoint_every`` (other tiers), plus ``device``."""
    if mode != "stencil" or model != "dna2":
        raise NotImplementedError(f"mode={mode!r}, model={model!r} is not ported yet (stencil/dna2 only)")
    if init_centers is None or init_orientation is None:
        raise ValueError("the site-mode stencil band is sized from init_centers and init_orientation")
    energy_fn = dna2.create_default_energy_fn(topology, dtype=torch.float32, device=device)
    band = stencil_band_for_site_cutoffs(
        topology,
        dna2.per_term_site_cutoffs(),
        init_centers=init_centers,
        init_orientation=init_orientation,
        perm=strand_interleave_perm(topology),
        site_margin=site_margin,
    )
    sim = CudaSimulator(
        energy_fn=energy_fn,
        band=band,
        dt=5e-3,
        kT=float(kT),
        mass=1.0,
        inertia=(1.0, 1.0, 1.0),
        gamma_t=float(kT) / 2.5,
        gamma_r=float(kT) / 7.5,
        save_every=neighbor_update_every,
        neighbor_update_every=neighbor_update_every,
    )
    return energy_fn, sim
