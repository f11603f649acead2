#!/usr/bin/env python
"""Simulate an oxDNA1 duplex with the port's small-system Langevin engine.

Counterpart of examples/dna1_simulation.py: the default oxDNA1 energy of a
topology, rigid-body BAOAB Langevin over the static pair list
(``entry.build_sim(mode="pairs", model="dna1")``: ``PairSimulator`` over
``NoNeighborList``, the force by autograd), and the trajectory written as
an oxDNA file. On the card unless ``--device cpu``.

Usage::

    python -m mythos_tpu_torch.examples.dna1_simulation sys.top init.conf --steps 20000
"""

from __future__ import annotations

import argparse

import torch

import mythos_tpu_torch.energy.dna1 as dna1
from mythos_tpu_torch.entry import build_sim
from mythos_tpu_torch.io import topology as top
from mythos_tpu_torch.io import trajectory as traj
from mythos_tpu_torch.utils import devices


def build_simulator(topology, checkpoint_every: int = 0, save_every: int = 1, device="cuda",
                    dtype: torch.dtype = torch.float32):
    """The default oxDNA1 simulator of a topology: the reference's
    simulation configuration (``dna1.default_configs()``: kT, dt 5e-3,
    mass and inertia 1, friction kT / 2.5 and kT / 7.5) on the pair list."""
    sim_cfg, _ = dna1.default_configs()
    _, sim = build_sim(topology, float(sim_cfg["kT"]), mode="pairs", model="dna1", checkpoint_every=checkpoint_every,
                       device=device, dtype=dtype)
    return sim.replace(save_every=save_every)


def load_initial_state(topology_path, conf_path, device="cuda", dtype: torch.dtype = torch.float32):
    """(topology, first state of ``conf_path`` as a RigidBody on ``device``)."""
    topology = top.from_oxdna_file(topology_path)
    init = traj.from_file(conf_path, topology.strand_counts).states[0].to_rigid_body(dtype=dtype, device=device)
    return topology, init


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("topology")
    parser.add_argument("conf")
    parser.add_argument("--steps", type=int, default=20_000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="trajectory_out.dat")
    parser.add_argument("--save-every", type=int, default=100)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = devices.resolve(args.device)
    topology, init = load_initial_state(args.topology, args.conf, device=device)
    simulator = build_simulator(topology, save_every=args.save_every, device=device)
    params = simulator.energy_fn.opt_params()

    print(f"Simulating {args.steps} steps of a {topology.n_nucleotides}-nt system...")
    with torch.no_grad():
        out = simulator.run(params, init, args.steps, torch.Generator(device=device).manual_seed(args.seed))
    trajectory = out.observables[0]
    trajectory.to_file(args.out)
    print(f"Done; wrote {trajectory.length()} states to {args.out}")


if __name__ == "__main__":
    main()
