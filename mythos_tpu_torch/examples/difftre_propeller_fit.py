#!/usr/bin/env python
"""DiffTRe fit of oxDNA1 parameters to a propeller-twist target.

Counterpart of examples/difftre_propeller_fit.py: instead of
differentiating through the dynamics, trajectories are reweighted under
perturbed parameters; when the effective sample size degrades, the
objective asks for a fresh simulation, and ``SimpleOptimizer`` reruns it.
The simulator is the small-system path (dna1_simulation.build_simulator);
the states are re-evaluated on the pair list. On the card unless
``--device cpu``.

Usage::

    python -m mythos_tpu_torch.examples.difftre_propeller_fit sys.top init.conf
"""

from __future__ import annotations

import argparse
import functools

import torch

import mythos_tpu_torch.energy.dna1 as dna1
from mythos_tpu_torch.examples.dna1_simulation import build_simulator, load_initial_state
from mythos_tpu_torch.losses import ObservableLossFn, SquaredError
from mythos_tpu_torch.observables import PropellerTwist
from mythos_tpu_torch.observables.propeller import TARGETS
from mythos_tpu_torch.optimization import DiffTReObjective, SimpleOptimizer
from mythos_tpu_torch.simulators.base import BoundSimulator
from mythos_tpu_torch.ui.loggers import ConsoleLogger
from mythos_tpu_torch.utils import devices

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("topology")
    parser.add_argument("conf")
    parser.add_argument("--sim-steps", type=int, default=10_000)
    parser.add_argument("--save-every", type=int, default=100)
    parser.add_argument("--n-eq-states", type=int, default=20)
    parser.add_argument("--opt-steps", type=int, default=50)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--target", type=float, default=TARGETS["oxDNA"])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    return parser.parse_args(argv)


def propeller_loss_fn(topology, target: float, device):
    """The example's ``grad_or_loss_fn``: the reweighted mean propeller
    twist over the duplex's base pairs against ``target``."""
    n = topology.n_nucleotides
    bps = torch.tensor([[i, n - 1 - i] for i in range(n // 2)], dtype=torch.int32, device=device)
    observable = PropellerTwist(rigid_body_transform_fn=dna1.default_transform_soa_fn(), h_bonded_base_pairs=bps)
    obs_loss = ObservableLossFn(observable=observable, loss_fn=SquaredError(), return_observable=True)

    def grad_or_loss_fn(ref_states, weights, energy_fn, opt_params, observables):
        loss, measured = obs_loss(ref_states, target, weights)
        return loss, (("propeller_twist", measured), None)

    return grad_or_loss_fn


def build_fit(args: argparse.Namespace):
    """(optimizer, initial parameters) of the fit the arguments describe."""
    device, dtype = devices.resolve(args.device), DTYPES[args.dtype]
    topology, init = load_initial_state(args.topology, args.conf, device=device, dtype=dtype)
    base_sim = build_simulator(topology, save_every=args.save_every, device=device, dtype=dtype)
    energy_fn = base_sim.energy_fn
    # freeze the simulator's run signature to (opt_params, **state); each
    # rerun the optimizer asks for draws a fresh generator (the threaded seq)
    simulator = BoundSimulator(name="propeller_sim", simulator=base_sim, run_args=(init, args.sim_steps))
    objective = DiffTReObjective(
        name="propeller",
        required_observables=tuple(simulator.exposes()),
        grad_or_loss_fn=propeller_loss_fn(topology, args.target, device),
        energy_fn=energy_fn,
        n_equilibration_steps=args.n_eq_states,
    )
    optimizer = SimpleOptimizer(
        objective=objective,
        simulator=simulator,
        optimizer=functools.partial(torch.optim.Adam, lr=args.learning_rate),
        logger=ConsoleLogger(),
    )
    return optimizer, energy_fn.opt_params()


def main(argv=None, callback=None):
    """Run the fit; ``callback`` as ``Optimizer.run`` takes it. Returns the
    last OptimizerOutput."""
    args = parse_args(argv)
    optimizer, params = build_fit(args)
    output = optimizer.run(params, n_steps=args.opt_steps, callback=callback)
    print("Final eps_stack_base:", float(output.opt_params["eps_stack_base"]))
    return output


if __name__ == "__main__":
    main()
