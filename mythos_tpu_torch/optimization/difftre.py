"""One DiffTRe training step on one device.

The one-device form of ``__graft_entry__.dryrun_multichip`` (its loss_fn
and optimizer update, without the mesh or the gradient psum): simulate,
treat the saved states as data, re-evaluate their energies under the
current parameters (ComposedEnergyFunction.map with ``map_neighbors``: the
tile kernels K4 and, backward, K5), Boltzmann-reweight the observable, and
take one optimizer step on the loss against a target. The reweighting is
:func:`optimization.objective.compute_loss`, the one the objectives use.
"""

from __future__ import annotations

import torch

from mythos_tpu_torch.losses import ObservableLossFn, SquaredError
from mythos_tpu_torch.optimization.objective import check_no_overflow, compute_loss
from mythos_tpu_torch.rigid_body import RigidBody


def difftre_loss(energy_fn, map_neighbors, observable, target, opt_params: dict, states, kT: float,  # noqa: N803
                 loss_fn=SquaredError()):
    """(loss, n_eff) of fixed reference states: the reference energies are
    the re-evaluated ones without gradient, so the weights start uniform and
    gradients flow only through the reweighting."""
    states = RigidBody(states.center.detach(), states.orientation.detach())
    obs_loss = ObservableLossFn(observable=observable, loss_fn=loss_fn, return_observable=True)

    def grad_or_loss_fn(ref_states, weights, *_):
        loss, measured = obs_loss(ref_states, target, weights)
        return loss, (("observable", measured), None)

    loss, (n_eff, _, _) = compute_loss(opt_params, energy_fn.replace(map_neighbors=map_neighbors), 1.0 / kT,
                                       grad_or_loss_fn, states, None, [])
    return loss, n_eff


def difftre_step(energy_fn, sim, map_neighbors, observable, target, optimizer: torch.optim.Optimizer,
                 generator: torch.Generator, *, opt_params: dict, init_state: RigidBody, n_steps: int,
                 loss_fn=SquaredError()) -> dict:
    """One training step; ``opt_params`` are the leaf tensors ``optimizer``
    updates. Returns the loss, n_eff, the gradients and the new parameters."""
    with torch.no_grad():
        out = sim.run({k: v.detach() for k, v in opt_params.items()}, init_state, n_steps, generator)
    traj = out.observables[0]
    check_no_overflow(traj)
    optimizer.zero_grad()
    loss, n_eff = difftre_loss(energy_fn, map_neighbors, observable, target, opt_params, traj, sim.kT, loss_fn)
    loss.backward()
    grads = {k: torch.zeros_like(v) if v.grad is None else v.grad.detach().clone() for k, v in opt_params.items()}
    optimizer.step()
    return {
        "loss": loss.detach(),
        "n_eff": n_eff.detach(),
        "grads": grads,
        "params": {k: v.detach().clone() for k, v in opt_params.items()},
        "trajectory": traj,
    }
