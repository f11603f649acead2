"""Objectives: gradient producers, DiffTRe trajectory reweighting among them.

Counterpart of mythos_tpu/optimization/objective.py. The DiffTRe math
follows Thaler & Zavadlav, Nat. Commun. 12, 6884 (2021), eqs. 4-5:
Boltzmann reweighting of reference states under perturbed parameters, with
the normalized effective sample size n_eff as the validity criterion. The
gradient is ``torch.autograd.grad`` over the parameter leaves (the
reference's ``jax.value_and_grad``; a probabilistic sequence ``{"pseq":
(up_pseq, bp_pseq)}`` gets a tuple of gradients, as its pytree does); the
re-evaluation is the composed energy's ``map`` (with ``map_neighbors``:
the tile kernels K4 forward and K5 backward).
"""

from __future__ import annotations

import dataclasses as dc
import math
import typing
from collections.abc import Callable

import torch

from mythos_tpu_torch.simulators.io import SimulatorTrajectory

ERR_MISSING_ARG = "Missing required argument: {missing_arg}."
ERR_OBJECTIVE_NOT_READY = "Not all required observables have been obtained."
ERR_NEIGHBOR_OVERFLOW = (
    "Trajectory was produced with an overflowed neighbor table (dropped pair "
    "interactions). Enlarge the neighbor-list capacity (capacity/"
    "capacity_multiplier) and re-simulate."
)


@dc.dataclass(frozen=True, kw_only=True)
class ObjectiveOutput:
    """Result of an objective calculation. ``is_ready=False`` with
    ``needs_update`` names is the signal that re-triggers the producing
    simulators."""

    is_ready: bool
    grads: dict | None = None
    observables: dict[str, typing.Any] = dc.field(default_factory=dict)
    state: dict[str, typing.Any] = dc.field(default_factory=dict)
    needs_update: tuple[str, ...] = ()


@dc.dataclass(frozen=True, kw_only=True)
class Objective:
    """Immutable gradient producer: ``required_observables`` names are
    matched against simulator ``exposes()`` strings; all state passes
    through :meth:`calculate`."""

    name: str
    required_observables: tuple[str, ...]
    grad_or_loss_fn: Callable = dc.field(repr=False)

    def __post_init__(self) -> None:
        for arg in ("name", "required_observables", "grad_or_loss_fn"):
            if getattr(self, arg) is None:
                raise ValueError(ERR_MISSING_ARG.format(missing_arg=arg))

    def calculate(self, observables: dict[str, typing.Any], opt_params: dict | None = None,
                  **_kwargs) -> ObjectiveOutput:
        """Gradients from observables, or the names of the missing ones."""
        missing = [obs for obs in self.required_observables if obs not in observables]
        if missing:
            return ObjectiveOutput(is_ready=False, needs_update=tuple(missing))
        sorted_obs = [observables[key] for key in self.required_observables]
        grads, aux = self.grad_or_loss_fn(*sorted_obs)
        output_observables = dict(aux)
        output_observables.update(dict(zip(self.required_observables, sorted_obs, strict=True)))
        return ObjectiveOutput(is_ready=True, grads=grads, observables=output_observables)


# DiffTRe math -----------------------------------------------------------------


def compute_weights_and_neff(beta, new_energies: torch.Tensor, ref_energies: torch.Tensor):
    """Boltzmann weights and normalized effective sample size:
    w_i = exp(-beta dE_i) / sum, n_eff = exp(-sum w log w) / S. ``beta``
    is a number or a per-state tensor. The max logit is subtracted (without
    gradient) so that float32 does not overflow."""
    logits = -beta * (new_energies - ref_energies)
    logits = logits - logits.max().detach()
    boltz = torch.exp(logits)
    weights = boltz / boltz.sum()
    n_eff = torch.exp(-torch.sum(weights * torch.log(torch.where(weights > 0, weights, torch.ones_like(weights)))))
    return weights, n_eff / new_energies.shape[0]


def compute_min_segment_neff(temperature, new_energies: torch.Tensor, ref_energies: torch.Tensor) -> float:
    """The smallest n_eff over the trajectory's temperature segments, read
    on the host (one device read for all three inputs)."""
    temperature, new_energies, ref_energies = (
        torch.as_tensor(x).detach().cpu() for x in (temperature, new_energies, ref_energies))

    def segment_neff(temp) -> float:
        mask = temperature == temp
        return float(compute_weights_and_neff(1.0 / temp, new_energies[mask], ref_energies[mask])[1])

    return min(segment_neff(t) for t in torch.unique(temperature))


def compute_loss(opt_params: dict, energy_fn, beta, loss_fn: Callable, ref_states, ref_energies,
                 observables: list) -> tuple:
    """The reweighted loss under ``opt_params`` (the DiffTRe objective's
    core): ``(loss, (n_eff, measured_value, new_energies))``.
    ``ref_energies`` None takes the new energies, without gradient, as the
    reference (the reference parameters are ``opt_params``: uniform weights,
    gradients through the reweighting alone)."""
    energy_fn = energy_fn.with_params(opt_params)
    new_energies = energy_fn.map(ref_states)
    ref = new_energies.detach() if ref_energies is None else ref_energies
    weights, neff = compute_weights_and_neff(beta, new_energies, ref)
    loss, (measured_value, _) = loss_fn(ref_states, weights, energy_fn, opt_params, observables)
    return loss, (neff, measured_value, new_energies)


def _map(fn, params: dict) -> dict:
    """``fn`` on each tensor of ``params``, a tuple's (a probabilistic
    sequence ``(up_pseq, bp_pseq)``) element by element, as the reference's
    pytree gradient treats it."""
    return {k: tuple(fn(x) for x in v) if isinstance(v, tuple) else fn(v) for k, v in params.items()}


def _leaves(opt_params: dict) -> dict:
    return _map(lambda v: torch.as_tensor(v).detach().requires_grad_(True), opt_params)


def _grads(loss: torch.Tensor, leaves: dict) -> dict:
    flat = [x for v in leaves.values() for x in (v if isinstance(v, tuple) else (v,))]
    g = dict(zip(map(id, flat), torch.autograd.grad(loss, flat, allow_unused=True), strict=True))
    return _map(lambda v: torch.zeros_like(v) if g[id(v)] is None else g[id(v)], leaves)


def check_no_overflow(*trajectories) -> None:
    """Refuse trajectories whose neighbor tables overflowed: they dropped
    pair interactions, and reweighting them would corrupt the fit."""
    for t in trajectories:
        overflow = (t.metadata or {}).get("neighbor_overflow")
        if overflow is not None and bool(torch.as_tensor(overflow).any()):
            raise RuntimeError(ERR_NEIGHBOR_OVERFLOW)


def _detached(params: dict) -> dict:
    return _map(lambda v: torch.as_tensor(v).detach(), params)


@dc.dataclass(frozen=True, kw_only=True)
class DiffTReObjective(Objective):
    """Differentiable Trajectory Reweighting objective.

    Protocol: slice the equilibration snapshots, concatenate the
    trajectories, evaluate the reference energies under the frozen
    reference parameters, check the per-segment n_eff >= ``min_n_eff_factor``
    (else ask for fresh trajectories and reset ``opt_steps``), then produce
    the reweighted gradients. ``energy_fn.map`` re-evaluates the states: give
    the energy ``map_neighbors`` for the tile kernels.

    The states are re-evaluated once under the current parameters, with
    the autograd graph, and the n_eff check reads those energies before the
    backward runs; where the reference parameters are the current ones (the
    first step on fresh trajectories) the reference energies are those same
    energies, which the reference's second evaluation reproduces bit for
    bit."""

    energy_fn: typing.Any = dc.field(repr=False)
    n_equilibration_steps: int = 0
    min_n_eff_factor: float = 0.95
    max_valid_opt_steps: float = math.inf

    def __post_init__(self) -> None:
        Objective.__post_init__(self)
        if self.energy_fn is None:
            raise ValueError(ERR_MISSING_ARG.format(missing_arg="energy_fn"))
        if self.n_equilibration_steps is None:
            raise ValueError(ERR_MISSING_ARG.format(missing_arg="n_equilibration_steps"))
        if self.n_equilibration_steps < 0:
            raise ValueError(f"n_equilibration_steps must be non-negative, got {self.n_equilibration_steps}.")
        if self.max_valid_opt_steps <= 0:
            raise ValueError("max_valid_opt_steps must be positive or infinity.")

    def calculate(self, observables: dict[str, typing.Any], opt_params: dict, opt_steps: int = 0,
                  reference_opt_params: dict | None = None) -> ObjectiveOutput:
        """Gradients by reweighting, or a not-ready request for fresh data."""
        if opt_steps >= self.max_valid_opt_steps:
            return ObjectiveOutput(is_ready=False, needs_update=tuple(self.required_observables),
                                   state={"opt_steps": 0})
        missing = [obs for obs in self.required_observables if obs not in observables]
        if missing:
            return ObjectiveOutput(is_ready=False, needs_update=tuple(missing))

        sorted_obs = [observables[key] for key in self.required_observables]
        trajectories = [o for o in sorted_obs if isinstance(o, SimulatorTrajectory)]
        if not trajectories:
            raise ValueError("No SimulatorTrajectory observables found in observables.")
        check_no_overflow(*trajectories)
        if self.n_equilibration_steps > 0:
            trajectories = [t.slice(slice(self.n_equilibration_steps, t.length())) for t in trajectories]
        reference_states = SimulatorTrajectory.concat(trajectories)
        if reference_states.length() == 0:
            raise ValueError("Equilibration slicing yields no states! Note slicing is in number of "
                             "snapshots, not timesteps.")
        if reference_states.temperature is None:
            raise ValueError("SimulatorTrajectory.temperature is None. DiffTRe requires per-state "
                             "temperature (kT) on the trajectory.")
        beta = 1.0 / reference_states.temperature

        same_reference = reference_opt_params is None or reference_opt_params is opt_params
        reference_opt_params = opt_params if same_reference else reference_opt_params
        reference_energies = None
        if not same_reference:
            with torch.no_grad():
                reference_energies = self.energy_fn.with_params(_detached(reference_opt_params)).map(
                    reference_states)
        leaves = _leaves(opt_params)
        with torch.enable_grad():
            loss, (_, measured_value, new_energies) = compute_loss(
                leaves, self.energy_fn, beta, self.grad_or_loss_fn, reference_states, reference_energies,
                sorted_obs)
        if reference_energies is None:
            reference_energies = new_energies.detach()
        neff = compute_min_segment_neff(reference_states.temperature, new_energies, reference_energies)
        if neff < self.min_n_eff_factor:
            return ObjectiveOutput(is_ready=False, needs_update=tuple(self.required_observables),
                                   observables={"neff": neff}, state={"opt_steps": 0})
        grads = _grads(loss, leaves)
        return ObjectiveOutput(
            is_ready=True,
            grads=grads,
            observables={"loss": loss.detach(), "neff": neff, measured_value[0]: measured_value[1].detach()},
            state={"opt_steps": opt_steps + 1, "reference_opt_params": reference_opt_params},
        )
