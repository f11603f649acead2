"""Optimization loops: the base run loop and the simple optimizer.

Counterpart of ``Optimizer`` and ``SimpleOptimizer`` of
mythos_tpu/optimization/optimization.py. A ``torch.optim`` optimizer takes
optax's place: ``SimpleOptimizer.optimizer`` builds one over a list of leaf
tensors (e.g. ``functools.partial(torch.optim.Adam, lr=1e-3)``; Adam's
update is optax.adam's, m_hat / (sqrt(v_hat) + eps)). Its state is a
value, as optax's is: ``OptimizerState.optimizer_state`` holds the torch
optimizer's ``state_dict()`` after a step, and each step builds fresh
leaves from the parameters the objective differentiated, a fresh
optimizer over them that loads a deep copy of that state, sets the
leaves' ``.grad`` to the objective's gradients (nothing accumulates across
steps or resimulations), and steps. A step from an earlier output's state
therefore repeats that output's next step. The concurrent
``PoolOptimizer`` waits for the external engines.
"""

from __future__ import annotations

import copy
import dataclasses as dc
import logging
from abc import ABC, abstractmethod
from collections.abc import Callable
from typing import Any

import torch

from mythos_tpu_torch.optimization.objective import Objective
from mythos_tpu_torch.ui.loggers.logger import Logger, NullLogger
from mythos_tpu_torch.utils.helpers import tree_leaves, try_to_float

LOGGER = logging.getLogger(__name__)


@dc.dataclass(frozen=True, kw_only=True)
class OptimizerState:
    """All mutable optimization-loop state; ``component_state`` is keyed by
    objective and simulator name (one namespace: names must be unique).
    ``optimizer_state`` is the torch optimizer's ``state_dict()`` once a
    step ran (over the parameters in their dict order); no step mutates it."""

    observables: dict[str, Any] = dc.field(default_factory=dict)
    component_state: dict[str, dict[str, Any]] = dc.field(default_factory=dict)
    optimizer_state: Any | None = None

    def replace(self, **kw) -> "OptimizerState":
        return dc.replace(self, **kw)


@dc.dataclass(frozen=True, kw_only=True)
class OptimizerOutput:
    """One optimization step's result."""

    grads: dict
    opt_params: dict
    state: OptimizerState
    observables: dict[str, dict[str, Any]] = dc.field(default_factory=dict)


def _all_finite(tensors: list) -> bool:
    """Whether every tensor is finite, read with one device synchronisation."""
    return bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all()) if tensors else True


@dc.dataclass(frozen=True, kw_only=True)
class Optimizer(ABC):
    """Base optimizer: the run loop with callback, logging and NaN guard."""

    logger: Logger = dc.field(default_factory=NullLogger)

    @abstractmethod
    def step(self, params: dict, state: OptimizerState | None = None) -> OptimizerOutput:
        """One optimization step."""

    def run(self, params: dict, n_steps: int, callback: Callable | None = None) -> OptimizerOutput:
        """Run for n_steps; ``callback(optimizer_output=, step=)`` returns
        (output or None, keep_going). Raises RuntimeError on NaN/Inf
        gradients rather than fit on silently."""
        if n_steps < 1:
            raise ValueError("n_steps must be at least 1.")
        state = None
        output = None
        for step in range(n_steps):
            output = self.step(params, state)
            keep_going = True
            if callback is not None:
                cb_output, keep_going = callback(optimizer_output=output, step=step)
                output = cb_output if cb_output is not None else output
            for component, obs in output.observables.items():
                for obs_name, value in obs.items():
                    if (value := try_to_float(value)) is not None:
                        self.logger.log_metric(f"{component}.{obs_name}", value, step=step)
            if not keep_going:
                LOGGER.info("Early stopping optimization at step %s based on callback signal.", step)
                break
            if not _all_finite(tree_leaves(output.grads)):
                raise RuntimeError(f"NaN or Inf detected in gradients at step {step}. Is your learning rate too high?")
            params = output.opt_params
            state = output.state
        return output


@dc.dataclass(frozen=True, kw_only=True)
class SimpleOptimizer(Optimizer):
    """One simulator and one objective: try the cached observables, rerun
    the simulator where the objective is not ready. ``optimizer`` maps a
    list of leaf tensors to a ``torch.optim.Optimizer`` over them."""

    objective: Objective
    simulator: Any
    optimizer: Callable[[list], torch.optim.Optimizer]

    def step(self, params: dict, state: OptimizerState | None = None) -> OptimizerOutput:
        state = state or OptimizerState()
        params = {k: torch.as_tensor(v).detach() for k, v in params.items()}
        obj_state = state.component_state.get(self.objective.name, {})
        sim_state = state.component_state.get(self.simulator.name, {})
        obj_output = None
        if state.observables:
            obj_output = self.objective.calculate(state.observables, opt_params=params, **obj_state)
            obj_state = obj_output.state
        if obj_output is None or not obj_output.is_ready:
            with torch.no_grad():
                sim_output = self.simulator.run(params, **sim_state)
            sim_state = sim_output.state
            state = state.replace(observables=dict(zip(self.simulator.exposes(), sim_output.observables, strict=True)))
            obj_output = self.objective.calculate(state.observables, opt_params=params, **obj_state)
            obj_state = obj_output.state
            if not obj_output.is_ready:
                raise ValueError("Objective readiness check failed after simulation run.")

        grads = obj_output.grads
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        opt = self.optimizer(list(leaves.values()))
        if state.optimizer_state is not None:
            # load_state_dict keeps tensors already of the leaves' dtype and
            # device, and the step updates them in place: load a copy
            opt.load_state_dict(copy.deepcopy(state.optimizer_state))
        for k, leaf in leaves.items():
            leaf.grad = grads[k].detach().to(leaf.dtype).clone()
        opt.step()
        return OptimizerOutput(
            opt_params={k: leaf.detach() for k, leaf in leaves.items()},
            state=state.replace(
                optimizer_state=opt.state_dict(),
                component_state={**state.component_state, self.objective.name: obj_state,
                                 self.simulator.name: sim_state},
            ),
            grads=grads,
            observables={self.objective.name: obj_output.observables},
        )
