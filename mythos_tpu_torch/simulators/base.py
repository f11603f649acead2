"""Simulator base classes.

Counterpart of mythos_tpu/simulators/base.py: ``SimulatorOutput``, the
``Simulator`` contract (observables matched to objectives by the exposed
names ``"{obs}.{Class}.{name}"``) and ``BoundSimulator``, which adapts an
in-process simulator to the optimizer's ``run(opt_params, **state)``.
``InputDirSimulator`` waits for the external engines.
"""

from __future__ import annotations

import dataclasses as dc
import uuid
from typing import Any, ClassVar

import torch


@dc.dataclass(frozen=True)
class SimulatorOutput:
    """Observables (by position, matching exposes()) plus simulator state."""

    observables: list[Any]
    state: dict[str, Any] = dc.field(default_factory=dict)


@dc.dataclass(frozen=True, kw_only=True)
class Simulator:
    """Base class for simulation backends."""

    name: str = dc.field(default_factory=lambda: str(uuid.uuid4()))
    exposed_observables: ClassVar[list[str]] = ["trajectory"]

    def run(self, *_args, opt_params: dict[str, Any], **_kwargs) -> SimulatorOutput:
        """Run the simulation."""
        raise NotImplementedError

    def exposes(self) -> list[str]:
        """Fully-qualified observable names this simulator produces."""
        return [f"{obs}.{self.__class__.__name__}.{self.name}" for obs in self.exposed_observables]


def generator_seed(seed: int, seq: int) -> int:
    """The seed of invocation ``seq`` of a simulator seeded with ``seed``:
    ``seed`` in the high 32 bits, ``seq`` in the low 32 (the port's
    counterpart of ``jax.random.fold_in(PRNGKey(seed), seq)``)."""
    return ((int(seed) & 0x7FFFFFFF) << 32) | (int(seq) & 0xFFFFFFFF)


@dc.dataclass(frozen=True, kw_only=True)
class BoundSimulator(Simulator):
    """Adapt an in-process simulator to the optimizer run protocol.

    Optimizers call ``run(opt_params, **state)``; the port's simulators
    take positional ``(init_state, n_steps, generator)``. This adapter binds
    ``run_args`` (the initial state and the step count) and draws a fresh
    ``torch.Generator`` each invocation, on the device of the initial state,
    seeded from (``seed``, ``seq``) by :func:`generator_seed`, ``seq`` an
    invocation counter threaded through the optimizer's component state --
    so that a DiffTRe resimulation request draws a new trajectory instead
    of replaying the old one."""

    simulator: Any
    run_args: tuple = ()
    seed: int = 0

    def run(self, opt_params: dict[str, Any] | None, seq: int = 0, **_state) -> SimulatorOutput:
        """Run the bound simulator with invocation ``seq``'s generator."""
        device = self.run_args[0].center.device if self.run_args else torch.device("cpu")
        generator = torch.Generator(device=device).manual_seed(generator_seed(self.seed, seq))
        out = self.simulator.run(opt_params, *self.run_args, generator)
        return SimulatorOutput(observables=out.observables, state={**out.state, "seq": seq + 1})
