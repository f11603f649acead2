"""Loss functions over observables.

Counterpart of mythos_tpu/losses/__init__.py: ``SquaredError``,
``RootMeanSquaredError``, ``ObservableLossFn`` (the reweighted observable
expectation against a target) and ``l2_loss``.
"""

from __future__ import annotations

import dataclasses as dc
from collections.abc import Callable

import torch


class LossFn:
    """Base class for loss functions."""

    def __call__(self, actual, target, weights=None) -> torch.Tensor:
        raise NotImplementedError("Subclasses must implement this method.")


class SquaredError(LossFn):
    """(target - actual)^2."""

    def __call__(self, actual: torch.Tensor, target) -> torch.Tensor:
        return (target - actual) ** 2


class RootMeanSquaredError(LossFn):
    """sqrt(mean((target - actual)^2))."""

    def __call__(self, actual: torch.Tensor, target) -> torch.Tensor:
        return torch.sqrt(torch.mean((target - actual) ** 2))


@dc.dataclass
class ObservableLossFn:
    """Reweighted observable expectation and its loss against a target.

    The weights are DiffTRe reweighting weights: the expectation is
    sum(weights * observable(trajectory)). Returns ``(loss,)``, or
    ``(loss, expectation)`` with ``return_observable``."""

    observable: Callable
    loss_fn: LossFn
    return_observable: bool = False

    def __call__(self, trajectory, target, weights: torch.Tensor) -> tuple:
        obs = torch.sum(self.observable(trajectory) * weights)
        vals = [self.loss_fn(obs, target)]
        if self.return_observable:
            vals.append(obs)
        return tuple(vals)


def l2_loss(actual: torch.Tensor, target) -> torch.Tensor:
    """sum((actual - target)^2)."""
    return torch.sum((actual - target) ** 2)


__all__ = ["LossFn", "ObservableLossFn", "RootMeanSquaredError", "SquaredError", "l2_loss"]
