"""Loss functions over observables.

Counterpart of mythos_tpu/losses/__init__.py (``SquaredError``,
``RootMeanSquaredError``); the observable-loss wrapper is not ported yet.
"""

from __future__ import annotations

import torch


class SquaredError:
    """(target - actual)^2."""

    def __call__(self, actual: torch.Tensor, target) -> torch.Tensor:
        return (target - actual) ** 2


class RootMeanSquaredError:
    """sqrt(mean((target - actual)^2))."""

    def __call__(self, actual: torch.Tensor, target) -> torch.Tensor:
        return torch.sqrt(torch.mean((target - actual) ** 2))
