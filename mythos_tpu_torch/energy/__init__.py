"""Energy models: composable parameterized potentials (port of mythos_tpu.energy)."""

from mythos_tpu_torch.energy.base import (
    BaseConfiguration,
    BaseEnergyFunction,
    ComposedEnergyFunction,
    params_from_numpy,
)

__all__ = [
    "BaseConfiguration",
    "BaseEnergyFunction",
    "ComposedEnergyFunction",
    "params_from_numpy",
]
