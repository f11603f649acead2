"""MARTINI 2/3 coarse-grained lipid models (port of mythos_tpu.energy.martini)."""

from mythos_tpu_torch.energy.martini import m2, m3
from mythos_tpu_torch.energy.martini.base import (
    MartiniEnergyConfiguration,
    MartiniEnergyFunction,
    MartiniTopology,
    derive_angle_names,
    derive_bond_names,
    get_periodic,
)

__all__ = [
    "MartiniEnergyConfiguration",
    "MartiniEnergyFunction",
    "MartiniTopology",
    "derive_angle_names",
    "derive_bond_names",
    "get_periodic",
    "m2",
    "m3",
]
