"""Default-configuration loading for the model packages.

Counterpart of mythos_tpu/energy/defaults.py. The TOML data files are read
in place from the JAX package's ``energy/<model>/defaults/`` (data is
shared; code is not). Values stay Python floats here; the model packages
cast them to tensors of the requested dtype and device.
"""

from __future__ import annotations

from pathlib import Path

from mythos_tpu_torch.io import toml

#: the reference package's energy directory (data files only)
_ENERGY_DIR = Path(__file__).resolve().parents[2] / "mythos_tpu" / "energy"


def default_configs_for(model: str) -> tuple[dict, dict]:
    """(simulation_config, energy_config) parsed from the model's defaults."""
    config_dir = _ENERGY_DIR / model / "defaults"
    return toml.parse_toml(config_dir / "simulation.toml"), toml.parse_toml(config_dir / "energy.toml")
