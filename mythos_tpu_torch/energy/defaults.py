"""Default-configuration loading for the model packages.

Counterpart of mythos_tpu/energy/defaults.py. The TOML data files are read
in place from the JAX package's ``energy/<model>/defaults/`` (data is
shared; code is not). Values stay Python floats here; the model packages
cast them to tensors of the requested dtype and device (``cast_params``).
The cutoff helpers the model packages share read a composed energy's
bound parameters, or the defaults (``term_params``,
``unbonded_site_cutoffs``, ``pair_cutoffs``).
"""

from __future__ import annotations

from collections.abc import Callable
from pathlib import Path

import numpy as np
import torch

from mythos_tpu_torch.io import toml

#: the reference package's energy directory (data files only)
_ENERGY_DIR = Path(__file__).resolve().parents[2] / "mythos_tpu" / "energy"


def default_configs_for(model: str) -> tuple[dict, dict]:
    """(simulation_config, energy_config) parsed from the model's defaults;
    the simulation config is empty where the model ships none (rna2)."""
    config_dir = _ENERGY_DIR / model / "defaults"
    sim_path = config_dir / "simulation.toml"
    sim = toml.parse_toml(sim_path) if sim_path.exists() else {}
    return sim, toml.parse_toml(config_dir / "energy.toml")


def cast_params(values: dict, dtype, device) -> dict:
    """A parameter table's numbers and arrays as tensors of ``dtype`` on
    ``device`` (a tensor keeps its autograd graph); flags stay Python bools,
    and anything else (a probabilistic sequence's tuple, its constraints)
    passes as given."""
    out = {}
    for k, v in values.items():
        if isinstance(v, (bool, np.bool_)):
            out[k] = bool(v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.to(dtype=dtype, device=device)
        elif isinstance(v, (int, float, np.number, np.ndarray)):
            out[k] = torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=device)
        else:
            out[k] = v
    return out


def term_params(energy_fn, energy_fns: list[type], energy_configs: Callable) -> dict:
    """{term class name: its configuration}: the bound parameters of a
    composed ``energy_fn``, or (None) the model's defaults derived in
    float64 on the CPU (``energy_configs(dtype=, device=)``)."""
    if energy_fn is not None:
        return {type(fn).__name__: fn.params for fn in energy_fn.energy_fns}
    configs = energy_configs(dtype=torch.float64, device="cpu")
    return {cls.__name__: cfg.init_params() for cls, cfg in zip(energy_fns, configs, strict=True)}


def unbonded_site_cutoffs(params: dict) -> dict:
    """{term: ((site_a, site_b, bare cutoff), ...)} of the oxDNA-family
    unbonded terms present in ``params`` (term_params): the radial support
    of each site pair a term reads, from its configuration's upper
    cutoffs (excluded volume's four; hydrogen bonding's, cross stacking's
    and coaxial stacking's high cutoffs; Debye-Hueckel's ``r_cut``)."""
    def value(x) -> float:
        return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)

    terms = {}
    if (px := params.get("UnbondedExcludedVolume")) is not None:
        terms["UnbondedExcludedVolume"] = (
            ("base", "base", value(px.dr_c_base)),
            ("back", "base", max(value(px.dr_c_back_base), value(px.dr_c_base_back))),
            ("back", "back", value(px.dr_c_backbone)),
        )
    for name, site, cutoff in (("HydrogenBonding", "base", "dr_c_high_hb"),
                               ("CrossStacking", "base", "dr_c_high_cross"),
                               ("CoaxialStacking", "stack", "dr_c_high_coax"), ("Debye", "back", "r_cut")):
        if (p := params.get(name)) is not None:
            terms[name] = ((site, site, value(getattr(p, cutoff))),)
    return terms


def pair_cutoffs(terms: dict) -> dict[str, float]:
    """{term: its largest site cutoff} of unbonded_site_cutoffs' terms."""
    return {nm: max(c for _, _, c in prs) for nm, prs in terms.items()}
