"""oxDNA ``input`` files: ``key = value`` lines with nested ``{}`` blocks.

Counterpart of mythos_tpu/io/oxdna_input.py: ``read``, ``write``/``write_to``,
``read_box_size`` and ``read_input_dir`` (topology, kT and box of an oxDNA
input directory).
"""

from __future__ import annotations

import dataclasses as dc
import typing
from pathlib import Path

import numpy as np

from mythos_tpu_torch.io import topology as _topology
from mythos_tpu_torch.utils.units import get_kt_from_string

INVALID_DICT_LINE = "Invalid dictionary line: {}"

Value = typing.Union[str, float, int, bool, dict]


def _parse_value(value: str) -> Value:
    value = value.split("#", maxsplit=1)[0].strip()
    for caster in (int, float):
        try:
            return caster(value)
        except ValueError:
            continue
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    return value


def _parse_dict(in_line: str, lines: typing.Iterator[str]) -> tuple[tuple[str, dict], typing.Iterator[str]]:
    if "=" not in in_line and "{" not in in_line:
        raise ValueError(INVALID_DICT_LINE.format(in_line))
    var_name = in_line.split("=", maxsplit=1)[0].strip()
    parsed: dict = {}
    for line in lines:
        if "{" not in line and "}" not in line:
            key, value = (v.strip() for v in line.split("="))
            parsed[key] = _parse_value(value)
        elif "{" in line:
            (key, value), lines = _parse_dict(line, lines)
            parsed[key] = value
        else:  # closing brace
            break
    return (var_name, parsed), lines


def read(input_file) -> dict[str, Value]:
    """Parse an oxDNA input file into a (possibly nested) dict; ints, floats
    and booleans are typed, the rest stays text (comments dropped)."""
    with Path(input_file).open("r") as f:
        lines = iter([ln for ln in f.readlines() if ln.strip() and not ln.strip().startswith("#")])
    parsed: dict[str, Value] = {}
    for line in lines:
        if "{" in line:
            (key, value), lines = _parse_dict(line, lines)
        else:
            key, str_value = (v.strip() for v in line.split("="))
            value = _parse_value(str_value)
        parsed[key] = value
    return parsed


def write_to(input_config: dict, f: typing.TextIO) -> None:
    """Serialize a config dict in oxDNA input format (a float ``T`` in K)."""
    for key, value in input_config.items():
        if isinstance(value, dict):
            f.write(f"{key} = {{\n")
            write_to(value, f)
            f.write("}\n")
        else:
            if key == "T" and isinstance(value, float):
                parsed = f"{value}K"
            elif isinstance(value, bool):
                parsed = str(value).lower()
            else:
                parsed = str(value)
            f.write(f"{key} = {parsed}\n")


def write(input_config: dict, input_file) -> None:
    """Write an oxDNA input file."""
    with Path(input_file).open("w") as f:
        write_to(input_config, f)


def read_box_size(conf_file) -> np.ndarray:
    """Box dimensions from the ``b = ...`` header of a configuration file."""
    with Path(conf_file).open("r") as f:
        for line in f:
            if line.startswith("b ="):
                return np.array([float(v) for v in line.split("=")[1].strip().split()])
    raise ValueError(f"No 'b = ...' line found in {conf_file}")


@dc.dataclass
class OxDNAInputData:
    """Topology, kT, box size and the raw config of an input directory."""

    topology: _topology.Topology
    kT: float  # noqa: N815 - domain casing
    box_size: np.ndarray
    config: dict[str, typing.Any]


def read_input_dir(input_dir, input_file: str = "input") -> OxDNAInputData:
    """Load an oxDNA input directory's topology, temperature and box."""
    input_dir = Path(input_dir)
    config = read(input_dir / input_file)
    top = _topology.from_oxdna_file(input_dir / config.get("topology", "sys.top"))
    kt = get_kt_from_string(str(config["T"]))
    box_size = read_box_size(input_dir / config["conf_file"])
    return OxDNAInputData(topology=top, kT=kt, box_size=box_size, config=config)
