"""oxDNA reduced-unit conversions.

Counterpart of mythos_tpu/utils/units.py: one length unit = 8.518 angstrom
and kT(300 K) = 0.1 in simulation energy units.
"""

from __future__ import annotations

ANGSTROMS_PER_OXDNA_LENGTH = 8.518
ANGSTROMS_PER_NM = 10
NM_PER_OXDNA_LENGTH = ANGSTROMS_PER_OXDNA_LENGTH / ANGSTROMS_PER_NM
PN_PER_OXDNA_FORCE = 48.63
JOULES_PER_OXDNA_ENERGY = 4.142e-20


def get_kt(t_kelvin):
    """Temperature in Kelvin -> kT in simulation units."""
    return 0.1 * t_kelvin / 300.0


def get_kt_from_c(t_celsius):
    """Temperature in Celsius -> kT in simulation units."""
    return get_kt(t_celsius + 273.15)


def get_kt_from_string(temp_str: str) -> float:
    """Parse a temperature string like '300K' or '27C' into simulation kT."""
    if temp_str.endswith("K"):
        return get_kt(float(temp_str[:-1]))
    if temp_str.endswith("C"):
        return get_kt_from_c(float(temp_str[:-1]))
    raise ValueError(f"Invalid temperature string: {temp_str}")


def from_kt(kt):
    """kT in simulation units -> temperature in Kelvin."""
    return 300.0 * kt / 0.1
