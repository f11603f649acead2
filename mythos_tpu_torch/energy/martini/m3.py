"""MARTINI 3 terms: reuses MARTINI 2 with a harmonic (non-G96) angle.

Counterpart of mythos_tpu/energy/martini/m3.py.
"""

from mythos_tpu_torch.energy.martini.m2 import Angle as Martini2Angle
from mythos_tpu_torch.energy.martini.m2 import AngleConfiguration, Bond, BondConfiguration


class Angle(Martini2Angle):
    """Plain harmonic angle (MARTINI 3)."""

    use_G96 = False  # noqa: N815 - GROMACS naming


__all__ = ["Angle", "AngleConfiguration", "Bond", "BondConfiguration"]
