"""Observables of trajectories (port of mythos_tpu.observables)."""

from mythos_tpu_torch.observables.membranes import AreaPerLipid, MembraneThickness
from mythos_tpu_torch.observables.propeller import PropellerTwist

__all__ = ["AreaPerLipid", "MembraneThickness", "PropellerTwist"]
