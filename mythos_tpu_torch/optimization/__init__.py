"""DiffTRe fitting (port of mythos_tpu.optimization): objectives and the
simple optimizer loop."""

from mythos_tpu_torch.optimization.objective import (
    DiffTReObjective,
    Objective,
    ObjectiveOutput,
    compute_loss,
    compute_min_segment_neff,
    compute_weights_and_neff,
)
from mythos_tpu_torch.optimization.optimization import (
    Optimizer,
    OptimizerOutput,
    OptimizerState,
    SimpleOptimizer,
)

__all__ = [
    "DiffTReObjective",
    "Objective",
    "ObjectiveOutput",
    "Optimizer",
    "OptimizerOutput",
    "OptimizerState",
    "SimpleOptimizer",
    "compute_loss",
    "compute_min_segment_neff",
    "compute_weights_and_neff",
]
