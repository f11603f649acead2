"""Sequence-dependent weight tables (discrete sequences).

Counterpart of the table half of mythos_tpu/energy/seqdep.py and the
sequence-averaged tables of mythos_tpu/energy/dna1/terms.py. Probabilistic
sequences (pseq) are not ported yet: the stencil main path refuses them
(``ops.stencil.ERR_MS_PSEQ``).
"""

from __future__ import annotations

import numpy as np

#: sequence-averaged stacking weights (uniform)
STACK_WEIGHTS_SA = np.ones((4, 4))

#: sequence-averaged HB weights: Watson-Crick complementarity mask (A-T, C-G)
HB_WEIGHTS_SA = np.array(
    [
        [0.0, 0.0, 0.0, 1.0],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [1.0, 0.0, 0.0, 0.0],
    ]
)
