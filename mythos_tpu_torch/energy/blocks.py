"""Host-side tables of the block-sparse tile path.

Counterpart of ``bonded_partner_table`` in mythos_tpu/energy/blocks.py. The
XLA block-pair sums of that module are not ported: the port's tile path is
the kernels of ops/tiles.py and their plain versions.
"""

from __future__ import annotations

import numpy as np


def bonded_partner_table(n_pad: int, bonded_neighbors) -> tuple[np.ndarray, np.ndarray]:
    """Per-row 3'/5' bonded-partner indices (-1 where absent), (n_pad,) int32.

    Every nucleotide has at most two backbone bonds, so two rows encode the
    whole exclusion structure of the tile masks without an (N, N) mask.
    """
    bn = np.asarray(bonded_neighbors, np.int64).reshape(-1, 2)
    prev = np.full((n_pad,), -1, np.int32)
    nxt = np.full((n_pad,), -1, np.int32)
    prev[bn[:, 0]] = bn[:, 1]
    nxt[bn[:, 1]] = bn[:, 0]
    return prev, nxt
