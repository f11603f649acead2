"""Nucleic-acid topology: the fields the ported main path reads.

Counterpart of mythos_tpu/io/topology.py (``Topology``, ``_bonded_neighbors``,
``unbonded_pairs``). The JAX module imports ``mythos_tpu.utils.types``,
which imports jax, so the port owns this container. File parsers are not
ported yet.
"""

from __future__ import annotations

import dataclasses as dc
import itertools

import numpy as np

ERR_INVALID_NUMBER_NUCLEOTIDES = "Invalid number of nucleotides"
ERR_STRAND_COUNTS_NOT_MATCH = "Strand counts do not match number of nucleotides"
ERR_BONDED_NEIGHBORS_INVALID_SHAPE = "Invalid bonded neighbors shape"


@dc.dataclass(frozen=True)
class Topology:
    """Connectivity and sequence of a nucleic-acid system.

    ``bonded_neighbors``: (B, 2) int pairs (i 3'-side, j 5'-side).
    ``seq``: discrete (N,) int array. ``is_end``: (N,) 1 at strand termini.
    ``unbonded_neighbors`` (all i<j pairs minus bonded) derives lazily.
    """

    n_nucleotides: int
    strand_counts: np.ndarray
    bonded_neighbors: np.ndarray
    seq: np.ndarray
    is_end: np.ndarray

    def __post_init__(self) -> None:
        if self.n_nucleotides < 1:
            raise ValueError(ERR_INVALID_NUMBER_NUCLEOTIDES)
        if self.n_nucleotides != int(np.sum(self.strand_counts)):
            raise ValueError(ERR_STRAND_COUNTS_NOT_MATCH)
        if self.bonded_neighbors.ndim != 2 or self.bonded_neighbors.shape[1] != 2:
            raise ValueError(ERR_BONDED_NEIGHBORS_INVALID_SHAPE)

    @property
    def unbonded_neighbors(self) -> np.ndarray:
        """(U, 2) all i<j pairs minus bonded (O(N^2): small systems only)."""
        return unbonded_pairs(self.n_nucleotides, self.bonded_neighbors)


def bonded_neighbors_for(strand_lengths: list[int], is_circular: list[bool]) -> np.ndarray:
    """Consecutive-index bonds per strand; circular strands close the loop."""
    pairs: list[tuple[int, int]] = []
    start = 0
    for length, circ in zip(strand_lengths, is_circular, strict=True):
        pairs.extend(itertools.pairwise(range(start, start + length)))
        if circ:
            pairs.append((start + length - 1, start))
        start += length
    return np.array(pairs, dtype=np.int32)


def unbonded_pairs(n: int, bonded: np.ndarray) -> np.ndarray:
    """(U, 2) array of all i<j pairs excluding bonded pairs."""
    iu, ju = np.triu_indices(n, k=1)
    lo = np.minimum(bonded[:, 0], bonded[:, 1]).astype(np.int64)
    hi = np.maximum(bonded[:, 0], bonded[:, 1]).astype(np.int64)
    keep = ~np.isin(iu.astype(np.int64) * n + ju, lo * n + hi)
    return np.stack([iu[keep], ju[keep]], axis=1).astype(np.int32)
