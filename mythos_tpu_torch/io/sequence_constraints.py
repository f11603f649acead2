"""Sequence constraints of a probabilistic sequence (sequence design).

Counterpart of mythos_tpu/io/sequence_constraints.py, in numpy alone (the
JAX module imports chex). A :class:`SequenceConstraints` splits the
nucleotides into unpaired positions and base pairs, with the index maps
that ``energy.seqdep`` reads. A probabilistic sequence is the tuple
``(up_pseq (n_unpaired, 4), bp_pseq (n_bp, 4))``: a distribution over the
bases of each unpaired nucleotide and over the base-pair types
(``utils.constants.BP_TYPES``) of each pair.
"""

from __future__ import annotations

import dataclasses as dc

import numpy as np

import mythos_tpu_torch.utils.constants as const

ERR_INVALID_N = "Invalid number of nucleotides"
ERR_INVALID_BP_SHAPE = "Invalid shape for base pairs"
ERR_BP_DUPLICATES = "Array specifying base paired indices cannot contain duplicates"
ERR_BP_RANGE = "Base paired indices must be between 0 and n_nucleotides-1"
ERR_COVER = "Unpaired and coupled nucleotides do not cover all nucleotides"
ERR_COUNTS = (
    "Number of nucleotides should equal the number of unpaired base pairs plus "
    "the number of coupled base pairs"
)
ERR_INVALID_BP = "Invalid base pair encountered when converting discrete sequence to probabilistic sequence"


@dc.dataclass(frozen=True)
class SequenceConstraints:
    """Partition of the nucleotides into unpaired positions and base pairs.

    ``is_unpaired`` (N,) 0/1; ``unpaired`` (n_unpaired,) indices; ``bps``
    (n_bp, 2) nucleotide pairs; ``idx_to_unpaired_idx`` (N,) row of
    ``up_pseq`` (-1 if paired); ``idx_to_bp_idx`` (N, 2) (row of
    ``bp_pseq``, place in the pair) (-1s if unpaired).
    """

    n_nucleotides: int
    n_unpaired: int
    n_bp: int
    is_unpaired: np.ndarray
    unpaired: np.ndarray
    bps: np.ndarray
    idx_to_unpaired_idx: np.ndarray
    idx_to_bp_idx: np.ndarray

    def __post_init__(self) -> None:
        if self.n_nucleotides < 1:
            raise ValueError(ERR_INVALID_N)
        bps = np.asarray(self.bps).reshape(-1, 2) if self.n_bp else np.zeros((0, 2), int)
        if self.n_unpaired + 2 * self.n_bp != self.n_nucleotides:
            raise ValueError(ERR_COUNTS)
        covered = set(np.concatenate([np.asarray(self.unpaired), bps.flatten()]).astype(int).tolist())
        if covered != set(range(self.n_nucleotides)):
            raise ValueError(ERR_COVER)

    def partners(self) -> np.ndarray:
        """(N,) each nucleotide's base-pair partner, itself when unpaired."""
        out = np.arange(self.n_nucleotides)
        bps = np.asarray(self.bps).reshape(-1, 2).astype(int)
        out[bps[:, 0]], out[bps[:, 1]] = bps[:, 1], bps[:, 0]
        return out


def from_bps(n_nucleotides: int, bps) -> SequenceConstraints:
    """Constraints from an (n_bp, 2) base-pair array; the rest is unpaired."""
    bps = np.asarray(bps)
    if bps.ndim != 2 or bps.shape[1] != const.N_NT_PER_BP or 2 * bps.shape[0] > n_nucleotides:
        raise ValueError(ERR_INVALID_BP_SHAPE)
    paired = bps.flatten()
    if len(np.unique(paired)) < len(paired):
        raise ValueError(ERR_BP_DUPLICATES)
    if not np.all((paired >= 0) & (paired < n_nucleotides)):
        raise ValueError(ERR_BP_RANGE)
    unpaired = np.setdiff1d(np.arange(n_nucleotides), paired)
    idx_to_unpaired_idx = np.full((n_nucleotides,), -1, dtype=np.int32)
    idx_to_unpaired_idx[unpaired] = np.arange(len(unpaired), dtype=np.int32)
    idx_to_bp_idx = np.full((n_nucleotides, 2), -1, dtype=np.int32)
    for bp_idx, (nt1, nt2) in enumerate(bps):
        idx_to_bp_idx[nt1] = [bp_idx, 0]
        idx_to_bp_idx[nt2] = [bp_idx, 1]
    is_unpaired = np.zeros(n_nucleotides, dtype=np.int32)
    is_unpaired[unpaired] = 1
    return SequenceConstraints(
        n_nucleotides=n_nucleotides, n_unpaired=len(unpaired), n_bp=bps.shape[0], is_unpaired=is_unpaired,
        unpaired=unpaired, bps=bps, idx_to_unpaired_idx=idx_to_unpaired_idx, idx_to_bp_idx=idx_to_bp_idx,
    )


def dseq_to_pseq(dseq, sc: SequenceConstraints) -> tuple[np.ndarray, np.ndarray]:
    """One-hot a discrete sequence into a probabilistic one (float64). With
    no base pair, ``bp_pseq`` gets one dummy row, so that its gathers stay
    in range."""
    dseq = np.asarray(dseq)
    up_pseq = np.zeros((sc.n_unpaired, const.N_NT), dtype=np.float64)
    for up_idx, idx in enumerate(np.asarray(sc.unpaired)):
        up_pseq[up_idx, dseq[idx]] = 1.0
    bp_pseq = np.zeros((max(sc.n_bp, 1), const.N_BP_TYPES), dtype=np.float64)
    for bp_idx, (i, j) in enumerate(np.asarray(sc.bps).reshape(-1, 2)):
        key = (int(dseq[i]), int(dseq[j]))
        if key not in const.BP_IDX_MAP:
            raise ValueError(ERR_INVALID_BP)
        bp_pseq[bp_idx, const.BP_IDX_MAP[key]] = 1.0
    return up_pseq, bp_pseq
