"""Nucleic-acid topology and the oxDNA topology files (classic and new).

Counterpart of mythos_tpu/io/topology.py (``Topology``, ``from_oxdna_file``
with its format sniffing, ``_bonded_neighbors``, ``unbonded_pairs``). The
JAX module imports ``mythos_tpu.utils.types``, which imports jax, so the
port owns this module. ``seq`` is discrete, or a probabilistic sequence
``(up_pseq, bp_pseq)`` (``check_valid_seq``; the energies take one through
their ``pseq`` parameter, io.sequence_constraints).
"""

from __future__ import annotations

import dataclasses as dc
import enum
import itertools
import warnings
from pathlib import Path

import numpy as np
import torch

import mythos_tpu_torch.utils.constants as const
from mythos_tpu_torch.io import trajectory as io_traj
from mythos_tpu_torch.soa import Quat, quat_frame_soa

N_1ST_LINE_OXDNA_CLASSIC = 2
N_1ST_LINE_OXDNA_NEW = 3

ERR_INVALID_NUMBER_NUCLEOTIDES = "Invalid number of nucleotides"
ERR_INVALID_STRAND_COUNTS = "Invalid strand counts"
ERR_STRAND_COUNTS_NOT_MATCH = "Strand counts do not match number of nucleotides"
ERR_BONDED_NEIGHBORS_INVALID_SHAPE = "Invalid bonded neighbors shape"
ERR_INVALID_SEQUENCE_NUCLEOTIDES = "Invalid sequence nucleotides"
ERR_INVALID_DISCRETE_SEQUENCE_SHAPE = "Invalid discrete sequence shape"
ERR_INVALID_UNPAIRED_PSEQ_SHAPE = "Invalid unpaired probabilistic sequence shape"
ERR_MISMATCH_PSEQ_SHAPE = "Pseq shape does not match number of nucleotides"
ERR_INVALID_BP_PSEQ_SHAPE = "Invalid base-paired probabilistic sequence shape"
ERR_INVALID_PROBABILITIES = "Probabilities must be > 0"
ERR_PSEQ_NOT_NORMALIZED = "Probabilities must be normalized"
ERR_INVALID_SEQUENCE_TYPE = "Invalid sequence type. Must be discrete or probabilistic"
ERR_INVALID_OXDNA_FORMAT = (
    "Invalid oxDNA topology format. See "
    "https://lorenzo-rovigatti.github.io/oxDNA/configurations.html#topology-file"
)
ERR_STRAND_COUNTS_CIRCULAR_MISMATCH = "Strand counts and circularity do not match"
ERR_FILE_NOT_FOUND = "Topology file not found"

WARN_UNSPECIFIED_NT_TYPE = "Type of strand {strand_idx} not specified"


class OxDNAFormat(enum.Enum):
    """The two oxDNA topology file formats."""

    CLASSIC = "classic"
    NEW = "new"


class NucleotideType(enum.IntEnum):
    """Nucleotide types (also used per strand)."""

    UNSPECIFIED = 0
    DNA = 1
    RNA = 2


def check_valid_seq(seq, n_nucleotides: int) -> None:
    """Validate a discrete (N,) sequence or a probabilistic one, ``(up_pseq
    (n_unpaired, 4), bp_pseq (n_bp, 4))`` with n_unpaired + 2 n_bp = N,
    non-negative rows summing to 1."""
    if isinstance(seq, tuple) and len(seq) == 2:
        up_pseq, bp_pseq = (np.asarray(torch.as_tensor(x).detach().cpu()) for x in seq)
        if up_pseq.ndim != 2 or up_pseq.shape[1] != const.N_NT:
            raise ValueError(ERR_INVALID_UNPAIRED_PSEQ_SHAPE)
        if bp_pseq.ndim != 2 or bp_pseq.shape[1] != const.N_BP_TYPES:
            raise ValueError(ERR_INVALID_BP_PSEQ_SHAPE)
        if up_pseq.shape[0] + const.N_NT_PER_BP * bp_pseq.shape[0] != n_nucleotides:
            raise ValueError(ERR_MISMATCH_PSEQ_SHAPE)
        if (up_pseq < 0).any() or (bp_pseq < 0).any():
            raise ValueError(ERR_INVALID_PROBABILITIES)
        if not np.allclose(up_pseq.sum(axis=1), 1) or not np.allclose(bp_pseq.sum(axis=1), 1):
            raise ValueError(ERR_PSEQ_NOT_NORMALIZED)
    elif hasattr(seq, "shape"):
        arr = np.asarray(seq)
        if arr.ndim != 1:  # the shape first: a 2-D array's rows are unhashable
            raise ValueError(ERR_INVALID_DISCRETE_SEQUENCE_SHAPE)
        if set(arr.tolist()) - {0, 1, 2, 3}:
            raise ValueError(ERR_INVALID_SEQUENCE_NUCLEOTIDES)
        if arr.shape != (n_nucleotides,):
            raise ValueError(ERR_INVALID_DISCRETE_SEQUENCE_SHAPE)
    else:
        raise ValueError(ERR_INVALID_SEQUENCE_TYPE)


@dc.dataclass(frozen=True)
class Topology:
    """Connectivity and sequence of a nucleic-acid system.

    ``bonded_neighbors``: (B, 2) int pairs (i 3'-side, j 5'-side).
    ``seq``: discrete (N,) int array or a probabilistic sequence tuple
    (``check_valid_seq``). ``is_end``: (N,) 1 at the termini of
    non-circular strands. ``nt_type``: (N,) NucleotideType values where a
    file gave them. ``unbonded_neighbors`` (all i<j pairs minus bonded)
    derives lazily, once.
    """

    n_nucleotides: int
    strand_counts: np.ndarray
    bonded_neighbors: np.ndarray
    seq: np.ndarray | tuple
    is_end: np.ndarray
    nt_type: np.ndarray | None = None

    def __post_init__(self) -> None:
        if self.n_nucleotides < 1:
            raise ValueError(ERR_INVALID_NUMBER_NUCLEOTIDES)
        if len(self.strand_counts) == 0 or int(np.sum(self.strand_counts)) == 0:
            raise ValueError(ERR_INVALID_STRAND_COUNTS)
        if self.n_nucleotides != int(np.sum(self.strand_counts)):
            raise ValueError(ERR_STRAND_COUNTS_NOT_MATCH)
        if self.bonded_neighbors.ndim != 2 or self.bonded_neighbors.shape[1] != 2:
            raise ValueError(ERR_BONDED_NEIGHBORS_INVALID_SHAPE)
        check_valid_seq(self.seq, self.n_nucleotides)

    @property
    def unbonded_neighbors(self) -> np.ndarray:
        """(U, 2) all i<j pairs minus bonded (O(N^2): small systems only),
        derived on first use and kept."""
        if "_unbonded" not in self.__dict__:
            object.__setattr__(self, "_unbonded", unbonded_pairs(self.n_nucleotides, self.bonded_neighbors))
        return self.__dict__["_unbonded"]


def bonded_neighbors_for(strand_lengths: list[int], is_circular: list[bool]) -> np.ndarray:
    """Consecutive-index bonds per strand; a circular strand closes its loop
    with (last, first), keeping the (3'-side, 5'-side) order."""
    if len(strand_lengths) != len(is_circular):
        raise ValueError(ERR_STRAND_COUNTS_CIRCULAR_MISMATCH)
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


def from_oxdna_file(path, *, return_format: bool = False):
    """Read a topology from either oxDNA file format, sniffed from the
    number of fields on line 1 (2: classic, 3: new); with ``return_format``
    also the OxDNAFormat."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(ERR_FILE_NOT_FOUND)
    lines = path.read_text().splitlines()
    tokens = lines[0].strip().split()
    if len(tokens) == N_1ST_LINE_OXDNA_CLASSIC:
        fmt, top = OxDNAFormat.CLASSIC, _from_lines_classic(lines)
    elif len(tokens) == N_1ST_LINE_OXDNA_NEW:
        fmt, top = OxDNAFormat.NEW, _from_lines_new(lines)
    else:
        raise ValueError(ERR_INVALID_OXDNA_FORMAT)
    return (top, fmt) if return_format else top


def to_oxdna_files(directory, topology: Topology, body, new_format: bool = False) -> tuple[Path, Path]:
    """Write ``topology`` and one state ``body`` (float64 rigid body, box
    50) as oxDNA files ``sys.top`` and ``init.conf`` in ``directory``; give
    their paths. The classic topology keeps each strand 3'->5', as the port
    does; the new one lists each strand 5'->3', and the state's strands are
    reversed to match."""
    directory = Path(directory)
    a1, _, a3 = (torch.stack(tuple(v), -1) for v in quat_frame_soa(Quat(*body.orientation.unbind(-1))))
    nt, counts = topology.n_nucleotides, [int(c) for c in topology.strand_counts]
    bases = "".join("ACGT"[int(b)] for b in topology.seq)
    starts = np.cumsum([0, *counts[:-1]])
    if new_format:
        lines = [f"{nt} {len(counts)} 5->3"]
        lines += [f"{bases[s0:s0 + n][::-1]} type=DNA circular=false" for s0, n in zip(starts, counts, strict=True)]
    else:
        lines = [f"{nt} {len(counts)}"]
        for sid, (s0, n) in enumerate(zip(starts, counts, strict=True), start=1):
            lines += [f"{sid} {bases[s0 + k]} {s0 + k - 1 if k > 0 else -1} {s0 + k + 1 if k < n - 1 else -1}"
                      for k in range(n)]
    (directory / "sys.top").write_text("\n".join(lines) + "\n")
    conf = torch.cat([body.center, a1, a3, torch.zeros((nt, 6), dtype=torch.float64)], dim=1).numpy()
    if new_format:
        conf = conf[io_traj._strand_order(counts)]
    io_traj.Trajectory(n_nucleotides=nt, strand_lengths=counts, times=np.zeros(1), energies=np.zeros((1, 3)),
                       states=[io_traj.NucleotideState(np.ascontiguousarray(conf))],
                       box_size=np.array([50.0, 50.0, 50.0])).to_file(directory / "init.conf")
    return directory / "sys.top", directory / "init.conf"


def _strand_ends_and_type(nucleotides: str, circ: bool) -> tuple[list[int], NucleotideType]:
    is_end = [0] * len(nucleotides)
    if not circ:
        is_end[0] = 1
        is_end[-1] = 1
    if "T" in nucleotides:
        nt_type = NucleotideType.DNA
    elif "U" in nucleotides:
        nt_type = NucleotideType.RNA
    else:
        nt_type = NucleotideType.UNSPECIFIED
    return is_end, nt_type


def _from_lines_classic(lines: list[str]) -> Topology:
    """Classic 4-column format: strand id, base, 3' and 5' neighbours, one
    line a nucleotide, each strand 3'->5'."""
    n_nucleotides, n_strands = map(int, lines[0].strip().split())
    rows = [line.strip().split() for line in lines[1 : 1 + n_nucleotides]]
    strand_ids = np.array([int(r[0]) for r in rows])
    bases = [r[1] for r in rows]
    neighbor_5p = np.array([int(r[3]) for r in rows])
    _, strand_counts = np.unique(strand_ids, return_counts=True)

    sequence, is_circular, is_end, nt_type = [], [], [], []
    for sid in range(1, n_strands + 1):
        idxs = np.where(strand_ids == sid)[0]
        strand_bases = "".join(bases[i] for i in idxs)
        circ = bool(neighbor_5p[idxs[-1]] != -1)
        is_circular.append(circ)
        sequence.append(strand_bases)
        ends, stype = _strand_ends_and_type(strand_bases, circ)
        if stype == NucleotideType.UNSPECIFIED:
            warnings.warn(WARN_UNSPECIFIED_NT_TYPE.format(strand_idx=sid), stacklevel=2)
        is_end.extend(ends)
        nt_type.extend([stype] * len(strand_bases))
    return _assemble(n_nucleotides, strand_counts, "".join(sequence), is_circular, is_end, nt_type)


def _from_lines_new(lines: list[str]) -> Topology:
    """New format: one line a strand, its sequence 5'->3' with k=v options
    (stored 3'->5')."""
    n_nucleotides = int(lines[0].strip().split()[0])
    sequence, strand_counts, is_circular, is_end, nt_type = [], [], [], [], []
    for line in lines[1:]:
        if not line.strip():
            continue
        nucleotides = line.strip().split()[0]
        sequence.append(nucleotides[::-1])
        strand_counts.append(len(nucleotides))
        circ = "circular=true" in line.lower()
        is_circular.append(circ)
        ends, _ = _strand_ends_and_type(nucleotides, circ)
        is_end.extend(ends)
        if "type=DNA" in line:
            stype = NucleotideType.DNA
        elif "type=RNA" in line:
            stype = NucleotideType.RNA
        else:
            warnings.warn(WARN_UNSPECIFIED_NT_TYPE.format(strand_idx=line), stacklevel=2)
            stype = NucleotideType.UNSPECIFIED
        nt_type.extend([stype] * len(nucleotides))
    return _assemble(n_nucleotides, np.array(strand_counts), "".join(sequence), is_circular, is_end, nt_type)


def _assemble(n_nucleotides, strand_counts, sequence: str, is_circular, is_end, nt_type) -> Topology:
    return Topology(
        n_nucleotides=n_nucleotides,
        strand_counts=np.asarray(strand_counts),
        bonded_neighbors=bonded_neighbors_for([int(c) for c in strand_counts], is_circular),
        seq=np.array([const.NUCLEOTIDES_IDX[s] for s in sequence], dtype=np.int32),
        is_end=np.array(is_end, dtype=np.int32),
        nt_type=np.array(nt_type, dtype=np.int32),
    )
