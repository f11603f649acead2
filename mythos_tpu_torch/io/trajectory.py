"""oxDNA trajectory (.dat) reading and writing.

Counterpart of mythos_tpu/io/trajectory.py: ``NucleotideState`` (one
(N, 15) state: com, a1, a3, velocity, angular momentum; ``to_rigid_body``
through the Tait-Bryan angles of the (a1, a3 x a1, a3) frame),
``Trajectory`` (``to_file``) and ``from_file``, the whole file parsed in
one vectorised numpy pass with the per-strand 5'->3' flip and a fixed-box
check. Like the reference, ``from_file`` tries the native parser
(:mod:`io.native`, the repo's C++ source built with g++ at first use) first
and parses in numpy (:func:`parse_numpy`, the native parser's check) where
it is unavailable.
"""

from __future__ import annotations

import dataclasses as dc
from pathlib import Path
from typing import TextIO

import numpy as np
import torch

from mythos_tpu_torch.rigid_body import RigidBody
from mythos_tpu_torch.utils import devices

N_STATE_COLS = 15

ERR_FILE_NOT_FOUND = "Trajectory file not found: {}"
ERR_N_NUCLEOTIDE_STRAND_LENGTHS = "n_nucleotides and sum(strand_lengths) do not match"
ERR_T_E_S_LENGTHS = "times, energies, and states do not have the same length"
ERR_TIMES_DIMS = "times must be a 1D array"
ERR_ENERGIES_SHAPE = "energies must be a 2D array with shape (n_states, 3)"
ERR_STATE_SHAPE = "Invalid shape for nucleotide states:"
ERR_FIXED_BOX_SIZE = "Only trajectories in a fixed box size are supported"
ERR_MALFORMED = "Malformed trajectory file: {}"


def principal_axes_to_euler_angles(x: np.ndarray, y: np.ndarray, z: np.ndarray):
    """Tait-Bryan (ZYX) Euler angles of the frames whose rotation matrices
    have the columns x, y, z (arctan2 forms)."""
    psi = np.arctan2(x[:, 1], x[:, 0])
    theta = np.arcsin(-np.clip(x[:, 2], -1.0, 1.0))
    phi = np.arctan2(y[:, 2], z[:, 2])
    return psi, theta, phi


def euler_angles_to_quaternion(psi: np.ndarray, theta: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """ZYX Euler angles -> (N, 4) unit quaternions, scalar first."""
    sp, cp = np.sin(0.5 * psi), np.cos(0.5 * psi)
    st, ct = np.sin(0.5 * theta), np.cos(0.5 * theta)
    sf, cf = np.sin(0.5 * phi), np.cos(0.5 * phi)
    return np.stack([
        sp * st * sf + cp * ct * cf,
        -sp * st * cf + sf * cp * ct,
        sp * ct * sf + cp * st * cf,
        sp * ct * cf - cp * st * sf,
    ], axis=-1)


@dc.dataclass(frozen=True)
class NucleotideState:
    """A single (N, 15) state: com, a1, a3, velocity, angular momentum."""

    array: np.ndarray

    def __post_init__(self) -> None:
        if not isinstance(self.array, np.ndarray):
            raise TypeError(ERR_STATE_SHAPE + str(type(self.array)))
        if self.array.ndim != 2 or self.array.shape[1] != N_STATE_COLS:
            raise ValueError(ERR_STATE_SHAPE + str(self.array.shape))

    @property
    def com(self) -> np.ndarray:
        return self.array[:, :3]

    @property
    def back_base_vector(self) -> np.ndarray:
        return self.array[:, 3:6]

    @property
    def base_normal(self) -> np.ndarray:
        return self.array[:, 6:9]

    @property
    def velocity(self) -> np.ndarray:
        return self.array[:, 9:12]

    @property
    def angular_velocity(self) -> np.ndarray:
        return self.array[:, 12:15]

    @property
    def euler_angles(self):
        """Tait-Bryan angles of the (a1, a3 x a1, a3) frame."""
        a1, a3 = self.back_base_vector, self.base_normal
        return principal_axes_to_euler_angles(a1, np.cross(a3, a1), a3)

    @property
    def quaternions(self) -> np.ndarray:
        return euler_angles_to_quaternion(*self.euler_angles)

    def to_rigid_body(self, dtype: torch.dtype = torch.float64, device: torch.device | str = "cuda") -> RigidBody:
        """The state as a RigidBody of ``dtype`` tensors on ``device`` (the
        card unless the caller asks for the CPU)."""
        device = devices.resolve(device)
        return RigidBody(torch.as_tensor(self.com, dtype=dtype, device=device),
                         torch.as_tensor(self.quaternions, dtype=dtype, device=device))


@dc.dataclass(frozen=True)
class Trajectory:
    """A parsed oxDNA trajectory: times (S,), energies (S, 3), states."""

    n_nucleotides: int
    strand_lengths: list[int]
    times: np.ndarray
    energies: np.ndarray
    states: list[NucleotideState]
    box_size: np.ndarray | None = None

    def __post_init__(self) -> None:
        if self.n_nucleotides != sum(self.strand_lengths):
            raise ValueError(ERR_N_NUCLEOTIDE_STRAND_LENGTHS)
        if not isinstance(self.times, np.ndarray):
            raise TypeError("times must be a numpy array")
        if not isinstance(self.energies, np.ndarray):
            raise TypeError("energies must be a numpy array")
        if len(self.times) != len(self.energies) or len(self.times) != len(self.states):
            raise ValueError(ERR_T_E_S_LENGTHS)
        if self.times.ndim != 1:
            raise ValueError(ERR_TIMES_DIMS)
        if self.energies.ndim != 2 or self.energies.shape[1] != 3:
            raise ValueError(ERR_ENERGIES_SHAPE)

    def to_file(self, filepath) -> None:
        """Write in oxDNA text format (box '0 0 0' if unknown), the states in
        their stored order."""
        box = self.box_size if self.box_size is not None else (0, 0, 0)
        with Path(filepath).open("w") as f:
            for i in range(len(self.times)):
                _write_state(f, self.times[i], self.energies[i], self.states[i].array, box)


def validate_box_size(state_box_sizes: np.ndarray) -> None:
    """Require the box to be constant over the trajectory."""
    if not np.all(state_box_sizes == state_box_sizes[0]):
        raise ValueError(ERR_FIXED_BOX_SIZE)


def _strand_order(strand_lengths: list[int]) -> np.ndarray:
    """The index order that reverses each strand in place."""
    starts = np.cumsum([0, *strand_lengths[:-1]])
    return np.concatenate([np.arange(s, s + n)[::-1] for s, n in zip(starts, strand_lengths, strict=True)])


def from_file(path, strand_lengths, *, is_5p_3p: bool = True) -> Trajectory:
    """Parse an oxDNA trajectory file; each state is::

        t = <time>
        b = <bx> <by> <bz>
        E = <e1> <e2> <e3>
        <15 floats> x n_nucleotides

    With ``is_5p_3p`` each strand's nucleotides are flipped to the internal
    3'->5' order. The native parser first, else numpy."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(ERR_FILE_NOT_FOUND.format(path))
    strand_lengths = [int(x) for x in strand_lengths]
    n = sum(strand_lengths)
    from mythos_tpu_torch.io import native

    ts, bs, es, states = native.parse_trajectory(path, n) or parse_numpy(path, n)
    if is_5p_3p:
        states = states[:, _strand_order(strand_lengths)]
    validate_box_size(np.array(bs))
    return Trajectory(
        box_size=np.asarray(bs[0]),
        n_nucleotides=n,
        strand_lengths=strand_lengths,
        times=np.array(ts, dtype=np.float64),
        energies=np.array(es, dtype=np.float64),
        states=[NucleotideState(array=np.ascontiguousarray(s)) for s in states],
    )


def parse_numpy(path, n: int):
    """(times, boxes, energies, (S, n, 15) states) of a file, in one
    vectorised numpy pass."""
    ts, bs, es, rows = [], [], [], []
    for line in path.read_text().splitlines():
        c = line[0] if line else ""
        if c == "t":
            ts.append(float(line.split("=", 1)[1]))
        elif c == "b":
            bs.append(np.array(line.split("=", 1)[1].split(), dtype=np.float64))
        elif c == "E":
            es.append(np.array(line.split("=", 1)[1].split(), dtype=np.float64))
        elif line.strip():
            rows.append(line)
    data = np.array(" ".join(rows).split(), dtype=np.float64)
    if data.size != len(ts) * n * N_STATE_COLS:
        raise ValueError(ERR_MALFORMED.format(path))
    return ts, bs, es, data.reshape(len(ts), n, N_STATE_COLS)


def _write_state(file: TextIO, time: float, energies, state: np.ndarray, box_size=(0, 0, 0)) -> None:
    file.write(f"t = {time}\n")
    file.write(f"b = {box_size[0]} {box_size[1]} {box_size[2]}\n")
    file.write(f"E = {energies[0]} {energies[1]} {energies[2]}\n")
    for nucleotide in state:
        file.write(" ".join(map(str, nucleotide)) + "\n")
