"""Synthetic system generators (no input files needed).

Counterpart of mythos_tpu/io/synthetic.py: the same ideal B-/A-form duplex,
built in numpy (float64) and returned as a torch ``RigidBody``.
"""

from __future__ import annotations

import numpy as np
import torch

import mythos_tpu_torch.utils.constants as const
from mythos_tpu_torch.io.topology import Topology, bonded_neighbors_for
from mythos_tpu_torch.rigid_body import RigidBody


def _frame_to_quat(a1: np.ndarray, a3: np.ndarray) -> np.ndarray:
    """Shepperd's method on the frame columns (a1, a3 x a1, a3)."""
    a2 = np.cross(a3, a1)
    m = np.stack([a1, a2, a3], axis=1)
    t = m[0, 0] + m[1, 1] + m[2, 2]
    if t > max(m[0, 0], m[1, 1], m[2, 2]):
        r = np.sqrt(1.0 + t)
        s = 0.5 / r
        q = np.array(
            [0.5 * r, (m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s, (m[1, 0] - m[0, 1]) * s]
        )
    else:
        i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        r = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        s = 0.5 / r
        xyz = np.empty(3)
        xyz[i] = 0.5 * r
        xyz[j] = (m[j, i] + m[i, j]) * s
        xyz[k] = (m[k, i] + m[i, k]) * s
        q = np.array([(m[k, j] - m[j, k]) * s, *xyz])
    return q / np.linalg.norm(q)


def synthetic_duplex(
    n_bp: int = 8,
    form: str = "B",
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cpu",
) -> tuple[Topology, RigidBody]:
    """Ideal duplex of ``n_bp`` base pairs: (Topology, RigidBody).

    Strand 2 runs antiparallel; ``form`` "B" is B-DNA-like (rise 0.39,
    twist 34.3 deg, radius 0.6), "A" the A-RNA-like helix.
    """
    n = 2 * n_bp
    seq = "ACGT" * (n_bp // 4 + 1)
    s1 = seq[:n_bp]
    comp = {"A": "T", "T": "A", "C": "G", "G": "C"}
    s2 = "".join(comp[c] for c in s1)[::-1]
    is_end = np.zeros(n, np.int32)
    for idx in (0, n_bp - 1, n_bp, n - 1):
        is_end[idx] = 1
    topology = Topology(
        n_nucleotides=n,
        strand_counts=np.array([n_bp, n_bp]),
        bonded_neighbors=bonded_neighbors_for([n_bp, n_bp], [False, False]),
        seq=np.array([const.NUCLEOTIDES_IDX[c] for c in s1 + s2], dtype=np.int32),
        is_end=is_end,
    )
    if form == "A":
        rise, twist, radius = 0.411, np.deg2rad(32.73), 0.628
    else:
        rise, twist, radius = 0.39, np.deg2rad(34.3), 0.6
    centers, quats = [], []
    for strand in range(2):
        for k in range(n_bp):
            i = k if strand == 0 else n_bp - 1 - k
            phi = i * twist + strand * np.pi
            a1 = -np.array([np.cos(phi), np.sin(phi), 0.0])
            a3 = np.array([0.0, 0.0, 1.0]) * (1 if strand == 0 else -1)
            centers.append(np.array([-radius * a1[0], -radius * a1[1], i * rise]))
            quats.append(_frame_to_quat(a1, a3))
    body = RigidBody(
        center=torch.as_tensor(np.array(centers), dtype=dtype, device=device),
        orientation=torch.as_tensor(np.array(quats), dtype=dtype, device=device),
    )
    return topology, body
