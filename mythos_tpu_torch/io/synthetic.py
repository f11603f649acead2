"""Synthetic system generators (no input files needed).

Counterpart of mythos_tpu/io/synthetic.py: the same ideal B-/A-form duplex,
optionally bent along a circular arc, built in numpy (float64) and returned
as a torch ``RigidBody``; and ``coax_engaged``, which places pairs of a
state coaxially stacked (an oxRNA2 term that is zero in a duplex) for the
checks of that term.
"""

from __future__ import annotations

import numpy as np
import torch

import mythos_tpu_torch.utils.constants as const
from mythos_tpu_torch.io.topology import Topology, bonded_neighbors_for
from mythos_tpu_torch.rigid_body import RigidBody
from mythos_tpu_torch.utils import devices


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
    bend: float | None = None,
    dtype: torch.dtype = torch.float64,
    device: torch.device | str = "cuda",
) -> tuple[Topology, RigidBody]:
    """Ideal duplex of ``n_bp`` base pairs: (Topology, RigidBody).

    Strand 2 runs antiparallel; ``form`` "B" is B-DNA-like (rise 0.39,
    twist 34.3 deg, radius 0.6), "A" the A-RNA-like helix. ``bend``: total
    bend angle (radians) of the helix axis along a circular arc in the x-z
    plane; the local structure stays ideal while index-distant segments
    approach in space (the block tier's general conformation).
    """
    device = devices.resolve(device)
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
    centers, quats = np.array(centers), np.array(quats)
    if bend:
        # z -> theta = z * bend / L; positions rotate about y by theta
        # (R_y(-theta): x -> (c, 0, s), z -> (-s, 0, c)) and every quaternion
        # is pre-multiplied by the same world rotation (cos(theta/2), 0, -sin(theta/2), 0)
        z = centers[:, 2]
        length = float(z.max() - z.min()) or 1.0
        theta = (z - z.min()) * (float(bend) / length)
        r_c = length / float(bend)
        ct, st = np.cos(theta), np.sin(theta)
        x = centers[:, 0]
        centers = np.stack([(r_c + x) * ct - r_c, centers[:, 1], (r_c + x) * st], axis=1)
        c, s = np.cos(theta / 2), np.sin(theta / 2)
        w, qx, qy, qz = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
        quats = np.stack([c * w + s * qy, c * qx - s * qz, c * qy - s * w, c * qz + s * qx], axis=1)
    body = RigidBody(
        center=torch.as_tensor(centers, dtype=dtype, device=device),
        orientation=torch.as_tensor(quats, dtype=dtype, device=device),
    )
    return topology, body


def coax_engaged(com: np.ndarray, quat: np.ndarray, pairs, seed: int, tries: int = 2000):
    """Copies of (N, 3) centers and (N, 4) quaternions (float64) with body j
    of each pair (i, j) moved so that oxRNA2's (oxDNA1's) coaxial stacking
    of the pair engages -- zero in an ideal duplex, whose stacked bases are
    bonded neighbours. j's frame is i's turned 0.4-0.7 rad about a tilted
    a3 (theta1 near theta0_coax_1, theta4 small), its stacking site
    0.46-0.54 from i's at 0.5-0.9 rad (or its supplement) from a3_i; of
    ``tries`` such random placements (numpy Generator ``seed``) the one of
    the most negative pair energy is kept. Other terms of j are not
    minded: it may clash with its neighbours."""
    import mythos_tpu_torch.energy.rna2 as rna2
    from mythos_tpu_torch.energy.dna1 import geometry as geom
    from mythos_tpu_torch.energy.dna1.terms import coax_product
    from mythos_tpu_torch.simulators.neighbors import _np_frames

    rng = np.random.default_rng(seed)
    p = rna2.default_energy_configs(dtype=torch.float64)[6].init_params()
    sto = rna2.geometry()["com_to_stacking"]
    transform = rna2.default_transform_soa_fn()
    com, quat = np.array(com, np.float64), np.array(quat, np.float64)
    m = tries
    for i, j in pairs:
        a1i, _, a3i = (a[0] for a in _np_frames(quat[i : i + 1]))
        ang = rng.uniform(0.4, 0.7, m)
        axis = a3i + 0.15 * rng.standard_normal((m, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        w1, x1, y1, z1 = np.cos(ang / 2), *(np.sin(ang / 2)[:, None] * axis).T
        w2, x2, y2, z2 = quat[i]
        qj = np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                       w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], 1)
        th = rng.uniform(0.5, 0.9, m) * rng.choice([1.0, -1.0], m)
        perp = np.cross(a3i, rng.standard_normal((m, 3)))
        perp /= np.linalg.norm(perp, axis=1, keepdims=True)
        u = (np.cos(np.abs(th)) * np.sign(th))[:, None] * a3i + np.sin(np.abs(th))[:, None] * perp
        a1j, _, _ = _np_frames(qj)
        cj = com[i] + sto * a1i + rng.uniform(0.46, 0.54, m)[:, None] * u - sto * a1j
        t = torch.as_tensor
        ni = transform(RigidBody(t(np.repeat(com[i][None], m, 0)), t(np.repeat(quat[i][None], m, 0))))
        nj = transform(RigidBody(t(cj), t(qj)))
        v = coax_product(p, geom.coax_geometry_vec(ni.stack, nj.stack, ni.a1, nj.a1, ni.a3, nj.a3,
                                                   back_i=ni.back, back_j=nj.back))
        k = int(torch.argmin(v))
        com[j], quat[j] = cj[k], qj[k]
    return com, quat
