"""Sequence-dependent weight tables, and their expectation under a
probabilistic sequence (sequence design).

Counterpart of mythos_tpu/energy/seqdep.py and of the sequence-averaged
tables of mythos_tpu/energy/dna1/terms.py. A probabilistic sequence (pseq)
is ``(up_pseq (n_unpaired, 4), bp_pseq (n_bp, 4))`` under a
``io.sequence_constraints.SequenceConstraints``. The expected weight of a
pair (i, j) is E[W[s_i, s_j]]. Unless i and j form one constrained base
pair, s_i and s_j are independent, so the expectation is the bilinear form
m_i W m_j of the per-nucleotide marginals m (:func:`nucleotide_marginals`);
for the two members of a base pair it sums over the pair's types
(:func:`pair_weights`). :func:`factorized_weights` writes it as the
discrete paths' one-hot form with marginals in place of one-hots plus a
correction on each base pair's partner -- the form the tile and stencil
kernels read. Every function is differentiable in both pseq arrays and
the table.
"""

from __future__ import annotations

import numpy as np
import torch

import mythos_tpu_torch.utils.constants as const

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


def _arrays(pseq) -> tuple[torch.Tensor, torch.Tensor]:
    """The pseq's two arrays as tensors, an empty one given one zero row so
    that the gathers stay in range (its rows are masked)."""
    up, bp = (torch.as_tensor(x) for x in pseq)
    dtype = torch.promote_types(up.dtype, bp.dtype)
    up, bp = up.to(dtype=dtype, device=bp.device), bp.to(dtype)
    if up.shape[0] == 0:
        up = torch.zeros((1, const.N_NT), dtype=dtype, device=bp.device)
    if bp.shape[0] == 0:
        bp = torch.zeros((1, const.N_BP_TYPES), dtype=dtype, device=bp.device)
    return up, bp


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device).long()


def nucleotide_marginals(pseq, sc) -> torch.Tensor:
    """(N, 4) per-nucleotide marginal base distributions."""
    up, bp = _arrays(pseq)
    dev = bp.device
    is_unpaired = torch.as_tensor(np.asarray(sc.is_unpaired) != 0, device=dev)
    idx_up = _index(np.clip(sc.idx_to_unpaired_idx, 0, up.shape[0] - 1), dev)
    idx_bp = np.asarray(sc.idx_to_bp_idx)
    # base-pair type -> nucleotide one-hots for each place in the pair: (2, 4 types, 4 nt)
    onehot = torch.eye(const.N_NT, dtype=bp.dtype, device=dev)
    bp_idxs = _index(const.BP_IDXS, dev)
    bp_to_nt = torch.stack([onehot[bp_idxs[:, 0]], onehot[bp_idxs[:, 1]]])
    beta = bp[_index(np.clip(idx_bp[:, 0], 0, bp.shape[0] - 1), dev)]
    paired = torch.einsum("nt,nta->na", beta, bp_to_nt[_index(np.clip(idx_bp[:, 1], 0, 1), dev)])
    return torch.where(is_unpaired[:, None], up[idx_up], paired)


def pair_weights(pseq, op_i, op_j, table: torch.Tensor, sc, marginals: torch.Tensor | None = None) -> torch.Tensor:
    """(P,) expected weights E[table[s_i, s_j]] of the index pairs (op_i,
    op_j) (numpy or tensors; out-of-range indices are clipped, for the
    caller to mask)."""
    _, bp = _arrays(pseq)
    dev = bp.device
    marginals = nucleotide_marginals(pseq, sc) if marginals is None else marginals
    n = sc.n_nucleotides
    oi = np.clip(np.asarray(torch.as_tensor(op_i).cpu()), 0, n - 1)
    oj = np.clip(np.asarray(torch.as_tensor(op_j).cpu()), 0, n - 1)
    table = table.to(marginals.dtype)
    w_ind = ((marginals[_index(oi, dev)] @ table) * marginals[_index(oj, dev)]).sum(-1)
    # same base pair: sum over the 4 types of beta[t] * table[nt(t, k_i), nt(t, k_j)]
    idx_bp, unp = np.asarray(sc.idx_to_bp_idx), np.asarray(sc.is_unpaired)
    bp_i, k_i = idx_bp[oi, 0], np.clip(idx_bp[oi, 1], 0, 1)
    bp_j, k_j = idx_bp[oj, 0], np.clip(idx_bp[oj, 1], 0, 1)
    bp_idxs_t = np.asarray(const.BP_IDXS).T  # (2 places, 4 types)
    w_same = (bp[_index(np.clip(bp_i, 0, bp.shape[0] - 1), dev)]
              * table[_index(bp_idxs_t[k_i], dev), _index(bp_idxs_t[k_j], dev)]).sum(-1)
    same = torch.as_tensor((bp_i == bp_j) & (unp[oi] == 0) & (unp[oj] == 0), device=dev)
    return torch.where(same, w_same, w_ind)


def factorized_weights(pseq, table: torch.Tensor, sc, marginals: torch.Tensor | None = None):
    """``(left (N, 4), right (N, 4), partner (N,) numpy, corr (N,))`` with,
    for every i != j::

        E[table[s_i, s_j]] == left[i] @ right[j] + (j == partner[i]) * corr[i]

    ``left = M @ table``, ``right = M`` (M the marginals): the discrete
    paths' one-hot form with marginals; ``partner`` each nucleotide's
    base-pair partner (itself when unpaired, so that the correction never
    fires on i != j), ``corr`` the exact weight less the factorized one on
    that partner."""
    marginals = nucleotide_marginals(pseq, sc) if marginals is None else marginals
    table = table.to(marginals.dtype)
    left = marginals @ table
    partner = sc.partners()
    idx = np.arange(sc.n_nucleotides)
    exact = pair_weights(pseq, idx, partner, table, sc, marginals=marginals)
    w_ind = (left * marginals[_index(partner, marginals.device)]).sum(-1)
    paired = torch.as_tensor(partner != idx, device=marginals.device)
    corr = torch.where(paired, exact - w_ind, torch.zeros_like(w_ind))
    return left, marginals, partner, corr
