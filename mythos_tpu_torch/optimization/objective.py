"""DiffTRe reweighting math.

Counterpart of ``compute_weights_and_neff`` and the neighbor-overflow
refusal of mythos_tpu/optimization/objective.py (Thaler & Zavadlav, Nat.
Commun. 12, 6884 (2021), eqs. 4-5). The scheduler-driven Objective classes
are not ported yet.
"""

from __future__ import annotations

import torch

ERR_NEIGHBOR_OVERFLOW = (
    "Trajectory was produced with an overflowed neighbor table (dropped pair "
    "interactions). Enlarge the neighbor-list capacity (capacity/"
    "capacity_multiplier) and re-simulate."
)


def compute_weights_and_neff(beta: float, new_energies: torch.Tensor, ref_energies: torch.Tensor):
    """Boltzmann weights and normalized effective sample size:
    w_i = exp(-beta dE_i) / sum, n_eff = exp(-sum w log w) / S. The max
    logit is subtracted (without gradient) so that float32 does not overflow."""
    logits = -beta * (new_energies - ref_energies)
    logits = logits - logits.max().detach()
    boltz = torch.exp(logits)
    weights = boltz / boltz.sum()
    n_eff = torch.exp(-torch.sum(weights * torch.log(torch.where(weights > 0, weights, torch.ones_like(weights)))))
    return weights, n_eff / new_energies.shape[0]


def check_no_overflow(*trajectories) -> None:
    """Refuse trajectories whose neighbor tables overflowed: they dropped
    pair interactions, and reweighting them would corrupt the fit."""
    for t in trajectories:
        overflow = (t.metadata or {}).get("neighbor_overflow")
        if overflow is not None and bool(torch.as_tensor(overflow).any()):
            raise RuntimeError(ERR_NEIGHBOR_OVERFLOW)
