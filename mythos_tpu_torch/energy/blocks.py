"""Block-sparse pair sums: the reference's XLA tile path, in plain torch.

Counterpart of mythos_tpu/energy/blocks.py. Particles (in a table's slot
order) form index blocks of B; a block table lists, for each row block a,
up to K column blocks b >= a (a non-symmetric BlockNeighborList, padded
with n_blocks). :func:`block_pair_sums` evaluates every unbonded pair
function of a model on the same (B, K B) tiles -- rows i of a row block
against the columns j of its K column blocks, the column axis flattened as
the reference's --, masks the pairs that are not j > i, not real or bonded,
and sums each function's tile. It is the block tier of the model families
the tile kernels (ops/tiles.py) do not implement, oxRNA2 and the oxNA
hybrid, as it is the reference's: ``ComposedEnergyFunction.compute_terms``
groups the members bound to one table, and autograd of the sums is their
force. oxDNA1 and oxDNA2 keep the kernels.

A pair function takes two :class:`PairSide` views of the transformed
nucleotide (energy.dna1.terms, ``pair_energies``) -- here a (rows, B, 1)
side and a (rows, 1, K B) side -- and returns the tile of pair energies.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import numpy as np
import torch

from mythos_tpu_torch.soa import Vec3

ERR_BLOCK_IDS = "block_ids must be (n_blocks, K) int32"
ERR_PLACEHOLDER = (
    "block_ids is an empty placeholder; allocate a BlockNeighborList and bind "
    "it via energy_fn.with_props(block_ids=nbl.idx) before evaluating"
)


class PairSide:
    """One side (i or j) of a term's pairs: every Vec3 field of a nucleotide
    view (nested views too: the oxNA hybrid's ``dna``/``rna``) taken at
    ``idx``, the side's original nucleotide ids, by ``take`` -- gathered
    along a pair list, broadcast as rows or columns on the dense path,
    gathered into tile rows or columns on the block path. Each field is
    taken once and kept."""

    __slots__ = ("_nuc", "idx", "_take", "_fields")

    def __init__(self, nuc, idx: torch.Tensor, take: Callable) -> None:
        self._nuc, self.idx, self._take, self._fields = nuc, idx, take, {}

    def __getattr__(self, name: str):
        fields = self._fields
        if name not in fields:
            v = getattr(self._nuc, name)
            fields[name] = Vec3(*(self._take(c) for c in v)) if isinstance(v, Vec3) else PairSide(v, self.idx,
                                                                                                  self._take)
        return fields[name]


def gathered_side(nuc, idx: torch.Tensor) -> PairSide:
    """The side of ``nuc`` at the ids ``idx`` (any shape), one gather a field."""
    flat = idx.reshape(-1)
    return PairSide(nuc, idx, lambda c: torch.index_select(c, 0, flat).reshape(idx.shape))


def n_blocks_for(n: int, block_size: int) -> int:
    """Number of blocks covering n rows."""
    return -(-n // block_size)


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


def block_pair_sums(
    pair_fns: Sequence[Callable],
    nuc,
    block_ids: torch.Tensor,
    block_size: int,
    n: int,
    bonded_neighbors,
    *,
    perm: np.ndarray | None = None,
    rows_batch: int | None = None,
) -> torch.Tensor:
    """(len(pair_fns),) per-function sums of the masked pair energies over
    the table's tiles.

    ``nuc``: the transformed nucleotide, (n,) fields in the original order.
    ``block_ids``: (n_blocks, K) column blocks of each row block, entries in
    [a, n_blocks) or n_blocks for padding; each unordered pair is evaluated
    once (the in-tile mask keeps j > i, which also orders the diagonal
    block). ``bonded_neighbors``: (B, 2) original ids of the bonded pairs,
    excluded with the self-pairs, as the reference's pair lists. ``perm``:
    perm[slot] = original id, the slot order the table was built in (None:
    the original order). ``rows_batch``: evaluate this many row blocks at a
    time to bound the live memory (default: all at once)."""
    if block_ids.dim() != 2:
        raise ValueError(ERR_BLOCK_IDS)
    if block_ids.shape[1] == 0:
        raise ValueError(ERR_PLACEHOLDER)
    nb, cap = block_ids.shape
    device = block_ids.device
    n_pad = nb * block_size
    ids = block_ids.long()
    loc = torch.arange(block_size, device=device)
    ig = torch.arange(n_pad, device=device).reshape(nb, block_size)
    jg = torch.where((ids < nb)[:, :, None], ids.clamp(max=nb - 1)[:, :, None] * block_size + loc, n_pad)
    jg = jg.reshape(nb, cap * block_size)  # padded slots point past every real row: masked below
    bonded = np.asarray(bonded_neighbors).reshape(-1, 2)
    order = np.arange(n) if perm is None else np.asarray(perm)
    if perm is not None:
        bonded = np.argsort(order)[bonded]  # bonds in slot ids
    prev, nxt = (torch.as_tensor(a, device=device).long() for a in bonded_partner_table(n_pad, bonded))
    # slot -> original id; padded slots read the last nucleotide (masked)
    orig = torch.as_tensor(np.concatenate([order, np.full(n_pad + 1 - n, order[-1])]), device=device).long()
    step = nb if rows_batch is None else rows_batch
    sums = 0.0
    for start in range(0, nb, step):
        i_s, j_s = ig[start : start + step, :, None], jg[start : start + step, None, :]
        mask = (j_s > i_s) & (i_s < n) & (j_s < n) & (j_s != prev[i_s]) & (j_s != nxt[i_s])
        si, sj = gathered_side(nuc, orig[i_s]), gathered_side(nuc, orig[j_s])
        sums = sums + torch.stack([torch.where(mask, fn(si, sj), 0.0).sum() for fn in pair_fns])
    return sums


def block_pair_sum(pair_fn: Callable, nuc, block_ids, block_size: int, n: int, bonded_neighbors, *,
                   perm=None, rows_batch: int | None = None) -> torch.Tensor:
    """Scalar sum of the masked pair energies of one pair function."""
    return block_pair_sums([pair_fn], nuc, block_ids, block_size, n, bonded_neighbors, perm=perm,
                           rows_batch=rows_batch)[0]
