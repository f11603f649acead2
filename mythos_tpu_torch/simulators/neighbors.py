"""Neighbor structures: static pairs, the banded stencil (site mode) and
block tables.

Counterpart of mythos_tpu/simulators/neighbors.py:

* the pair-list half (small systems): ``NoNeighborList`` (a fixed pair
  list), ``DensePairs`` (the dense (N, N)-mask path's marker) and their
  masks, ``bonded_exclusion_mask`` and ``dense_pair_mask``, and
  ``FixedCapacityNeighborList`` (a distance-culled pair list of fixed
  capacity, rebuilt on the positions' device, through a displacement:
  periodic boxes too) with
  ``neighbor_list_for_topology``;
* the stencil half: ``strand_interleave_perm``,
  ``stencil_band_for_site_cutoffs`` (host numpy sizing, carried over as is)
  and ``StencilBand``'s site-mode checks (``_check_site``, ``far_check``);
* the block half: ``BlockNeighborList`` (symmetric tables for the tile
  kernels, non-symmetric ones -- column blocks b >= a -- for the block sums
  of energy/blocks.py, the two-level tight/wide mode, ``perm``, banded
  windows, the distance-prioritised compaction and the missed-interaction
  detector),
  ``_max_span``, ``_snap_capacity`` and ``block_neighbor_list_for_topology``
  (oxDNA1 has no Debye term and takes a one-level table: no
  ``r_cutoff_inner``).

All of it runs in torch on whichever device the positions live. The dense
O(n_blocks^2) AABB pass is one plain torch pass (1.6M block pairs at 10k nt
with B = 8). Not ported: the legacy COM-mode band and the hierarchical
(super-block) rebuild, which measured slower than the dense pass on the TPU.
"""

from __future__ import annotations

import dataclasses as dc
from collections.abc import Callable

import numpy as np
import torch

from mythos_tpu_torch.soa import Quat, Vec3, quat_frame_soa


@dc.dataclass(frozen=True)
class NoNeighborList:
    """All unbonded pairs, statically precomputed (exact, O(N^2) memory):
    ``unbonded_nbrs`` (U, 2), the energy terms' ``unbonded_neighbors``."""

    unbonded_nbrs: np.ndarray


@dc.dataclass(frozen=True)
class DensePairs:
    """Marker of the dense (N, N) energy path: the terms carry their
    constant mask (``dense_pair_mask``), nothing is ever rebuilt."""


def bonded_exclusion_mask(n: int, bonded_neighbors: np.ndarray) -> np.ndarray:
    """(N, N) boolean mask of excluded (self + bonded) pairs."""
    mask = np.eye(n, dtype=bool)
    bn = np.asarray(bonded_neighbors).reshape(-1, 2)
    mask[bn[:, 0], bn[:, 1]] = mask[bn[:, 1], bn[:, 0]] = True
    return mask


def dense_pair_mask(topology) -> np.ndarray:
    """(N, N) upper-triangular unbonded-pair mask for the dense energy path."""
    n = topology.n_nucleotides
    return np.triu(~bonded_exclusion_mask(n, topology.bonded_neighbors), k=1)


@dc.dataclass
class FixedCapacityNeighborList:
    """Distance-culled unbonded pairs of static capacity.

    The rebuild takes the upper triangle of the (N, N) centre distances
    (``displacement_fn(c_i, c_j)``, the reference's; free space when None,
    ``spaces.periodic(box)[0]`` for a periodic box),
    drops the excluded (self and bonded) pairs and compacts the hits within
    ``r_cutoff + dr_threshold`` into a (2, capacity) list, nearest first,
    padded with N (a stable sort: equal distances keep the reference's
    order). ``did_overflow`` is raised when more pairs lie inside the bare
    ``r_cutoff`` than ``capacity``, or, given the previous list, when a pair
    inside the bare cutoff is missing from it -- the condition under which
    the last interval's forces were wrong. The list carries no gradient."""

    exclusion_mask: np.ndarray  # (N, N) bool, True = never a neighbour
    r_cutoff: float
    dr_threshold: float
    capacity: int
    idx_: torch.Tensor | None = None
    did_overflow: torch.Tensor | None = None
    displacement_fn: Callable | None = None

    @property
    def idx(self) -> torch.Tensor | None:
        return self.idx_

    def pair_d2(self, centers: torch.Tensor, iu: torch.Tensor) -> torch.Tensor:
        """Squared centre distances of the pairs ``iu`` ((2, P) ids)."""
        ci, cj = centers[iu[0]], centers[iu[1]]
        dr = ci - cj if self.displacement_fn is None else self.displacement_fn(ci, cj)
        return (dr * dr).sum(-1)

    def replace(self, **kw) -> "FixedCapacityNeighborList":
        return dc.replace(self, **kw)

    def _build(self, centers: torch.Tensor, prev: torch.Tensor | None = None):
        """((2, capacity) long pairs, 0-d bool overflow) of (N, 3) centres."""
        with torch.no_grad():
            n = centers.shape[0]
            device = centers.device
            iu = torch.triu_indices(n, n, offset=1, device=device)
            d2u = self.pair_d2(centers, iu)
            allowed = ~torch.as_tensor(self.exclusion_mask, device=device)[iu[0], iu[1]]
            hit = (d2u < (self.r_cutoff + self.dr_threshold) ** 2) & allowed
            order = torch.argsort(torch.where(hit, d2u, torch.inf), stable=True)[: self.capacity]
            valid = hit[order]
            pairs = torch.where(valid, iu[:, order], n)
            if pairs.shape[1] < self.capacity:
                pairs = torch.nn.functional.pad(pairs, (0, self.capacity - pairs.shape[1]), value=n)
            hard = (d2u < self.r_cutoff * self.r_cutoff) & allowed
            overflow = hard.sum() > self.capacity
            if prev is not None:
                member = torch.zeros((n + 1, n + 1), dtype=torch.bool, device=device)
                member[prev[0].long(), prev[1].long()] = True
                overflow = overflow | (hard & ~member[iu[0], iu[1]]).any()
        return pairs, overflow

    def build(self, centers: torch.Tensor, prev: torch.Tensor | None = None):
        """(pairs, overflow) of (N, 3) centres; ``prev`` arms the
        missed-interaction detector."""
        return self._build(centers, prev=prev)

    def allocate(self, centers: torch.Tensor) -> "FixedCapacityNeighborList":
        idx, overflow = self._build(centers)
        return self.replace(idx_=idx, did_overflow=overflow)

    def update(self, centers: torch.Tensor) -> "FixedCapacityNeighborList":
        idx, overflow = self._build(centers, prev=self.idx_)
        return self.replace(idx_=idx, did_overflow=self.did_overflow | overflow)


#: capacity over the initial hits of neighbor_list_for_topology
PAIR_CAPACITY_MULTIPLIER = 1.25


def neighbor_list_for_topology(
    topology, r_cutoff: float, dr_threshold: float = 0.2, capacity: int | None = None, init_centers=None,
    displacement_fn: Callable | None = None,
) -> FixedCapacityNeighborList:
    """A FixedCapacityNeighborList, its capacity (when not given) the
    initial hits x PAIR_CAPACITY_MULTIPLIER, at least 16 (the reference's
    sizing); allocated when ``init_centers`` ((N, 3) tensor) is given.
    ``displacement_fn``: the distances' (free space when None)."""
    nbl = FixedCapacityNeighborList(
        exclusion_mask=bonded_exclusion_mask(topology.n_nucleotides, topology.bonded_neighbors),
        r_cutoff=float(r_cutoff), dr_threshold=float(dr_threshold), capacity=capacity or 0,
        displacement_fn=displacement_fn,
    )
    if capacity is None:
        if init_centers is None:
            raise ValueError("capacity or init_centers must be provided")
        c = torch.as_tensor(init_centers).detach()
        iu = torch.triu_indices(len(c), len(c), offset=1, device=c.device)
        allowed = ~torch.as_tensor(nbl.exclusion_mask, device=c.device)[iu[0], iu[1]]
        hits = int(((nbl.pair_d2(c, iu) < (r_cutoff + dr_threshold) ** 2) & allowed).sum())
        nbl = nbl.replace(capacity=max(16, int(hits * PAIR_CAPACITY_MULTIPLIER)))
    return nbl.allocate(torch.as_tensor(init_centers)) if init_centers is not None else nbl


def strand_interleave_perm(topology) -> np.ndarray | None:
    """Duplex interleave: slot 2i holds strand-A index i, slot 2i+1 its
    antiparallel partner N-1-i. None unless two equal strands."""
    counts = getattr(topology, "strand_counts", None)
    if counts is None or len(counts) != 2 or counts[0] != counts[1]:
        return None
    n = int(sum(counts))
    perm = np.empty(n, dtype=np.int64)
    perm[0::2] = np.arange(n // 2)
    perm[1::2] = n - 1 - np.arange(n // 2)
    return perm


def _site_coeffs(c) -> tuple[float, float, float]:
    """Site-offset spec -> (a1, a2, a3) coefficients."""
    c = tuple(float(v) for v in c)
    return c if len(c) == 3 else (c[0], c[1], 0.0)


def _np_frames(quats: np.ndarray):
    w, x, y, z = (quats[:, k] for k in range(4))
    a1 = np.stack([w * w + x * x - y * y - z * z, 2 * (x * y + w * z), 2 * (x * z - w * y)], -1)
    a2 = np.stack([2 * (x * y - w * z), w * w - x * x + y * y - z * z, 2 * (y * z + w * x)], -1)
    a3 = np.stack([2 * (x * z + w * y), 2 * (y * z - w * x), w * w - x * x - y * y + z * z], -1)
    return a1, a2, a3


def _band_reach2(ca: np.ndarray, cb: np.ndarray, cutoff: float, group: int = 64) -> int:
    """Max slot distance over cross-site pairs (a_i, b_j) or (b_i, a_j)
    within ``cutoff`` (exact, bounded by a block-AABB sweep first)."""
    ca = np.asarray(ca, np.float32)
    cb = np.asarray(cb, np.float32)
    n = ca.shape[0]
    if n < 2:
        return 0
    nb = -(-n // group)
    n_pad = nb * group

    def aabb(c):
        cp = np.pad(c, ((0, n_pad - n), (0, 0)), constant_values=np.nan).reshape(nb, group, 3)
        return np.nanmin(cp, axis=1), np.nanmax(cp, axis=1)

    lo_a, hi_a = aabb(ca)
    lo_b, hi_b = aabb(cb)
    lo = np.minimum(lo_a, lo_b)
    hi = np.maximum(hi_a, hi_b)
    gap = np.maximum(np.maximum(lo[:, None, :] - hi[None, :, :], lo[None, :, :] - hi[:, None, :]), 0.0)
    hit_b = (gap * gap).sum(-1) < cutoff * cutoff
    if not hit_b.any():
        return 0
    bi = np.arange(nb)
    bd = int(np.abs(bi[:, None] - bi[None, :])[hit_b].max())
    c2 = cutoff * cutoff
    for d in range(min(n - 1, (bd + 1) * group - 1), 0, -1):
        dd = cb[d:] - ca[:-d]
        if ((dd * dd).sum(-1) < c2).any():
            return d
        dd = ca[d:] - cb[:-d]
        if ((dd * dd).sum(-1) < c2).any():
            return d
    return 0


def _delta_min_gaps(spos: dict, b_sz: int, n: int) -> np.ndarray:
    """(nb,) per-block-index-distance min site-union AABB gap."""
    nb = -(-n // b_sz)
    n_pad = nb * b_sz
    lo = hi = None
    for s in spos.values():
        sp = np.pad(np.asarray(s, np.float32), ((0, n_pad - n), (0, 0)), constant_values=np.nan)
        sp = sp.reshape(nb, b_sz, 3)
        lo_s, hi_s = np.nanmin(sp, axis=1), np.nanmax(sp, axis=1)
        lo = lo_s if lo is None else np.minimum(lo, lo_s)
        hi = hi_s if hi is None else np.maximum(hi, hi_s)
    gaps = np.full(nb, np.inf, np.float32)
    for delta in range(1, nb):
        g = np.maximum(lo[delta:] - hi[:-delta], 0.0)
        g = np.maximum(g, np.maximum(lo[:-delta] - hi[delta:], 0.0))
        gaps[delta] = float(np.sqrt((g * g).sum(-1).min()))
    return gaps


#: site families the in-kernel checks know, in the kernels' code order
SITE_FAMILIES = ("back", "base", "stack")

_SHORT_TERMS = ("UnbondedExcludedVolume", "HydrogenBonding", "CrossStacking", "CoaxialStacking")

#: thermal slack added to each site cutoff when the band is sized, per site
#: family pair (backbones move most), and to the far sweep's cutoff; the
#: reference's defaults (mythos_tpu/simulators/neighbors.py)
SITE_SLACK = 0.5
FAMILY_SLACK = {("back", "back"): 0.9, ("back", "base"): 0.75, ("base", "back"): 0.75}
FAR_SLACK = 1.5
#: smallest block of the far sweep (grown so that it has at most 4096 blocks)
CHECK_BLOCK = 4
ERR_BAND_CUTOFF = (
    "the energy's bound {term} cutoff {bound:.6g} ({fa}-{fb} sites) passes the {reach:.6g} its stencil band's "
    "reach was sized for: pairs inside it could lie beyond the band. Size the band from the bound energy: "
    "stencil_band_for_site_cutoffs(topology, <model>.per_term_site_cutoffs(energy_fn), ...)"
)


@dc.dataclass
class StencilBand:
    """Static band validity of the stencil path (site mode).

    ``site_checks`` holds ((fa, fb, bare_cutoff, d_lo, d_hi), ...): for slot
    offsets d in (d_lo, d_hi] no (fa, fb) site pair may sit inside the bare
    cutoff. Beyond ``check_dm`` a site-union block-AABB sweep catches
    fold-backs. ``w_terms`` are the per-term (exc, hb, cross, coax) reaches
    the kernels use; ``w_wide`` is the Debye reach. ``site_cutoffs``
    records ((term, fa, fb, bare_cutoff, reach_cutoff), ...): each term's
    site cutoffs and the cutoff its reach was sized for (bare plus the
    family's slack), which an energy's bound cutoffs must not pass
    (:meth:`bound`). ``did_overflow`` is the flag of the conformation the
    band was sized from.
    """

    n: int
    w_wide: int
    check_block: int
    perm: np.ndarray | None
    site_geometry: tuple
    site_checks: tuple
    check_dm: int
    far_cutoff: float
    w_terms: tuple
    site_cutoffs: tuple = ()
    did_overflow: torch.Tensor | None = None

    def bound(self, terms: dict) -> "StencilBand":
        """This band for an energy whose unbonded site cutoffs are ``terms``
        (energy.defaults.unbonded_site_cutoffs of its bound parameters).
        Raises ERR_BAND_CUTOFF where one passes the cutoff its term's reach
        was sized for: pairs inside it could lie beyond the reach. Else the
        band with its exact checks and far sweep at the bound cutoffs where
        these are the larger, so that a pair inside one beyond the reach
        raises the overflow flag. A band that records no cutoffs is
        returned as it is."""
        raised = {}
        for term, fa, fb, bare, reach in self.site_cutoffs:
            for ga, gb, cut in terms.get(term, ()):
                if (ga, gb) != (fa, fb):
                    continue
                if cut > reach:
                    raise ValueError(ERR_BAND_CUTOFF.format(term=term, bound=cut, fa=fa, fb=fb, reach=reach))
                raised[(fa, fb, bare)] = max(raised.get((fa, fb, bare), bare), cut)
        if not raised:
            return self
        checks = tuple((fa, fb, raised.get((fa, fb, cu), cu), lo, hi) for fa, fb, cu, lo, hi in self.site_checks)
        return dc.replace(self, site_checks=checks, far_cutoff=max(self.far_cutoff, *raised.values()))

    def sites(self, com: Vec3, quat: Quat) -> dict[str, Vec3]:
        a1, a2, a3 = quat_frame_soa(quat)
        out = {}
        for name, c in self.site_geometry:
            c1, c2, c3 = _site_coeffs(c)
            out[name] = com + c1 * a1 + c2 * a2 + c3 * a3
        return out


    def _exact_violation(self, sites: dict) -> torch.Tensor:
        """Per-offset site distances for d <= check_dm (no partner mask,
        as the reference's host-side check)."""
        viol = torch.zeros((), dtype=torch.bool, device=next(iter(sites.values())).x.device)
        for fa, fb, cutoff, d_lo, d_hi in self.site_checks:
            sa, sb = sites[fa], sites[fb]
            for d in range(d_lo + 1, min(d_hi, self.n - 1) + 1):
                d2 = sum((cb[d:] - ca[:-d]) ** 2 for ca, cb in zip(sa, sb, strict=True))
                m = d2.min()
                if fa != fb:
                    d2r = sum((ca[d:] - cb[:-d]) ** 2 for ca, cb in zip(sa, sb, strict=True))
                    m = torch.minimum(m, d2r.min())
                viol = viol | (m < cutoff * cutoff)
        return viol

    def _far_violation(self, sites: dict) -> torch.Tensor:
        """Site-union block-AABB sweep over block distances whose slot
        distances all exceed check_dm."""
        b_sz = self.check_block
        n = self.n
        nb = -(-n // b_sz)
        pad = nb * b_sz - n
        dist2 = 0.0
        for k in range(3):
            comps = torch.stack([s[k] for s in sites.values()])  # (n_sites, n)
            lo = torch.nn.functional.pad(comps, (0, pad), value=float("inf"))
            hi = torch.nn.functional.pad(comps, (0, pad), value=float("-inf"))
            lo_c = lo.reshape(-1, nb, b_sz).amin(dim=(0, 2))
            hi_c = hi.reshape(-1, nb, b_sz).amax(dim=(0, 2))
            gap = torch.clamp(
                torch.maximum(lo_c[:, None] - hi_c[None, :], lo_c[None, :] - hi_c[:, None]), min=0.0
            )
            dist2 = dist2 + gap * gap
        col = torch.arange(nb, device=dist2.device)
        far = (col[:, None] - col[None, :]).abs() >= self.check_dm // b_sz + 1
        return (far & (dist2 < self.far_cutoff * self.far_cutoff)).any()

    def check(self, com: Vec3, quat: Quat) -> torch.Tensor:
        """Overflow flag (0-d bool tensor) of positions in the original
        nucleotide order: exact checks + far sweep."""
        if self.perm is not None:
            idx = torch.as_tensor(self.perm, device=com.x.device)
            com, quat = Vec3(*(c[idx] for c in com)), Quat(*(c[idx] for c in quat))
        return self.slot_check(com, quat)

    def slot_check(self, com: Vec3, quat: Quat) -> torch.Tensor:
        """:meth:`check` of slot-order positions."""
        sites = self.sites(com, quat)
        return self._exact_violation(sites) | self._far_violation(sites)

    def far_check(self, com: Vec3, quat: Quat) -> torch.Tensor:
        """The far fold-back sweep only, of slot-order positions (the exact
        part runs in-kernel)."""
        return self._far_violation(self.sites(com, quat))


def stencil_band_for_site_cutoffs(
    topology,
    site_cutoffs: dict,
    init_centers,
    init_orientation,
    perm: np.ndarray | None = None,
    site_margin: int = 1,
    fam_slack_overrides: dict | None = None,
    far_slack: float | None = None,
) -> StencilBand:
    """Size a site-mode StencilBand from the initial conformation.

    Same sizing as the reference (per-term reaches measured on the actual
    interaction-site distances with per-family thermal slack plus
    ``site_margin`` slots; exact checks out to ``check_dm``; the far sweep
    beyond). ``init_centers``/``init_orientation``: (N, 3)/(N, 4) arrays or
    tensors in the original nucleotide order. ``fam_slack_overrides``
    ({(fa, fb): slack}, either order) and ``far_slack`` replace the
    B-DNA defaults where a helix form breathes further (A-form rna2:
    ``energy.rna2.aform_site_slacks`` / ``aform_far_slack``).
    ``site_cutoffs``: a model's ``per_term_site_cutoffs(energy_fn)``, from
    the energy the band will run (its salt sets the Debye reach
    ``w_wide``); the band keeps them with the cutoffs its reaches were
    sized for, and the stencil context of an energy whose bound cutoffs
    pass those raises (:meth:`StencilBand.bound`, ERR_BAND_CUTOFF).
    """
    n = topology.n_nucleotides
    bn = np.asarray(topology.bonded_neighbors)
    if bn.size and np.bincount(bn.ravel(), minlength=n).max() > 2:
        raise ValueError("stencil bands support at most 2 bonded partners per particle")
    c = np.asarray(torch.as_tensor(init_centers).detach().cpu(), np.float32)
    q = np.asarray(torch.as_tensor(init_orientation).detach().cpu(), np.float32)
    if perm is not None:
        c, q = c[perm], q[perm]
    a1, a2, a3 = _np_frames(q)
    sdefs = dict(site_cutoffs["sites"])
    spos = {}
    for nm, v in sdefs.items():
        cs = _site_coeffs(v)
        spos[nm] = c + cs[0] * a1 + cs[1] * a2 + cs[2] * a3
    terms_sc = dict(site_cutoffs["terms"])
    missing = [nm for nm in _SHORT_TERMS if nm not in terms_sc]
    if missing:
        raise ValueError(f"site_cutoffs missing short-range terms {missing}")

    fam_slack = dict(FAMILY_SLACK)
    for (fa, fb), v in (fam_slack_overrides or {}).items():
        fam_slack[(fa, fb)] = fam_slack[(fb, fa)] = max(SITE_SLACK, float(v))
    far_slack = max(SITE_SLACK, FAR_SLACK if far_slack is None else float(far_slack))

    def reach_of(pairs) -> int:
        r = 0
        for fa, fb, cutoff in pairs:
            slack = fam_slack.get((fa, fb), SITE_SLACK)
            r = max(r, _band_reach2(spos[fa], spos[fb], float(cutoff) + slack))
        return r + site_margin

    w_t = {nm: max(1, reach_of(terms_sc[nm])) for nm in _SHORT_TERMS}
    w_short = max(w_t.values())
    has_debye = "Debye" in terms_sc
    w_wide = max(1, reach_of(terms_sc["Debye"])) if has_debye else w_short
    w_wide = max(w_wide, w_short)
    reach_cutoffs = tuple((nm, fa, fb, float(cu), float(cu) + fam_slack.get((fa, fb), SITE_SLACK))
                          for nm, prs in terms_sc.items() for fa, fb, cu in prs)
    if w_wide > max(8, n // 2):
        raise ValueError(f"initial layout is not banded (site reach {w_wide} of {n} slots)")
    far_cutoff = max(float(cu) for prs in terms_sc.values() for _, _, cu in prs)
    b_sz = max(CHECK_BLOCK, -(-n // 4096))
    gaps = _delta_min_gaps(spos, b_sz, n)
    ok = gaps > far_cutoff + far_slack
    suffix_ok = np.flip(np.logical_and.accumulate(np.flip(ok)))
    cand = np.nonzero(suffix_ok)[0]
    cand = cand[cand >= 1]
    if cand.size == 0:
        raise ValueError("initial layout has fold-back contacts at every scale")
    dm = max(w_wide + 2, int(cand[0]) * b_sz)
    dm = -(-dm // b_sz) * b_sz
    check_dm = dm + b_sz - 1
    site_checks = []
    for nm in _SHORT_TERMS:
        for fa, fb, cutoff in terms_sc[nm]:
            if w_t[nm] < check_dm:
                site_checks.append((fa, fb, float(cutoff), w_t[nm], check_dm))
    if has_debye:
        for fa, fb, cutoff in terms_sc["Debye"]:
            if w_wide < check_dm:
                site_checks.append((fa, fb, float(cutoff), w_wide, check_dm))
    band = StencilBand(
        n=n,
        w_wide=w_wide,
        check_block=b_sz,
        perm=None if perm is None else np.asarray(perm),
        site_geometry=tuple(sorted(sdefs.items())),
        site_checks=tuple(site_checks),
        check_dm=int(check_dm),
        far_cutoff=float(far_cutoff),
        w_terms=tuple(w_t[nm] for nm in _SHORT_TERMS),
        site_cutoffs=reach_cutoffs,
    )
    ct = torch.as_tensor(init_centers)
    qt = torch.as_tensor(init_orientation)
    return dc.replace(band, did_overflow=band.check(Vec3(*ct.unbind(-1)), Quat(*qt.unbind(-1))))


@dc.dataclass
class BlockNeighborList:
    """Block-level neighbor table of the block-sparse tile path.

    Particles (in ``perm`` order when set) form index blocks of
    ``block_size``; each row block keeps up to ``capacity`` column blocks
    whose axis-aligned bounding boxes lie within ``r_cutoff +
    dr_threshold`` (padded with n_blocks). A ``symmetric`` table lists
    every pair from both sides, which the tile kernels need, as their
    row-side gradient under the full mask is the whole force (ops/tiles.py);
    a non-symmetric one only column blocks b >= a, each pair once, which the
    block sums of energy/blocks.py take (one table: no ``r_cutoff_inner``,
    no ``banded``).
    With ``r_cutoff_inner`` set, :meth:`build` returns a (tight, wide) pair
    of tables from one AABB pass: the short-range terms run on the tight one,
    Debye-Hueckel alone on the wide one. ``banded`` tables hold consecutive
    block ids (a window covering every hit).
    """

    block_size: int
    capacity: int
    r_cutoff: float
    dr_threshold: float
    n: int
    symmetric: bool = True
    r_cutoff_inner: float | None = None
    capacity_inner: int = 0
    perm: np.ndarray | None = None
    banded: bool = False
    block_ids_: object = None  # (n_blocks, capacity) int32, or a (tight, wide) pair
    did_overflow: torch.Tensor | None = None

    @property
    def idx(self):
        return self.block_ids_

    @property
    def n_blocks(self) -> int:
        return -(-self.n // self.block_size)

    def replace(self, **kw) -> "BlockNeighborList":
        return dc.replace(self, **kw)

    def _ids_from_components(self, x, y, z, prev=None):
        """AABB pass + compaction of (N,) slot-order components; ``prev`` (the
        previous table(s)) arms the missed-interaction detector: overflow is
        raised when a block pair is inside the bare cutoff now but was absent
        from the previous table, the condition under which the last
        interval's forces were wrong."""
        nb, b_sz = self.n_blocks, self.block_size
        n_pad = nb * b_sz
        device = x.device
        row_valid = (torch.arange(n_pad, device=device) < self.n).reshape(nb, b_sz)
        big = torch.finfo(x.dtype).max
        dist2 = torch.zeros((nb, nb), dtype=x.dtype, device=device)
        for c in (x, y, z):
            cb = torch.nn.functional.pad(c, (0, n_pad - c.shape[0])).reshape(nb, b_sz)
            lo = torch.where(row_valid, cb, big).amin(dim=1)
            hi = torch.where(row_valid, cb, -big).amax(dim=1)
            gap = torch.clamp(torch.maximum(lo[:, None] - hi[None, :], lo[None, :] - hi[:, None]), min=0.0)
            dist2 = dist2 + gap * gap
        col = torch.arange(nb, device=device)
        upper = torch.ones((), dtype=torch.bool, device=device) if self.symmetric else col[None, :] >= col[:, None]

        def compact(cut_bare: float, capacity: int):
            cut = cut_bare + self.dr_threshold
            hit = (dist2 < cut * cut) & upper
            hard = (dist2 < cut_bare * cut_bare) & upper
            if self.banded:
                # window start: the first hit, clamped into range; any bare
                # hit outside the window overflows
                start = torch.where(hit, col[None, :], nb).amin(dim=1)
                start = torch.clamp(start, 0, max(0, nb - capacity))
                ids = start[:, None] + torch.arange(capacity, device=device)[None, :]
                outside = (col[None, :] < start[:, None]) | (col[None, :] >= start[:, None] + capacity)
                return ids.to(torch.int32), (hard & outside).any()
            # distance-prioritised: when a row holds more hits than capacity
            # the farthest (skin-zone) blocks go; overflow only when bare hits
            # do not fit (skin drops are caught by the detector later)
            # (a stable sort: ties keep the lower block first, as lax.top_k)
            score = torch.where(hit, -dist2, -torch.inf)
            k = min(capacity, nb)
            vals, idxs = torch.sort(score, dim=1, descending=True, stable=True)
            ids = torch.where(vals[:, :k] > -torch.inf, idxs[:, :k], nb)
            ids = torch.sort(ids, dim=1).values
            if k < capacity:
                ids = torch.nn.functional.pad(ids, (0, capacity - k), value=nb)
            return ids.to(torch.int32), (hard.sum(dim=1) > capacity).any()

        def missed(prev_ids, cut_bare: float):
            hit = (dist2 < cut_bare * cut_bare) & upper
            member = torch.zeros((nb, nb + 1), dtype=torch.bool, device=device)
            member.scatter_(1, prev_ids.long(), True)
            return (hit & ~member[:, :nb]).any()

        ids, overflow = compact(self.r_cutoff, self.capacity)
        if self.r_cutoff_inner is None:
            if prev is not None:
                overflow = overflow | missed(prev, self.r_cutoff)
            return ids, overflow
        ids_in, ovf_in = compact(self.r_cutoff_inner, self.capacity_inner)
        overflow = overflow | ovf_in
        if prev is not None:
            prev_in, prev_wide = prev
            overflow = overflow | missed(prev_in, self.r_cutoff_inner) | missed(prev_wide, self.r_cutoff)
        return (ids_in, ids), overflow

    def build(self, centers, prev=None):
        """(table or (tight, wide) tables, 0-d bool overflow) of positions in
        the original nucleotide order: an (N, 3) tensor or a Vec3."""
        comps = tuple(centers) if isinstance(centers, Vec3) else tuple(centers.unbind(-1))
        if self.perm is not None:
            idx = torch.as_tensor(self.perm, device=comps[0].device)
            comps = tuple(c[idx] for c in comps)
        return self._ids_from_components(*comps, prev=prev)

    def allocate(self, centers) -> "BlockNeighborList":
        ids, overflow = self.build(centers)
        return self.replace(block_ids_=ids, did_overflow=overflow)


def _max_span(ids: np.ndarray, nblk: int) -> int:
    """Largest contiguous block-index span covering a row's hits (the
    banded window a row needs)."""
    valid = ids < nblk
    anyv = valid.any(axis=1)
    first = np.where(valid, ids, nblk).min(axis=1)
    last = np.where(valid, ids, -1).max(axis=1)
    return int(np.max(np.where(anyv, last - first + 1, 0)))


#: capacity over the observed per-row hits when no slot quantum fits
CAPACITY_MULTIPLIER = 1.5


def _snap_capacity(hits: int, block_size: int, symmetric: bool = True) -> int:
    """Capacity from an observed per-row hit count: on a symmetric table the
    smallest of the reference's slot quanta 128/(B*q) with a spare block (so
    both packages size the same tables), else hits x CAPACITY_MULTIPLIER."""
    if symmetric and 128 % block_size == 0:
        quanta = sorted(128 // (block_size * q) for q in (1, 2, 4, 8, 16) if block_size * q <= 128)
        for s in quanta:
            if s >= hits + 1:
                return s
    return max(2, int(np.ceil(hits * CAPACITY_MULTIPLIER)))


def block_neighbor_list_for_topology(
    topology,
    r_cutoff: float,
    dr_threshold: float = 0.5,
    block_size: int = 64,
    capacity: int | None = None,
    init_centers=None,
    r_cutoff_inner: float | None = None,
    perm: np.ndarray | None = None,
    symmetric: bool = True,
) -> BlockNeighborList:
    """A BlockNeighborList sized from the initial positions (free space).

    ``r_cutoff_inner`` switches on the two-level mode (symmetric tables
    only); ``perm`` reorders the particles before blocking
    (strand_interleave_perm). A symmetric table sized here is banded when
    the window costs no extra capacity (the reference's ``banded=None``).
    ``init_centers``: (N, 3) tensor in the original order; the table lives
    on its device.
    """
    if not symmetric and r_cutoff_inner is not None:
        raise ValueError("two-level (tight, wide) tables are symmetric: the block sums take one table")
    n = topology.n_nucleotides
    bn = np.asarray(topology.bonded_neighbors)
    if bn.size and np.bincount(bn.ravel(), minlength=n).max() > 2:
        raise ValueError("block neighbor lists support at most 2 bonded partners per particle")
    nbl = BlockNeighborList(
        block_size=block_size,
        capacity=capacity or 0,
        r_cutoff=float(r_cutoff),
        dr_threshold=float(dr_threshold),
        n=n,
        symmetric=symmetric,
        r_cutoff_inner=None if r_cutoff_inner is None else float(r_cutoff_inner),
        capacity_inner=(capacity or 0) if r_cutoff_inner is not None else 0,
        perm=None if perm is None else np.asarray(perm),
    )
    if capacity is None:
        if init_centers is None:
            raise ValueError("capacity or init_centers must be provided")
        nblk = nbl.n_blocks
        probe = nbl.replace(capacity=nblk, capacity_inner=nblk if r_cutoff_inner is not None else 0)
        ids, _ = probe.build(init_centers)
        ids_in = None
        if r_cutoff_inner is not None:
            ids_in, ids = ids
        ids = ids.cpu().numpy()
        hits = int(np.max(np.sum(ids < nblk, axis=1)))
        cap = min(nblk, _snap_capacity(hits, block_size, symmetric))
        cap_band = min(nblk, _snap_capacity(_max_span(ids, nblk), block_size, symmetric))
        use_banded = symmetric and nblk > cap_band and cap_band <= cap
        if use_banded:
            cap = cap_band
        cap_in = 0
        if ids_in is not None:
            ids_in = ids_in.cpu().numpy()
            n_in = _max_span(ids_in, nblk) if use_banded else int(np.max(np.sum(ids_in < nblk, axis=1)))
            cap_in = min(nblk, _snap_capacity(n_in, block_size))
            if cap_in >= cap:
                # the tight table would be as wide as the wide one: one table
                nbl = nbl.replace(r_cutoff_inner=None)
                cap_in = 0
        nbl = nbl.replace(capacity=cap, capacity_inner=cap_in, banded=use_banded)
    return nbl.allocate(init_centers) if init_centers is not None else nbl
