"""Banded-stencil layout and band validity (site mode).

Counterpart of the stencil half of mythos_tpu/simulators/neighbors.py:
``strand_interleave_perm``, ``stencil_band_for_site_cutoffs`` (host numpy
sizing, carried over as is) and ``StencilBand``'s site-mode checks
(``_check_site``, ``far_check``) in torch, on whichever device the
positions live. The legacy COM-mode band and the block tables are not
ported yet.
"""

from __future__ import annotations

import dataclasses as dc

import numpy as np
import torch

from mythos_tpu_torch.soa import Quat, Vec3, quat_frame_soa


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


@dc.dataclass
class StencilBand:
    """Static band validity of the stencil path (site mode).

    ``site_checks`` holds ((fa, fb, bare_cutoff, d_lo, d_hi), ...): for slot
    offsets d in (d_lo, d_hi] no (fa, fb) site pair may sit inside the bare
    cutoff. Beyond ``check_dm`` a site-union block-AABB sweep catches
    fold-backs. ``w_terms`` are the per-term (exc, hb, cross, coax) reaches
    the kernels use; ``w_wide`` is the Debye reach. ``did_overflow`` is the
    flag of the conformation the band was sized from.
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
    did_overflow: torch.Tensor | None = None

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
) -> StencilBand:
    """Size a site-mode StencilBand from the initial conformation.

    Same sizing as the reference (per-term reaches measured on the actual
    interaction-site distances with per-family thermal slack plus
    ``site_margin`` slots; exact checks out to ``check_dm``; the far sweep
    beyond). ``init_centers``/``init_orientation``: (N, 3)/(N, 4) arrays or
    tensors in the original nucleotide order.
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

    def reach_of(pairs) -> int:
        r = 0
        for fa, fb, cutoff in pairs:
            slack = FAMILY_SLACK.get((fa, fb), SITE_SLACK)
            r = max(r, _band_reach2(spos[fa], spos[fb], float(cutoff) + slack))
        return r + site_margin

    w_t = {nm: max(1, reach_of(terms_sc[nm])) for nm in _SHORT_TERMS}
    w_short = max(w_t.values())
    has_debye = "Debye" in terms_sc
    w_wide = max(1, reach_of(terms_sc["Debye"])) if has_debye else w_short
    w_wide = max(w_wide, w_short)
    if w_wide > max(8, n // 2):
        raise ValueError(f"initial layout is not banded (site reach {w_wide} of {n} slots)")
    far_cutoff = max(float(cu) for prs in terms_sc.values() for _, _, cu in prs)
    b_sz = max(CHECK_BLOCK, -(-n // 4096))
    gaps = _delta_min_gaps(spos, b_sz, n)
    ok = gaps > far_cutoff + FAR_SLACK
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
    )
    ct = torch.as_tensor(init_centers)
    qt = torch.as_tensor(init_orientation)
    return dc.replace(band, did_overflow=band.check(Vec3(*ct.unbind(-1)), Quat(*qt.unbind(-1))))
