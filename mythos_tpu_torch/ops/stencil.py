"""Banded-stencil oxDNA2 physics: host prep, plain twins, kernel wrappers.

Counterpart of mythos_tpu/ops/stencil.py. Slots are the strand-interleave
order of simulators.neighbors.strand_interleave_perm, in which every
interacting pair (i, j) has a small slot offset d = j - i <= ``w_wide``:
base-pair partners sit at d = 1, bonded backbone neighbours at d = 2. The
unbonded terms are evaluated for d = 1..w_wide (each short-range term only
up to its own reach ``w_terms``; Debye-Hueckel out to ``w_wide``), the
bonded terms (FENE, bonded excluded volume, stacking) on the (i, i+2) bonds.

Two kernels carry the main path (sources in ``ops/csrc``):

* K2 :func:`field_grads` -- one unbonded band evaluation, d/dcom and
  d/dquat (replaces ``_kernel_field_grads``; runs once per run for the
  initial force).
* K1 :func:`multistep_chunk` -- ``n_inner`` BAOAB Langevin steps with the
  bonded terms, and the exact site-distance band checks at the chunk's
  entry positions (replaces ``_multistep_chunk_l``).

Beside each sits its plain PyTorch twin (:func:`field_grads_plain`,
:func:`multistep_chunk_plain`): the band energy written in torch and
differentiated with ``torch.autograd.grad`` -- an independent check of the
kernels' hand-written derivatives. A wrapper runs the twin for CPU tensors
only; on a CUDA tensor it launches its kernel or raises.

Arrays are flat ``(rows, n)`` slot-order tensors. All term parameters ride
in one flat vector whose layout (:data:`PARAM_GROUPS`) the CUDA header
``stencil_physics.cuh`` mirrors (``P_*`` offsets).
"""

from __future__ import annotations

import ctypes
import dataclasses as dc
from types import SimpleNamespace

import numpy as np
import torch

import mythos_tpu_torch.energy.dna1.terms as t1
import mythos_tpu_torch.energy.dna2.terms as t2
from mythos_tpu_torch.energy.dna1 import geometry as geom
from mythos_tpu_torch.simulators.neighbors import SITE_FAMILIES, StencilBand
from mythos_tpu_torch.soa import Quat, Vec3, free_rotor_soa, quat_cotangent_to_torque_soa, quat_frame_soa, vnorm
from mythos_tpu_torch.utils.math import arccos_poly

UNBONDED_ORDER = ("UnbondedExcludedVolume", "HydrogenBonding", "CrossStacking", "CoaxialStacking", "Debye")
BONDED_ORDER = ("Fene", "BondedExcludedVolume", "Stacking")

ERR_MS_SCALAR = "multi-step path requires scalar mass/gamma/inertia (got per-particle)"
ERR_MS_BONDS = "multi-step path requires every bond at slot offset 2 (duplex interleave)"
ERR_MS_PSEQ = "multi-step path does not support probabilistic sequences yet"
ERR_TERMS = "the stencil path implements exactly the oxDNA2 term set {}; got {}"

_F1 = ("dr_low_{0}", "dr_high_{0}", "dr_c_low_{0}", "dr_c_high_{0}", "a_{0}", "dr0_{0}", "dr_c_{0}",
       "b_low_{0}", "b_high_{0}")
_F2 = ("dr_low_{0}", "dr_high_{0}", "dr_c_low_{0}", "dr_c_high_{0}", "k_{0}", "{1}_{0}", "dr_c_{0}",
       "b_low_{0}", "b_high_{0}")


def _f4(name: str, ks) -> tuple:
    return tuple(
        f.format(name, k)
        for k in ks
        for f in ("theta0_{0}_{1}", "delta_theta_star_{0}_{1}", "delta_theta_{0}_{1}_c", "a_{0}_{1}", "b_{0}_{1}")
    )


def _f3(fams) -> tuple:
    return tuple(f"{p}_{fam}" for fam in fams for p in ("dr_star", "sigma", "b", "dr_c"))


#: (macro, term, parameter names): the flat parameter vector, in order.
#: ``stencil_physics.cuh`` defines ``P_<macro>`` at each group's offset.
#: f1 groups: r_low, r_high, r_c_low, r_c_high, a, r0, r_c, b_low, b_high;
#: f2 groups the same with k for a; f3: r_star, sigma, b, r_c; f4: theta0,
#: delta_theta_star, delta_theta_c, a, b; f5: x_star, x_c, a, b.
PARAM_GROUPS = (
    ("EXC", "UnbondedExcludedVolume", ("eps_exc", *_f3(("base", "back_base", "base_back", "backbone")))),
    ("HB", "HydrogenBonding", (*(f.format("hb") for f in _F1), *_f4("hb", (1, 2, 3, 4, 7, 8)), "eps_hb_weights")),
    ("CROSS", "CrossStacking", (*(f.format("cross", "r0") for f in _F2), *_f4("cross", (1, 2, 3, 4, 7, 8)))),
    ("COAX", "CoaxialStacking", (*(f.format("coax", "dr0") for f in _F2), *_f4("coax", (4, 1, 5, 6)),
                                 "a_coax_1_f6", "b_coax_1_f6")),
    ("DEBYE", "Debye", ("kappa", "prefactor", "smoothing_coeff", "r_cut", "r_high")),
    ("FENE", "Fene", ("eps_backbone", "r0_backbone", "delta_backbone", "fmax", "finf")),
    ("BEXC", "BondedExcludedVolume", ("eps_exc", *_f3(("base", "back_base", "base_back")))),
    ("STACK", "Stacking", (*(f.format("stack") for f in _F1), *_f4("stack", (4, 5, 6)),
                           "neg_cos_phi1_star_stack", "neg_cos_phi1_c_stack", "a_stack_1", "b_neg_cos_phi1_stack",
                           "neg_cos_phi2_star_stack", "neg_cos_phi2_c_stack", "a_stack_2", "b_neg_cos_phi2_stack")),
    ("GEOM", None, ("bx", "by", "hb", "st", "bd1")),
    ("GT", None, ("exc", "hb", "cross", "coax", "debye", "fene", "bexc", "stack")),
)

#: sizes of array-valued parameters (everything else is a scalar)
_SIZES = {"eps_hb_weights": 16}


def param_offsets() -> dict[str, int]:
    """``{macro: offset}`` of every group plus ``TOTAL``."""
    out, off = {}, 0
    for macro, _, names in PARAM_GROUPS:
        out[macro] = off
        off += sum(_SIZES.get(nm, 1) for nm in names)
    out["TOTAL"] = off
    return out


def unpack_params(vec: torch.Tensor) -> dict[str, SimpleNamespace]:
    """Flat parameter vector -> ``{macro: namespace of named tensors}``."""
    out, off = {}, 0
    for macro, _, names in PARAM_GROUPS:
        ns = {}
        for nm in names:
            size = _SIZES.get(nm, 1)
            ns[nm] = vec[off : off + size].reshape(4, 4) if size == 16 else vec[off]
            off += size
        out[macro] = SimpleNamespace(**ns)
    return out


@dc.dataclass
class StencilContext:
    """Loop-invariant inputs of the stencil kernels and twins (slot order)."""

    n: int
    w_terms: tuple  # (exc, hb, cross, coax) one-sided reaches
    w_wide: int  # Debye reach
    params: torch.Tensor  # (P,) flat parameter vector (PARAM_GROUPS)
    seq: torch.Tensor  # (n,) int32
    partners: torch.Tensor  # (2, n) int32 bonded partner slots, -1 when none
    qf: torch.Tensor  # (n,) Debye charge factor
    wstack: torch.Tensor  # (n,) stacking weight of bond (i, i+2)
    dirf: torch.Tensor  # (n,) +1: slot i is the 3'-side of bond (i, i+2); -1 5'-side; 0 none
    checks: torch.Tensor  # (n_checks, 5) f32: fam_a, fam_b, cutoff, d_lo, d_hi
    check_dm: int
    perm: np.ndarray | None
    inv_perm: np.ndarray | None

    def to_slots(self, x: torch.Tensor) -> torch.Tensor:
        """(..., N) original nucleotide order -> slot order."""
        return x if self.perm is None else x[..., torch.as_tensor(self.perm, device=x.device)]

    def from_slots(self, x: torch.Tensor) -> torch.Tensor:
        """(..., N) slot order -> original nucleotide order."""
        return x if self.perm is None else x[..., torch.as_tensor(self.inv_perm, device=x.device)]

    def astype(self, dtype: torch.dtype) -> "StencilContext":
        """The same context with its float tables in ``dtype`` (e.g. a
        float64 twin run as the reference of the float32 arithmetic)."""
        return dc.replace(
            self, params=self.params.to(dtype), qf=self.qf.to(dtype), wstack=self.wstack.to(dtype),
            dirf=self.dirf.to(dtype),
        )


def pack_params(composed, dtype=torch.float32, device=None) -> torch.Tensor:
    """Flat parameter vector of a composed dna2 energy (params bound)."""
    by_name = {type(fn).__name__: fn for fn in composed.energy_fns}
    weights = {type(fn).__name__: w for fn, w in zip(composed.energy_fns, composed.term_weights(), strict=True)}
    g = composed.energy_fns[0].transform_fn.keywords  # the default_transform_soa_fn partial
    extra = {
        "GEOM": dict(bx=g["com_to_backbone_x"], by=g["com_to_backbone_y"], hb=g["com_to_hb"],
                     st=g["com_to_stacking"], bd1=g["com_to_backbone_dna1"]),
        "GT": dict(zip(PARAM_GROUPS[-1][2], (weights[t] for t in UNBONDED_ORDER + BONDED_ORDER), strict=True)),
    }
    device = device if device is not None else composed.energy_fns[0].params.eps_backbone.device
    parts = []
    for macro, term, names in PARAM_GROUPS:
        src = extra[macro] if term is None else None
        for nm in names:
            v = src[nm] if src is not None else getattr(by_name[term].params, nm)
            parts.append(torch.as_tensor(v, dtype=dtype, device=device).reshape(-1))
    return torch.cat(parts)


def prepare_stencil_context(composed, band: StencilBand, dtype=torch.float32, device=None) -> StencilContext:
    """Build the StencilContext of a composed oxDNA2 energy over ``band``.

    ``composed`` must carry its bound parameters (``with_params`` applied).
    Raises for configurations the stencil kernels do not implement: another
    term set, probabilistic sequences, or bonds off slot offset 2.
    """
    names = tuple(type(fn).__name__ for fn in composed.energy_fns)
    if sorted(names) != sorted(UNBONDED_ORDER + BONDED_ORDER):
        raise ValueError(ERR_TERMS.format(UNBONDED_ORDER + BONDED_ORDER, names))
    first = composed.energy_fns[0]
    if getattr(first.topology, "seq", None) is None or np.asarray(first.topology.seq).ndim != 1:
        raise ValueError(ERR_MS_PSEQ)
    params = pack_params(composed, dtype=dtype, device=device)
    device = params.device
    n = band.n
    perm = band.perm
    inv_perm = None if perm is None else np.argsort(perm)
    topo = first.topology
    seq = np.asarray(topo.seq)
    bonded = np.asarray(topo.bonded_neighbors).reshape(-1, 2)
    if perm is not None:
        seq = seq[perm]
        bonded = inv_perm[bonded]
    partners = np.full((2, n), -1, np.int32)
    dirf = np.zeros(n, np.float32)
    for a, b in bonded:  # a = 3'-side slot, b = 5'-side slot
        for x, y in ((a, b), (b, a)):
            row = 0 if partners[0, x] < 0 else 1
            if partners[row, x] >= 0:
                raise ValueError("stencil path supports at most 2 bonded partners per particle")
            partners[row, x] = y
        lo, hi = min(a, b), max(a, b)
        if hi - lo != 2:
            raise ValueError(ERR_MS_BONDS)
        dirf[lo] = 1.0 if a < b else -1.0
    # stacking weight of bond (p, p+2): eps_stack[seq_3', seq_5']
    seq_j = np.roll(seq, -2)
    s3 = np.where(dirf > 0, seq, seq_j)
    s5 = np.where(dirf > 0, seq_j, seq)
    eps_stack = composed.energy_fns[names.index("Stacking")].params.eps_stack
    wstack = eps_stack.to(device=device, dtype=dtype)[torch.as_tensor(s3, device=device).long(),
                                                      torch.as_tensor(s5, device=device).long()]
    wstack = torch.where(torch.as_tensor(dirf != 0, device=device), wstack, torch.zeros_like(wstack))
    debye = composed.energy_fns[names.index("Debye")]
    qf = debye.charge_factors(params)
    if perm is not None:
        qf = qf[torch.as_tensor(perm, device=device)]
    fam = {nm: float(k) for k, nm in enumerate(SITE_FAMILIES)}
    checks = torch.tensor(
        [[fam[fa], fam[fb], cu, d_lo, d_hi] for fa, fb, cu, d_lo, d_hi in band.site_checks],
        dtype=torch.float32, device=device,
    ).reshape(-1, 5)
    return StencilContext(
        n=n,
        w_terms=tuple(int(w) for w in band.w_terms),
        w_wide=int(band.w_wide),
        params=params,
        seq=torch.as_tensor(seq, dtype=torch.int32, device=device),
        partners=torch.as_tensor(partners, device=device),
        qf=qf.to(dtype),
        wstack=wstack,
        dirf=torch.as_tensor(dirf, dtype=dtype, device=device),
        checks=checks,
        check_dm=int(band.check_dm),
        perm=perm,
        inv_perm=inv_perm,
    )


@dc.dataclass(frozen=True)
class OUConstants:
    """Exact-OU BAOAB constants for scalar mass/gamma (float64 host values)."""

    dt: float
    c_t: float
    s_t: float
    c_r: tuple
    s_r: tuple
    half_inv_m: float
    inv_inertia: tuple

    def vector(self, device, dtype=torch.float32) -> torch.Tensor:
        """(13,) kernel form: half_dt, half_inv_m, c_t, s_t, c_r(3), s_r(3), inv_inertia(3)."""
        vals = (0.5 * self.dt, self.half_inv_m, self.c_t, self.s_t, *self.c_r, *self.s_r, *self.inv_inertia)
        return torch.tensor(vals, dtype=dtype, device=device)


def ou_constants(dt: float, kT: float, mass, inertia, gamma_t, gamma_r) -> OUConstants:  # noqa: N803
    """BAOAB/OU constants; raises ERR_MS_SCALAR for per-particle values."""
    m = np.asarray(mass, np.float64).reshape(-1)
    ii = np.asarray(inertia, np.float64).reshape(-1, 3)
    g_t = np.asarray(gamma_t, np.float64).reshape(-1)
    g_r = np.asarray(gamma_r, np.float64).reshape(-1)
    if m.shape[0] != 1 or ii.shape[0] != 1 or g_t.shape[0] != 1 or g_r.shape[0] != 1:
        raise ValueError(ERR_MS_SCALAR)
    inv_m = 1.0 / float(m[0])
    inv_i = tuple(1.0 / float(v) for v in ii[0])
    c_t = float(np.exp(-g_t[0] * dt * inv_m))
    s_t = float(np.sqrt((1.0 - c_t * c_t) * kT / inv_m))
    c_r = tuple(float(np.exp(-g_r[0] * dt * v)) for v in inv_i)
    s_r = tuple(float(np.sqrt((1.0 - cr * cr) * kT / v)) for cr, v in zip(c_r, inv_i, strict=True))
    return OUConstants(float(dt), c_t, s_t, c_r, s_r, 0.5 * dt * inv_m, inv_i)


# Plain twins ---------------------------------------------------------------


def _sites(P, com: Vec3, quat: Quat):
    a1, a2, a3 = quat_frame_soa(quat)
    g = P["GEOM"]
    return SimpleNamespace(
        com=com, a1=a1, a2=a2, a3=a3,
        back=com + g.bx * a1 + g.by * a2,
        base=com + g.hb * a1,
        stack=com + g.st * a1,
        back_dna1=com + g.bd1 * a1,
    )


def _lo(v: Vec3, d: int) -> Vec3:
    return Vec3(*(c[: c.shape[0] - d] for c in v))


def _hi(v: Vec3, d: int) -> Vec3:
    return Vec3(*(c[d:] for c in v))


def band_energy_terms(ctx: StencilContext, com: Vec3, quat: Quat, params: torch.Tensor) -> list:
    """Per-term unbonded band sums (exc, hb, cross, coax, debye), unweighted.

    Pair (i, i+d) for d = 1..w_wide, excluding bonded partners; each
    short-range term up to its own reach, Debye to w_wide.
    """
    P = unpack_params(params)
    s = _sites(P, com, quat)
    n = ctx.n
    seq = ctx.seq.long()
    w_hb = P["HB"].eps_hb_weights
    idx = torch.arange(n, device=com.x.device)
    sums = [com.x.new_zeros(()) for _ in range(5)]
    for d in range(1, min(ctx.w_wide, n - 1) + 1):
        m = n - d
        valid = (ctx.partners[0, :m] != idx[:m] + d) & (ctx.partners[1, :m] != idx[:m] + d)
        back_i, back_j = _lo(s.back, d), _hi(s.back, d)
        r_bb = vnorm(back_j - back_i)
        terms = [None] * 5
        if d <= ctx.w_terms[0] or d <= ctx.w_terms[1] or d <= ctx.w_terms[2]:
            base_i, base_j = _lo(s.base, d), _hi(s.base, d)
        if d <= ctx.w_terms[0]:
            terms[0] = t1.unbonded_exc(
                P["EXC"], vnorm(base_j - base_i), vnorm(base_j - back_i), vnorm(back_j - base_i), r_bb
            )
        if d <= ctx.w_terms[1] or d <= ctx.w_terms[2]:
            g = geom.unbonded_geometry_vec(
                base_i, base_j, _lo(s.a1, d), _hi(s.a1, d), _lo(s.a3, d), _hi(s.a3, d), arccos_poly
            )
            if d <= ctx.w_terms[1]:
                terms[1] = t1.hb_product(P["HB"], g) * w_hb[seq[:m], seq[d:]]
            if d <= ctx.w_terms[2]:
                terms[2] = t1.cross_product(P["CROSS"], g)
        if d <= ctx.w_terms[3]:
            gc = geom.coax_geometry_vec(
                _lo(s.stack, d), _hi(s.stack, d), _lo(s.a1, d), _hi(s.a1, d), _lo(s.a3, d), _hi(s.a3, d),
                arccos_poly,
            )
            terms[3] = t2.coax_value(P["COAX"], gc)
        terms[4] = t2.debye_of(P["DEBYE"], r_bb) * ctx.qf[:m] * ctx.qf[d:]
        for t, e in enumerate(terms):
            if e is not None:
                sums[t] = sums[t] + torch.where(valid, e, torch.zeros_like(e)).sum()
    return sums


def bonded_energy(ctx: StencilContext, com: Vec3, quat: Quat, params: torch.Tensor) -> torch.Tensor:
    """Weighted FENE + bonded excluded volume + stacking over bonds (i, i+2)."""
    P = unpack_params(params)
    s = _sites(P, com, quat)
    m = ctx.n - 2
    dirf = ctx.dirf[:m]
    mask = dirf != 0.0
    pos = dirf > 0.0

    back_i, back_j = _lo(s.back, 2), _hi(s.back, 2)
    base_i, base_j = _lo(s.base, 2), _hi(s.base, 2)
    pf, px, ps, gt = P["FENE"], P["BEXC"], P["STACK"], P["GT"]
    fene = t1.v_fene_smooth(vnorm(back_j - back_i), pf.eps_backbone, pf.r0_backbone, pf.delta_backbone,
                            pf.fmax, pf.finf)
    u, v = vnorm(base_j - back_i), vnorm(back_j - base_i)
    bexc = (
        t1.exc_family(px, "base", vnorm(base_j - base_i))
        + t1.exc_family(px, "back_base", torch.where(pos, u, v))
        + t1.exc_family(px, "base_back", torch.where(pos, v, u))
    )

    def by_side(v: Vec3) -> tuple[Vec3, Vec3]:  # (3'-side, 5'-side) of bond (i, i+2)
        lo, hi = _lo(v, 2), _hi(v, 2)
        return (Vec3(*(torch.where(pos, a, b) for a, b in zip(lo, hi, strict=True))),
                Vec3(*(torch.where(pos, b, a) for a, b in zip(lo, hi, strict=True))))

    g = geom.bonded_geometry_vec(
        *by_side(s.back_dna1), *by_side(s.stack), *by_side(s.a3), *by_side(s.a2), arccos=arccos_poly
    )
    stack = ctx.wstack[:m] * t1.stack_product(ps, g)
    zero = torch.zeros_like(fene)
    return (
        gt.fene * torch.where(mask, fene, zero).sum()
        + gt.bexc * torch.where(mask, bexc, zero).sum()
        + gt.stack * torch.where(mask, stack, zero).sum()
    )


def _unbonded_energy(ctx, com, quat, params):
    gt = unpack_params(params)["GT"]
    w = (gt.exc, gt.hb, gt.cross, gt.coax, gt.debye)
    return sum(wi * e for wi, e in zip(w, band_energy_terms(ctx, com, quat, params), strict=True))


def _grads(energy, com: Vec3, quat: Quat, create_graph: bool = False):
    g = torch.autograd.grad(energy, (*com, *quat), create_graph=create_graph, allow_unused=True)
    return [torch.zeros_like(x) if gi is None else gi for gi, x in zip(g, (*com, *quat), strict=True)]


def _leaf_rows(rows: torch.Tensor, k0: int, k1: int, create_graph: bool) -> list:
    out = []
    for k in range(k0, k1):
        r = rows[k]
        out.append(r if create_graph else r.detach().requires_grad_(True))
    return out


def field_grads_plain(
    ctx: StencilContext, dyn: torch.Tensor, params: torch.Tensor | None = None, create_graph: bool = False
) -> torch.Tensor:
    """Twin of K2: (7, n) [com (3), quat (4)] -> (7, n) [dE/dcom, dE/dquat]
    of the weighted unbonded band energy, by autograd."""
    params = ctx.params if params is None else params
    with torch.enable_grad():
        rows = _leaf_rows(dyn, 0, 7, create_graph)
        com, quat = Vec3(*rows[:3]), Quat(*rows[3:])
        g = _grads(_unbonded_energy(ctx, com, quat, params), com, quat, create_graph)
    return torch.stack(g)


def bonded_grads_plain(ctx: StencilContext, dyn: torch.Tensor, params: torch.Tensor | None = None) -> torch.Tensor:
    """(7, n) [dE/dcom, dE/dquat] of the bonded terms, by autograd (the
    initial force adds it to K2's unbonded gradient, as the reference adds
    its XLA bonded gradient)."""
    params = ctx.params if params is None else params
    with torch.enable_grad():
        rows = _leaf_rows(dyn, 0, 7, False)
        com, quat = Vec3(*rows[:3]), Quat(*rows[3:])
        g = _grads(bonded_energy(ctx, com, quat, params), com, quat)
    return torch.stack(g)


def _force_torque_plain(ctx, com: Vec3, quat: Quat, params, create_graph: bool):
    with torch.enable_grad():
        c, q = com, quat
        if not create_graph:
            c = Vec3(*(x.detach().requires_grad_(True) for x in com))
            q = Quat(*(x.detach().requires_grad_(True) for x in quat))
        e = _unbonded_energy(ctx, c, q, params) + bonded_energy(ctx, c, q, params)
        g = _grads(e, c, q, create_graph)
    force = Vec3(-g[0], -g[1], -g[2])
    return force, quat_cotangent_to_torque_soa(quat, Quat(*g[3:]))


def site_violations_plain(ctx: StencilContext, com: Vec3, quat: Quat) -> torch.Tensor:
    """(n,) count of in-band site checks violated per slot (kernel form:
    bonded partners masked), at the given positions."""
    P = unpack_params(ctx.params.to(com.x.dtype))
    s = _sites(P, com, quat)
    fams = {k: getattr(s, nm) for k, nm in enumerate(SITE_FAMILIES)}
    n = ctx.n
    viol = torch.zeros(n, dtype=com.x.dtype, device=com.x.device)
    idx = torch.arange(n, device=com.x.device)
    checks = [tuple(float(v) for v in row) for row in ctx.checks.tolist()]
    for d in range(1, min(ctx.check_dm, n - 1) + 1):
        m = n - d
        valid = (ctx.partners[0, :m] != idx[:m] + d) & (ctx.partners[1, :m] != idx[:m] + d)
        for fa, fb, cu, d_lo, d_hi in checks:
            if not d_lo < d <= d_hi:
                continue
            sa, sb = fams[int(fa)], fams[int(fb)]
            hit = sum((cb[d:] - ca[:m]) ** 2 for ca, cb in zip(sa, sb, strict=True)) < cu * cu
            if fa != fb:
                hit = hit | (sum((ca[d:] - cb[:m]) ** 2 for ca, cb in zip(sa, sb, strict=True)) < cu * cu)
            viol[:m] += (valid & hit).to(viol.dtype)
    return viol


def multistep_chunk_plain(
    ctx: StencilContext,
    ou: torch.Tensor,
    noise: torch.Tensor,
    state: torch.Tensor,
    params: torch.Tensor | None = None,
    create_graph: bool = False,
) -> torch.Tensor:
    """Twin of K1: ``n_inner`` BAOAB steps over (19, n) slot-order state
    [com 3, quat 4, momentum 3, angmom 3, force 3, torque 3] with the given
    (n_inner, 6, n) normals; returns (20, n), row 19 the entry-position
    band-check violation counts. ``ou``: :meth:`OUConstants.vector`."""
    params = ctx.params if params is None else params
    half, half_inv_m, c_t, s_t = (float(v) for v in ou[:4])
    c_r, s_r, inv_i = ([float(v) for v in ou[k : k + 3]] for k in (4, 7, 10))
    rows = list(state.unbind(0))
    com, quat = Vec3(*rows[0:3]), Quat(*rows[3:7])
    p, ell = Vec3(*rows[7:10]), Vec3(*rows[10:13])
    force, torque = Vec3(*rows[13:16]), Vec3(*rows[16:19])
    with torch.no_grad():
        viol = site_violations_plain(ctx, com, quat)
    for t in range(noise.shape[0]):
        ns = noise[t].to(state.dtype)
        p = p + half * force
        ell = ell + half * torque
        com = com + half_inv_m * p
        quat, ell = free_rotor_soa(quat, ell, inv_i, half)
        p = Vec3(*(c_t * pc + s_t * ns[k] for k, pc in enumerate(p)))
        ell = Vec3(*(c_r[k] * lc + s_r[k] * ns[3 + k] for k, lc in enumerate(ell)))
        com = com + half_inv_m * p
        quat, ell = free_rotor_soa(quat, ell, inv_i, half)
        force, torque = _force_torque_plain(ctx, com, quat, params, create_graph)
        p = p + half * force
        ell = ell + half * torque
    return torch.stack([*com, *quat, *p, *ell, *force, *torque, viol])


# Kernel wrappers -----------------------------------------------------------


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_cuda(name: str, **tensors) -> None:
    for nm, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {nm} must be a CUDA tensor (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")


def _ctx_args(ctx: StencilContext) -> tuple:
    return (
        _ptr(ctx.params), _ptr(ctx.seq), _ptr(ctx.partners), _ptr(ctx.qf), ctypes.c_int(ctx.n),
        *(ctypes.c_int(w) for w in ctx.w_terms), ctypes.c_int(ctx.w_wide),
    )


def field_grads(ctx: StencilContext, dyn: torch.Tensor) -> torch.Tensor:
    """K2: (7, n) [com, quat] -> (7, n) [dE/dcom, dE/dquat] of the weighted
    unbonded band energy. CPU tensors run :func:`field_grads_plain`."""
    if dyn.device.type == "cpu":
        return field_grads_plain(ctx, dyn)
    from mythos_tpu_torch.ops import _build

    _check_cuda("field_grads", dyn=dyn, params=ctx.params)
    if dyn.dtype != torch.float32 or ctx.params.dtype != torch.float32 or dyn.shape != (7, ctx.n):
        raise ValueError(f"field_grads takes (7, {ctx.n}) float32, got {tuple(dyn.shape)} {dyn.dtype}")
    lib = _build.load_library()
    out = torch.empty_like(dyn)
    rc = lib.stencil_field_grads(
        *_ctx_args(ctx), _ptr(dyn), _ptr(out), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    )
    if rc != 0:
        raise RuntimeError(f"stencil_field_grads launch failed: CUDA error {rc}")
    field_grads.launches += 1
    return out


field_grads.launches = 0


def multistep_chunk(ctx: StencilContext, ou: torch.Tensor, noise: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """K1: one chunk of ``noise.shape[0]`` BAOAB steps, (19, n) -> (20, n).

    ``noise``: (n_inner, 6, n) bfloat16 standard normals. CPU tensors run
    :func:`multistep_chunk_plain`. On the card one call enqueues the
    chunk's kernels on the current stream and never synchronises."""
    if state.device.type == "cpu":
        return multistep_chunk_plain(ctx, ou, noise, state)
    from mythos_tpu_torch.ops import _build

    _check_cuda("multistep_chunk", state=state, noise=noise, ou=ou, params=ctx.params)
    n = ctx.n
    if state.dtype != torch.float32 or state.shape != (19, n):
        raise ValueError(f"multistep_chunk takes (19, {n}) float32 state, got {tuple(state.shape)} {state.dtype}")
    if noise.dtype != torch.bfloat16 or noise.dim() != 3 or noise.shape[1:] != (6, n):
        raise ValueError(f"multistep_chunk takes (n_inner, 6, {n}) bfloat16 noise, got {tuple(noise.shape)}")
    if ou.dtype != torch.float32 or ou.shape != (13,):
        raise ValueError("multistep_chunk takes the (13,) float32 OU vector")
    lib = _build.load_library()
    out = torch.empty((20, n), dtype=torch.float32, device=state.device)
    out[:19].copy_(state)
    rc = lib.multistep_chunk(
        *_ctx_args(ctx), _ptr(ctx.wstack), _ptr(ctx.dirf), _ptr(ctx.checks),
        ctypes.c_int(ctx.checks.shape[0]), ctypes.c_int(ctx.check_dm),
        _ptr(ou), _ptr(noise), ctypes.c_int(noise.shape[0]), _ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"multistep_chunk launch failed: CUDA error {rc}")
    multistep_chunk.launches += 1
    return out


multistep_chunk.launches = 0


class FieldGrads(torch.autograd.Function):
    """K2 forward; backward through the twin (double-backward of the band
    energy), as the reference's custom JVP falls back to XLA."""

    @staticmethod
    def forward(fctx, dyn, params, ctx):
        fctx.save_for_backward(dyn, params)
        fctx.sctx = ctx
        return field_grads(dc.replace(ctx, params=params.detach()), dyn.detach())

    @staticmethod
    def backward(fctx, g_out):
        dyn, params = fctx.saved_tensors
        with torch.enable_grad():
            dyn_ = dyn.detach().requires_grad_(True)
            par_ = params.detach().requires_grad_(True)
            out = field_grads_plain(fctx.sctx, dyn_, par_, create_graph=True)
            g_dyn, g_par = torch.autograd.grad(out, (dyn_, par_), g_out, allow_unused=True)
        return g_dyn, g_par, None


class MultistepChunk(torch.autograd.Function):
    """K1 forward; backward through :func:`multistep_chunk_plain`."""

    @staticmethod
    def forward(fctx, state, params, ou, noise, ctx):
        fctx.save_for_backward(state, params, ou, noise)
        fctx.sctx = ctx
        return multistep_chunk(dc.replace(ctx, params=params.detach()), ou, noise, state.detach())

    @staticmethod
    def backward(fctx, g_out):
        state, params, ou, noise = fctx.saved_tensors
        with torch.enable_grad():
            st_ = state.detach().requires_grad_(True)
            par_ = params.detach().requires_grad_(True)
            out = multistep_chunk_plain(fctx.sctx, ou, noise, st_, par_, create_graph=True)
            g_st, g_par = torch.autograd.grad(out, (st_, par_), g_out, allow_unused=True)
        return g_st, g_par, None, None, None
