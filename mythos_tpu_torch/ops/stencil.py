"""Banded-stencil oxDNA2, oxRNA2 and oxDNA1 physics: host prep, plain twins,
kernel wrappers.

Counterpart of mythos_tpu/ops/stencil.py. Slots are the strand-interleave
order of simulators.neighbors.strand_interleave_perm, in which every
interacting pair (i, j) has a small slot offset d = j - i <= ``w_wide``:
base-pair partners sit at d = 1, bonded backbone neighbours at d = 2. The
unbonded terms are evaluated for d = 1..w_wide (each short-range term only
up to its own reach ``w_terms``; Debye-Hueckel out to ``w_wide``), the
bonded terms (FENE, bonded excluded volume, stacking) on the (i, i+2) bonds.

Three model families share the band (``StencilContext.family``, found from
the composed energy's term classes as the reference finds its variants):

* ``"dna2"``: dna1 cross stacking, dna2's f4 + f6 coaxial stacking, the
  backbone site on (a1, a2), dna1 stacking against the dna1-compatible
  backbone site;
* ``"rna2"``: rna2 cross stacking (no theta4), dna1's coaxial stacking
  (f5 of cos phi3 and cos phi4, on the backbone sites), the backbone site
  on (a1, a3), rna2 stacking on the 3'/5' stacking sites and the p3/p5
  axes;
* ``"dna1"``: dna1 cross stacking (with theta4), dna1's coaxial stacking
  (as rna2's), one backbone site on a1 (FENE and stacking's cos phi sites
  on it), dna1 stacking, and no Debye-Hueckel term: its band's ``w_wide``
  is its widest short-range reach, its charge factors are ones that no
  kernel reads, and its Debye entries (weight, parameters, term values,
  gate) are zero.

Two kernels carry the main path (sources in ``ops/csrc``), each with one
compiled instance per family:

* K2 :func:`field_grads` -- one unbonded band evaluation, d/dcom and
  d/dquat (replaces ``_kernel_field_grads``; the initial force of a run,
  and every step's force on the per-step branch). Its gate has a plain
  version too, :func:`band_gates_plain`.
* K1 :func:`multistep_chunk` -- ``n_inner`` BAOAB Langevin steps with the
  bonded terms, and the exact site-distance band checks at the chunk's
  entry positions (replaces ``_multistep_chunk_l``).

Beside each sits its plain PyTorch twin (:func:`field_grads_plain`,
:func:`multistep_chunk_plain`): the band energy written in torch and
differentiated with ``torch.autograd.grad`` -- an independent check of the
kernels' hand-written derivatives. A wrapper runs the twin for CPU tensors
only; on a CUDA tensor it launches its kernel or raises.

Direct differentiation through a run goes through two autograd Functions,
:class:`FieldGrads` and :class:`MultistepChunk`: the kernel forward, the
twin backward (the reference differentiates its XLA functions, not its
Pallas kernels), and :func:`bonded_grads_plain` with ``create_graph``.

Probabilistic sequences (sequence design): K2 has a pseq instance of
each family (oxDNA2, oxRNA2, oxDNA1), which takes the hb weight from
per-slot factors (``StencilContext.hbf``: the marginal factors hw and oh,
the correction ``corr`` and its base-pair ``partner``, energy/seqdep.py)
instead of the sequence and the weight table; the stacking weights
``wstack`` are the expected weights of the bonds. :class:`FieldGrads`
takes the factors as an input, so that its backward reaches the sequence
distribution. K1 refuses a pseq (ERR_MS_PSEQ), as the reference's does:
under one the simulator steps on K2 (simulators/cuda.py).

Arrays are flat ``(rows, n)`` slot-order tensors. All term parameters ride
in one flat vector whose layout (:data:`PARAM_GROUPS`) the CUDA header
``stencil_physics.cuh`` mirrors (``P_*`` offsets); a name the family's
term does not define packs as 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses as dc
from types import SimpleNamespace

import numpy as np
import torch

import mythos_tpu_torch.energy.dna1.terms as t1
import mythos_tpu_torch.energy.dna2.terms as t2
import mythos_tpu_torch.energy.rna2.terms as tr
from mythos_tpu_torch.energy import seqdep
from mythos_tpu_torch.energy.dna1 import geometry as geom
from mythos_tpu_torch.simulators.neighbors import SITE_FAMILIES, StencilBand
from mythos_tpu_torch.soa import Quat, Vec3, free_rotor_soa, quat_cotangent_to_torque_soa, quat_frame_soa, vnorm
from mythos_tpu_torch.utils.math import arccos_poly

UNBONDED_ORDER = ("UnbondedExcludedVolume", "HydrogenBonding", "CrossStacking", "CoaxialStacking", "Debye")
BONDED_ORDER = ("Fene", "BondedExcludedVolume", "Stacking")

ERR_MS_SCALAR = "multi-step path requires scalar mass/gamma/inertia (got per-particle)"
ERR_MS_BONDS = "multi-step path requires every bond at slot offset 2 (duplex interleave)"
ERR_MS_PSEQ = "multi-step path does not support probabilistic sequences yet"
ERR_TERMS = "the stencil path implements exactly the oxDNA1, oxDNA2 or oxRNA2 term set {}; got {}"

#: model family -> its (cross stacking, coaxial stacking, stacking) classes
FAMILIES = {
    "dna2": (t1.CrossStacking, t2.CoaxialStacking, t2.Stacking),
    "rna2": (tr.CrossStacking, t1.CoaxialStacking, tr.Stacking),
    "dna1": (t1.CrossStacking, t1.CoaxialStacking, t1.Stacking),
}
#: the families without a Debye-Hueckel term
NO_DEBYE = frozenset({"dna1"})

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
#: oxDNA1 reads COAXPHI as oxRNA2 does and packs DEBYE and its weight as 0.
#: f1 groups: r_low, r_high, r_c_low, r_c_high, a, r0, r_c, b_low, b_high;
#: f2 groups the same with k for a; f3: r_star, sigma, b, r_c; f4: theta0,
#: delta_theta_star, delta_theta_c, a, b; f5: x_star, x_c, a, b. The groups
#: after GT carry what only oxRNA2 reads: dna1 coax's f5 of cos phi3 and
#: cos phi4 (COAXPHI), rna2 stacking's theta9/theta10 (STACKR) and its
#: stacking sites and p3/p5 axes (RSITES); its cross
#: stacking leaves theta4 (0) unread, its stacking theta4, and GEOM's
#: ``by`` is its backbone's a3 coefficient.
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
    ("COAXPHI", "CoaxialStacking", ("cos_phi3_star_coax", "cos_phi3_c_coax", "a_coax_3p", "b_cos_phi3_coax",
                                  "cos_phi4_star_coax", "cos_phi4_c_coax", "a_coax_4p", "b_cos_phi4_coax")),
    ("STACKR", "Stacking", _f4("stack", (9, 10))),
    ("RSITES", None, ("s3a1", "s3a2", "s5a1", "s5a2", "p3x", "p3y", "p3z", "p5x", "p5y", "p5z")),
)

#: sizes of array-valued parameters (everything else is a scalar)
_SIZES = {"eps_hb_weights": 16}
_NAMES = {macro: names for macro, _, names in PARAM_GROUPS}


def param_offsets() -> dict[str, int]:
    """``{macro: offset}`` of every group plus ``TOTAL``."""
    out, off = {}, 0
    for macro, _, names in PARAM_GROUPS:
        out[macro] = off
        off += sum(_SIZES.get(nm, 1) for nm in names)
    out["TOTAL"] = off
    return out


def unpack_params(vec: torch.Tensor) -> dict[str, SimpleNamespace]:
    """Flat parameter vector -> ``{macro: namespace of named tensors}``; a
    term's first group also carries the names of its later groups (COAX
    holds COAXPHI's, STACK STACKR's)."""
    out, first, off = {}, {}, 0
    for macro, term, names in PARAM_GROUPS:
        ns = {}
        for nm in names:
            size = _SIZES.get(nm, 1)
            ns[nm] = vec[off : off + size].reshape(4, 4) if size == 16 else vec[off]
            off += size
        out[macro] = SimpleNamespace(**ns)
        if term is not None:
            vars(out[first.setdefault(term, macro)]).update(ns)
    return out


@dc.dataclass
class StencilContext:
    """Loop-invariant inputs of the stencil kernels and twins (slot order)."""

    n: int
    family: str  # "dna2", "rna2" or "dna1" (FAMILIES)
    w_terms: tuple  # (exc, hb, cross, coax) one-sided reaches
    w_wide: int  # Debye reach
    params: torch.Tensor  # (P,) flat parameter vector (PARAM_GROUPS)
    seq: torch.Tensor  # (n,) int32
    partners: torch.Tensor  # (2, n) int32 bonded partner slots, -1 when none
    qf: torch.Tensor  # (n,) Debye charge factor (ones under dna1)
    wstack: torch.Tensor  # (n,) stacking weight of bond (i, i+2)
    dirf: torch.Tensor  # (n,) +1: slot i is the 3'-side of bond (i, i+2); -1 5'-side; 0 none
    checks: torch.Tensor  # (n_checks, 5) f32: fam_a, fam_b, cutoff, d_lo, d_hi
    check_dm: int
    perm: np.ndarray | None
    inv_perm: np.ndarray | None
    #: the plain versions run inside a ``torch.utils.checkpoint`` region
    #: (the per-step branch's ``checkpoint_every``): they keep the tensors
    #: their energy saves for its own gradient (:func:`_own_saves`)
    checkpointed: bool = False
    #: under a probabilistic sequence, (10, n) per-slot hb weight factors:
    #: hw (4), oh (4), corr, partner's slot (a float; -1 where none) --
    #: the weight of band pair (i, i + d) is hw_i . oh_{i+d}, plus corr_i
    #: where partner_i = i + d. None for a discrete sequence
    hbf: torch.Tensor | None = None

    @property
    def pseq(self) -> bool:
        return self.hbf is not None

    @property
    def branch(self) -> str:
        """K2's instance: the family, ``_pseq`` under pseq."""
        return self.family + ("_pseq" if self.pseq else "")

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
            dirf=self.dirf.to(dtype), hbf=None if self.hbf is None else self.hbf.to(dtype),
        )


def family_terms(family: str) -> tuple:
    """The term names of a family: every unbonded and bonded term, less
    Debye-Hueckel where the family has none."""
    return tuple(nm for nm in UNBONDED_ORDER + BONDED_ORDER if not (nm == "Debye" and family in NO_DEBYE))


def model_family(composed) -> str:
    """The family of a composed energy (FAMILIES) from its term classes;
    raises for another term set."""
    names = tuple(type(fn).__name__ for fn in composed.energy_fns)
    by_name = {nm: type(fn) for nm, fn in zip(names, composed.energy_fns, strict=True)}
    if sorted(names) not in [sorted(family_terms(f)) for f in FAMILIES]:
        raise ValueError(ERR_TERMS.format(UNBONDED_ORDER + BONDED_ORDER, names))
    for family, classes in FAMILIES.items():
        if sorted(names) == sorted(family_terms(family)) and all(by_name[cls.__name__] is cls for cls in classes):
            return family
    raise ValueError(ERR_TERMS.format({f: [c.__module__ + "." + c.__name__ for c in cls] for f, cls in FAMILIES.items()},
                                      [c.__module__ + "." + c.__name__ for c in by_name.values()]))


def _geometry_values(family: str, g: dict) -> dict:
    """GEOM and RSITES groups from the transform's keywords."""
    if family == "dna2":
        return {
            "GEOM": dict(bx=g["com_to_backbone_x"], by=g["com_to_backbone_y"], hb=g["com_to_hb"],
                         st=g["com_to_stacking"], bd1=g["com_to_backbone_dna1"]),
            "RSITES": dict.fromkeys(_NAMES["RSITES"], 0.0),
        }
    if family == "dna1":  # one backbone site on a1: FENE's and stacking's
        return {
            "GEOM": dict(bx=g["com_to_backbone"], by=0.0, hb=g["com_to_hb"], st=g["com_to_stacking"],
                         bd1=g["com_to_backbone"]),
            "RSITES": dict.fromkeys(_NAMES["RSITES"], 0.0),
        }
    rna2 = ("pos_stack_3_a1", "pos_stack_3_a2", "pos_stack_5_a1", "pos_stack_5_a2",
            "p3_x", "p3_y", "p3_z", "p5_x", "p5_y", "p5_z")
    return {
        "GEOM": dict(bx=g["com_to_backbone_x"], by=g["com_to_backbone_y"], hb=g["com_to_hb"],
                     st=g["com_to_stacking"], bd1=0.0),
        "RSITES": dict(zip(_NAMES["RSITES"], (g[k] for k in rna2), strict=True)),
    }


def pack_params(composed, dtype=torch.float32, device=None) -> torch.Tensor:
    """Flat parameter vector of a composed dna2, rna2 or dna1 energy (params
    bound); a name its term's configuration does not define packs as 0, and
    so does a term the family lacks (dna1's Debye), its weight too."""
    family = model_family(composed)
    by_name = {type(fn).__name__: fn for fn in composed.energy_fns}
    weights = {type(fn).__name__: w for fn, w in zip(composed.energy_fns, composed.term_weights(), strict=True)}
    extra = _geometry_values(family, composed.energy_fns[0].transform_fn.keywords)
    extra["GT"] = dict(zip(_NAMES["GT"], (weights.get(t, 0.0) for t in UNBONDED_ORDER + BONDED_ORDER), strict=True))
    device = device if device is not None else composed.energy_fns[0].params.eps_backbone.device
    parts = []
    for macro, term, names in PARAM_GROUPS:
        for nm in names:
            if term is None:
                v = extra[macro][nm]
            elif term in by_name and nm in by_name[term].params:
                v = getattr(by_name[term].params, nm)
            else:
                v = torch.zeros(_SIZES.get(nm, 1))
            parts.append(torch.as_tensor(v, dtype=dtype, device=device).reshape(-1))
    return torch.cat(parts)


def prepare_stencil_context(composed, band: StencilBand, dtype=torch.float32, device=None) -> StencilContext:
    """Build the StencilContext of a composed oxDNA2, oxRNA2 or oxDNA1
    energy over ``band``.

    ``composed`` must carry its bound parameters (``with_params`` applied).
    Under a probabilistic sequence (hydrogen bonding's ``pseq``) the
    context carries the hb weight factors (``hbf``, from
    ``ops.tiles.pair_static_fields``) and the bonds' expected stacking
    weights, both on the autograd graph of the pseq. Raises for
    configurations the stencil kernels do not implement: another term set,
    or bonds off slot offset 2.
    """
    from mythos_tpu_torch.ops import tiles

    family = model_family(composed)
    names = tuple(type(fn).__name__ for fn in composed.energy_fns)
    first = composed.energy_fns[0]
    hb = composed.energy_fns[names.index("HydrogenBonding")].params
    stack = composed.energy_fns[names.index("Stacking")].params
    pseq = hb.pseq is not None
    params = pack_params(composed, dtype=dtype, device=device)
    device = params.device
    n = band.n
    perm = band.perm
    inv_perm = None if perm is None else np.argsort(perm)
    topo = first.topology
    seq = np.zeros(n, np.int64) if pseq else np.asarray(topo.seq)  # K2's pseq instance reads no sequence
    bonded0 = np.asarray(topo.bonded_neighbors).reshape(-1, 2)
    bonded = bonded0
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
    # stacking weight of bond (p, p+2): eps_stack[seq_3', seq_5'], or under a
    # pseq the bond's expected weight
    if stack.pseq is not None:
        w_bond = seqdep.pair_weights(stack.pseq, bonded0[:, 0], bonded0[:, 1], stack.eps_stack,
                                     stack.pseq_constraints).to(device=device, dtype=dtype)
        wstack = torch.zeros(n, dtype=dtype, device=device).index_put(
            (torch.as_tensor(bonded.min(axis=1), device=device).long(),), w_bond)
    else:
        seq_j = np.roll(seq, -2)
        s3 = np.where(dirf > 0, seq, seq_j)
        s5 = np.where(dirf > 0, seq_j, seq)
        wstack = stack.eps_stack.to(device=device, dtype=dtype)[torch.as_tensor(s3, device=device).long(),
                                                                torch.as_tensor(s5, device=device).long()]
        wstack = torch.where(torch.as_tensor(dirf != 0, device=device), wstack, torch.zeros_like(wstack))
    hbf = None
    if pseq:
        hw, oh, corr, partner, _ = tiles.pair_static_fields(composed, perm)
        hbf = torch.cat([hw.T, oh.T, corr[None], partner[None]]).to(device=device, dtype=dtype).contiguous()
    if family in NO_DEBYE:
        qf = torch.ones(n, dtype=dtype, device=device)
    else:
        qf = composed.energy_fns[names.index("Debye")].charge_factors(params)
        if perm is not None:
            qf = qf[torch.as_tensor(perm, device=device)]
    fam = {nm: float(k) for k, nm in enumerate(SITE_FAMILIES)}
    checks = torch.tensor(
        [[fam[fa], fam[fb], cu, d_lo, d_hi] for fa, fb, cu, d_lo, d_hi in band.site_checks],
        dtype=torch.float32, device=device,
    ).reshape(-1, 5)
    return StencilContext(
        n=n,
        family=family,
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
        hbf=hbf,
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


def _sites(P, com: Vec3, quat: Quat, family: str = "dna2"):
    a1, a2, a3 = quat_frame_soa(quat)
    g = P["GEOM"]
    back = {"dna2": lambda: com + g.bx * a1 + g.by * a2, "rna2": lambda: com + g.bx * a1 + g.by * a3,
            "dna1": lambda: com + g.bx * a1}[family]()
    s = SimpleNamespace(com=com, a1=a1, a2=a2, a3=a3, back=back, base=com + g.hb * a1, stack=com + g.st * a1)
    if family == "rna2":
        r = P["RSITES"]
        s.stack3 = com + r.s3a1 * a1 + r.s3a2 * a2
        s.stack5 = com + r.s5a1 * a1 + r.s5a2 * a2
        s.p3 = r.p3x * a1 + r.p3y * a2 + r.p3z * a3
        s.p5 = r.p5x * a1 + r.p5y * a2 + r.p5z * a3
    else:
        s.back_dna1 = com + g.bd1 * a1
    return s


def _lo(v: Vec3, d: int) -> Vec3:
    return Vec3(*(c[: c.shape[0] - d] for c in v))


def _hi(v: Vec3, d: int) -> Vec3:
    return Vec3(*(c[d:] for c in v))


def _band_pairs(ctx: StencilContext, device) -> tuple[torch.Tensor, torch.Tensor, list]:
    """(lo, hi, ends) of the band's unbonded pairs (lo, hi = lo + d) for
    d = 1..w_wide, offset-major, bonded partners dropped: the pairs up to
    offset w are the first ``ends[w]``."""
    n = ctx.n
    idx = torch.arange(n, device=device)
    partners = ctx.partners.to(device)
    los, his, ends = [], [], [0]
    for d in range(1, min(ctx.w_wide, n - 1) + 1):
        lo = idx[: n - d]
        lo = lo[(partners[0, : n - d] != lo + d) & (partners[1, : n - d] != lo + d)]
        los.append(lo)
        his.append(lo + d)
        ends.append(ends[-1] + lo.numel())
    ends += [ends[-1]] * (max(ctx.w_terms) + 1)  # reaches past the band's end
    return torch.cat(los), torch.cat(his), ends


def band_pair_terms(ctx: StencilContext, com: Vec3, quat: Quat, params: torch.Tensor) -> tuple:
    """Per-pair unbonded band energies, unweighted: (lo, hi, [exc, hb,
    cross, coax, debye]), term k's values those of the first ``len(e_k)``
    pairs (lo, hi) -- the pairs (i, i + d) for d = 1..w_wide, offset-major,
    bonded partners dropped, each short-range term up to its own reach,
    Debye to w_wide (all offsets through each term in one pass); a family
    without Debye gets no Debye values (an empty tensor)."""
    P = unpack_params(params)
    s = _sites(P, com, quat, ctx.family)
    rna2 = ctx.family == "rna2"
    lo, hi, ends = _band_pairs(ctx, com.x.device)
    k_exc, k_hb, k_cross, k_coax = (ends[w] for w in ctx.w_terms)

    def at(v: Vec3, idx: torch.Tensor, k: int) -> Vec3:  # rows idx[:k] of a field
        return Vec3(*(torch.index_select(c, 0, idx[:k]) for c in v))

    back_i, back_j = at(s.back, lo, len(lo)), at(s.back, hi, len(hi))
    r_bb = vnorm(back_j - back_i)
    k_base = max(k_exc, k_hb, k_cross)
    base_i, base_j = at(s.base, lo, k_base), at(s.base, hi, k_base)

    def pre(v: Vec3, k: int) -> Vec3:
        return Vec3(*(c[:k] for c in v))

    exc = t1.unbonded_exc(
        P["EXC"], vnorm(pre(base_j - base_i, k_exc)), vnorm(pre(base_j, k_exc) - pre(back_i, k_exc)),
        vnorm(pre(back_j, k_exc) - pre(base_i, k_exc)), r_bb[:k_exc],
    )
    k_ang = max(k_hb, k_cross)
    g = geom.unbonded_geometry_vec(
        pre(base_i, k_ang), pre(base_j, k_ang), at(s.a1, lo, k_ang), at(s.a1, hi, k_ang), at(s.a3, lo, k_ang),
        at(s.a3, hi, k_ang), arccos_poly,
    )
    hb = t1.hb_product(P["HB"], type(g)(*(x[:k_hb] for x in g)))
    hb = hb * band_hb_weights(ctx, lo[:k_hb], hi[:k_hb], P["HB"].eps_hb_weights)
    cross = (tr.cross_value if rna2 else t1.cross_product)(P["CROSS"], type(g)(*(x[:k_cross] for x in g)))
    dna1_coax = ctx.family != "dna2"  # oxRNA2 composes oxDNA1's coaxial stacking
    gc = geom.coax_geometry_vec(
        at(s.stack, lo, k_coax), at(s.stack, hi, k_coax), at(s.a1, lo, k_coax), at(s.a1, hi, k_coax),
        at(s.a3, lo, k_coax), at(s.a3, hi, k_coax), arccos_poly,
        **(dict(back_i=pre(back_i, k_coax), back_j=pre(back_j, k_coax)) if dna1_coax else {}),
    )
    coax = t1.coax_product(P["COAX"], gc) if dna1_coax else t2.coax_value(P["COAX"], gc)
    if ctx.family in NO_DEBYE:
        debye = r_bb[:0]
    else:
        debye = t2.debye_of(P["DEBYE"], r_bb) * ctx.qf[lo] * ctx.qf[hi]
    return lo, hi, [exc, hb, cross, coax, debye]


def band_hb_weights(ctx: StencilContext, lo: torch.Tensor, hi: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The hb weights of band pairs (lo, hi): ``table[seq_lo, seq_hi]``, or
    under a pseq hw_lo . oh_hi plus corr_lo where hi is lo's partner (the
    reference's ``weight_d``, mythos_tpu/ops/stencil.py:360-371)."""
    if ctx.hbf is None:
        seq = ctx.seq.long()
        return table[seq[lo], seq[hi]]
    f = ctx.hbf
    w = (f[0:4][:, lo] * f[4:8][:, hi]).sum(0)
    return w + torch.where(f[9][lo] == hi.to(f.dtype), f[8][lo], torch.zeros_like(w))


def band_energy_terms(ctx: StencilContext, com: Vec3, quat: Quat, params: torch.Tensor) -> list:
    """Per-term unbonded band sums (exc, hb, cross, coax, debye), unweighted
    (:func:`band_pair_terms` summed)."""
    return [e.sum() for e in band_pair_terms(ctx, com, quat, params)[2]]


#: K2's tally of the band pairs (stencil_grads.cu, K2_TALLY): the pairs
#: each term's gate keeps, then the classes -- a short-range term kept,
#: Debye alone, nothing
BAND_TALLY = ("UnbondedExcludedVolume", "HydrogenBonding", "CrossStacking", "CoaxialStacking", "Debye",
              "short", "debye", "skipped")
#: the parameter names of the four excluded-volume distances' upper cutoffs
#: (base-base, base_j - back_i, back_j - base_i, back-back)
_EXC_CUTOFFS = ("dr_c_base", "dr_c_back_base", "dr_c_base_back", "dr_c_backbone")


def band_gates_plain(ctx: StencilContext, dyn: torch.Tensor) -> dict:
    """Plain version of K2's gate: {term: (w_wide, n) bool}, entry [d - 1, i]
    for the band pair (i, i + d) of the (7, n) slot-order state, set where
    the pair is in the band (i + d < n, not bonded partners), within the
    term's offset reach (``w_terms``; Debye ``w_wide``), and one of the
    term's site distances lies inside the upper cutoff its radial factor
    reads from the parameters (past it the factor, and so the term and its
    gradient, is exactly zero). Excluded volume: any of its four distances;
    hydrogen bonding and cross stacking: base-base; coaxial stacking:
    stack-stack; Debye: backbone-backbone (never under dna1)."""
    P = unpack_params(ctx.params.to(dyn.dtype))
    s = _sites(P, Vec3(*dyn[:3]), Quat(*dyn[3:7]), ctx.family)
    n, w_wide = ctx.n, ctx.w_wide
    idx = torch.arange(n, device=dyn.device)
    reaches = (*ctx.w_terms, w_wide)
    gates = {nm: torch.zeros((w_wide, n), dtype=torch.bool, device=dyn.device) for nm in UNBONDED_ORDER}
    for d in range(1, min(w_wide, n - 1) + 1):
        m = n - d
        valid = (ctx.partners[0, :m] != idx[:m] + d) & (ctx.partners[1, :m] != idx[:m] + d)
        r_ee, r_eb, r_be, r_bb, r_ss = (
            vnorm(_hi(b, d) - _lo(a, d))
            for a, b in ((s.base, s.base), (s.back, s.base), (s.base, s.back), (s.back, s.back), (s.stack, s.stack))
        )
        exc = P["EXC"]
        inside = {
            "UnbondedExcludedVolume": torch.stack([r < getattr(exc, nm) for r, nm in
                                                   zip((r_ee, r_eb, r_be, r_bb), _EXC_CUTOFFS, strict=True)]).any(0),
            "HydrogenBonding": r_ee < P["HB"].dr_c_high_hb,
            "CrossStacking": r_ee < P["CROSS"].dr_c_high_cross,
            "CoaxialStacking": r_ss < P["COAX"].dr_c_high_coax,
            "Debye": (r_bb < P["DEBYE"].r_cut) & (ctx.family not in NO_DEBYE),
        }
        for nm, w in zip(UNBONDED_ORDER, reaches, strict=True):
            if d <= w:
                gates[nm][d - 1, :m] = valid & inside[nm]
    return gates


def band_gate_counts(ctx: StencilContext, dyn: torch.Tensor) -> dict:
    """K2's tally (:data:`BAND_TALLY`) by the plain gate: the band pairs each
    term's gate keeps, and the band pairs by class."""
    gates = band_gates_plain(ctx, dyn)
    short = torch.stack([gates[nm] for nm in UNBONDED_ORDER[:4]]).any(0)
    counts = {nm: int(g.sum()) for nm, g in gates.items()}
    counts.update(short=int(short.sum()), debye=int((gates["Debye"] & ~short).sum()))
    counts["skipped"] = _band_pairs(ctx, dyn.device)[0].numel() - counts["short"] - counts["debye"]
    return counts


def bonded_energy(ctx: StencilContext, com: Vec3, quat: Quat, params: torch.Tensor) -> torch.Tensor:
    """Weighted FENE + bonded excluded volume + stacking over bonds (i, i+2)."""
    P = unpack_params(params)
    s = _sites(P, com, quat, ctx.family)
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

    if ctx.family == "rna2":
        (s5_3, _), (_, s3_5) = by_side(s.stack5), by_side(s.stack3)
        (p5_3, _), (_, p3_5) = by_side(s.p5), by_side(s.p3)
        g = tr.stack_geometry_vec(s5_3, s3_5, *by_side(s.back), *by_side(s.a3), p5_3, p3_5, *by_side(s.a2),
                                  arccos=arccos_poly)
        stack = ctx.wstack[:m] * tr.stack_product(ps, g)
    else:
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


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _own_saves(ctx: StencilContext):
    """Inside a checkpointed region (``ctx.checkpointed``), keep the tensors
    an energy saves for its own gradient as they are.

    A plain version differentiates its energy inside the call; under
    ``torch.utils.checkpoint`` (the per-step branch's ``checkpoint_every``)
    the checkpoint's hooks would otherwise drop those tensors and recompute
    the whole checkpointed stretch to get them back, at every step. What the
    gradient itself saves for a backward stays the checkpoint's, and that is
    most of the graph: on an H100 (``chip_smoke.py`` phase 12c, 1,000 nt,
    40 per-step steps in 4 intervals) the graph held after the forward is
    26.4 MiB with ``checkpoint_every`` 1 against 79.7 MiB without. The peak
    of that evaluation does not fall (108.7 against 104.0 MiB above its
    start): at 40 steps the backward's own working set sets it. Elsewhere
    no hooks: each costs the host microseconds a saved tensor."""
    return torch.autograd.graph.saved_tensors_hooks(_same, _same) if ctx.checkpointed else contextlib.nullcontext()


def _grads(energy, com: Vec3, quat: Quat, create_graph: bool = False):
    g = torch.autograd.grad(energy, (*com, *quat), create_graph=create_graph, allow_unused=True)
    return [torch.zeros_like(x) if gi is None else gi for gi, x in zip(g, (*com, *quat), strict=True)]


def _leaf_rows(rows: torch.Tensor, k0: int, k1: int, create_graph: bool) -> list:
    """Rows k0..k1 to differentiate by: with ``create_graph`` the rows
    themselves where they are on the graph (the gradient stays a function
    of whatever they depend on), else detached leaves."""
    out = []
    for k in range(k0, k1):
        r = rows[k]
        out.append(r if create_graph and r.requires_grad else r.detach().requires_grad_(True))
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
        with _own_saves(ctx):
            e = _unbonded_energy(ctx, com, quat, params)
        g = _grads(e, com, quat, create_graph)
    return torch.stack(g)


def bonded_grads_plain(
    ctx: StencilContext, dyn: torch.Tensor, params: torch.Tensor | None = None, create_graph: bool = False
) -> torch.Tensor:
    """(7, n) [dE/dcom, dE/dquat] of the bonded terms, by autograd (the
    initial force adds it to K2's unbonded gradient, as the reference adds
    its XLA bonded gradient). With ``create_graph`` the result stays on the
    graph of ``dyn``, ``params`` and ``ctx.wstack`` (direct differentiation
    through a run)."""
    params = ctx.params if params is None else params
    with torch.enable_grad():
        rows = _leaf_rows(dyn, 0, 7, create_graph)
        com, quat = Vec3(*rows[:3]), Quat(*rows[3:])
        with _own_saves(ctx):
            e = bonded_energy(ctx, com, quat, params)
        g = _grads(e, com, quat, create_graph)
    return torch.stack(g)


def _force_torque_plain(ctx, com: Vec3, quat: Quat, params, create_graph: bool):
    with torch.enable_grad():
        c, q = com, quat
        if not create_graph:
            c = Vec3(*(x.detach().requires_grad_(True) for x in com))
            q = Quat(*(x.detach().requires_grad_(True) for x in quat))
        with _own_saves(ctx):
            e = _unbonded_energy(ctx, c, q, params) + bonded_energy(ctx, c, q, params)
        g = _grads(e, c, q, create_graph)
    force = Vec3(-g[0], -g[1], -g[2])
    return force, quat_cotangent_to_torque_soa(quat, Quat(*g[3:]))


def site_violations_plain(ctx: StencilContext, com: Vec3, quat: Quat) -> torch.Tensor:
    """(n,) count of in-band site checks violated per slot (kernel form:
    bonded partners masked), at the given positions."""
    P = unpack_params(ctx.params.to(com.x.dtype))
    s = _sites(P, com, quat, ctx.family)
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
    if ctx.pseq:
        raise ValueError(ERR_MS_PSEQ)
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


def _instance(name: str, ctx: StencilContext) -> str:
    """The C entry point of the kernel's instance for the context's family
    (``<name>`` for dna2, ``<name>_rna2``, ``<name>_dna1``)."""
    return name if ctx.family == "dna2" else f"{name}_{ctx.family}"


def _field_grads(ctx: StencilContext, dyn: torch.Tensor, count: bool = False):
    """:func:`field_grads` on CUDA tensors: (out, counts), ``counts`` (with
    ``count``) the kernel's tally {name: pairs} of the band pairs by gate
    (:data:`BAND_TALLY`; :func:`band_gate_counts`), else None."""
    from mythos_tpu_torch.ops import _build

    _check_cuda("field_grads", dyn=dyn, params=ctx.params)
    if dyn.dtype != torch.float32 or ctx.params.dtype != torch.float32 or dyn.shape != (7, ctx.n):
        raise ValueError(f"field_grads takes (7, {ctx.n}) float32, got {tuple(dyn.shape)} {dyn.dtype}")
    name = _instance("stencil_field_grads", ctx)
    pseq = ()
    if ctx.pseq:
        _check_cuda("field_grads", hbf=ctx.hbf)
        if ctx.hbf.dtype != torch.float32 or ctx.hbf.shape != (10, ctx.n):
            raise ValueError(f"field_grads takes (10, {ctx.n}) float32 hb factors, got {tuple(ctx.hbf.shape)}")
        name, pseq = name + "_pseq", (_ptr(ctx.hbf),)
    out = torch.empty_like(dyn)
    lib = _build.load_library()
    parts = torch.empty((lib.stencil_field_grads_blocks(ctx.n), len(BAND_TALLY)), dtype=torch.int32,
                        device=dyn.device) if count else None
    rc = getattr(lib, name)(
        *_ctx_args(ctx), *pseq, _ptr(dyn), _ptr(out), ctypes.c_void_p(None if parts is None else parts.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    field_grads.launches += 1
    field_grads.by_family[ctx.branch] = field_grads.by_family.get(ctx.branch, 0) + 1
    return out, None if parts is None else dict(zip(BAND_TALLY, parts.sum(0).tolist(), strict=True))


def field_grads(ctx: StencilContext, dyn: torch.Tensor) -> torch.Tensor:
    """K2: (7, n) [com, quat] -> (7, n) [dE/dcom, dE/dquat] of the weighted
    unbonded band energy (its pseq instance under a pseq). CPU tensors run
    :func:`field_grads_plain`. ``launches`` counts every launch,
    ``by_family`` each instance's (:data:`K2_BRANCHES`)."""
    if dyn.device.type == "cpu":
        return field_grads_plain(ctx, dyn)
    return _field_grads(ctx, dyn)[0]


#: K2's instances: each family's, and each family's pseq instance
K2_BRANCHES = (*FAMILIES, *(f"{f}_pseq" for f in FAMILIES))
field_grads.launches = 0
field_grads.by_family = dict.fromkeys(K2_BRANCHES, 0)


def multistep_chunk(ctx: StencilContext, ou: torch.Tensor, noise: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """K1: one chunk of ``noise.shape[0]`` BAOAB steps, (19, n) -> (20, n).

    ``noise``: (n_inner, 6, n) bfloat16 standard normals. CPU tensors run
    :func:`multistep_chunk_plain`. On the card one call enqueues the
    chunk's ``n_inner + 1`` kernels on the current stream and never
    synchronises. ``launches`` counts every call that launched, ``by_family``
    each family's."""
    if ctx.pseq:
        raise ValueError(ERR_MS_PSEQ)
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
    name = _instance("multistep_chunk", ctx)
    out = torch.empty((27, n), dtype=torch.float32, device=state.device)
    out[:19].copy_(state)
    state_out, alt = out[:20], out[20:]  # alt: the positions' second buffer
    rc = getattr(_build.load_library(), name)(
        *_ctx_args(ctx), _ptr(ctx.wstack), _ptr(ctx.dirf), _ptr(ctx.checks),
        ctypes.c_int(ctx.checks.shape[0]), ctypes.c_int(ctx.check_dm),
        _ptr(ou), _ptr(noise), ctypes.c_int(noise.shape[0]), _ptr(state_out), _ptr(alt),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    multistep_chunk.launches += 1
    multistep_chunk.by_family[ctx.family] += 1
    return state_out


multistep_chunk.launches = 0
multistep_chunk.by_family = dict.fromkeys(FAMILIES, 0)


#: the float tables each kernel reads from the context rather than as an
#: input of its Function (``seq``, ``partners`` and ``checks`` are integer
#: or constant tables)
_K2_HIDDEN = ("qf",)
_K1_HIDDEN = ("qf", "dirf")


def _no_hidden_grads(name: str, ctx: StencilContext, hidden: tuple) -> None:
    """Raise where the kernel reads a context tensor that needs a gradient
    its Function does not take as an input: the gradient would drop
    silently."""
    for field in hidden:
        t = getattr(ctx, field)
        if t is not None and t.requires_grad:
            raise ValueError(f"{name}: ctx.{field} needs a gradient but is not an input of the Function")


class FieldGrads(torch.autograd.Function):
    """K2 forward; backward through :func:`field_grads_plain` (the double
    backward of the band energy).

    ``FieldGrads.apply(dyn, params, ctx, hbf=None)``: the forward is the
    kernel call of :func:`field_grads` (its plain version on CPU tensors),
    the backward always the plain version -- the port of the reference's
    custom-JVP rule, which differentiates its XLA band instead of the
    Pallas kernel (``_kernel_field_grads_jvp`` -> ``_xla_field_grads_layout``,
    mythos_tpu/ops/stencil.py:1486-1488). Under a pseq ``hbf`` is the
    context's hb weight factors (``ctx.hbf``), an input so that the
    backward reaches the sequence distribution (the reference's rule
    differentiates ``weight_d``). K2 reads no ``wstack``; a ``ctx.qf``, or
    a ``ctx.hbf`` not given as ``hbf``, that needs a gradient raises."""

    @staticmethod
    def forward(fctx, dyn, params, ctx, hbf=None):
        _no_hidden_grads("FieldGrads", ctx, _K2_HIDDEN if hbf is not None else (*_K2_HIDDEN, "hbf"))
        fctx.save_for_backward(dyn, params, hbf)
        fctx.sctx = ctx
        fixed = dict(hbf=hbf.detach()) if hbf is not None else {}
        return field_grads(dc.replace(ctx, params=params.detach(), **fixed), dyn.detach())

    @staticmethod
    def backward(fctx, g_out):
        dyn, params, hbf = fctx.saved_tensors
        with torch.enable_grad():
            dyn_ = dyn.detach().requires_grad_(True)
            par_ = params.detach().requires_grad_(True)
            ins, sctx = [dyn_, par_], fctx.sctx
            if hbf is not None:
                hbf_ = hbf.detach().requires_grad_(True)
                ins.append(hbf_)
                sctx = dc.replace(sctx, hbf=hbf_)
            out = field_grads_plain(sctx, dyn_, par_, create_graph=True)
            g = torch.autograd.grad(out, ins, g_out, allow_unused=True)
        return g[0], g[1], None, g[2] if hbf is not None else None


class MultistepChunk(torch.autograd.Function):
    """K1 forward; backward through :func:`multistep_chunk_plain`.

    ``MultistepChunk.apply(state, params, wstack, ou, noise, ctx)`` -> (20,
    n): the forward is the kernel call of :func:`multistep_chunk` (its
    plain version on CPU tensors), the backward always the plain version
    with ``create_graph`` -- the port of the reference's custom-JVP rule
    (``_multistep_chunk_l_jvp`` -> ``_xla_multistep_reference``,
    mythos_tpu/ops/stencil.py:2399-2401). The gradient reaches ``state``,
    ``params`` and the stacking weight ``wstack`` (``eps_stack[seq_3',
    seq_5']``, so ``eps_stack_base``); row 19, the band checks' counts,
    carries none. Only the chunk's entry state is saved. A ``ctx.qf`` or
    ``ctx.dirf`` that needs a gradient raises."""

    @staticmethod
    def forward(fctx, state, params, wstack, ou, noise, ctx):
        _no_hidden_grads("MultistepChunk", ctx, _K1_HIDDEN)
        fctx.save_for_backward(state, params, wstack, ou, noise)
        fctx.sctx = ctx
        return multistep_chunk(dc.replace(ctx, params=params.detach(), wstack=wstack.detach()), ou, noise,
                               state.detach())

    @staticmethod
    def backward(fctx, g_out):
        state, params, wstack, ou, noise = fctx.saved_tensors
        with torch.enable_grad():
            st_ = state.detach().requires_grad_(True)
            par_ = params.detach().requires_grad_(True)
            ws_ = wstack.detach().requires_grad_(True)
            out = multistep_chunk_plain(dc.replace(fctx.sctx, wstack=ws_), ou, noise, st_, par_, create_graph=True)
            g_st, g_par, g_ws = torch.autograd.grad(out, (st_, par_, ws_), g_out, allow_unused=True)
        return g_st, g_par, g_ws, None, None, None
