"""Block-tile oxDNA2 and oxDNA1 unbonded physics: host prep, plain versions,
kernels.

Counterpart of the host side of mythos_tpu/ops/oxdna_tiles.py. Particles
(in ``perm`` order) form index blocks of B; a symmetric block-neighbor
table (simulators.neighbors.BlockNeighborList) lists each row block's
column blocks. Per-particle data is one (n_pad, F) row array: the body
fields (com, a1, a2, a3 -- a2 as its own fields, as the reference keeps
it, so that quaternion cotangents off the unit sphere agree) followed by
a static tail (hb weight factors, the probabilistic-sequence correction
and partner, Debye charge factor, bonded partners, the global id). The
"debye" kind carries only the backbone site.

Three kernels, hand-written in CUDA (``ops/csrc/tiles.cu``), carry the
tables, beside their plain PyTorch versions (autograd over a gathered
(nb, B, cap*B) tile evaluation; a wrapper runs the plain version for CPU
tensors only, and on a CUDA tensor launches its kernel or raises):

* K3 :func:`tile_forces` -- row forces under the full mask (replaces
  ``_bwd_rows_impl(forces_only=True)``): the block tier's force.
* K4 :func:`tile_energies` -- per-term sums under the triangular mask
  (replaces ``_fwd_impl``): the DiffTRe re-evaluation.
* K5 :func:`tile_row_grads` -- the row gradients of K4's sums for a
  cotangent (replaces ``_bwd_rows_impl``): K4's backward.

All three share one kernel body: each gates every pair by reach first
(:func:`tile_gates_plain` is the gate's plain version) and runs each
term's physics only inside its cutoff; each can tally the pairs of its
mask by class (:func:`tile_gate_counts`).

Model family (``TileSpec.family``, from the composed energy's term
classes): oxDNA2, or oxDNA1 -- one table of the "short" kind (no
Debye-Hueckel term), the backbone site on a1, oxDNA1's coaxial stacking --
for which each of K3, K4 and K5 has its own instance: the block tier's
force and the DiffTRe re-evaluation under oxDNA1. (The reference takes
oxDNA1's one table as its "full" kind with no Debye term to sum; the
short kind here sums the same four terms.)

Probabilistic sequences (``TileSpec.pseq``; sequence design): the hb
weight factors hold the marginal factors of ``energy.seqdep``, and the
correction ``corr_i`` adds to the weight of the pair whose column is the
row's base-pair partner (``partner_i``, a slot id). Each kernel has a
pseq instance of each family (``<name>[_dna1]_pseq``); K5's writes 21
fields: beside the 16, the right factor's gradient (pairs j < i, the
role-swapped hb product) and the correction's (j > i, j = partner_i), so
that the map's gradient reaches the sequence distribution.

:class:`UnbondedTileEnergies` ties K4 to K5, and its parameter gradient
to :func:`params_grad` (the port of ``_params_grad_xla``: autograd over
the batched tile evaluation, as the reference leaves it to XLA). The
tiles read the packed parameter vector of ops/stencil.py (``P_*`` offsets
of ``stencil_physics.cuh``), the one vector K1/K2 read.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses as dc

import numpy as np
import torch

import mythos_tpu_torch.energy.dna1.terms as t1
import mythos_tpu_torch.energy.dna2.terms as t2
from mythos_tpu_torch.energy import blocks, seqdep
from mythos_tpu_torch.energy.dna1 import geometry as geom
from mythos_tpu_torch.energy.dna1.nucleotide import NucleotideSoA as NucleotideSoA1
from mythos_tpu_torch.energy.dna2.nucleotide import NucleotideSoA
from mythos_tpu_torch.ops import stencil
from mythos_tpu_torch.soa import BodySoA, Quat, Vec3, quat_frame_soa, vnorm
from mythos_tpu_torch.utils.math import arccos_poly

#: row layout of the "full"/"short" kinds (mythos_tpu/ops/oxdna_tiles.py:57-73)
_COM, _A1, _A2, _A3 = 0, 3, 6, 9
_HW = 12  # left hb-weight factor one_hot(seq) @ W (4)
_OH = 16  # right hb-weight factor one_hot(seq) (4)
_CORR = 20  # probabilistic-sequence correction of the partner's weight (0 for a discrete sequence)
_QF = 21  # Debye end-charge factor
_PARTNER = 22  # probabilistic-sequence partner's slot id (-1 for a discrete sequence)
_PREV, _NXT, _GID = 23, 24, 25
N_FIELDS = 26
#: row layout of the "debye" kind: backbone site, charge factor, partners, id
_DB_QF, _DB_PREV, _DB_NXT, _DB_GID = 3, 4, 5, 6
N_FIELDS_DEBYE = 8
_BIG = 1e9  # the global id of a padded row

#: terms of each kind, in the order of the sums (and of the kernels' P_GT slots)
KIND_TERMS = {
    "full": ("UnbondedExcludedVolume", "HydrogenBonding", "CrossStacking", "CoaxialStacking", "Debye"),
    "short": ("UnbondedExcludedVolume", "HydrogenBonding", "CrossStacking", "CoaxialStacking"),
    "debye": ("Debye",),
}
_KIND_CODE = {"full": 0, "short": 1, "debye": 2}
#: offset of each term's weight in the P_GT group
_GT_SLOT = {nm: k for k, nm in enumerate(KIND_TERMS["full"])}

#: term modules the tile kernels implement (as the reference's, ops/oxdna_tiles.py:1226)
KERNEL_MODULES = ("mythos_tpu_torch.energy.dna1.terms", "mythos_tpu_torch.energy.dna2.terms")
ERR_TERMS = "the tile kernels implement the oxDNA2 term set and oxDNA1's {}; got {}"
ERR_UNSUPPORTED_MODEL = (
    "the tile kernels support dna1/dna2 terms only, the oxDNA2 term set and oxDNA1's (got {}); use a "
    "non-symmetric block table (symmetric=False) for the block sums"
)
ERR_DNA1_KIND = "oxDNA1 has no Debye-Hueckel term: its one table is of the short kind, got {!r}"
ERR_HIDDEN_GRAD = (
    "fused_grads_ctx: a context's parameters or static tail need a gradient, which K3 would drop; pass "
    "create_graph=True"
)


@dc.dataclass(frozen=True)
class TileSpec:
    """Static shape of one table's tiles (the reference's TileSpec without
    the TPU knobs: no row-block packing, grid steps, residency or lane
    padding; an empty slot is skipped, so no pad block is needed; a banded
    window's slots are block ids like any other, so no banded flag)."""

    block_size: int
    cap: int  # column-block slots per row block
    n: int  # real particles
    n_blocks: int
    kind: str  # "full" | "short" | "debye"
    geometry: tuple  # (back a1, back a2, base a1, stack a1) site offsets
    family: str = "dna2"  # "dna2" | "dna1" (ops.stencil.FAMILIES)
    pseq: bool = False  # hb weights from a probabilistic sequence (the correction on)

    @property
    def n_pad(self) -> int:
        return self.n_blocks * self.block_size

    @property
    def terms(self) -> tuple:
        return KIND_TERMS[self.kind]

    @property
    def n_fields(self) -> int:
        return N_FIELDS_DEBYE if self.kind == "debye" else N_FIELDS

    @property
    def n_force_fields(self) -> int:
        return 3 if self.kind == "debye" else 12

    @property
    def n_grad_fields(self) -> int:
        """K5's width: back site + charge factor (debye kind); the body and
        hw (16); under pseq also oh and corr (21)."""
        if self.kind == "debye":
            return 4
        return _CORR + 1 if self.pseq else _HW + 4

    @property
    def branch(self) -> str:
        """The kernels' instance: the family, ``_pseq`` under pseq."""
        return self.family + ("_pseq" if self.pseq else "")

    @property
    def id_offsets(self) -> tuple[int, int, int]:
        """(gid, prev, nxt) field offsets for the mask."""
        return (_DB_GID, _DB_PREV, _DB_NXT) if self.kind == "debye" else (_GID, _PREV, _NXT)


@dc.dataclass(frozen=True)
class TileContext:
    """Loop-invariant inputs of one table's tiles, prepared once per run."""

    spec: TileSpec
    params: torch.Tensor  # (P,) packed parameters (ops/stencil.py layout)
    static_tail: torch.Tensor  # (n_pad, F - n_body) body-independent fields
    unbonded: tuple  # ((composed index, term name), ...) in sum order
    perm: torch.Tensor | None  # perm[slot] = original index


def _geometry_of(composed, family: str) -> tuple:
    g = composed.energy_fns[0].transform_fn.keywords
    if family == "dna1":  # one backbone site on a1
        return float(g["com_to_backbone"]), 0.0, float(g["com_to_hb"]), float(g["com_to_stacking"])
    return (float(g["com_to_backbone_x"]), float(g["com_to_backbone_y"]), float(g["com_to_hb"]),
            float(g["com_to_stacking"]))


def pair_static_fields(composed, perm: np.ndarray | None):
    """Static per-slot pair fields in slot order: (hw (n, 4), oh (n, 4),
    corr (n,), partner (n,), qf (n,)), as the reference's
    (oxdna_tiles.py:1481-1539). hw/oh are the left/right factors of the hb
    weight: hw = one_hot(seq) @ eps_hb_weights, oh = one_hot(seq), corr 0
    and partner -1 for a discrete sequence; under a probabilistic sequence
    the marginal factors, the correction of each base pair's partner and
    that partner's slot (``seqdep.factorized_weights``). Autograd reaches
    the weights and the sequence distribution through them. qf is the Debye
    end-charge factor (ones without a Debye term, read by no kernel)."""
    by_name = {type(fn).__name__: fn for fn in composed.energy_fns}
    hb = by_name["HydrogenBonding"].params
    w = hb.eps_hb_weights
    n = composed.energy_fns[0].topology.n_nucleotides
    perm_t = None if perm is None else torch.as_tensor(perm, device=w.device)
    if hb.pseq is None:
        seq = torch.as_tensor(np.asarray(composed.energy_fns[0].topology.seq), device=w.device)
        if perm_t is not None:
            seq = seq[perm_t]
        oh = torch.nn.functional.one_hot(seq.long(), 4).to(w.dtype)
        hw, corr = oh @ w, torch.zeros(n, dtype=w.dtype, device=w.device)
        partner = torch.full((n,), -1.0, dtype=w.dtype, device=w.device)
    else:
        hw, oh, partner_np, corr = seqdep.factorized_weights(hb.pseq, w, hb.pseq_constraints)
        hw, oh, corr = hw.to(w.dtype), oh.to(w.dtype), corr.to(w.dtype)
        if perm is not None:
            hw, oh, corr = hw[perm_t], oh[perm_t], corr[perm_t]
            partner_np = np.argsort(perm)[partner_np[perm]]
        partner = torch.as_tensor(partner_np, dtype=w.dtype, device=w.device)
    if "Debye" not in by_name:
        qf = torch.ones(n, dtype=w.dtype, device=w.device)
    else:
        qf = by_name["Debye"].charge_factors(w)
        qf = qf if perm_t is None else qf[perm_t]
    return hw, oh, corr, partner, qf


def kernel_family(composed) -> str | None:
    """The composed energy's family where every term is oxDNA2's or oxDNA1's
    (KERNEL_MODULES): the tile kernels, and ERR_TERMS for a term set of those
    modules that they do not implement. None where a term is another model's
    (oxRNA2, the oxNA hybrid): the block sums of energy/blocks.py."""
    if any(type(fn).__module__ not in KERNEL_MODULES for fn in composed.energy_fns):
        return None
    try:
        return stencil.model_family(composed)
    except ValueError as e:
        raise ValueError(ERR_TERMS.format(stencil.UNBONDED_ORDER + stencil.BONDED_ORDER,
                                          [f"{type(fn).__module__}.{type(fn).__name__}" for fn in composed.energy_fns]
                                          )) from e


def _tile_family(composed) -> str:
    """The composed energy's family, oxDNA2 or oxDNA1; raises for another
    (the reference's unsupported-model message)."""
    family = kernel_family(composed)
    if family is None:
        raise ValueError(ERR_UNSUPPORTED_MODEL.format(
            sorted({type(fn).__module__ for fn in composed.energy_fns})))
    return family


def prepare_tile_context(composed, sym_ids: torch.Tensor, block_size: int, kind: str = "full", perm=None) -> TileContext:
    """The TileContext of one (n_blocks, cap) table of a composed oxDNA2 or
    oxDNA1 energy (parameters bound; oxDNA1 tables are of the short kind);
    ``perm`` as the table was built with."""
    family = _tile_family(composed)
    if family == "dna1" and kind != "short":
        raise ValueError(ERR_DNA1_KIND.format(kind))
    names = tuple(type(fn).__name__ for fn in composed.energy_fns)
    first = composed.energy_fns[0]
    fene = composed.energy_fns[names.index("Fene")]
    dtype = fene.params.eps_backbone.dtype
    params = stencil.pack_params(composed, dtype=dtype)
    device = params.device
    n = first.topology.n_nucleotides
    nb, cap = sym_ids.shape
    if nb != -(-n // block_size):
        raise ValueError(f"table has {nb} row blocks; {n} particles in blocks of {block_size} need {-(-n // block_size)}")
    pseq = composed.energy_fns[names.index("HydrogenBonding")].params.pseq is not None
    spec = TileSpec(block_size=block_size, cap=cap, n=n, n_blocks=nb, kind=kind,
                    geometry=_geometry_of(composed, family), family=family, pseq=pseq and kind != "debye")
    n_pad = spec.n_pad
    perm = None if perm is None else np.asarray(perm)
    perm_t = None if perm is None else torch.as_tensor(perm, device=device)
    bonded = np.asarray(first.topology.bonded_neighbors)
    if perm is not None:
        bonded = np.argsort(perm)[bonded]  # bonds in slot indices
    prev, nxt = blocks.bonded_partner_table(n_pad, bonded)
    idx = np.arange(n_pad)
    ids = [torch.as_tensor(a, dtype=dtype, device=device) for a in (prev, nxt, np.where(idx < n, idx, _BIG))]

    def pad(c, value=0.0):
        return torch.nn.functional.pad(c.to(dtype), (0, n_pad - n), value=value)

    hw, oh, corr, partner, qf = pair_static_fields(composed, perm)
    zeros = torch.zeros(n_pad, dtype=dtype, device=device)
    if kind == "debye":
        tail = [pad(qf), *ids, zeros]
    else:
        tail = [pad(hw[:, k]) for k in range(4)] + [pad(oh[:, k]) for k in range(4)]
        tail += [pad(corr), pad(qf), pad(partner, -1.0), *ids]  # a padded row's partner -1 matches no column
    by_name = {nm: i for i, nm in enumerate(names)}
    return TileContext(
        spec=spec,
        params=params,
        static_tail=torch.stack(tail, dim=-1),
        unbonded=tuple((by_name[nm], nm) for nm in spec.terms),
        perm=perm_t,
    )


def prepare_contexts(composed, sym_ids, block_size: int, perm=None) -> tuple:
    """TileContexts of one table ("full") or a (tight, wide) pair ("short" +
    "debye"); under oxDNA1 one table of the short kind. They serve K3 (the
    block tier) and K4/K5 (the DiffTRe map) alike. Call once per run,
    outside any loop over steps or states."""
    if _tile_family(composed) == "dna1":
        if isinstance(sym_ids, (tuple, list)):
            raise ValueError(ERR_DNA1_KIND.format("(tight, wide)"))
        return (prepare_tile_context(composed, sym_ids, block_size, "short", perm),)
    if isinstance(sym_ids, (tuple, list)):
        return (
            prepare_tile_context(composed, sym_ids[0], block_size, "short", perm),
            prepare_tile_context(composed, sym_ids[1], block_size, "debye", perm),
        )
    return (prepare_tile_context(composed, sym_ids, block_size, "full", perm),)


def _as_tables(sym_ids) -> tuple:
    return tuple(sym_ids) if isinstance(sym_ids, (tuple, list)) else (sym_ids,)


def pad_ids(spec: TileSpec, sym_ids: torch.Tensor) -> torch.Tensor:
    """A table of fewer slots widened to the spec's ``cap`` with empty slots."""
    cap = sym_ids.shape[1]
    if cap == spec.cap:
        return sym_ids
    return torch.nn.functional.pad(sym_ids, (0, spec.cap - cap), value=spec.n_blocks)


def dynamic_rows(ctx: TileContext, body: BodySoA) -> torch.Tensor:
    """The (n_pad, F) rows of a body (original order): body fields in slot
    order, then the static tail. Differentiable in the body."""
    spec = ctx.spec
    com, quat = body.center, body.orientation
    if ctx.perm is not None:
        com = Vec3(*(torch.index_select(c, 0, ctx.perm) for c in com))
        quat = Quat(*(torch.index_select(c, 0, ctx.perm) for c in quat))
    a1, a2, a3 = quat_frame_soa(quat)
    if spec.kind == "debye":
        bx, by = spec.geometry[0], spec.geometry[1]
        dyn = list(com + bx * a1 + by * a2)
    else:
        dyn = [*com, *a1, *a2, *a3]
    pad = spec.n_pad - spec.n
    dyn = torch.stack([torch.nn.functional.pad(c, (0, pad)) for c in dyn], dim=-1)
    return torch.cat([dyn.to(ctx.static_tail.dtype), ctx.static_tail], dim=1)


# Tile evaluation in torch (plain versions and the parameter gradient) ------


def _gather_cols(rows: torch.Tensor, ids: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """(nb, cap*B, F) column panels; an empty slot's gid becomes _BIG so the
    mask drops it."""
    nb, cap = ids.shape
    b_sz, f = spec.block_size, spec.n_fields
    valid = ids < spec.n_blocks
    safe = torch.where(valid, ids, 0).long()
    cols = rows.reshape(spec.n_blocks, b_sz, f)[safe]  # (nb, cap, B, F)
    g = spec.id_offsets[0]
    gid = torch.where(valid[:, :, None], cols[..., g], _BIG)
    cols = torch.cat([cols[..., :g], gid[..., None], cols[..., g + 1 :]], dim=-1)
    return cols.reshape(nb, cap * b_sz, f)


def _vec(x: torch.Tensor, off: int) -> Vec3:
    return Vec3(x[..., off], x[..., off + 1], x[..., off + 2])


def _tile_mask(ri: torch.Tensor, cj: torch.Tensor, spec: TileSpec, triangular: bool) -> torch.Tensor:
    """(nb, B, M) validity: no self pair, no bonded partner, real rows and
    columns; ``triangular`` keeps j > i (each unordered pair once)."""
    g, p, x = spec.id_offsets
    ig, jg = ri[..., g], cj[..., g]
    keep = (jg > ig) if triangular else (jg != ig)
    return keep & (ig < spec.n) & (jg < spec.n) & (jg != ri[..., p]) & (jg != ri[..., x])


def _tile_terms(ri: torch.Tensor, cj: torch.Tensor, params: torch.Tensor, spec: TileSpec):
    """Unweighted (nb, B, M) energies of every term of the kind, in sum
    order, plus the weight-free hb product (None for the debye kind).
    ``ri``: (nb, B, 1, F) rows, ``cj``: (nb, 1, M, F) columns."""
    P = stencil.unpack_params(params)
    _, _, hbo, sto = spec.geometry
    if spec.kind == "debye":
        r = vnorm(_vec(cj, 0) - _vec(ri, 0))
        return [t2.debye_of(P["DEBYE"], r) * ri[..., _DB_QF] * cj[..., _DB_QF]], None
    com_i, a1_i, a2_i, a3_i = (_vec(ri, o) for o in (_COM, _A1, _A2, _A3))
    com_j, a1_j, a2_j, a3_j = (_vec(cj, o) for o in (_COM, _A1, _A2, _A3))
    back_i, back_j = _back(spec, com_i, a1_i, a2_i), _back(spec, com_j, a1_j, a2_j)
    base_i, base_j = com_i + hbo * a1_i, com_j + hbo * a1_j
    r_bb = vnorm(back_j - back_i)
    exc = t1.unbonded_exc(P["EXC"], vnorm(base_j - base_i), vnorm(base_j - back_i), vnorm(back_j - base_i), r_bb)
    g = geom.unbonded_geometry_vec(base_i, base_j, a1_i, a1_j, a3_i, a3_j, arccos_poly)
    hb_prod = t1.hb_product(P["HB"], g)
    weight = sum(ri[..., _HW + k] * cj[..., _OH + k] for k in range(4))
    if spec.pseq:
        weight = weight + torch.where(cj[..., _GID] == ri[..., _PARTNER], ri[..., _CORR], 0.0)
    stack_i, stack_j = com_i + sto * a1_i, com_j + sto * a1_j
    if spec.family == "dna1":  # oxDNA1's coaxial stacking: the phi cosines on the backbone sites
        coax = t1.coax_product(P["COAX"], geom.coax_geometry_vec(stack_i, stack_j, a1_i, a1_j, a3_i, a3_j,
                                                                 arccos_poly, back_i=back_i, back_j=back_j))
    else:
        coax = t2.coax_value(P["COAX"], geom.coax_geometry_vec(stack_i, stack_j, a1_i, a1_j, a3_i, a3_j, arccos_poly))
    out = [exc, hb_prod * weight, t1.cross_product(P["CROSS"], g), coax]
    if spec.kind == "full":
        out.append(t2.debye_of(P["DEBYE"], r_bb) * ri[..., _QF] * cj[..., _QF])
    return out, hb_prod


def _back(spec: TileSpec, com: Vec3, a1: Vec3, a2: Vec3) -> Vec3:
    """The family's backbone site: com + bx a1 + by a2 (oxDNA2), com + bx a1 (oxDNA1)."""
    bx, by = spec.geometry[0], spec.geometry[1]
    return com + bx * a1 if spec.family == "dna1" else com + bx * a1 + by * a2


def _split(rows: torch.Tensor, cols: torch.Tensor, spec: TileSpec):
    return rows.reshape(spec.n_blocks, spec.block_size, 1, spec.n_fields), cols[:, None]


def _masked_sums(rows, cols, params, spec: TileSpec, triangular: bool) -> list:
    ri, cj = _split(rows, cols, spec)
    mask = _tile_mask(ri, cj, spec, triangular)
    terms, _ = _tile_terms(ri, cj, params, spec)
    return [torch.where(mask, e, torch.zeros_like(e)).sum() for e in terms]


def _term_slots(spec: TileSpec) -> slice:
    """The kind's terms as a slice of the five sums (and of the P_GT weights)."""
    slots = [_GT_SLOT[nm] for nm in spec.terms]
    return slice(slots[0], slots[-1] + 1)


def _gt_slots(spec: TileSpec) -> slice:
    """The kind's term weights as a slice of the parameter vector."""
    gt0, slots = stencil.param_offsets()["GT"], _term_slots(spec)
    return slice(gt0 + slots.start, gt0 + slots.stop)


def term_weights(params: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """The kind's term weights, read from the parameter vector's P_GT group."""
    return params[_gt_slots(spec)]


#: upper cutoff of each radial factor, as offsets into the parameter vector
#: (stencil_physics.cuh): exc_f3's r_c of the base-base, base_j-back_i,
#: back_j-base_i and back-back distances (P_EXC + 1/5/9/13, + 3); f1's and
#: f2's r_c_high (+ 3); Debye's r_cut (+ 3)
_EXC_CUTS = (4, 8, 12, 16)
_R_C_HIGH = 3
_R_CUT = 3


def tile_gates_plain(rows: torch.Tensor, params: torch.Tensor, ids: torch.Tensor, spec: TileSpec) -> dict:
    """Plain version of K3's gate: {term: (nb, B, M) bool}, each term of
    the kind where one of its site distances lies inside the upper cutoff
    its radial factor reads from ``params`` (past it the factor, and so the
    term and its gradient, is exactly zero). Excluded volume: any of its
    four distances; hydrogen bonding and cross stacking: base-base; coaxial
    stacking: stack-stack; Debye: backbone-backbone."""
    off = stencil.param_offsets()
    ri, cj = _split(rows, _gather_cols(rows, ids, spec), spec)
    if spec.kind == "debye":
        return {"Debye": vnorm(_vec(cj, 0) - _vec(ri, 0)) < params[off["DEBYE"] + _R_CUT]}
    _, _, hbo, sto = spec.geometry
    com_i, a1_i, a2_i = (_vec(ri, o) for o in (_COM, _A1, _A2))
    com_j, a1_j, a2_j = (_vec(cj, o) for o in (_COM, _A1, _A2))
    back_i, back_j = _back(spec, com_i, a1_i, a2_i), _back(spec, com_j, a1_j, a2_j)
    base_i, base_j = com_i + hbo * a1_i, com_j + hbo * a1_j
    r_bb, r_ee = vnorm(back_j - back_i), vnorm(base_j - base_i)
    r_exc = (r_ee, vnorm(base_j - back_i), vnorm(back_j - base_i), r_bb)
    r_ss = vnorm((com_j + sto * a1_j) - (com_i + sto * a1_i))
    gates = {
        "UnbondedExcludedVolume": torch.stack(
            [r < params[off["EXC"] + k] for r, k in zip(r_exc, _EXC_CUTS, strict=True)]).any(0),
        "HydrogenBonding": r_ee < params[off["HB"] + _R_C_HIGH],
        "CrossStacking": r_ee < params[off["CROSS"] + _R_C_HIGH],
        "CoaxialStacking": r_ss < params[off["COAX"] + _R_C_HIGH],
        "Debye": r_bb < params[off["DEBYE"] + _R_CUT],
    }
    return {nm: gates[nm] for nm in spec.terms}


def tile_gate_counts(rows: torch.Tensor, params: torch.Tensor, ids: torch.Tensor, spec: TileSpec,
                     triangular: bool = False) -> dict:
    """The kernels' classes of the pairs under the full mask (K3, K5) or,
    with ``triangular``, under the triangular one (K4), by the plain gate:
    ``short`` (a short-range term in reach), ``debye`` (Debye alone) and
    ``skipped`` (nothing)."""
    gates = tile_gates_plain(rows, params, ids, spec)
    ri, cj = _split(rows, _gather_cols(rows, ids, spec), spec)
    mask = _tile_mask(ri, cj, spec, triangular=triangular)
    short = torch.zeros_like(mask)
    for nm in spec.terms:
        if nm != "Debye":
            short |= gates[nm]
    debye = gates["Debye"] & ~short if "Debye" in gates else torch.zeros_like(mask)
    return {"short": int((mask & short).sum()), "debye": int((mask & debye).sum()),
            "skipped": int((mask & ~short & ~debye).sum())}


def _body_row_grads(rows, params, ids, gt, spec: TileSpec, width: int) -> torch.Tensor:
    """d/d(rows[:, :width]) of sum_t gt_t x (symmetric-mask sum of term t),
    row side only (columns and the other fields held constant)."""
    rows = rows.detach()
    with torch.enable_grad():
        head = rows[:, :width].clone().requires_grad_(True)
        r = torch.cat([head, rows[:, width:]], dim=1)
        sums = _masked_sums(r, _gather_cols(rows, ids, spec), params.detach(), spec, triangular=False)
        total = sum(w * s for w, s in zip(gt.detach(), sums, strict=True))
        (g,) = torch.autograd.grad(total, head, allow_unused=True)
    return torch.zeros_like(head) if g is None else g


def tile_forces_graph(rows: torch.Tensor, params: torch.Tensor, ids: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """:func:`tile_forces_plain` with ``create_graph``: the same row forces,
    differentiable in ``rows`` -- through a row's own fields and through its
    appearance as a column of every block that lists it, which the second
    derivative needs (the force itself holds the columns constant) -- and in
    ``params``, the term weights included. ``rows`` and ``params`` are used
    as given (on the graph where they are), else as fresh leaves."""
    width = spec.n_force_fields
    with torch.enable_grad():
        rows = rows if rows.requires_grad else rows.detach().requires_grad_(True)
        head = rows[:, :width]
        r = torch.cat([head, rows[:, width:]], dim=1)
        sums = _masked_sums(r, _gather_cols(rows, ids, spec), params, spec, triangular=False)
        total = sum(w * s for w, s in zip(term_weights(params, spec), sums, strict=True))
        (g,) = torch.autograd.grad(total, head, create_graph=True)
    return g


def tile_energies_plain(rows: torch.Tensor, params: torch.Tensor, ids: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """Plain version of K4: (T,) unweighted per-term sums, triangular mask."""
    with torch.no_grad():
        return torch.stack(_masked_sums(rows, _gather_cols(rows, ids, spec), params, spec, triangular=True))


def tile_forces_plain(rows: torch.Tensor, params: torch.Tensor, ids: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """Plain version of K3: (n_pad, 12) dE/d(com, a1, a2, a3) -- or (n_pad,
    3) dE/d(back) for the debye kind -- of the term-weighted energy, by
    autograd of the full-mask sum on the row side."""
    return _body_row_grads(rows, params, ids, term_weights(params, spec), spec, spec.n_force_fields)


def tile_row_grads_plain(
    rows: torch.Tensor, params: torch.Tensor, ids: torch.Tensor, gt: torch.Tensor, spec: TileSpec
) -> torch.Tensor:
    """Plain version of K5: d(gt . K4's sums)/d(rows), (n_pad, 16) -- the
    12 body fields under the full mask, the hb weight factor hw under the
    triangular mask (it enters the forward on the row side only) -- or
    (n_pad, 4) back site + charge factor for the debye kind. Under pseq
    (n_pad, 21): also the right factor oh (it enters on the column side, so
    its gradient gathers the pairs j < i) and the correction corr, each the
    whole derivative of K4's triangular hb sum, by autograd through the
    rows and the columns alike."""
    if spec.kind == "debye":
        return _body_row_grads(rows, params, ids, gt, spec, 4)
    body = _body_row_grads(rows, params, ids, gt, spec, 12)
    rows = rows.detach()
    hi = spec.n_grad_fields
    with torch.enable_grad():
        tail = rows[:, _HW:hi].clone().requires_grad_(True)
        r = torch.cat([rows[:, :_HW], tail, rows[:, hi:]], dim=1)
        ri, cj = _split(r, _gather_cols(r if spec.pseq else rows, ids, spec), spec)
        mask = _tile_mask(ri, cj, spec, triangular=True)
        terms, _ = _tile_terms(ri, cj, params.detach(), spec)
        hb = terms[spec.terms.index("HydrogenBonding")]
        (g,) = torch.autograd.grad(gt[1].detach() * torch.where(mask, hb, torch.zeros_like(hb)).sum(), tail)
    return torch.cat([body, g], dim=1)


def params_grad(
    rows: torch.Tensor, params: torch.Tensor, ids: torch.Tensor, gt: torch.Tensor, spec: TileSpec
) -> torch.Tensor:
    """d(gt . per-term sums)/d(params): the port of ``_params_grad_xla``,
    autograd over the batched tile evaluation under the triangular mask
    (each unordered pair once, so orientation-asymmetric parameter pairs
    such as theta2/theta3 are not mixed). Runs only when the parameter
    cotangent is asked for."""
    rows = rows.detach()
    with torch.enable_grad():
        p = params.detach().clone().requires_grad_(True)
        sums = _masked_sums(rows, _gather_cols(rows, ids, spec), p, spec, triangular=True)
        (g,) = torch.autograd.grad(sum(w * s for w, s in zip(gt.detach(), sums, strict=True)), p)
    return g


# Kernel wrappers -------------------------------------------------------------


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _kernel_args(name: str, rows, params, ids, spec: TileSpec) -> tuple:
    stencil._check_cuda(name, rows=rows, params=params, ids=ids)
    if rows.dtype != torch.float32 or params.dtype != torch.float32 or rows.shape != (spec.n_pad, spec.n_fields):
        raise ValueError(f"{name} takes ({spec.n_pad}, {spec.n_fields}) float32 rows, got {tuple(rows.shape)} {rows.dtype}")
    if ids.dtype != torch.int32 or ids.shape != (spec.n_blocks, spec.cap):
        raise ValueError(f"{name} takes a ({spec.n_blocks}, {spec.cap}) int32 table, got {tuple(ids.shape)} {ids.dtype}")
    return (
        _ptr(params), _ptr(rows), _ptr(ids), ctypes.c_int(spec.n), ctypes.c_int(spec.n_blocks),
        ctypes.c_int(spec.block_size), ctypes.c_int(spec.cap), ctypes.c_int(_KIND_CODE[spec.kind]),
    )


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launch(name: str, rows, params, ids, spec: TileSpec, outs: tuple, count: bool):
    """Call C entry ``name`` with the table arguments, the ``outs`` and a
    (3,) int32 tally when ``count`` (else a null pointer); the tally or None."""
    from mythos_tpu_torch.ops import _build

    args = _kernel_args(name, rows, params, ids, spec)
    counts = torch.zeros(3, dtype=torch.int32, device=rows.device) if count else None
    rc = getattr(_build.load_library(), name)(
        *args, *(_ptr(o) for o in outs), ctypes.c_void_p(None if counts is None else counts.data_ptr()), _stream()
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return counts


def _instance(name: str, spec: TileSpec) -> str:
    """The C entry of kernel ``name``'s instance for the spec's family, and
    under pseq its pseq instance (``<name>[_dna1][_pseq]``)."""
    return name + ("" if spec.family == "dna2" else f"_{spec.family}") + ("_pseq" if spec.pseq else "")


def _count(fn, spec: TileSpec) -> None:
    fn.launches += 1
    fn.by_family[spec.branch] = fn.by_family.get(spec.branch, 0) + 1


#: the kernels' instances a wrapper counts (``by_family``): each family's,
#: and each family's pseq instance
BRANCHES = ("dna2", "dna1", "dna2_pseq", "dna1_pseq")


def _tile_forces(rows, params, ids, spec: TileSpec, count: bool = False):
    """:func:`tile_forces` on CUDA tensors: (forces, counts), ``counts``
    (with ``count``) the kernel's (3,) int32 tally of the ordered pairs
    under the full mask that needed the short-range terms, Debye alone,
    and nothing (:func:`tile_gate_counts`), else None."""
    out = torch.empty((spec.n_pad, spec.n_force_fields), dtype=torch.float32, device=rows.device)
    counts = _launch(_instance("tile_forces", spec), rows, params, ids, spec, (out,), count)
    _count(tile_forces, spec)
    return out, counts


def tile_forces(rows: torch.Tensor, params: torch.Tensor, ids: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """K3: (n_pad, 12) row forces dE/d(com, a1, a2, a3), or (n_pad, 3)
    dE/d(back) for the debye kind. CPU tensors run :func:`tile_forces_plain`.
    ``launches`` counts every launch, ``by_family`` each instance's
    (:data:`BRANCHES`)."""
    if rows.device.type == "cpu":
        return tile_forces_plain(rows, params, ids, spec)
    return _tile_forces(rows, params, ids, spec)[0]


tile_forces.launches = 0
tile_forces.by_family = dict.fromkeys(BRANCHES, 0)


class TileForces(torch.autograd.Function):
    """K3 forward; backward through :func:`tile_forces_graph` (the double
    backward of the tile energy).

    ``TileForces.apply(rows, params, ids, spec)``: the forward is the kernel
    call of :func:`tile_forces` (its plain version on CPU tensors), the
    backward the VJP of the plain version with ``create_graph`` with respect
    to the whole ``rows`` -- the body fields and the static tail, whose hb
    weights and Debye charge factors depend on parameters
    (:func:`pair_static_fields`) -- and to ``params``: the port of the
    reference's rule that differentiates its XLA tiles instead of the
    Pallas kernel. K3 reads nothing else but the integer table, so nothing
    that needs a gradient is hidden from the Function."""

    @staticmethod
    def forward(fctx, rows, params, ids, spec):
        fctx.save_for_backward(rows, params, ids)
        fctx.spec = spec
        with _keep_saves(True):  # the plain version (CPU) differentiates inside: its saves are its own
            return tile_forces(rows.detach(), params.detach(), ids, spec)

    @staticmethod
    def backward(fctx, g_out):
        rows, params, ids = fctx.saved_tensors
        with torch.enable_grad():
            rows_ = rows.detach().requires_grad_(True)
            par_ = params.detach().requires_grad_(True)
            out = tile_forces_graph(rows_, par_, ids, fctx.spec)
            g_rows, g_par = torch.autograd.grad(out, (rows_, par_), g_out, allow_unused=True)
        return g_rows, g_par, None, None


def _tile_energies(rows, params, ids, spec: TileSpec, count: bool = False):
    """:func:`tile_energies` on CUDA tensors: (sums, counts), ``counts``
    as :func:`_tile_forces` gives them but under the triangular mask
    (:func:`tile_gate_counts` with ``triangular``)."""
    from mythos_tpu_torch.ops import _build

    parts = _build.load_library().tile_energies_partials(spec.n_blocks, spec.block_size)
    buf = torch.empty(parts * 5 + 5, dtype=torch.float32, device=rows.device)
    counts = _launch(_instance("tile_energies", spec), rows, params, ids, spec, (buf[: parts * 5], buf[parts * 5 :]),
                     count)
    _count(tile_energies, spec)
    return buf[parts * 5 :][_term_slots(spec)], counts


def tile_energies(rows: torch.Tensor, params: torch.Tensor, ids: torch.Tensor, spec: TileSpec) -> torch.Tensor:
    """K4: (T,) unweighted per-term sums under the triangular mask. CPU
    tensors run :func:`tile_energies_plain`. ``launches`` counts every
    launch, ``by_family`` each instance's (:data:`BRANCHES`)."""
    if rows.device.type == "cpu":
        return tile_energies_plain(rows, params, ids, spec)
    return _tile_energies(rows, params, ids, spec)[0]


tile_energies.launches = 0
tile_energies.by_family = dict.fromkeys(BRANCHES, 0)


def _tile_row_grads(rows, params, ids, gt, spec: TileSpec, count: bool = False):
    """:func:`tile_row_grads` on CUDA tensors: (row gradients, counts),
    ``counts`` as :func:`_tile_forces` gives them (the same gate and mask)."""
    # the kernel reads the cotangent where K3 reads the term weights
    p = params.detach().clone()
    p[_gt_slots(spec)] = gt.detach().to(p.dtype)
    out = torch.empty((spec.n_pad, spec.n_grad_fields), dtype=torch.float32, device=rows.device)
    counts = _launch(_instance("tile_row_grads", spec), rows, p, ids, spec, (out,), count)
    _count(tile_row_grads, spec)
    return out, counts


def tile_row_grads(
    rows: torch.Tensor, params: torch.Tensor, ids: torch.Tensor, gt: torch.Tensor, spec: TileSpec
) -> torch.Tensor:
    """K5: (n_pad, 16) -- (n_pad, 21) under pseq, (n_pad, 4) for the debye
    kind -- row gradients of gt . K4's sums. CPU tensors run
    :func:`tile_row_grads_plain`. ``launches`` counts every launch,
    ``by_family`` each instance's (:data:`BRANCHES`)."""
    if rows.device.type == "cpu":
        return tile_row_grads_plain(rows, params, ids, gt, spec)
    return _tile_row_grads(rows, params, ids, gt, spec)[0]


tile_row_grads.launches = 0
tile_row_grads.by_family = dict.fromkeys(BRANCHES, 0)


class UnbondedTileEnergies(torch.autograd.Function):
    """Per-term unbonded sums over a symmetric table: K4 forward; backward
    K5 when the rows need a gradient and :func:`params_grad` when the
    parameters do (ref ``unbonded_tile_energies``, oxdna_tiles.py:1184-1212)."""

    @staticmethod
    def forward(fctx, rows, params, ids, spec):
        fctx.save_for_backward(rows, params, ids)
        fctx.spec = spec
        return tile_energies(rows.detach(), params.detach(), ids, spec)

    @staticmethod
    def backward(fctx, gt):
        rows, params, ids = fctx.saved_tensors
        spec = fctx.spec
        gt = gt.contiguous()
        g_rows = g_params = None
        if fctx.needs_input_grad[0]:
            g = tile_row_grads(rows.detach(), params.detach(), ids, gt, spec)
            g_rows = torch.nn.functional.pad(g, (0, spec.n_fields - g.shape[1]))
        if fctx.needs_input_grad[1]:
            g_params = params_grad(rows, params, ids, gt, spec)
        return g_rows, g_params, None, None


def unbonded_tile_energies(rows, params, ids, spec: TileSpec) -> torch.Tensor:
    """(T,) per-term unbonded sums [exc, hb, cross, coax, (debye)] of one table."""
    return UnbondedTileEnergies.apply(rows, params, ids, spec)


# Composed energies and forces --------------------------------------------------


def _nucleotides(composed, body: BodySoA):
    cls = NucleotideSoA1 if _tile_family(composed) == "dna1" else NucleotideSoA
    return cls.from_body_soa(body, **composed.energy_fns[0].transform_fn.keywords)


def _bonded_energy(composed, unbonded_idx: set, body: BodySoA) -> torch.Tensor:
    nuc = _nucleotides(composed, body)
    weights = composed.term_weights()
    return sum(
        weights[i] * fn.compute_energy(nuc) for i, fn in enumerate(composed.energy_fns) if i not in unbonded_idx
    )


def fused_energy_ctx(composed, ctxs: tuple, body: BodySoA, sym_ids) -> torch.Tensor:
    """Total energy of a body from prepared contexts: the unbonded terms
    through :func:`unbonded_tile_energies` (K4, differentiable through
    K5 and :func:`params_grad`), the bonded terms on their pair lists;
    weighted like ``ComposedEnergyFunction.__call__``."""
    weights = composed.term_weights()
    total, unbonded = 0.0, set()
    for ctx, ids in zip(ctxs, _as_tables(sym_ids), strict=True):
        sums = unbonded_tile_energies(dynamic_rows(ctx, body), ctx.params, pad_ids(ctx.spec, ids), ctx.spec)
        for k, (i, _) in enumerate(ctx.unbonded):
            total = total + weights[i] * sums[k]
            unbonded.add(i)
    return total + _bonded_energy(composed, unbonded, body)


def _keep_saves(on: bool):
    """Inside a checkpointed region, keep what an energy saves for its own
    gradient (ops.stencil._own_saves): the gradient is taken inside the
    region, and the checkpoint's hooks would recompute the region for it."""
    return torch.autograd.graph.saved_tensors_hooks(stencil._same, stencil._same) if on else contextlib.nullcontext()


def fused_grads_ctx(composed, ctxs: tuple, body: BodySoA, sym_ids, create_graph: bool = False,
                    checkpointed: bool = False) -> tuple[Vec3, Quat]:
    """(dE/dcom, dE/dquat) of the total energy: K3 on each table, the
    row-field packing transposed back to the body by autograd, plus the
    bonded gradient by autograd (ref ``fused_grads_ctx``). No forward
    energy kernel runs.

    With ``create_graph`` (direct differentiation through a run) the result
    stays on the autograd graph of the body, the contexts' parameters and
    static tails, and the composed energy's parameters (K3 through
    :class:`TileForces`); the body's tensors
    are used as given where they are on the graph. Without it, contexts that
    need a gradient raise (ERR_HIDDEN_GRAD) rather than lose it.
    ``checkpointed``: the call runs inside a ``torch.utils.checkpoint``
    region (:func:`_keep_saves`)."""
    if not create_graph and torch.is_grad_enabled():
        if any(ctx.params.requires_grad or ctx.static_tail.requires_grad for ctx in ctxs):
            raise ValueError(ERR_HIDDEN_GRAD)
    comps = (*body.center, *body.orientation)
    leaves = [c if create_graph and c.requires_grad else c.detach().requires_grad_(True) for c in comps]
    b = BodySoA(Vec3(*leaves[:3]), Quat(*leaves[3:]))
    outs, cots, unbonded = [], [], set()
    with torch.enable_grad():
        for ctx, ids in zip(ctxs, _as_tables(sym_ids), strict=True):
            with _keep_saves(checkpointed):
                rows = dynamic_rows(ctx, b)
            ids = pad_ids(ctx.spec, ids)
            if create_graph:
                g = TileForces.apply(rows, ctx.params, ids, ctx.spec)
            else:  # no Function on the path without gradients: its host cost is per step
                g = tile_forces(rows.detach(), ctx.params.detach(), ids, ctx.spec)
            outs.append(rows)
            cots.append(torch.nn.functional.pad(g, (0, ctx.spec.n_fields - g.shape[1])))
            unbonded.update(i for i, _ in ctx.unbonded)
        with _keep_saves(checkpointed):
            e = _bonded_energy(composed, unbonded, b)
        outs.append(e)
        cots.append(torch.ones_like(e))
        g = torch.autograd.grad(outs, leaves, cots, create_graph=create_graph, allow_unused=True)
    g = [torch.zeros_like(x) if gi is None else gi for gi, x in zip(g, leaves, strict=True)]
    return Vec3(*g[:3]), Quat(*g[3:])
