"""PyTorch port (mythos_tpu_torch): DiffTRe under oxDNA1 -- the dna1
plain versions of K4 (per-term sums) and K5 (row gradients), the port of
``_params_grad_xla``, and ``ComposedEnergyFunction.map`` with
``map_neighbors`` -- against the JAX package.

The JAX side is its XLA paths, never Pallas interpret mode: the block
energy over a triangular table (``compute_terms_soa``, float64), the
fused path's ``_params_grad_xla`` in float32 (it refuses x64), and the
pair-list ``map`` (float64). Tolerances: float64 rtol 1e-6 (XLA-CPU
transcendentals are float32-accurate even under x64; the tiles use the
polynomial arccos), the parameter gradients to the reference's rule for
its fused map, 3e-3 max(1, |ref|) + 1e-4 (test_pallas_tiles.py).

Pair orientation: the triangular mask orients a pair by slot. The
parameter-gradient checks give both sides the same order -- the strand
interleave for ``_params_grad_xla``, the original order (no perm) for
the pair-list map, which orients every pair i < j -- so that role-swapped
parameters (theta0_cross_2 and _3) split alike.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny CPU shapes: one thread a worker, no idle pool spinning beside the others

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.dna1 as jdna1  # noqa: E402
import mythos_tpu_torch.energy.dna1 as tdna1  # noqa: E402
from mythos_tpu import soa as jsoa  # noqa: E402
from mythos_tpu import spaces  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.ops import oxdna_tiles as ot  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.simulators import neighbors as jnb  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
from mythos_tpu_torch.ops import tiles  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators import neighbors as tnb  # noqa: E402
from mythos_tpu_torch.soa import BodySoA, Quat, Vec3, to_soa  # noqa: E402

N_BP = 40
KT = 296.15 * 0.1 / 300.0
UNBONDED = tiles.KIND_TERMS["short"]


def _jittered(seed: int, n_states: int | None = None, bend=None):
    """Centers and unit quaternions (numpy, float64) 0.01 off the ideal
    40-bp duplex: one state, or (n_states, N, .) stacked."""
    _, body = jax_duplex(N_BP, bend=bend)
    rng = np.random.default_rng(seed)
    lead = () if n_states is None else (n_states,)
    c = np.asarray(body.center) + 0.01 * rng.standard_normal((*lead, 2 * N_BP, 3))
    q = np.asarray(body.orientation) + 0.01 * rng.standard_normal((*lead, 2 * N_BP, 4))
    return c, q / np.linalg.norm(q, axis=-1, keepdims=True)


def _port_table(top, centers, perm: bool):
    return tnb.block_neighbor_list_for_topology(top, tdna1.default_neighbor_cutoff(), block_size=8,
                                                init_centers=centers,
                                                perm=tnb.strand_interleave_perm(top) if perm else None)


def test_k4_k5_and_params_grad_plain_match_jax():
    """On the jittered 40-bp duplex's one-level table (short kind, dna1):
    K4's plain version equals the reference's XLA block sums over a
    triangular table (f64, rtol 1e-6); the body gradient of gt . sums
    through ``unbonded_tile_energies`` (K5's plain version backward, the
    rows transposed to the body by autograd) equals jax.grad of the same
    combination of the reference's terms (f64, rtol 1e-6, atol 1e-6 max:
    the polynomial arccos's derivative); and ``params_grad`` equals the
    reference's ``_params_grad_xla`` under dna1 (float32, the strand
    interleave on both sides), every packed parameter but the hb weights
    (they reach the sums through the rows, K5) by the 3e-3 rule."""
    c, q = _jittered(0)
    top_j, _ = jax_duplex(N_BP)
    e_blk = jdna1.create_default_energy_fn(top_j, block_unbonded=True, block_size=8)
    tri = jnb.block_neighbor_list_for_topology(spaces.free()[0], top_j, jdna1.default_neighbor_cutoff(),
                                               dr_threshold=0.5, block_size=8, init_centers=c)
    e_j = e_blk.with_props(block_ids=tri.idx)
    names = [type(fn).__name__ for fn in e_j.energy_fns]
    gt = np.array([0.9, 1.3, 0.7, 1.1])
    jb = jsoa.to_soa(JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q)))

    def weighted(b):
        t = e_j.compute_terms_soa(b)
        return sum(w * t[names.index(nm)] for w, nm in zip(gt, UNBONDED, strict=True))

    terms_j, g_j = jax.jit(lambda b: (e_j.compute_terms_soa(b), jax.grad(weighted)(b)))(jb)  # one compile
    terms_j = np.asarray(terms_j)

    top, _ = synthetic_duplex(N_BP, device="cpu")
    e_t = tdna1.create_default_energy_fn(top, dtype=torch.float64, device="cpu")
    nbl = _port_table(top, torch.as_tensor(c), perm=True)
    (ctx,) = tiles.prepare_contexts(e_t, nbl.idx, nbl.block_size, perm=nbl.perm)
    assert (ctx.spec.kind, ctx.spec.family, ctx.spec.terms) == ("short", "dna1", UNBONDED)
    leaves = [torch.as_tensor(x).clone().requires_grad_(True) for x in (*c.T, *q.T)]
    body = BodySoA(Vec3(*leaves[:3]), Quat(*leaves[3:]))
    sums = tiles.unbonded_tile_energies(tiles.dynamic_rows(ctx, body), ctx.params, nbl.idx, ctx.spec)
    for nm, s_ in zip(UNBONDED, sums, strict=True):
        np.testing.assert_allclose(float(s_.detach()), terms_j[names.index(nm)], rtol=1e-6, atol=1e-12, err_msg=nm)
    g_t = torch.autograd.grad((torch.as_tensor(gt) * sums).sum(), leaves)
    got = torch.stack(g_t).numpy()
    want = np.stack([np.asarray(x) for x in (*g_j.center, *g_j.orientation)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())

    jax.config.update("jax_enable_x64", False)  # the fused path's parameter gradient refuses x64
    try:
        c32, q32 = c.astype(np.float32), q.astype(np.float32)
        perm = jnb.strand_interleave_perm(top_j)
        e_f = e_blk.with_params(e_blk.opt_params())
        sym = jnb.block_neighbor_list_for_topology(spaces.free()[0], top_j, jdna1.default_neighbor_cutoff(),
                                                   dr_threshold=0.5, block_size=8, init_centers=jnp.asarray(c32),
                                                   symmetric=True, perm=perm)
        ctx_j = ot.prepare_tile_context(e_f, sym.idx, 8, "full", perm=perm)
        rows_j = ot.dynamic_rows(ctx_j, jsoa.to_soa(JaxRigidBody(center=jnp.asarray(c32), orientation=jnp.asarray(q32))))
        pg_j = ot._params_grad_xla(rows_j, ctx_j.params_vec, ot.pad_ids(ctx_j.spec, sym.idx),
                                   jnp.asarray(gt, jnp.float32), ctx_j.spec)
        structs = ot._unpack_params(pg_j, ctx_j.spec.params_treedef, ctx_j.spec.leaf_shapes)
        params = e_f.opt_params()
    finally:
        jax.config.update("jax_enable_x64", True)
    assert [type(s).__name__ for s in structs] == [nm + "Configuration" for nm in UNBONDED]
    e32 = tdna1.create_default_energy_fn(top, device="cpu")
    e32 = e32.with_params(params_from_numpy({k: np.asarray(v) for k, v in params.items()}))
    ids = torch.as_tensor(np.array(sym.idx), dtype=torch.int32)
    ctx32 = tiles.prepare_tile_context(e32, ids, 8, "short", perm)
    rows32 = tiles.dynamic_rows(ctx32, to_soa(RigidBody(torch.as_tensor(c32), torch.as_tensor(q32))))
    pg_t = ts.unpack_params(tiles.params_grad(rows32, ctx32.params, ids, torch.as_tensor(gt, dtype=torch.float32),
                                              ctx32.spec))
    checked = 0
    for macro, _, names_ in ts.PARAM_GROUPS:
        if macro not in ("EXC", "HB", "CROSS", "COAX", "COAXPHI"):
            continue
        for nm in names_:
            ref = [getattr(s, nm) for s in structs if nm in vars(s)]
            if nm == "eps_hb_weights" or not ref:
                continue
            a, b = float(getattr(pg_t[macro], nm)), float(np.asarray(ref[0]))
            assert abs(a - b) <= 3e-3 * max(1.0, abs(b)) + 1e-4, (macro, nm, a, b)
            checked += 1
    assert checked > 100


def test_map_with_map_neighbors_matches_jax_pair_map():
    """``energy_fn.replace(map_neighbors=...).map`` under oxDNA1 (one table
    of the short kind: K4, backward K5 and params_grad; on the CPU their
    plain versions) against the reference's pair-list ``map`` (f64): the
    energies of 3 jittered states rtol 1e-6, and the gradient of a
    weighted sum of them with respect to every parameter, rtol 1e-5, atol
    1e-6 x the largest (no perm: both sides orient pairs i < j); the
    contexts are built once for all states, and a state whose table
    overflows reads NaN."""
    c, q = _jittered(3, n_states=3)
    top_j, _ = jax_duplex(N_BP)
    e_pair = jdna1.create_default_energy_fn(top_j)
    states_j = JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))
    coef = jnp.asarray([1.0, -0.5, 2.0])
    coef_t = torch.tensor([1.0, -0.5, 2.0], dtype=torch.float64)
    params = e_pair.opt_params()

    def weighted_map(p):
        energies = e_pair.with_params(p).map(states_j)
        return jnp.sum(coef * energies), energies

    (ref_e, ref_map), ref_g = jax.jit(jax.value_and_grad(weighted_map, has_aux=True))(params)  # one compile
    ref_map = np.asarray(ref_map)

    top, _ = synthetic_duplex(N_BP, device="cpu")
    e = tdna1.create_default_energy_fn(top, dtype=torch.float64, device="cpu")
    states = RigidBody(torch.as_tensor(c), torch.as_tensor(q))
    nbl = _port_table(top, states.center[0], perm=False)
    opt = {k: v.requires_grad_(True) for k, v in
           params_from_numpy({k: np.asarray(v) for k, v in params.items()}, dtype=torch.float64).items()}
    calls = []
    prepare = tiles.prepare_contexts

    def counted(*a, **k):
        calls.append(1)
        return prepare(*a, **k)

    tiles.prepare_contexts = counted
    try:
        got = e.replace(map_neighbors=nbl).with_params(opt).map(states)
    finally:
        tiles.prepare_contexts = prepare
    assert len(calls) == 1
    np.testing.assert_allclose(got.detach().numpy(), ref_map, rtol=1e-6)
    np.testing.assert_allclose(float((coef_t * got).sum().detach()), float(ref_e), rtol=1e-6)
    g = torch.autograd.grad((coef_t * got).sum(), list(opt.values()), allow_unused=True)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in ref_g.values())
    for (k, v), gk in zip(opt.items(), g, strict=True):
        got_k = np.zeros(v.shape) if gk is None else gk.numpy()
        np.testing.assert_allclose(got_k, np.asarray(ref_g[k]), rtol=1e-5, atol=1e-6 * scale, err_msg=k)
    small = tnb.block_neighbor_list_for_topology(top, tdna1.default_neighbor_cutoff(), block_size=8, capacity=2,
                                                 init_centers=states.center[0])
    assert torch.isnan(e.replace(map_neighbors=small).map(states)).all()


@pytest.mark.parametrize("shape", ["straight", "bent"])
def test_dna1_reach_gates_drop_only_zeros(shape):
    """The dna1 gate (tile_gates_plain on the short kind, each term's upper
    cutoff read from the parameter vector; the backbone site on a1): on
    the jittered 40-bp duplex, straight and bent 270 degrees, in float64,
    every term's value and the weight-free HB product are exactly 0 under
    the full mask where the term's gate is clear, so K4's plain sums and
    K5's plain row gradients (full mask, the hb-weight fields triangular)
    with each term kept only inside its gate equal the ungated ones
    exactly; no pair is Debye-only."""
    c, q = _jittered(4, bend=math.radians(270) if shape == "bent" else None)
    top, _ = synthetic_duplex(N_BP, device="cpu")
    e = tdna1.create_default_energy_fn(top, dtype=torch.float64, device="cpu")
    nbl = _port_table(top, torch.as_tensor(c), perm=True)
    (ctx,) = tiles.prepare_contexts(e, nbl.idx, nbl.block_size, perm=nbl.perm)
    sp, params, ids = ctx.spec, ctx.params, nbl.idx
    rows = tiles.dynamic_rows(ctx, to_soa(RigidBody(torch.as_tensor(c), torch.as_tensor(q)))).detach()
    gates = tiles.tile_gates_plain(rows, params, ids, sp)
    assert tuple(gates) == UNBONDED
    ri, cj = tiles._split(rows, tiles._gather_cols(rows, ids, sp), sp)
    full = tiles._tile_mask(ri, cj, sp, triangular=False)
    terms, hb_prod = tiles._tile_terms(ri, cj, params, sp)
    for nm, v in zip(UNBONDED, terms, strict=True):
        assert bool((v[full & ~gates[nm]] == 0).all()), nm
    assert bool((hb_prod[full & ~gates["HydrogenBonding"]] == 0).all())
    assert any(bool((full & gates[nm]).any()) for nm in UNBONDED)

    def gated(rows_, triangular):
        ri_, cj_ = tiles._split(rows_, tiles._gather_cols(rows.detach(), ids, sp), sp)
        mask = tiles._tile_mask(ri_, cj_, sp, triangular)
        ts_, _ = tiles._tile_terms(ri_, cj_, params, sp)
        return [torch.where(mask & gates[nm], v, torch.zeros_like(v)).sum() for nm, v in zip(UNBONDED, ts_, strict=True)]

    assert torch.equal(torch.stack(gated(rows, True)), tiles.tile_energies_plain(rows, params, ids, sp))
    gt = torch.tensor([0.9, 1.3, 0.7, 1.1], dtype=torch.float64)
    head = rows[:, :12].clone().requires_grad_(True)
    (g_body,) = torch.autograd.grad(sum(w * s for w, s in zip(gt, gated(torch.cat([head, rows[:, 12:]], 1), False),
                                                             strict=True)), head)
    hw = rows[:, 12:16].clone().requires_grad_(True)
    hb = gated(torch.cat([rows[:, :12], hw, rows[:, 16:]], 1), True)[1]
    (g_hw,) = torch.autograd.grad(gt[1] * hb, hw)
    assert torch.equal(torch.cat([g_body, g_hw], 1), tiles.tile_row_grads_plain(rows, params, ids, gt, sp))
    counts = tiles.tile_gate_counts(rows, params, ids, sp)
    assert counts["debye"] == 0 and counts["short"] > 0
