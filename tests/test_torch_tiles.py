"""PyTorch port (mythos_tpu_torch): the block tier -- block-neighbor tables,
the plain versions of the tile kernels K3/K4/K5, the port of
``_params_grad_xla`` and a block-tier run -- against the JAX package.

The JAX side is always its XLA path, never Pallas interpret mode: the
triangular-table block sums (``compute_terms_soa``), ``jax.grad`` of the
block energy, the shared tile formulas of ``oxdna_tiles`` evaluated with
``jax.vmap`` at q = 1, ``_params_grad_xla``, and TpuSimulator on a
single-level non-symmetric table. Tolerances: rtol 1e-6 in float64 (XLA-CPU
transcendentals are float32-accurate even under x64, and the port's tiles
use the polynomial arccos); float32 comparisons as stated per test.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny CPU shapes: one thread a worker, no idle pool spinning beside the others

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.dna2 as jdna2  # noqa: E402
import mythos_tpu_torch.energy.dna2 as tdna2  # noqa: E402
from mythos_tpu import soa as jsoa  # noqa: E402
from mythos_tpu import spaces  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.ops import oxdna_tiles as ot  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.simulators import StaticSimulatorParams, TpuSimulator  # noqa: E402
from mythos_tpu.simulators import neighbors as jnb  # noqa: E402
import mythos_tpu_torch.energy.dna1.terms as t1  # noqa: E402
from mythos_tpu_torch.energy import blocks  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.entry import build_sim  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
from mythos_tpu_torch.ops import tiles  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators import neighbors as tnb  # noqa: E402
from mythos_tpu_torch.soa import to_soa, vnorm  # noqa: E402

N_BP = 40
KT = 296.15 * 0.1 / 300.0
BENDS = {"straight": None, "bent": math.radians(270)}


@pytest.fixture
def f32():
    """JAX in float32 for this test (the fused tile path refuses x64)."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _jittered(body_np, seed: int, scale: float = 0.01):
    """(centers, unit quats) off the ideal lattice (numpy, float64)."""
    rng = np.random.default_rng(seed)
    c = np.asarray(body_np[0]) + scale * rng.standard_normal(np.shape(body_np[0]))
    q = np.asarray(body_np[1]) + scale * rng.standard_normal(np.shape(body_np[1]))
    return c, q / np.linalg.norm(q, axis=1, keepdims=True)


def _tables(nbl):
    ids = nbl.idx
    return tuple(ids) if isinstance(ids, tuple) else (ids,)


@pytest.mark.parametrize("shape", sorted(BENDS))
@pytest.mark.parametrize("block_size", [4, 8, 16])
def test_block_neighbor_list_matches_jax(shape, block_size):
    """Symmetric two-level interleaved tables: sizing, ids and overflow
    equal the reference's, at build and at a rebuild from moved positions
    (the missed-interaction detector armed with the previous tables)."""
    top_j, body_j = jax_duplex(N_BP, bend=BENDS[shape])
    top_t, body_t = synthetic_duplex(N_BP, bend=BENDS[shape], device="cpu")
    kw = dict(dr_threshold=0.5, block_size=block_size)
    ref = jnb.block_neighbor_list_for_topology(
        spaces.free()[0], top_j, jdna2.default_neighbor_cutoff(), init_centers=body_j.center, symmetric=True,
        r_cutoff_inner=jdna2.short_range_neighbor_cutoff(), perm=jnb.strand_interleave_perm(top_j), **kw,
    )
    got = tnb.block_neighbor_list_for_topology(
        top_t, tdna2.default_neighbor_cutoff(), init_centers=body_t.center,
        r_cutoff_inner=tdna2.short_range_neighbor_cutoff(), perm=tnb.strand_interleave_perm(top_t), **kw,
    )
    assert (got.capacity, got.capacity_inner, got.banded, got.r_cutoff_inner is None) == (
        ref.capacity, ref.capacity_inner, ref.banded, ref.r_cutoff_inner is None,
    )
    for a, b in zip(_tables(got), _tables(ref), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(got.did_overflow) == bool(ref.did_overflow)
    moved, _ = _jittered((np.asarray(body_j.center), np.asarray(body_j.orientation)), 3, scale=0.4)
    ids_j, ovf_j = ref.build(jnp.asarray(moved), prev=ref.idx)
    ids_t, ovf_t = got.build(torch.as_tensor(moved), prev=got.idx)
    for a, b in zip(_tables(got.replace(block_ids_=ids_t)), _tables(ref.replace(block_ids_=ids_j)), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(ovf_t) == bool(ovf_j)


def test_scattered_table_and_capacity_overflow_match_jax():
    """A non-banded table with a capacity too small for the rows' hits: the
    distance-prioritised compaction keeps the same blocks as the
    reference's symmetric table and raises the same overflow flag."""
    top_j, body_j = jax_duplex(N_BP)
    top_t, body_t = synthetic_duplex(N_BP, device="cpu")
    kw = dict(dr_threshold=0.5, block_size=8, capacity=3)
    ref = jnb.block_neighbor_list_for_topology(
        spaces.free()[0], top_j, jdna2.default_neighbor_cutoff(), init_centers=body_j.center, symmetric=True, **kw
    )
    got = tnb.block_neighbor_list_for_topology(top_t, tdna2.default_neighbor_cutoff(), init_centers=body_t.center, **kw)
    assert not got.banded and bool(got.did_overflow) == bool(ref.did_overflow) is True
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))


def test_synthetic_bend_matches_jax():
    _, body_j = jax_duplex(N_BP, bend=BENDS["bent"])
    _, body_t = synthetic_duplex(N_BP, bend=BENDS["bent"], device="cpu")
    np.testing.assert_allclose(body_t.center.numpy(), np.asarray(body_j.center), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(body_t.orientation.numpy(), np.asarray(body_j.orientation), rtol=1e-6, atol=1e-12)


def test_bonded_partner_table_matches_jax():
    from mythos_tpu.energy import blocks as jblocks

    top_t, _ = synthetic_duplex(8, device="cpu")
    for a, b in zip(blocks.bonded_partner_table(24, top_t.bonded_neighbors),
                    jblocks.bonded_partner_table(24, top_t.bonded_neighbors), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.fixture(scope="module")
def f64_system():
    """A jittered 40-bp duplex (float64) on both sides; the JAX triangular
    table for its XLA block path, the port's symmetric tables."""
    top_j, body_j = jax_duplex(N_BP)
    c, q = _jittered((np.asarray(body_j.center), np.asarray(body_j.orientation)), 0)
    jbody = JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))
    e_blk = jdna2.create_default_energy_fn(top_j, block_unbonded=True, block_size=8)
    tri = jnb.block_neighbor_list_for_topology(
        spaces.free()[0], top_j, jdna2.default_neighbor_cutoff(), dr_threshold=0.5, block_size=8, init_centers=c
    )
    e_j = e_blk.with_props(block_ids=tri.idx)
    top_t, _ = synthetic_duplex(N_BP, device="cpu")
    tbody = RigidBody(torch.as_tensor(c), torch.as_tensor(q))
    e_t = tdna2.create_default_energy_fn(top_t, dtype=torch.float64, device="cpu")
    return jbody, e_j, top_t, tbody, e_t


@pytest.fixture(scope="module")
def f64_reference(f64_system):
    """(per-term energies, gradient) of the reference block energy on
    f64_system's state: one compile for the tests below."""
    jbody, e_j, *_ = f64_system
    terms, g = jax.jit(lambda b: (e_j.compute_terms_soa(b), jax.grad(e_j.energy_soa)(b)))(jsoa.to_soa(jbody))
    return np.asarray(terms), g


@pytest.mark.parametrize("two_level", [False, True], ids=["one-table", "tight-wide"])
def test_tile_energies_plain_match_jax_block_sums(f64_system, f64_reference, two_level):
    """K4's plain version, per term over a symmetric table (triangular
    mask), equals the reference's XLA block sums over a triangular table."""
    jbody, e_j, top_t, tbody, e_t = f64_system
    terms_j = f64_reference[0]
    names = [type(fn).__name__ for fn in e_j.energy_fns]
    nbl = tnb.block_neighbor_list_for_topology(
        top_t, tdna2.default_neighbor_cutoff(), block_size=4 if two_level else 8, init_centers=tbody.center,
        r_cutoff_inner=tdna2.short_range_neighbor_cutoff() if two_level else None,
        perm=tnb.strand_interleave_perm(top_t),
    )
    assert (nbl.r_cutoff_inner is not None) == two_level
    ctxs = tiles.prepare_contexts(e_t, nbl.idx, nbl.block_size, perm=nbl.perm)
    got = {}
    for ctx, ids in zip(ctxs, _tables(nbl), strict=True):
        sums = tiles.tile_energies_plain(tiles.dynamic_rows(ctx, to_soa(tbody)), ctx.params, ids, ctx.spec)
        got.update({nm: float(s) for nm, s in zip(ctx.spec.terms, sums, strict=True)})
    for nm in tiles.KIND_TERMS["full"]:
        np.testing.assert_allclose(got[nm], terms_j[names.index(nm)], rtol=1e-6, atol=1e-12, err_msg=nm)


def test_tile_forces_plain_match_jax_grad(f64_system, f64_reference):
    """K3's plain version, through fused_grads_ctx (K3 on each table +
    the bonded gradient), equals jax.grad of the reference block energy."""
    jbody, e_j, top_t, tbody, e_t = f64_system
    g = f64_reference[1]
    nbl = tnb.block_neighbor_list_for_topology(
        top_t, tdna2.default_neighbor_cutoff(), block_size=4, init_centers=tbody.center,
        r_cutoff_inner=tdna2.short_range_neighbor_cutoff(), perm=tnb.strand_interleave_perm(top_t),
    )
    ctxs = tiles.prepare_contexts(e_t, nbl.idx, nbl.block_size, perm=nbl.perm)
    g_com, g_quat = tiles.fused_grads_ctx(e_t, ctxs, to_soa(tbody), nbl.idx)
    for got, want in ((g_com, g.center), (g_quat, g.orientation)):
        a = torch.stack(tuple(got)).numpy()
        b = np.stack([np.asarray(c) for c in want])
        # atol 1e-6 x max: the tiles' polynomial arccos differs from arccos
        # in its derivative by ~1e-6 (in its value by <= 2e-8)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


@pytest.fixture(params=["no-perm", "interleave"])
def f32_tiles(f32, request):
    """One symmetric table (B = 8) on both sides in float32, in the original
    order or over the strand interleave (the block tier's and the map's slot
    order, where the triangular mask orients pairs by slot): the
    reference's full-kind context and rows, the port's."""
    top_j, body_j = jax_duplex(N_BP)
    c, q = _jittered((np.asarray(body_j.center), np.asarray(body_j.orientation)), 1)
    c, q = c.astype(np.float32), q.astype(np.float32)
    perm = jnb.strand_interleave_perm(top_j) if request.param == "interleave" else None
    e_j = jdna2.create_default_energy_fn(top_j, block_unbonded=True, block_size=8)
    e_j = e_j.with_params(e_j.opt_params())
    sym = jnb.block_neighbor_list_for_topology(
        spaces.free()[0], top_j, jdna2.default_neighbor_cutoff(), dr_threshold=0.5, block_size=8,
        init_centers=jnp.asarray(c), symmetric=True, perm=perm,
    )
    ctx_j = ot.prepare_tile_context(e_j, sym.idx, 8, "full", perm=perm)
    rows_j = ot.dynamic_rows(ctx_j, jsoa.to_soa(JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))))
    top_t, _ = synthetic_duplex(N_BP, device="cpu")
    e_t = tdna2.create_default_energy_fn(top_t, device="cpu")
    e_t = e_t.with_params(params_from_numpy({k: np.asarray(v) for k, v in e_j.opt_params().items()}))
    ids_t = torch.as_tensor(np.array(sym.idx), dtype=torch.int32)
    ctx_t = tiles.prepare_tile_context(e_t, ids_t, 8, "full", perm)
    rows_t = tiles.dynamic_rows(ctx_t, to_soa(RigidBody(torch.as_tensor(c), torch.as_tensor(q))))
    return ctx_j, rows_j, sym.idx, ctx_t, rows_t, ids_t


def test_tile_row_grads_plain_hw_matches_jax(f32_tiles):
    """K5's plain version: the hb-weight columns are the triangular-mask
    gradient (rtol 1e-5 in float32) of a sum the reference builds from
    _tile_energies, _tile_mask and _gather_cols (q = 1)."""
    ctx_j, rows_j, sym_ids, ctx_t, rows_t, ids_t = f32_tiles
    spec = ctx_j.spec._replace(q=1)
    params = ot._unpack_params(ctx_j.params_vec, spec.params_treedef, spec.leaf_shapes)
    cols = ot._gather_cols(rows_j, ot.pad_ids(ctx_j.spec, sym_ids), spec)

    def tri_hb(rows):
        def blk(rb, cb):
            rv = ot._Rows(rb, spec)
            energies, _ = ot._tile_energies(rv, cb, params, spec)
            return jnp.where(ot._tile_mask(rv, cb, spec, triangular=True), energies[1], 0.0).sum()

        return jax.vmap(blk)(rows.reshape(spec.nb_pad, spec.block_size, -1), cols).sum()

    gt = torch.tensor([1.0, 1.3, 0.7, 1.1, 0.9])
    want = 1.3 * np.asarray(jax.grad(tri_hb)(rows_j))[: ctx_t.spec.n, 12:16]
    got = tiles.tile_row_grads_plain(rows_t, ctx_t.params, ids_t, gt, ctx_t.spec)
    assert got.shape == (ctx_t.spec.n_pad, 16)
    np.testing.assert_allclose(got[: ctx_t.spec.n, 12:16].numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_params_grad_matches_jax(f32_tiles):
    """The port of _params_grad_xla against the reference's, parameter by
    parameter, at float32 (tolerance 3e-3 max(1, |ref|) + 1e-4, as the
    reference holds its fused map's gradients, test_pallas_tiles.py). With
    the interleave it witnesses that the reference orients pairs by slot as
    the port does, so both split the gradient between role-swapped
    parameters (theta0_cross_2/_3) the same way."""
    ctx_j, rows_j, sym_ids, ctx_t, rows_t, ids_t = f32_tiles
    gt = jnp.array([1.0, 1.3, 0.7, 1.1, 0.9], jnp.float32)
    g_j = ot._params_grad_xla(rows_j, ctx_j.params_vec, ot.pad_ids(ctx_j.spec, sym_ids), gt, ctx_j.spec)
    structs = ot._unpack_params(g_j, ctx_j.spec.params_treedef, ctx_j.spec.leaf_shapes)
    g_t = ts.unpack_params(tiles.params_grad(rows_t, ctx_t.params, ids_t, torch.as_tensor(np.asarray(gt)), ctx_t.spec))
    checked = 0
    for struct, (macro, _, names) in zip(structs, ts.PARAM_GROUPS[:5], strict=True):
        for nm in names:
            if nm == "eps_hb_weights":  # reaches the sums through the hw rows (K5), as in the reference
                continue
            a, b = float(getattr(g_t[macro], nm)), float(np.asarray(getattr(struct, nm)))
            assert abs(a - b) <= 3e-3 * max(1.0, abs(b)) + 1e-4, (macro, nm, a, b)
            checked += 1
    assert checked > 100


def test_block_run_matches_jax_tpu_simulator(f32):
    """A 40-bp block-tier run at kT = 0 (20 steps, rebuild every 5, save
    every 10): the port (symmetric tables, K3's plain version) against
    TpuSimulator on a single-level non-symmetric table (its XLA tile path;
    the energies are the same either way), rtol 1e-4, atol 1e-5."""
    top_j, body_j = jax_duplex(N_BP)
    e_j = jdna2.create_default_energy_fn(top_j, block_unbonded=True, block_size=8)
    nbl = jnb.block_neighbor_list_for_topology(
        spaces.free()[0], top_j, jdna2.default_neighbor_cutoff(), dr_threshold=0.5, block_size=8,
        init_centers=body_j.center,
    )
    sim_j = TpuSimulator(
        energy_fn=e_j,
        simulator_params=StaticSimulatorParams(
            seq=jnp.asarray(top_j.seq),
            mass=JaxRigidBody(center=jnp.array([1.0]), orientation=jnp.array([[1.0, 1.0, 1.0]])),
            gamma=JaxRigidBody(center=jnp.array([0.0]), orientation=jnp.array([0.0])),
            bonded_neighbors=jnp.asarray(top_j.bonded_neighbors), checkpoint_every=0, dt=5e-3, kT=0.0,
        ),
        space=spaces.free(), neighbors=nbl, save_every=10, neighbor_update_every=5,
    )
    params = e_j.opt_params()
    body32 = JaxRigidBody(center=jnp.asarray(body_j.center, jnp.float32),
                          orientation=jnp.asarray(body_j.orientation, jnp.float32))
    ref = jax.jit(lambda p: sim_j.run(p, body32, 20, jax.random.PRNGKey(0)))(params).observables[0]
    top_t, body_t = synthetic_duplex(N_BP, dtype=torch.float32, device="cpu")
    e_t, sim_t = build_sim(top_t, 0.0, mode="block", init_centers=body_t.center, neighbor_update_every=5,
                           device="cpu")
    opt = params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    got = sim_t.replace(save_every=10).run(opt, body_t, 20, torch.Generator().manual_seed(0)).observables[0]
    np.testing.assert_allclose(got.center.numpy(), np.asarray(ref.center), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.orientation.numpy(), np.asarray(ref.orientation), rtol=1e-4, atol=1e-5)
    assert not bool(got.metadata["neighbor_overflow"].any())


def test_block_run_is_finite_with_thermostat():
    """kT > 0 on the 270-degree arc: finite states, unit quaternions, no
    overflow, and a state saved every 10 steps."""
    top, body = synthetic_duplex(N_BP, bend=BENDS["bent"], dtype=torch.float32, device="cpu")
    e, sim = build_sim(top, KT, mode="block", init_centers=body.center, neighbor_update_every=5, device="cpu")
    traj = sim.replace(save_every=10).run(e.opt_params(), body, 20, torch.Generator().manual_seed(1)).observables[0]
    assert traj.center.shape == (2, 2 * N_BP, 3)
    assert torch.isfinite(traj.center).all() and torch.isfinite(traj.orientation).all()
    np.testing.assert_allclose(traj.orientation.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert not bool(traj.metadata["neighbor_overflow"].any())


def test_tile_autograd_function_backward():
    """UnbondedTileEnergies: K4 forward; backward K5 for the rows and the
    port of _params_grad_xla for the parameters (CPU: the plain versions),
    equal to autograd through the plain tile sums."""
    top, body = synthetic_duplex(N_BP, dtype=torch.float64, device="cpu")
    e = tdna2.create_default_energy_fn(top, dtype=torch.float64, device="cpu")
    c, q = _jittered((body.center.numpy(), body.orientation.numpy()), 2)
    nbl = tnb.block_neighbor_list_for_topology(top, tdna2.default_neighbor_cutoff(), block_size=8,
                                               init_centers=torch.as_tensor(c))
    ctx = tiles.prepare_tile_context(e, nbl.idx, 8, "full")
    rows0 = tiles.dynamic_rows(ctx, to_soa(RigidBody(torch.as_tensor(c), torch.as_tensor(q)))).detach()
    w = torch.tensor([1.0, 1.3, 0.7, 1.1, 0.9], dtype=torch.float64)

    def grads(fn):
        rows = rows0.clone().requires_grad_(True)
        p = ctx.params.detach().clone().requires_grad_(True)
        return torch.autograd.grad((w * fn(rows, p)).sum(), (rows, p))

    via = grads(lambda r, p: tiles.unbonded_tile_energies(r, p, nbl.idx, ctx.spec))

    def direct(r, p):
        # row-side sums under the full mask for the body fields, the
        # triangular hb sum for hw: what K5 differentiates
        cols = tiles._gather_cols(r.detach(), nbl.idx, ctx.spec)
        return torch.stack(tiles._masked_sums(r, cols, p, ctx.spec, triangular=True))

    rows_g, p_g = grads(direct)
    torch.testing.assert_close(via[1], p_g)
    # hw columns: triangular, as above; body fields: half the symmetric sum
    torch.testing.assert_close(via[0][:, 12:16], rows_g[:, 12:16])
    body = tiles.tile_row_grads_plain(rows0, ctx.params, nbl.idx, w, ctx.spec)[:, :12]
    torch.testing.assert_close(via[0][:, :12], body)
    torch.testing.assert_close(via[0][:, 16:], torch.zeros_like(via[0][:, 16:]))


def _gated_sums(rows, ids, params, spec, triangular, gates):
    """Per-term sums of the plain tile formulas over the mask, each term
    kept only where its gate is set (all terms where ``gates`` is None)."""
    ri, cj = tiles._split(rows, tiles._gather_cols(rows.detach(), ids, spec), spec)
    mask = tiles._tile_mask(ri, cj, spec, triangular)
    terms, _ = tiles._tile_terms(ri, cj, params, spec)
    return [torch.where(mask & gates[nm], e, torch.zeros_like(e)).sum() for nm, e in zip(spec.terms, terms, strict=True)]


def _gated_row_grads(rows, ids, params, spec, gt, width, gates):
    """d/d(rows[:, :width]) of sum_t gt_t x (gated full-mask sum of term t),
    row side only: K3's forces (gt the term weights) or K5's body fields."""
    head = rows[:, :width].clone().requires_grad_(True)
    sums = _gated_sums(torch.cat([head, rows[:, width:]], dim=1), ids, params, spec, False, gates)
    (g,) = torch.autograd.grad(sum(w * s for w, s in zip(gt, sums, strict=True)), head)
    return g


@pytest.mark.parametrize("kind", ["full", "short", "debye"])
@pytest.mark.parametrize("shape", sorted(BENDS))
def test_tile_gates_drop_only_zeros(shape, kind):
    """The kernels' gate (tile_gates_plain, reading each term's upper
    cutoff from the parameter vector): on the jittered 40-bp duplex,
    straight and bent 270 degrees, in float64, every term's value -- each
    of the four excluded-volume distances' apart, and the weight-free HB
    product -- is exactly 0 under the mask where its gate is clear, so the
    plain tile energies (K4, triangular mask), K3's plain row forces and
    K5's plain row gradients (full mask; the hb-weight fields triangular,
    the debye kind's charge-factor field) with each term kept only inside
    its gate equal the ungated ones exactly; and the per-class counts of
    the pairs (short-range, Debye only, skipped) under the full and the
    triangular mask are those of the site distances against the cutoffs
    named in the parameter groups and in dna2.per_term_site_cutoffs."""
    top, body = synthetic_duplex(N_BP, bend=BENDS[shape], dtype=torch.float64, device="cpu")
    e = tdna2.create_default_energy_fn(top, dtype=torch.float64, device="cpu")
    c, q = _jittered((body.center.numpy(), body.orientation.numpy()), 4)
    nbl = tnb.block_neighbor_list_for_topology(top, tdna2.default_neighbor_cutoff(), block_size=8,
                                               init_centers=torch.as_tensor(c), perm=tnb.strand_interleave_perm(top))
    ids = _tables(nbl)[0]
    ctx = tiles.prepare_tile_context(e, ids, 8, kind, nbl.perm)
    sp, params = ctx.spec, ctx.params
    rows = tiles.dynamic_rows(ctx, to_soa(RigidBody(torch.as_tensor(c), torch.as_tensor(q)))).detach()
    gates = tiles.tile_gates_plain(rows, params, ids, sp)
    assert tuple(gates) == sp.terms

    # each term's value (K4 sums values, not only derivatives) is exactly 0
    # where its gate is clear; for the excluded volume, each distance's own
    # value where that distance is past its own cutoff (the kernel gates
    # them apart; exc_f3 floors r at 1e-2, below every cutoff)
    ri_, cj_ = tiles._split(rows, tiles._gather_cols(rows, ids, sp), sp)
    full_mask = tiles._tile_mask(ri_, cj_, sp, triangular=False)
    terms, hb_prod = tiles._tile_terms(ri_, cj_, params, sp)
    for nm, e in zip(sp.terms, terms, strict=True):
        assert bool((e[full_mask & ~gates[nm]] == 0).all()), nm
    if kind != "debye":
        off_e = ts.param_offsets()["EXC"]
        assert bool((hb_prod[full_mask & ~gates["HydrogenBonding"]] == 0).all())
        bx, by, hbo, _ = sp.geometry

        def site(a, f):
            return tiles._vec(a, 0) + f[0] * tiles._vec(a, 3) + f[1] * tiles._vec(a, 6)

        back, base = (bx, by), (hbo, 0.0)
        named_exc = ts.unpack_params(params)["EXC"]
        gated_exc = 0.0
        for (fi, fj), fam, k in zip(((base, base), (back, base), (base, back), (back, back)),
                                    ("base", "back_base", "base_back", "backbone"), tiles._EXC_CUTS, strict=True):
            r = vnorm(site(cj_, fj) - site(ri_, fi))
            v = t1.exc_family(named_exc, fam, r)
            inside = r < params[off_e + k]
            assert float(params[off_e + k]) > 1e-2 and bool((v[full_mask & ~inside] == 0).all()), fam
            gated_exc = gated_exc + torch.where(inside, v, torch.zeros_like(v))
        assert torch.equal(gated_exc[full_mask], terms[0][full_mask])

    energies = torch.stack(_gated_sums(rows, ids, params, sp, True, gates))
    assert torch.equal(energies, tiles.tile_energies_plain(rows, params, ids, sp))
    weights = tiles.term_weights(params, sp)
    forces = _gated_row_grads(rows, ids, params, sp, weights, sp.n_force_fields, gates)
    assert torch.equal(forces, tiles.tile_forces_plain(rows, params, ids, sp))
    # K5: the body fields for another cotangent, the debye kind's charge
    # factor, and the triangular hb-weight gradient, each gated
    gt = weights * torch.linspace(0.5, 1.5, len(sp.terms), dtype=weights.dtype)
    k5 = _gated_row_grads(rows, ids, params, sp, gt, 4 if kind == "debye" else 12, gates)
    if kind != "debye":
        hw = rows[:, tiles._HW : tiles._HW + 4].clone().requires_grad_(True)
        r_hw = torch.cat([rows[:, : tiles._HW], hw, rows[:, tiles._HW + 4 :]], dim=1)
        hb = _gated_sums(r_hw, ids, params, sp, True, gates)[sp.terms.index("HydrogenBonding")]
        (g_hw,) = torch.autograd.grad(gt[1] * hb, hw)
        k5 = torch.cat([k5, g_hw], dim=1)
    assert torch.equal(k5, tiles.tile_row_grads_plain(rows, params, ids, gt, sp))

    # each term's gate and the classes from the site distances, cutoffs by parameter name
    named = ts.unpack_params(params)
    x = tiles._gather_cols(rows, ids, sp).numpy()[:, None]  # (nb, 1, M, F)
    r = rows.numpy().reshape(sp.n_blocks, 8, 1, -1)
    mask, tri = full_mask.numpy(), tiles._tile_mask(ri_, cj_, sp, triangular=True).numpy()
    r_cut = float(named["DEBYE"].r_cut)
    if kind == "debye":
        want_gates = {"Debye": np.linalg.norm(x[..., :3] - r[..., :3], axis=-1) < r_cut}
    else:
        bx, by, hbo, sto = sp.geometry

        def dist(fi, fj):
            def site(a, f):
                return a[..., 0:3] + f[0] * a[..., 3:6] + f[1] * a[..., 6:9]

            return np.linalg.norm(site(x, fj) - site(r, fi), axis=-1)

        back, base, stack = (bx, by), (hbo, 0.0), (sto, 0.0)
        exc = named["EXC"]
        want_gates = {
            "UnbondedExcludedVolume": (dist(base, base) < float(exc.dr_c_base))
            | (dist(back, base) < float(exc.dr_c_back_base)) | (dist(base, back) < float(exc.dr_c_base_back))
            | (dist(back, back) < float(exc.dr_c_backbone)),
            "HydrogenBonding": dist(base, base) < float(named["HB"].dr_c_high_hb),
            "CrossStacking": dist(base, base) < float(named["CROSS"].dr_c_high_cross),
            "CoaxialStacking": dist(stack, stack) < float(named["COAX"].dr_c_high_coax),
            "Debye": dist(back, back) < r_cut,
        }
    for nm in sp.terms:
        np.testing.assert_array_equal(gates[nm].numpy() & mask, want_gates[nm] & mask, err_msg=nm)
    # the offsets the gates read are the named cutoffs (each of the four
    # excluded-volume distances has its own, which the kernel gates apart)
    off = ts.param_offsets()
    exc_names = ("dr_c_base", "dr_c_back_base", "dr_c_base_back", "dr_c_backbone")
    for k, nm in zip(tiles._EXC_CUTS, exc_names, strict=True):
        assert float(params[off["EXC"] + k]) == float(getattr(named["EXC"], nm)), nm
    assert float(params[off["HB"] + tiles._R_C_HIGH]) == float(named["HB"].dr_c_high_hb)
    assert float(params[off["CROSS"] + tiles._R_C_HIGH]) == float(named["CROSS"].dr_c_high_cross)
    assert float(params[off["COAX"] + tiles._R_C_HIGH]) == float(named["COAX"].dr_c_high_coax)
    assert float(params[off["DEBYE"] + tiles._R_CUT]) == r_cut
    short = np.zeros_like(mask)
    for nm in sp.terms:
        if nm != "Debye":
            short |= want_gates[nm]
    debye = want_gates["Debye"] & ~short if "Debye" in sp.terms else np.zeros_like(mask)
    want = {"short": int((mask & short).sum()), "debye": int((mask & debye).sum()),
            "skipped": int((mask & ~short & ~debye).sum())}
    assert tiles.tile_gate_counts(rows, params, ids, sp) == want
    # the same classes from the physics package's own per-term site cutoffs
    site_cuts = tdna2.per_term_site_cutoffs()
    if kind == "debye":
        ((_, _, cut),) = site_cuts["terms"]["Debye"]
        reach_short = np.zeros_like(mask)
        reach_debye = np.linalg.norm(x[..., :3] - r[..., :3], axis=-1) < cut
    else:

        def reach(pairs):
            hit = np.zeros_like(mask)
            for fa, fb, cut in pairs:
                sa, sb = site_cuts["sites"][fa], site_cuts["sites"][fb]
                hit |= dist(sa, sb) < cut
                hit |= dist(sb, sa) < cut
            return hit

        reach_short = reach([pr for nm in tiles.KIND_TERMS["short"] for pr in site_cuts["terms"][nm]])
        reach_debye = reach(site_cuts["terms"]["Debye"]) & ~reach_short if kind == "full" else np.zeros_like(mask)
    np.testing.assert_array_equal(short & mask, reach_short & mask)
    np.testing.assert_array_equal(debye & mask, reach_debye & mask)
    # K4's classes: the same gate under the triangular mask
    want_tri = {"short": int((tri & reach_short).sum()), "debye": int((tri & reach_debye).sum()),
                "skipped": int((tri & ~reach_short & ~reach_debye).sum())}
    assert tiles.tile_gate_counts(rows, params, ids, sp, triangular=True) == want_tri
    assert sum(want_tri.values()) < sum(want.values())
    assert want["skipped"] > 0 and (want["short"] > 0 or kind == "debye") and (want["debye"] > 0 or kind == "short")
