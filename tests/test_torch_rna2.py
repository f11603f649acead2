"""PyTorch port (mythos_tpu_torch): the oxRNA2 stencil main path -- the
band, the rna2 plain versions of kernels K1 and K2, and the slice as a
whole -- against the JAX package on the 40-bp A-form duplex (80 nt).

The JAX stencil refuses x64 (ERR_X64), so this module runs JAX in float32
(module fixture) and holds the port against the XLA references the Pallas
kernels were tested against: ``_xla_field_grads_layout``,
``stencil_grads_ctx(kernel=False)`` and ``_xla_multistep_reference``
(jitted once for a 40-step chunk). No Pallas kernel runs here. The energy
terms and the rna2 bonded gradient are held in float64 in
test_torch_rna2_energy.py; the CUDA kernels against these plain versions
in test_torch_cuda.py.
"""

import dataclasses as dc
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.rna2 as jrna2  # noqa: E402
import mythos_tpu_torch.energy.rna2 as trna2  # noqa: E402
from __graft_entry__ import _build_sim, _tiny_duplex  # noqa: E402
from mythos_tpu import soa as jsoa  # noqa: E402
from mythos_tpu import spaces  # noqa: E402
from mythos_tpu.ops import stencil as st  # noqa: E402
from mythos_tpu.simulators import neighbors as jnb  # noqa: E402
from mythos_tpu_torch import entry  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import coax_engaged, synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
from mythos_tpu_torch.simulators import neighbors as tnb  # noqa: E402
from mythos_tpu_torch.soa import Quat, Vec3  # noqa: E402

KT = 296.15 * 0.1 / 300.0
N_BP = 40
U = 40  # one chunk
FAMILY_IDS = {"back": 0.0, "base": 1.0, "stack": 2.0}


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def systems(_f32_mode):
    """The 40-bp A-form duplex on both sides: JAX sim (site band with the
    A-form slacks, site_margin 2) + stencil/kernel contexts, port energy
    (same parameters) + band + stencil context."""
    topology, body = _tiny_duplex(N_BP, form="A")
    _, sim = _build_sim(
        topology, KT, mode="stencil", init_centers=body.center, init_orientation=body.orientation, model="rna2"
    )
    e = sim.energy_fn.with_params(sim.energy_fn.opt_params())
    nb = sim.neighbors
    sctx = st.prepare_stencil_context(e, nb.w_short, nb.w_wide, perm=nb.perm, w_terms=nb.w_terms, kernel=True)
    ttop, tbody = synthetic_duplex(N_BP, form="A", dtype=torch.float32, device="cpu")
    te, tsim = entry.build_sim(ttop, KT, model="rna2", init_centers=tbody.center, init_orientation=tbody.orientation,
                               device="cpu")
    opt = params_from_numpy({k: np.asarray(v) for k, v in sim.energy_fn.opt_params().items()})
    ctx = ts.prepare_stencil_context(te.with_params(opt), tsim.band)
    return types.SimpleNamespace(
        topology=topology, body=body, sim=sim, e=e, nb=nb, sctx=sctx, te=te, tbody=tbody, tsim=tsim, ctx=ctx, opt=opt
    )


def _layout(rows, s):
    return jnp.stack([st._to_layout(jnp.asarray(r), s.sctx.kernel_ctx.kspec.s) for r in rows])


def _flat(arr_l, s, k):
    return np.stack([np.asarray(st._from_layout(arr_l[i], s.ctx.n)) for i in range(k)])


def _jittered_slots(s, seed: int, scale: float = 0.01):
    """(7, n) slot-order com + unit quat near the ideal helix (numpy f32)."""
    rng = np.random.default_rng(seed)
    n = s.ctx.n
    com = np.asarray(s.body.center, np.float32) + scale * rng.standard_normal((n, 3)).astype(np.float32)
    q = np.asarray(s.body.orientation, np.float32) + scale * rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    perm = s.nb.perm
    return np.concatenate([com[perm].T, q[perm].T]).astype(np.float32), com, q


def test_family_and_variants(systems):
    """The port finds the rna2 family where the reference finds the rna2
    cross variant, the dna1 coax and the (a1, a3) backbone."""
    assert systems.ctx.family == "rna2"
    spec = systems.sctx.spec
    assert (spec.cross_variant, spec.coax_variant, spec.geometry[0]) == ("rna2", "dna1", "rna2")
    g = ts.unpack_params(systems.ctx.params)["GEOM"]
    np.testing.assert_allclose([float(g.bx), float(g.by), float(g.hb), float(g.st)], spec.geometry[1], rtol=1e-7)


# the band -----------------------------------------------------------------


@pytest.mark.parametrize("field", ["w_terms", "w_wide", "check_dm", "check_block", "site_checks"])
def test_band_sizing_matches(field, systems):
    """Reaches, check_dm and exact checks equal JAX's under the A-form
    slacks, the far slack and site_margin 2."""
    got, ref = getattr(systems.tsim.band, field), getattr(systems.nb, field)
    if field == "site_checks":
        assert len(got) == len(ref)
        for a, b in zip(got, ref, strict=True):
            assert (a[0], a[1], a[3], a[4]) == (b[0], b[1], b[3], b[4])
            np.testing.assert_allclose(a[2], b[2], rtol=1e-6)
    else:
        assert tuple(np.atleast_1d(got)) == tuple(np.atleast_1d(ref))


def _port_flag(band, com, quat):
    com, quat = torch.tensor(np.array(com)), torch.tensor(np.array(quat))
    return bool(band.check(Vec3(*com.T), Quat(*quat.T)))


def _bands_from(form):
    """The rna2 band of both packages sized from a ``form`` init."""
    topology, body = _tiny_duplex(N_BP, form=form)
    kw = dict(perm=jnb.strand_interleave_perm(topology), site_margin=2,
              fam_slack_overrides=jrna2.aform_site_slacks(), far_slack=jrna2.aform_far_slack())
    ref = jnb.stencil_band_for_site_cutoffs(spaces.free()[0], topology, jrna2.per_term_site_cutoffs(),
                                           init_centers=body.center, init_orientation=body.orientation, **kw)
    import mythos_tpu_torch.energy.rna2 as trna2

    com, quat = np.array(body.center, np.float32), np.array(body.orientation, np.float32)
    got = tnb.stencil_band_for_site_cutoffs(topology, trna2.per_term_site_cutoffs(), torch.as_tensor(com),
                                            torch.as_tensor(quat), **kw)
    return ref, got, com, quat


@pytest.mark.parametrize("case", ["aform", "aform_folded", "bform", "bform_folded"])
def test_band_flag_matches_jax(case, systems):
    """The overflow flag of the rna2 site band, port against JAX: the
    A-form init, and a band sized from a B-form init under rna2 (its sizing
    equal too) on that init; each as is and with the fold-back of
    tests/test_stencil.py:119-126."""
    s = systems
    band, ref_band = s.tsim.band, s.nb
    com, quat = np.asarray(s.body.center, np.float32), np.asarray(s.body.orientation, np.float32)
    if case.startswith("bform"):
        ref_band, band, com, quat = _bands_from("B")
        assert (band.w_terms, band.w_wide, band.check_dm) == (tuple(ref_band.w_terms), ref_band.w_wide,
                                                              ref_band.check_dm)
    if case.endswith("folded"):
        com = com.copy()
        com[s.topology.n_nucleotides // 4] = com[0] + 0.1
    ref = bool(ref_band._check(jnp.asarray(com), orientation=jnp.asarray(quat)))
    assert _port_flag(band, com, quat) == ref
    assert ref == case.endswith("folded")


# K2's plain version ----------------------------------------------------------


@pytest.fixture(scope="module")
def k2_case(systems):
    s = systems
    dyn, com, q = _jittered_slots(s, seed=0)
    kctx = s.sctx.kernel_ctx
    ref = st._xla_field_grads_layout(
        kctx.kspec, kctx.params_vec, jnp.ones((1, 8), jnp.float32), _layout(dyn, s), kctx.wt_l, kctx.pn_l, kctx.qf_l
    )
    got = ts.field_grads_plain(s.ctx, torch.as_tensor(dyn))
    return dyn, com, q, _flat(ref, s, 7), got.numpy()


@pytest.mark.parametrize("rows", ["com", "quat"])
def test_field_grads_twin_matches_xla_layout(rows, k2_case):
    """field_grads_plain (rna2) == _xla_field_grads_layout, float32, rtol
    1e-4, atol 1e-4 max|ref|."""
    *_, ref, got = k2_case
    sl = slice(0, 3) if rows == "com" else slice(3, 7)
    np.testing.assert_allclose(got[sl], ref[sl], rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_field_grads_twin_matches_stencil_grads_ctx(systems, k2_case):
    """Unbonded + bonded plain versions == stencil_grads_ctx(kernel=False)
    (the reference's per-step force path, original nucleotide order)."""
    s = systems
    dyn, com, q, *_ = k2_case
    ctx_x = st.prepare_stencil_context(s.e, s.nb.w_short, s.nb.w_wide, perm=s.nb.perm, w_terms=s.nb.w_terms,
                                       kernel=False)
    g = st.stencil_grads_ctx(s.e, ctx_x, jsoa.BodySoA(jsoa.Vec3(*jnp.asarray(com).T), jsoa.Quat(*jnp.asarray(q).T)))
    ref = np.stack([np.asarray(c) for c in (*g.center, *g.orientation)])
    dyn_t = torch.as_tensor(dyn)
    got = s.ctx.from_slots(ts.field_grads_plain(s.ctx, dyn_t) + ts.bonded_grads_plain(s.ctx, dyn_t)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_field_grads_coax_term_matches_xla(systems):
    """oxDNA1's coaxial stacking alone (term weights 0 but coax's) on a
    state with three coaxially stacked pairs placed in (zero in a duplex):
    the port's band against _xla_field_grads_layout, rtol 1e-4, atol 1e-4
    max|ref|."""
    s = systems
    perm, n = s.nb.perm, s.ctx.n
    com, quat = (np.array(x, np.float64)[perm] for x in (s.body.center, s.body.orientation))
    com, quat = coax_engaged(com, quat, [(10, 11), (30, 33), (50, 57)], seed=3)
    dyn = np.concatenate([com.T, quat.T]).astype(np.float32)
    gt = np.zeros((1, 8), np.float32)
    gt[0, 3] = 1.0
    kctx = s.sctx.kernel_ctx
    ref = _flat(st._xla_field_grads_layout(kctx.kspec, kctx.params_vec, jnp.asarray(gt), _layout(dyn, s), kctx.wt_l,
                                           kctx.pn_l, kctx.qf_l), s, 7)
    params = s.ctx.params.clone()
    off = ts.param_offsets()["GT"]
    params[off : off + 8] = torch.as_tensor(gt[0])
    got = ts.field_grads_plain(dc.replace(s.ctx, params=params), torch.as_tensor(dyn)).numpy()
    assert np.abs(ref).max() > 1.0 and n == 2 * N_BP
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


# K1's plain version ----------------------------------------------------------


@pytest.fixture(scope="module")
def xla_chunk(systems):
    """The jitted JAX 40-step chunk (_xla_multistep_reference), its exact
    checks widened to every in-band offset (d_lo 1) so that row 19 counts
    the helix's own contacts, and the port context with the same checks."""
    s = systems
    checks = tuple((fa, fb, cu, 1, d_hi) for fa, fb, cu, _, d_hi in s.nb.site_checks)
    mctx = st.prepare_multistep_context(s.e, s.sctx, s.sim.simulator_params, U)
    mspec = mctx.mspec._replace(site_checks=checks, check_dm=s.nb.check_dm)
    kctx = s.sctx.kernel_ctx
    fn = jax.jit(st._xla_multistep_reference, static_argnums=0)

    def run(noise, state):  # (U, 6, n) bf16 torch, (19, n) f32 numpy -> (20, n)
        noise_l = jnp.stack([_layout(noise[t].float().numpy(), s).astype(jnp.bfloat16) for t in range(U)])
        out = fn(mspec, mctx.params_vec, mctx.gt, noise_l, _layout(state, s), kctx.wt_l, kctx.pn_l, kctx.qf_l,
                 mctx.bd_l)
        return _flat(out, s, 20)

    table = torch.tensor([[FAMILY_IDS[fa], FAMILY_IDS[fb], cu, lo, hi] for fa, fb, cu, lo, hi in checks])
    return run, dc.replace(s.ctx, checks=table)


@pytest.fixture(scope="module")
def k1_case(systems, xla_chunk):
    run, ctx = xla_chunk
    rng = np.random.default_rng(1)
    n = ctx.n
    dyn, _, _ = _jittered_slots(systems, seed=1)
    state = np.concatenate([dyn, 0.3 * rng.standard_normal((6, n)), 0.5 * rng.standard_normal((6, n))])
    state = torch.as_tensor(state.astype(np.float32))
    noise = torch.as_tensor(rng.standard_normal((U, 6, n)).astype(np.float32)).to(torch.bfloat16)
    ou = ts.ou_constants(5e-3, KT, [1.0], [[1.0, 1.0, 1.0]], [KT / 2.5], [KT / 7.5]).vector("cpu")
    got = ts.multistep_chunk_plain(ctx, ou, noise, state).numpy()
    got64 = ts.multistep_chunk_plain(ctx.astype(torch.float64), ou.double(), noise, state.double()).numpy()
    return run(noise, state.numpy()), got, got64


@pytest.mark.parametrize("block", ["position", "momentum", "force", "violations"])
def test_multistep_twin_matches_xla_reference(block, k1_case):
    """multistep_chunk_plain (rna2) against _xla_multistep_reference over
    one 40-step chunk, the same bf16 noise, per row: rtol 2e-4, atol 5e-5,
    or where two float32 orderings drift apart over 40 steps, the float32
    budget of chip_smoke.py's phase 4, |port - JAX| <= 2 |port - port
    float64| + 5e-5 + 2e-4 max|row|. Row 19 (the entry-position checks,
    bonded partners masked, on the (a1, a3) backbone) counts the helix's
    in-band contacts under the widened checks, equal on both."""
    ref, got, got64 = k1_case
    rows = {"position": range(0, 7), "momentum": range(7, 13), "force": range(13, 19), "violations": range(19, 20)}
    for r in rows[block]:
        fixed = np.abs(got[r] - ref[r]) <= 5e-5 + 2e-4 * np.abs(ref[r])
        budget = np.abs(got[r] - ref[r]).max() <= 2 * np.abs(got[r] - got64[r]).max() + 5e-5 + 2e-4 * np.abs(
            got64[r]).max()
        assert fixed.all() or budget, (r, float(np.abs(got[r] - ref[r]).max()))
    if block == "violations":
        assert ref[19].sum() > 0
        np.testing.assert_array_equal(got[19], ref[19])


# the slice as a whole ----------------------------------------------------------


@pytest.fixture(scope="module")
def slice_runs(systems, xla_chunk):
    """build_sim(model="rna2", device="cpu"): two 40-step chunks at 80 nt
    with the thermostat on; the JAX loop of two _xla_multistep_reference
    chunks from the port's initial state (its K2 + bonded initial force)
    with the noise the port's generator drew."""
    run, _ = xla_chunk
    s = systems
    sim = s.tsim
    out = sim.run(s.opt, s.tbody, 2 * U, torch.Generator().manual_seed(5)).observables[0]
    gen = torch.Generator().manual_seed(5)
    ctx = ts.prepare_stencil_context(s.te.with_params(s.opt), sim.band)
    state = sim.initial_state(ctx, s.tbody, gen).numpy()
    saves = []
    for _ in range(2):
        noise = torch.randn((U, 6, ctx.n), generator=gen).to(torch.bfloat16)
        state = run(noise, state)[:19]
        saves.append(ctx.from_slots(torch.as_tensor(state[:7])).numpy())
    return out, np.stack(saves)


@pytest.mark.parametrize("field", ["center", "orientation"])
def test_slice_matches_jax_chunk_loop(field, slice_runs):
    """The port's two chunks == the JAX loop (rtol 1e-4, atol 1e-5)."""
    out, ref = slice_runs
    got = getattr(out, field).numpy()
    sl = slice(0, 3) if field == "center" else slice(3, 7)
    np.testing.assert_allclose(got, ref[:, sl].transpose(0, 2, 1), rtol=1e-4, atol=1e-5)


def test_slice_is_valid(slice_runs):
    """No overflow, finite states, |q| = 1 within 1e-5."""
    out, _ = slice_runs
    assert not bool(out.metadata["neighbor_overflow"].any())
    assert torch.isfinite(out.center).all() and torch.isfinite(out.orientation).all()
    np.testing.assert_allclose(out.orientation.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_build_sim_rna2_runs_on_the_card_only():
    """Without device="cpu" the rna2 entry point runs on the card; with no
    card it raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    top, body = synthetic_duplex(8, form="A", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.build_sim(top, KT, model="rna2", init_centers=body.center, init_orientation=body.orientation)


def test_build_sim_rna2_block_tier_raises():
    """The rna2 block tier builds on one non-symmetric table (the block
    sums; tests/test_torch_rna2_block.py holds it against the reference),
    and raises where its tables are of the wrong kind: a symmetric table
    (the tile kernels', which do not implement oxRNA2) and a two-level one."""
    top, body = synthetic_duplex(8, form="A", device="cpu")
    _, sim = entry.build_sim(top, KT, mode="block", model="rna2", init_centers=body.center, device="cpu")
    assert not sim.neighbors.symmetric and not sim.uses_kernels()
    sym = tnb.block_neighbor_list_for_topology(top, trna2.default_neighbor_cutoff(), block_size=8,
                                               init_centers=body.center)
    with pytest.raises(ValueError, match="non-symmetric"):
        sim.replace(neighbors=sym).run(sim.energy_fn.opt_params(), body, 40, torch.Generator())
    with pytest.raises(ValueError, match="symmetric"):
        tnb.block_neighbor_list_for_topology(top, trna2.default_neighbor_cutoff(), block_size=8,
                                             init_centers=body.center, symmetric=False,
                                             r_cutoff_inner=trna2.short_range_neighbor_cutoff())


def test_mixed_term_set_is_refused(systems):
    """A composed energy of neither family (dna2 terms with rna2's cross
    stacking) is refused, not run on the wrong kernel instance."""
    import mythos_tpu_torch.energy.dna2 as tdna2

    top, _ = synthetic_duplex(N_BP, device="cpu")
    e = tdna2.create_default_energy_fn(top, device="cpu")
    k = [type(fn).__name__ for fn in e.energy_fns].index("CrossStacking")
    fns = list(e.energy_fns)
    fns[k] = systems.te.energy_fns[k]
    with pytest.raises(ValueError, match="oxRNA2 term set"):
        ts.model_family(e.replace(energy_fns=fns))


def test_tile_path_refuses_rna2(systems):
    """The tile kernels (K3-K5) are oxDNA2 only: an rna2 energy is refused
    by their context, not run on oxDNA2 physics."""
    from mythos_tpu_torch.ops import tiles

    ids = torch.zeros((systems.ctx.n // 8, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="oxDNA2 term set"):
        tiles.prepare_tile_context(systems.te, ids, 8)
