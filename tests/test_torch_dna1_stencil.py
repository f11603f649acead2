"""PyTorch port (mythos_tpu_torch): the oxDNA1 stencil -- the band, the
dna1 plain versions of kernels K1 and K2 -- against the JAX package on the
40-bp B-form duplex (80 nt).

The JAX stencil refuses x64 (ERR_X64), so this module runs JAX in float32
(module fixture) and holds the port against the XLA references the Pallas
kernels were tested against: ``_xla_field_grads_layout`` and
``_xla_multistep_reference`` (jitted once for a 40-step chunk). No Pallas
kernel runs here; the CUDA kernels are held against these plain versions in
test_torch_cuda.py.
"""

import dataclasses as dc
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _build_sim, _tiny_duplex  # noqa: E402
from mythos_tpu.ops import stencil as st  # noqa: E402
from mythos_tpu_torch import entry  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
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
    """The 40-bp duplex under oxDNA1 on both sides: JAX sim (site band,
    B-DNA slacks, site_margin 1) + stencil/kernel contexts; port energy
    (the same parameters) + band + stencil context."""
    topology, body = _tiny_duplex(N_BP)
    _, sim = _build_sim(topology, KT, mode="stencil", init_centers=body.center, init_orientation=body.orientation,
                        model="dna1")
    e = sim.energy_fn.with_params(sim.energy_fn.opt_params())
    nb = sim.neighbors
    sctx = st.prepare_stencil_context(e, nb.w_short, nb.w_wide, perm=nb.perm, w_terms=nb.w_terms, kernel=True)
    ttop, tbody = synthetic_duplex(N_BP, dtype=torch.float32, device="cpu")
    te, tsim = entry.build_sim(ttop, KT, model="dna1", init_centers=tbody.center, init_orientation=tbody.orientation,
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
    return np.concatenate([com[perm].T, q[perm].T]).astype(np.float32)


def test_band_and_family_match_jax(systems):
    """The port finds the dna1 family where the reference finds dna1's cross
    and coax variants and no Debye, with the one backbone site on a1 (GEOM's
    a2 coefficient 0, FENE and stacking on the same site, Debye's weight 0,
    charge factors ones); the band's reaches, check_dm and exact checks
    equal JAX's under dna1's sites (w_wide the widest short-range reach);
    and its overflow flag equals JAX's on the ideal helix and with the
    fold-back of tests/test_stencil.py:119-126."""
    s = systems
    assert s.ctx.family == "dna1"
    spec = s.sctx.spec
    assert (spec.cross_variant, spec.coax_variant, spec.has_debye) == ("dna1", "dna1", False)
    P = ts.unpack_params(s.ctx.params)
    assert float(P["GEOM"].by) == 0.0 and float(P["GEOM"].bd1) == float(P["GEOM"].bx) == pytest.approx(-0.4)
    assert float(P["GT"].debye) == 0.0 and torch.equal(s.ctx.qf, torch.ones(s.ctx.n))
    band = s.tsim.band
    for field in ("w_terms", "w_wide", "check_dm", "check_block"):
        assert tuple(np.atleast_1d(getattr(band, field))) == tuple(np.atleast_1d(getattr(s.nb, field))), field
    assert len(band.site_checks) == len(s.nb.site_checks)
    for x, y in zip(band.site_checks, s.nb.site_checks, strict=True):
        assert (x[0], x[1], x[3], x[4]) == (y[0], y[1], y[3], y[4])
        np.testing.assert_allclose(x[2], y[2], rtol=1e-6)
    assert band.w_wide == max(band.w_terms)
    for folded in (False, True):
        com, quat = np.asarray(s.body.center, np.float32), np.asarray(s.body.orientation, np.float32)
        if folded:
            com = com.copy()
            com[s.topology.n_nucleotides // 4] = com[0] + 0.1
        ref = bool(s.nb._check(jnp.asarray(com), orientation=jnp.asarray(quat)))
        assert bool(band.check(Vec3(*torch.tensor(com).T), Quat(*torch.tensor(quat).T))) == ref == folded


# K2's plain version ----------------------------------------------------------


@pytest.fixture(scope="module")
def k2_case(systems):
    s = systems
    dyn = _jittered_slots(s, seed=0)
    kctx = s.sctx.kernel_ctx
    ref = st._xla_field_grads_layout(
        kctx.kspec, kctx.params_vec, jnp.ones((1, 8), jnp.float32), _layout(dyn, s), kctx.wt_l, kctx.pn_l, kctx.qf_l
    )
    got = ts.field_grads_plain(s.ctx, torch.as_tensor(dyn))
    return dyn, _flat(ref, s, 7), got.numpy()


def test_field_grads_plain_matches_xla_layout(systems, k2_case):
    """field_grads_plain (dna1) == _xla_field_grads_layout on the jittered
    helix, float32, rtol 1e-4, atol 1e-4 max|ref|; and K2's tally by the
    plain gate (band_gate_counts) has no Debye class: every band pair is
    short-range or skipped."""
    dyn, ref, got = k2_case
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    counts = ts.band_gate_counts(systems.ctx, torch.as_tensor(dyn))
    assert counts["Debye"] == counts["debye"] == 0
    assert counts["short"] > 0 and counts["short"] + counts["skipped"] == ts._band_pairs(systems.ctx, "cpu")[0].numel()


def test_field_grads_coax_term_matches_xla(systems):
    """oxDNA1's coaxial stacking alone (term weights 0 but coax's) on a
    state with three coaxially stacked pairs placed in (zero in a duplex)
    at slot offsets inside coax's band reach (the reference's XLA band
    takes every term to w_short, the kernels each to its own reach): the
    port's band against _xla_field_grads_layout, rtol 1e-4, atol 1e-4
    max|ref|."""
    from mythos_tpu_torch.io.synthetic import coax_engaged

    s = systems
    perm = s.nb.perm
    pairs = [(10, 11), (30, 33), (50, 55)]
    assert max(j - i for i, j in pairs) <= s.ctx.w_terms[3]
    com, quat = (np.array(x, np.float64)[perm] for x in (s.body.center, s.body.orientation))
    com, quat = coax_engaged(com, quat, pairs, seed=3)
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
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


# K1's plain version ----------------------------------------------------------


@pytest.fixture(scope="module")
def k1_case(systems):
    """One 40-step chunk of multistep_chunk_plain (dna1) and of the jitted
    _xla_multistep_reference with the same bf16 normals, the exact checks
    widened to every in-band offset (d_lo 1) so that row 19 counts the
    helix's own contacts; the port's chunk also in float64."""
    s = systems
    checks = tuple((fa, fb, cu, 1, d_hi) for fa, fb, cu, _, d_hi in s.nb.site_checks)
    mctx = st.prepare_multistep_context(s.e, s.sctx, s.sim.simulator_params, U)
    mspec = mctx.mspec._replace(site_checks=checks, check_dm=s.nb.check_dm)
    kctx = s.sctx.kernel_ctx
    table = torch.tensor([[FAMILY_IDS[fa], FAMILY_IDS[fb], cu, lo, hi] for fa, fb, cu, lo, hi in checks])
    ctx = dc.replace(s.ctx, checks=table)
    rng = np.random.default_rng(1)
    n = ctx.n
    state = np.concatenate([_jittered_slots(s, seed=1), 0.3 * rng.standard_normal((6, n)),
                            0.5 * rng.standard_normal((6, n))]).astype(np.float32)
    noise = torch.as_tensor(rng.standard_normal((U, 6, n)).astype(np.float32)).to(torch.bfloat16)
    noise_l = jnp.stack([_layout(noise[t].float().numpy(), s).astype(jnp.bfloat16) for t in range(U)])
    ref = jax.jit(st._xla_multistep_reference, static_argnums=0)(
        mspec, mctx.params_vec, mctx.gt, noise_l, _layout(state, s), kctx.wt_l, kctx.pn_l, kctx.qf_l, mctx.bd_l)
    ou = ts.ou_constants(5e-3, KT, [1.0], [[1.0, 1.0, 1.0]], [KT / 2.5], [KT / 7.5]).vector("cpu")
    state_t = torch.as_tensor(state)
    four = ts.multistep_chunk_plain(ctx, ou, noise[:4], state_t).numpy()
    got = ts.multistep_chunk_plain(ctx, ou, noise, state_t).numpy()
    got64 = ts.multistep_chunk_plain(ctx.astype(torch.float64), ou.double(), noise, state_t.double()).numpy()
    ref4 = jax.jit(st._xla_multistep_reference, static_argnums=0)(
        mspec._replace(n_inner=4), mctx.params_vec, mctx.gt, noise_l[:4], _layout(state, s), kctx.wt_l, kctx.pn_l,
        kctx.qf_l, mctx.bd_l)
    return _flat(ref4, s, 20), four, _flat(ref, s, 20), got, got64


def test_multistep_plain_matches_xla(k1_case):
    """multistep_chunk_plain (dna1) against _xla_multistep_reference with
    the same bf16 noise: after 4 steps rtol 1e-4 (atol 1e-4 max|row| for
    rows that cross zero); over one 40-step chunk, per row, rtol 2e-4 /
    atol 5e-5, or where two float32 orderings drift apart over 40 steps,
    the float32 budget of chip_smoke.py's phase 4, |port - JAX| <= 2 |port
    - port float64| + 5e-5 + 2e-4 max|row|. Row 19 (the entry-position
    checks on the one backbone site) counts the helix's in-band contacts
    under the widened checks, equal on both."""
    ref4, four, ref, got, got64 = k1_case
    for r in range(19):
        np.testing.assert_allclose(four[r], ref4[r], rtol=1e-4, atol=1e-4 * np.abs(ref4[r]).max(), err_msg=str(r))
        fixed = np.abs(got[r] - ref[r]) <= 5e-5 + 2e-4 * np.abs(ref[r])
        budget = np.abs(got[r] - ref[r]).max() <= 2 * np.abs(got[r] - got64[r]).max() + 5e-5 + 2e-4 * np.abs(
            got64[r]).max()
        assert fixed.all() or budget, (r, float(np.abs(got[r] - ref[r]).max()))
    assert ref[19].sum() > 0
    np.testing.assert_array_equal(got[19], ref[19])
