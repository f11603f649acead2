"""PyTorch port (mythos_tpu_torch): the stencil band and the plain twins
of kernels K1 and K2.

The JAX stencil refuses x64 (ERR_X64), so this module runs JAX in float32
(module fixture, as tests/test_multistep.py does) and holds the port's
twins against the XLA references the Pallas kernels were tested against:
``_xla_field_grads_layout``, ``stencil_grads_ctx(kernel=False)`` and
``_xla_multistep_reference``. No Pallas kernel runs here; the kernels
themselves are tested against these twins in test_torch_cuda.py.
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.dna2 as jdna2  # noqa: E402
import mythos_tpu_torch.energy.dna2 as tdna2  # noqa: E402
from __graft_entry__ import _build_sim, _tiny_duplex  # noqa: E402
from mythos_tpu import soa as jsoa  # noqa: E402
from mythos_tpu import spaces  # noqa: E402
from mythos_tpu.ops import stencil as st  # noqa: E402
from mythos_tpu.simulators import neighbors as jnb  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.entry import build_sim  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
from mythos_tpu_torch.simulators import neighbors as tnb  # noqa: E402
from mythos_tpu_torch.soa import Quat, Vec3  # noqa: E402

KT = 296.15 * 0.1 / 300.0
N_BP = 40
CSRC = Path(__file__).resolve().parents[1] / "mythos_tpu_torch" / "ops" / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def systems(_f32_mode):
    """The 40-bp duplex on both sides: JAX sim + stencil/kernel contexts,
    port energy (same parameters) + band + stencil context."""
    topology, body = _tiny_duplex(N_BP)
    _, sim = _build_sim(
        topology, KT, mode="stencil", init_centers=body.center, init_orientation=body.orientation, model="dna2"
    )
    e = sim.energy_fn.with_params(sim.energy_fn.opt_params())
    nb = sim.neighbors
    sctx = st.prepare_stencil_context(e, nb.w_short, nb.w_wide, perm=nb.perm, w_terms=nb.w_terms, kernel=True)
    ttop, tbody = synthetic_duplex(N_BP, dtype=torch.float32, device="cpu")
    te, tsim = build_sim(ttop, KT, init_centers=tbody.center, init_orientation=tbody.orientation, device="cpu")
    opt = params_from_numpy({k: np.asarray(v) for k, v in sim.energy_fn.opt_params().items()})
    ctx = ts.prepare_stencil_context(te.with_params(opt), tsim.band)
    return types.SimpleNamespace(
        topology=topology, body=body, sim=sim, e=e, nb=nb, sctx=sctx, tbody=tbody, tsim=tsim, ctx=ctx
    )


def _perturbed_slots(s, seed: int, scale: float = 0.02):
    """(7, n) slot-order com + unit quat near the ideal helix (numpy f32)."""
    rng = np.random.default_rng(seed)
    n = s.ctx.n
    com = np.asarray(s.body.center, np.float32) + scale * rng.standard_normal((n, 3)).astype(np.float32)
    q = np.asarray(s.body.orientation, np.float32) + scale * rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    perm = s.nb.perm
    return np.concatenate([com[perm].T, q[perm].T]).astype(np.float32), com, q


def _layout(rows, s):
    kspec = s.sctx.kernel_ctx.kspec
    return jnp.stack([st._to_layout(jnp.asarray(r), kspec.s) for r in rows])


def _flat(arr_l, s, k):
    return np.stack([np.asarray(st._from_layout(arr_l[i], s.ctx.n)) for i in range(k)])


# (d) band sizing and validity ------------------------------------------------


def test_interleave_perm_matches(systems):
    np.testing.assert_array_equal(tnb.strand_interleave_perm(systems.topology), jnb.strand_interleave_perm(systems.topology))


@pytest.mark.parametrize("field", ["w_terms", "w_wide", "check_dm", "check_block", "site_checks"])
def test_band_sizing_matches(field, systems):
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


def test_band_flags_foldback_like_jax(systems):
    """The fold-back fixture of tests/test_stencil.py:119-126 on the
    site-mode band: same overflow flag before and after the fold."""
    s = systems
    com = np.asarray(s.body.center, np.float32)
    quat = np.asarray(s.body.orientation, np.float32)
    folded = com.copy()
    folded[s.topology.n_nucleotides // 4] = folded[0] + 0.1
    for c in (com, folded):
        ref = bool(s.nb._check(jnp.asarray(c), orientation=jnp.asarray(quat)))
        assert _port_flag(s.tsim.band, c, quat) == ref
    assert _port_flag(s.tsim.band, folded, quat)


def _line_bands(n=64, spacing=8.0):
    bonds = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    topo = types.SimpleNamespace(n_nucleotides=n, bonded_neighbors=bonds)
    centers = np.zeros((n, 3), np.float32)
    centers[:, 0] = spacing * np.arange(n)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    ref = jnb.stencil_band_for_site_cutoffs(
        spaces.free()[0], topo, jdna2.per_term_site_cutoffs(), init_centers=jnp.asarray(centers),
        init_orientation=jnp.asarray(quats),
    )
    got = tnb.stencil_band_for_site_cutoffs(
        topo, tdna2.per_term_site_cutoffs(), torch.as_tensor(centers), torch.as_tensor(quats)
    )
    return ref, got, centers, quats


@pytest.mark.parametrize("where", ["gap_low", "gap_high", "far"])
def test_line_band_flags_match(where, _f32_mode):
    """The straight-line fixtures of tests/test_stencil.py:137-194 (the
    block-misaligned gap offsets and the far sweep): same flags."""
    ref, got, centers, quats = _line_bands()
    assert got.check_dm == ref.check_dm and got.check_block == ref.check_block
    b_sz = ref.check_block
    s = {"gap_low": ref.check_dm - (b_sz - 1) + 1, "gap_high": ref.check_dm, "far": ref.check_dm + 1 + b_sz}[where]
    assert not _port_flag(got, centers, quats)
    moved = centers.copy()
    moved[s] = centers[0] + np.asarray([0.0, 0.2, 0.0], np.float32)
    flag_ref = bool(ref._check(jnp.asarray(moved), orientation=jnp.asarray(quats)))
    assert flag_ref
    assert _port_flag(got, moved, quats) == flag_ref


def test_param_layout_matches_cuda_header():
    """The P_* offsets of stencil_physics.cuh are the Python layout's, the
    oxRNA2 groups (dna1 coax's phi modulations, rna2 stacking's theta9/10,
    its sites and axes) among them, each as long as the header says."""
    text = (CSRC / "stencil_physics.cuh").read_text()
    header = {m.group(1): int(m.group(2)) for m in re.finditer(r"#define P_([A-Z0-9]+) (\d+)", text)}
    offsets = ts.param_offsets()
    assert header == offsets
    assert {"COAXPHI", "STACKR", "RSITES"} <= header.keys()
    sizes = {macro: len(names) for macro, _, names in ts.PARAM_GROUPS}
    assert (sizes["COAXPHI"], sizes["STACKR"], sizes["RSITES"]) == (8, 10, 10)
    assert offsets["TOTAL"] == offsets["RSITES"] + sizes["RSITES"]


# (e) K2 twin ---------------------------------------------------------------


@pytest.fixture(scope="module")
def k2_case(systems):
    s = systems
    dyn, com, q = _perturbed_slots(s, seed=0)
    kctx = s.sctx.kernel_ctx
    ref = st._xla_field_grads_layout(
        kctx.kspec, kctx.params_vec, jnp.ones((1, 8), jnp.float32), _layout(dyn, s), kctx.wt_l, kctx.pn_l, kctx.qf_l
    )
    got = ts.field_grads_plain(s.ctx, torch.as_tensor(dyn))
    return dyn, com, q, _flat(ref, s, 7), got.numpy()


@pytest.mark.parametrize("rows", ["com", "quat"])
def test_field_grads_twin_matches_xla_layout(rows, k2_case):
    """(e) field_grads_plain == _xla_field_grads_layout (f32, rtol 1e-4,
    atol 1e-5)."""
    *_, ref, got = k2_case
    sl = slice(0, 3) if rows == "com" else slice(3, 7)
    np.testing.assert_allclose(got[sl], ref[sl], rtol=1e-4, atol=1e-5)


def test_field_grads_twin_matches_stencil_grads_ctx(systems, k2_case):
    """(e) unbonded twin + bonded twin == stencil_grads_ctx(kernel=False)
    (the reference's per-step force path, original nucleotide order)."""
    s = systems
    dyn, com, q, *_ = k2_case
    ctx_x = st.prepare_stencil_context(s.e, s.nb.w_short, s.nb.w_wide, perm=s.nb.perm, w_terms=s.nb.w_terms, kernel=False)
    g = st.stencil_grads_ctx(s.e, ctx_x, jsoa.BodySoA(jsoa.Vec3(*jnp.asarray(com).T), jsoa.Quat(*jnp.asarray(q).T)))
    ref = np.stack([np.asarray(c) for c in (*g.center, *g.orientation)])
    dyn_t = torch.as_tensor(dyn)
    got = s.ctx.from_slots(ts.field_grads_plain(s.ctx, dyn_t) + ts.bonded_grads_plain(s.ctx, dyn_t)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_field_grads_wrapper_uses_twin_on_cpu(systems, k2_case):
    """On a CPU tensor the K2 wrapper runs the twin (and launches nothing)."""
    dyn, *_, got = k2_case
    before = ts.field_grads.launches
    out = ts.field_grads(systems.ctx, torch.as_tensor(dyn))
    np.testing.assert_array_equal(out.numpy(), got)
    assert ts.field_grads.launches == before


# (f) K1 twin ---------------------------------------------------------------


def _chunk_case(s, seed: int, n_inner: int, fold: bool = False):
    import ml_dtypes

    rng = np.random.default_rng(seed)
    n = s.ctx.n
    dyn, _, _ = _perturbed_slots(s, seed=seed, scale=0.01)
    if fold:
        # a within-cutoff contact at slot distance w_wide + 3 (inside the
        # exact-check range): row 19 must count it on both sides
        d = s.ctx.w_wide + 3
        dyn[0:3, d + 1] = dyn[0:3, 1] + np.float32([0.0, 0.0, 0.3])
    state = np.concatenate(
        [dyn, 0.3 * rng.standard_normal((6, n)), 0.5 * rng.standard_normal((6, n))]
    ).astype(np.float32)
    noise = rng.standard_normal((n_inner, 6, n)).astype(ml_dtypes.bfloat16)
    mctx = st.prepare_multistep_context(s.e, s.sctx, s.sim.simulator_params, n_inner)
    mspec = mctx.mspec._replace(site_checks=tuple(s.nb.site_checks), check_dm=s.nb.check_dm)
    kctx = s.sctx.kernel_ctx
    noise_l = jnp.stack([_layout(noise[t].astype(np.float32), s).astype(jnp.bfloat16) for t in range(n_inner)])
    ref = st._xla_multistep_reference(
        mspec, mctx.params_vec, mctx.gt, noise_l, _layout(state, s), kctx.wt_l, kctx.pn_l, kctx.qf_l, mctx.bd_l
    )
    ou = ts.ou_constants(5e-3, KT, [1.0], [[1.0, 1.0, 1.0]], [KT / 2.5], [KT / 7.5]).vector("cpu")
    got = ts.multistep_chunk_plain(
        s.ctx, ou, torch.from_numpy(noise.astype(np.float32)).to(torch.bfloat16), torch.as_tensor(state)
    )
    return _flat(ref, s, 20), got.numpy()


@pytest.fixture(scope="module")
def k1_case(systems):
    return _chunk_case(systems, seed=1, n_inner=4, fold=True)


@pytest.mark.parametrize("block", ["position", "momentum", "force", "violations"])
def test_multistep_twin_matches_xla_reference(block, k1_case):
    """(f) multistep_chunk_plain == _xla_multistep_reference, same bf16
    noise, 4 steps (rtol 2e-4, atol 5e-5). The state carries one
    within-cutoff contact inside the exact-check range, so row 19 (the
    entry-position checks, bonded partners masked) counts it on both."""
    ref, got = k1_case
    assert ref[19].sum() > 0
    sl = {"position": slice(0, 7), "momentum": slice(7, 13), "force": slice(13, 19), "violations": slice(19, 20)}[block]
    np.testing.assert_allclose(got[sl], ref[sl], rtol=2e-4, atol=5e-5)
