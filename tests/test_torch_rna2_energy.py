"""PyTorch port (mythos_tpu_torch): the oxRNA2 energy against the JAX
package on the same inputs.

Float64 (conftest turns x64 on), rtol 1e-6 as tests/test_torch_energy.py
holds the oxDNA2 terms: the per-term energies of the default composed
energy on a 12-bp A-form duplex (ideal, jittered, with coaxially stacked
pairs placed in, and with changed parameters carried across by
``params_from_numpy``), the re-derived dependent parameters, the cutoffs
and band slacks, and the stencil's rna2 bonded gradient against the JAX
``_bonded_energy`` with its ``rna2_geom`` offsets.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.rna2 as jrna2  # noqa: E402
import mythos_tpu_torch.energy.rna2 as trna2  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.ops import stencil as st  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.soa import Quat as JQuat  # noqa: E402
from mythos_tpu.soa import Vec3 as JVec3  # noqa: E402
from mythos_tpu.soa import quat_frame_soa as jframe  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import coax_engaged, synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators.neighbors import StencilBand, strand_interleave_perm  # noqa: E402

N_BP = 12
TERMS = [cls.__name__ for cls in trna2.default_energy_fns()]


def _perturbed(opt):
    opt = {k: np.array(v) for k, v in opt.items()}
    for k, f in (("eps_stack_base", 1.05), ("eps_hb", 0.95), ("q_eff", 1.02), ("k_coax", 1.1), ("a_stack_9", 0.9),
                 ("theta0_cross_7", 1.03), ("cos_phi3_star_coax", 0.9)):
        opt[k] = opt[k] * f
    return opt


@pytest.fixture(scope="module")
def energies():
    """Both packages' default oxRNA2 energy on a 12-bp A-form duplex:
    per-term energies of four cases (float64)."""
    top_j, body_j = jax_duplex(N_BP, form="A")
    e_j = jrna2.create_default_energy_fn(top_j)
    top_t, _ = synthetic_duplex(N_BP, form="A", dtype=torch.float64, device="cpu")
    e_t = trna2.create_default_energy_fn(top_t, dtype=torch.float64, device="cpu")
    com, quat = np.array(body_j.center, np.float64), np.array(body_j.orientation, np.float64)
    rng = np.random.default_rng(0)
    jit_c = com + 0.05 * rng.standard_normal(com.shape)
    jit_q = quat + 0.05 * rng.standard_normal(quat.shape)
    jit_q /= np.linalg.norm(jit_q, axis=1, keepdims=True)
    n = top_t.n_nucleotides
    coax = coax_engaged(com, quat, [(2, n - 4), (6, 7)], seed=1)
    opt = _perturbed(e_j.opt_params())
    cases = {"ideal": (com, quat, None), "jittered": (jit_c, jit_q, None), "coax": (*coax, None),
             "perturbed": (jit_c, jit_q, opt)}
    out = {}
    for name, (c, q, o) in cases.items():
        ej, et = (e_j, e_t) if o is None else (e_j.with_params(o), e_t.with_params(params_from_numpy(o, dtype=torch.float64)))
        ref = np.asarray(jax.jit(ej.compute_terms)(JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))))
        got = et.compute_terms(RigidBody(torch.as_tensor(c), torch.as_tensor(q))).numpy()
        out[name] = (ref, got)
    return e_j, e_t, opt, out


def test_opt_params_names_match(energies):
    e_j, e_t, *_ = energies
    assert set(e_j.opt_params()) == set(e_t.opt_params())


@pytest.mark.parametrize("term", TERMS)
def test_dependent_params_rederived(term, energies):
    """with_params(params_from_numpy(...)) re-derives every dependent
    parameter as the JAX with_params does (float64, rtol 1e-12)."""
    e_j, e_t, opt, _ = energies
    k = TERMS.index(term)
    pj = e_j.with_params(opt).energy_fns[k].params
    pt = e_t.with_params(params_from_numpy(opt, dtype=torch.float64)).energy_fns[k].params
    assert set(pt.dependent_params) == set(pj.dependent_params)
    for name in (*pj.dependent_params, *pj.required_params):
        np.testing.assert_allclose(np.asarray(getattr(pt, name), np.float64), np.asarray(getattr(pj, name), np.float64),
                                   rtol=1e-12, atol=0, err_msg=name)


@pytest.mark.parametrize("case", ["ideal", "jittered", "coax", "perturbed"])
@pytest.mark.parametrize("term", TERMS)
def test_term_energy_matches_jax(term, case, energies):
    """Per-term energies on the pair-list path (float64, rtol 1e-6)."""
    ref, got = energies[3][case]
    k = TERMS.index(term)
    np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-12)


def test_coax_case_engages_coaxial_stacking(energies):
    """The coax case exercises oxDNA1's coaxial stacking (zero in a duplex)."""
    ref, got = energies[3]["coax"]
    k = TERMS.index("CoaxialStacking")
    assert ref[k] < -0.1 and energies[3]["ideal"][0][k] == 0.0


def test_cutoffs_and_slacks_match_jax():
    assert trna2.default_neighbor_cutoff() == pytest.approx(jrna2.default_neighbor_cutoff(), rel=1e-12)
    assert trna2.short_range_neighbor_cutoff() == pytest.approx(jrna2.short_range_neighbor_cutoff(), rel=1e-12)
    assert trna2.max_site_offset() == pytest.approx(jrna2.max_site_offset(), rel=1e-12)
    got, ref = trna2.per_term_site_cutoffs(), jrna2.per_term_site_cutoffs()
    assert got["sites"] == pytest.approx(ref["sites"])
    for nm, pairs in ref["terms"].items():
        assert [(a, b) for a, b, _ in got["terms"][nm]] == [(a, b) for a, b, _ in pairs]
        np.testing.assert_allclose([c for *_, c in got["terms"][nm]], [c for *_, c in pairs], rtol=1e-12)
    assert trna2.aform_site_slacks() == jrna2.aform_site_slacks()
    assert trna2.aform_far_slack() == jrna2.aform_far_slack()


def test_rna2_bonded_gradient_matches_jax():
    """The stencil's rna2 bonded terms (FENE, bonded excluded volume, rna2
    stacking at slot offset 2): d/dcom and d/dquat of ``bonded_energy``
    against jax.grad of the JAX ``_bonded_energy`` with ``rna2_geom`` (the
    frames through quat_frame_soa), the same slot-order inputs, float64,
    rtol 1e-6."""
    n_bp = 10
    top, body = synthetic_duplex(n_bp, form="A", dtype=torch.float64, device="cpu")
    e_t = trna2.create_default_energy_fn(top, dtype=torch.float64, device="cpu")
    perm = strand_interleave_perm(top)
    n = top.n_nucleotides
    band = StencilBand(n=n, w_wide=4, check_block=4, perm=perm, site_geometry=(), site_checks=(), check_dm=6,
                       far_cutoff=1.0, w_terms=(2, 2, 2, 2))
    ctx = ts.prepare_stencil_context(e_t, band, dtype=torch.float64)
    rng = np.random.default_rng(2)
    com = body.center.numpy()[perm] + 0.03 * rng.standard_normal((n, 3))
    q = body.orientation.numpy()[perm] + 0.03 * rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    dyn = np.concatenate([com.T, q.T])
    got = ts.bonded_grads_plain(ctx, torch.as_tensor(dyn)).numpy()

    top_j, _ = jax_duplex(n_bp, form="A")
    e_j = jrna2.create_default_energy_fn(top_j)
    by_name = {type(fn).__name__: fn for fn in e_j.energy_fns}
    bparams = tuple(by_name[k].params for k in ("Fene", "BondedExcludedVolume", "Stacking"))
    kw = e_j.energy_fns[0].transform_soa_fn.keywords
    geometry = ("rna2", tuple(float(kw[k]) for k in ("com_to_backbone_x", "com_to_backbone_y", "com_to_hb",
                                                        "com_to_stacking")))
    rna2_geom = tuple(float(kw[k]) for k in ("pos_stack_3_a1", "pos_stack_3_a2", "pos_stack_5_a1", "pos_stack_5_a2",
                                             "p3_x", "p3_y", "p3_z", "p5_x", "p5_y", "p5_z"))
    wstack, dirf = jnp.asarray(ctx.wstack.numpy()), jnp.asarray(ctx.dirf.numpy())

    def energy(rows):
        c, quat = JVec3(*rows[:3]), JQuat(*rows[3:])
        fi = (c, *jframe(quat))
        fj = tuple(JVec3(*(jnp.roll(x, -2) for x in v)) for v in fi)
        return st._bonded_energy(fi, fj, bparams, (1.0, 1.0, 1.0), float(kw["com_to_backbone_x"]), geometry,
                                 wstack, dirf, rna2_geom)

    ref = np.stack(jax.grad(energy)(tuple(jnp.asarray(r) for r in dyn)))
    assert math.isfinite(float(np.abs(ref).sum())) and np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9 * np.abs(ref).max())
