"""PyTorch port (mythos_tpu_torch): the oxDNA1 model -- its terms on the
pair list and on the dense (N, N) masks, its parameters carried across, its
cutoffs -- against mythos_tpu.energy.dna1 on the same inputs.

Energies run in float64 (conftest turns x64 on); the tolerance is 1e-6
relative because XLA-CPU transcendentals are only float32-accurate even
under x64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.dna1 as jdna1  # noqa: E402
import mythos_tpu_torch.energy.dna1 as tdna1  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.simulators import neighbors as jnb  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators import neighbors as tnb  # noqa: E402

N_BP = 20
TERMS = [cls.__name__ for cls in tdna1.default_energy_fns()]


def _perturbed(opt):
    opt = {k: np.asarray(v) for k, v in opt.items()}
    opt["eps_stack_base"] = opt["eps_stack_base"] * 1.05
    opt["eps_hb"] = opt["eps_hb"] * 0.95
    opt["k_coax"] = opt["k_coax"] * 1.03
    opt["cos_phi3_star_coax"] = opt["cos_phi3_star_coax"] * 0.98
    return opt


@pytest.fixture(scope="module", params=["pairs", "dense"])
def energies(request):
    """Both packages' default oxDNA1 energy on a 0.01-jittered 20-bp duplex,
    as the pair list or the dense masks, each term at the defaults and at
    the same perturbed parameters (float64)."""
    dense = request.param == "dense"
    top_j, body_j = jax_duplex(N_BP)
    rng = np.random.default_rng(0)
    c = np.asarray(body_j.center) + 0.01 * rng.standard_normal(np.shape(body_j.center))
    q = np.asarray(body_j.orientation) + 0.01 * rng.standard_normal(np.shape(body_j.orientation))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e_j = jdna1.create_default_energy_fn(top_j, dense_unbonded=dense)
    opt = _perturbed(e_j.opt_params())
    top_t, _ = synthetic_duplex(N_BP, dtype=torch.float64, device="cpu")
    e_t = tdna1.create_default_energy_fn(top_t, dtype=torch.float64, device="cpu", dense_unbonded=dense)
    jbody = JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))
    tbody = RigidBody(torch.as_tensor(c), torch.as_tensor(q))
    terms_j = jax.jit(lambda p: e_j.with_params(p).compute_terms(jbody))
    default_j, perturbed_j = (np.asarray(terms_j(p)) for p in (e_j.opt_params(), opt))
    default_t = e_t.compute_terms(tbody).numpy()
    perturbed_t = e_t.with_params(params_from_numpy(opt, dtype=torch.float64)).compute_terms(tbody).numpy()
    return e_j, e_t, tbody, default_j, default_t, perturbed_j, perturbed_t


@pytest.mark.parametrize("term", TERMS)
def test_term_energy_matches_jax(term, energies):
    """Each term of the default oxDNA1 energy equals the reference's, rtol
    1e-6, on the pair list and on the dense masks."""
    *_, default_j, default_t, _, _ = energies
    k = TERMS.index(term)
    np.testing.assert_allclose(default_t[k], default_j[k], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("term", TERMS)
def test_term_energy_matches_jax_with_params_carried_across(term, energies):
    """The same at perturbed parameters carried across with
    params_from_numpy (eps_stack_base, eps_hb, k_coax, cos_phi3_star_coax
    moved), rtol 1e-6."""
    *_, perturbed_j, perturbed_t = energies
    k = TERMS.index(term)
    np.testing.assert_allclose(perturbed_t[k], perturbed_j[k], rtol=1e-6, atol=1e-12)


def test_opt_params_names_match(energies):
    """The port's opt_params are the reference's: the same names and values
    (stacking's kt fixed, not among them)."""
    e_j, e_t, *_ = energies
    ref, got = e_j.opt_params(), e_t.opt_params()
    assert sorted(ref) == sorted(got) and "kt" not in got
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-12, err_msg=k)


def test_dense_and_pairs_gradients_agree(energies):
    """The port's dense masks and pair list give the same force and torque
    (finite on the masked diagonal), float64, rtol 1e-10."""
    _, e_t, tbody, *_ = energies
    top = e_t.energy_fns[0].topology
    grads = []
    for dense in (False, True):
        e = tdna1.create_default_energy_fn(top, dtype=torch.float64, device="cpu", dense_unbonded=dense)
        c, q = (x.clone().requires_grad_(True) for x in tbody)
        grads.append(torch.autograd.grad(e(RigidBody(c, q)), (c, q)))
    for a, b in zip(*grads, strict=True):
        assert torch.isfinite(b).all()
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-10, atol=1e-12)


def test_dense_pair_mask_matches_jax():
    """dense_pair_mask and bonded_exclusion_mask equal the reference's, and
    select exactly the topology's unbonded pairs."""
    top_j, _ = jax_duplex(8)
    top_t, _ = synthetic_duplex(8, device="cpu")
    np.testing.assert_array_equal(tnb.dense_pair_mask(top_t), jnb.dense_pair_mask(top_j))
    np.testing.assert_array_equal(tnb.bonded_exclusion_mask(16, top_t.bonded_neighbors),
                                  jnb.bonded_exclusion_mask(16, top_j.bonded_neighbors))
    np.testing.assert_array_equal(np.argwhere(tnb.dense_pair_mask(top_t)), top_t.unbonded_neighbors)


def test_cutoffs_match_jax():
    """max_site_offset, default_neighbor_cutoff, per_term_neighbor_cutoffs
    and per_term_site_cutoffs equal the reference's (no Debye term)."""
    assert tdna1.max_site_offset() == pytest.approx(jdna1.max_site_offset(), rel=1e-12)
    assert tdna1.default_neighbor_cutoff() == pytest.approx(jdna1.default_neighbor_cutoff(), rel=1e-12)
    ref, got = jdna1.per_term_neighbor_cutoffs(), tdna1.per_term_neighbor_cutoffs()
    assert sorted(ref) == sorted(got) and "Debye" not in got
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-12), k
    ref, got = jdna1.per_term_site_cutoffs(), tdna1.per_term_site_cutoffs()
    assert {k: tuple(map(float, v)) for k, v in ref["sites"].items()} == got["sites"]
    assert sorted(ref["terms"]) == sorted(got["terms"])
    for k, pairs in ref["terms"].items():
        for (fa, fb, cu), (ga, gb, gu) in zip(pairs, got["terms"][k], strict=True):
            assert (fa, fb) == (ga, gb) and gu == pytest.approx(cu, rel=1e-12)


def test_nucleotide_sites_match_jax():
    """The dna1 Nucleotide (AoS) and NucleotideSoA sites equal the
    reference's transform: back, hb and stacking sites on a1."""
    top_j, body_j = jax_duplex(4)
    ref = jdna1.default_transform_fn()(body_j)
    body = RigidBody(torch.as_tensor(np.array(body_j.center)), torch.as_tensor(np.array(body_j.orientation)))
    got = tdna1.default_transform_fn()(body)
    soa = tdna1.default_transform_soa_fn()(body)
    for f_ref, f_got, f_soa in (("back_sites", "back_sites", "back"), ("base_sites", "base_sites", "base"),
                                ("stack_sites", "stack_sites", "stack"), ("cross_prods", "cross_prods", "a2")):
        want = np.asarray(getattr(ref, f_ref))
        np.testing.assert_allclose(getattr(got, f_got).numpy(), want, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(torch.stack(tuple(getattr(soa, f_soa)), -1).numpy(), want, rtol=1e-12, atol=1e-14)
