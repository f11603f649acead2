"""PyTorch port (mythos_tpu_torch): the energy constructors' reference
options, periodic boxes and the composition API, against the JAX package.

``create_default_energy_fn(displacement_fn=, overrides=, opts=)`` of
oxDNA1, oxDNA2 and oxRNA2 at another temperature, salt and (oxDNA2)
half-charged ends, with a term's parameters overridden and a subset of
parameters to optimise, in a periodic box of 20 (``spaces.periodic``) that
the 0.02-jittered 20-bp duplex crosses on two faces, wrapped into it;
oxDNA2 on the dense masks, oxDNA1 and oxRNA2 on the pair lists; float64:
each term's energy and its gradient in the positions and quaternions within
rtol 1e-6 (atol 1e-6 of the term's largest gradient; XLA-CPU
transcendentals are float32-accurate even under x64), and the same
``opt_params()``. One JAX compile of each energy serves the options and the
box. Then the reference example's composition (``from_lists``,
``with_noopt``, ``with_params``; examples/melting_temperature_optimization.py:52-60)
and the rest of the composition API. No simulator and no Pallas: three
items, five JAX compiles of one energy each.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny CPU shapes: one thread a worker, no idle pool spinning beside the others

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.dna1 as jdna1  # noqa: E402
import mythos_tpu.energy.dna2 as jdna2  # noqa: E402
import mythos_tpu.energy.rna2 as jrna2  # noqa: E402
import mythos_tpu_torch.energy.dna1 as tdna1  # noqa: E402
import mythos_tpu_torch.energy.dna2 as tdna2  # noqa: E402
import mythos_tpu_torch.energy.rna2 as trna2  # noqa: E402
from mythos_tpu import spaces as jspaces  # noqa: E402
from mythos_tpu.energy.base import ComposedEnergyFunction as JaxComposed  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu_torch import spaces as tspaces  # noqa: E402
from mythos_tpu_torch.energy.base import ComposedEnergyFunction  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402

N_BP = 20
BOX = 20.0
F64 = {"dtype": torch.float64, "device": "cpu"}
#: kT, salt and half-charged ends off their defaults, two terms' parameters
#: overridden (the reference's merge), a subset of parameters to optimise
OVERRIDES = {"kT": 0.11, "salt_conc": 0.2, "half_charged_ends": True,
             "stacking": {"eps_stack_base": 1.4}, "hydrogen_bonding": {"eps_hb": 1.1}}
OPTS = {"hydrogen_bonding": ("eps_hb", "dr0_hb"), "fene": ("eps_backbone",), "stacking": ("eps_stack_base",)}
MODELS = {"dna1": (jdna1, tdna1, "B"), "dna2": (jdna2, tdna2, "B"), "rna2": (jrna2, trna2, "A")}
#: the melting-temperature example's simulation temperature (307.15 K)
SIM_KT = 0.10238333333333333


def _bodies(form: str = "B", seed: int = 0, across: bool = False):
    """(JAX topology, JAX body, port topology, port body, requires grad) of the
    20-bp duplex jittered by 0.02, float64; ``across``: its axis moved onto
    the x face of the box and its middle onto the z face, wrapped into it."""
    top_j, body = jax_duplex(N_BP, form=form)
    rng = np.random.default_rng(seed)
    c = np.asarray(body.center, np.float64) + 0.02 * rng.standard_normal(np.shape(body.center))
    q = np.asarray(body.orientation, np.float64) + 0.02 * rng.standard_normal(np.shape(body.orientation))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if across:
        c = np.mod(c + np.array([BOX - 0.3, 0.5 * BOX, BOX - 0.5 * float(c[:, 2].max())]), BOX)
    top_t, _ = synthetic_duplex(N_BP, form=form, **F64)
    body_t = RigidBody(torch.tensor(c, requires_grad=True), torch.tensor(q, requires_grad=True))
    return top_j, JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q)), top_t, body_t


def _ref_terms(e_j, body_j):
    """The reference's per-term energies and their d/dcenter, d/dorientation
    (one compile)."""
    def terms(c, q):
        return e_j.compute_terms(JaxRigidBody(center=c, orientation=q))

    ref_e, ref_g = jax.jit(lambda c, q: (terms(c, q), jax.jacrev(terms, argnums=(0, 1))(c, q)))(
        body_j.center, body_j.orientation)
    return np.asarray(ref_e), [np.asarray(g) for g in ref_g]


def _terms_and_grads(e_j, e_t, body_j, body_t):
    """Per-term energies and d/dcenter, d/dorientation of both packages."""
    ref_e, ref_g = _ref_terms(e_j, body_j)
    got_e = e_t.compute_terms(body_t)
    got_g = [torch.autograd.grad(v, (body_t.center, body_t.orientation), retain_graph=True, allow_unused=True)
             for v in got_e]
    return ref_e, ref_g, got_e.detach().numpy(), got_g


def _held(name, ref_e, ref_g, got_e, got_g, e_t):
    for k, fn in enumerate(e_t.energy_fns):
        term = f"{name} {type(fn).__name__}"
        np.testing.assert_allclose(got_e[k], ref_e[k], rtol=1e-6, atol=1e-12, err_msg=term)
        for a, (g, field) in enumerate(zip(got_g[k], ("center", "orientation"), strict=True)):
            ref = ref_g[a][k]
            g = np.zeros_like(ref) if g is None else g.numpy()
            np.testing.assert_allclose(g, ref, rtol=1e-6, atol=1e-6 * max(float(np.abs(ref).max()), 1e-12),
                                       err_msg=f"{term} d/d{field}")


def test_overrides_and_opts_match_reference():
    """dna1, dna2 and rna2 under the reference's overrides (kT 0.11, salt
    0.2, half-charged ends -- not under rna2, as the reference's notebook
    --, stacking's eps_stack_base and hb's eps_hb) and an opts subset, in
    the periodic box the duplex crosses (dna2 on the dense masks, dna1 and
    rna2 on the pair lists): per-term energies and gradients in float64 as
    the reference's, the bonds and pairs across a face among them, equal
    opt_params (keys and values), and the bound Debye r_cut and stacking kt
    are the overrides'."""
    for model, (jpkg, tpkg, form) in MODELS.items():
        over = {k: v for k, v in OVERRIDES.items() if not (model == "rna2" and k == "half_charged_ends")}
        top_j, body_j, top_t, body_t = _bodies(form, across=True)
        c = body_t.center.detach()
        assert bool(((c[:, None] - c[None]).abs().amax(-1) > 0.5 * BOX).any())  # the duplex crosses a face
        dense = model == "dna2"
        e_j = jpkg.create_default_energy_fn(top_j, displacement_fn=jspaces.periodic(BOX)[0], dense_unbonded=dense,
                                            overrides=over, opts=OPTS)
        e_t = tpkg.create_default_energy_fn(top_t, displacement_fn=tspaces.periodic(BOX)[0], dense_unbonded=dense,
                                            overrides=over, opts=OPTS, **F64)
        ref_opt, got_opt = e_j.opt_params(), e_t.opt_params()
        assert sorted(got_opt) == sorted(ref_opt), model
        for k, v in ref_opt.items():
            np.testing.assert_array_equal(got_opt[k].numpy(), np.asarray(v), err_msg=f"{model} {k}")
        assert "kt" not in got_opt and set(got_opt) >= {"eps_hb", "dr0_hb", "eps_backbone", "eps_stack_base"}
        by_name = {type(fn).__name__: fn.params for fn in e_t.energy_fns}
        assert float(by_name["Stacking"].kt) == 0.11
        if "Debye" in by_name:
            ref_debye = {type(fn).__name__: fn.params for fn in e_j.energy_fns}["Debye"]
            assert float(by_name["Debye"].r_cut) == pytest.approx(float(ref_debye.r_cut), rel=1e-12)
            assert bool(by_name["Debye"].half_charged_ends) is (model == "dna2")
        _held(model, *_terms_and_grads(e_j, e_t, body_j, body_t), e_t)


def test_from_lists_and_with_noopt_match_reference():
    """The melting-temperature example's energy: ``from_lists`` of oxDNA1's
    default terms in a periodic box of 20, ``with_noopt("ss_stack_weights",
    "ss_hb_weights", "kt")``, ``with_params(kt=...)``; the same opt_params
    keys (no kt) and values, per-term energies and gradients, weights of
    ones, the composed ``pair_cutoff``, and ``params_dict``'s keys with and
    without the non-optimizable ones."""
    top_j, body_j, top_t, body_t = _bodies()
    e_j = JaxComposed.from_lists(
        energy_fns=jdna1.default_energy_fns(), energy_configs=jdna1.default_energy_configs(),
        transform_fn=jdna1.default_transform_fn(), displacement_fn=jspaces.periodic(20.0)[0], topology=top_j,
    ).with_noopt("ss_stack_weights", "ss_hb_weights", "kt").with_params(kt=SIM_KT)
    e_t = ComposedEnergyFunction.from_lists(
        energy_fns=tdna1.default_energy_fns(), energy_configs=tdna1.default_energy_configs(**F64),
        transform_fn=tdna1.default_transform_soa_fn(), displacement_fn=tspaces.periodic(20.0)[0], topology=top_t,
    ).with_noopt("ss_stack_weights", "ss_hb_weights", "kt").with_params(kt=torch.tensor(SIM_KT, **F64))
    assert sorted(e_t.opt_params()) == sorted(e_j.opt_params()) and "kt" not in e_t.opt_params()
    np.testing.assert_array_equal(e_t.weights.numpy(), np.asarray(e_j.weights))
    assert e_t.pair_cutoff() == pytest.approx(float(e_j.pair_cutoff()), rel=1e-12)
    assert e_t.pair_cutoff() == pytest.approx(tdna1.default_neighbor_cutoff() - 2 * tdna1.max_site_offset(), rel=1e-12)
    for dep, noopt in ((True, False), (False, True), (True, True)):
        ref = e_j.params_dict(include_dependent=dep, exclude_non_optimizable=noopt)
        got = e_t.params_dict(include_dependent=dep, exclude_non_optimizable=noopt)
        assert sorted(got) == sorted(ref), (dep, noopt)
    assert "kt" not in e_t.params_dict(exclude_non_optimizable=True)
    ref_e, *rest = _terms_and_grads(e_j, e_t, body_j, body_t)
    _held("from_lists", ref_e, *rest, e_t)
    assert float(e_t(body_t).detach()) == pytest.approx(float(np.asarray(e_j.weights) @ ref_e), rel=1e-6)


def test_composition_api_matches_reference():
    """On oxDNA2's default energy: ``without_terms`` (by name and by class),
    ``add_energy_fn`` with a weight, ``+`` of two terms, of a sum and a
    term, and of two sums, ``*`` by a number, ``create_from`` and
    ``add_composable_energy_fn``: the weights and the total energy as the
    reference's (float64, rtol 1e-6)."""
    top_j, body_j, top_t, body_t = _bodies(seed=1)
    e_j = jdna2.create_default_energy_fn(top_j)
    e_t = tdna2.create_default_energy_fn(top_t, **F64)
    hb_j, hb_t = e_j.energy_fns[4], e_t.energy_fns[4]
    cases = {
        "without_terms": (e_j.without_terms("Debye", jdna2.HydrogenBonding),
                          e_t.without_terms("Debye", type(hb_t))),
        "add_energy_fn": (e_j.without_terms("Debye").add_energy_fn(e_j.energy_fns[7], 2.0),
                          e_t.without_terms("Debye").add_energy_fn(e_t.energy_fns[7], 2.0)),
        "term + term": (hb_j + e_j.energy_fns[5], hb_t + e_t.energy_fns[5]),
        "sum + term": (e_j.without_terms("Debye") + e_j.energy_fns[7], e_t.without_terms("Debye") + e_t.energy_fns[7]),
        "term * 0.5 + sum": (hb_j * 0.5 + e_j, hb_t * 0.5 + e_t),
        "create_from": (JaxComposed(energy_fns=[type(hb_j).create_from(hb_j)]),
                        ComposedEnergyFunction([type(hb_t).create_from(hb_t)])),
        "add_composable": (e_j.add_composable_energy_fn(JaxComposed(energy_fns=[hb_j], weights=jnp.array([3.0]))),
                           e_t.add_composable_energy_fn(ComposedEnergyFunction([hb_t], weights=torch.tensor([3.0])))),
    }
    # each case's total from the reference's terms and weights, over the
    # reference's per-term energies of the default function (one compile)
    ref_terms = np.asarray(jax.jit(lambda c, q: e_j.compute_terms(JaxRigidBody(center=c, orientation=q)))(
        body_j.center, body_j.orientation))
    by_name = {type(fn).__name__: v for fn, v in zip(e_j.energy_fns, ref_terms, strict=True)}
    with torch.no_grad():
        for name, (ref, got) in cases.items():
            assert [type(f).__name__ for f in got.energy_fns] == [type(f).__name__ for f in ref.energy_fns], name
            ref_w = np.ones(len(ref.energy_fns)) if ref.weights is None else np.asarray(ref.weights)
            np.testing.assert_allclose([float(w) for w in got.term_weights()], ref_w, err_msg=name)
            ref_total = ref_w @ np.array([by_name[type(f).__name__] for f in ref.energy_fns])
            np.testing.assert_allclose(float(got(body_t)), ref_total, rtol=1e-6, err_msg=name)
