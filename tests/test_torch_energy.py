"""PyTorch port (mythos_tpu_torch): parameters, TOML and per-term energies
against the JAX package on the same inputs.

Energies run in float64 on the pair-list path (conftest turns x64 on);
the tolerance is 1e-6 relative because XLA-CPU transcendentals are only
float32-accurate even under x64.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import mythos_tpu.energy.dna2 as jdna2  # noqa: E402
import mythos_tpu_torch.energy.dna2 as tdna2  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.io.toml import parse_toml as jax_parse_toml  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.io.toml import eval_expr, parse_toml  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TERMS = [cls.__name__ for cls in tdna2.default_energy_fns()]


def _same_tree(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("model", ["dna1", "dna2"])
@pytest.mark.parametrize("which", ["energy", "simulation"])
def test_toml_matches_sympy_path(model, which):
    """(a) the ast evaluator gives the sympy path's floats exactly."""
    path = ROOT / "mythos_tpu" / "energy" / model / "defaults" / f"{which}.toml"
    _same_tree(jax_parse_toml(path), parse_toml(path))


@pytest.mark.parametrize(
    "text", ["pi", "pi / 2", "pi - 2.35", "pi - 0.25", "pi - 0.025", "296.15 * 0.1 / 300.0", "-2 * 0.5 + 3"]
)
def test_eval_expr_exact(text):
    import sympy

    assert eval_expr(text) == float(sympy.parse_expr(text).evalf(n=32))


def _perturbed(opt):
    opt = {k: np.asarray(v) for k, v in opt.items()}
    opt["eps_stack_base"] = opt["eps_stack_base"] * 1.05
    opt["eps_hb"] = opt["eps_hb"] * 0.95
    opt["q_eff"] = opt["q_eff"] * 1.02
    return opt


@pytest.fixture(scope="module")
def energies():
    """Both packages' default oxDNA2 energy on a 12-bp duplex, rebound to
    the same perturbed parameters (float64)."""
    top_j, body_j = jax_duplex(12)
    e_j = jdna2.create_default_energy_fn(top_j)
    opt = _perturbed(e_j.opt_params())
    e_j = e_j.with_params(opt)
    top_t, body_t = synthetic_duplex(12, dtype=torch.float64, device="cpu")
    e_t = tdna2.create_default_energy_fn(top_t, dtype=torch.float64, device="cpu")
    e_t = e_t.with_params(params_from_numpy(opt, dtype=torch.float64))
    terms_j = np.asarray(jax.jit(e_j.compute_terms)(body_j))
    terms_t = e_t.compute_terms(body_t).numpy()
    return e_j, e_t, terms_j, terms_t, (body_j, body_t)


def test_synthetic_duplex_matches():
    top_j, body_j = jax_duplex(8)
    top_t, body_t = synthetic_duplex(8, device="cpu")
    np.testing.assert_array_equal(np.asarray(body_j.center), body_t.center.numpy())
    np.testing.assert_array_equal(np.asarray(body_j.orientation), body_t.orientation.numpy())
    np.testing.assert_array_equal(top_j.bonded_neighbors, top_t.bonded_neighbors)
    np.testing.assert_array_equal(np.asarray(top_j.seq), top_t.seq)
    np.testing.assert_array_equal(top_j.is_end, top_t.is_end)


def test_opt_params_names_match(energies):
    e_j, e_t, *_ = energies
    assert set(e_j.opt_params()) == set(e_t.opt_params())


@pytest.mark.parametrize("term", TERMS)
def test_dependent_params_rederived(term, energies):
    """(b) with_params(params_from_numpy(...)) re-derives every dependent
    parameter as the JAX with_params does (float64, rtol 1e-12)."""
    e_j, e_t, *_ = energies
    k = TERMS.index(term)
    pj, pt = e_j.energy_fns[k].params, e_t.energy_fns[k].params
    assert set(pt.dependent_params) == set(pj.dependent_params)
    for name in pj.dependent_params:
        np.testing.assert_allclose(
            getattr(pt, name).numpy(), np.asarray(getattr(pj, name)), rtol=1e-12, atol=0, err_msg=name
        )
    for name in pj.required_params:
        np.testing.assert_allclose(
            np.asarray(getattr(pt, name), np.float64), np.asarray(getattr(pj, name), np.float64),
            rtol=1e-12, err_msg=name,
        )


@pytest.mark.parametrize("term", TERMS)
def test_term_energy_matches_jax(term, energies):
    """(c) per-term energies on the pair-list path (float64, rtol 1e-6)."""
    *_, terms_j, terms_t, _ = energies
    k = TERMS.index(term)
    np.testing.assert_allclose(terms_t[k], terms_j[k], rtol=1e-6, atol=1e-12)


def test_total_energy_gradient_flows_to_params(energies):
    """Dependent params re-derive under autograd: d E / d eps_stack_base
    through the derivation matches a finite difference."""
    _, e_t, _, _, (_, body_t) = energies
    opt = {k: v.detach().clone().requires_grad_(True) for k, v in e_t.opt_params().items()}
    e = e_t.with_params(opt)(body_t)
    (g,) = torch.autograd.grad(e, opt["eps_stack_base"])
    h = 1e-6
    up = {**opt, "eps_stack_base": opt["eps_stack_base"].detach() + h}
    dn = {**opt, "eps_stack_base": opt["eps_stack_base"].detach() - h}
    fd = (e_t.with_params(up)(body_t) - e_t.with_params(dn)(body_t)) / (2 * h)
    np.testing.assert_allclose(g.item(), fd.item(), rtol=1e-6)


def test_port_imports_no_jax():
    """(h) importing every module of the port (the oxRNA2 and oxDNA1
    packages, the oxDNA file readers, the small-system path, the fitting
    loop -- objectives, optimizer, loggers, the native trajectory parser's
    binding, the examples --, the block sums, the oxNA hybrid package and
    the neighbor lists among them) pulls in no jax, chex, sympy,
    MDAnalysis, nor any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mythos_tpu_torch\n"
        "for m in pkgutil.walk_packages(mythos_tpu_torch.__path__, 'mythos_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'chex', 'sympy', 'MDAnalysis', 'mythos_tpu'))\n"
        "assert not bad, bad\n"
        "rna2 = {'mythos_tpu_torch.energy.rna2', 'mythos_tpu_torch.energy.rna2.nucleotide', "
        "'mythos_tpu_torch.energy.rna2.terms'}\n"
        "assert rna2 <= set(sys.modules), rna2 - set(sys.modules)\n"
        "dna1 = {'mythos_tpu_torch.energy.dna1', 'mythos_tpu_torch.energy.dna1.nucleotide', "
        "'mythos_tpu_torch.io.trajectory', 'mythos_tpu_torch.io.oxdna_input', 'mythos_tpu_torch.utils.units'}\n"
        "assert dna1 <= set(sys.modules), dna1 - set(sys.modules)\n"
        "fit = {'mythos_tpu_torch.optimization.objective', 'mythos_tpu_torch.optimization.optimization', "
        "'mythos_tpu_torch.simulators.base', 'mythos_tpu_torch.ui.loggers.sinks', 'mythos_tpu_torch.io.native', "
        "'mythos_tpu_torch.utils.helpers', "
        "'mythos_tpu_torch.examples.difftre_propeller_fit', 'mythos_tpu_torch.examples.dna1_simulation'}\n"
        "assert fit <= set(sys.modules), fit - set(sys.modules)\n"
        "na1 = {'mythos_tpu_torch.energy.na1', 'mythos_tpu_torch.energy.na1.hybrid', "
        "'mythos_tpu_torch.energy.na1.nucleotide', 'mythos_tpu_torch.energy.blocks', "
        "'mythos_tpu_torch.simulators.neighbors'}\n"
        "assert na1 <= set(sys.modules), na1 - set(sys.modules)\n"
        "print(len([k for k in sys.modules if k.startswith('mythos_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
