"""PyTorch port (mythos_tpu_torch): direct differentiation through the
MARTINI NPT run, against ``jax.grad`` through the JAX MartiniSimulator.

``loss(sim.run(p, x0, n, ...)).backward()`` through ``MartiniSimulator.run``
gives d loss / d every tensor of ``opt_params``: every force and every
barostat virial is taken with ``create_graph`` (simulators/particles.py),
the LJ term's backward is ``ops.lj.LJGrads`` (K6's backward kernel forward
on the card; here its plain version) and its double backward the plain
version's (``lj_grads_vjp_plain``), so the gradient reaches the parameters
through the positions, the momenta and the box. The 104-bead bilayer
``lattice_bilayer(3, 3, water_layers=1)``, jittered by 0.03 nm, runs in
float64 as the reference's test does (tests/test_martini_md.py:123-145: dt
0.01 ps, 50 steps, the barostat every 10, a state every 25), the port fed
JAX's replayed momenta and normals; the loss is the mean area per lipid,
which reaches the LJ parameters only through the box, that is through the
barostat's virial and so through K6's box gradient twice differentiated.

Tolerances: the loss rtol 1e-8 and the gradients rtol 1e-5 (measured:
the port's gradients within 2e-14 of jax.grad, relative, the loss equal to
the last bit); the LJ tables' gradient of the energy rtol 1e-10;
``LJGrads`` passes float64 ``gradcheck`` and ``gradgradcheck``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny CPU shapes: one thread a worker, no idle pool spinning beside the others

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mythos_tpu.energy.martini.systems import default_bilayer_terms as j_terms  # noqa: E402
from mythos_tpu.energy.martini.systems import lattice_bilayer as j_bilayer  # noqa: E402
from mythos_tpu.observables.membranes import AreaPerLipid as JAreaPerLipid  # noqa: E402
from mythos_tpu.simulators import MartiniSimulator as JMartiniSimulator  # noqa: E402
from mythos_tpu.simulators.io import SimulatorTrajectory as JTrajectory  # noqa: E402
from mythos_tpu_torch.energy.martini import m2 as tm2  # noqa: E402
from mythos_tpu_torch.energy.martini.systems import default_bilayer_terms as t_terms  # noqa: E402
from mythos_tpu_torch.energy.martini.systems import lattice_bilayer as t_bilayer  # noqa: E402
from mythos_tpu_torch.observables.membranes import AreaPerLipid, MembraneThickness  # noqa: E402
from mythos_tpu_torch.ops import lj as tlj  # noqa: E402
from mythos_tpu_torch.simulators import particles as tpt  # noqa: E402
from mythos_tpu_torch.simulators.io import SimulatorTrajectory  # noqa: E402
from mythos_tpu_torch.simulators.martini import MartiniSimulator  # noqa: E402

BAROSTAT = {"pressure0": 1.0, "tau": 4.0, "every": 10}
N_STEPS, SAVE_EVERY, DT = 50, 25, 0.01


@pytest.fixture(scope="module")
def bilayer():
    """Both packages' 104-bead bilayer, jittered by 0.03 nm (float64), the
    PO4 head beads, and the differentiated parameters: the tail-tail LJ
    epsilon and sigma, one bond constant and one angle constant (the G96
    angle's theta0 is pi, where its gradient vanishes)."""
    j_top, pos, box, masses = j_bilayer(3, 3, water_layers=1)
    t_top = t_bilayer(3, 3, water_layers=1)[0]
    pos = pos + np.random.default_rng(1).normal(scale=0.03, size=pos.shape)
    heads = np.asarray([i for i, nm in enumerate(j_top.atom_names) if nm == "PO4"], np.int32)
    jb, ja, jl = j_terms(j_top)
    names = ("lj_epsilon_C1_C1", "lj_sigma_C1_C1", next(k for k in jb.params.params if k.startswith("bond_k_")),
             next(k for k in ja.params.params if k.startswith("angle_k_")))
    values = {k: float(fn.params.params[k]) for fn in (jb, ja, jl) for k in names if k in fn.params.params}
    return j_top, t_top, pos, box, masses, heads, values


def _port_sim(t_top, box, masses, device="cpu"):
    return MartiniSimulator(energy_fns=t_terms(t_top), box=box, masses=masses, dt=DT, save_every=SAVE_EVERY,
                            barostat=BAROSTAT, device=device)


@pytest.fixture(scope="module")
def jax_run(bilayer):
    """(loss, {name: gradient}, momenta, normals): jax.grad of the mean APL
    through the JAX MartiniSimulator.run, and its PRNG draws replayed."""
    j_top, _, pos, box, masses, heads, values = bilayer
    sim = JMartiniSimulator(energy_fns=j_terms(j_top), box=jnp.asarray(box), masses=jnp.asarray(masses), dt=DT,
                            save_every=SAVE_EVERY, barostat=BAROSTAT)
    apl = JAreaPerLipid(head_indices=jnp.asarray(heads))
    key = jax.random.PRNGKey(2)

    def loss(p):
        return jnp.mean(apl(sim.run(p, jnp.asarray(pos), N_STEPS, key).observables[0]))

    value, grads = jax.jit(jax.value_and_grad(loss))({k: jnp.asarray(v) for k, v in values.items()})

    @jax.jit
    def replay(k):
        # nvt_langevin_particles: init_fn splits once for the momenta, each
        # step splits once for its normals
        k, sub = jax.random.split(k)
        mom = jax.random.normal(sub, pos.shape, jnp.float64) * jnp.sqrt(jnp.asarray(masses)[:, None] * sim.kT)

        def step(kk, _):
            kk, s = jax.random.split(kk)
            return kk, jax.random.normal(s, pos.shape, jnp.float64)

        return mom, jax.lax.scan(step, k, None, length=N_STEPS)[1]

    mom, normals = replay(key)
    return (float(value), {k: float(v) for k, v in grads.items()}, torch.tensor(np.asarray(mom)),
            torch.tensor(np.asarray(normals)))


@pytest.fixture(scope="module")
def port_run(bilayer, jax_run):
    """(parameters, trajectory) of the port's run on JAX's noise, every
    differentiated parameter a float64 leaf."""
    _, t_top, pos, box, masses, _, values = bilayer
    _, _, mom, normals = jax_run
    p = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True) for k, v in values.items()}
    return p, _port_sim(t_top, box, masses).run(p, pos, N_STEPS, init_momentum=mom, noise=normals).observables[0]


def test_npt_gradient_matches_jax_grad(bilayer, jax_run, port_run):
    """(a) d (mean APL) / d (LJ epsilon and sigma C1-C1, a bond and an angle
    constant) through MartiniSimulator.run == jax.grad through the JAX run
    on the same noise: loss rtol 1e-8, every gradient nonzero and within
    rtol 1e-5."""
    heads = bilayer[5]
    ref_loss, ref, _, _ = jax_run
    p, traj = port_run
    loss = AreaPerLipid(head_indices=heads)(traj).mean()
    got = dict(zip(p, (g.item() for g in torch.autograd.grad(loss, list(p.values()), retain_graph=True)),
                   strict=True))
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-8)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert ref[k] != 0.0, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=0, err_msg=k)


def test_membrane_observables_stay_on_the_graph(bilayer, port_run):
    """APL (through the box) and thickness (through the positions) of a run
    with gradients carry d / d lj_epsilon_C1_C1."""
    heads = bilayer[5]
    p, traj = port_run
    apl, thick = AreaPerLipid(head_indices=heads)(traj), MembraneThickness(thickness_indices=heads)(traj)
    assert apl.requires_grad and thick.requires_grad and traj.box_size.requires_grad
    for obs in (apl, thick):
        (g,) = torch.autograd.grad(obs.mean(), p["lj_epsilon_C1_C1"], retain_graph=True)
        assert np.isfinite(g.item()) and g.item() != 0.0


def test_lj_table_gradients_match_jax(bilayer):
    """(b) the LJ energy's gradient in every sigma/epsilon parameter, through
    LJPairEnergy (its tables' gradient by autograd of lj_energy_plain),
    == jax.grad of the JAX m2.LJ energy in those parameters, float64 rtol
    1e-10."""
    j_top, t_top, pos, box, *_ = bilayer
    jl, tl = j_terms(j_top)[2], t_terms(t_top)[2]
    names = sorted(jl.params.opt_params)
    snap_j = JTrajectory(center=jnp.asarray(pos), orientation=jnp.zeros((pos.shape[0], 4)), box_size=jnp.asarray(box))
    ref = jax.jit(jax.grad(lambda p: jl.replace(params=jl.params | p).compute_energy(snap_j)))(
        {k: jnp.asarray(float(jl.params.params[k])) for k in names})
    p = {k: torch.tensor(float(tl.params.params[k]), dtype=torch.float64, requires_grad=True) for k in names}
    snap_t = SimulatorTrajectory(center=torch.as_tensor(pos), orientation=torch.zeros(pos.shape[0], 4),
                                 box_size=torch.as_tensor(box))
    e = tl.replace(params=tl.params | p).compute_energy(snap_t)
    got = torch.autograd.grad(e, [p[k] for k in names])
    assert any(float(ref[k]) != 0.0 for k in names if k.startswith("lj_sigma_"))
    for k, g in zip(names, got, strict=True):
        np.testing.assert_allclose(g.item(), float(ref[k]), rtol=1e-10, atol=1e-12, err_msg=k)


def _lj_inputs(t_top, pos, box):
    tl = t_terms(t_top)[2]
    sig, eps = tl.tables("cpu", torch.float64)
    x, b = torch.as_tensor(pos), torch.as_tensor(box)
    return tl.types("cpu"), tl.pair_mask("cpu"), [t.clone().requires_grad_(True) for t in (x, b, sig, eps)]


@pytest.mark.parametrize("order", ["gradcheck", "gradgradcheck"])
def test_lj_grads_gradcheck(bilayer, order):
    """(c) LJGrads (positions, box, sigma and epsilon tables -> the position
    and box gradients) passes float64 gradcheck and gradgradcheck (fast
    mode: along random directions of inputs and outputs) on the 104-bead
    bilayer: its backward, the plain double backward, is the
    derivative of K6's gradients, box gradient included, and is itself
    differentiable."""
    _, t_top, pos, box, *_ = bilayer
    types, mask, ins = _lj_inputs(t_top, pos, box)

    def fn(x, b, s, e):
        return tlj.LJGrads.apply(x, b, s, e, types, mask, None)

    check = torch.autograd.gradcheck if order == "gradcheck" else torch.autograd.gradgradcheck
    assert check(fn, tuple(ins), eps=1e-6, atol=1e-5, rtol=1e-4, fast_mode=True)


def test_lj_pair_energy_is_twice_differentiable(bilayer):
    """The force of LJPairEnergy taken with create_graph differentiates again:
    its gradient in the epsilon table equals the mixed second derivative of
    lj_energy_plain (float64, rtol 1e-10), and so does the table gradient's
    in the positions."""
    _, t_top, pos, box, *_ = bilayer
    types, mask, (x, b, sig, eps) = _lj_inputs(t_top, pos, box)
    w = torch.as_tensor(np.random.default_rng(5).normal(size=pos.shape))
    (g,) = torch.autograd.grad(tlj.lj_pair_energy(x, types, mask, b, (sig, eps)), x, create_graph=True)
    (got,) = torch.autograd.grad((w * g).sum(), eps)
    (g_eps,) = torch.autograd.grad(tlj.lj_pair_energy(x, types, mask, b, (sig, eps)), eps, create_graph=True)
    (got_x,) = torch.autograd.grad((g_eps * eps.detach()).sum(), x)
    e = tlj.lj_energy_plain(x, types, mask, b, (sig, eps))
    (g_ref,) = torch.autograd.grad(e, x, create_graph=True)
    (ref,) = torch.autograd.grad((w * g_ref).sum(), eps)
    (g_eps_ref,) = torch.autograd.grad(tlj.lj_energy_plain(x, types, mask, b, (sig, eps)), eps, create_graph=True)
    (ref_x,) = torch.autograd.grad((g_eps_ref * eps.detach()).sum(), x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-10, atol=1e-10 * float(ref.abs().max()))
    np.testing.assert_allclose(got_x.numpy(), ref_x.numpy(), rtol=1e-10, atol=1e-10 * float(ref_x.abs().max()))
    assert float(ref.abs().max()) > 0 and float(ref_x.abs().max()) > 0


def test_grad_run_is_the_no_grad_run(bilayer, monkeypatch):
    """(d) A run that builds the graph gives the trajectory of the same run
    under no_grad bit for bit, calls K6's wrappers (lj_energy forward,
    lj_grads backward; here their plain versions) as often in its forward,
    and leaves the generator in the same state; it builds the LJ tables
    once (LJConfiguration.tables), where a run without gradients caches
    them as well."""
    _, t_top, pos, box, masses, _, values = bilayer
    sim = _port_sim(t_top, box, masses)
    calls = {"K6 fwd": 0, "K6 bwd": 0, "tables": 0}

    def counted(key, fn):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(tlj, "lj_energy", counted("K6 fwd", tlj.lj_energy))
    monkeypatch.setattr(tlj, "lj_grads", counted("K6 bwd", tlj.lj_grads))
    monkeypatch.setattr(tm2.LJConfiguration, "tables", counted("tables", tm2.LJConfiguration.tables))
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        ref = sim.run({k: torch.tensor(v, dtype=torch.float64) for k, v in values.items()}, pos, N_STEPS,
                      gen).observables[0]
    ref_calls, ref_gen = dict(calls), gen.get_state()
    calls.update({k: 0 for k in calls})
    p = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True) for k, v in values.items()}
    gen = torch.Generator().manual_seed(7)
    got = sim.run(p, pos, N_STEPS, gen).observables[0]
    assert got.center.requires_grad and got.box_size.requires_grad
    for field in ("center", "box_size"):
        assert torch.equal(getattr(got, field).detach(), getattr(ref, field)), field
    force_evals = 1 + N_STEPS + N_STEPS // BAROSTAT["every"]
    assert calls == ref_calls == {"K6 fwd": force_evals, "K6 bwd": force_evals, "tables": 1}
    assert torch.equal(gen.get_state(), ref_gen)
    got.box_size[-1, 0].backward()
    assert calls["K6 fwd"] == force_evals and calls["K6 bwd"] == force_evals
    assert all(v.grad is not None and bool(torch.isfinite(v.grad)) for v in p.values())


@pytest.mark.parametrize("pressure0, clipped", [(1.0, False), (-1e5, True)], ids=["in range", "clipped"])
def test_barostat_gradient_through_mu(bilayer, pressure0, clipped):
    """One Berendsen step on a state on the graph: the box carries d / d
    lj_epsilon_C1_C1 through mu, and none where mu is clipped to 0.98 or
    1.02 (as jnp.clip)."""
    _, t_top, pos, box, masses, _, values = bilayer
    eps = torch.tensor(values["lj_epsilon_C1_C1"], dtype=torch.float64, requires_grad=True)
    energy = _port_sim(t_top, box, masses)._energy_fn({"lj_epsilon_C1_C1": eps})
    x, b = torch.as_tensor(pos), torch.as_tensor(box)
    init_fn, _ = tpt.nvt_langevin_particles(energy, lambda y, dy: y + dy, DT, 2.5, 72.0)
    mom = torch.as_tensor(np.random.default_rng(3).normal(size=pos.shape)) * (72.0 * 2.5) ** 0.5
    state = init_fn(x, b, torch.as_tensor(masses), mom, True)
    state = state._replace(position=state.position + 1e-3 * state.force)  # on the graph of eps
    new = tpt.berendsen_semi_isotropic(energy, state, pressure0=pressure0, tau=4.0, dt=DT * 10,
                                       compressibility=3e-4 * 16.6054)
    mu = (new.box / b).detach()
    assert bool(((mu - 1.02).abs() < 1e-12).all()) == clipped and bool(((mu - 1.0).abs() < 0.02).all()) != clipped
    (g,) = torch.autograd.grad(new.box.sum(), eps, allow_unused=True)
    if clipped:
        assert g is None or float(g) == 0.0
    else:
        assert g is not None and float(g) != 0.0
