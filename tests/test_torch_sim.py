"""PyTorch port (mythos_tpu_torch): the whole main-path slice on the CPU
against the JAX TpuSimulator.

JAX runs its XLA per-step stencil path (USE_KERNEL / USE_MULTISTEP off, no
Pallas) in float32; the port runs CudaSimulator, whose kernel wrappers take
their plain twins on CPU tensors. kT = 0 keeps random numbers out of the
comparison (tolerances as tests/test_multistep.py:150-157).
"""

import dataclasses as dc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _build_sim, _tiny_duplex  # noqa: E402
from mythos_tpu import soa as jsoa  # noqa: E402
from mythos_tpu import spaces  # noqa: E402
from mythos_tpu.ops import stencil as st  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.simulators import integrators as jint  # noqa: E402
from mythos_tpu_torch import entry  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
from mythos_tpu_torch.simulators.integrators import state_from_numpy  # noqa: E402

N_BP = 40
U = 10
KT = 296.15 * 0.1 / 300.0


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _port(kT, u=U):  # noqa: N803
    top, body = synthetic_duplex(N_BP, dtype=torch.float32, device="cpu")
    e, sim = entry.build_sim(top, kT, init_centers=body.center, init_orientation=body.orientation,
                             neighbor_update_every=u, device="cpu")
    return e, sim.replace(save_every=u), body


@pytest.fixture(scope="module")
def runs(_f32_mode):
    """(g) 4 chunks of 10 steps, thermostat off, both packages."""
    topology, body = _tiny_duplex(N_BP)
    old = (st.USE_KERNEL, st.USE_MULTISTEP)
    st.USE_KERNEL, st.USE_MULTISTEP = False, False
    try:
        _, sim = _build_sim(
            topology, 0.0, mode="stencil", init_centers=body.center, init_orientation=body.orientation,
            model="dna2", neighbor_update_every=U,
        )
        sim = sim.replace(save_every=U)
        params = sim.energy_fn.opt_params()
        out = jax.jit(lambda p: sim.run(p, body, 4 * U, jax.random.PRNGKey(3)))(params)
    finally:
        st.USE_KERNEL, st.USE_MULTISTEP = old
    ref = out.observables[0]
    _, tsim, tbody = _port(0.0)
    opt = params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    got = tsim.run(opt, tbody, 4 * U, torch.Generator().manual_seed(0)).observables[0]
    return ref, got


@pytest.mark.parametrize("field", ["center", "orientation"])
def test_slice_matches_jax_tpu_simulator(field, runs):
    """(g) CudaSimulator.run on CPU == TpuSimulator.run (rtol 1e-4, atol 1e-5)."""
    ref, got = runs
    a = getattr(got, field).numpy()
    b = np.asarray(getattr(ref, field))
    assert a.shape == b.shape == ((4, 2 * N_BP, 3) if field == "center" else (4, 2 * N_BP, 4))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_slice_overflow_flag_matches(runs):
    ref, got = runs
    np.testing.assert_array_equal(got.metadata["neighbor_overflow"].numpy(), np.asarray(ref.metadata["neighbor_overflow"]))


def test_initial_state_matches_jax_init(_f32_mode):
    """The port's initial force/torque (K2 wrapper + bonded gradient) ==
    nvt_langevin_soa's init through stencil_grads_ctx, carried across with
    state_from_numpy."""
    topology, body = _tiny_duplex(N_BP)
    _, sim = _build_sim(topology, KT, mode="stencil", init_centers=body.center,
                        init_orientation=body.orientation, model="dna2")
    e = sim.energy_fn.with_params(sim.energy_fn.opt_params())
    nb = sim.neighbors
    sctx = st.prepare_stencil_context(e, nb.w_short, nb.w_wide, perm=nb.perm, w_terms=nb.w_terms, kernel=False)
    gamma = JaxRigidBody(center=jnp.array([KT / 2.5]), orientation=jnp.array([KT / 7.5]))
    mass = JaxRigidBody(center=jnp.array([1.0]), orientation=jnp.array([[1.0, 1.0, 1.0]]))
    init_fn, _ = jint.nvt_langevin_soa(
        lambda b, **kw: st.stencil_energy_ctx(e, sctx, b), spaces.free_soa()[1], dt=5e-3, kT=KT, gamma=gamma,
        grad_fn=lambda b, **kw: st.stencil_grads_ctx(e, sctx, b),
    )
    ref = state_from_numpy(init_fn(jax.random.PRNGKey(0), jsoa.to_soa(body), mass))
    te, tsim, tbody = _port(KT)
    ctx = ts.prepare_stencil_context(te, tsim.band)
    state = tsim.initial_state(ctx, tbody, torch.Generator().manual_seed(0))
    got = ctx.from_slots(state)
    np.testing.assert_allclose(got[0:3].numpy(), np.stack([c.numpy() for c in ref.position.center]), rtol=0, atol=0)
    np.testing.assert_allclose(got[13:16].numpy(), np.stack([c.numpy() for c in ref.force]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[16:19].numpy(), np.stack([c.numpy() for c in ref.torque]), rtol=1e-4, atol=1e-4)
    assert ref.inv_mass == 1.0 and ref.inv_inertia == (1.0, 1.0, 1.0)


def test_thermostat_run_is_finite_and_unit_quat():
    """kT > 0: finite states, unit quaternions, no overflow (the reference's
    test_simulator_multistep_finite_with_noise on the port)."""
    e, sim, body = _port(KT)
    traj = sim.run(e.opt_params(), body, 2 * U, torch.Generator().manual_seed(1)).observables[0]
    assert torch.isfinite(traj.center).all() and torch.isfinite(traj.orientation).all()
    np.testing.assert_allclose(traj.orientation.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert not bool(traj.metadata["neighbor_overflow"].any())


@pytest.mark.parametrize(
    "change, match",
    [
        ({"save_every": 15}, "save_every"),
        ({"save_every": 5}, "neighbor_update_every"),
    ],
)
def test_ineligible_run_raises(change, match):
    e, sim, body = _port(KT)
    with pytest.raises(ValueError, match=match):
        sim.replace(**change).run(e.opt_params(), body, 30, torch.Generator())


def test_per_particle_mass_raises():
    with pytest.raises(ValueError, match="scalar mass"):
        ts.ou_constants(5e-3, KT, [1.0, 2.0], [[1.0, 1.0, 1.0]], [0.1], [0.1])


def test_bonds_off_offset_two_raise():
    """A topology whose bonds do not sit at slot offset 2 is refused
    (ERR_MS_BONDS), not run on a fallback."""
    e, sim, _ = _port(KT)
    band = sim.band.__class__(**{**sim.band.__dict__, "perm": None})
    with pytest.raises(ValueError, match="slot offset 2"):
        ts.prepare_stencil_context(e, band)


def test_build_sim_refuses_unported_modes():
    """Every (mode, model) of the reference's _build_sim builds -- the rna2
    block tier on the block sums, as the reference's fused tiles refuse
    it --, and a mode or model the reference does not know raises."""
    top, body = synthetic_duplex(8, device="cpu")
    _, sim = entry.build_sim(top, KT, mode="block", model="rna2", init_centers=body.center, device="cpu")
    assert not sim.uses_kernels()
    for mode, model in (("hierarchical", "dna2"), ("stencil", "na1")):
        with pytest.raises(NotImplementedError):
            entry.build_sim(top, KT, mode=mode, model=model, init_centers=body.center,
                            init_orientation=body.orientation, device="cpu")


def test_kernel_autograd_functions_backward_through_twins():
    """FieldGrads / MultistepChunk (the kernels' autograd wrappers) give the
    gradients of differentiating the twins directly, MultistepChunk's also
    with respect to the stacking weight ``wstack`` (nonzero: the way to
    ``eps_stack_base``) (CPU: forward is the twin too, so this checks the
    wrappers' plumbing and arity); a context tensor that needs a gradient
    and is not an input of the Function raises."""
    e, sim, body = _port(KT)
    ctx = ts.prepare_stencil_context(e, sim.band)
    state = sim.initial_state(ctx, body, torch.Generator().manual_seed(0))
    ou = ts.ou_constants(5e-3, KT, [1.0], [[1.0, 1.0, 1.0]], [KT / 2.5], [KT / 7.5]).vector("cpu")
    noise = torch.randn((1, 6, ctx.n), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    # a weighted sum of the last seven rows (K1's force, torque and checks;
    # all of K2's): one step's centres read no force of the step's end
    weights = torch.randn((7, ctx.n), generator=torch.Generator().manual_seed(2))

    def grads(fn, x0, with_w=False):
        x = x0.detach().clone().requires_grad_(True)
        p = ctx.params.detach().clone().requires_grad_(True)
        w = ctx.wstack.detach().clone().requires_grad_(with_w)
        return torch.autograd.grad((weights * fn(x, p, w)[-7:]).sum(), (x, p, w) if with_w else (x, p))

    via_fn = grads(lambda x, p, w: ts.MultistepChunk.apply(x, p, w, ou, noise, ctx), state, True)
    direct = grads(lambda x, p, w: ts.multistep_chunk_plain(dc.replace(ctx, wstack=w), ou, noise, x, p,
                                                            create_graph=True), state, True)
    for a, b in zip(via_fn, direct, strict=True):
        torch.testing.assert_close(a, b)
    assert bool(via_fn[2].abs().max() > 0)
    via_fn = grads(lambda x, p, w: ts.FieldGrads.apply(x, p, ctx), state[:7])
    direct = grads(lambda x, p, w: ts.field_grads_plain(ctx, x, p, create_graph=True), state[:7])
    for a, b in zip(via_fn, direct, strict=True):
        torch.testing.assert_close(a, b)
    hidden = dc.replace(ctx, qf=ctx.qf.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="ctx.qf needs a gradient"):
        ts.FieldGrads.apply(state[:7], ctx.params, hidden)
    with pytest.raises(ValueError, match="ctx.qf needs a gradient"):
        ts.MultistepChunk.apply(state, ctx.params, ctx.wstack, ou, noise, hidden)
