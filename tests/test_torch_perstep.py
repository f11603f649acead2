"""PyTorch port (mythos_tpu_torch): the stencil's per-step branch and
every-step emission on both tiers, against the JAX TpuSimulator, and the
plain version of K2's gate.

With ``save_every = 1`` the reference steps one step at a time (its generic
branch, simulators/tpu.py:451-482): a band check or table rebuild every
``neighbor_update_every`` steps, then that many BAOAB steps, each state
emitted. JAX runs its XLA stencil (USE_KERNEL off, no Pallas) and its XLA
tile path in float32; the port's kernel wrappers take their plain versions
on CPU tensors. kT = 0 keeps random numbers out of the comparison (rtol
1e-4, atol 1e-5, as tests/test_torch_sim.py). The gate
(``ops.stencil.band_gates_plain``) is checked in float64: every term it
drops is exactly zero, value and gradient.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny CPU shapes: one thread a worker, no idle pool spinning beside the others

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.dna2 as jdna2  # noqa: E402
import mythos_tpu_torch.energy.dna1.terms as t1  # noqa: E402
from __graft_entry__ import _build_sim, _tiny_duplex  # noqa: E402
from mythos_tpu import spaces  # noqa: E402
from mythos_tpu.ops import stencil as st  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.simulators import StaticSimulatorParams, TpuSimulator  # noqa: E402
from mythos_tpu.simulators import neighbors as jnb  # noqa: E402
from mythos_tpu_torch import entry  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
from mythos_tpu_torch.soa import Quat, Vec3, vnorm  # noqa: E402

N_BP = 40
U = 5
N_STEPS = 20
KT = 296.15 * 0.1 / 300.0
FORMS = {"dna2": "B", "rna2": "A"}


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _port(model, kT, mode="stencil", dtype=torch.float32):  # noqa: N803
    top, body = synthetic_duplex(N_BP, form=FORMS[model], dtype=dtype, device="cpu")
    kw = dict(init_orientation=body.orientation) if mode == "stencil" else {}
    e, sim = entry.build_sim(top, kT, mode=mode, model=model, init_centers=body.center, neighbor_update_every=U,
                             device="cpu", **kw)
    return e, sim.replace(save_every=1), body


@pytest.fixture(scope="module", params=sorted(FORMS))
def stencil_runs(request, _f32_mode):
    """20 per-step stencil steps at kT = 0, rebuild every 5, every state
    emitted, both packages; the port's K2 calls counted."""
    model = request.param
    topology, body = _tiny_duplex(N_BP, form=FORMS[model])
    old = st.USE_KERNEL
    st.USE_KERNEL = False
    try:
        _, sim = _build_sim(topology, 0.0, mode="stencil", init_centers=body.center,
                            init_orientation=body.orientation, model=model, neighbor_update_every=U)
        sim = sim.replace(save_every=1)
        params = sim.energy_fn.opt_params()
        ref = jax.jit(lambda p: sim.run(p, body, N_STEPS, jax.random.PRNGKey(3)))(params).observables[0]
    finally:
        st.USE_KERNEL = old
    _, tsim, tbody = _port(model, 0.0)
    opt = params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    calls = []
    plain_k2, plain_k1 = ts.field_grads, ts.multistep_chunk

    def counted(ctx, dyn):
        calls.append(ctx.family)
        return plain_k2(ctx, dyn)

    def refused(*_):
        raise AssertionError("the per-step branch ran K1")

    ts.field_grads, ts.multistep_chunk = counted, refused
    try:
        got = tsim.run(opt, tbody, N_STEPS, torch.Generator().manual_seed(0)).observables[0]
    finally:
        ts.field_grads, ts.multistep_chunk = plain_k2, plain_k1
    return model, ref, got, calls


@pytest.mark.parametrize("field", ["center", "orientation"])
def test_stencil_per_step_matches_jax_tpu_simulator(field, stencil_runs):
    """Every one of the 20 emitted states of CudaSimulator.run (save_every
    1) on the CPU == TpuSimulator.run's per-step branch (rtol 1e-4, atol
    1e-5), oxDNA2 on the B-form and oxRNA2 on the A-form 40-bp duplex."""
    _, ref, got, _ = stencil_runs
    a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
    assert a.shape == b.shape == (N_STEPS, 2 * N_BP, 3 if field == "center" else 4)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_stencil_per_step_overflow_and_k2_calls(stencil_runs):
    """The overflow flags agree with the reference's, and the branch took
    K2 once for the initial force and once a step, never K1."""
    model, ref, got, calls = stencil_runs
    np.testing.assert_array_equal(got.metadata["neighbor_overflow"].numpy(),
                                  np.asarray(ref.metadata["neighbor_overflow"]))
    assert calls == [model] * (N_STEPS + 1)


def test_block_per_step_matches_jax_tpu_simulator():
    """A 40-bp block-tier run at kT = 0 emitting every state (20 steps,
    rebuild every 5): the port (symmetric tables, K3's plain version)
    against TpuSimulator on a single-level non-symmetric table (its XLA tile
    path), rtol 1e-4, atol 1e-5, set up as
    test_torch_tiles.py::test_block_run_matches_jax_tpu_simulator."""
    top_j, body_j = _tiny_duplex(N_BP)
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
        space=spaces.free(), neighbors=nbl, save_every=1, neighbor_update_every=U,
    )
    params = e_j.opt_params()
    body32 = JaxRigidBody(center=jnp.asarray(body_j.center, jnp.float32),
                          orientation=jnp.asarray(body_j.orientation, jnp.float32))
    ref = jax.jit(lambda p: sim_j.run(p, body32, N_STEPS, jax.random.PRNGKey(0)))(params).observables[0]
    e_t, sim_t, body_t = _port("dna2", 0.0, mode="block")
    opt = params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    got = sim_t.run(opt, body_t, N_STEPS, torch.Generator().manual_seed(0)).observables[0]
    assert got.center.shape == (N_STEPS, 2 * N_BP, 3)
    np.testing.assert_allclose(got.center.numpy(), np.asarray(ref.center), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.orientation.numpy(), np.asarray(ref.orientation), rtol=1e-4, atol=1e-5)
    assert not bool(got.metadata["neighbor_overflow"].any())


@pytest.mark.parametrize("mode", ["stencil", "block"])
def test_per_step_n_steps_not_multiple_raises(mode):
    """Emitting every state, n_steps must be a multiple of
    neighbor_update_every (ERR_UPDATE_EVERY, as the reference's :468-469)."""
    e, sim, body = _port("dna2", KT, mode=mode)
    with pytest.raises(ValueError, match="n_steps when emitting every step"):
        sim.run(e.opt_params(), body, 2 * U + 2, torch.Generator())


@pytest.mark.parametrize("model", sorted(FORMS))
def test_per_step_thermostat_run_is_finite(model):
    """kT > 0: 20 per-step states, finite, unit quaternions, no overflow."""
    e, sim, body = _port(model, KT)
    traj = sim.run(e.opt_params(), body, N_STEPS, torch.Generator().manual_seed(1)).observables[0]
    assert traj.center.shape == (N_STEPS, 2 * N_BP, 3)
    assert torch.isfinite(traj.center).all() and torch.isfinite(traj.orientation).all()
    np.testing.assert_allclose(traj.orientation.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert not bool(traj.metadata["neighbor_overflow"].any())


@pytest.mark.parametrize("scale", [0.0, 0.01, 0.05], ids=["ideal", "jittered", "jittered 0.05"])
@pytest.mark.parametrize("model", sorted(FORMS))
def test_band_gates_drop_only_zeros(model, scale):
    """K2's gate (band_gates_plain): in float64, on the ideal duplex and
    jittered ones, every band pair's term value is exactly 0 where the
    term's gate is clear -- each of the four excluded-volume distances' own
    value past its own cutoff too -- and so is the gradient of the dropped
    values; the gate is clear past each term's offset reach; its tally
    (band_gate_counts) counts the band once."""
    e, sim, body = _port(model, KT, dtype=torch.float64)
    ctx = ts.prepare_stencil_context(e, sim.band, dtype=torch.float64)
    rng = np.random.default_rng(7)
    c = body.center + scale * torch.as_tensor(rng.standard_normal(tuple(body.center.shape)))
    q = body.orientation + scale * torch.as_tensor(rng.standard_normal(tuple(body.orientation.shape)))
    q = q / q.norm(dim=-1, keepdim=True)
    dyn = torch.cat([ctx.to_slots(c.T), ctx.to_slots(q.T)]).requires_grad_(True)
    gates = ts.band_gates_plain(ctx, dyn.detach())
    assert tuple(gates) == ts.UNBONDED_ORDER
    lo, hi, terms = ts.band_pair_terms(ctx, Vec3(*dyn[:3]), Quat(*dyn[3:]), ctx.params)
    dropped = 0.0
    for nm, values, w in zip(ts.UNBONDED_ORDER, terms, (*ctx.w_terms, ctx.w_wide), strict=True):
        k = values.shape[0]
        kept = gates[nm][hi[:k] - lo[:k] - 1, lo[:k]]
        assert bool((values[~kept] == 0).all()), nm
        assert not bool(gates[nm][w:].any()) and int(gates[nm].sum()) == int(kept.sum()), nm
        dropped = dropped + torch.where(kept, torch.zeros_like(values), values).sum()
    (g,) = torch.autograd.grad(dropped, dyn)
    assert bool((g == 0).all())
    # the excluded volume gates each distance apart (the kernel too)
    P = ts.unpack_params(ctx.params)
    s = ts._sites(P, Vec3(*dyn.detach()[:3]), Quat(*dyn.detach()[3:]), ctx.family)
    k = terms[0].shape[0]

    def at(v, idx):
        return Vec3(*(x[idx[:k]] for x in v))

    for (a, b), fam, cut in zip(((s.base, s.base), (s.back, s.base), (s.base, s.back), (s.back, s.back)),
                                ("base", "back_base", "base_back", "backbone"), ts._EXC_CUTOFFS, strict=True):
        r = vnorm(at(b, hi) - at(a, lo))
        v = t1.exc_family(P["EXC"], fam, r)
        assert bool((v[r >= getattr(P["EXC"], cut)] == 0).all()), fam
    counts = ts.band_gate_counts(ctx, dyn.detach())
    assert counts["short"] + counts["debye"] + counts["skipped"] == lo.shape[0]
    assert counts["short"] >= max(counts[nm] for nm in ts.UNBONDED_ORDER[:4])
    print(f"{model} scale {scale}: {counts} of {lo.shape[0]} band pairs")
