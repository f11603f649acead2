"""PyTorch port (mythos_tpu_torch): direct differentiation through the
stencil run, against ``jax.grad`` through the JAX TpuSimulator.

``loss(sim.run(p, body, n, gen)).backward()`` through ``CudaSimulator.run``
gives d loss / d every tensor of ``opt_params``: the chunk path through
``ops.stencil.MultistepChunk`` (K1 forward), the per-step branch through
``FieldGrads`` (K2 forward) and the bonded gradient on the graph, both
backward through the plain versions (on the CPU the forward is the plain
version too). JAX runs its XLA per-step stencil path (USE_KERNEL /
USE_MULTISTEP off, no Pallas) in float32, ``save_every`` =
``neighbor_update_every`` = 5: one run-level gradient (the second-order
band compiles for ~4 minutes), compiled once and shared. The loss reads the states at multiples of 5 steps,
so the port's chunk path and its per-step branch (states ``[4::5]``) are
both held against it. kT = 0 keeps random numbers out of the comparison;
the start is the 20-bp duplex jittered by 0.01, off the arccos clamp.

Tolerance: every parameter of the float32 gradient within rtol 1e-3 /
atol 2e-4 max|grad| of ``jax.grad``. On this input the angle offsets of
stacking's theta4 and hydrogen bonding's theta2 (cosines near 1, where
arccos amplifies a float32 rounding) carry float32 error in either
package: beyond the rtol part the port's float32 gradient is 1.007e-4
max|grad| from jax.grad at theta0_stack_4 and 8.3e-5 at theta0_hb_2, and
1.6e-4 from its own float64 gradient at theta0_hb_2, while JAX's float32
gradient is up to 7.4e-5 max|grad| from the port's float64 one. Every
other parameter is within 6e-6 max|grad|. The fitted strengths
eps_stack_base and eps_stack_kt_coeff (5e-4 and 5e-5 of max|grad|, so the
atol alone would not see a wrong stacking-weight gradient) and eps_hb are
also held at rtol 1e-3 alone: they are within 2e-5 of jax.grad relative
to their own size. The same gradient in float64, straight through the
plain versions (no Function, no simulator), is held to jax.grad within
rtol 1e-3 / atol 1e-4 max|grad| for every parameter.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _build_sim, _tiny_duplex  # noqa: E402
from mythos_tpu.ops import stencil as st  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.simulators.tpu import ERR_CHKPNT_SCN  # noqa: E402
from mythos_tpu_torch import entry  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.soa import Quat, quat_cotangent_to_torque_soa  # noqa: E402

N_BP = 20
#: oxRNA2's A-form band reaches 25 slots, which stencil_band_for_site_cutoffs takes
#: from 50 slots up
N_BP_RNA2 = 30
U = 5
N_STEPS = 10
KT = 296.15 * 0.1 / 300.0
#: the port's float64 gradient against jax.grad, per parameter: rtol,
#: atol x max|grad| (beyond the rtol part, 7.4e-5 of max|grad| at most)
RTOL, ATOL = 1e-3, 1e-4
#: the port's float32 gradient against jax.grad: atol x max|grad| (beyond
#: rtol 1e-3, 1.007e-4 of max|grad| at most, from float32 alone)
ATOL_F32 = 2e-4
PATHS = {"chunk": {"save_every": U}, "per-step": {"save_every": 1},
         "per-step checkpoint_every=1": {"save_every": 1, "checkpoint_every": 1}}


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _start(form: str = "B", n_bp: int = N_BP):
    """(JAX topology, (centers, unit quats) of the duplex jittered by 0.01,
    float32 numpy)."""
    topology, body = _tiny_duplex(n_bp, form=form)
    rng = np.random.default_rng(0)
    c = np.asarray(body.center, np.float64) + 0.01 * rng.standard_normal(np.shape(body.center))
    q = np.asarray(body.orientation, np.float64) + 0.01 * rng.standard_normal(np.shape(body.orientation))
    return topology, (c.astype(np.float32), (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32))


def _weights(n_nt: int = 2 * N_BP):
    """Fixed weights of the loss on the (N_STEPS // U) saved states."""
    rng = np.random.default_rng(1)
    return (rng.standard_normal((N_STEPS // U, n_nt, 3)).astype(np.float32),
            rng.standard_normal((N_STEPS // U, n_nt, 4)).astype(np.float32))


def _port(model: str = "dna2", kT: float = 0.0, form: str = "B", n_bp: int = N_BP):  # noqa: N803
    """(energy_fn, simulator, jittered body) of the port on the CPU."""
    _, (c, q) = _start(form, n_bp)
    top, _ = synthetic_duplex(n_bp, form=form, dtype=torch.float32, device="cpu")
    body = RigidBody(torch.from_numpy(c), torch.from_numpy(q))
    e, sim = entry.build_sim(top, kT, model=model, init_centers=body.center, init_orientation=body.orientation,
                             neighbor_update_every=U, device="cpu")
    return e, sim, body


def _port_grad(e, sim, body, n_steps=N_STEPS, seed=0):
    """(loss, {name: d loss / d name}, trajectory) of one run with every
    ``opt_params`` tensor a leaf; per-step runs read the states [U-1::U]."""
    wc, wq = (torch.from_numpy(w) for w in _weights(body.center.shape[0]))
    p = {k: v.detach().clone().requires_grad_(True) for k, v in e.opt_params().items()}
    traj = sim.run(p, body, n_steps, torch.Generator().manual_seed(seed)).observables[0]
    pick = slice(None) if sim.save_every > 1 else slice(U - 1, None, U)
    loss = (wc * traj.center[pick]).sum() + (wq * traj.orientation[pick]).sum()
    loss.backward()
    return loss.item(), {k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in p.items()}, traj


@pytest.fixture(scope="module")
def jax_grad(_f32_mode):
    """(loss, {name: gradient}) of jax.grad through TpuSimulator.run on its
    XLA per-step path, 10 steps, a state every 5."""
    topology, (c, q) = _start()
    body = JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))
    wc, wq = (jnp.asarray(w) for w in _weights())
    old = (st.USE_KERNEL, st.USE_MULTISTEP)
    st.USE_KERNEL, st.USE_MULTISTEP = False, False
    try:
        _, sim = _build_sim(topology, 0.0, mode="stencil", init_centers=body.center,
                            init_orientation=body.orientation, model="dna2", neighbor_update_every=U)
        sim = sim.replace(save_every=U)
        params = sim.energy_fn.opt_params()

        def loss(p):
            traj = sim.run(p, body, N_STEPS, jax.random.PRNGKey(3)).observables[0]
            return jnp.sum(wc * traj.center) + jnp.sum(wq * traj.orientation)

        value, grads = jax.jit(jax.value_and_grad(loss))(params)
    finally:
        st.USE_KERNEL, st.USE_MULTISTEP = old
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def f64_grad():
    """{name: gradient} of the chunk path's run and loss in float64, by
    autograd straight through the plain versions (no Function, no
    simulator): the initial force of field_grads_plain + bonded_grads_plain,
    then multistep_chunk_plain chunk by chunk, all with create_graph."""
    e, sim, body = _port()
    wc, wq = (torch.from_numpy(w).double() for w in _weights())
    p = {k: v.detach().double().requires_grad_(True) for k, v in e.opt_params().items()}
    ctx = ts.prepare_stencil_context(e.with_params(p), sim.band, dtype=torch.float64)
    ou = ts.ou_constants(sim.dt, 0.0, [sim.mass], [sim.inertia], [0.0], [0.0]).vector("cpu", torch.float64)
    rows = torch.cat([ctx.to_slots(body.center.T.double()), ctx.to_slots(body.orientation.T.double())])
    g = ts.field_grads_plain(ctx, rows, create_graph=True) + ts.bonded_grads_plain(ctx, rows, create_graph=True)
    torque = quat_cotangent_to_torque_soa(Quat(*rows[3:]), Quat(*g[3:]))
    state = torch.cat([rows, torch.zeros((6, ctx.n), dtype=torch.float64), -g[:3], torch.stack(list(torque))])
    saves = []
    for _ in range(N_STEPS // U):  # kT = 0: no friction and no noise
        state = ts.multistep_chunk_plain(ctx, ou, torch.zeros((U, 6, ctx.n)), state, create_graph=True)[:19]
        saves.append(state[:7])
    traj = ctx.from_slots(torch.stack(saves))
    loss = (wc * traj[:, 0:3].transpose(1, 2)).sum() + (wq * traj[:, 3:7].transpose(1, 2)).sum()
    loss.backward()
    return {k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in p.items()}


@pytest.fixture(scope="module")
def port_grads():
    """{path: (loss, grads, trajectory)} of the port's oxDNA2 runs."""
    e, sim, body = _port()
    return {name: _port_grad(e, sim.replace(**kw), body) for name, kw in PATHS.items()}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_gradient_matches_jax_grad(path, port_grads, jax_grad):
    """d loss / d opt_params through CudaSimulator.run == jax.grad through
    TpuSimulator.run, every parameter within rtol 1e-3 / atol 2e-4
    max|grad| (module docstring); the fitted strengths, the stacking
    weight's parameters (eps_stack_base, eps_stack_kt_coeff) and eps_hb,
    nonzero and within rtol 1e-3 alone."""
    ref_loss, ref = jax_grad
    loss, got, _ = port_grads[path]
    assert sorted(got) == sorted(ref)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    scale = max(float(np.abs(g).max()) for g in ref.values())
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=RTOL, atol=ATOL_F32 * scale, err_msg=k)
    for k in ("eps_stack_base", "eps_stack_kt_coeff", "eps_hb"):
        assert float(np.abs(ref[k]).max()) > 0, k
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=RTOL, atol=0, err_msg=k)
    assert [k for k in ref if np.any(ref[k] != 0)] == [k for k in ref if bool((got[k] != 0).any())]


def test_float64_gradient_matches_jax_grad(f64_grad, jax_grad):
    """The same gradient in float64, straight through the plain versions,
    == jax.grad (float32) within rtol 1e-3 / atol 1e-4 max|grad|, every
    parameter."""
    _, ref = jax_grad
    scale = max(float(np.abs(g).max()) for g in ref.values())
    for k in ref:
        np.testing.assert_allclose(f64_grad[k].numpy(), ref[k], rtol=RTOL, atol=ATOL * scale, err_msg=k)


def test_checkpoint_every_keeps_the_gradient(port_grads):
    """The per-step branch with checkpoint_every 1 (each rebuild interval
    recomputed in the backward) gives the gradient of the run without it."""
    _, plain, _ = port_grads["per-step"]
    _, ckpt, _ = port_grads["per-step checkpoint_every=1"]
    for k in plain:
        np.testing.assert_allclose(ckpt[k].numpy(), plain[k].numpy(), rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_grad_run_is_the_no_grad_run(path, monkeypatch):
    """At kT > 0 (noise on), a run that builds the graph gives the
    trajectory of the same run under no_grad bit for bit, calls K1's and
    K2's wrappers as often in its forward, and leaves the generator in the
    same state; the backward recomputes a checkpointed interval's forces."""
    e, sim, body = _port(kT=KT)
    sim = sim.replace(**PATHS[path])
    calls = {"K1": 0, "K2": 0}
    k1, k2 = ts.multistep_chunk, ts.field_grads

    def counted(key, fn):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(ts, "multistep_chunk", counted("K1", k1))
    monkeypatch.setattr(ts, "field_grads", counted("K2", k2))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        ref = sim.run(e.opt_params(), body, N_STEPS, gen).observables[0]
    ref_calls, ref_gen = dict(calls), gen.get_state()
    calls.update(K1=0, K2=0)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in e.opt_params().items()}
    gen = torch.Generator().manual_seed(4)
    got = sim.run(p, body, N_STEPS, gen).observables[0]
    assert got.center.requires_grad
    assert torch.equal(got.center.detach(), ref.center) and torch.equal(got.orientation.detach(), ref.orientation)
    assert calls == ref_calls == ({"K1": N_STEPS // U, "K2": 1} if path == "chunk" else {"K1": 0, "K2": N_STEPS + 1})
    assert torch.equal(gen.get_state(), ref_gen)
    (got.center * torch.linspace(-1.0, 1.0, got.center.numel()).reshape(got.center.shape)).sum().backward()
    recomputed = N_STEPS if "checkpoint" in path else 0
    assert calls == {"K1": ref_calls["K1"], "K2": ref_calls["K2"] + recomputed}
    assert all(bool(torch.isfinite(v.grad).all()) for v in p.values() if v.grad is not None)


def test_checkpoint_every_must_divide_the_intervals():
    """On the per-step branch checkpoint_every counts rebuild intervals (2
    here) and must divide them: the reference's ERR_CHKPNT_SCN."""
    e, sim, body = _port()
    with pytest.raises(ValueError) as err:
        sim.replace(save_every=1, checkpoint_every=3).run(e.opt_params(), body, N_STEPS, torch.Generator())
    assert str(err.value) == ERR_CHKPNT_SCN.format(3, N_STEPS // U)


def test_chunk_path_ignores_checkpoint_every():
    """The chunk path accepts any checkpoint_every and runs as without it
    (the reference's fused branch is a plain scan); build_sim passes it on."""
    e, sim, body = _port()
    top, _ = synthetic_duplex(N_BP, dtype=torch.float32, device="cpu")
    _, sim3 = entry.build_sim(top, 0.0, init_centers=body.center, init_orientation=body.orientation,
                              neighbor_update_every=U, checkpoint_every=3, device="cpu")
    assert sim3.checkpoint_every == 3 and sim.checkpoint_every == 0
    p = {k: v.detach().clone().requires_grad_(True) for k, v in e.opt_params().items()}
    a, b = (s.replace(save_every=U).run(p, body, N_STEPS, torch.Generator().manual_seed(5)).observables[0]
            for s in (sim, sim3))
    assert torch.equal(a.center, b.center) and torch.equal(a.orientation, b.orientation)


def test_block_tier_refuses_checkpoint_every():
    """The block tier takes checkpoint_every from build_sim (its direct
    differentiation: tests/test_torch_block_direct.py) and refuses one that
    does not divide its outer loop -- 2 saves of 5 steps here -- with the
    reference's ERR_CHKPNT_SCN."""
    top, body = synthetic_duplex(N_BP, dtype=torch.float32, device="cpu")
    e, sim = entry.build_sim(top, KT, mode="block", init_centers=body.center, neighbor_update_every=U,
                             checkpoint_every=3, device="cpu")
    assert sim.checkpoint_every == 3
    with pytest.raises(ValueError) as err:
        sim.run(e.opt_params(), body, N_STEPS, torch.Generator())
    assert str(err.value) == ERR_CHKPNT_SCN.format(3, N_STEPS // U)


def test_rna2_chunk_gradient_matches_per_step():
    """oxRNA2 (A-form, 30 bp, kT = 0), the port alone: the chunk path's gradient
    (K1's rna2 instance forward) equals the per-step branch's (K2's) within
    rtol 1e-3 / atol 1e-4 max|grad|; d / d eps_stack_base is nonzero."""
    e, sim, body = _port("rna2", form="A", n_bp=N_BP_RNA2)
    loss_c, chunk, _ = _port_grad(e, sim.replace(save_every=U), body)
    loss_s, step, _ = _port_grad(e, sim.replace(save_every=1), body)
    np.testing.assert_allclose(loss_c, loss_s, rtol=1e-5)
    scale = max(float(g.abs().max()) for g in step.values())
    for k in step:
        np.testing.assert_allclose(chunk[k].numpy(), step[k].numpy(), rtol=RTOL, atol=ATOL * scale, err_msg=k)
    assert bool(chunk["eps_stack_base"].abs().max() > 1e-3 * scale)
