"""PyTorch port (mythos_tpu_torch): the fitting layer -- DiffTReObjective,
SimpleOptimizer with torch Adam, BoundSimulator -- and the DiffTRe
propeller-twist example as a whole, against the JAX package (the loggers
and the SimulatorTrajectory helpers: tests/test_torch_native_io.py).

The JAX side runs its own objective and optimizer loop in float64 (the
pair-list ``map``: no kernel). Tolerances per test. The reference
objective traces its map anew at each call (8-20 s on a CPU), so the checks
are grouped into few calls.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.dna1 as jdna1  # noqa: E402
import mythos_tpu_torch.energy.dna1 as tdna1  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.losses import ObservableLossFn as JaxObservableLossFn  # noqa: E402
from mythos_tpu.losses import SquaredError as JaxSquaredError  # noqa: E402
from mythos_tpu.observables import PropellerTwist as JaxPropellerTwist  # noqa: E402
from mythos_tpu.optimization import DiffTReObjective as JaxDiffTReObjective  # noqa: E402
from mythos_tpu.simulators.io import SimulatorTrajectory as JaxTrajectory  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.losses import ObservableLossFn, SquaredError  # noqa: E402
from mythos_tpu_torch.observables import PropellerTwist  # noqa: E402
from mythos_tpu_torch.optimization import DiffTReObjective  # noqa: E402
from mythos_tpu_torch.optimization.objective import ERR_NEIGHBOR_OVERFLOW  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators.io import SimulatorTrajectory  # noqa: E402

N_BP = 8
N = 2 * N_BP
KT = 296.15 * 0.1 / 300.0
TARGET = 21.7
OBS = "trajectory.BoundSimulator.fit"


def _states(n_states: int, seed: int, scale: float = 0.02):
    _, body = jax_duplex(N_BP)
    rng = np.random.default_rng(seed)
    c = np.asarray(body.center)[None] + scale * rng.standard_normal((n_states, N, 3))
    q = np.asarray(body.orientation)[None] + scale * rng.standard_normal((n_states, N, 4))
    return c, q / np.linalg.norm(q, axis=-1, keepdims=True)


def _bps():
    return np.array([[i, N - 1 - i] for i in range(N_BP)], np.int32)


def _jax_objective(top_j, n_eq: int, **kw):
    obs = JaxObservableLossFn(
        observable=JaxPropellerTwist(rigid_body_transform_fn=jdna1.default_transform_fn(),
                                     h_bonded_base_pairs=jnp.asarray(_bps())),
        loss_fn=JaxSquaredError(), return_observable=True)

    def grad_or_loss_fn(ref_states, weights, energy_fn, opt_params, observables):
        loss, measured = obs(ref_states, TARGET, weights)
        return loss, (("propeller_twist", measured), None)

    return JaxDiffTReObjective(name="fit", required_observables=(OBS,), grad_or_loss_fn=grad_or_loss_fn,
                               energy_fn=jdna1.create_default_energy_fn(top_j), n_equilibration_steps=n_eq, **kw)


def _port_objective(top, n_eq: int, **kw):
    obs = ObservableLossFn(
        observable=PropellerTwist(rigid_body_transform_fn=tdna1.default_transform_soa_fn(),
                                  h_bonded_base_pairs=torch.as_tensor(_bps())),
        loss_fn=SquaredError(), return_observable=True)

    def grad_or_loss_fn(ref_states, weights, energy_fn, opt_params, observables):
        loss, measured = obs(ref_states, TARGET, weights)
        return loss, (("propeller_twist", measured), None)

    return DiffTReObjective(name="fit", required_observables=(OBS,), grad_or_loss_fn=grad_or_loss_fn,
                            energy_fn=tdna1.create_default_energy_fn(top, dtype=torch.float64, device="cpu"),
                            n_equilibration_steps=n_eq, **kw)


def _to_port(params_j: dict) -> dict:
    return params_from_numpy({k: np.asarray(v) for k, v in params_j.items()}, dtype=torch.float64)


def _assert_output(got, want, loss_rtol: float, grad_rtol: float):
    """A ready port ObjectiveOutput against the reference's: loss, n_eff,
    observable, and every gradient (atol grad_rtol x the largest)."""
    assert got.is_ready and want.is_ready
    for k in ("loss", "propeller_twist", "neff"):
        np.testing.assert_allclose(float(got.observables[k]), float(want.observables[k]), rtol=loss_rtol, err_msg=k)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.grads.values())
    assert set(got.grads) == set(want.grads)
    for k, v in want.grads.items():
        np.testing.assert_allclose(got.grads[k].numpy(), np.asarray(v), rtol=grad_rtol, atol=grad_rtol * scale,
                                   err_msg=k)
    assert got.state["opt_steps"] == want.state["opt_steps"]


def test_difftre_objective_matches_jax():
    """DiffTReObjective.calculate on 8 jittered 8-bp states (2 sliced off
    as equilibration), float64, against the reference's with the reference
    parameters 0.1 % away from the current ones (loss and n_eff rtol 1e-6:
    the weights read energy differences, which XLA-CPU's float32-accurate
    transcendentals shift by ~1e-7; gradients rtol 1e-5); with them the
    current ones n_eff is 1 to 1e-12 and they are kept as the reference
    (that branch against the reference's: the example's first step,
    below); the call below its n_eff floor asks for fresh trajectories
    with the reference's n_eff and opt_steps reset; past
    max_valid_opt_steps and with an observable missing it is not ready,
    as the reference's; an overflowed trajectory, one without temperature
    and one sliced to nothing raise as the reference's. One reference call
    of the map: each costs 8-20 s on a CPU."""
    c, q = _states(8, seed=0)
    top_j, _ = jax_duplex(N_BP)
    traj_j = JaxTrajectory(center=jnp.asarray(c), orientation=jnp.asarray(q), temperature=jnp.full(8, KT))
    obj_j = _jax_objective(top_j, 2)
    p_j = obj_j.energy_fn.opt_params()
    p2_j = {k: v * 1.001 for k, v in p_j.items()}
    want1 = obj_j.calculate({OBS: traj_j}, opt_params=p2_j, opt_steps=3, reference_opt_params=p_j)

    top, _ = synthetic_duplex(N_BP, device="cpu")
    traj = SimulatorTrajectory(center=torch.as_tensor(c), orientation=torch.as_tensor(q),
                               temperature=torch.full((8,), KT, dtype=torch.float64))
    obj = _port_objective(top, 2)
    p, p2 = _to_port(p_j), _to_port(p2_j)
    got0 = obj.calculate({OBS: traj}, opt_params=p)
    assert got0.is_ready and got0.state == {"opt_steps": 1, "reference_opt_params": p}
    assert abs(float(got0.observables["neff"]) - 1.0) < 1e-12
    got1 = obj.calculate({OBS: traj}, opt_params=p2, opt_steps=3, reference_opt_params=p)
    _assert_output(got1, want1, 1e-6, 1e-5)
    assert got1.state["reference_opt_params"] is p and float(want1.observables["neff"]) < 1.0

    # below the n_eff floor (the reference's branch: the same n_eff as above)
    strict = _port_objective(top, 2, min_n_eff_factor=float(want1.observables["neff"]) + 1e-6)
    low = strict.calculate({OBS: traj}, opt_params=p2, opt_steps=3, reference_opt_params=p)
    assert (low.is_ready, low.needs_update, low.state) == (False, (OBS,), {"opt_steps": 0})
    np.testing.assert_allclose(low.observables["neff"], float(want1.observables["neff"]), rtol=1e-6)
    for o, t, kw in ((obj_j, traj_j, {"opt_params": p_j}), (obj, traj, {"opt_params": p})):
        capped = type(o)(**{**{f: getattr(o, f) for f in ("name", "required_observables", "grad_or_loss_fn",
                                                           "energy_fn", "n_equilibration_steps")},
                            "max_valid_opt_steps": 2})
        out = capped.calculate({OBS: t}, opt_steps=2, **kw)
        assert (out.is_ready, tuple(out.needs_update), out.state) == (False, (OBS,), {"opt_steps": 0})
        out = o.calculate({}, **kw)
        assert (out.is_ready, tuple(out.needs_update)) == (False, (OBS,))
    # the refusals, each raised by both
    cases = {
        "overflowed neighbor table": (traj_j.with_state_metadata(neighbor_overflow=True),
                                      traj.with_state_metadata(neighbor_overflow=True), RuntimeError),
        "temperature": (traj_j.replace(temperature=None), traj.replace(temperature=None), ValueError),
        "no states": (traj_j.slice(slice(0, 2)), traj.slice(slice(0, 2)), ValueError),
    }
    for match, (t_j, t, err) in cases.items():
        with pytest.raises(err, match=match):
            obj_j.calculate({OBS: t_j}, opt_params=p_j)
        with pytest.raises(err, match=match):
            obj.calculate({OBS: t}, opt_params=p)
    assert "capacity" in ERR_NEIGHBOR_OVERFLOW


class _FixedStates:
    """A stub simulator: every run returns the same trajectory."""

    name = "sim"

    def __init__(self, traj):
        self.traj, self.runs = traj, 0

    def exposes(self):
        return [OBS]

    def run(self, opt_params, **state):
        from mythos_tpu_torch.simulators.base import SimulatorOutput

        self.runs += 1
        return SimulatorOutput(observables=[self.traj], state={"seq": state.get("seq", 0) + 1})


def test_simple_optimizer_adam_matches_optax():
    """3 SimpleOptimizer steps (lr 1e-2) of the port -- its DiffTReObjective
    on a stub simulator that returns 6 fixed states, torch Adam -- against
    the reference's SimpleOptimizer with optax.adam fed the same gradients
    step by step (a replaying objective; the objective itself is held to
    the reference's above): the parameters after every step agree (f64,
    rtol 1e-6, atol 1e-12), every step updates the leaves the objective
    differentiated with that step's gradient (no gradient carried over),
    and where the objective asks for fresh states the stub runs again. The
    optimizer's state is a value, as optax's is: two steps from the first
    output's state each repeat the second step exactly."""
    import functools

    import optax

    from mythos_tpu.optimization import SimpleOptimizer as JaxSimpleOptimizer
    from mythos_tpu.optimization.objective import ObjectiveOutput as JaxObjectiveOutput
    from mythos_tpu.simulators.base import SimulatorOutput as JaxSimulatorOutput
    from mythos_tpu_torch.optimization import SimpleOptimizer

    c, q = _states(6, seed=1)
    top, _ = synthetic_duplex(N_BP, device="cpu")
    traj = SimulatorTrajectory(center=torch.as_tensor(c), orientation=torch.as_tensor(q),
                               temperature=torch.full((6,), KT, dtype=torch.float64))
    stub = _FixedStates(traj)
    opt = SimpleOptimizer(objective=_port_objective(top, 0), simulator=stub,
                          optimizer=functools.partial(torch.optim.Adam, lr=1e-2))
    params0 = tdna1.create_default_energy_fn(top, dtype=torch.float64, device="cpu").opt_params()
    outs = []
    opt.run(params0, 3, callback=lambda optimizer_output, step: (outs.append(optimizer_output), (None, True))[1])
    assert set(outs[-1].state.optimizer_state) == {"state", "param_groups"} and stub.runs >= 1
    for again in (opt.step(outs[0].opt_params, outs[0].state), opt.step(outs[0].opt_params, outs[0].state)):
        for name, v in outs[1].opt_params.items():
            assert torch.equal(again.opt_params[name], v), name

    class Replay:
        name = "fit"

        def __init__(self):
            self.step = 0

        def calculate(self, observables, opt_params, **_):
            grads = {k: jnp.asarray(v.numpy()) for k, v in outs[self.step].grads.items()}
            self.step += 1
            return JaxObjectiveOutput(is_ready=True, grads=grads, observables={}, state={})

    class JaxStub:
        name = "sim"

        def exposes(self):
            return [OBS]

        def run(self, opt_params, **_):
            return JaxSimulatorOutput(observables=[None], state={})

    jopt = JaxSimpleOptimizer(objective=Replay(), simulator=JaxStub(), optimizer=optax.adam(1e-2))
    p_j = {k: jnp.asarray(v.numpy()) for k, v in params0.items()}
    state = None
    for k in range(3):
        out_j = jopt.step(p_j, state)
        p_j, state = out_j.opt_params, out_j.state
        for name, v in outs[k].opt_params.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(p_j[name]), rtol=1e-6, atol=1e-12,
                                       err_msg=f"step {k} {name}")
    moved = [k for k in params0 if not torch.equal(params0[k], outs[-1].opt_params[k])]
    assert "eps_stack_base" in moved


def test_example_fit_matches_jax_objective(tmp_path, capsys):
    """The port's examples/difftre_propeller_fit.py ``main()`` at 8 bp on the
    CPU in float64, from oxDNA files of the new format (each strand 5'->3',
    flipped by the example's reader) -- BoundSimulator over PairSimulator
    (200 MD steps, a state every 10, 5 equilibration states),
    DiffTReObjective, SimpleOptimizer with torch Adam, ConsoleLogger -- for
    2 steps: each step's loss and gradients equal the reference's
    DiffTReObjective fed the port's trajectory and the same parameters
    (loss rtol 1e-10 where the reference parameters are the current ones,
    the first step on fresh states, whose weights are uniform, else rtol
    1e-6 as above; gradients rtol 1e-5); each run draws from the generator
    of its invocation count, which the optimizer threads; the console lines
    are the loop's metrics."""
    from mythos_tpu.io import topology as jtop
    from mythos_tpu_torch.examples import difftre_propeller_fit as fit
    from mythos_tpu_torch.io.topology import to_oxdna_files
    from mythos_tpu_torch.simulators.base import BoundSimulator, generator_seed

    top_path, conf_path = to_oxdna_files(tmp_path, *synthetic_duplex(N_BP, dtype=torch.float64, device="cpu"),
                                         new_format=True)
    outs = []
    argv = [str(top_path), str(conf_path), "--device", "cpu", "--dtype", "float64", "--sim-steps", "200",
            "--save-every", "10", "--n-eq-states", "5", "--opt-steps", "2"]
    final = fit.main(argv, callback=lambda optimizer_output, step: (outs.append(optimizer_output), (None, True))[1])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == f"Step: 0, propeller.loss: {float(outs[0].observables['propeller']['loss'])}"
    assert printed[-1] == f"Final eps_stack_base: {float(final.opt_params['eps_stack_base'])}"
    assert len(printed) == 7  # loss, neff, propeller twist a step
    sim_name = "trajectory.BoundSimulator.propeller_sim"
    assert final.state.component_state["propeller_sim"]["seq"] >= 1

    top_j = jtop.from_oxdna_file(top_path)
    obj_j = _jax_objective(top_j, 5)
    obj_j = type(obj_j)(**{**{f: getattr(obj_j, f) for f in ("grad_or_loss_fn", "energy_fn", "n_equilibration_steps")},
                          "name": "propeller", "required_observables": (sim_name,)})
    args = fit.parse_args(argv)
    params = fit.build_fit(args)[1]
    for k, out in enumerate(outs):
        traj = out.state.observables[sim_name]
        assert traj.center.shape == (20, N, 3) and traj.center.dtype == torch.float64
        state = out.state.component_state["propeller"]
        ref = state["reference_opt_params"]
        traj_j = JaxTrajectory(center=jnp.asarray(traj.center.numpy()), orientation=jnp.asarray(traj.orientation.numpy()),
                               temperature=jnp.asarray(traj.temperature.numpy()))
        want = obj_j.calculate({sim_name: traj_j}, opt_params={kk: jnp.asarray(v.numpy()) for kk, v in params.items()},
                               opt_steps=state["opt_steps"] - 1,
                               reference_opt_params=None if ref is params else
                               {kk: jnp.asarray(v.numpy()) for kk, v in ref.items()})
        got = type("Out", (), {"is_ready": True, "grads": out.grads, "state": state,
                               "observables": out.observables["propeller"]})
        _assert_output(got, want, 1e-10 if ref is params else 1e-6, 1e-5)
        params = out.opt_params

    # the generator rule: invocation seq's draws, seq threaded
    bound = BoundSimulator(name="b", simulator=fit.build_simulator(top_j, save_every=5, device="cpu",
                                                                   dtype=torch.float64),
                           run_args=(RigidBody(traj.center[0], traj.orientation[0]), 10), seed=3)
    assert generator_seed(3, 1) == (3 << 32) + 1
    b0, b0_again, b1 = bound.run(None, seq=0), bound.run(None, seq=0), bound.run(None, seq=1)
    assert b0.state["seq"] == 1 and b1.state["seq"] == 2
    assert torch.equal(b0.observables[0].center, b0_again.observables[0].center)
    assert not torch.equal(b0.observables[0].center, b1.observables[0].center)

