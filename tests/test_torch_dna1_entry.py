"""PyTorch port (mythos_tpu_torch): the reference's 8-bp oxDNA1 step
(``entry.entry``, AoS ``integrators.nvt_langevin`` on the dense masks)
against ``__graft_entry__.entry()``, and ``integrators.nve`` against the
reference's, in float64.

The entry step replays the reference's own normals (its key split, as
``integrators.nvt_langevin`` draws them). Tolerance rtol 1e-6 (XLA-CPU
transcendentals are float32-accurate even under x64).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mythos_tpu_torch import entry  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators.integrators import LangevinState  # noqa: E402


def _jittered(body, seed=0, scale=0.01):
    rng = np.random.default_rng(seed)
    c = np.asarray(body.center) + scale * rng.standard_normal(np.shape(body.center))
    q = np.asarray(body.orientation) + scale * rng.standard_normal(np.shape(body.orientation))
    return c, q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def entry_steps():
    """The reference's entry() step from its state0 (jitted), and the port's
    entry() step from the same state with the reference's normals."""
    fn, (state0,) = graft.entry()
    ref1 = jax.jit(fn)(state0)
    _, k1, k2 = jax.random.split(state0.key, 3)
    n = state0.momentum.shape[0]
    xi = np.stack([np.asarray(jax.random.normal(k1, (n, 3), state0.momentum.dtype)),
                   np.asarray(jax.random.normal(k2, (n, 3), state0.momentum.dtype))])
    step, (s0,) = entry.entry(device="cpu", dtype=torch.float64)

    def t(x):
        return torch.as_tensor(np.array(x))

    start = LangevinState(
        position=RigidBody(t(state0.position.center), t(state0.position.orientation)),
        momentum=t(state0.momentum), angmom=t(state0.angmom), force=t(state0.force), torque=t(state0.torque),
        mass=RigidBody(t(state0.mass.center), t(state0.mass.orientation)),
    )
    return state0, ref1, s0, step(start, xi=torch.as_tensor(xi))


def test_entry_state0_forces_match_jax(entry_steps):
    """entry()'s state0 (the 8-bp duplex on the dense masks) sits where the
    reference's does and carries its force and torque, rtol 1e-6 (atol
    1e-6 max|ref|)."""
    state0, _, s0, _ = entry_steps
    np.testing.assert_array_equal(s0.position.center.numpy(), np.asarray(state0.position.center))
    for field in ("force", "torque"):
        ref = np.asarray(getattr(state0, field))
        np.testing.assert_allclose(getattr(s0, field).numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=field)


def test_entry_step_matches_jax(entry_steps):
    """One BAOAB step of the port's entry() from the reference's state0 with
    its normals equals the reference's step in every field (positions,
    quaternions, momenta, angular momenta, force, torque), rtol 1e-6 (atol
    1e-6 max|ref|)."""
    _, ref1, _, got1 = entry_steps
    pairs = [(ref1.position.center, got1.position.center), (ref1.position.orientation, got1.position.orientation)]
    pairs += [(getattr(ref1, f), getattr(got1, f)) for f in ("momentum", "angmom", "force", "torque")]
    for ref, got in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_nve_matches_jax():
    """integrators.nve (velocity Verlet, the gamma -> 0 limit) from a
    0.01-jittered 8-bp duplex at rest, 5 steps on the dense oxDNA1 energy,
    against the reference's nve, rtol 1e-6 (atol 1e-9)."""
    from mythos_tpu import spaces as jspaces
    from mythos_tpu.rigid_body import RigidBody as JaxRigidBody
    from mythos_tpu.simulators import integrators as jint

    from mythos_tpu_torch import spaces
    from mythos_tpu_torch.simulators import integrators

    top_j, body_j = graft._tiny_duplex(8)
    c, q = _jittered(body_j, seed=4)
    energy_j, _ = graft._build_sim(top_j, 0.0, mode="dense", model="dna1")
    init_j, step_j = jint.nve(energy_j, jspaces.free()[1], dt=5e-3)
    mass_j = JaxRigidBody(center=jax.numpy.array([1.0]), orientation=jax.numpy.array([[1.0, 1.0, 1.0]]))

    def run_j(body):
        return jax.lax.fori_loop(0, 5, lambda _, s: step_j(s), init_j(jax.random.PRNGKey(0), body, mass_j))

    ref = jax.jit(run_j)(JaxRigidBody(center=jax.numpy.asarray(c), orientation=jax.numpy.asarray(q)))
    top_t, _ = synthetic_duplex(8, device="cpu")
    energy_t, _ = entry.build_sim(top_t, 0.0, mode="dense", model="dna1", device="cpu", dtype=torch.float64)
    init_t, step_t = integrators.nve(energy_t, spaces.free()[1], 5e-3)
    state = init_t(None, RigidBody(torch.as_tensor(c), torch.as_tensor(q)),
                   RigidBody(torch.tensor([1.0], dtype=torch.float64), torch.tensor([[1.0, 1.0, 1.0]],
                                                                                    dtype=torch.float64)))
    for _ in range(5):
        state = step_t(state)
    for got, want in ((state.position.center, ref.position.center), (state.position.orientation,
                                                                     ref.position.orientation),
                      (state.momentum, ref.momentum), (state.angmom, ref.angmom)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
