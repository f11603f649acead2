"""PyTorch port (mythos_tpu_torch): the DiffTRe slice -- the tile-kernel
``ComposedEnergyFunction.map``, the reweighting math, the propeller-twist
observable and one fitting step -- against the JAX package.

The JAX side is its pair-list reference (``e_pair.map``: every unbonded
pair, no kernel); the port re-evaluates states through its tile path
(K4 and, backward, K5 and the port of ``_params_grad_xla``; on the CPU
their plain versions). Tolerances per test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.dna2 as jdna2  # noqa: E402
import mythos_tpu_torch.energy.dna2 as tdna2  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.observables import PropellerTwist as JaxPropellerTwist  # noqa: E402
from mythos_tpu.optimization.objective import compute_weights_and_neff as jax_weights  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.entry import build_sim  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.observables import PropellerTwist  # noqa: E402
from mythos_tpu_torch.optimization.difftre import difftre_loss, difftre_step  # noqa: E402
from mythos_tpu_torch.optimization.objective import (  # noqa: E402
    ERR_NEIGHBOR_OVERFLOW,
    check_no_overflow,
    compute_weights_and_neff,
)
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators import neighbors as tnb  # noqa: E402
from mythos_tpu_torch.simulators.io import SimulatorTrajectory  # noqa: E402

N_BP = 40
KT = 296.15 * 0.1 / 300.0
TARGET = 21.7


def _states(n_states: int, seed: int = 0):
    """(S, N, 3) centers and (S, N, 4) unit quats near the ideal 40-bp
    duplex (numpy, float64)."""
    _, body = jax_duplex(N_BP)
    rng = np.random.default_rng(seed)
    c = np.asarray(body.center)[None] + 0.01 * rng.standard_normal((n_states, 2 * N_BP, 3))
    q = np.asarray(body.orientation)[None] + 0.01 * rng.standard_normal((n_states, 2 * N_BP, 4))
    return c, q / np.linalg.norm(q, axis=-1, keepdims=True)


def _map_nbl(top, centers, interleave: bool = True):
    return tnb.block_neighbor_list_for_topology(
        top, tdna2.default_neighbor_cutoff(), block_size=8, init_centers=centers,
        r_cutoff_inner=tdna2.short_range_neighbor_cutoff(),
        perm=tnb.strand_interleave_perm(top) if interleave else None,
    )


def _bps():
    n = 2 * N_BP
    return np.array([[i, n - 1 - i] for i in range(N_BP)], np.int32)


def test_map_matches_jax_pair_map():
    """map with map_neighbors (the tile path, float32) against the
    reference's pair-list map (float32), rtol 3e-5 as the reference holds
    its fused map (test_pallas_tiles.py); a state whose table overflows
    reads NaN."""
    c, q = _states(3)
    c, q = c.astype(np.float32), q.astype(np.float32)
    top_j, _ = jax_duplex(N_BP)
    e_pair = jdna2.create_default_energy_fn(top_j)
    params32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), e_pair.opt_params())
    ref = np.asarray(jax.jit(lambda p: e_pair.with_params(p).map(
        JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))))(params32))
    top, _ = synthetic_duplex(N_BP, device="cpu")
    e = tdna2.create_default_energy_fn(top, device="cpu")
    states = RigidBody(torch.as_tensor(c), torch.as_tensor(q))
    got = e.replace(map_neighbors=_map_nbl(top, states.center[0])).map(states)
    np.testing.assert_allclose(got.numpy(), ref, rtol=3e-5)
    small = tnb.block_neighbor_list_for_topology(top, tdna2.default_neighbor_cutoff(), block_size=8, capacity=2,
                                                 init_centers=states.center[0])
    assert torch.isnan(e.replace(map_neighbors=small).map(states)).all()


def test_pair_map_matches_jax():
    """map without map_neighbors: the pair-list path, state by state (f64)."""
    c, q = _states(2, seed=4)
    top_j, _ = jax_duplex(N_BP)
    ref = np.asarray(jdna2.create_default_energy_fn(top_j).map(
        JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))))
    top, _ = synthetic_duplex(N_BP, device="cpu")
    e = tdna2.create_default_energy_fn(top, dtype=torch.float64, device="cpu")
    got = e.map(RigidBody(torch.as_tensor(c), torch.as_tensor(q)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


def test_weights_and_neff_match_jax():
    rng = np.random.default_rng(1)
    new, ref = rng.normal(-130.0, 0.5, 12), rng.normal(-130.0, 0.5, 12)
    w_j, n_j = jax_weights(1.0 / KT, jnp.asarray(new), jnp.asarray(ref))
    w_t, n_t = compute_weights_and_neff(1.0 / KT, torch.as_tensor(new), torch.as_tensor(ref))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-10, atol=1e-300)
    np.testing.assert_allclose(float(n_t), float(n_j), rtol=1e-10)


def test_propeller_twist_matches_jax():
    c, q = _states(3, seed=2)
    ref = JaxPropellerTwist(rigid_body_transform_fn=jdna2.default_transform_fn(),
                            h_bonded_base_pairs=jnp.asarray(_bps()))(
        JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q)))
    got = PropellerTwist(rigid_body_transform_fn=tdna2.default_transform_soa_fn(),
                         h_bonded_base_pairs=torch.as_tensor(_bps()))(
        RigidBody(torch.as_tensor(c), torch.as_tensor(q)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)


def test_difftre_loss_and_grads_match_jax():
    """The DiffTRe loss and its parameter gradients on fixed 40-bp states:
    the port (tile map, float64 plain versions) against the same
    computation in JAX on e_pair.map (float64), rtol 1e-5 (the polynomial
    arccos of the tiles against arccos, in the gradients' near-cancelling
    weight differences), atol 1e-6 x the largest gradient. The table keeps
    the original order (no interleave): the triangular mask then orients
    every pair as the pair list does (i < j), which decides how a pair's
    gradient splits between role-swapped parameters such as theta0_cross_2
    and theta0_cross_3 (their sum does not depend on it)."""
    c, q = _states(4, seed=3)
    top_j, _ = jax_duplex(N_BP)
    e_pair = jdna2.create_default_energy_fn(top_j)
    obs_j = JaxPropellerTwist(rigid_body_transform_fn=jdna2.default_transform_fn(),
                              h_bonded_base_pairs=jnp.asarray(_bps()))
    states_j = JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))

    def loss_j(p):
        new_e = e_pair.with_params(p).map(states_j)
        w, _ = jax_weights(1.0 / KT, new_e, jax.lax.stop_gradient(new_e))
        return (TARGET - jnp.sum(w * obs_j(states_j))) ** 2

    params = e_pair.opt_params()
    l_j, g_j = jax.jit(jax.value_and_grad(loss_j))(params)
    top, _ = synthetic_duplex(N_BP, device="cpu")
    e = tdna2.create_default_energy_fn(top, dtype=torch.float64, device="cpu")
    opt = {k: v.requires_grad_(True) for k, v in
           params_from_numpy({k: np.asarray(v) for k, v in params.items()}, dtype=torch.float64).items()}
    states = RigidBody(torch.as_tensor(c), torch.as_tensor(q))
    obs = PropellerTwist(rigid_body_transform_fn=tdna2.default_transform_soa_fn(),
                         h_bonded_base_pairs=torch.as_tensor(_bps()))
    loss, n_eff = difftre_loss(e, _map_nbl(top, states.center[0], interleave=False), obs, TARGET, opt, states, KT)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=1e-10)
    assert abs(n_eff.item() - 1.0) < 1e-12  # reference energies = new energies
    scale = max(float(np.abs(np.asarray(v)).max()) for v in g_j.values())
    for k, v in opt.items():
        got = np.zeros_like(np.asarray(g_j[k])) if v.grad is None else v.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g_j[k]), rtol=1e-5, atol=1e-6 * scale, err_msg=k)


def test_difftre_step_moves_parameters():
    """One whole step on the CPU: stencil MD (K1/K2's plain versions), the
    tile map, reweighting, backward and one Adam step; finite loss and
    gradients, n_eff 1, and the parameters move."""
    top, body = synthetic_duplex(N_BP, dtype=torch.float32, device="cpu")
    e, sim = build_sim(top, KT, init_centers=body.center, init_orientation=body.orientation,
                       neighbor_update_every=10, device="cpu")
    opt = {k: v.detach().clone().requires_grad_(True) for k, v in e.opt_params().items()}
    before = {k: v.detach().clone() for k, v in opt.items()}
    obs = PropellerTwist(rigid_body_transform_fn=tdna2.default_transform_soa_fn(),
                         h_bonded_base_pairs=torch.as_tensor(_bps()))
    out = difftre_step(e, sim.replace(save_every=10), _map_nbl(top, body.center), obs, TARGET,
                       torch.optim.Adam(opt.values(), lr=1e-3), torch.Generator().manual_seed(0),
                       opt_params=opt, init_state=body, n_steps=20)
    assert out["trajectory"].center.shape == (2, 2 * N_BP, 3)
    assert torch.isfinite(out["loss"]) and abs(out["n_eff"].item() - 1.0) < 1e-6
    assert all(torch.isfinite(g).all() for g in out["grads"].values())
    assert any(float(g.abs().max()) > 0 for g in out["grads"].values())
    assert any(not torch.equal(before[k], out["params"][k]) for k in opt)


def test_overflowed_trajectory_is_refused():
    traj = SimulatorTrajectory(center=torch.zeros(2, 4, 3), orientation=torch.zeros(2, 4, 4))
    check_no_overflow(traj.with_state_metadata(neighbor_overflow=False))
    with pytest.raises(RuntimeError, match="overflowed neighbor table"):
        check_no_overflow(traj.with_state_metadata(neighbor_overflow=True))
    assert "capacity" in ERR_NEIGHBOR_OVERFLOW


def test_entry_points_default_to_the_card():
    """build_sim, synthetic_duplex and create_default_energy_fn run on the
    card unless asked for the CPU; without one they raise, never fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    top, body = synthetic_duplex(8, device="cpu")
    for call in (
        lambda: build_sim(top, KT, init_centers=body.center, init_orientation=body.orientation),
        lambda: build_sim(top, KT, mode="block", init_centers=body.center),
        lambda: synthetic_duplex(8),
        lambda: tdna2.create_default_energy_fn(top),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
