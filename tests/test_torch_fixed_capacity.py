"""PyTorch port (mythos_tpu_torch): ``FixedCapacityNeighborList`` -- the
distance-culled pair list of fixed capacity -- and ``PairSimulator``
rebuilding it, against the JAX package.

The list's build is exact integer output: the pairs, their order (nearest
first, a stable sort) and the overflow flags must equal the reference's.
The run compares the port's float32 trajectory with TpuSimulator's generic
branch over its own list at kT 0 (no random numbers in either), rtol 1e-4 /
atol 1e-5 (float32 over 20 steps). One JAX run compile in the file.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.dna2 as jdna2  # noqa: E402
import mythos_tpu_torch.energy.dna2 as tdna2  # noqa: E402
from mythos_tpu import spaces  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.simulators import StaticSimulatorParams, TpuSimulator  # noqa: E402
from mythos_tpu.simulators import neighbors as jnb  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators import cuda as tcuda  # noqa: E402
from mythos_tpu_torch.simulators import neighbors as tnb  # noqa: E402

N_BP = 40
N_STEPS = 20


def _jittered(seed: int = 0, scale: float = 0.05):
    _, body = jax_duplex(N_BP)
    rng = np.random.default_rng(seed)
    c = np.asarray(body.center, np.float64) + scale * rng.standard_normal(np.shape(body.center))
    q = np.asarray(body.orientation, np.float64) + scale * rng.standard_normal(np.shape(body.orientation))
    return c, q / np.linalg.norm(q, axis=1, keepdims=True)


def _pairs_equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert bool(got[1]) == bool(want[1])


def test_build_matches_reference():
    """``_build`` on the reference's three-particle case
    (tests/test_blocks.py:169-194: drop the farthest, the missed-pair
    detector with and without the interacting pair) and on a 0.05-jittered
    40-bp duplex (float64, the dna2 cutoff) at the sized capacity and at
    half the bare-cutoff hits (overflowing): the (2, capacity) pairs, their
    order and the flags equal the reference's, also for a rebuild against
    a previous list (``update``) with a pair censored out of it."""
    centers = np.array([[0.0, 0, 0], [0.9, 0, 0], [1.7, 0, 0]])
    kw = dict(exclusion_mask=np.zeros((3, 3), bool), r_cutoff=1.0, dr_threshold=1.0, capacity=2)
    ref = jnb.FixedCapacityNeighborList(displacement_fn=spaces.free()[0], **kw)
    port = tnb.FixedCapacityNeighborList(**kw)
    for prev in (None, [[1, 3], [2, 3]], [[1, 0], [2, 1]]):
        _pairs_equal(port._build(torch.as_tensor(centers), None if prev is None else torch.as_tensor(prev)),
                     ref._build(jnp.asarray(centers), None if prev is None else jnp.asarray(prev)))
    assert not bool(port._build(torch.as_tensor(centers))[1])
    assert bool(port._build(torch.as_tensor(centers), torch.as_tensor([[1, 3], [2, 3]]))[1])

    top_j, _ = jax_duplex(N_BP)
    top_t, _ = synthetic_duplex(N_BP, device="cpu")
    c, _ = _jittered()
    cut = tdna2.default_neighbor_cutoff()
    assert cut == pytest.approx(jdna2.default_neighbor_cutoff(), rel=1e-12)
    ref = jnb.neighbor_list_for_topology(spaces.free()[0], top_j, cut, init_centers=jnp.asarray(c))
    port = tnb.neighbor_list_for_topology(top_t, cut, init_centers=torch.as_tensor(c))
    assert port.capacity == ref.capacity
    _pairs_equal((port.idx, port.did_overflow), (ref.idx, ref.did_overflow))
    c2, _ = _jittered(seed=1)
    moved = port.update(torch.as_tensor(c2))
    moved_ref = ref.update(jnp.asarray(c2))
    _pairs_equal((moved.idx, moved.did_overflow), (moved_ref.idx, moved_ref.did_overflow))
    hard = int(np.sum(np.asarray(ref.idx[0]) < 2 * N_BP))
    small = dict(capacity=hard // 2, r_cutoff=cut, dr_threshold=0.2)
    ref_s = ref.replace(**small)
    port_s = port.replace(**small)
    built = port_s._build(torch.as_tensor(c))
    _pairs_equal(built, ref_s._build(jnp.asarray(c)))
    assert bool(built[1]) and built[0].shape == (2, hard // 2)
    censored = port.idx.clone()
    censored[:, 0] = 2 * N_BP  # the nearest pair is inside the bare cutoff
    _pairs_equal(port._build(torch.as_tensor(c2), censored), ref._build(jnp.asarray(c2), jnp.asarray(censored)))
    assert bool(port._build(torch.as_tensor(c2), censored)[1])


def test_pair_simulator_rebuilds_like_reference():
    """A 20-step oxDNA2 run at kT 0 from a 0.01-jittered 40-bp duplex,
    every state saved, the list rebuilt every 5 steps: the port's
    PairSimulator over a FixedCapacityNeighborList against TpuSimulator's
    generic branch over the reference's (float32, rtol 1e-4, atol 1e-5),
    equal ``neighbor_overflow`` metadata; the cadence checks raise the
    reference's messages in both forms."""
    c, q = _jittered(scale=0.01)
    jax.config.update("jax_enable_x64", False)
    try:
        top_j, _ = jax_duplex(N_BP)
        c32, q32 = jnp.asarray(c, jnp.float32), jnp.asarray(q, jnp.float32)
        e_j = jdna2.create_default_energy_fn(top_j)
        nbl_j = jnb.neighbor_list_for_topology(spaces.free()[0], top_j, jdna2.default_neighbor_cutoff(),
                                               init_centers=c32)
        sim_j = TpuSimulator(
            energy_fn=e_j,
            simulator_params=StaticSimulatorParams(
                seq=jnp.asarray(top_j.seq),
                mass=JaxRigidBody(center=jnp.array([1.0]), orientation=jnp.array([[1.0, 1.0, 1.0]])),
                gamma=JaxRigidBody(center=jnp.array([0.0]), orientation=jnp.array([0.0])),
                bonded_neighbors=jnp.asarray(top_j.bonded_neighbors), checkpoint_every=0, dt=5e-3, kT=0.0),
            space=spaces.free(), neighbors=nbl_j, save_every=1, neighbor_update_every=5,
        )
        params = e_j.opt_params()
        ref = jax.jit(lambda p: sim_j.run(p, JaxRigidBody(center=c32, orientation=q32), N_STEPS,
                                          jax.random.PRNGKey(0)))(params).observables[0]
        ref_overflow = bool(np.asarray(ref.metadata["neighbor_overflow"]).any())
    finally:
        jax.config.update("jax_enable_x64", True)

    top_t, _ = synthetic_duplex(N_BP, device="cpu")
    body = RigidBody(torch.as_tensor(c, dtype=torch.float32), torch.as_tensor(q, dtype=torch.float32))
    e_t = tdna2.create_default_energy_fn(top_t, device="cpu")
    nbl = tnb.neighbor_list_for_topology(top_t, tdna2.default_neighbor_cutoff(), init_centers=body.center)
    assert nbl.capacity == int(nbl_j.capacity)
    sim = tcuda.PairSimulator(energy_fn=e_t, neighbors=nbl, dt=5e-3, kT=0.0, neighbor_update_every=5)
    opt = params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    got = sim.run(opt, body, N_STEPS, torch.Generator().manual_seed(0)).observables[0]
    for field in ("center", "orientation"):
        a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        assert a.shape == b.shape == (N_STEPS, 2 * N_BP, 3 if field == "center" else 4)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=field)
    assert bool(torch.as_tensor(got.metadata["neighbor_overflow"]).any()) is ref_overflow is False
    with pytest.raises(ValueError, match="neighbor_update_every"):
        sim.run(opt, body, 12, torch.Generator())
    with pytest.raises(ValueError, match="neighbor_update_every"):
        sim.replace(save_every=6).run(opt, body, 12, torch.Generator())
