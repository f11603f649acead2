"""PyTorch port (mythos_tpu_torch): the oxRNA2 block tier -- the plain block
sums (energy/blocks.py) on a non-symmetric table, ``BlockSimulator`` taking
their autograd as its force, ``build_sim(mode="block", model="rna2")`` --
and DiffTRe under oxRNA2, against the JAX package's XLA tile path.

The reference's own ``_build_sim(mode="block", model="rna2")`` builds
symmetric tables, which its fused tiles refuse at the first run, so the
oracle is its ``create_default_energy_fn(block_unbonded=True)`` on a
non-symmetric table: ``compute_terms_soa`` and ``jax.grad`` of
``energy_soa`` (float64, rtol 1e-6: XLA-CPU transcendentals are
float32-accurate even under x64), TpuSimulator (float32, kT 0, rtol 1e-4 /
atol 1e-5), and ``jax.grad`` of the reweighted loss on its ``map`` (loss
rtol 1e-10, gradients rtol 1e-5 / atol 1e-6 x the largest, as
test_torch_difftre.py). One JAX run compile in the file.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.rna2 as jrna2  # noqa: E402
import mythos_tpu_torch.energy.dna2 as tdna2  # noqa: E402
import mythos_tpu_torch.energy.rna2 as trna2  # noqa: E402
from mythos_tpu import soa as jsoa  # noqa: E402
from mythos_tpu import spaces  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.observables import PropellerTwist as JaxPropellerTwist  # noqa: E402
from mythos_tpu.optimization.objective import compute_weights_and_neff as jax_weights  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.simulators import StaticSimulatorParams, TpuSimulator  # noqa: E402
from mythos_tpu.simulators import neighbors as jnb  # noqa: E402
from mythos_tpu_torch.energy import blocks  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.entry import build_sim  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.losses import ObservableLossFn, SquaredError  # noqa: E402
from mythos_tpu_torch.observables import PropellerTwist  # noqa: E402
from mythos_tpu_torch.ops import tiles  # noqa: E402
from mythos_tpu_torch.optimization import DiffTReObjective  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators import neighbors as tnb  # noqa: E402
from mythos_tpu_torch.simulators.io import SimulatorTrajectory  # noqa: E402

N_BP = 40
RUN_BP = 20
B = 8
KT = 296.15 * 0.1 / 300.0


def _jittered(n_bp: int, seed: int, lead: tuple = (), scale: float = 0.01):
    _, body = jax_duplex(n_bp, form="A")
    rng = np.random.default_rng(seed)
    c = np.asarray(body.center, np.float64) + scale * rng.standard_normal((*lead, 2 * n_bp, 3))
    q = np.asarray(body.orientation, np.float64) + scale * rng.standard_normal((*lead, 2 * n_bp, 4))
    return c, q / np.linalg.norm(q, axis=-1, keepdims=True)


def _jax_table(top_j, c):
    return jnb.block_neighbor_list_for_topology(spaces.free()[0], top_j, jrna2.default_neighbor_cutoff(),
                                                dr_threshold=0.5, block_size=B, init_centers=jnp.asarray(c))


def test_block_sums_match_reference_compute_terms_soa():
    """On a 0.05-jittered 40-bp A-form duplex (float64): the port's
    non-symmetric table equals the reference's (ids and capacity); the
    per-term block sums (``with_props(block_ids=...)``, the 5 unbonded terms
    on shared tiles) equal the reference's ``compute_terms_soa`` on it,
    rtol 1e-6, and so do the same sums over the strand interleave (the
    table ``build_sim`` makes) and the pair list; d E / d (com, quat) of
    the block energy equals ``jax.grad`` of its ``energy_soa`` (rtol 1e-6,
    atol 1e-8 x the largest), and ``block_pair_sums`` in row batches of 3
    of the 10 row blocks gives the whole sums and gradient (rtol 1e-12).
    Unbound, the placeholder raises the reference's message; the tile
    kernels refuse the family with the reference's unsupported-model
    message; a block tier takes the kernels under dna2 and the block sums
    under rna2, and an oxDNA2 term set less its Debye term, which the
    kernels do not implement, raises on a non-symmetric table instead of
    taking the block sums."""
    c, q = _jittered(N_BP, 0, scale=0.05)
    top_j, _ = jax_duplex(N_BP, form="A")
    tri = _jax_table(top_j, c)
    e_j = jrna2.create_default_energy_fn(top_j, block_unbonded=True, block_size=B).with_props(block_ids=tri.idx)
    jbody = jsoa.to_soa(JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q)))
    want = np.asarray(e_j.compute_terms_soa(jbody))
    g_j = jax.grad(lambda b: e_j.energy_soa(b))(jbody)
    g_want = np.concatenate([np.stack(tuple(g_j.center), -1), np.stack(tuple(g_j.orientation), -1)], -1)

    top, _ = synthetic_duplex(N_BP, form="A", device="cpu")
    cut = trna2.default_neighbor_cutoff()
    nbl = tnb.block_neighbor_list_for_topology(top, cut, block_size=B, init_centers=torch.as_tensor(c),
                                               symmetric=False)
    np.testing.assert_array_equal(nbl.idx.numpy(), np.asarray(tri.idx))
    assert not nbl.symmetric and not nbl.banded and nbl.capacity == tri.capacity < nbl.n_blocks
    e = trna2.create_default_energy_fn(top, dtype=torch.float64, device="cpu", block_unbonded=True, block_size=B)
    body = RigidBody(torch.as_tensor(c).requires_grad_(True), torch.as_tensor(q).requires_grad_(True))
    with pytest.raises(ValueError, match="empty placeholder"):
        e(body)
    got = e.with_props(block_ids=nbl.idx).compute_terms(body)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-12)
    perm = tnb.strand_interleave_perm(top)
    inter = tnb.block_neighbor_list_for_topology(top, cut, block_size=B, init_centers=torch.as_tensor(c),
                                                 perm=perm, symmetric=False)
    e_perm = e.with_props(block_ids=inter.idx, block_perm=inter.perm)
    np.testing.assert_allclose(e_perm.compute_terms(body).detach().numpy(), want, rtol=1e-6, atol=1e-12)
    pairs = trna2.create_default_energy_fn(top, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(pairs.compute_terms(body).detach().numpy(), want, rtol=1e-6, atol=1e-12)
    g = torch.cat(torch.autograd.grad(got.sum(), (body.center, body.orientation)), -1).numpy()
    np.testing.assert_allclose(g, g_want, rtol=1e-6, atol=1e-8 * np.abs(g_want).max())
    members = [fn for fn in e.with_props(block_ids=nbl.idx).energy_fns if hasattr(fn, "pair_energies")]
    nuc = members[0].transform_fn(body)
    for rows_batch in (None, 3):
        sums = blocks.block_pair_sums([fn.pair_energies for fn in members], nuc, nbl.idx, B, 2 * N_BP,
                                      members[0].bonded_neighbors, rows_batch=rows_batch)
        g_b = torch.cat(torch.autograd.grad(sums.sum(), (body.center, body.orientation), retain_graph=True), -1)
        if rows_batch is None:
            whole, g_whole = sums.detach().numpy(), g_b.numpy()
    assert nbl.n_blocks == 10 and len(members) == 5
    np.testing.assert_allclose(sums.detach().numpy(), whole, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(g_b.numpy(), g_whole, rtol=1e-12, atol=1e-14 * np.abs(g_whole).max())

    with pytest.raises(ValueError, match="dna1/dna2 terms only"):
        tiles.prepare_contexts(e, inter.idx, B, perm=perm)
    with pytest.raises(ValueError, match="dna1/dna2 terms only"):
        e.replace(map_neighbors=inter).map(RigidBody(body.center.detach()[None], body.orientation.detach()[None]))
    assert blocks.n_blocks_for(2 * N_BP, B) == nbl.n_blocks
    top32, body32 = synthetic_duplex(N_BP, form="A", dtype=torch.float32, device="cpu")
    for model, kernels in (("dna2", True), ("rna2", False)):
        pkg = tdna2 if model == "dna2" else trna2
        top_m, body_m = (synthetic_duplex(N_BP, device="cpu") if model == "dna2" else (top32, body32))
        energy_fn, sim = build_sim(top_m, KT, mode="block", model=model, init_centers=body_m.center, device="cpu")
        assert sim.uses_kernels() is kernels and sim.neighbors.symmetric is kernels
        assert sim.neighbors.r_cutoff == pytest.approx(pkg.default_neighbor_cutoff())
    assert sim.neighbors.perm is not None and energy_fn.energy_fns[3].block_ids is sim.neighbors.idx
    e_dna2 = tdna2.create_default_energy_fn(top, dtype=torch.float32, device="cpu")
    no_debye = e_dna2.replace(energy_fns=[fn for fn in e_dna2.energy_fns if type(fn).__name__ != "Debye"])
    with pytest.raises(ValueError, match="oxDNA2 term set"):
        sim.replace(energy_fn=no_debye).uses_kernels()


def _reference_run():
    """The reference's XLA block run: 20 steps at kT 0 of a 0.01-jittered
    20-bp A-form duplex (float32), rebuild every 5, every state saved."""
    c, q = _jittered(RUN_BP, 3)
    jax.config.update("jax_enable_x64", False)
    try:
        top_j, _ = jax_duplex(RUN_BP, form="A")
        c32, q32 = jnp.asarray(c, jnp.float32), jnp.asarray(q, jnp.float32)
        e_j = jrna2.create_default_energy_fn(top_j, block_unbonded=True, block_size=B)
        sim_j = TpuSimulator(
            energy_fn=e_j,
            simulator_params=StaticSimulatorParams(
                seq=jnp.asarray(top_j.seq),
                mass=JaxRigidBody(center=jnp.array([1.0]), orientation=jnp.array([[1.0, 1.0, 1.0]])),
                gamma=JaxRigidBody(center=jnp.array([0.0]), orientation=jnp.array([0.0])),
                bonded_neighbors=jnp.asarray(top_j.bonded_neighbors), checkpoint_every=0, dt=5e-3, kT=0.0),
            space=spaces.free(), neighbors=_jax_table(top_j, c32), save_every=1, neighbor_update_every=5,
        )
        params = e_j.opt_params()
        ref = jax.jit(lambda p: sim_j.run(p, JaxRigidBody(center=c32, orientation=q32), 20,
                                          jax.random.PRNGKey(0)))(params).observables[0]
        return c, q, {k: np.asarray(v) for k, v in params.items()}, ref
    finally:
        jax.config.update("jax_enable_x64", True)


def test_rna2_block_run_matches_reference_xla_block_run():
    """``build_sim(mode="block", model="rna2")`` (the non-symmetric table over
    the strand interleave, the block sums' autograd as the force) runs 20
    steps at kT 0 (rebuild every 5, every state saved), float32, against
    the reference's XLA block run on its non-symmetric table (original
    order), rtol 1e-4, atol 1e-5; no overflow on either side; no tile
    kernel is reached (K3's wrapper never called)."""
    c, q, params, ref = _reference_run()
    top, _ = synthetic_duplex(RUN_BP, form="A", dtype=torch.float32, device="cpu")
    body = RigidBody(torch.as_tensor(c, dtype=torch.float32), torch.as_tensor(q, dtype=torch.float32))
    _, sim = build_sim(top, 0.0, mode="block", model="rna2", init_centers=body.center, neighbor_update_every=5,
                       device="cpu")
    calls = tiles.tile_forces.launches
    plain_k3 = tiles.tile_forces

    def refused(*_a, **_k):
        raise AssertionError("the rna2 block tier reached K3")

    tiles.tile_forces = refused
    try:
        got = sim.replace(save_every=1).run(params_from_numpy(params), body, 20,
                                            torch.Generator().manual_seed(0)).observables[0]
    finally:
        tiles.tile_forces = plain_k3
    assert tiles.tile_forces.launches == calls
    for field in ("center", "orientation"):
        a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        assert a.shape == b.shape == (20, 2 * RUN_BP, 3 if field == "center" else 4)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=field)
    assert not bool(np.asarray(ref.metadata["neighbor_overflow"]).any())
    assert not bool(torch.as_tensor(got.metadata["neighbor_overflow"]).any())


def test_rna2_difftre_matches_jax_grad():
    """The reweighted propeller-twist loss of 4 given 0.01-jittered 20-bp
    A-form states under oxRNA2 and its gradient in every optimisable
    parameter: ``DiffTReObjective.calculate`` on the energy's ``map``
    through its own block table (``map_neighbors`` None; the block sums)
    against ``jax.grad`` of the same loss on the reference's block ``map``
    (float64): loss rtol 1e-10, gradients rtol 1e-5, atol 1e-6 x the
    largest."""
    c, q = _jittered(RUN_BP, 5, lead=(4,))
    target = 21.7
    n = 2 * RUN_BP
    bps = np.array([[i, n - 1 - i] for i in range(RUN_BP)], np.int32)
    top_j, _ = jax_duplex(RUN_BP, form="A")
    tri = _jax_table(top_j, c[0])
    e_j = jrna2.create_default_energy_fn(top_j, block_unbonded=True, block_size=B).with_props(block_ids=tri.idx)
    obs_j = JaxPropellerTwist(rigid_body_transform_fn=jrna2.default_transform_fn(),
                              h_bonded_base_pairs=jnp.asarray(bps))
    states_j = JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))
    p0 = e_j.opt_params()

    def loss_j(p):
        new_e = e_j.with_params(p).map(states_j)
        w, _ = jax_weights(1.0 / KT, new_e, jax.lax.stop_gradient(new_e))
        return (target - jnp.sum(w * obs_j(states_j))) ** 2

    l_j, g_j = jax.jit(jax.value_and_grad(loss_j))(p0)

    top, _ = synthetic_duplex(RUN_BP, form="A", device="cpu")
    nbl = tnb.block_neighbor_list_for_topology(top, trna2.default_neighbor_cutoff(), block_size=B,
                                               init_centers=torch.as_tensor(c[0]), symmetric=False)
    e = trna2.create_default_energy_fn(top, dtype=torch.float64, device="cpu", block_unbonded=True,
                                       block_size=B).with_props(block_ids=nbl.idx)
    obs = ObservableLossFn(observable=PropellerTwist(rigid_body_transform_fn=trna2.default_transform_soa_fn(),
                                                     h_bonded_base_pairs=torch.as_tensor(bps)),
                           loss_fn=SquaredError(), return_observable=True)

    def grad_or_loss_fn(ref_states, weights, *_):
        loss, measured = obs(ref_states, target, weights)
        return loss, (("propeller_twist", measured), None)

    objective = DiffTReObjective(name="rna2", required_observables=("traj",), grad_or_loss_fn=grad_or_loss_fn,
                                 energy_fn=e)
    traj = SimulatorTrajectory(center=torch.as_tensor(c), orientation=torch.as_tensor(q),
                               temperature=torch.full((4,), KT, dtype=torch.float64))
    opt = params_from_numpy({k: np.asarray(v) for k, v in p0.items()}, dtype=torch.float64)
    out = objective.calculate({"traj": traj}, opt_params=opt)
    assert out.is_ready
    np.testing.assert_allclose(float(out.observables["loss"]), float(l_j), rtol=1e-10)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in g_j.values())
    assert scale > 0 and set(out.grads) == set(g_j)
    for k, v in g_j.items():
        np.testing.assert_allclose(out.grads[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6 * scale, err_msg=k)
