"""PyTorch port (mythos_tpu_torch): the oxDNA1 block tier -- K3's dna1
plain version on a one-level symmetric table (oxDNA1 has no Debye term)
and ``build_sim(mode="block", model="dna1")`` -- against the JAX package's
XLA tile path, and DiffTRe under oxDNA1's one table (its refusal of a
(tight, wide) table pair).

The JAX side is its XLA path, never Pallas interpret mode: ``jax.grad`` of
the block energy over a triangular table (float64, rtol 1e-6; XLA-CPU
transcendentals are float32-accurate even under x64, the port's tiles use
the polynomial arccos), and TpuSimulator on a single-level non-symmetric
table (float32, kT 0, rtol 1e-4, atol 1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny CPU shapes: one thread a worker, no idle pool spinning beside the others

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.dna1 as jdna1  # noqa: E402
import mythos_tpu_torch.energy.dna1 as tdna1  # noqa: E402
from mythos_tpu import soa as jsoa  # noqa: E402
from mythos_tpu import spaces  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.simulators import StaticSimulatorParams, TpuSimulator  # noqa: E402
from mythos_tpu.simulators import neighbors as jnb  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.entry import build_sim  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import tiles  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators import neighbors as tnb  # noqa: E402
from mythos_tpu_torch.soa import to_soa  # noqa: E402

N_BP = 40


@pytest.fixture(scope="module")
def f64_system():
    """A 0.01-jittered 40-bp duplex (float64) on both sides: the JAX block
    energy over a triangular table, the port's one-level symmetric table
    over the strand interleave, its dna1 contexts."""
    top_j, body_j = jax_duplex(N_BP)
    rng = np.random.default_rng(0)
    c = np.asarray(body_j.center) + 0.01 * rng.standard_normal(np.shape(body_j.center))
    q = np.asarray(body_j.orientation) + 0.01 * rng.standard_normal(np.shape(body_j.orientation))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jbody = JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))
    e_blk = jdna1.create_default_energy_fn(top_j, block_unbonded=True, block_size=8)
    tri = jnb.block_neighbor_list_for_topology(
        spaces.free()[0], top_j, jdna1.default_neighbor_cutoff(), dr_threshold=0.5, block_size=8, init_centers=c
    )
    e_j = e_blk.with_props(block_ids=tri.idx)
    top_t, _ = synthetic_duplex(N_BP, device="cpu")
    tbody = RigidBody(torch.as_tensor(c), torch.as_tensor(q))
    e_t = tdna1.create_default_energy_fn(top_t, dtype=torch.float64, device="cpu")
    nbl = tnb.block_neighbor_list_for_topology(top_t, tdna1.default_neighbor_cutoff(), block_size=8,
                                               init_centers=tbody.center, perm=tnb.strand_interleave_perm(top_t))
    ctxs = tiles.prepare_contexts(e_t, nbl.idx, nbl.block_size, perm=nbl.perm)
    return jbody, e_j, tbody, e_t, nbl, ctxs


def test_tile_plain_versions_match_jax(f64_system):
    """On the jittered 40-bp duplex's one-level symmetric table (short
    kind, family dna1, the backbone site on a1): the four unbonded sums
    (K4's plain version, triangular mask) equal the reference's XLA block
    sums over a triangular table, rtol 1e-6; K3's dna1 plain version,
    through fused_grads_ctx (K3 on the one table + the bonded gradient),
    equals jax.grad of the reference block energy, rtol 1e-6 (atol 1e-6
    max: the tiles' polynomial arccos differs from arccos in its derivative
    by ~1e-6); and K3's plain gate classes no pair as Debye-only."""
    jbody, e_j, tbody, e_t, nbl, ctxs = f64_system
    assert nbl.r_cutoff_inner is None and not isinstance(nbl.idx, tuple)
    (ctx,) = ctxs
    assert (ctx.spec.kind, ctx.spec.family, ctx.spec.terms) == ("short", "dna1", tiles.KIND_TERMS["short"])
    assert ctx.spec.geometry[:2] == (pytest.approx(-0.4), 0.0)
    terms_j, g = jax.jit(lambda b: (e_j.compute_terms_soa(b), jax.grad(e_j.energy_soa)(b)))(jsoa.to_soa(jbody))
    terms_j = np.asarray(terms_j)  # the reference's terms and gradient: one compile
    names = [type(fn).__name__ for fn in e_j.energy_fns]
    rows = tiles.dynamic_rows(ctx, to_soa(tbody))
    sums = tiles.tile_energies_plain(rows, ctx.params, nbl.idx, ctx.spec)
    for nm, s_ in zip(ctx.spec.terms, sums, strict=True):
        np.testing.assert_allclose(float(s_), terms_j[names.index(nm)], rtol=1e-6, atol=1e-12, err_msg=nm)
    g_com, g_quat = tiles.fused_grads_ctx(e_t, ctxs, to_soa(tbody), nbl.idx)
    for got, want in ((g_com, g.center), (g_quat, g.orientation)):
        a_ = torch.stack(tuple(got)).numpy()
        b_ = np.stack([np.asarray(c) for c in want])
        np.testing.assert_allclose(a_, b_, rtol=1e-6, atol=1e-6 * np.abs(b_).max())
    counts = tiles.tile_gate_counts(rows, ctx.params, nbl.idx, ctx.spec)
    assert counts["debye"] == 0 and counts["short"] > 0


def test_difftre_under_dna1_is_refused(f64_system):
    """What DiffTRe under oxDNA1 still refuses: a (tight, wide) table pair,
    which needs a Debye table oxDNA1 lacks; the error names the one short
    table it takes instead."""
    _, _, _, e_t, nbl, _ = f64_system
    with pytest.raises(ValueError, match="short kind"):
        tiles.prepare_contexts(e_t, (nbl.idx, nbl.idx), nbl.block_size, perm=nbl.perm)


def test_difftre_under_dna1_takes_one_short_table(f64_system):
    """DiffTRe under oxDNA1 takes one table: its contexts are the block
    tier's (one of the short kind, K3-K5's dna1 instances), and the tile
    map of a state equals the pair-list energy (f64, rtol 1e-6: the tiles'
    polynomial arccos; tests/test_torch_dna1_difftre.py holds the map and
    its gradients against the reference)."""
    _, _, tbody, e_t, nbl, ctxs = f64_system
    (ctx,) = tiles.prepare_contexts(e_t, nbl.idx, nbl.block_size, perm=nbl.perm)
    assert ctx.spec == ctxs[0].spec
    states = RigidBody(tbody.center[None], tbody.orientation[None])
    got = e_t.replace(map_neighbors=nbl).map(states)
    np.testing.assert_allclose(got.numpy(), e_t.map(states).numpy(), rtol=1e-6)


def test_dna1_block_run_matches_jax_tpu_simulator():
    """A 40-bp oxDNA1 block-tier run at kT = 0 (20 steps, rebuild every 5,
    save every 10): the port (one symmetric table, K3's dna1 plain version)
    against TpuSimulator on a single-level non-symmetric table (its XLA tile
    path), rtol 1e-4, atol 1e-5, no overflow."""
    jax.config.update("jax_enable_x64", False)
    try:
        top_j, body_j = jax_duplex(N_BP)
        e_j = jdna1.create_default_energy_fn(top_j, block_unbonded=True, block_size=8)
        nbl = jnb.block_neighbor_list_for_topology(
            spaces.free()[0], top_j, jdna1.default_neighbor_cutoff(), dr_threshold=0.5, block_size=8,
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
            space=spaces.free(), neighbors=nbl, save_every=10, neighbor_update_every=5,
        )
        params = e_j.opt_params()
        body32 = JaxRigidBody(center=jnp.asarray(body_j.center, jnp.float32),
                              orientation=jnp.asarray(body_j.orientation, jnp.float32))
        ref = jax.jit(lambda p: sim_j.run(p, body32, 20, jax.random.PRNGKey(0)))(params).observables[0]
    finally:
        jax.config.update("jax_enable_x64", True)
    top_t, body_t = synthetic_duplex(N_BP, dtype=torch.float32, device="cpu")
    e_t, sim_t = build_sim(top_t, 0.0, mode="block", model="dna1", init_centers=body_t.center,
                           neighbor_update_every=5, device="cpu")
    assert sim_t.neighbors.r_cutoff_inner is None
    opt = params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    got = sim_t.replace(save_every=10).run(opt, body_t, 20, torch.Generator().manual_seed(0)).observables[0]
    np.testing.assert_allclose(got.center.numpy(), np.asarray(ref.center), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.orientation.numpy(), np.asarray(ref.orientation), rtol=1e-4, atol=1e-5)
    assert not bool(got.metadata["neighbor_overflow"].any())
