"""PyTorch port (mythos_tpu_torch): direct differentiation through the
block tier, against ``jax.grad`` through the JAX TpuSimulator.

``loss(sim.run(p, body, n, gen)).backward()`` through ``BlockSimulator.run``
gives d loss / d every tensor of ``opt_params``: every force goes through
``ops.tiles.TileForces`` (K3 forward -- here its plain version -- and the
plain version with ``create_graph`` backward, differentiable in the rows
through both their row and their column roles and in the parameters), the
row packing and the bonded gradient with ``create_graph``; the contexts'
parameters and static tails are on the graph. JAX differentiates its
block run on a single-level non-symmetric table (the XLA tile path,
mythos_tpu/simulators/tpu.py:323-328: ``jax.grad`` does not go through its
fused K3), in float32, ``save_every`` = ``neighbor_update_every`` = 5: one
run-level gradient, compiled once and shared. The port's symmetric two-level
tables, its saving branch and its every-step branch (states ``[4::5]``),
each with ``checkpoint_every`` 0 and 1, are held against it. kT = 0 keeps
random numbers out of the comparison; the start is the 20-bp duplex
jittered by 0.01, off the arccos clamp.

The pair orientation. The port's K3, like the reference's fused K3, takes
the force on each body from the row side of a symmetric table: the body
plays the first role of every pair it is in. The reference's differentiable
run sums each pair once, in index order, so one body of each pair plays the
second role. With the defaults both roles of an angle hold equal values,
so forces, trajectories and the loss agree; but the gradient of a force in
an angle parameter that the two roles hold apart (hydrogen bonding's and
cross stacking's theta2/theta3, hydrogen bonding's theta7/theta8) goes to
one role in the port where the reference splits it. So for those ten
parameters the test holds the combinations that do not depend on the
orientation (ROLE_SUMS, ROLE_DIFFS): measured within 1.9e-7 max|grad| of
jax.grad, except theta0_hb_2 + theta0_hb_3 at 1.32e-4 (float32), while
their single gradients differ by up to 2.8e-2 max|grad|. ROADMAP.md queue 3
names the same orientation effect in the tile map's parameter gradients.

Tolerance: every other parameter of the float32 gradient, and each of those
combinations, within rtol 1e-3 / atol 2e-4 max|grad| of ``jax.grad`` (the
limit of tests/test_torch_direct.py, for the same float32 reason:
measured, the worst is theta0_stack_4 at 1.093e-4 max|grad| beyond the
rtol part), and eps_stack_base, eps_stack_kt_coeff and eps_hb at rtol 1e-3
alone (measured 2.8e-4 relative at most). The four paths give the same
gradient bit for bit here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.dna2 as jdna2  # noqa: E402
from __graft_entry__ import _tiny_duplex  # noqa: E402
from mythos_tpu import spaces  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.simulators import StaticSimulatorParams, TpuSimulator  # noqa: E402
from mythos_tpu.simulators import neighbors as jnb  # noqa: E402
from mythos_tpu.simulators.tpu import ERR_CHKPNT_SCN  # noqa: E402
from mythos_tpu_torch import entry  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import tiles  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.soa import to_soa  # noqa: E402

N_BP = 20
U = 5
N_STEPS = 10
KT = 296.15 * 0.1 / 300.0
RTOL, ATOL_F32 = 1e-3, 2e-4
PATHS = {
    "saving": {"save_every": U},
    "saving checkpoint_every=1": {"save_every": U, "checkpoint_every": 1},
    "every-step": {"save_every": 1},
    "every-step checkpoint_every=1": {"save_every": 1, "checkpoint_every": 1},
}
#: the angle parameters that a pair's two bodies take in turn: hydrogen
#: bonding's and cross stacking's theta2/theta3 and hydrogen bonding's
#: theta7/theta8. Their single gradients follow the pair's orientation
#: (module docstring); these combinations do not: the sums, and for
#: theta0_hb_7/8 the difference (theta7 of the swapped pair is pi - theta8,
#: so its offset's derivative flips sign)
ROLE_SUMS = (("a_hb_2", "a_hb_3"), ("theta0_hb_2", "theta0_hb_3"), ("a_hb_7", "a_hb_8"),
             ("a_cross_2", "a_cross_3"), ("theta0_cross_2", "theta0_cross_3"))
ROLE_DIFFS = (("theta0_hb_7", "theta0_hb_8"),)


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _start():
    """(JAX topology, (centers, unit quats) of the duplex jittered by 0.01,
    float32 numpy), as tests/test_torch_direct.py."""
    topology, body = _tiny_duplex(N_BP)
    rng = np.random.default_rng(0)
    c = np.asarray(body.center, np.float64) + 0.01 * rng.standard_normal(np.shape(body.center))
    q = np.asarray(body.orientation, np.float64) + 0.01 * rng.standard_normal(np.shape(body.orientation))
    return topology, (c.astype(np.float32), (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32))


def _weights():
    """Fixed weights of the loss on the (N_STEPS // U) states it reads."""
    rng = np.random.default_rng(1)
    return (rng.standard_normal((N_STEPS // U, 2 * N_BP, 3)).astype(np.float32),
            rng.standard_normal((N_STEPS // U, 2 * N_BP, 4)).astype(np.float32))


def _port(kT: float = 0.0, **kw):  # noqa: N803
    """(energy_fn, block simulator, jittered body) of the port on the CPU."""
    _, (c, q) = _start()
    top, _ = synthetic_duplex(N_BP, dtype=torch.float32, device="cpu")
    body = RigidBody(torch.from_numpy(c), torch.from_numpy(q))
    e, sim = entry.build_sim(top, kT, mode="block", init_centers=body.center, neighbor_update_every=U, device="cpu",
                             **kw)
    return e, sim, body


def _port_grad(e, sim, body, seed=0):
    """(loss, {name: d loss / d name}) of one run, every ``opt_params``
    tensor a leaf; every-step runs read the states [U-1::U]."""
    wc, wq = (torch.from_numpy(w) for w in _weights())
    p = {k: v.detach().clone().requires_grad_(True) for k, v in e.opt_params().items()}
    traj = sim.run(p, body, N_STEPS, torch.Generator().manual_seed(seed)).observables[0]
    pick = slice(None) if sim.save_every > 1 else slice(U - 1, None, U)
    loss = (wc * traj.center[pick]).sum() + (wq * traj.orientation[pick]).sum()
    loss.backward()
    return loss.item(), {k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in p.items()}


@pytest.fixture(scope="module")
def jax_grad(_f32_mode):
    """(loss, {name: gradient}) of jax.grad through TpuSimulator.run on a
    single-level non-symmetric block table (XLA tile path), 10 steps, a
    state every 5 (set up as test_torch_perstep.py's block test)."""
    topology, (c, q) = _start()
    body = JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))
    e_j = jdna2.create_default_energy_fn(topology, block_unbonded=True, block_size=8)
    nbl = jnb.block_neighbor_list_for_topology(
        spaces.free()[0], topology, jdna2.default_neighbor_cutoff(), dr_threshold=0.5, block_size=8,
        init_centers=body.center,
    )
    sim = TpuSimulator(
        energy_fn=e_j,
        simulator_params=StaticSimulatorParams(
            seq=jnp.asarray(topology.seq),
            mass=JaxRigidBody(center=jnp.array([1.0]), orientation=jnp.array([[1.0, 1.0, 1.0]])),
            gamma=JaxRigidBody(center=jnp.array([0.0]), orientation=jnp.array([0.0])),
            bonded_neighbors=jnp.asarray(topology.bonded_neighbors), checkpoint_every=0, dt=5e-3, kT=0.0,
        ),
        space=spaces.free(), neighbors=nbl, save_every=U, neighbor_update_every=U,
    )
    wc, wq = (jnp.asarray(w) for w in _weights())

    def loss(p):
        traj = sim.run(p, body, N_STEPS, jax.random.PRNGKey(0)).observables[0]
        return jnp.sum(wc * traj.center) + jnp.sum(wq * traj.orientation)

    value, grads = jax.jit(jax.value_and_grad(loss))(e_j.opt_params())
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def port_grads():
    """{path: (loss, grads)} of the port's runs."""
    e, sim, body = _port()
    return {name: _port_grad(e, sim.replace(**kw), body) for name, kw in PATHS.items()}


@pytest.mark.parametrize("path", list(PATHS))
def test_gradient_matches_jax_grad(path, port_grads, jax_grad):
    """d loss / d opt_params through BlockSimulator.run == jax.grad through
    TpuSimulator.run (module docstring)."""
    ref_loss, ref = jax_grad
    loss, got = port_grads[path]
    assert sorted(got) == sorted(ref)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    scale = max(float(np.abs(g).max()) for g in ref.values())
    paired = {k for pair in ROLE_SUMS + ROLE_DIFFS for k in pair}
    for k in ref:
        if k not in paired:
            np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=RTOL, atol=ATOL_F32 * scale, err_msg=k)
    for pairs, sign in ((ROLE_SUMS, 1.0), (ROLE_DIFFS, -1.0)):
        for a, b in pairs:
            np.testing.assert_allclose(got[a].numpy() + sign * got[b].numpy(), ref[a] + sign * ref[b], rtol=RTOL,
                                       atol=ATOL_F32 * scale, err_msg=f"{a}, {b}")
    for k in ("eps_stack_base", "eps_stack_kt_coeff", "eps_hb"):
        assert float(np.abs(ref[k]).max()) > 0, k
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=RTOL, atol=0, err_msg=k)
    assert [k for k in ref if np.any(ref[k] != 0)] == [k for k in ref if bool((got[k] != 0).any())]


@pytest.mark.parametrize("branch", ["saving", "every-step"])
def test_checkpoint_every_keeps_the_gradient(branch, port_grads):
    """checkpoint_every 1 (each outer iteration recomputed in the backward)
    gives the gradient of the run without it, rtol 1e-6."""
    _, plain = port_grads[branch]
    _, ckpt = port_grads[f"{branch} checkpoint_every=1"]
    for k in plain:
        np.testing.assert_allclose(ckpt[k].numpy(), plain[k].numpy(), rtol=1e-6, atol=0, err_msg=k)


def _tile_inputs(kind: str, dtype=torch.float64):
    """(rows, params, padded table, spec) of one kind on the 14-bp duplex
    (28 nt: 4 row blocks of 8), jittered by 0.01, in ``dtype``."""
    top, body = synthetic_duplex(14, dtype=dtype, device="cpu")
    gen = torch.Generator().manual_seed(3)
    c = body.center + 0.01 * torch.randn(body.center.shape, generator=gen, dtype=dtype)
    q = body.orientation + 0.01 * torch.randn(body.orientation.shape, generator=gen, dtype=dtype)
    body = RigidBody(c, q / q.norm(dim=-1, keepdim=True))
    e, sim = entry.build_sim(top, KT, mode="block", init_centers=body.center, device="cpu")
    nbl = sim.neighbors
    ids = nbl.idx[0 if kind == "short" else -1] if isinstance(nbl.idx, tuple) else nbl.idx
    ctx = tiles.prepare_tile_context(e, ids, nbl.block_size, kind, nbl.perm)
    ctx = tiles.TileContext(spec=ctx.spec, params=ctx.params.to(dtype), static_tail=ctx.static_tail.to(dtype),
                            unbonded=ctx.unbonded, perm=ctx.perm)
    rows = tiles.dynamic_rows(ctx, to_soa(body)).to(dtype)
    return rows, ctx.params, tiles.pad_ids(ctx.spec, ids), ctx.spec


@pytest.mark.parametrize("kind", ["full", "short", "debye"])
def test_tile_forces_gradcheck(kind):
    """TileForces (K3: rows, params -> row forces) passes a float64
    gradcheck on a table of 4 row blocks, in every kind: its backward, the
    plain version with create_graph, is the derivative of the forces in the
    rows' continuous fields (body, hb weight factors, charge factor; the
    ids are integers) through both their row and their column roles, and
    in every parameter, the term weights included."""
    rows, params, ids, spec = _tile_inputs(kind)
    assert spec.n_blocks == 4
    fixed = set(spec.id_offsets) | ({tiles._PARTNER} if kind != "debye" else set())
    free = torch.tensor([k for k in range(spec.n_fields) if k not in fixed])

    def fn(values, p):
        return tiles.TileForces.apply(rows.detach().index_copy(1, free, values), p, ids, spec)

    ins = (rows[:, free].detach().clone().requires_grad_(True), params.detach().clone().requires_grad_(True))
    assert torch.autograd.gradcheck(fn, ins, eps=1e-6, atol=1e-5, rtol=1e-4, fast_mode=True)
    # the column role is load-bearing: the row side alone misses part of the derivative
    g = torch.randn((spec.n_pad, spec.n_force_fields), dtype=rows.dtype, generator=torch.Generator().manual_seed(4))
    r_ = rows.detach().requires_grad_(True)
    (full,) = torch.autograd.grad(tiles.TileForces.apply(r_, params, ids, spec), r_, g)
    with torch.enable_grad():
        head = r_[:, : spec.n_force_fields]
        sums = tiles._masked_sums(torch.cat([head, r_.detach()[:, spec.n_force_fields:]], 1),
                                  tiles._gather_cols(r_.detach(), ids, spec), params, spec, triangular=False)
        total = sum(w * s for w, s in zip(tiles.term_weights(params, spec), sums, strict=True))
        (f_row,) = torch.autograd.grad(total, head, create_graph=True)
        (row_only,) = torch.autograd.grad(f_row, r_, g)
    assert float((full - row_only).abs().max()) > 1e-3 * float(full.abs().max())


@pytest.mark.parametrize("path", list(PATHS))
def test_grad_run_is_the_no_grad_run(path, monkeypatch):
    """At kT > 0 (noise on), a run that builds the graph gives the
    trajectory of the same run under no_grad bit for bit, calls K3's
    wrapper (tile_forces) as often in its forward, and leaves the generator
    in the same state; the backward calls it again only to recompute a
    checkpointed stretch."""
    e, sim, body = _port(kT=KT)
    sim = sim.replace(**PATHS[path])
    calls = {"K3": 0}
    k3 = tiles.tile_forces

    def counted(*args, **kw):
        calls["K3"] += 1
        return k3(*args, **kw)

    monkeypatch.setattr(tiles, "tile_forces", counted)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        ref = sim.run(e.opt_params(), body, N_STEPS, gen).observables[0]
    ref_calls, ref_gen = calls["K3"], gen.get_state()
    calls["K3"] = 0
    p = {k: v.detach().clone().requires_grad_(True) for k, v in e.opt_params().items()}
    gen = torch.Generator().manual_seed(4)
    got = sim.run(p, body, N_STEPS, gen).observables[0]
    assert got.center.requires_grad
    assert torch.equal(got.center.detach(), ref.center) and torch.equal(got.orientation.detach(), ref.orientation)
    n_tables = len(sim.neighbors.idx) if isinstance(sim.neighbors.idx, tuple) else 1
    assert calls["K3"] == ref_calls == n_tables * (N_STEPS + 1)
    assert torch.equal(gen.get_state(), ref_gen)
    (got.center * torch.linspace(-1.0, 1.0, got.center.numel()).reshape(got.center.shape)).sum().backward()
    recomputed = n_tables * N_STEPS if "checkpoint" in path else 0
    assert calls["K3"] == ref_calls + recomputed
    assert all(bool(torch.isfinite(v.grad).all()) for v in p.values() if v.grad is not None)
    assert float(p["eps_stack_base"].grad) != 0.0


@pytest.mark.parametrize("branch, kw, length", [("saving", {"save_every": U}, N_STEPS // U),
                                                 ("every-step", {"save_every": 1}, N_STEPS // U)])
def test_checkpoint_every_must_divide_the_outer_loop(branch, kw, length):
    """checkpoint_every counts saves (saving branch) or rebuild intervals
    (every-step branch), 2 of each here, and must divide them: the
    reference's ERR_CHKPNT_SCN, with or without gradients."""
    e, sim, body = _port()
    with pytest.raises(ValueError) as err:
        sim.replace(checkpoint_every=3, **kw).run(e.opt_params(), body, N_STEPS, torch.Generator())
    assert str(err.value) == ERR_CHKPNT_SCN.format(3, length)


def test_build_sim_block_takes_checkpoint_every():
    """build_sim(mode="block", checkpoint_every=k) builds the block tier with
    it (the refusal of earlier ports is gone)."""
    _, sim, _ = _port(checkpoint_every=1)
    assert type(sim).__name__ == "BlockSimulator" and sim.checkpoint_every == 1


def test_fused_grads_refuse_contexts_that_need_a_gradient():
    """Without create_graph, fused_grads_ctx would run K3 on detached
    parameters: contexts prepared on the graph raise (ERR_HIDDEN_GRAD)
    rather than drop the gradient silently; with create_graph the force
    reaches the parameters."""
    e, sim, body = _port()
    p = {k: v.detach().clone().requires_grad_(True) for k, v in e.opt_params().items()}
    energy = e.with_params(p)
    nbl = sim.neighbors
    ctxs = tiles.prepare_contexts(energy, nbl.idx, nbl.block_size, perm=nbl.perm)
    b = to_soa(body)
    with pytest.raises(ValueError, match="pass create_graph=True"):
        tiles.fused_grads_ctx(energy, ctxs, b, nbl.idx)
    g_com, _ = tiles.fused_grads_ctx(energy, ctxs, b, nbl.idx, create_graph=True)
    (g,) = torch.autograd.grad(g_com.x.sum(), p["eps_hb"])
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
