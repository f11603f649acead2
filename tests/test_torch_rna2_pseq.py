"""PyTorch port (mythos_tpu_torch): oxRNA2 under a probabilistic sequence
(sequence design) -- its stacking's expected bond weights, hydrogen
bonding's pseq on the pair list, the block sums and the stencil (K2's rna2
pseq instance, its plain version here), the per-step stencil run, and
d loss / d bp_pseq of DiffTRe -- against the JAX package.

The JAX side is its XLA paths: the pair-list pseq energy and its
``jax.grad`` (float64), its pair-list ``TpuSimulator`` (float32) -- the
reference's XLA stencil cannot run a pseq under ``jax.jit`` (it reads its
partner table with ``np.asarray`` inside the traced run,
mythos_tpu/ops/oxdna_tiles.py:1509) -- and ``jax.grad`` of the reweighted
loss on its pair-list ``map``. One JAX run compile in the file.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.rna2 as jrna2  # noqa: E402
import mythos_tpu.io.sequence_constraints as jsc  # noqa: E402
import mythos_tpu_torch.energy.rna2 as trna2  # noqa: E402
import mythos_tpu_torch.io.sequence_constraints as tsc  # noqa: E402
from __graft_entry__ import _build_sim  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.observables import PropellerTwist as JaxPropellerTwist  # noqa: E402
from mythos_tpu.optimization.objective import compute_weights_and_neff as jax_weights  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.entry import build_sim  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.losses import ObservableLossFn, SquaredError  # noqa: E402
from mythos_tpu_torch.observables import PropellerTwist  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
from mythos_tpu_torch.optimization import DiffTReObjective  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators import neighbors as tnb  # noqa: E402
from mythos_tpu_torch.simulators.io import SimulatorTrajectory  # noqa: E402
from mythos_tpu_torch.soa import Quat, Vec3  # noqa: E402

N_BP = 40
N = 2 * N_BP
B = 8
KT = 296.15 * 0.1 / 300.0


def _constraints(module):
    """All but the two outermost base pairs constrained: four unpaired
    nucleotides, so that both pseq arrays take part."""
    return module.from_bps(N, np.array([[i, N - 1 - i] for i in range(1, N_BP - 1)]))


def _pseq(seed: int):
    rng = np.random.default_rng(seed)
    sc = _constraints(tsc)
    up, bp = rng.random((sc.n_unpaired, 4)), rng.random((sc.n_bp, 4))
    return up / up.sum(1, keepdims=True), bp / bp.sum(1, keepdims=True)


def _jittered(seed: int, lead: tuple = ()):
    _, body = jax_duplex(N_BP, form="A")
    rng = np.random.default_rng(seed)
    c = np.asarray(body.center, np.float64) + 0.01 * rng.standard_normal((*lead, N, 3))
    q = np.asarray(body.orientation, np.float64) + 0.01 * rng.standard_normal((*lead, N, 4))
    return c, q / np.linalg.norm(q, axis=-1, keepdims=True)


def _jax_with_pseq(efn, pseq, sc):
    return efn.replace(energy_fns=[
        fn.replace(params=fn.params.replace(pseq=pseq, pseq_constraints=sc).init_params())
        if hasattr(fn.params, "pseq") else fn for fn in efn.energy_fns
    ])


def _paths(top, body, pseq, sc, dtype):
    """{path: (energy, d/d up, d/d bp)} of the port under ``pseq``: the pair
    list, the block sums on a non-symmetric table over the strand
    interleave, and the stencil's plain versions (K2's, the band with its
    hb factors, and the bonded terms' expected weights)."""
    out = {}
    for path in ("pairs", "block", "stencil"):
        up, bp = (torch.tensor(x, dtype=dtype, requires_grad=True) for x in pseq)
        e = trna2.create_default_energy_fn(top, dtype=dtype, device="cpu").with_params(pseq=(up, bp),
                                                                                      pseq_constraints=sc)
        b = RigidBody(body.center.to(dtype), body.orientation.to(dtype))
        if path == "pairs":
            val = e(b)
        elif path == "block":
            nbl = tnb.block_neighbor_list_for_topology(top, trna2.default_neighbor_cutoff(), block_size=B,
                                                       init_centers=b.center, perm=tnb.strand_interleave_perm(top),
                                                       symmetric=False)
            val = e.with_props(block_ids=nbl.idx, block_size=B, block_perm=nbl.perm)(b)
        else:
            _, sim = build_sim(top, KT, model="rna2", init_centers=body.center.float(),
                               init_orientation=body.orientation.float(), device="cpu")
            ctx = ts.prepare_stencil_context(e, sim.band, dtype=dtype)
            assert ctx.branch == "rna2_pseq" and ctx.hbf.shape == (10, N)
            com, quat = Vec3(*ctx.to_slots(b.center.T)), Quat(*ctx.to_slots(b.orientation.T))
            val = ts._unbonded_energy(ctx, com, quat, ctx.params) + ts.bonded_energy(ctx, com, quat, ctx.params)
        g_up, g_bp = torch.autograd.grad(val, (up, bp))
        out[path] = (float(val.detach()), g_up.numpy(), g_bp.numpy())
    return out


def test_rna2_pseq_energies_and_sequence_gradients():
    """On a 0.01-jittered 40-bp A-form duplex (38 constrained base pairs, 4
    unpaired nucleotides): the oxRNA2 pseq energy and its gradient in both
    pseq arrays on the pair list, the block sums and the stencil's plain
    versions, against the reference's pair-list pseq energy and its
    ``jax.grad`` (float64: rtol 1e-6, atol 1e-6 x max|grad|; the band's
    polynomial arccos differs from arccos by ~1e-8). One-hot pseq equals the
    discrete sequence's pair-list energy (rel 1e-10 on the pair list, 1e-6
    on the others, float64). The rna2
    stacking's ``ss_stack_weights`` take oxRNA2's temperature law, as the
    reference's."""
    c, q = _jittered(11)
    up, bp = _pseq(7)
    top_j, _ = jax_duplex(N_BP, form="A")
    sc_j = _constraints(jsc)
    e_j = jrna2.create_default_energy_fn(top_j)
    body_j = JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))
    ref_e, (ref_up, ref_bp) = jax.jit(jax.value_and_grad(
        lambda u, b: _jax_with_pseq(e_j, (u, b), sc_j)(body_j), argnums=(0, 1)))(jnp.asarray(up), jnp.asarray(bp))
    ref_up, ref_bp = np.asarray(ref_up), np.asarray(ref_bp)
    scale = max(np.abs(ref_up).max(), np.abs(ref_bp).max())

    top, _ = synthetic_duplex(N_BP, form="A", device="cpu")
    sc = _constraints(tsc)
    body = RigidBody(torch.as_tensor(c), torch.as_tensor(q))
    for path, (val, g_up, g_bp) in _paths(top, body, (up, bp), sc, torch.float64).items():
        np.testing.assert_allclose(val, float(ref_e), rtol=1e-6, err_msg=path)
        for got, want in ((g_up, ref_up), (g_bp, ref_bp)):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale, err_msg=path)

    onehot = tsc.dseq_to_pseq(np.asarray(top.seq), sc)
    e = trna2.create_default_energy_fn(top, dtype=torch.float64, device="cpu")
    for path, (val, _, _) in _paths(top, body, onehot, sc, torch.float64).items():
        np.testing.assert_allclose(val, float(e(body)), rtol=1e-10 if path == "pairs" else 1e-6, err_msg=path)

    table = np.arange(16, dtype=np.float64).reshape(4, 4) / 10 + 1.0
    p_j = jrna2.StackingConfiguration(**{k: v for k, v in e_j.energy_fns[2].params.items()
                                         if k in jrna2.StackingConfiguration.required_params},
                                      ss_stack_weights=jnp.asarray(table)).init_params()
    p_t = e.energy_fns[2].params.replace(ss_stack_weights=torch.as_tensor(table)).init_params()
    np.testing.assert_allclose(p_t.eps_stack.numpy(), np.asarray(p_j.eps_stack), rtol=1e-12)


def _reference_run(pseq):
    """The reference's pair-list run under one pseq: 20 steps at kT 0 of
    the 40-bp A-form duplex, a state every 10 (float32)."""
    sc_j = _constraints(jsc)
    jax.config.update("jax_enable_x64", False)
    try:
        pseq_j = tuple(jnp.asarray(x, jnp.float32) for x in pseq)
        top_j, body_j = jax_duplex(N_BP, form="A")
        body32 = JaxRigidBody(center=jnp.asarray(body_j.center, jnp.float32),
                              orientation=jnp.asarray(body_j.orientation, jnp.float32))
        _, sim = _build_sim(top_j, 0.0, mode="pairs", model="rna2")
        sim = sim.replace(energy_fn=_jax_with_pseq(sim.energy_fn, pseq_j, sc_j), save_every=10)
        out = jax.jit(lambda p: sim.run(p, body32, 20, jax.random.PRNGKey(3)))(sim.energy_fn.opt_params())
        return out.observables[0], {k: np.asarray(v) for k, v in sim.energy_fn.opt_params().items()}
    finally:
        jax.config.update("jax_enable_x64", True)


def test_rna2_pseq_runs_match_reference_pair_list():
    """20 steps at kT 0 under one pseq (a state every 10), float32, rtol
    1e-4 / atol 1e-5 against the reference's pair-list run: the oxRNA2
    stencil on its per-step branch (K2's rna2 pseq instance -- its plain
    version here -- once for the initial force and once a step, K1 never;
    K1 refuses the pseq, ERR_MS_PSEQ), the block tier (the block sums, no
    tile kernel) and PairSimulator on the static pair list."""
    pseq = _pseq(3)
    ref, params = _reference_run(pseq)
    sc = _constraints(tsc)
    pseq_t = tuple(torch.as_tensor(x, dtype=torch.float32) for x in pseq)
    top, body = synthetic_duplex(N_BP, form="A", dtype=torch.float32, device="cpu")
    opt = params_from_numpy(params)
    calls, plain_k2 = [], ts.field_grads

    def counted(ctx, dyn):
        calls.append(ctx.branch)
        return plain_k2(ctx, dyn)

    for mode in ("stencil", "block", "pairs"):
        kw = dict(init_orientation=body.orientation) if mode == "stencil" else {}
        e, sim = build_sim(top, 0.0, mode=mode, model="rna2", init_centers=body.center, neighbor_update_every=5,
                           device="cpu", **kw)
        sim = sim.replace(energy_fn=e.with_params(pseq=pseq_t, pseq_constraints=sc), save_every=10)
        ts.field_grads = counted
        try:
            got = sim.run(opt, body, 20, torch.Generator().manual_seed(0)).observables[0]
        finally:
            ts.field_grads = plain_k2
        for field in ("center", "orientation"):
            a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
            assert a.shape == b.shape == (2, N, 3 if field == "center" else 4)
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=f"{mode} {field}")
        if mode != "pairs":
            assert not bool(torch.as_tensor(got.metadata["neighbor_overflow"]).any())
    assert calls == ["rna2_pseq"] * 21
    _, sim = build_sim(top, 0.0, model="rna2", init_centers=body.center, init_orientation=body.orientation,
                       device="cpu")
    ctx = ts.prepare_stencil_context(sim.energy_fn.with_params(pseq=pseq_t, pseq_constraints=sc), sim.band)
    ou = ts.ou_constants(5e-3, 0.0, [1.0], [(1.0, 1.0, 1.0)], [0.0], [0.0]).vector("cpu")
    with pytest.raises(ValueError, match=ts.ERR_MS_PSEQ):
        ts.multistep_chunk(ctx, ou, torch.zeros((5, 6, N), dtype=torch.bfloat16), torch.zeros((19, N)))


def test_rna2_difftre_sequence_gradient_matches_jax():
    """d loss / d (up_pseq, bp_pseq) of the reweighted propeller-twist loss
    on 4 given 0.01-jittered states under oxRNA2: ``DiffTReObjective``
    with ``opt_params={"pseq": (up, bp)}`` on the map through the energy's
    own non-symmetric block table (the block sums, the factorized hb
    weights) against ``jax.grad`` of the same loss on the reference's
    pair-list ``map`` (float64): loss rtol 1e-10, gradients rtol 1e-5, atol
    1e-6 x the largest."""
    c, q = _jittered(5, lead=(4,))
    up, bp = _pseq(9)
    target = 21.7
    bps = np.array([[i, N - 1 - i] for i in range(N_BP)], np.int32)
    top_j, _ = jax_duplex(N_BP, form="A")
    sc_j = _constraints(jsc)
    e_pair = jrna2.create_default_energy_fn(top_j)
    obs_j = JaxPropellerTwist(rigid_body_transform_fn=jrna2.default_transform_fn(),
                              h_bonded_base_pairs=jnp.asarray(bps))
    states_j = JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))

    def loss_j(u, b):
        new_e = _jax_with_pseq(e_pair, (u, b), sc_j).map(states_j)
        w, _ = jax_weights(1.0 / KT, new_e, jax.lax.stop_gradient(new_e))
        return (target - jnp.sum(w * obs_j(states_j))) ** 2

    l_j, g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(jnp.asarray(up), jnp.asarray(bp))

    top, _ = synthetic_duplex(N_BP, form="A", device="cpu")
    sc = _constraints(tsc)
    pseq0 = tuple(torch.as_tensor(x) for x in (up, bp))
    nbl = tnb.block_neighbor_list_for_topology(top, trna2.default_neighbor_cutoff(), block_size=B,
                                               init_centers=torch.as_tensor(c[0]), symmetric=False)
    e = trna2.create_default_energy_fn(top, dtype=torch.float64, device="cpu", block_unbonded=True, block_size=B)
    e = e.with_props(block_ids=nbl.idx).with_params(pseq=pseq0, pseq_constraints=sc)
    obs = ObservableLossFn(observable=PropellerTwist(rigid_body_transform_fn=trna2.default_transform_soa_fn(),
                                                     h_bonded_base_pairs=torch.as_tensor(bps)),
                           loss_fn=SquaredError(), return_observable=True)

    def grad_or_loss_fn(ref_states, weights, *_):
        loss, measured = obs(ref_states, target, weights)
        return loss, (("propeller_twist", measured), None)

    objective = DiffTReObjective(name="design", required_observables=("traj",), grad_or_loss_fn=grad_or_loss_fn,
                                 energy_fn=e)
    traj = SimulatorTrajectory(center=torch.as_tensor(c), orientation=torch.as_tensor(q),
                               temperature=torch.full((4,), KT, dtype=torch.float64))
    out = objective.calculate({"traj": traj}, opt_params={"pseq": pseq0})
    assert out.is_ready
    np.testing.assert_allclose(float(out.observables["loss"]), float(l_j), rtol=1e-10)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in g_j)
    assert isinstance(out.grads["pseq"], tuple) and scale > 0
    for got, want in zip(out.grads["pseq"], g_j, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6 * scale)
