"""PyTorch port (mythos_tpu_torch): probabilistic sequences (sequence
design) under oxDNA1 and oxDNA2 -- the sequence tables, constraints and
files, the pseq energies and their gradients in the sequence distribution
on every tier, pseq runs, and d loss / d bp_pseq of DiffTRe -- against
the JAX package.

The JAX side is its XLA paths, never Pallas interpret mode: the pair-list
pseq energy (float64) and its ``jax.grad`` as the reference for every
tier, ``TpuSimulator`` on its pair list and on a single-level
non-symmetric table (its XLA tile path) in float32, and the reweighted
loss on the pair-list ``map``. Four items, so that pytest-xdist's
``loadfile`` schedule runs the file beside the long ones (ROADMAP, "Test
time").
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.dna1 as jdna1  # noqa: E402
import mythos_tpu.energy.dna2 as jdna2  # noqa: E402
import mythos_tpu.io.sequence_constraints as jsc  # noqa: E402
import mythos_tpu.io.sequence_dependence as jsd  # noqa: E402
import mythos_tpu.io.topology as jtop  # noqa: E402
import mythos_tpu_torch.energy.dna1 as tdna1  # noqa: E402
import mythos_tpu_torch.energy.dna2 as tdna2  # noqa: E402
import mythos_tpu_torch.io.sequence_constraints as tsc  # noqa: E402
import mythos_tpu_torch.io.sequence_dependence as tsd  # noqa: E402
import mythos_tpu_torch.io.topology as ttop  # noqa: E402
from __graft_entry__ import _build_sim  # noqa: E402
from mythos_tpu import spaces  # noqa: E402
from mythos_tpu.energy import seqdep as jseqdep  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.observables import PropellerTwist as JaxPropellerTwist  # noqa: E402
from mythos_tpu.optimization.objective import compute_weights_and_neff as jax_weights  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.simulators import StaticSimulatorParams, TpuSimulator  # noqa: E402
from mythos_tpu.simulators import neighbors as jnb  # noqa: E402
from mythos_tpu_torch.energy import seqdep  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.entry import build_sim  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.losses import ObservableLossFn, SquaredError  # noqa: E402
from mythos_tpu_torch.observables import PropellerTwist  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
from mythos_tpu_torch.ops import tiles  # noqa: E402
from mythos_tpu_torch.optimization import DiffTReObjective  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators import neighbors as tnb  # noqa: E402
from mythos_tpu_torch.simulators.io import SimulatorTrajectory  # noqa: E402
from mythos_tpu_torch.simulators.neighbors import dense_pair_mask  # noqa: E402
from mythos_tpu_torch.soa import Quat, Vec3, to_soa  # noqa: E402

N_BP = 16
N = 2 * N_BP
KT = 296.15 * 0.1 / 300.0
PKGS = {"dna1": (jdna1, tdna1), "dna2": (jdna2, tdna2)}


def _constraints(module):
    """All but the two outermost base pairs constrained; four nucleotides
    unpaired, so that both pseq arrays take part."""
    return module.from_bps(N, np.array([[i, N - 1 - i] for i in range(1, N_BP - 1)]))


def _pseq(seed: int):
    rng = np.random.default_rng(seed)
    sc = _constraints(tsc)
    up, bp = rng.random((sc.n_unpaired, 4)), rng.random((sc.n_bp, 4))
    return up / up.sum(1, keepdims=True), bp / bp.sum(1, keepdims=True)


def _jittered(seed: int, n_states: int | None = None):
    _, body = jax_duplex(N_BP)
    rng = np.random.default_rng(seed)
    lead = () if n_states is None else (n_states,)
    c = np.asarray(body.center) + 0.01 * rng.standard_normal((*lead, N, 3))
    q = np.asarray(body.orientation) + 0.01 * rng.standard_normal((*lead, N, 4))
    return c, q / np.linalg.norm(q, axis=-1, keepdims=True)


def _jax_with_pseq(efn, pseq, sc):
    return efn.replace(energy_fns=[
        fn.replace(params=fn.params.replace(pseq=pseq, pseq_constraints=sc).init_params())
        if hasattr(fn.params, "pseq") else fn for fn in efn.energy_fns
    ])


def test_sequence_tables_constraints_and_files(tmp_path):
    """The numpy half of sequence design against the reference (float64,
    rtol 1e-12): ``from_bps`` (every field), its five refusals and
    ``SequenceConstraints``' two, ``dseq_to_pseq`` and its refusal of a
    non-bonding pair; the topology's pseq checks with the reference's
    error strings; the marginals, ``pair_weights`` on every pair (i != j)
    and ``factorized_weights``, also against a brute-force enumeration of
    the sequences of a 4-nt system; and ``read_ss_weights`` of a file
    written here, oxDNA's and an oxRNA table with the G-U wobble and no
    STCK_FACT_EPS."""
    bps = np.array([[0, 11], [2, 9], [3, 8]])
    sc_j, sc_t = jsc.from_bps(12, bps), tsc.from_bps(12, bps)
    for f in ("n_nucleotides", "n_unpaired", "n_bp", "is_unpaired", "unpaired", "bps", "idx_to_unpaired_idx",
              "idx_to_bp_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(sc_t, f)), np.asarray(getattr(sc_j, f)), err_msg=f)
    for bad, msg in ((np.zeros((3,), int), tsc.ERR_INVALID_BP_SHAPE),
                     (np.array([[0, 1], [1, 2]]), tsc.ERR_BP_DUPLICATES), (np.array([[0, 12]]), tsc.ERR_BP_RANGE),
                     (np.zeros((7, 2), int), tsc.ERR_INVALID_BP_SHAPE),
                     (np.array([[0, 1, 2]]), tsc.ERR_INVALID_BP_SHAPE)):
        with pytest.raises(ValueError) as got:
            tsc.from_bps(12, bad)
        with pytest.raises(ValueError) as want:
            jsc.from_bps(12, bad)
        assert str(got.value) == str(want.value) == msg
    kw = dict(n_nucleotides=4, is_unpaired=np.ones(4), unpaired=np.arange(4), bps=np.zeros((0, 2), int),
              idx_to_unpaired_idx=np.arange(4), idx_to_bp_idx=-np.ones((4, 2), int))
    with pytest.raises(ValueError, match=tsc.ERR_COUNTS):
        tsc.SequenceConstraints(n_unpaired=3, n_bp=0, **kw)
    with pytest.raises(ValueError, match=tsc.ERR_COVER):
        tsc.SequenceConstraints(n_unpaired=4, n_bp=0, **{**kw, "unpaired": np.array([0, 1, 2, 2])})
    dseq = np.array([0, 1, 2, 1, 3, 0, 1, 2, 2, 1, 0, 3])
    for a, b in zip(tsc.dseq_to_pseq(dseq, sc_t), jsc.dseq_to_pseq(dseq, sc_j), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match=tsc.ERR_INVALID_BP):
        tsc.dseq_to_pseq(np.zeros(12, int), sc_t)

    up, bp = _normalised(np.random.default_rng(4), sc_t)
    for seq in ((up, bp[:2]), (up[:, :3], bp), (up, bp[:, :3]), (-up, bp), (2 * up, bp), np.zeros((12, 4)), [0, 1]):
        with pytest.raises(ValueError) as got:
            ttop.check_valid_seq(seq, 12)
        with pytest.raises(ValueError) as want:
            jtop.check_valid_seq(seq, 12)
        assert str(got.value) == str(want.value)
    ttop.check_valid_seq((up, bp), 12)

    table = np.random.default_rng(5).random((4, 4))
    pseq_t, pseq_j = (torch.as_tensor(up), torch.as_tensor(bp)), (jnp.asarray(up), jnp.asarray(bp))
    np.testing.assert_allclose(seqdep.nucleotide_marginals(pseq_t, sc_t).numpy(),
                               np.asarray(jseqdep.nucleotide_marginals(pseq_j, sc_j)), rtol=1e-12)
    ii, jj = np.nonzero(~np.eye(12, dtype=bool))
    want = np.asarray(jseqdep.pair_weights(pseq_j, ii, jj, jnp.asarray(table), sc_j))
    np.testing.assert_allclose(seqdep.pair_weights(pseq_t, ii, jj, torch.as_tensor(table), sc_t).numpy(), want,
                               rtol=1e-12)
    left, right, partner, corr = seqdep.factorized_weights(pseq_t, torch.as_tensor(table), sc_t)
    for a, b in zip((left, right, corr), [jseqdep.factorized_weights(pseq_j, jnp.asarray(table), sc_j)[k]
                                          for k in (0, 1, 3)], strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-15)
    dense = (left @ right.T).numpy() + np.where(np.arange(12)[None] == partner[:, None], corr.numpy()[:, None], 0.0)
    np.testing.assert_allclose(dense[ii, jj], want, rtol=1e-12)
    sc4 = tsc.from_bps(4, np.array([[0, 3]]))
    up4, bp4 = _normalised(np.random.default_rng(6), sc4)
    brute = np.zeros((4, 4))
    for t, (b0, b3) in enumerate(np.array([[0, 3], [3, 0], [2, 1], [1, 2]])):
        for s1 in range(4):
            for s2 in range(4):
                p, s = bp4[0, t] * up4[0, s1] * up4[1, s2], (b0, s1, s2, b3)
                brute += p * table[np.array(s)[:, None], np.array(s)[None, :]]
    i4, j4 = np.nonzero(~np.eye(4, dtype=bool))
    np.testing.assert_allclose(seqdep.pair_weights((torch.as_tensor(up4), torch.as_tensor(bp4)), i4, j4,
                                                   torch.as_tensor(table), sc4).numpy(), brute[i4, j4], rtol=1e-12)

    lines = [f"STCK_{a}_{b} = {1.0 + 0.1 * i + 0.01 * j:.4f}"
             for i, a in enumerate("ACGT") for j, b in enumerate("ACGT")]
    for text in ("\n".join([*lines, "HYDR_A_T = 0.88", "HYDR_C_G = 1.23f", "STCK_FACT_EPS = 0.18", ""]),
                 "\n".join([*lines, "HYDR_T_A = 0.9", "HYDR_G_C = 1.2", "HYDR_G_T = 0.5"])):
        path = tmp_path / "weights.txt"
        path.write_text(text)
        got, want = tsd.read_ss_weights(path), jsd.read_ss_weights(str(path))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-12)


def _normalised(rng, sc):
    up, bp = rng.random((sc.n_unpaired, 4)), rng.random((sc.n_bp, 4))
    return up / up.sum(1, keepdims=True), bp / bp.sum(1, keepdims=True)


def _port_paths(model: str, top, body, pseq, sc, dtype):
    """{path: (energy, d/d up_pseq, d/d bp_pseq)} of the port: the pair
    list, the dense mask, the tiles (K4's plain version forward, K5's and
    params_grad's backward, on the block tier's symmetric table over the
    strand interleave) and the stencil's plain versions (the band and the
    bonded terms over the slots)."""
    _, tpkg = PKGS[model]
    out = {}
    for path in ("pairs", "dense", "tiles", "stencil"):
        up, bp = (torch.tensor(x, dtype=dtype, requires_grad=True) for x in pseq)
        e = tpkg.create_default_energy_fn(top, dtype=dtype, device="cpu").with_params(pseq=(up, bp),
                                                                                     pseq_constraints=sc)
        b = RigidBody(body.center.to(dtype), body.orientation.to(dtype))
        if path == "pairs":
            val = e(b)
        elif path == "dense":
            val = e.with_props(dense_mask=dense_pair_mask(top))(b)
        elif path == "tiles":
            nbl = tnb.block_neighbor_list_for_topology(top, tpkg.default_neighbor_cutoff(), block_size=8,
                                                       init_centers=b.center, perm=tnb.strand_interleave_perm(top))
            ctxs = tiles.prepare_contexts(e, nbl.idx, nbl.block_size, perm=nbl.perm)
            assert all(c.spec.pseq == (c.spec.kind != "debye") for c in ctxs)
            val = tiles.fused_energy_ctx(e, ctxs, to_soa(b), nbl.idx)
        else:
            _, sim = build_sim(top, KT, model=model, init_centers=body.center.float(),
                               init_orientation=body.orientation.float(), device="cpu")
            ctx = ts.prepare_stencil_context(e, sim.band, dtype=dtype)
            assert ctx.pseq and ctx.hbf.shape == (10, N)
            com, quat = Vec3(*ctx.to_slots(b.center.T)), Quat(*ctx.to_slots(b.orientation.T))
            val = ts._unbonded_energy(ctx, com, quat, ctx.params) + ts.bonded_energy(ctx, com, quat, ctx.params)
        g_up, g_bp = torch.autograd.grad(val, (up, bp))
        out[path] = (float(val.detach()), g_up.numpy(), g_bp.numpy())
    return out


def test_pseq_energies_and_sequence_gradients_on_every_tier():
    """Under oxDNA1 and oxDNA2, the pseq energy and its gradient in both pseq arrays on a jittered
    16-bp duplex (14 constrained base pairs, 4 unpaired nucleotides) on
    the pair list, the dense mask, the tile plain versions and the stencil
    plain versions, against the reference's pair-list pseq energy and its
    ``jax.grad`` (float64). Float64: rtol 1e-6 on energies and gradients
    (atol 1e-6 x max|grad|: the tiles' and the band's polynomial arccos
    differ from arccos by ~1e-8 in these sums). Float32: the reference's
    own limits (tests/test_pseq_paths.py:165-196), rtol 5e-6 on the energy,
    atol 5e-5 x max|grad|. One-hot pseq equals the discrete sequence on
    every path within rel 1e-5 (float32). K5's plain version gives 21
    fields under pseq, each equal to autograd of K4's plain version through
    rows and columns (float64, 1e-12 x max)."""
    for model in sorted(PKGS):
        _check_tiers(model)


def _check_tiers(model: str) -> None:
    jpkg, tpkg = PKGS[model]
    c, q = _jittered(11)
    up, bp = _pseq(7)
    top_j, _ = jax_duplex(N_BP)
    sc_j = _constraints(jsc)
    e_j = jpkg.create_default_energy_fn(top_j)
    body_j = JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))
    ref_e, (ref_up, ref_bp) = jax.jit(jax.value_and_grad(
        lambda u, b: _jax_with_pseq(e_j, (u, b), sc_j)(body_j), argnums=(0, 1)))(jnp.asarray(up), jnp.asarray(bp))
    ref_e, ref_up, ref_bp = float(ref_e), np.asarray(ref_up), np.asarray(ref_bp)
    scale = max(np.abs(ref_up).max(), np.abs(ref_bp).max())

    top, _ = synthetic_duplex(N_BP, device="cpu")
    sc = _constraints(tsc)
    body = RigidBody(torch.as_tensor(c), torch.as_tensor(q))
    for dtype, e_tol, g_tol in ((torch.float64, 1e-6, 1e-6), (torch.float32, 5e-6, 5e-5)):
        for path, (val, g_up, g_bp) in _port_paths(model, top, body, (up, bp), sc, dtype).items():
            np.testing.assert_allclose(val, ref_e, rtol=e_tol, err_msg=f"{path} {dtype}")
            for got, want in ((g_up, ref_up), (g_bp, ref_bp)):
                np.testing.assert_allclose(got, want, rtol=e_tol, atol=g_tol * scale, err_msg=f"{path} {dtype}")

    onehot = tsc.dseq_to_pseq(np.asarray(top.seq), sc)
    pseq_paths = _port_paths(model, top, body, onehot, sc, torch.float32)
    b32 = RigidBody(body.center.float(), body.orientation.float())
    e = tpkg.create_default_energy_fn(top, device="cpu")
    nbl = tnb.block_neighbor_list_for_topology(top, tpkg.default_neighbor_cutoff(), block_size=8,
                                               init_centers=b32.center, perm=tnb.strand_interleave_perm(top))
    _, sim = build_sim(top, KT, model=model, init_centers=b32.center, init_orientation=b32.orientation, device="cpu")
    ctx = ts.prepare_stencil_context(e, sim.band)
    com, quat = Vec3(*ctx.to_slots(b32.center.T)), Quat(*ctx.to_slots(b32.orientation.T))
    discrete = {
        "pairs": e(b32), "dense": e.with_props(dense_mask=dense_pair_mask(top))(b32),
        "tiles": tiles.fused_energy_ctx(e, tiles.prepare_contexts(e, nbl.idx, 8, perm=nbl.perm), to_soa(b32), nbl.idx),
        "stencil": ts._unbonded_energy(ctx, com, quat, ctx.params) + ts.bonded_energy(ctx, com, quat, ctx.params),
    }
    for path, val in discrete.items():
        np.testing.assert_allclose(pseq_paths[path][0], float(val), rtol=1e-5, err_msg=path)

    e64 = tpkg.create_default_energy_fn(top, dtype=torch.float64, device="cpu").with_params(
        pseq=tuple(torch.as_tensor(x) for x in (up, bp)), pseq_constraints=sc)
    ctx = tiles.prepare_contexts(e64, nbl.idx, 8, perm=nbl.perm)[0]
    ids = tiles.pad_ids(ctx.spec, tiles._as_tables(nbl.idx)[0])
    rows = tiles.dynamic_rows(ctx, to_soa(body)).detach()
    gt = torch.tensor([0.9, 1.3, 0.7, 1.1, 0.8], dtype=torch.float64)[: len(ctx.spec.terms)]
    k5 = tiles.tile_row_grads_plain(rows, ctx.params, ids, gt, ctx.spec)
    r = rows.clone().requires_grad_(True)
    sums = tiles._masked_sums(r, tiles._gather_cols(r, ids, ctx.spec), ctx.params, ctx.spec, triangular=True)
    (want,) = torch.autograd.grad((gt * torch.stack(sums)).sum(), r)
    assert k5.shape == (ctx.spec.n_pad, 21) and ctx.spec.n_grad_fields == 21
    np.testing.assert_allclose(k5.numpy(), want[:, :21].numpy(), rtol=1e-12, atol=1e-12 * float(want.abs().max()))


def _pseq_sim_runs():
    """The reference's runs under one pseq, 20 steps at kT = 0, a state
    every 10 (float32): oxDNA1 on its pair list (TpuSimulator with
    NoNeighborList), the reference for the port's stencil -- its own XLA
    stencil cannot run a pseq under ``jax.jit`` with this JAX: it reads its
    partner table with ``np.asarray`` inside the traced run
    (mythos_tpu/ops/oxdna_tiles.py:1509, a TracerArrayConversionError) --
    and oxDNA2's block tier, rebuild every 5, on a single-level
    non-symmetric table (its XLA tile path)."""
    up, bp = _pseq(3)
    sc_j = _constraints(jsc)
    pseq_j = (jnp.asarray(up, jnp.float32), jnp.asarray(bp, jnp.float32))
    top_j, body_j = jax_duplex(N_BP)
    body32 = JaxRigidBody(center=jnp.asarray(body_j.center, jnp.float32),
                          orientation=jnp.asarray(body_j.orientation, jnp.float32))
    _, sim = _build_sim(top_j, 0.0, mode="pairs", model="dna1")
    sim = sim.replace(energy_fn=_jax_with_pseq(sim.energy_fn, pseq_j, sc_j), save_every=10)
    stencil = jax.jit(lambda p: sim.run(p, body32, 20, jax.random.PRNGKey(3)))(sim.energy_fn.opt_params())
    e_blk = _jax_with_pseq(jdna2.create_default_energy_fn(top_j, block_unbonded=True, block_size=8), pseq_j, sc_j)
    nbl = jnb.block_neighbor_list_for_topology(spaces.free()[0], top_j, jdna2.default_neighbor_cutoff(),
                                               dr_threshold=0.5, block_size=8, init_centers=body_j.center)
    sim_b = TpuSimulator(
        energy_fn=e_blk,
        simulator_params=StaticSimulatorParams(
            seq=jnp.asarray(top_j.seq),
            mass=JaxRigidBody(center=jnp.array([1.0]), orientation=jnp.array([[1.0, 1.0, 1.0]])),
            gamma=JaxRigidBody(center=jnp.array([0.0]), orientation=jnp.array([0.0])),
            bonded_neighbors=jnp.asarray(top_j.bonded_neighbors), checkpoint_every=0, dt=5e-3, kT=0.0),
        space=spaces.free(), neighbors=nbl, save_every=10, neighbor_update_every=5,
    )
    block = jax.jit(lambda p: sim_b.run(p, body32, 20, jax.random.PRNGKey(0)))(e_blk.opt_params())
    return (up, bp), {"stencil": (stencil.observables[0], sim.energy_fn.opt_params()),
                      "block": (block.observables[0], e_blk.opt_params())}


def test_pseq_runs_match_jax_tpu_simulator():
    """20 steps at kT 0 under one pseq (16 bp, rebuild every 5, a state
    every 10), float32, rtol 1e-4 / atol 1e-5 against the reference: the
    stencil (oxDNA1) on its per-step branch at save_every 10 -- K2 (its
    plain version here) once for the initial force and once a step, K1
    never, as the reference's generic branch -- against the reference's
    pair list (the band drops only exact zeros; its polynomial arccos moves
    the states by ~1e-6), and the block tier
    (oxDNA2, symmetric tables, K3's pseq plain version). K1's entry points
    and its Function refuse a pseq (ERR_MS_PSEQ), as the reference's."""
    jax.config.update("jax_enable_x64", False)
    try:
        pseq, runs = _pseq_sim_runs()
    finally:
        jax.config.update("jax_enable_x64", True)
    sc = _constraints(tsc)
    pseq_t = tuple(torch.as_tensor(x, dtype=torch.float32) for x in pseq)
    top, body = synthetic_duplex(N_BP, dtype=torch.float32, device="cpu")
    calls, plain_k2 = [], ts.field_grads
    for mode, model in (("stencil", "dna1"), ("block", "dna2")):
        ref, params = runs[mode]
        kw = dict(init_orientation=body.orientation) if mode == "stencil" else {}
        e, sim = build_sim(top, 0.0, mode=mode, model=model, init_centers=body.center, neighbor_update_every=5,
                           device="cpu", **kw)
        sim = sim.replace(energy_fn=e.with_params(pseq=pseq_t, pseq_constraints=sc), save_every=10)
        opt = params_from_numpy({k: np.asarray(v) for k, v in params.items()})

        def counted(ctx, dyn):
            calls.append(ctx.branch)
            return plain_k2(ctx, dyn)

        ts.field_grads = counted
        try:
            got = sim.run(opt, body, 20, torch.Generator().manual_seed(0)).observables[0]
        finally:
            ts.field_grads = plain_k2
        for field in ("center", "orientation"):
            a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
            assert a.shape == b.shape == (2, N, 3 if field == "center" else 4)
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=f"{mode} {field}")
        assert not bool(torch.as_tensor(got.metadata["neighbor_overflow"]).any())
    assert calls == ["dna1_pseq"] * 21

    e, sim = build_sim(top, 0.0, model="dna1", init_centers=body.center, init_orientation=body.orientation,
                       device="cpu")
    ctx = ts.prepare_stencil_context(e.with_params(pseq=pseq_t, pseq_constraints=sc), sim.band)
    state = torch.zeros((19, N))
    noise = torch.zeros((5, 6, N), dtype=torch.bfloat16)
    ou = ts.ou_constants(5e-3, 0.0, [1.0], [(1.0, 1.0, 1.0)], [0.0], [0.0]).vector("cpu")
    for call in (lambda: ts.multistep_chunk(ctx, ou, noise, state),
                 lambda: ts.MultistepChunk.apply(state, ctx.params, ctx.wstack, ou, noise, ctx)):
        with pytest.raises(ValueError, match=ts.ERR_MS_PSEQ):
            call()


def test_difftre_sequence_gradient_matches_jax():
    """d loss / d (up_pseq, bp_pseq) of the reweighted propeller-twist loss
    on 4 given jittered 16-bp states under oxDNA1 (no simulation):
    ``DiffTReObjective.calculate`` with ``opt_params={"pseq": (up, bp)}``
    on the tile map (K4, backward K5's 21 fields, plain versions here; the
    table in the original order) against ``jax.grad`` of the same loss on
    the reference's pair-list ``map``, float64, loss rtol 1e-10 and
    gradients rtol 1e-5, atol 1e-6 x the largest (as
    test_torch_difftre.py). Direct differentiation: a bp_pseq that needs a
    gradient reaches a loss of a 10-step kT-0 run through FieldGrads (the
    stencil's per-step branch, oxDNA1) and through TileForces (the block
    tier, oxDNA1), the two within 1e-3 x the largest of each other
    (float32: the band and the tiles order their sums differently), and a
    context that hides it raises."""
    c, q = _jittered(5, n_states=4)
    up, bp = _pseq(9)
    target = 21.7
    bps = np.array([[i, N - 1 - i] for i in range(N_BP)], np.int32)
    top_j, _ = jax_duplex(N_BP)
    sc_j = _constraints(jsc)
    e_pair = jdna1.create_default_energy_fn(top_j)
    obs_j = JaxPropellerTwist(rigid_body_transform_fn=jdna1.default_transform_fn(),
                              h_bonded_base_pairs=jnp.asarray(bps))
    states_j = JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))

    def loss_j(u, b):
        new_e = _jax_with_pseq(e_pair, (u, b), sc_j).map(states_j)
        w, _ = jax_weights(1.0 / KT, new_e, jax.lax.stop_gradient(new_e))
        return (target - jnp.sum(w * obs_j(states_j))) ** 2

    l_j, g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(jnp.asarray(up), jnp.asarray(bp))

    top, _ = synthetic_duplex(N_BP, device="cpu")
    sc = _constraints(tsc)
    pseq0 = tuple(torch.as_tensor(x) for x in (up, bp))
    e = tdna1.create_default_energy_fn(top, dtype=torch.float64, device="cpu").with_params(pseq=pseq0,
                                                                                          pseq_constraints=sc)
    nbl = tnb.block_neighbor_list_for_topology(top, tdna1.default_neighbor_cutoff(), block_size=8,
                                               init_centers=torch.as_tensor(c[0]))
    obs = ObservableLossFn(observable=PropellerTwist(rigid_body_transform_fn=tdna1.default_transform_soa_fn(),
                                                     h_bonded_base_pairs=torch.as_tensor(bps)),
                           loss_fn=SquaredError(), return_observable=True)

    def grad_or_loss_fn(ref_states, weights, *_):
        loss, measured = obs(ref_states, target, weights)
        return loss, (("propeller_twist", measured), None)

    objective = DiffTReObjective(name="design", required_observables=("traj",), grad_or_loss_fn=grad_or_loss_fn,
                                 energy_fn=e.replace(map_neighbors=nbl))
    traj = SimulatorTrajectory(center=torch.as_tensor(c), orientation=torch.as_tensor(q),
                               temperature=torch.full((4,), KT, dtype=torch.float64))
    out = objective.calculate({"traj": traj}, opt_params={"pseq": pseq0})
    assert out.is_ready
    np.testing.assert_allclose(float(out.observables["loss"]), float(l_j), rtol=1e-10)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in g_j)
    assert isinstance(out.grads["pseq"], tuple) and scale > 0
    for got, want in zip(out.grads["pseq"], g_j, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6 * scale)

    top32, body = synthetic_duplex(N_BP, dtype=torch.float32, device="cpu")
    grads = {}
    for mode in ("stencil", "block"):
        kw = dict(init_orientation=body.orientation) if mode == "stencil" else {}
        e32, sim = build_sim(top32, 0.0, mode=mode, model="dna1", init_centers=body.center, neighbor_update_every=5,
                             device="cpu", **kw)
        b_leaf = torch.tensor(bp, dtype=torch.float32, requires_grad=True)
        pseq = (torch.tensor(up, dtype=torch.float32), b_leaf)
        sim = sim.replace(energy_fn=e32.with_params(pseq=pseq, pseq_constraints=sc), save_every=5)
        traj = sim.run({"pseq": pseq}, body, 10, torch.Generator().manual_seed(0)).observables[0]
        twist = obs.observable(RigidBody(traj.center, traj.orientation)).mean()
        (grads[mode],) = torch.autograd.grad((twist - target) ** 2, b_leaf)
        assert torch.isfinite(grads[mode]).all() and float(grads[mode].abs().max()) > 0
    np.testing.assert_allclose(grads["stencil"].numpy(), grads["block"].numpy(), rtol=1e-3,
                               atol=1e-3 * float(grads["block"].abs().max()))

    ctx = ts.prepare_stencil_context(e32.with_params(pseq=(torch.tensor(up, dtype=torch.float32),
                                                           torch.tensor(bp, dtype=torch.float32, requires_grad=True)),
                                                     pseq_constraints=sc),
                                     build_sim(top32, 0.0, model="dna1", init_centers=body.center,
                                               init_orientation=body.orientation, device="cpu")[1].band)
    dyn = torch.cat([body.center.T, body.orientation.T]).float()
    with pytest.raises(ValueError, match="hbf needs a gradient"):
        ts.FieldGrads.apply(dyn, ctx.params, ctx)
    assert ts.FieldGrads.apply(dyn, ctx.params, ctx, ctx.hbf).shape == (7, N)
    ctxs = tiles.prepare_contexts(e32.with_params(pseq=(torch.tensor(up, dtype=torch.float32),
                                                        torch.tensor(bp, dtype=torch.float32, requires_grad=True)),
                                                  pseq_constraints=sc), nbl.idx, 8)
    with pytest.raises(ValueError, match="create_graph=True"):
        tiles.fused_grads_ctx(e32, ctxs, to_soa(body), nbl.idx)
