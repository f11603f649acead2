"""PyTorch port (mythos_tpu_torch): the oxNA hybrid (na1) -- the hybrid
terms' 2-way bonded and 4-way unbonded selects over the port's dna1, dna2
and rna2 terms, on pair lists and block tables -- against the JAX package.

The golden na1 systems are absent here, so the inputs are synthetic: a
20-bp duplex of one DNA strand and one RNA strand and a DNA/DNA one, each
jittered from a seed. The terms are composed as tests/test_na1_soa.py
composes them (the reference has no ``create_default_energy_fn`` for
na1). Energies and forces in float64 against the reference's pair path,
rtol 1e-6 (XLA-CPU transcendentals are float32-accurate even under x64);
the run in float32 at kT 0 against TpuSimulator over its
FixedCapacityNeighborList, rtol 1e-4 / atol 1e-5. One JAX run compile in
the file.
"""

import dataclasses as dc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.na1 as jna1  # noqa: E402
import mythos_tpu_torch.energy.na1 as tna1  # noqa: E402
from mythos_tpu import spaces  # noqa: E402
from mythos_tpu.energy.base import ComposedEnergyFunction as JaxComposed  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.simulators import StaticSimulatorParams, TpuSimulator  # noqa: E402
from mythos_tpu.simulators import neighbors as jnb  # noqa: E402
from mythos_tpu_torch.energy.base import ComposedEnergyFunction, params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.io.topology import NucleotideType  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators import cuda as tcuda  # noqa: E402
from mythos_tpu_torch.simulators import neighbors as tnb  # noqa: E402
from mythos_tpu_torch.simulators.neighbors import dense_pair_mask  # noqa: E402

N_BP = 20
N = 2 * N_BP
B = 8
KT = 296.15 * 0.1 / 300.0
SALT = 0.5
#: the cutoff of the block tables and pair lists: every hybrid term's site
#: cutoff plus twice the largest site offset of either geometry
R_CUT = 6.5
SYSTEMS = {
    "dna-rna": [NucleotideType.DNA] * N_BP + [NucleotideType.RNA] * N_BP,
    "dna-dna": [NucleotideType.DNA] * N,
}


def _shared(key: str) -> dict:
    return {"stacking": {"kt": KT}, "debye": {"kt": KT, "salt_conc": SALT}}.get(key, {})


def _jax_energy(nt_type):
    """The reference's composed na1 energy on the synthetic duplex."""
    top, _ = jax_duplex(N_BP)
    top = dc.replace(top, nt_type=np.asarray(nt_type, np.int32))
    _, params = jna1.default_configs()
    fns = []
    for key, port_cls, port_cfg in tna1.TERMS:
        cls, cfg_cls = getattr(jna1, port_cls.__name__), getattr(jna1, port_cfg.__name__)
        kwargs = dict(params[key]) | _shared(key) | {"nt_type": jnp.asarray(top.nt_type)}
        if key == "debye":
            kwargs["half_charged_ends"] = True
        fns.append(cls(params=cfg_cls(**kwargs).init_params(), displacement_fn=spaces.free()[0],
                       transform_fn=jna1.default_transform_fn(), topology=top))
    return top, JaxComposed(energy_fns=fns)


def _port_energy(nt_type, dtype=torch.float64):
    """The port's composed na1 energy (the package docstring's recipe)."""
    top, _ = synthetic_duplex(N_BP, device="cpu")
    top = dc.replace(top, nt_type=np.asarray(nt_type, np.int32))
    _, params = tna1.default_configs()
    fns = []
    for key, cls, cfg_cls in tna1.TERMS:
        values = params_from_numpy(params[key] | _shared(key), "cpu", dtype)
        extra = {"half_charged_ends": True} if key == "debye" else {}
        cfg = cfg_cls(**values, nt_type=top.nt_type, **extra)
        fns.append(cls(cfg.init_params(), top, tna1.default_transform_soa_fn()))
    return top, ComposedEnergyFunction(fns)


def _jittered(seed: int, scale: float = 0.02):
    _, body = jax_duplex(N_BP)
    rng = np.random.default_rng(seed)
    c = np.asarray(body.center, np.float64) + scale * rng.standard_normal((N, 3))
    q = np.asarray(body.orientation, np.float64) + scale * rng.standard_normal((N, 4))
    return c, q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_na1_terms_and_forces_match_reference(system):
    """Per-term na1 energies and the forces (d E / d com, d E / d quat) on
    a 0.02-jittered 20-bp duplex (DNA/RNA hybrid, DNA/DNA), float64: the
    port's pair path (every unbonded pair, and a FixedCapacityNeighborList's
    padded list) and its block path (the block sums on a non-symmetric
    table, over the strand interleave too) against the reference's pair
    path, rtol 1e-6 (forces atol 1e-8 x the largest). The merged default
    tables equal the reference's; the hybrid refuses a dense mask."""
    nt = SYSTEMS[system]
    c, q = _jittered(3 if system == "dna-rna" else 4)
    top_j, e_j = _jax_energy(nt)
    jbody = JaxRigidBody(center=jnp.asarray(c), orientation=jnp.asarray(q))
    want = np.asarray(e_j.compute_terms(jbody))
    g_j = jax.grad(lambda b: e_j(b), allow_int=True)(jbody)
    g_want = np.concatenate([np.asarray(g_j.center), np.asarray(g_j.orientation)], -1)

    _, p_t = tna1.default_configs()
    _, p_j = jna1.default_configs()
    for key, _, _ in tna1.TERMS:
        assert set(p_t[key]) == set(p_j[key])
        for k, v in p_t[key].items():
            np.testing.assert_allclose(float(v), float(p_j[key][k]), rtol=1e-12, err_msg=k)

    top, e = _port_energy(nt)
    cut = max(fn.pair_cutoff() for fn in e.energy_fns if hasattr(fn, "pair_energies"))
    assert cut + 2.0 * 0.75 < R_CUT
    fixed = tnb.neighbor_list_for_topology(top, R_CUT, init_centers=torch.as_tensor(c))
    tables = {
        "pairs": e,
        "fixed": e.with_props(unbonded_neighbors=fixed.idx),
        "block": e.with_props(block_ids=tnb.block_neighbor_list_for_topology(
            top, R_CUT, block_size=B, init_centers=torch.as_tensor(c), symmetric=False).idx, block_size=B),
    }
    inter = tnb.block_neighbor_list_for_topology(top, R_CUT, block_size=B, init_centers=torch.as_tensor(c),
                                                 perm=tnb.strand_interleave_perm(top), symmetric=False)
    tables["interleave"] = e.with_props(block_ids=inter.idx, block_size=B, block_perm=inter.perm)
    for path, energy in tables.items():
        body = RigidBody(torch.as_tensor(c).requires_grad_(True), torch.as_tensor(q).requires_grad_(True))
        got = energy.compute_terms(body)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-12, err_msg=path)
        g = torch.cat(torch.autograd.grad(got.sum(), (body.center, body.orientation)), -1).numpy()
        np.testing.assert_allclose(g, g_want, rtol=1e-6, atol=1e-8 * np.abs(g_want).max(), err_msg=path)
    assert not bool(fixed.did_overflow)
    with pytest.raises(ValueError, match="dense"):
        e.with_props(dense_mask=dense_pair_mask(top))(RigidBody(torch.as_tensor(c), torch.as_tensor(q)))


def test_na1_pair_simulator_matches_reference():
    """A 20-step run of the DNA/RNA hybrid at kT 0 from a 0.01-jittered
    duplex (float32), every state saved, the FixedCapacityNeighborList
    rebuilt every 5 steps: PairSimulator against TpuSimulator's generic
    branch over the reference's list, rtol 1e-4 / atol 1e-5, equal
    ``neighbor_overflow``; then the same system on the block tier
    (BlockSimulator, the block sums, no tile kernel) against the same
    reference."""
    nt = SYSTEMS["dna-rna"]
    c, q = _jittered(5, scale=0.01)
    jax.config.update("jax_enable_x64", False)
    try:
        top_j, e_j = _jax_energy(nt)
        c32, q32 = jnp.asarray(c, jnp.float32), jnp.asarray(q, jnp.float32)
        nbl_j = jnb.neighbor_list_for_topology(spaces.free()[0], top_j, R_CUT, init_centers=c32)
        sim_j = TpuSimulator(
            energy_fn=e_j,
            simulator_params=StaticSimulatorParams(
                seq=jnp.asarray(top_j.seq),
                mass=JaxRigidBody(center=jnp.array([1.0]), orientation=jnp.array([[1.0, 1.0, 1.0]])),
                gamma=JaxRigidBody(center=jnp.array([0.0]), orientation=jnp.array([0.0])),
                bonded_neighbors=jnp.asarray(top_j.bonded_neighbors), checkpoint_every=0, dt=5e-3, kT=0.0),
            space=spaces.free(), neighbors=nbl_j, save_every=1, neighbor_update_every=5,
        )
        params = {k: np.asarray(v) for k, v in e_j.opt_params().items()}
        ref = jax.jit(lambda p: sim_j.run(p, JaxRigidBody(center=c32, orientation=q32), 20,
                                          jax.random.PRNGKey(0)))(e_j.opt_params()).observables[0]
        ref_overflow = bool(np.asarray(ref.metadata["neighbor_overflow"]).any())
    finally:
        jax.config.update("jax_enable_x64", True)

    top, e = _port_energy(nt, torch.float32)
    body = RigidBody(torch.as_tensor(c, dtype=torch.float32), torch.as_tensor(q, dtype=torch.float32))
    fixed = tnb.neighbor_list_for_topology(top, R_CUT, init_centers=body.center)
    assert fixed.capacity == int(nbl_j.capacity)
    opt = params_from_numpy({k: v for k, v in params.items() if k in e.opt_params()})
    assert set(opt) == set(e.opt_params())
    sims = {
        "pairs": tcuda.PairSimulator(energy_fn=e, neighbors=fixed, dt=5e-3, kT=0.0, neighbor_update_every=5),
        "block": tcuda.BlockSimulator(
            energy_fn=e, dt=5e-3, kT=0.0, save_every=1, neighbor_update_every=5,
            neighbors=tnb.block_neighbor_list_for_topology(top, R_CUT, block_size=B, init_centers=body.center,
                                                           perm=tnb.strand_interleave_perm(top), symmetric=False)),
    }
    for name, sim in sims.items():
        got = sim.run(opt, body, 20, torch.Generator().manual_seed(0)).observables[0]
        for field in ("center", "orientation"):
            a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
            assert a.shape == b.shape == (20, N, 3 if field == "center" else 4)
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=f"{name} {field}")
        assert bool(torch.as_tensor(got.metadata["neighbor_overflow"]).any()) is ref_overflow is False
    assert not sims["block"].uses_kernels()
