"""PyTorch port (mythos_tpu_torch): periodic boxes on the small-system
path, against the JAX package.

Every term forms its site differences through its ``displacement_fn``
(``spaces.periodic(box)[0]``): the pair lists, the dense masks and the
bonded terms. The duplex is placed across two faces of a cubic box of 20
and wrapped into it, so that bonds and unbonded pairs straddle the faces.
(1) ``PairSimulator`` over a ``FixedCapacityNeighborList`` (distances by
the same displacement, the shift wrapping each step) against
TpuSimulator's generic branch under the same periodic space, float32, kT
0, rtol 1e-4 / atol 1e-5 after wrapping both (one JAX run compile);
(2) per-term energies and gradients of the dense-mask and pair-list paths
in float64 equal to each other and to the free-space ones of the unwrapped
duplex (the periodic energies against the reference's:
tests/test_torch_overrides.py); (3) the kernel tiers refuse a periodic
space with the reference's words.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny CPU shapes: one thread a worker, no idle pool spinning beside the others

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mythos_tpu.energy.dna2 as jdna2  # noqa: E402
import mythos_tpu_torch.energy.dna1 as tdna1  # noqa: E402
import mythos_tpu_torch.energy.dna2 as tdna2  # noqa: E402
import mythos_tpu_torch.energy.rna2 as trna2  # noqa: E402
from mythos_tpu import spaces as jspaces  # noqa: E402
from mythos_tpu.io.synthetic import synthetic_duplex as jax_duplex  # noqa: E402
from mythos_tpu.rigid_body import RigidBody as JaxRigidBody  # noqa: E402
from mythos_tpu.simulators import StaticSimulatorParams, TpuSimulator  # noqa: E402
from mythos_tpu.simulators import neighbors as jnb  # noqa: E402
from mythos_tpu.simulators import tpu as jtpu  # noqa: E402
from mythos_tpu_torch import entry  # noqa: E402
from mythos_tpu_torch import spaces as tspaces  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators import cuda as tcuda  # noqa: E402
from mythos_tpu_torch.simulators import neighbors as tnb  # noqa: E402

BOX = 20.0
N_BP = 40
N_STEPS = 10
F64 = {"dtype": torch.float64, "device": "cpu"}


def _across_faces(n_bp: int = N_BP, form: str = "B", scale: float = 0.01, seed: int = 0):
    """(centers unwrapped, centers wrapped into the box, unit quats) of the
    duplex jittered by ``scale``, its axis moved onto the box's x face and
    its middle onto the z face, float64 numpy."""
    _, body = jax_duplex(n_bp, form=form)
    rng = np.random.default_rng(seed)
    c = np.asarray(body.center, np.float64) + scale * rng.standard_normal(np.shape(body.center))
    q = np.asarray(body.orientation, np.float64) + scale * rng.standard_normal(np.shape(body.orientation))
    c = c + np.array([BOX - 0.3, 0.5 * BOX, BOX - 0.5 * float(c[:, 2].max())])
    return c, np.mod(c, BOX), q / np.linalg.norm(q, axis=1, keepdims=True)


def test_periodic_pair_simulator_matches_reference():
    """A 10-step oxDNA2 run at kT 0 of the 40-bp duplex across two faces,
    every state saved, the list rebuilt every 5 steps: PairSimulator
    (``space=spaces.periodic(20)``, the energy's and the list's
    displacement periodic) against TpuSimulator with the reference's
    periodic space (float32, rtol 1e-4, atol 1e-5, positions wrapped into
    the box), with the same list capacity and no overflow; the bonds
    crossing a face are stretched by no more than the FENE range."""
    _, c, q = _across_faces()
    jax.config.update("jax_enable_x64", False)
    try:
        top_j, _ = jax_duplex(N_BP)
        c32, q32 = jnp.asarray(c, jnp.float32), jnp.asarray(q, jnp.float32)
        disp_j = jspaces.periodic(BOX)[0]
        e_j = jdna2.create_default_energy_fn(top_j, displacement_fn=disp_j)
        nbl_j = jnb.neighbor_list_for_topology(disp_j, top_j, jdna2.default_neighbor_cutoff(), init_centers=c32)
        sim_j = TpuSimulator(
            energy_fn=e_j,
            simulator_params=StaticSimulatorParams(
                seq=jnp.asarray(top_j.seq),
                mass=JaxRigidBody(center=jnp.array([1.0]), orientation=jnp.array([[1.0, 1.0, 1.0]])),
                gamma=JaxRigidBody(center=jnp.array([0.0]), orientation=jnp.array([0.0])),
                bonded_neighbors=jnp.asarray(top_j.bonded_neighbors), checkpoint_every=0, dt=5e-3, kT=0.0),
            space=jspaces.periodic(BOX), neighbors=nbl_j, save_every=1, neighbor_update_every=5,
        )
        params = e_j.opt_params()
        ref = jax.jit(lambda p: sim_j.run(p, JaxRigidBody(center=c32, orientation=q32), N_STEPS,
                                          jax.random.PRNGKey(0)))(params).observables[0]
        ref_overflow = bool(np.asarray(ref.metadata["neighbor_overflow"]).any())
    finally:
        jax.config.update("jax_enable_x64", True)

    top_t, _ = synthetic_duplex(N_BP, device="cpu")
    space = tspaces.periodic(BOX)
    body = RigidBody(torch.as_tensor(c, dtype=torch.float32), torch.as_tensor(q, dtype=torch.float32))
    e_t = tdna2.create_default_energy_fn(top_t, displacement_fn=space[0], device="cpu")
    nbl = tnb.neighbor_list_for_topology(top_t, tdna2.default_neighbor_cutoff(e_t), init_centers=body.center,
                                         displacement_fn=space[0])
    assert nbl.capacity == int(nbl_j.capacity)
    np.testing.assert_array_equal(nbl.idx.numpy(), np.asarray(nbl_j.idx))
    sim = tcuda.PairSimulator(energy_fn=e_t, neighbors=nbl, dt=5e-3, kT=0.0, neighbor_update_every=5, space=space)
    opt = params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    got = sim.run(opt, body, N_STEPS, torch.Generator().manual_seed(0)).observables[0]
    assert got.center.shape == (N_STEPS, 2 * N_BP, 3)
    assert bool(((got.center >= 0) & (got.center < BOX)).all())
    ref_c = np.asarray(ref.center, np.float64)
    # a coordinate within float32 rounding of a face may wrap to either side
    dc = np.mod(got.center.numpy() - ref_c + 0.5 * BOX, BOX) - 0.5 * BOX
    np.testing.assert_allclose(dc, 0.0, atol=1e-5 + 1e-4 * BOX)
    np.testing.assert_allclose(got.orientation.numpy(), np.asarray(ref.orientation), rtol=1e-4, atol=1e-5)
    assert bool(torch.as_tensor(got.metadata["neighbor_overflow"]).any()) is ref_overflow is False
    bonds = torch.as_tensor(top_t.bonded_neighbors).long()
    last = got.center[-1].double()
    across = (last[bonds[:, 0]] - last[bonds[:, 1]]).abs().amax(-1) > 0.5 * BOX
    span = space[0](last[bonds[:, 0]], last[bonds[:, 1]]).norm(dim=-1)
    assert bool(across.any()) and float(span.max()) < 1.0


def test_periodic_energies_match_free_space():
    """The port alone, float64, the duplex jittered by 0.02 across two faces
    of the box, wrapped into it: oxDNA2, oxDNA1 and oxRNA2 (A-form, 20
    bp). Under ``spaces.periodic(20)`` each term's energy and its gradients
    (positions, quaternions) on the dense masks equal those on the pair
    lists, and both equal the free-space ones of the unwrapped duplex (rtol
    1e-9, atol 1e-9 of the term's largest gradient). The periodic energies
    against the reference's, under the constructors' options:
    tests/test_torch_overrides.py."""
    for name, tpkg, form, n_bp in (("dna2", tdna2, "B", N_BP), ("dna1", tdna1, "B", N_BP), ("rna2", trna2, "A", 20)):
        unwrapped, c, q = _across_faces(n_bp, form, scale=0.02)
        top, _ = synthetic_duplex(n_bp, form=form, **F64)
        assert bool((np.abs(c - unwrapped) > 0.5 * BOX).any()), name  # the duplex crosses a face
        runs = {}
        for key, pos, disp, dense in (("free", unwrapped, None, False), ("pairs", c, tspaces.periodic(BOX)[0], False),
                                      ("dense", c, tspaces.periodic(BOX)[0], True)):
            kw = {} if disp is None else {"displacement_fn": disp}
            e = tpkg.create_default_energy_fn(top, dense_unbonded=dense, **kw, **F64)
            body = RigidBody(torch.tensor(pos, requires_grad=True), torch.tensor(q, requires_grad=True))
            terms = e.compute_terms(body)
            grads = [torch.autograd.grad(v, (body.center, body.orientation), retain_graph=True, allow_unused=True)
                     for v in terms]
            runs[key] = (terms.detach().numpy(), [[None if g is None else g.numpy() for g in gs] for gs in grads])
        ref_e, ref_g = runs["free"]
        assert float(ref_e[0]) > 0.0 and np.isfinite(ref_e).all()
        for key in ("pairs", "dense"):
            got_e, got_g = runs[key]
            np.testing.assert_allclose(got_e, ref_e, rtol=1e-9, atol=1e-12, err_msg=f"{name} {key}")
            for k, (gs, rs) in enumerate(zip(got_g, ref_g, strict=True)):
                for a, (g, r) in enumerate(zip(gs, rs, strict=True)):
                    r = np.zeros_like(g) if r is None else r
                    g = np.zeros_like(r) if g is None else g
                    np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-9 * max(float(np.abs(r).max()), 1e-12),
                                               err_msg=f"{name} {key} term {k} d/d{('center', 'orientation')[a]}")


def test_kernel_tiers_refuse_periodic_space():
    """The stencil (K1, K2) and the tile kernels (K3) compute free-space
    displacements: CudaSimulator refuses a periodic space, or an energy
    whose terms carry a periodic displacement, with the reference's
    ERR_STENCIL; BlockSimulator with ERR_PERIODIC_FUSED on a symmetric
    table (dna2) and ERR_PERIODIC_SOA on the block sums' table (rna2), as
    the reference's SoA hot path; PairSimulator takes it."""
    top, body = synthetic_duplex(20, dtype=torch.float32, device="cpu")
    space = tspaces.periodic(BOX)
    e, sim = entry.build_sim(top, 0.1, init_centers=body.center, init_orientation=body.orientation, device="cpu")
    for make in (lambda: sim.replace(space=space),
                 lambda: sim.replace(energy_fn=tdna2.create_default_energy_fn(top, displacement_fn=space[0],
                                                                              device="cpu"))):
        with pytest.raises(ValueError) as err:
            make()
        assert str(err.value) == jtpu.ERR_STENCIL == tcuda.ERR_STENCIL
    _, blk = entry.build_sim(top, 0.1, mode="block", init_centers=body.center, device="cpu")
    with pytest.raises(ValueError) as err:
        blk.replace(space=space)
    assert str(err.value) == jtpu.ERR_PERIODIC_FUSED
    top_a, body_a = synthetic_duplex(20, form="A", dtype=torch.float32, device="cpu")
    _, blk_a = entry.build_sim(top_a, 0.1, mode="block", model="rna2", init_centers=body_a.center, device="cpu")
    with pytest.raises(ValueError) as err:
        blk_a.replace(space=space)
    assert str(err.value) == jtpu.ERR_PERIODIC_SOA
    _, pairs = entry.build_sim(top, 0.1, mode="pairs", device="cpu")
    assert pairs.replace(space=space).space is space
