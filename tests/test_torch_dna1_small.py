"""PyTorch port (mythos_tpu_torch): the small-system path -- the static
pair list (``NoNeighborList``) and the dense masks (``DensePairs``) under
the AoS Langevin integrator (``simulators.cuda.PairSimulator``) -- against
the JAX TpuSimulator in float64.

kT = 0 keeps random numbers out of the runs' comparison. Tolerance rtol
1e-6 (XLA-CPU transcendentals are float32-accurate even under x64).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mythos_tpu_torch import entry  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402

N_BP = 12
N_STEPS = 10


def _jittered(top, body, seed=0, scale=0.01):
    rng = np.random.default_rng(seed)
    c = np.asarray(body.center) + scale * rng.standard_normal(np.shape(body.center))
    q = np.asarray(body.orientation) + scale * rng.standard_normal(np.shape(body.orientation))
    return c, q / np.linalg.norm(q, axis=1, keepdims=True)


def _runs(model, mode):
    """10 steps at kT 0 from a 0.01-jittered 12-bp duplex, every state
    saved, on both sides: TpuSimulator with NoNeighborList or DensePairs
    (``_build_sim``), the port's build_sim (float64, CPU)."""
    from mythos_tpu.rigid_body import RigidBody as JaxRigidBody

    top_j, body_j = graft._tiny_duplex(N_BP)
    c, q = _jittered(top_j, body_j)
    _, sim = graft._build_sim(top_j, 0.0, mode=mode, model=model)
    params = sim.energy_fn.opt_params()
    jbody = JaxRigidBody(center=jax.numpy.asarray(c), orientation=jax.numpy.asarray(q))
    ref = jax.jit(lambda p: sim.run(p, jbody, N_STEPS, jax.random.PRNGKey(0)))(params).observables[0]
    top_t, _ = synthetic_duplex(N_BP, device="cpu")
    _, sim_t = entry.build_sim(top_t, 0.0, mode=mode, model=model, device="cpu", dtype=torch.float64)
    opt = params_from_numpy({k: np.asarray(v) for k, v in params.items()}, dtype=torch.float64)
    got = sim_t.run(opt, RigidBody(torch.as_tensor(c), torch.as_tensor(q)), N_STEPS,
                    torch.Generator().manual_seed(0)).observables[0]
    return ref, got, sim_t


@pytest.mark.parametrize("model", ["dna1", "dna2"])
def test_small_system_run_matches_jax(model):
    """On the pair list and on the dense masks, every one of the 10 states of
    PairSimulator.run equals TpuSimulator's static-neighbour branch, rtol
    1e-6 (atol 1e-9); neither trajectory carries overflow metadata (a
    static list never overflows)."""
    from mythos_tpu_torch.simulators.neighbors import DensePairs, NoNeighborList

    for mode, kind in (("pairs", NoNeighborList), ("dense", DensePairs)):
        ref, got, sim_t = _runs(model, mode)
        assert isinstance(sim_t.neighbors, kind)
        assert not got.metadata and not ref.metadata
        for field in ("center", "orientation"):
            a_, b_ = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
            assert a_.shape == b_.shape == (N_STEPS, 2 * N_BP, 3 if field == "center" else 4)
            np.testing.assert_allclose(a_, b_, rtol=1e-6, atol=1e-9, err_msg=f"{mode} {field}")


def test_build_sim_refuses_rna2_block():
    """The rna2 block tier, which the reference's fused tiles refuse, builds
    on the block sums (one non-symmetric table, no tile kernel); every
    other (mode, model) of the reference builds too."""
    top, body = synthetic_duplex(8, device="cpu")
    _, sim = entry.build_sim(top, 0.1, mode="block", model="rna2", init_centers=body.center, device="cpu")
    assert not sim.uses_kernels() and not sim.neighbors.symmetric
    for model in ("dna1", "dna2", "rna2"):
        for mode in ("pairs", "dense"):
            _, sim = entry.build_sim(top, 0.1, mode=mode, model=model, device="cpu")
            assert sim.save_every == 1


def test_pair_simulator_gradient_flows():
    """The small-system run is differentiable: d (spread of the final z) /
    d eps_stack_base through 5 steps of the dense dna1 path from a jittered
    4-bp duplex is finite and nonzero, and equals a central difference
    (rtol 1e-5, float64, kT 0)."""
    top, body = synthetic_duplex(4, dtype=torch.float64, device="cpu")
    c, q = _jittered(top, body, seed=2, scale=0.05)
    body = RigidBody(torch.as_tensor(c), torch.as_tensor(q))
    e, sim = entry.build_sim(top, 0.0, mode="dense", model="dna1", device="cpu", dtype=torch.float64)

    def loss(p):
        out = sim.run(p, body, 5, torch.Generator().manual_seed(0)).observables[0]
        return out.center[-1, :, 2].var()

    p = {k: v.clone().requires_grad_(True) for k, v in e.opt_params().items()}
    (g,) = torch.autograd.grad(loss(p), p["eps_stack_base"])
    h = 1e-5
    with torch.no_grad():
        up = {**{k: v.detach() for k, v in p.items()}, "eps_stack_base": p["eps_stack_base"].detach() + h}
        dn = {**{k: v.detach() for k, v in p.items()}, "eps_stack_base": p["eps_stack_base"].detach() - h}
        fd = (loss(up) - loss(dn)) / (2 * h)
    assert torch.isfinite(g) and float(g) != 0.0
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-5)
