"""PyTorch port (mythos_tpu_torch): the oxDNA1 stencil run as a whole --
``build_sim(mode="stencil", model="dna1")`` on its chunk path (K1's plain
version) and on its per-step branch (K2's) -- against the JAX TpuSimulator
from ``_build_sim(mode="stencil", model="dna1")``.

JAX runs its XLA per-step stencil (USE_KERNEL / USE_MULTISTEP off, no
Pallas) in float32; the port's kernel wrappers take their plain versions on
CPU tensors. kT = 0 keeps random numbers out of the comparison (rtol 1e-4,
atol 1e-5, as tests/test_torch_sim.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from __graft_entry__ import _build_sim, _tiny_duplex  # noqa: E402
from mythos_tpu.ops import stencil as st  # noqa: E402
from mythos_tpu_torch import entry  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402

N_BP = 40
U = 10
N_STEPS = 40


@pytest.fixture(autouse=True, scope="module")
def _f32_mode():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module", params=[U, 1], ids=["chunks", "per-step"])
def runs(request, _f32_mode):
    """40 steps at kT 0, rebuild every 10, a state every 10 (the chunk path)
    or every step (the per-step branch), both packages; the port's kernel
    launches counted by family."""
    save_every = request.param
    topology, body = _tiny_duplex(N_BP)
    old = (st.USE_KERNEL, st.USE_MULTISTEP)
    st.USE_KERNEL, st.USE_MULTISTEP = False, False
    try:
        _, sim = _build_sim(topology, 0.0, mode="stencil", init_centers=body.center,
                            init_orientation=body.orientation, model="dna1", neighbor_update_every=U)
        sim = sim.replace(save_every=save_every)
        params = sim.energy_fn.opt_params()
        ref = jax.jit(lambda p: sim.run(p, body, N_STEPS, jax.random.PRNGKey(3)))(params).observables[0]
    finally:
        st.USE_KERNEL, st.USE_MULTISTEP = old
    top, tbody = synthetic_duplex(N_BP, dtype=torch.float32, device="cpu")
    _, tsim = entry.build_sim(top, 0.0, model="dna1", init_centers=tbody.center, init_orientation=tbody.orientation,
                              neighbor_update_every=U, device="cpu")
    opt = params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    calls = {"K1": [], "K2": []}
    plain_k2, plain_k1 = ts.field_grads, ts.multistep_chunk

    def k2(ctx, dyn):
        calls["K2"].append(ctx.family)
        return plain_k2(ctx, dyn)

    def k1(ctx, *args):
        calls["K1"].append(ctx.family)
        return plain_k1(ctx, *args)

    ts.field_grads, ts.multistep_chunk = k2, k1
    try:
        got = tsim.replace(save_every=save_every).run(opt, tbody, N_STEPS,
                                                       torch.Generator().manual_seed(0)).observables[0]
    finally:
        ts.field_grads, ts.multistep_chunk = plain_k2, plain_k1
    return save_every, ref, got, calls


def test_dna1_stencil_run_matches_jax_tpu_simulator(runs):
    """Every saved state of CudaSimulator.run under oxDNA1 (the chunk path,
    a state every 10 steps; the per-step branch, every step) equals
    TpuSimulator.run's, rtol 1e-4, atol 1e-5; the overflow flags equal the
    reference's (no overflow); and the run took the dna1 instances: the
    chunk path K2 once (the initial force) and K1 once a chunk, the
    per-step branch K2 once a step and once for the initial force, K1
    never."""
    save_every, ref, got, calls = runs
    for field in ("center", "orientation"):
        a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        assert a.shape == b.shape == (N_STEPS // save_every, 2 * N_BP, 3 if field == "center" else 4)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=field)
    np.testing.assert_array_equal(got.metadata["neighbor_overflow"].numpy(),
                                  np.asarray(ref.metadata["neighbor_overflow"]))
    assert not bool(got.metadata["neighbor_overflow"].any())
    if save_every == 1:
        assert calls == {"K1": [], "K2": ["dna1"] * (N_STEPS + 1)}
    else:
        assert calls == {"K1": ["dna1"] * (N_STEPS // U), "K2": ["dna1"]}
