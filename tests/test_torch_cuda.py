"""PyTorch port (mythos_tpu_torch): the CUDA kernels K1 and K2 against
their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU
mode) and skips without one. This file imports no JAX, so it also runs on
a machine without it; there, run it without the JAX-specific conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K2 rtol 1e-4 with atol 1e-4 x max|twin| (f32 sums in another
order, hand-written vs autograd derivatives); K1 over 4 steps rtol 2e-4,
atol 5e-5 (as tests/test_multistep.py holds the Pallas kernel).
"""

import pytest

torch = pytest.importorskip("torch")

from mythos_tpu_torch.entry import build_sim  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402

KT = 296.15 * 0.1 / 300.0


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def system(card):
    top, body = synthetic_duplex(40, dtype=torch.float32, device=card)
    e, sim = build_sim(top, KT, init_centers=body.center, init_orientation=body.orientation, device=card)
    ctx = ts.prepare_stencil_context(e, sim.band, device=card)
    return e, sim, ctx, body


@pytest.mark.cuda
def test_k2_kernel_matches_twin(system):
    _, _, ctx, body = system
    dyn = torch.cat([ctx.to_slots(body.center.T), ctx.to_slots(body.orientation.T)]).contiguous()
    before = ts.field_grads.launches
    got = ts.field_grads(ctx, dyn)
    ref = ts.field_grads_plain(ctx, dyn)
    torch.cuda.synchronize()
    assert ts.field_grads.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
def test_k1_kernel_matches_twin(system):
    _, sim, ctx, body = system
    gen = torch.Generator(device="cuda").manual_seed(0)
    # off the ideal lattice: there the stacked neighbours' a3.a3 sits exactly
    # at the arccos clamp, where the derivative jumps (both sides round it)
    q = body.orientation + 0.01 * torch.randn(body.orientation.shape, generator=gen, device="cuda")
    c = body.center + 0.01 * torch.randn(body.center.shape, generator=gen, device="cuda")
    state = sim.initial_state(ctx, RigidBody(c, q / q.norm(dim=-1, keepdim=True)), gen)
    noise = torch.randn((4, 6, ctx.n), generator=gen, device="cuda").to(torch.bfloat16)
    ou = ts.ou_constants(sim.dt, sim.kT, [1.0], [[1.0, 1.0, 1.0]], [sim.gamma_t], [sim.gamma_r]).vector("cuda")
    got = ts.multistep_chunk(ctx, ou, noise, state)
    ref = ts.multistep_chunk_plain(ctx, ou, noise, state)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=5e-5)


@pytest.mark.cuda
def test_k2_autograd_backward_goes_through_twin(system):
    """FieldGrads: kernel forward, twin double-backward."""
    _, _, ctx, body = system
    dyn = torch.cat([ctx.to_slots(body.center.T), ctx.to_slots(body.orientation.T)]).contiguous()
    dyn = dyn.clone().requires_grad_(True)
    params = ctx.params.clone().requires_grad_(True)
    out = ts.FieldGrads.apply(dyn, params, ctx)
    (g,) = torch.autograd.grad(out[:3].sum(), params)
    ref = ts.field_grads_plain(ctx, dyn.detach().requires_grad_(True), params, create_graph=True)
    (g_ref,) = torch.autograd.grad(ref[:3].sum(), params)
    torch.testing.assert_close(g, g_ref)


@pytest.mark.cuda
def test_simulator_on_card_matches_cpu_twins(card):
    """The whole slice: 40 bp, 4 chunks, thermostat off -- the run on the
    card (K1/K2) agrees with the same run on the CPU twins."""

    def run(device):
        top, b = synthetic_duplex(40, dtype=torch.float32, device=device)
        e, sim = build_sim(top, 0.0, init_centers=b.center, init_orientation=b.orientation,
                           neighbor_update_every=10, device=device)
        out = sim.replace(save_every=10).run(e.opt_params(), b, 40, torch.Generator(device=device).manual_seed(0))
        return out.observables[0]

    gpu, cpu = run(card), run("cpu")
    torch.testing.assert_close(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
    assert not bool(gpu.metadata["neighbor_overflow"].any())
