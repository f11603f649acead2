"""PyTorch port (mythos_tpu_torch): the CUDA kernels K1-K6 against their
plain PyTorch versions, on the card (K1 and K2 in both model families,
oxDNA2 and oxRNA2).

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU
mode) and skips without one. This file imports no JAX, so it also runs on
a machine without it; there, run it without the JAX-specific conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K2, K3, K4 and K5 rtol 1e-4 with atol 1e-4 x max|twin| (f32
sums in another order, hand-written vs autograd derivatives); K1 over 4
steps rtol 2e-4, atol 5e-5 (as tests/test_multistep.py holds the Pallas
kernel); K5's body fields against K3 rtol 1e-5, atol 5e-6 (as the
reference's test_fused_grads_soa_matches_grad_of_energy); K3, K4 and K5's
tallies of their pairs equal the plain gate's (tile_gate_counts, the
triangular mask for K4); K6's energy rtol 2e-5 (as tests/test_ops.py
holds the Pallas kernel), its position and box gradients rtol 2e-4 with
atol 1e-4 x max|plain| (also with the beads permuted, with the box and
positions scaled, and in a box too wide for floor(box / LJ_CELL) cells a
side), its cells exactly; K1, K3, K4, K5 and K6 give equal bits on a
second call; the MARTINI runs card vs CPU rtol 1e-4, atol 1e-5. The
oxRNA2 instances of K1 and K2 as oxDNA2's, on the 40-bp A-form duplex,
K2 also on coaxially stacked pairs (coaxial stacking alone), and a 40-bp
oxRNA2 run card vs CPU. K2 in both families, ideal, jittered and (oxRNA2)
coaxially stacked: its tally of the band pairs by gate equals the plain
gate's (band_gate_counts), two calls give equal bits; a per-step run
(save_every 1) of n steps launches K2 n + 1 times and K1 never, and
agrees with the CPU (rtol 1e-4, atol 1e-5). Direct differentiation
through a run (K1 and K2 forward, their plain versions backward): the
gradient of a loss through one 40-step chunk at kT 0 from a jittered state
agrees with the CPU in both families (loss rtol 1e-5, gradients rtol 1e-2 /
atol 1e-3 max|grad|), and a chunk-path and a checkpointed per-step grad
evaluation launch K1 and K2 as the same runs without gradients do (the
backward only K2 again, where it recomputes a checkpointed interval).
Direct differentiation through the block tier and MARTINI NPT (K3 and K6
forward, their plain versions backward): the VJPs of ``TileForces`` (every
kind) and ``LJGrads`` on the card against the CPU (rtol 1e-3, atol 1e-4 x
max|CPU|), a 40-bp block gradient and the 104-bead bilayer's NPT gradient
card vs CPU (gradients rtol 1e-2 / atol 1e-3 max|grad|), and runs with
gradients giving the bits and launches of the runs without them. oxDNA1:
K2's and K1's dna1 instances as oxRNA2's (K2's tally with no Debye class,
coaxial stacking alone on pairs inside coax's reach), K3's dna1 instance
on the one-level table, 40-bp stencil (both branches) and block runs card
vs CPU with their launches, the small-system path card vs CPU (pairs and
dense) and entry()'s step on the card. Probabilistic sequences: the pseq
instances of K2 (oxDNA1, oxDNA2) and of K3, K4 and K5 (K5's 21 fields)
against their plain versions with their tallies, equal bits on a second
call, each launch counted for the instance; on the one-hot pseq of the
duplex's sequence each within K2's tolerance of its discrete instance,
which counts its launches under the family alone; and 40-bp pseq runs of
the stencil (the per-step branch, K1 never) and the block tier card vs
CPU. oxRNA2's pseq instance of K2 likewise, and on the one-hot pseq the
discrete instance's bits; the block tier of oxRNA2 and of the oxNA hybrid
(the plain block sums) card vs CPU, K3 never launched.
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mythos_tpu_torch.energy.martini.systems import default_bilayer_terms, lattice_bilayer  # noqa: E402
from mythos_tpu_torch.entry import build_sim  # noqa: E402
from mythos_tpu_torch.io.synthetic import coax_engaged, synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
from mythos_tpu_torch.ops import lj, tiles  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators.martini import MartiniSimulator  # noqa: E402
from mythos_tpu_torch.soa import to_soa  # noqa: E402

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
    # deterministic: a fixed reduction order, no atomics
    assert torch.equal(got, ts.multistep_chunk(ctx, ou, noise, state))
    # an odd number of steps ends with the positions in the second buffer
    odd = noise[:3].contiguous()
    torch.testing.assert_close(ts.multistep_chunk(ctx, ou, odd, state), ts.multistep_chunk_plain(ctx, ou, odd, state),
                               rtol=2e-4, atol=5e-5)


@pytest.fixture(scope="module")
def rna2_system(card):
    top, body = synthetic_duplex(40, form="A", dtype=torch.float32, device=card)
    e, sim = build_sim(top, KT, model="rna2", init_centers=body.center, init_orientation=body.orientation,
                       device=card)
    ctx = ts.prepare_stencil_context(e, sim.band, device=card)
    return e, sim, ctx, body


def _jittered(body, gen, scale=0.01):
    q = body.orientation + scale * torch.randn(body.orientation.shape, generator=gen, device=body.center.device)
    c = body.center + scale * torch.randn(body.center.shape, generator=gen, device=body.center.device)
    return RigidBody(c, q / q.norm(dim=-1, keepdim=True))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["jittered", "coax"])
def test_k2_rna2_kernel_matches_twin(rna2_system, case):
    """K2's oxRNA2 instance against its plain version: the jittered A-form
    duplex (every term), and three coaxially stacked pairs placed in with
    every term weight but coax's 0 (oxDNA1's coax is zero in a duplex)."""
    import dataclasses as dc

    _, _, ctx, body = rna2_system
    if case == "jittered":
        b = _jittered(body, torch.Generator(device="cuda").manual_seed(3))
        dyn = torch.cat([ctx.to_slots(b.center.T), ctx.to_slots(b.orientation.T)]).contiguous()
    else:
        com, quat = (ctx.to_slots(x.T.double()).T.cpu().numpy() for x in (body.center, body.orientation))
        com, quat = coax_engaged(com, quat, [(10, 11), (30, 33), (50, 57)], seed=3)
        dyn = torch.as_tensor(np.concatenate([com.T, quat.T]), dtype=torch.float32, device="cuda").contiguous()
        params = ctx.params.clone()
        off = ts.param_offsets()["GT"]
        params[off : off + 8] = torch.tensor([0, 0, 0, 1, 0, 0, 0, 0], dtype=torch.float32)
        ctx = dc.replace(ctx, params=params)
    before = dict(ts.field_grads.by_family)
    got = ts.field_grads(ctx, dyn)
    ref = ts.field_grads_plain(ctx, dyn)
    torch.cuda.synchronize()
    assert ts.field_grads.by_family == {**before, "rna2": before["rna2"] + 1}
    assert float(ref.abs().max()) > 1.0
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
    assert torch.equal(got, ts.field_grads(ctx, dyn))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dna2 ideal", "dna2 jittered", "rna2 ideal", "rna2 jittered", "rna2 coax"])
def test_k2_gate_tally_and_bits(system, rna2_system, case):
    """K2 against its plain version (rtol 1e-4, atol 1e-4 max|plain|), its
    tally of the band pairs by gate equal to band_gate_counts', equal bits
    on a second call, one launch counted for the family."""
    import dataclasses as dc

    family, state = case.split()
    _, _, ctx, body = system if family == "dna2" else rna2_system
    if state == "coax":
        com, quat = (ctx.to_slots(x.T.double()).T.cpu().numpy() for x in (body.center, body.orientation))
        com, quat = coax_engaged(com, quat, [(10, 11), (30, 33), (50, 57)], seed=3)
        dyn = torch.as_tensor(np.concatenate([com.T, quat.T]), dtype=torch.float32, device="cuda").contiguous()
        params = ctx.params.clone()
        off = ts.param_offsets()["GT"]
        params[off : off + 8] = torch.tensor([0, 0, 0, 1, 0, 0, 0, 0], dtype=torch.float32)
        ctx = dc.replace(ctx, params=params)
    else:
        b = body if state == "ideal" else _jittered(body, torch.Generator(device="cuda").manual_seed(5))
        dyn = torch.cat([ctx.to_slots(b.center.T), ctx.to_slots(b.orientation.T)]).contiguous()
    before = dict(ts.field_grads.by_family)
    got, tally = ts._field_grads(ctx, dyn, count=True)
    assert ts.field_grads.by_family == {**before, family: before[family] + 1}
    ref = ts.field_grads_plain(ctx, dyn)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
    assert tally == ts.band_gate_counts(ctx, dyn)
    assert tally["short"] > 0 and tally["debye"] > 0
    assert torch.equal(got, ts.field_grads(ctx, dyn))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["dna2", "rna2"])
def test_per_step_run_on_card_matches_cpu(card, model):
    """The per-step branch (save_every 1): 40 bp, 20 steps, rebuild every 5,
    thermostat off -- K2 launched once for the initial force and once a
    step, K1 never, and every emitted state agrees with the CPU."""
    form = "B" if model == "dna2" else "A"

    def run(device):
        top, b = synthetic_duplex(40, form=form, dtype=torch.float32, device=device)
        e, sim = build_sim(top, 0.0, model=model, init_centers=b.center, init_orientation=b.orientation,
                           neighbor_update_every=5, device=device)
        out = sim.replace(save_every=1).run(e.opt_params(), b, 20, torch.Generator(device=device).manual_seed(0))
        return out.observables[0]

    k2, k1 = dict(ts.field_grads.by_family), ts.multistep_chunk.launches
    gpu = run(card)
    torch.cuda.synchronize()
    assert ts.field_grads.by_family == {**k2, model: k2[model] + 21}
    assert ts.multistep_chunk.launches == k1
    cpu = run("cpu")
    assert gpu.center.shape == (20, 80, 3)
    torch.testing.assert_close(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
    assert not bool(gpu.metadata["neighbor_overflow"].any())


@pytest.mark.cuda
def test_k1_rna2_kernel_matches_twin(rna2_system):
    """K1's oxRNA2 instance against its plain version over 4 and 3 steps
    (rtol 2e-4, atol 5e-5), equal bits on a second call, one launch counted
    for the family a call; the exact checks widened to every in-band offset
    (d_lo 1), so that row 19 counts the helix's own contacts on the (a1, a3)
    backbone."""
    import dataclasses as dc

    _, sim, ctx, body = rna2_system
    checks = ctx.checks.clone()
    checks[:, 3] = 1.0
    ctx = dc.replace(ctx, checks=checks)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = sim.initial_state(ctx, _jittered(body, gen), gen)
    noise = torch.randn((4, 6, ctx.n), generator=gen, device="cuda").to(torch.bfloat16)
    ou = ts.ou_constants(sim.dt, sim.kT, [1.0], [[1.0, 1.0, 1.0]], [sim.gamma_t], [sim.gamma_r]).vector("cuda")
    before = dict(ts.multistep_chunk.by_family)
    got = ts.multistep_chunk(ctx, ou, noise, state)
    assert ts.multistep_chunk.by_family == {**before, "rna2": before["rna2"] + 1}
    ref = ts.multistep_chunk_plain(ctx, ou, noise, state)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=5e-5)
    assert float(ref[19].sum()) > 0
    assert torch.equal(got, ts.multistep_chunk(ctx, ou, noise, state))
    odd = noise[:3].contiguous()
    torch.testing.assert_close(ts.multistep_chunk(ctx, ou, odd, state), ts.multistep_chunk_plain(ctx, ou, odd, state),
                               rtol=2e-4, atol=5e-5)


@pytest.mark.cuda
def test_rna2_simulator_on_card_matches_cpu_twins(card):
    """The oxRNA2 slice: 40 bp A-form, 4 chunks, thermostat off -- the run
    on the card (K1/K2's rna2 instances) agrees with the CPU twins."""

    def run(device):
        top, b = synthetic_duplex(40, form="A", dtype=torch.float32, device=device)
        e, sim = build_sim(top, 0.0, model="rna2", init_centers=b.center, init_orientation=b.orientation,
                           neighbor_update_every=10, device=device)
        out = sim.replace(save_every=10).run(e.opt_params(), b, 40, torch.Generator(device=device).manual_seed(0))
        return out.observables[0]

    gpu, cpu = run(card), run("cpu")
    torch.testing.assert_close(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
    assert not bool(gpu.metadata["neighbor_overflow"].any())


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


def _launches() -> tuple:
    return ts.multistep_chunk.launches, ts.field_grads.launches


def _grad_run(device, model, n_steps, **sim_kw):
    """(loss, {name: gradient on the CPU}, (K1, K2) launches of the forward,
    of the backward) of a weighted sum of the states of a 40-bp run at kT 0
    from a 0.01-jittered start, every opt_params tensor a leaf."""
    top, b = synthetic_duplex(40, form="B" if model == "dna2" else "A", dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(32)
    q = b.orientation + 0.01 * torch.randn(b.orientation.shape, generator=gen)
    b = RigidBody((b.center + 0.01 * torch.randn(b.center.shape, generator=gen)).to(device),
                  (q / q.norm(dim=-1, keepdim=True)).to(device))
    e, sim = build_sim(top, 0.0, model=model, init_centers=b.center, init_orientation=b.orientation, device=device)
    sim = sim.replace(**sim_kw)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in e.opt_params().items()}
    k0 = _launches()
    traj = sim.run(p, b, n_steps, torch.Generator(device=device).manual_seed(0)).observables[0]
    k1 = _launches()
    w = torch.randn((*traj.center.shape[:2], 7), generator=gen).to(device)
    loss = (w[..., :3] * traj.center).sum() + (w[..., 3:] * traj.orientation).sum()
    loss.backward()
    k2 = _launches()
    grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad).cpu() for k, v in p.items()}
    return loss.item(), grads, tuple(b - a for a, b in zip(k0, k1)), tuple(b - a for a, b in zip(k1, k2))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["dna2", "rna2"])
def test_gradient_through_run_on_card_matches_cpu(card, model):
    """d loss / d opt_params through one 40-step chunk (K1 forward on the
    card) agrees with the CPU plain versions: loss rtol 1e-5, gradients
    rtol 1e-2 / atol 1e-3 max|grad|; d / d eps_stack_base nonzero."""
    l_gpu, g_gpu, _, _ = _grad_run(card, model, 40)
    l_cpu, g_cpu, _, _ = _grad_run("cpu", model, 40)
    assert l_gpu == pytest.approx(l_cpu, rel=1e-5)
    scale = max(float(v.abs().max()) for v in g_cpu.values())
    for k in g_cpu:
        torch.testing.assert_close(g_gpu[k], g_cpu[k], rtol=1e-2, atol=1e-3 * scale, msg=k)
    assert float(g_cpu["eps_stack_base"]) != 0 and float(g_gpu["eps_stack_base"]) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["chunk", "per-step checkpoint_every=1"])
def test_gradient_run_launches(card, path):
    """A grad evaluation launches K1 and K2 in its forward as the run does
    without gradients (chunk path: K1 once a chunk, K2 once; per-step: K2
    n + 1 times), and the backward, the plain versions, launches neither --
    except K2 once a step again where it recomputes a checkpointed
    interval."""
    chunk = path == "chunk"
    kw = {"save_every": 40} if chunk else {"save_every": 1, "neighbor_update_every": 5, "checkpoint_every": 1}
    n_steps = 80 if chunk else 10
    _, g, fwd, bwd = _grad_run(card, "dna2", n_steps, **kw)
    with torch.no_grad():
        top, b = synthetic_duplex(40, dtype=torch.float32, device=card)
        e, sim = build_sim(top, 0.0, init_centers=b.center, init_orientation=b.orientation, device=card)
        k0 = _launches()
        sim.replace(**kw).run(e.opt_params(), b, n_steps, torch.Generator(device=card).manual_seed(0))
        plain = tuple(b - a for a, b in zip(k0, _launches()))
    assert fwd == plain == ((2, 1) if chunk else (0, n_steps + 1))
    assert bwd == ((0, 0) if chunk else (0, n_steps))
    assert all(bool(torch.isfinite(v).all()) for v in g.values())


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


@pytest.fixture(scope="module")
def tile_inputs(card):
    """{(shape, kind): (context, table, rows)} of a jittered 40-bp duplex,
    straight and bent 270 degrees, for every kind on its block table."""
    out = {}
    for shape, bend in (("straight", None), ("bent", math.radians(270))):
        top, body = synthetic_duplex(40, bend=bend, dtype=torch.float32, device=card)
        e, sim = build_sim(top, KT, mode="block", init_centers=body.center, device=card)
        nbl = sim.neighbors
        ids = nbl.idx if not isinstance(nbl.idx, tuple) else nbl.idx[1]
        gen = torch.Generator(device="cuda").manual_seed(2)
        q = body.orientation + 0.01 * torch.randn(body.orientation.shape, generator=gen, device="cuda")
        c = body.center + 0.01 * torch.randn(body.center.shape, generator=gen, device="cuda")
        b = to_soa(RigidBody(c, q / q.norm(dim=-1, keepdim=True)))
        for kind in ("full", "short", "debye"):
            ctx = tiles.prepare_tile_context(e, ids, nbl.block_size, kind, nbl.perm)
            out[shape, kind] = (ctx, ids, tiles.dynamic_rows(ctx, b).contiguous())
    return out


def _close(got, ref):
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["full", "short", "debye"])
@pytest.mark.parametrize("shape", ["straight", "bent"])
def test_k3_kernel_matches_plain(tile_inputs, shape, kind):
    """K3 against its plain version, its pair classes those of the plain
    gate (tile_gate_counts), equal bits on a second call."""
    ctx, ids, rows = tile_inputs[shape, kind]
    sp = ctx.spec
    before = tiles.tile_forces.launches
    got = tiles.tile_forces(rows, ctx.params, ids, sp)
    torch.cuda.synchronize()
    assert tiles.tile_forces.launches == before + 1
    _close(got, tiles.tile_forces_plain(rows, ctx.params, ids, sp))
    again, counts = tiles._tile_forces(rows, ctx.params, ids, sp, count=True)
    assert torch.equal(got, again)  # a fixed order, no atomics
    assert _tally(counts) == tiles.tile_gate_counts(rows, ctx.params, ids, sp)


def _tally(counts) -> dict:
    return dict(zip(("short", "debye", "skipped"), counts.tolist(), strict=True))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["full", "short", "debye"])
@pytest.mark.parametrize("shape", ["straight", "bent"])
def test_k4_kernel_matches_plain(tile_inputs, shape, kind):
    """K4 against its plain version, its pair classes those of the plain
    gate under the triangular mask, equal bits on a second call."""
    ctx, ids, rows = tile_inputs[shape, kind]
    sp = ctx.spec
    before = tiles.tile_energies.launches
    got = tiles.tile_energies(rows, ctx.params, ids, sp)
    torch.cuda.synchronize()
    assert tiles.tile_energies.launches == before + 1
    _close(got, tiles.tile_energies_plain(rows, ctx.params, ids, sp))
    again, counts = tiles._tile_energies(rows, ctx.params, ids, sp, count=True)
    assert torch.equal(got, again)  # a fixed reduction order, no atomics
    assert _tally(counts) == tiles.tile_gate_counts(rows, ctx.params, ids, sp, triangular=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["full", "short", "debye"])
@pytest.mark.parametrize("shape", ["straight", "bent"])
def test_k5_kernel_matches_plain_and_k3(tile_inputs, shape, kind):
    """K5 against its plain version, its body fields for the term weights
    against K3, its pair classes those of the plain gate, equal bits on a
    second call."""
    ctx, ids, rows = tile_inputs[shape, kind]
    sp = ctx.spec
    gt = tiles.term_weights(ctx.params, sp) * torch.linspace(0.5, 1.5, len(sp.terms), device="cuda")
    before = tiles.tile_row_grads.launches
    got = tiles.tile_row_grads(rows, ctx.params, ids, gt, sp)
    torch.cuda.synchronize()
    assert tiles.tile_row_grads.launches == before + 1
    _close(got, tiles.tile_row_grads_plain(rows, ctx.params, ids, gt, sp))
    again, counts = tiles._tile_row_grads(rows, ctx.params, ids, gt, sp, count=True)
    assert torch.equal(got, again)  # a fixed order, no atomics
    assert _tally(counts) == tiles.tile_gate_counts(rows, ctx.params, ids, sp)
    k5 = tiles.tile_row_grads(rows, ctx.params, ids, tiles.term_weights(ctx.params, sp), sp)
    k3 = tiles.tile_forces(rows, ctx.params, ids, sp)
    torch.testing.assert_close(k5[:, : sp.n_force_fields], k3, rtol=1e-5, atol=5e-6)


@pytest.mark.cuda
def test_block_run_on_card_matches_cpu(card):
    """The block tier, 40 bp, 20 steps, thermostat off: K3 on the card
    against the plain version on the CPU."""

    def run(device):
        top, b = synthetic_duplex(40, dtype=torch.float32, device=device)
        e, sim = build_sim(top, 0.0, mode="block", init_centers=b.center, neighbor_update_every=5, device=device)
        out = sim.replace(save_every=10).run(e.opt_params(), b, 20, torch.Generator(device=device).manual_seed(0))
        return out.observables[0]

    gpu, cpu = run(card), run("cpu")
    torch.testing.assert_close(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)


def _bilayer_lj(device, n_xy: int, water_layers: int, case: str):
    """K6's inputs for a lattice bilayer jittered by 0.03 nm (float32); for
    "permuted" its beads permuted (positions, types and mask alike), for
    "scaled box" its box and positions scaled by 0.98 in x and y and 1.02
    in z, as the barostat scales them; for "wide box" its beads moved across
    the x and y faces (by half its box) of a 70 x 70 x 10 nm box, whose
    floor(box / LJ_CELL) cells a side (63 x 63 x 9) exceed MAX_CELLS."""
    top, pos, box, _ = lattice_bilayer(n_xy, n_xy, water_layers=water_layers)
    pos = pos + np.random.default_rng(1).normal(scale=0.03, size=pos.shape)
    term = default_bilayer_terms(top)[2]
    types, mask = term.types(device), term.pair_mask(device)
    if case == "permuted":
        perm = np.random.default_rng(2).permutation(len(pos))
        pos, types = pos[perm], types[torch.as_tensor(perm, device=device)].contiguous()
        mask = lj.PairMask.build(len(pos), np.argsort(perm)[np.asarray(term.bonded_neighbors)], device)
    if case == "scaled box":
        scale = np.array([0.98, 0.98, 1.02])
        pos, box = pos * scale, box * scale
    if case == "wide box":
        pos, box = pos - np.array([box[0] / 2, box[1] / 2, 0.0]), np.array([70.0, 70.0, 10.0])
    x = torch.as_tensor(pos, dtype=torch.float32, device=device)
    b = torch.as_tensor(box, dtype=torch.float32, device=device)
    return x, types, mask, b, term.tables(device, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["jittered", "permuted", "scaled box", "wide box"])
@pytest.mark.parametrize("size", [(3, 1), (8, 4)], ids=["104 beads", "1864 beads"])
def test_k6_kernels_match_plain(card, size, case):
    """K6 forward (deterministic) and backward (position and box gradients,
    deterministic) against the plain versions on the card; the cells each
    built equal cell_list_plain's; under LJPairEnergy one cell build serves
    the forward and the backward, whose gradients equal lj_grads' bits."""
    args = _bilayer_lj(card, *size, case)
    before = (lj.lj_energy.launches, lj.lj_grads.launches, lj.lj_cells.launches)
    e = lj.lj_energy(*args)
    g, g_box = lj.lj_grads(*args)
    torch.cuda.synchronize()
    assert (lj.lj_energy.launches, lj.lj_grads.launches, lj.lj_cells.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 2)
    e_ref = lj.lj_energy_plain(*args)
    g_ref, g_box_ref = lj.lj_grads_plain(*args)
    torch.testing.assert_close(e, e_ref, rtol=2e-5, atol=0.0)
    torch.testing.assert_close(g, g_ref, rtol=2e-4, atol=1e-4 * float(g_ref.abs().max()))
    torch.testing.assert_close(g_box, g_box_ref, rtol=2e-4, atol=1e-4 * float(g_box_ref.abs().max()))
    plain = lj.cell_list_plain(args[0], args[3])
    e2, cells_e = lj._lj_energy(*args)  # the cells this call's energy came from
    assert torch.equal(e, e2)  # a fixed reduction order, no atomics
    g2, g_box2, cells_g = lj._lj_grads(*args)
    assert torch.equal(g, g2) and torch.equal(g_box, g_box2)
    for cells in (cells_e, cells_g):
        for field in ("dims", "cell_of", "start", "order"):
            assert torch.equal(getattr(cells, field), getattr(plain, field)), field
    x, box = args[0].clone().requires_grad_(True), args[3].clone().requires_grad_(True)
    builds = lj.lj_cells.launches
    g_fn, g_box_fn = torch.autograd.grad(lj.lj_pair_energy(x, args[1], args[2], box, args[4]), (x, box))
    assert lj.lj_cells.launches == builds + 1
    assert torch.equal(g_fn, g) and torch.equal(g_box_fn, g_box)


@pytest.mark.cuda
def test_martini_run_on_card_matches_cpu(card):
    """The MARTINI NPT path, 104 beads, 20 steps with the barostat every 10
    and the same pre-drawn noise: K6 on the card against the plain versions
    on the CPU."""
    top, pos, box, masses = lattice_bilayer(3, 3, water_layers=1)
    gen = torch.Generator().manual_seed(0)
    mom = torch.randn(pos.shape, generator=gen) * (72.0 * 0.0083144621 * 305.0) ** 0.5
    noise = torch.randn((20, *pos.shape), generator=gen)

    def run(device):
        sim = MartiniSimulator(energy_fns=default_bilayer_terms(top), box=box, masses=masses, save_every=10,
                               barostat={"pressure0": 1.0, "tau": 4.0, "every": 10}, device=device)
        x0 = torch.as_tensor(pos, dtype=torch.float32)
        return sim.run(None, x0, 20, init_momentum=mom, noise=noise).observables[0]

    before = lj.lj_grads.launches
    gpu = run(card)
    assert lj.lj_grads.launches > before
    cpu = run("cpu")
    torch.testing.assert_close(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gpu.box_size.cpu(), cpu.box_size, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["full", "short", "debye"])
def test_tile_forces_vjp_on_card_matches_cpu(tile_inputs, kind):
    """TileForces on the card: K3 forward (one launch), its backward the
    plain version with create_graph on CUDA tensors (no launch); the VJP in
    the rows and the parameters agrees with the same Function on the CPU
    (rtol 1e-3, atol 1e-4 x max|CPU|)."""
    ctx, ids, rows = tile_inputs["straight", kind]
    ids = tiles.pad_ids(ctx.spec, ids)
    gen = torch.Generator().manual_seed(5)
    cot = torch.randn((ctx.spec.n_pad, ctx.spec.n_force_fields), generator=gen)

    def vjp(device):
        r = rows.detach().to(device).requires_grad_(True)
        p = ctx.params.detach().to(device).requires_grad_(True)
        out = tiles.TileForces.apply(r, p, ids.to(device), ctx.spec)
        k3 = tiles.tile_forces.launches
        g_r, g_p = torch.autograd.grad(out, (r, p), cot.to(device))
        return out.detach().cpu(), g_r.cpu(), g_p.cpu(), tiles.tile_forces.launches - k3

    before = tiles.tile_forces.launches
    out_g, gr_g, gp_g, bwd = vjp(card_device := rows.device)
    assert card_device.type == "cuda" and tiles.tile_forces.launches == before + 1 and bwd == 0
    out_c, gr_c, gp_c, _ = vjp("cpu")
    _close(out_g, out_c)
    for got, ref in ((gr_g, gr_c), (gp_g, gp_c)):
        torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
def test_lj_grads_vjp_on_card_matches_cpu(card):
    """LJGrads on the card: K6's backward kernel forward, the plain double
    backward on CUDA tensors; the VJP in positions, box and both tables
    agrees with the CPU (104 beads, float32; rtol 1e-3, atol 1e-4 x
    max|CPU|), and the forward launched K6's backward once, the backward
    never."""
    x, types, mask, b, (sig, eps) = _bilayer_lj(card, 3, 1, "jittered")
    gen = torch.Generator().manual_seed(6)
    cots = (torch.randn(x.shape, generator=gen), torch.randn(3, generator=gen))

    def vjp(device):
        ins = [t.detach().to(device).requires_grad_(True) for t in (x, b, sig, eps)]
        k6 = lj.lj_grads.launches
        out = lj.LJGrads.apply(*ins, types.to(device), mask if device != "cpu" else
                               lj.PairMask(mask.n, mask.bits.cpu()), None)
        fwd = lj.lj_grads.launches - k6
        g = torch.autograd.grad(out, ins, tuple(c.to(device) for c in cots))
        return [t.cpu() for t in g], fwd, lj.lj_grads.launches - k6 - fwd

    got, fwd, bwd = vjp(card)
    assert fwd == 1 and bwd == 0
    ref, _, _ = vjp("cpu")
    for gg, gr in zip(got, ref, strict=True):
        torch.testing.assert_close(gg, gr, rtol=1e-3, atol=1e-4 * float(gr.abs().max()))


def _block_grad_run(device, n_steps=20, kT=0.0, seed=0, grad=True):  # noqa: N803
    """(loss or None, {name: gradient on the CPU} or None, trajectory, K3
    launches of the forward, of the backward) of a 40-bp block run from a
    0.01-jittered start (a rebuild every 5 steps, a state every 10)."""
    top, b = synthetic_duplex(40, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(32)
    q = b.orientation + 0.01 * torch.randn(b.orientation.shape, generator=gen)
    b = RigidBody((b.center + 0.01 * torch.randn(b.center.shape, generator=gen)).to(device),
                  (q / q.norm(dim=-1, keepdim=True)).to(device))
    e, sim = build_sim(top, kT, mode="block", init_centers=b.center, neighbor_update_every=5, device=device)
    sim = sim.replace(save_every=10)
    p = {k: v.detach().clone().requires_grad_(grad) for k, v in e.opt_params().items()}
    k0 = tiles.tile_forces.launches
    traj = sim.run(p, b, n_steps, torch.Generator(device=device).manual_seed(seed)).observables[0]
    fwd = tiles.tile_forces.launches - k0
    if not grad:
        return None, None, traj, fwd, 0
    w = torch.randn((*traj.center.shape[:2], 7), generator=gen).to(device)
    loss = (w[..., :3] * traj.center).sum() + (w[..., 3:] * traj.orientation).sum()
    loss.backward()
    grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad).cpu() for k, v in p.items()}
    return loss.item(), grads, traj, fwd, tiles.tile_forces.launches - k0 - fwd


@pytest.mark.cuda
def test_block_gradient_on_card_matches_cpu(card):
    """d loss / d opt_params through a 40-bp, 20-step block run at kT 0 (K3
    forward on the card) agrees with the CPU plain versions: loss rtol 1e-5,
    gradients rtol 1e-2 / atol 1e-3 max|grad|; d / d eps_stack_base
    nonzero."""
    l_gpu, g_gpu, _, _, _ = _block_grad_run(card)
    l_cpu, g_cpu, _, _, _ = _block_grad_run("cpu")
    assert l_gpu == pytest.approx(l_cpu, rel=1e-5)
    scale = max(float(v.abs().max()) for v in g_cpu.values())
    for k in g_cpu:
        torch.testing.assert_close(g_gpu[k], g_cpu[k], rtol=1e-2, atol=1e-3 * scale, msg=k)
    assert float(g_cpu["eps_stack_base"]) != 0 and float(g_gpu["eps_stack_base"]) != 0


@pytest.mark.cuda
def test_block_grad_run_is_the_no_grad_run_on_card(card):
    """At kT > 0 on the card, a block run that builds the graph gives the
    trajectory of the run without gradients bit for bit and launches K3 as
    often (once a table and step, plus the initial force); its backward
    launches none."""
    _, _, ref, fwd_ref, _ = _block_grad_run(card, kT=KT, seed=3, grad=False)
    _, g, got, fwd, bwd = _block_grad_run(card, kT=KT, seed=3)
    assert torch.equal(got.center.detach(), ref.center) and torch.equal(got.orientation.detach(), ref.orientation)
    assert fwd == fwd_ref >= 21 and bwd == 0
    assert all(bool(torch.isfinite(v).all()) for v in g.values())


def _martini_grad_run(device, grad=True):
    """(loss, d loss / d lj_epsilon_C1_C1 and lj_sigma_C1_C1, trajectory,
    K6 (forward, backward, cells) launches) of the 104-bead bilayer, 50 NPT
    steps with the barostat every 10, pre-drawn noise, the loss the mean
    area per lipid."""
    from mythos_tpu_torch.observables import AreaPerLipid

    top, pos, box, masses = lattice_bilayer(3, 3, water_layers=1)
    gen = torch.Generator().manual_seed(0)
    mom = torch.randn(pos.shape, generator=gen) * (72.0 * 0.0083144621 * 305.0) ** 0.5
    noise = torch.randn((50, *pos.shape), generator=gen)
    sim = MartiniSimulator(energy_fns=default_bilayer_terms(top), box=box, masses=masses, save_every=10,
                           barostat={"pressure0": 1.0, "tau": 4.0, "every": 10}, device=device)
    p = {k: torch.tensor(v, device=device).requires_grad_(grad) for k, v in (("lj_epsilon_C1_C1", 3.5),
                                                                            ("lj_sigma_C1_C1", 0.47))}
    k0 = (lj.lj_energy.launches, lj.lj_grads.launches, lj.lj_cells.launches)
    traj = sim.run(p, torch.as_tensor(pos, dtype=torch.float32), 50, init_momentum=mom, noise=noise).observables[0]
    k1 = (lj.lj_energy.launches, lj.lj_grads.launches, lj.lj_cells.launches)
    heads = [i for i, nm in enumerate(top.atom_names) if nm == "PO4"]
    loss = AreaPerLipid(head_indices=heads)(traj).mean()
    grads = torch.autograd.grad(loss, list(p.values())) if grad else None
    return float(loss.detach()), grads, traj, tuple(b - a for a, b in zip(k0, k1))


@pytest.mark.cuda
def test_martini_gradient_on_card_matches_cpu(card):
    """d (mean APL) / d (LJ epsilon, sigma) through 50 NPT steps of the
    104-bead bilayer (K6 forward on the card, its plain double backward)
    agrees with the CPU: loss rtol 1e-4, gradients rtol 1e-2 / atol 1e-3
    max|grad|; both nonzero."""
    l_gpu, g_gpu, _, _ = _martini_grad_run(card)
    l_cpu, g_cpu, _, _ = _martini_grad_run("cpu")
    assert l_gpu == pytest.approx(l_cpu, rel=1e-4)
    scale = max(float(g.abs()) for g in g_cpu)
    for gg, gc in zip(g_gpu, g_cpu, strict=True):
        assert float(gc) != 0.0
        torch.testing.assert_close(gg.cpu(), gc, rtol=1e-2, atol=1e-3 * scale)


@pytest.mark.cuda
def test_martini_grad_run_is_the_no_grad_run_on_card(card):
    """On the card, an NPT run with gradients gives the trajectory of the
    run without them bit for bit and launches K6 as often: forward, backward
    and one cell build a force evaluation."""
    _, _, ref, k_ref = _martini_grad_run(card, grad=False)
    _, _, got, k = _martini_grad_run(card)
    assert torch.equal(got.center.detach(), ref.center) and torch.equal(got.box_size.detach(), ref.box_size)
    assert k == k_ref and k[0] == k[1] == k[2] == 1 + 50 + 5


# oxDNA1: the dna1 instances of K1, K2 and K3, and the small-system path ----------


@pytest.fixture(scope="module")
def dna1_system(card):
    top, body = synthetic_duplex(40, dtype=torch.float32, device=card)
    e, sim = build_sim(top, KT, model="dna1", init_centers=body.center, init_orientation=body.orientation,
                       device=card)
    ctx = ts.prepare_stencil_context(e, sim.band, device=card)
    return e, sim, ctx, body


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ideal", "jittered", "coax"])
def test_k2_dna1_kernel_matches_twin(dna1_system, case):
    """K2's oxDNA1 instance against its plain version (rtol 1e-4, atol 1e-4
    max|plain|), ideal, jittered, and with coaxial stacking alone on pairs
    placed coaxially stacked inside coax's reach; its tally equal to
    band_gate_counts' with no Debye class, equal bits on a second call, one
    launch counted for the family."""
    import dataclasses as dc

    _, _, ctx, body = dna1_system
    if case == "coax":
        com, quat = (ctx.to_slots(x.T.double()).T.cpu().numpy() for x in (body.center, body.orientation))
        com, quat = coax_engaged(com, quat, [(10, 11), (30, 33), (50, 55)], seed=3)
        dyn = torch.as_tensor(np.concatenate([com.T, quat.T]), dtype=torch.float32, device="cuda").contiguous()
        params = ctx.params.clone()
        off = ts.param_offsets()["GT"]
        params[off : off + 8] = torch.tensor([0, 0, 0, 1, 0, 0, 0, 0], dtype=torch.float32)
        ctx = dc.replace(ctx, params=params)
    else:
        b = body if case == "ideal" else _jittered(body, torch.Generator(device="cuda").manual_seed(5))
        dyn = torch.cat([ctx.to_slots(b.center.T), ctx.to_slots(b.orientation.T)]).contiguous()
    before = dict(ts.field_grads.by_family)
    got, tally = ts._field_grads(ctx, dyn, count=True)
    assert ts.field_grads.by_family == {**before, "dna1": before["dna1"] + 1}
    ref = ts.field_grads_plain(ctx, dyn)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
    assert tally == ts.band_gate_counts(ctx, dyn)
    assert tally["short"] > 0 and tally["debye"] == tally["Debye"] == 0
    assert torch.equal(got, ts.field_grads(ctx, dyn))
    if case == "coax":
        assert float(ref.abs().max()) > 1.0


@pytest.mark.cuda
def test_k1_dna1_kernel_matches_twin(dna1_system):
    """K1's oxDNA1 instance against its plain version over 4 and 3 steps
    (rtol 2e-4, atol 5e-5), equal bits on a second call, one launch counted
    for the family; the exact checks widened to every in-band offset (d_lo
    1), so that row 19 counts the helix's own contacts on the one backbone
    site."""
    import dataclasses as dc

    _, sim, ctx, body = dna1_system
    checks = ctx.checks.clone()
    checks[:, 3] = 1.0
    ctx = dc.replace(ctx, checks=checks)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = sim.initial_state(ctx, _jittered(body, gen), gen)
    noise = torch.randn((4, 6, ctx.n), generator=gen, device="cuda").to(torch.bfloat16)
    ou = ts.ou_constants(sim.dt, sim.kT, [1.0], [[1.0, 1.0, 1.0]], [sim.gamma_t], [sim.gamma_r]).vector("cuda")
    before = dict(ts.multistep_chunk.by_family)
    got = ts.multistep_chunk(ctx, ou, noise, state)
    assert ts.multistep_chunk.by_family == {**before, "dna1": before["dna1"] + 1}
    ref = ts.multistep_chunk_plain(ctx, ou, noise, state)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=5e-5)
    assert float(ref[19].sum()) > 0
    assert torch.equal(got, ts.multistep_chunk(ctx, ou, noise, state))
    odd = noise[:3].contiguous()
    torch.testing.assert_close(ts.multistep_chunk(ctx, ou, odd, state), ts.multistep_chunk_plain(ctx, ou, odd, state),
                               rtol=2e-4, atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("save_every", [10, 1], ids=["chunks", "per-step"])
def test_dna1_stencil_run_on_card_matches_cpu(card, save_every):
    """The oxDNA1 stencil, 40 bp, 40 steps, thermostat off, on the chunk path
    (K1 once a chunk) and the per-step branch (K2 n + 1 times): the card's
    run agrees with the CPU's (rtol 1e-4, atol 1e-5)."""

    def run(device):
        top, b = synthetic_duplex(40, dtype=torch.float32, device=device)
        e, sim = build_sim(top, 0.0, model="dna1", init_centers=b.center, init_orientation=b.orientation,
                           neighbor_update_every=10, device=device)
        return sim.replace(save_every=save_every).run(e.opt_params(), b, 40,
                                                      torch.Generator(device=device).manual_seed(0)).observables[0]

    k1, k2 = dict(ts.multistep_chunk.by_family), dict(ts.field_grads.by_family)
    gpu = run(card)
    torch.cuda.synchronize()
    if save_every == 1:
        assert ts.field_grads.by_family["dna1"] == k2["dna1"] + 41
        assert ts.multistep_chunk.by_family == k1
    else:
        assert ts.multistep_chunk.by_family["dna1"] == k1["dna1"] + 4
    cpu = run("cpu")
    torch.testing.assert_close(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
    assert not bool(gpu.metadata["neighbor_overflow"].any())


@pytest.fixture(scope="module")
def dna1_tile_inputs(card):
    """{shape: (context, table, rows)} of a jittered 40-bp duplex under
    oxDNA1, straight and bent 270 degrees, on its one-level block table."""
    out = {}
    for shape, bend in (("straight", None), ("bent", math.radians(270))):
        top, body = synthetic_duplex(40, bend=bend, dtype=torch.float32, device=card)
        e, sim = build_sim(top, KT, mode="block", model="dna1", init_centers=body.center, device=card)
        nbl = sim.neighbors
        gen = torch.Generator(device="cuda").manual_seed(2)
        (ctx,) = tiles.prepare_contexts(e, nbl.idx, nbl.block_size, perm=nbl.perm)
        out[shape] = (ctx, nbl.idx, tiles.dynamic_rows(ctx, to_soa(_jittered(body, gen))).contiguous())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["straight", "bent"])
def test_k3_dna1_kernel_matches_plain(dna1_tile_inputs, shape):
    """K3's oxDNA1 instance against its plain version on the one-level table
    (short kind), its pair classes those of the plain gate (no Debye
    class), equal bits on a second call, one launch counted for the family."""
    ctx, ids, rows = dna1_tile_inputs[shape]
    sp = ctx.spec
    assert (sp.family, sp.kind) == ("dna1", "short")
    before = dict(tiles.tile_forces.by_family)
    got = tiles.tile_forces(rows, ctx.params, ids, sp)
    torch.cuda.synchronize()
    assert tiles.tile_forces.by_family == {**before, "dna1": before["dna1"] + 1}
    _close(got, tiles.tile_forces_plain(rows, ctx.params, ids, sp))
    again, counts = tiles._tile_forces(rows, ctx.params, ids, sp, count=True)
    assert torch.equal(got, again)
    assert _tally(counts) == tiles.tile_gate_counts(rows, ctx.params, ids, sp)
    assert _tally(counts)["debye"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["straight", "bent"])
def test_k4_k5_dna1_kernels_match_plain(dna1_tile_inputs, shape):
    """K4's and K5's oxDNA1 instances against their plain versions on the
    one-level table (short kind; K2's tolerance), their pair classes those
    of the plain gate (K4's under the triangular mask, no Debye class),
    equal bits on a second call, one launch each counted for the family,
    and K5's body fields for the term weights equal to K3's dna1 instance."""
    ctx, ids, rows = dna1_tile_inputs[shape]
    sp, P = ctx.spec, ctx.params
    gt = tiles.term_weights(P, sp) * torch.linspace(0.5, 1.5, len(sp.terms), device="cuda")
    before4, before5 = dict(tiles.tile_energies.by_family), dict(tiles.tile_row_grads.by_family)
    k4 = tiles.tile_energies(rows, P, ids, sp)
    k5 = tiles.tile_row_grads(rows, P, ids, gt, sp)
    torch.cuda.synchronize()
    assert tiles.tile_energies.by_family == {**before4, "dna1": before4["dna1"] + 1}
    assert tiles.tile_row_grads.by_family == {**before5, "dna1": before5["dna1"] + 1}
    assert k4.shape == (4,) and k5.shape == (sp.n_pad, 16)
    _close(k4, tiles.tile_energies_plain(rows, P, ids, sp))
    _close(k5, tiles.tile_row_grads_plain(rows, P, ids, gt, sp))
    again4, counts4 = tiles._tile_energies(rows, P, ids, sp, count=True)
    again5, counts5 = tiles._tile_row_grads(rows, P, ids, gt, sp, count=True)
    assert torch.equal(k4, again4) and torch.equal(k5, again5)
    assert _tally(counts4) == tiles.tile_gate_counts(rows, P, ids, sp, triangular=True)
    assert _tally(counts5) == tiles.tile_gate_counts(rows, P, ids, sp)
    assert _tally(counts4)["debye"] == _tally(counts5)["debye"] == 0
    body = tiles.tile_row_grads(rows, P, ids, tiles.term_weights(P, sp), sp)[:, : sp.n_force_fields]
    torch.testing.assert_close(body, tiles.tile_forces(rows, P, ids, sp), rtol=1e-5, atol=5e-6)


@pytest.mark.cuda
def test_dna1_difftre_on_card_matches_cpu(card, tmp_path):
    """DiffTRe under oxDNA1 on the card: the tile map of 3 jittered 40-bp
    states launches K4's dna1 instance once a state and, backward, K5's,
    its energies and parameter gradients against the CPU (rtol 1e-4, atol
    1e-5 max|grad|); and the example's main() on a 40-bp duplex from oxDNA
    files (40 MD steps on the pair list, one Adam step): its step's loss
    and gradients card vs CPU on the card's trajectory, as chip_smoke.py
    phase 16c."""
    import mythos_tpu_torch.energy.dna1 as dna1
    from mythos_tpu_torch.examples import difftre_propeller_fit as fit_example
    from mythos_tpu_torch.io.topology import to_oxdna_files
    from mythos_tpu_torch.simulators import neighbors as tnb

    gen = torch.Generator().manual_seed(5)
    top, b = synthetic_duplex(40, dtype=torch.float32, device="cpu")
    cs = b.center[None] + 0.01 * torch.randn((3, *b.center.shape), generator=gen)
    qs = b.orientation[None] + 0.01 * torch.randn((3, *b.orientation.shape), generator=gen)
    qs = qs / qs.norm(dim=-1, keepdim=True)

    def mapped(device):
        e = dna1.create_default_energy_fn(top, device=device)
        nbl = tnb.block_neighbor_list_for_topology(top, dna1.default_neighbor_cutoff(), block_size=8,
                                                   init_centers=cs[0].to(device), perm=tnb.strand_interleave_perm(top))
        p = {k: v.detach().clone().requires_grad_(True) for k, v in e.opt_params().items()}
        energies = e.replace(map_neighbors=nbl).with_params(p).map(RigidBody(cs.to(device), qs.to(device)))
        g = torch.autograd.grad((energies * torch.tensor([1.0, -0.5, 2.0], device=device)).sum(), list(p.values()),
                                allow_unused=True)
        return energies.detach().cpu(), {k: (torch.zeros_like(v) if gk is None else gk).cpu()
                                         for (k, v), gk in zip(p.items(), g, strict=True)}

    before4, before5 = tiles.tile_energies.by_family["dna1"], tiles.tile_row_grads.by_family["dna1"]
    e_gpu, g_gpu = mapped(card)
    torch.cuda.synchronize()
    assert tiles.tile_energies.by_family["dna1"] == before4 + 3
    assert tiles.tile_row_grads.by_family["dna1"] == before5 + 3
    e_cpu, g_cpu = mapped("cpu")
    torch.testing.assert_close(e_gpu, e_cpu, rtol=1e-4, atol=1e-5)
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    for k, g in g_cpu.items():
        torch.testing.assert_close(g_gpu[k], g, rtol=1e-4, atol=1e-5 * scale, msg=k)

    top_f, body_f = synthetic_duplex(40, dtype=torch.float64, device="cpu")
    top_path, conf_path = to_oxdna_files(tmp_path, top_f, body_f, new_format=True)
    argv = [str(top_path), str(conf_path), "--sim-steps", "40", "--save-every", "5", "--n-eq-states", "2",
            "--opt-steps", "1"]
    outs = []
    fit_example.main(argv + ["--device", "cuda"],
                     callback=lambda optimizer_output, step: (outs.append(optimizer_output), (None, True))[1])
    cpu_opt, params_cpu = fit_example.build_fit(fit_example.parse_args(argv + ["--device", "cpu"]))
    name = cpu_opt.simulator.exposes()[0]
    traj = outs[0].state.observables[name]
    assert traj.center.device.type == "cuda"
    ref = cpu_opt.objective.calculate({name: traj.replace(center=traj.center.cpu(), orientation=traj.orientation.cpu(),
                                                          temperature=traj.temperature.cpu())}, opt_params=params_cpu)
    assert ref.is_ready
    loss = float(outs[0].observables["propeller"]["loss"])
    assert abs(loss - float(ref.observables["loss"])) <= 1e-4 * abs(float(ref.observables["loss"])) + 1e-5
    scale = max(float(g.abs().max()) for g in ref.grads.values())
    for k, g in ref.grads.items():
        torch.testing.assert_close(outs[0].grads[k].cpu(), g, rtol=1e-4, atol=1e-5 * scale, msg=k)


@pytest.mark.cuda
def test_dna1_block_run_on_card_matches_cpu(card):
    """The oxDNA1 block tier, 40 bp, 20 steps, thermostat off: K3's dna1
    instance on the card (once a step on the one table) against the plain
    version on the CPU."""

    def run(device):
        top, b = synthetic_duplex(40, dtype=torch.float32, device=device)
        e, sim = build_sim(top, 0.0, mode="block", model="dna1", init_centers=b.center, neighbor_update_every=5,
                           device=device)
        out = sim.replace(save_every=10).run(e.opt_params(), b, 20, torch.Generator(device=device).manual_seed(0))
        return out.observables[0]

    before = tiles.tile_forces.by_family["dna1"]
    gpu = run(card)
    torch.cuda.synchronize()
    assert tiles.tile_forces.by_family["dna1"] == before + 21
    cpu = run("cpu")
    torch.testing.assert_close(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pairs", "dense"])
def test_small_system_run_on_card_matches_cpu(card, mode):
    """The small-system path (no kernel: autograd on the card), oxDNA1, 40
    bp, 20 steps, thermostat off: the card agrees with the CPU (rtol 1e-4,
    atol 1e-5), and entry()'s step runs on the card."""
    from mythos_tpu_torch import entry

    def run(device):
        top, b = synthetic_duplex(40, dtype=torch.float32, device=device)
        e, sim = build_sim(top, 0.0, mode=mode, model="dna1", device=device)
        return sim.run(e.opt_params(), b, 20, torch.Generator(device=device).manual_seed(0)).observables[0]

    gpu, cpu = run(card), run("cpu")
    assert gpu.center.device.type == "cuda" and gpu.center.shape == (20, 80, 3)
    torch.testing.assert_close(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
    step, (state0,) = entry.entry()
    state = step(state0)
    assert state.position.center.device.type == "cuda" and bool(torch.isfinite(state.position.center).all())


def _pseq_energy(model: str, device, onehot: bool = False, seed: int = 0):
    """The default oxDNA1, oxDNA2 or oxRNA2 energy of the 40-bp duplex
    (A-form under oxRNA2) under a pseq (all but the two outermost base
    pairs constrained): drawn from ``seed``, or the one-hot pseq of the
    duplex's own sequence."""
    from mythos_tpu_torch.io import sequence_constraints as sc_mod

    top, body = synthetic_duplex(40, form="A" if model == "rna2" else "B", dtype=torch.float32, device=device)
    n = top.n_nucleotides
    sc = sc_mod.from_bps(n, np.array([[i, n - 1 - i] for i in range(1, 39)]))
    if onehot:
        up, bp = sc_mod.dseq_to_pseq(np.asarray(top.seq), sc)
    else:
        rng = np.random.default_rng(seed)
        up, bp = rng.random((sc.n_unpaired, 4)), rng.random((sc.n_bp, 4))
        up, bp = up / up.sum(1, keepdims=True), bp / bp.sum(1, keepdims=True)
    pseq = tuple(torch.as_tensor(x, dtype=torch.float32, device=device) for x in (up, bp))
    pkg = importlib.import_module(f"mythos_tpu_torch.energy.{model}")
    return pkg.create_default_energy_fn(top, device=device).with_params(pseq=pseq, pseq_constraints=sc), top, body


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["dna1", "dna2"])
def test_k2_pseq_kernel_matches_twin(card, model):
    """K2's pseq instance of each family (the hb weight from the per-slot
    factors) against its plain version on the jittered 40-bp duplex (rtol
    1e-4, atol 1e-4 max|plain|), its tally equal to band_gate_counts',
    equal bits on a second call, one launch counted for the instance; and
    on the one-hot pseq of the duplex's sequence, within that tolerance of
    the discrete instance, which counts its launch under the family."""
    e, top, body = _pseq_energy(model, card)
    _, sim = build_sim(top, KT, model=model, init_centers=body.center, init_orientation=body.orientation,
                       device=card)
    ctx = ts.prepare_stencil_context(e, sim.band, device=card)
    b = _jittered(body, torch.Generator(device="cuda").manual_seed(5))
    dyn = torch.cat([ctx.to_slots(b.center.T), ctx.to_slots(b.orientation.T)]).contiguous()
    before = dict(ts.field_grads.by_family)
    got, tally = ts._field_grads(ctx, dyn, count=True)
    assert ts.field_grads.by_family == {**before, f"{model}_pseq": before[f"{model}_pseq"] + 1}
    ref = ts.field_grads_plain(ctx, dyn)
    torch.cuda.synchronize()
    _close(got, ref)
    assert tally == ts.band_gate_counts(ctx, dyn) and tally["short"] > 0
    assert torch.equal(got, ts.field_grads(ctx, dyn))
    e1, _, _ = _pseq_energy(model, card, onehot=True)
    one = ts.field_grads(ts.prepare_stencil_context(e1, sim.band, device=card), dyn)
    before = dict(ts.field_grads.by_family)
    discrete = ts.field_grads(ts.prepare_stencil_context(sim.energy_fn, sim.band, device=card), dyn)
    assert ts.field_grads.by_family == {**before, model: before[model] + 1}
    _close(one, discrete)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["dna1", "dna2"])
def test_tile_pseq_kernels_match_plain(card, model):
    """K3's, K4's and K5's pseq instances of each family (the correction in
    the hb weight; K5 21 fields) against their plain versions on the
    jittered 40-bp duplex's block table (oxDNA1 one short table, oxDNA2 one
    full table; K2's tolerance), their pair classes those of the plain
    gate, equal bits on a second call, one launch each counted for the
    instance; K5's body fields for the term weights equal to K3's; and on
    the one-hot pseq, each within K2's tolerance of the discrete instance."""
    from mythos_tpu_torch.simulators import neighbors as tnb

    e, top, body = _pseq_energy(model, card, seed=1)
    b = _jittered(body, torch.Generator(device="cuda").manual_seed(2))
    cutoff = importlib.import_module(f"mythos_tpu_torch.energy.{model}").default_neighbor_cutoff()
    nbl = tnb.block_neighbor_list_for_topology(top, cutoff, block_size=8, init_centers=b.center,
                                               perm=tnb.strand_interleave_perm(top))
    (ctx,) = tiles.prepare_contexts(e, nbl.idx, nbl.block_size, perm=nbl.perm)
    sp, P, ids = ctx.spec, ctx.params, tiles.pad_ids(ctx.spec, nbl.idx)
    assert sp.pseq and sp.n_grad_fields == 21
    rows = tiles.dynamic_rows(ctx, to_soa(b)).contiguous()
    gt = tiles.term_weights(P, sp) * torch.linspace(0.5, 1.5, len(sp.terms), device="cuda")
    counters = (tiles.tile_forces, tiles.tile_energies, tiles.tile_row_grads)
    before = [dict(f.by_family) for f in counters]
    k3 = tiles.tile_forces(rows, P, ids, sp)
    k4 = tiles.tile_energies(rows, P, ids, sp)
    k5 = tiles.tile_row_grads(rows, P, ids, gt, sp)
    torch.cuda.synchronize()
    for f, bf in zip(counters, before, strict=True):
        assert f.by_family == {**bf, sp.branch: bf[sp.branch] + 1}
    assert k5.shape == (sp.n_pad, 21)
    _close(k3, tiles.tile_forces_plain(rows, P, ids, sp))
    _close(k4, tiles.tile_energies_plain(rows, P, ids, sp))
    _close(k5, tiles.tile_row_grads_plain(rows, P, ids, gt, sp))
    again3, c3 = tiles._tile_forces(rows, P, ids, sp, count=True)
    again4, c4 = tiles._tile_energies(rows, P, ids, sp, count=True)
    again5, c5 = tiles._tile_row_grads(rows, P, ids, gt, sp, count=True)
    assert torch.equal(k3, again3) and torch.equal(k4, again4) and torch.equal(k5, again5)
    assert _tally(c3) == _tally(c5) == tiles.tile_gate_counts(rows, P, ids, sp)
    assert _tally(c4) == tiles.tile_gate_counts(rows, P, ids, sp, triangular=True)
    body_f = tiles.tile_row_grads(rows, P, ids, tiles.term_weights(P, sp), sp)[:, : sp.n_force_fields]
    torch.testing.assert_close(body_f, k3, rtol=1e-5, atol=5e-6)
    e1, _, _ = _pseq_energy(model, card, onehot=True)
    e0 = e1.with_params(pseq=None, pseq_constraints=None)
    outs = []
    for energy in (e1, e0):
        (cx,) = tiles.prepare_contexts(energy, nbl.idx, nbl.block_size, perm=nbl.perm)
        r = tiles.dynamic_rows(cx, to_soa(b)).contiguous()
        g = tiles.term_weights(cx.params, cx.spec)
        outs.append((tiles.tile_forces(r, cx.params, ids, cx.spec), tiles.tile_energies(r, cx.params, ids, cx.spec),
                     tiles.tile_row_grads(r, cx.params, ids, g, cx.spec)[:, :16]))
    for one, discrete in zip(*outs, strict=True):
        _close(one, discrete)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stencil", "block"])
def test_pseq_run_on_card_matches_cpu(card, mode):
    """A 40-bp oxDNA1 run under a pseq, 40 steps, thermostat off, a state
    every 10: the stencil on its per-step branch (K2's pseq instance 41
    times, K1 never) and the block tier (K3's pseq instance once a step
    and once for the initial force), card vs CPU (rtol 1e-4, atol 1e-5)."""

    def run(device):
        e, top, b = _pseq_energy("dna1", device, seed=4)
        kw = dict(init_orientation=b.orientation) if mode == "stencil" else {}
        _, sim = build_sim(top, 0.0, mode=mode, model="dna1", init_centers=b.center, neighbor_update_every=10,
                           device=device, **kw)
        sim = sim.replace(energy_fn=e, save_every=10)
        return sim.run(e.opt_params(), b, 40, torch.Generator(device=device).manual_seed(0)).observables[0]

    k1, k2, k3 = dict(ts.multistep_chunk.by_family), dict(ts.field_grads.by_family), dict(tiles.tile_forces.by_family)
    gpu = run(card)
    torch.cuda.synchronize()
    if mode == "stencil":
        assert ts.field_grads.by_family == {**k2, "dna1_pseq": k2["dna1_pseq"] + 41}
        assert ts.multistep_chunk.by_family == k1
    else:
        assert tiles.tile_forces.by_family == {**k3, "dna1_pseq": k3["dna1_pseq"] + 41}
    cpu = run("cpu")
    assert gpu.center.shape == (4, 80, 3)
    torch.testing.assert_close(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
    assert not bool(torch.as_tensor(gpu.metadata["neighbor_overflow"]).any())


@pytest.mark.cuda
def test_k2_rna2_pseq_kernel_matches_twin(card):
    """K2's oxRNA2 pseq instance (stencil_field_grads_rna2_pseq) against its
    plain version on the jittered 40-bp A-form duplex (rtol 1e-4, atol 1e-4
    max|plain|), its tally equal to band_gate_counts', equal bits on a
    second call, one launch counted for ``rna2_pseq``; on the one-hot pseq
    of the duplex's sequence it gives the discrete instance's bits."""
    e, top, body = _pseq_energy("rna2", card)
    _, sim = build_sim(top, KT, model="rna2", init_centers=body.center, init_orientation=body.orientation,
                       device=card)
    ctx = ts.prepare_stencil_context(e, sim.band, device=card)
    assert ctx.branch == "rna2_pseq"
    b = _jittered(body, torch.Generator(device="cuda").manual_seed(6))
    dyn = torch.cat([ctx.to_slots(b.center.T), ctx.to_slots(b.orientation.T)]).contiguous()
    before = dict(ts.field_grads.by_family)
    got, tally = ts._field_grads(ctx, dyn, count=True)
    assert ts.field_grads.by_family == {**before, "rna2_pseq": before["rna2_pseq"] + 1}
    ref = ts.field_grads_plain(ctx, dyn)
    torch.cuda.synchronize()
    _close(got, ref)
    assert tally == ts.band_gate_counts(ctx, dyn) and tally["short"] > 0
    assert torch.equal(got, ts.field_grads(ctx, dyn))
    e1, _, _ = _pseq_energy("rna2", card, onehot=True)
    one = ts.field_grads(ts.prepare_stencil_context(e1, sim.band, device=card), dyn)
    discrete = ts.field_grads(ts.prepare_stencil_context(sim.energy_fn, sim.band, device=card), dyn)
    assert torch.equal(one, discrete)


def _na1_hybrid(device):
    """The oxNA hybrid energy of a 40-bp duplex of one DNA strand and one RNA
    strand (tests/test_torch_na1.py's composition) and its table cutoff."""
    import dataclasses

    import mythos_tpu_torch.energy.na1 as na1
    import mythos_tpu_torch.energy.rna2 as rna2
    from mythos_tpu_torch.energy.base import ComposedEnergyFunction, params_from_numpy
    from mythos_tpu_torch.io.topology import NucleotideType

    top, body = synthetic_duplex(40, dtype=torch.float32, device=device)
    top = dataclasses.replace(top, nt_type=np.array([NucleotideType.DNA] * 40 + [NucleotideType.RNA] * 40, np.int32))
    _, params = na1.default_configs()
    shared = {"stacking": {"kt": KT}, "debye": {"kt": KT, "salt_conc": 0.5}}
    fns = []
    for key, cls, cfg_cls in na1.TERMS:
        cfg = cfg_cls(**params_from_numpy(params[key] | shared.get(key, {}), device), nt_type=top.nt_type,
                      **({"half_charged_ends": True} if key == "debye" else {}))
        fns.append(cls(cfg.init_params(), top, na1.default_transform_soa_fn()))
    cut = max(fn.pair_cutoff() for fn in fns if hasattr(fn, "pair_energies")) + 2.0 * rna2.max_site_offset()
    return ComposedEnergyFunction(fns), top, body, cut


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["rna2", "na1"])
def test_block_sum_runs_on_card_launch_no_k3(card, model):
    """The block tier of the families the tile kernels do not implement --
    oxRNA2 (``build_sim(mode="block", model="rna2")``) and the oxNA hybrid
    (BlockSimulator on a non-symmetric table) -- 40 steps of the 40-bp
    duplex, thermostat off, a state every 10: the plain block sums' autograd
    as the force, K3 never launched, card vs CPU (rtol 1e-4, atol 1e-5)."""
    from mythos_tpu_torch.simulators import neighbors as tnb
    from mythos_tpu_torch.simulators.cuda import BlockSimulator

    def run(device):
        if model == "rna2":
            top, b = synthetic_duplex(40, form="A", dtype=torch.float32, device=device)
            e, sim = build_sim(top, 0.0, mode="block", model="rna2", init_centers=b.center, neighbor_update_every=10,
                               device=device)
        else:
            e, top, b, cut = _na1_hybrid(device)
            nbl = tnb.block_neighbor_list_for_topology(top, cut, block_size=8, init_centers=b.center,
                                                       perm=tnb.strand_interleave_perm(top), symmetric=False)
            sim = BlockSimulator(energy_fn=e, neighbors=nbl, dt=5e-3, kT=0.0, neighbor_update_every=10)
        assert not sim.uses_kernels()
        return sim.replace(save_every=10).run(e.opt_params(), b, 40,
                                              torch.Generator(device=device).manual_seed(0)).observables[0]

    k3 = tiles.tile_forces.launches
    gpu = run(card)
    torch.cuda.synchronize()
    assert tiles.tile_forces.launches == k3
    cpu = run("cpu")
    assert gpu.center.shape == (4, 80, 3) and gpu.center.device.type == "cuda"
    torch.testing.assert_close(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
    assert not bool(torch.as_tensor(gpu.metadata["neighbor_overflow"]).any())
