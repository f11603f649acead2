#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Usage, from the root of a checkout, on a machine with an NVIDIA H100 and
nvcc::

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. the device and its power limit;
2. build the CUDA kernels from ``mythos_tpu_torch/ops/csrc`` (nvcc, sm_90a);
3. K2 (band force) against its plain PyTorch twin on a 10k-nt duplex;
4. K1 (40-step BAOAB chunk) against its twin, same bf16 noise, at 10k nt
   (inside the float32 twin's error against a float64 twin) and at 80 nt
   (rtol 2e-4, atol 5e-5);
5. the main path: ``entry.build_sim(mode="stencil", model="dna2")`` at
   10k nt runs 2000 Langevin steps (50 chunks) through K1 and K2, and a
   40-bp run on the card agrees with the same run on the CPU twins.

The last lines are a JSON record of the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Exits non-zero without
a CUDA device. Imports torch, numpy and mythos_tpu_torch only.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N_BP = 5000
N_STEPS = 2000
KT = 296.15 * 0.1 / 300.0


def _events_ms(fn, reps: int) -> tuple[list[float], object]:
    """Per-call device times (CUDA events) of ``reps`` calls of ``fn``."""
    import torch

    times, out = [], None
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times, out


def _within(got, ref, rtol: float, atol: float) -> tuple[bool, float]:
    err = (got - ref).abs()
    return bool((err <= atol + rtol * ref.abs()).all()), float(err.max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 2

    from mythos_tpu_torch.entry import build_sim
    from mythos_tpu_torch.io.synthetic import synthetic_duplex
    from mythos_tpu_torch.ops import _build
    from mythos_tpu_torch.ops import stencil as st
    from mythos_tpu_torch.rigid_body import RigidBody

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    lib_path, nvcc_s = _build.build()
    _build.load_library()
    regs, fn = [], "?"
    for ln in (lib_path.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "registers" in ln:
            regs.append(f"{fn}: {ln.split(':', 1)[1].strip()}")
    print(f"[2 build] {lib_path.name}: nvcc {nvcc_s:.1f} s, total {time.perf_counter() - t0:.1f} s; "
          + " | ".join(regs))

    # setup: the 10k-nt duplex, its band and stencil context
    topology, body = synthetic_duplex(N_BP, dtype=torch.float32, device=dev)
    energy_fn, sim = build_sim(
        topology, KT, init_centers=body.center, init_orientation=body.orientation, device=dev
    )
    ctx = st.prepare_stencil_context(energy_fn, sim.band, device=dev)
    n = ctx.n
    dyn = torch.cat([ctx.to_slots(body.center.T), ctx.to_slots(body.orientation.T)]).contiguous()

    # 3. K2 vs twin
    k2_ms, k2 = _events_ms(lambda: st.field_grads(ctx, dyn), 20)
    tw_ms, twin = _events_ms(lambda: st.field_grads_plain(ctx, dyn), 20)
    scale = float(twin.abs().max())
    ok2, err2 = _within(k2, twin, rtol=1e-4, atol=1e-4 * scale)
    print(f"[3 K2] n={n} w_terms={ctx.w_terms} w_wide={ctx.w_wide} max_abs_err={err2:.3e} "
          f"(atol {1e-4 * scale:.3e}, rtol 1e-4) kernel {statistics.median(k2_ms):.4f} ms "
          f"twin {statistics.median(tw_ms):.4f} ms")
    if not ok2:
        raise SystemExit("K2 disagrees with its twin")

    # 4. K1 vs twin: one 40-step chunk from a jittered (off-lattice) state,
    # same bf16 noise. At 10k nt the duplex spans |z| ~ 2000, where a float32
    # ulp is 1.2e-4, so any two float32 orderings drift apart over 40 steps;
    # the kernel must stay inside the float32 twin's own error against the
    # float64 twin (per row: |K1 - f32| <= 2 |f32 - f64| + 5e-5 + 2e-4 max|row|)
    gen = torch.Generator(device=dev).manual_seed(1)

    def jittered(b):
        q = b.orientation + 0.01 * torch.randn(b.orientation.shape, generator=gen, device=dev)
        c = b.center + 0.01 * torch.randn(b.center.shape, generator=gen, device=dev)
        return RigidBody(c, q / q.norm(dim=-1, keepdim=True))

    state = sim.initial_state(ctx, jittered(body), gen)
    u = sim.neighbor_update_every
    noise = torch.randn((u, 6, n), generator=gen, device=dev).to(torch.bfloat16)
    ou = st.ou_constants(sim.dt, sim.kT, [sim.mass], [sim.inertia], [sim.gamma_t], [sim.gamma_r]).vector(dev)
    k1_ms, k1 = _events_ms(lambda: st.multistep_chunk(ctx, ou, noise, state), 5)
    tw1_ms, twin1 = _events_ms(lambda: st.multistep_chunk_plain(ctx, ou, noise, state), 2)
    twin64 = st.multistep_chunk_plain(ctx.astype(torch.float64), ou.double(), noise, state.double())
    err_k = (k1 - twin1).abs().amax(1).double()
    err_32 = (twin1.double() - twin64).abs().amax(1)
    limit = 2 * err_32 + 5e-5 + 2e-4 * twin64.abs().amax(1)
    err1 = float(err_k.max())
    fixed_ok, _ = _within(k1, twin1, rtol=2e-4, atol=5e-5)
    rows = " ".join(f"{r}:{float(a):.1e}/{float(b):.1e}" for r, (a, b) in enumerate(zip(err_k, err_32)))
    print(f"[4 K1] {u} steps at {n} nt: max|K1-twin|={err1:.3e}; rtol 2e-4/atol 5e-5 met: {fixed_ok}; "
          f"kernel {statistics.median(k1_ms):.3f} ms twin {statistics.median(tw1_ms):.3f} ms; "
          f"row:|K1-f32|/|f32-f64| {rows}")
    if not bool((err_k <= limit).all()):
        raise SystemExit("K1 is outside the float32 error budget of its twin")

    # 4b. the same chunk at 40 bp over 4 steps, held to the fixed tolerance
    # the reference holds its Pallas kernel to (tests/test_multistep.py:112)
    top_s, body_s = synthetic_duplex(40, dtype=torch.float32, device=dev)
    _, sim_s = build_sim(top_s, KT, init_centers=body_s.center, init_orientation=body_s.orientation, device=dev)
    ctx_s = st.prepare_stencil_context(sim_s.energy_fn, sim_s.band, device=dev)
    state_s = sim_s.initial_state(ctx_s, jittered(body_s), gen)
    noise_s = torch.randn((4, 6, ctx_s.n), generator=gen, device=dev).to(torch.bfloat16)
    ok1s, err1s = _within(
        st.multistep_chunk(ctx_s, ou, noise_s, state_s), st.multistep_chunk_plain(ctx_s, ou, noise_s, state_s),
        rtol=2e-4, atol=5e-5,
    )
    print(f"[4 K1 small] 4 steps at 80 nt: max_abs_err={err1s:.3e} (rtol 2e-4, atol 5e-5) ok={ok1s}")
    if not ok1s:
        raise SystemExit("K1 disagrees with its twin at 80 nt")

    # 5a. the main path at 10k nt: warm-up run, then the counted, timed run
    params = energy_fn.opt_params()
    sim.run(params, body, N_STEPS, torch.Generator(device=dev).manual_seed(2))
    st.field_grads.launches = 0
    st.multistep_chunk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.run(params, body, N_STEPS, torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"K1": st.multistep_chunk.launches, "K2": st.field_grads.launches}
    traj = out.observables[0]
    finite = bool(torch.isfinite(traj.center).all() and torch.isfinite(traj.orientation).all())
    qdev = float((traj.orientation.norm(dim=-1) - 1.0).abs().max())
    overflow = bool(traj.metadata["neighbor_overflow"].any())
    steps_per_min = N_STEPS / elapsed * 60.0
    print(f"[5 main path] {N_STEPS} steps at {n} nt: {elapsed:.3f} s = {steps_per_min:.1f} steps/min on "
          f"{smi}; states {tuple(traj.center.shape)} finite={finite} max||q|-1|={qdev:.2e} "
          f"overflow={overflow} launches={launches}")
    if not finite or qdev > 1e-5 or overflow:
        raise SystemExit("main path produced a bad trajectory")
    if launches["K1"] != N_STEPS // u or launches["K2"] < 1:
        raise SystemExit(f"main path did not run through the kernels: {launches}")

    # 5b. a small input on the card agrees with the CPU twins (thermostat off)
    def small_run(device):
        top, b = synthetic_duplex(40, dtype=torch.float32, device=device)
        e, s = build_sim(top, 0.0, init_centers=b.center, init_orientation=b.orientation,
                         neighbor_update_every=10, device=device)
        o = s.replace(save_every=10).run(e.opt_params(), b, 40, torch.Generator(device=device).manual_seed(0))
        return o.observables[0]

    gpu, cpu = small_run(dev), small_run("cpu")
    okc, errc = _within(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    okq, errq = _within(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
    print(f"[5 small input] 40 bp, 40 steps, kT=0: card vs CPU twins center err {errc:.2e} quat err {errq:.2e}")
    if not (okc and okq):
        raise SystemExit("the card's trajectory disagrees with the CPU twins")

    kernels = [
        {"name": "K1 multistep_chunk", "route": "cuda", "source": "mythos_tpu_torch/ops/csrc/multistep.cu",
         "replaces": "mythos_tpu/ops/stencil.py:2236", "launches": launches["K1"], "max_abs_err": err1,
         "ms": statistics.median(k1_ms), "plain_ms": statistics.median(tw1_ms)},
        {"name": "K2 field_grads", "route": "cuda", "source": "mythos_tpu_torch/ops/csrc/stencil_grads.cu",
         "replaces": "mythos_tpu/ops/stencil.py:1420", "launches": launches["K2"], "max_abs_err": err2,
         "ms": statistics.median(k2_ms), "plain_ms": statistics.median(tw_ms)},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
