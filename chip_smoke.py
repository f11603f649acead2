#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Usage, from the root of a checkout, on a machine with an NVIDIA H100 and
nvcc::

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. the device and its power limit;
2. build the CUDA kernels from ``mythos_tpu_torch/ops/csrc`` (nvcc, sm_90a);
3. K2 (band force) against its plain PyTorch twin on the 10k-nt duplex
   (K2's tolerance), equal bits on a second call, its tally of the band
   pairs by gate against the plain gate (``band_gate_counts``), its
   registers and spill (none), its device time a call;
4. K1 (40-step BAOAB chunk) against its twin, same bf16 noise, at 10k nt
   (inside the float32 twin's error against a float64 twin; equal bits on
   a second call; its kernel launches a chunk, counted by torch.profiler)
   and at 80 nt (rtol 2e-4, atol 5e-5);
5. the main path: ``entry.build_sim(mode="stencil", model="dna2")`` at
   10k nt runs 2000 Langevin steps (50 chunks) through K1 and K2, then 10
   chunks under torch.profiler (launches a step, K1's share), and a 40-bp
   run on the card agrees with the same run on the CPU twins;
6. the tile kernels K3 (forces), K4 (energies) and K5 (row gradients)
   against their plain versions at 10k nt, on the block tables of a
   0.01-jittered ideal duplex and of the 270-degree arc: K2's tolerance,
   else the float32 budget of phase 4 against a float64 plain version,
   taken apart over the rows off and near the float32 arccos clamp (the
   worst element's pair is named and moved to show the gap follows it);
   K3's plain gate against the reaches of ``dna2.per_term_site_cutoffs``,
   each kernel's pair classes (short-range, Debye only, skipped) by its own
   tally against the plain gate's (K4's under the triangular mask), equal
   bits on a second call, and each kernel's device time a call
   (torch.profiler) beside its time by CUDA events;
7. the block tier: ``build_sim(mode="block", block_size=8)`` on the
   10k-nt duplex bent into a 270-degree arc, 400 steps through K3;
8. one DiffTRe step at 10k nt (after a warm-up step): stencil MD (K1,
   K2), the tile map of 10 states (K4; backward K5), propeller-twist
   loss, gradients, one Adam step; and (8b) a 40-bp DiffTRe loss and its gradients on fixed states
   agree between the card and the CPU plain versions;
9. MARTINI: (9a) K6 forward and backward (position and box gradients)
   against their plain versions on the 10,160-bead bilayer
   ``lattice_bilayer(16, 16, water_layers=6)`` jittered by 0.03 nm (energy
   rtol 2e-5; gradients rtol 2e-4 / atol 1e-4 max|plain|, else the float32
   budget of phase 4 per column), also with the beads permuted and with
   the box and positions scaled by 0.98 / 0.98 / 1.02, and with the beads
   moved across the faces of a 70 x 70 x 10.84 nm box (more cells of side
   ``LJ_CELL`` than the cell build holds, so coarser ones), each case
   deterministic, the cells each direction built equal to
   ``cell_list_plain``'s, and under ``LJPairEnergy`` one cell build serving
   both directions with the gradients of ``lj_grads`` bit for bit; the
   candidate pairs a call, each direction's launches and device time a
   call, and each bound (counting only the mask words that hold the bits
   of the pairs inside the cutoff) beside the first design's;
   (9b) 1000 NPT steps of that bilayer
   through ``MartiniSimulator`` (barostat every 10, a state every 50)
   after a warm-up run, one cell build a force evaluation, with a
   torch.profiler window; (9c) 50 NPT steps of
   the 104-bead bilayer with the same pre-drawn noise agree between the
   card and the CPU plain versions;
10. the oxRNA2 main path on the 10k-nt A-form duplex
   (``synthetic_duplex(5000, form="A")``, the A-form band slacks, site
   margin 2): (10a) K2's rna2 instance against its plain version on a
   jittered state (K2's tolerance; as phase 6, the slots with a pair at
   the float32 arccos clamp, else all, may take the float32 budget of
   phase 4), its bits, tally, registers and spill as in phase 3, and at 80
   nt on three coaxially stacked pairs (coaxial stacking alone);
   (10b) K1's rna2 instance, one 40-step chunk against its plain version
   with the same bf16 noise, at 10k nt inside the float32 budget of phase
   4 and at 80 nt to rtol 2e-4 / atol 5e-5 (else that budget), equal bits
   on a second call; (10c) ``build_sim(mode="stencil", model="rna2")``
   runs 2000 steps (50 chunks) after a warm-up run, with a torch.profiler
   window, and a 40-bp run on the card agrees with the CPU; (10d) the
   same run from the B-form helix, its overflow flag printed;
11. the stencil's per-step branch (``save_every`` 1) at 10k nt: oxDNA2 400
   steps and oxRNA2 120 steps after a warm-up run, a state emitted every
   step, K2 launched once a step and once for the initial force, K1 never,
   no overflow; a torch.profiler window of 10 steps (launches a step, idle
   share, K2's device time a call and its share of a step); 40-bp
   per-step runs of both families and of the block tier, card vs CPU;
12. direct differentiation through ``CudaSimulator.run`` (d loss / d every
   parameter by ``loss.backward()``; K1 and K2 forward, their plain
   versions backward): (12a) the reference's configuration, 1,000 nt, the
   propeller-twist loss through 80 steps (2 chunks; the reference's 200,
   cut for time) after a 40-step
   warm-up -- finite, nonzero, d / d eps_stack_base nonzero, K1 launched 2
   times and K2 once, the forward's and the backward's seconds, peak
   memory; (12b) 40 bp, one 40-step chunk at kT 0 from a jittered state,
   card vs CPU for oxDNA2 and oxRNA2 (loss rtol 1e-5, gradients rtol 1e-2
   / atol 1e-3 max|grad|); (12c) the per-step branch at 1,000 nt, 40
   steps in 4 rebuild intervals, ``checkpoint_every`` 1 (K2 41 times
   forward, 40 more in the backward) against 0 (the same gradient, rtol
   1e-5), with the memory the graph holds after the forward and the
   peak's rise over the evaluation, each; (12d) oxRNA2 at
   1,000 nt, 40 steps through K1's rna2 instance;
13. direct differentiation through ``BlockSimulator.run`` (K3 forward
   through ``TileForces``, its plain version backward): (13a) 1,000 nt
   under ``build_sim(mode="block")``, the propeller-twist loss through 80
   steps (200 before phase 17) after a 40-step warm-up -- finite, nonzero, d / d eps_stack_base
   nonzero, K3 launched as in the same run without gradients and never in
   the backward, the forward's and backward's seconds, peak memory; (13b)
   40 bp, 40 steps at kT 0 from a jittered state, card vs CPU (loss rtol
   1e-5, gradients rtol 1e-2 / atol 1e-3 max|grad|); (13c) 1,000 nt, 40
   steps in 4 rebuild intervals, ``checkpoint_every`` 1 against 0 (the same
   gradient, rtol 1e-5; K3 in the forward and the recompute; the memory
   held after the forward and the peak's rise); (13d) the 10k-nt
   270-degree arc of phase 7, 40 steps, a loss on the last state;
14. direct differentiation through ``MartiniSimulator.run`` with the
   barostat (K6 forward, ``LJGrads``' plain double backward): (14a) the
   reference example's fit, 5 Adam steps (lr 0.1) on lj_epsilon_C1_C1 from
   3.5, each 300 NPT steps of ``lattice_bilayer(4, 4, water_layers=2)`` at
   dt 0.02, loss (mean of the last 3 APLs - 0.64)^2; (14b) the 10,160-bead
   bilayer, 50 steps, d (mean APL) / d lj_epsilon_C1_C1, K6 launched as
   without gradients and never in the backward; (14c) the 104-bead bilayer
   with the same pre-drawn noise, card vs CPU (loss rtol 1e-4 / atol
   1e-5, gradients rtol 1e-2 / atol 1e-3 max|grad|);
15. oxDNA1 (no Debye-Hueckel term): (15a) K2's dna1 instance against its
   plain version on the 0.01-jittered 10k-nt duplex (as 10a; its tally
   with no Debye class), its bits, registers and spill, its device time a
   call; (15b) K1's dna1 instance, one 40-step chunk with the same bf16
   noise, at 10k nt inside the float32 budget of phase 4 and at 80 nt to
   rtol 2e-4 / atol 5e-5 (else that budget); (15c)
   ``build_sim(mode="stencil", model="dna1")`` at 10k nt, 2000 steps after
   a warm-up run, a torch.profiler window, the overflow flag printed, 40
   bp card vs CPU; (15d) K3's dna1 instance against its plain version on
   the one-level tables of the jittered duplex and of the 270-degree arc
   (phase 6's tolerances and tallies), then ``build_sim(mode="block",
   model="dna1")`` on the arc, 200 steps, and 40 bp card vs CPU; (15e) the
   small-system path: ``entry.entry()``'s 8-bp step 100 times, a 40-bp
   duplex written as oxDNA files and read back by the port's readers,
   ``build_sim(mode="pairs", model="dna1")`` on them for 150 steps (no
   kernel: autograd on the card; 1000 before phase 16 came), 40 steps card
   vs CPU;
16. DiffTRe under oxDNA1: (16a) K4's and K5's dna1 instances against
   their plain versions on the 0.01-jittered 10k-nt duplex's B = 8 table
   (phase 6's tolerances), their tallies against ``tile_gate_counts``,
   bits, registers and spill, device time a call; (16b) the reference
   example's fit at full width: ``BoundSimulator`` over the dna1 stencil
   (10,000 MD steps a simulation, a state every 200, 10 equilibration
   states), ``DiffTReObjective`` on the tile map (K4, K5), the
   propeller-twist loss through ``ObservableLossFn``, ``SimpleOptimizer``
   with Adam (lr 1e-3) and ``ConsoleLogger``, 5 steps -- finite loss and
   gradients, ``eps_stack_base`` moves, no overflow, n_eff printed each
   step, seconds a step, the map's states/s, K4's and K5's launches; (16c)
   the example's own ``main()`` on a 40-bp duplex from oxDNA files (200 MD
   steps on the pair list, 1 Adam step), its first step's loss and
   gradients card vs CPU (rtol 1e-4, atol 1e-5 max|grad|); (16d) the
   native trajectory parser on the fit's 10k-nt, 50-state trajectory,
   equal to the numpy parser's;
17. probabilistic sequences (sequence design): a ``bp_pseq`` over the
   10k-nt duplex's 5,000 base pairs drawn from a seed with numpy; (17a)
   the pseq instances of K2 (oxDNA1, oxDNA2) and of K3, K4 and K5 (K5's 21
   fields; oxDNA1's short table, oxDNA2's full table) against their plain
   versions on the 0.01-jittered duplex (phase 6's tolerances and
   tallies), bits, registers and spill, device time a call; (17b) each on
   the one-hot pseq of the duplex's sequence within K2's tolerance of its
   discrete instance; (17c) a sequence-design step under oxDNA1: 400 steps
   on the stencil's per-step branch (a state every 40; K1 refuses a pseq),
   the propeller-twist DiffTRe loss over the 10 states on a B = 8 table
   (K4, backward K5) and d loss / d bp_pseq, also through
   ``DiffTReObjective``, the seconds of MD, map and backward; oxDNA2's
   step at 40 steps, and 40 block-tier steps of each family under the
   pseq, every pseq instance's launches counted; (17d) the pseq energy of
   a 40-bp duplex on the tile map and d E / d bp_pseq card vs CPU (rtol
   1e-4, atol 1e-5 max|grad|);
18. the model paths the reference runs on XLA alone (``_rna2_na1``): (18a)
   K2's oxRNA2 pseq instance against its plain version on the 0.01-jittered
   10k-nt A-form duplex (slots off and at the float32 arccos clamp apart,
   as phase 10a), its bits, registers and spill, device time a call and
   bound, and on the one-hot pseq the discrete instance's bits; (18b) the
   oxRNA2 block tier at 10k nt (B = 8, one non-symmetric table, the plain
   block sums' autograd as the force), 100 steps: steps/min, kernel
   launches and device time of a force evaluation, peak memory, the
   overflow flag, no K3 launch, while 40 dna2 block steps launch K3; (18c)
   an oxRNA2 DiffTRe step: 400 stencil steps (K1 rna2), the 10 states
   mapped through the block sums on one table that each of them must not
   outgrow, the propeller-twist loss and finite gradients, the seconds of
   MD, map and backward; (18d) the oxNA hybrid: 40 block-tier steps of a
   10k-nt DNA/RNA duplex, then a 40-bp one on ``PairSimulator`` over a
   ``FixedCapacityNeighborList`` (100 steps, rebuilt every 10), and 10
   kT-0 steps (rebuilt every 5) card vs CPU; (18e) an oxRNA2
   sequence-design step at 10k nt, 40 steps on the stencil's per-step
   branch (K2's rna2 pseq instance 41 times, K1 none) and d loss / d
   bp_pseq through the block sums.

With ``--against DIR`` (a checkout of another commit, e.g. the parent),
phases 3 and 4 also build DIR's kernels and say whether its K1 gives this
checkout's bits on their inputs, and its K2 this checkout's values within
K2's tolerance.

The last lines are a JSON record of the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Exits non-zero without
a CUDA device. Imports torch, numpy and mythos_tpu_torch only.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

_LAPS = [time.perf_counter()]  # the script's start, then the end of each phase
N_BP = 5000
N_STEPS = 2000
KT = 296.15 * 0.1 / 300.0
BLOCK_STEPS = 400  # phase 7
DIFFTRE_STEPS, DIFFTRE_SAVE = 400, 40  # phase 8: 10 states
RNA2_COAX_PAIRS = ((10, 11), (30, 33), (50, 57))  # phase 10a: slot pairs placed coaxially stacked (80 nt)

#: the H100 SXM's published peaks (data sheet, 700 W): HBM bytes/s, fp32
#: (non-tensor) FLOP/s -- the bound of a kernel is the larger of its bytes
#: and its operations over these
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
#: operations per unit of work, estimated from the kernels' source
#: (stencil_physics.cuh): an unbonded pair with all five terms, its value
#: and the gradient on both bodies; its value alone; the weight-free hb
#: product; a Debye-only pair (gradient, value); a bonded pair's gradient;
#: one particle's BAOAB update (two exact rotors)
FLOP_PAIR_GRAD, FLOP_PAIR_ENERGY, FLOP_PAIR_HB = 1500, 650, 220
FLOP_DEBYE_GRAD, FLOP_DEBYE_ENERGY = 45, 35
FLOP_BOND_GRAD, FLOP_BODY_STEP = 900, 250
#: oxRNA2's bonded pair: a fourth arccos, the p3/p5 axes and the stacking
#: sites on (a1, a2) (bonded_pair_rna2); its unbonded pair is charged as
#: oxDNA2's (no theta4 in cross stacking, the phi cosines in coax)
FLOP_BOND_GRAD_RNA2 = 1100
#: K6 (ops/csrc/lj.cu), per unordered pair: the minimum-image distance
#: test; the LJ value, or its gradient on both beads and the box. The bound
#: charges both only to the pairs inside the cutoff (the others need no
#: work); the kernels' tests of their other candidates are their own cost
FLOP_LJ_TEST, FLOP_LJ_ENERGY, FLOP_LJ_GRAD = 22, 12, 30
MARTINI_LATTICE = (16, 16, 6)  # phase 9: 512 lipids, 8,112 waters, 10,160 beads
MARTINI_STEPS, MARTINI_SAVE, MARTINI_WARM = 1000, 50, 50
MARTINI_BAROSTAT = {"pressure0": 1.0, "tau": 4.0, "every": 10}
#: phase 11: a state every step (200 x 7 x 10k floats: 56 MB), a multiple of the 40-step
#: rebuild interval; 400 / 200 until phase 17 came
PER_STEP_STEPS = {"dna2": 200, "rna2": 120}
#: the profiled steps of the host-bound runs (phases 7, 11, 15d, 15e), each
#: on its own rebuild interval: the profiler's post-processing costs tens of
#: seconds a window of ~10^5 launches, and a launch count a step needs few
#: steps (40, 40, 40 and 20 before PR 15's review)
PROFILE_STEPS = 10
PER_STEP_WINDOW = PROFILE_STEPS
#: phase 12: the reference's direct-differentiation configuration
#: (benchmarks/RESULTS.md, "Direct differentiation"): 1,000 nt, 200 steps
#: (cut to 80, 2 chunks, to make room for phase 17) after a 40-step
#: warm-up; 40 per-step steps; 40 oxRNA2 steps (80 before phase 17)
DIRECT_N_BP, DIRECT_STEPS, DIRECT_WARM = 500, 80, 40
DIRECT_PER_STEP, DIRECT_RNA2_STEPS = 40, 40
#: phase 14: the reference example's fit (examples/martini_bilayer_native.py:
#: 5 Adam steps, each a 300-step NPT run of lattice_bilayer(4, 4, 2)), and
#: 50 steps of phase 9's bilayer
MARTINI_FIT_LATTICE, MARTINI_FIT_STEPS, MARTINI_FIT_MD = (4, 4, 2), 5, 300
MARTINI_DIRECT_STEPS = 50
WIDE_BOX = (70.0, 70.0, 10.84)  # phase 9a: floor(box / LJ_CELL) gives 63 x 63 x 9 > MAX_CELLS cells
#: a row is "near the clamp" when one of its pairs inside the short-range
#: reach has an angle cosine within this many float32 ulps of +-1
#: (arccos_poly clamps 8 ulps inside; two float32 orderings of a cosine
#: differ by a few ulps)
CLAMP_ULPS = 32
#: the kernels' template argument of each model family (stencil_physics.cuh FAM_*)
FAMILY_CODE = {"dna2": 0, "rna2": 1, "dna1": 2}
#: phase 15: oxDNA1's block run on the arc (phase 7 runs 400), the
#: small-system path's duplex, its steps, and entry()'s steps
DNA1_BLOCK_STEPS = 200
SMALL_BP, SMALL_STEPS, ENTRY_STEPS = 40, 150, 100  # 15e: 1000, 300 before phases 16, 17
#: phase 16: the DiffTRe fit under oxDNA1 at 10k nt (MD steps a simulation,
#: a state every FIT_SAVE steps, equilibration states sliced off, Adam
#: steps at FIT_LR; the reference example's 100-step cadence is no multiple
#: of the 40-step chunk, its 50 optimizer steps are cut for time), the
#: example's own shape at 40 bp (cut for time), the parser's states
FIT_MD_STEPS, FIT_SAVE, FIT_EQ, FIT_OPT_STEPS, FIT_LR = 10_000, 200, 10, 5, 1e-3
EXAMPLE_MD, EXAMPLE_SAVE, EXAMPLE_EQ, EXAMPLE_OPT = 200, 10, 5, 1  # 2 Adam steps before phase 17
#: phase 17: the seed of bp_pseq, the oxDNA1 sequence-design step's MD steps
#: on the per-step branch and its cadence (10 states), and the shorter
#: oxDNA2 step's and the block runs' steps (4 states)
PSEQ_SEED = 41
PSEQ_MD_STEPS, PSEQ_SAVE = 400, 40
PSEQ_SHORT_STEPS, PSEQ_SHORT_SAVE = 40, 10
#: phase 18: the steps and rebuild cadence of the rna2 and na1 block runs
#: (the host-bound block sums take 0.1-0.4 s a step; na1's 10k-nt run is
#: cut to 40 steps, two rebuilds, for the script's time), the rna2 DiffTRe
#: step's stencil steps and cadence (10 states), the na1 pair-list run's
#: duplex, steps (cut from 150 for time) and rebuild cadence, its
#: card-vs-CPU steps and their rebuild cadence, and the rna2
#: sequence-design step's per-step steps and cadence (4 states)
RNA2_BLOCK_STEPS, RNA2_BLOCK_UPDATE = 100, 50
NA1_BLOCK_STEPS, NA1_BLOCK_UPDATE = 40, 20
RNA2_DIFFTRE_MD, RNA2_DIFFTRE_SAVE = 400, 40
NA1_SMALL_BP, NA1_SMALL_STEPS, NA1_SMALL_UPDATE = 40, 100, 10
NA1_CMP_STEPS, NA1_CMP_UPDATE = 10, 5
RNA2_PSEQ_STEPS, RNA2_PSEQ_SAVE = 40, 10


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


def _dev_us(e) -> float:
    """Device microseconds of a torch.profiler key average (the attribute
    was renamed between torch versions)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _profiled(fn, reps: int = 1) -> dict:
    """``reps`` calls of ``fn`` in one torch.profiler window ended by a
    device synchronise, totals over the window: ``wall_ms`` (host clock,
    the profiler's overhead included), ``device_ms`` (kernel time on the
    device), ``launches`` (kernel launches), ``kernels`` {name: (device ms,
    kernel events recorded)} -- the profiler may record fewer kernel events
    than launches -- and ``host``, the five host ops of most self time as
    (name, ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    on_dev = [str(getattr(e, "device_type", "")).endswith("CUDA") for e in ev]
    host = sorted((e for e, d in zip(ev, on_dev) if not d), key=lambda e: e.self_cpu_time_total, reverse=True)
    return {
        "wall_ms": wall_ms,
        "device_ms": sum(_dev_us(e) for e, d in zip(ev, on_dev) if d) / 1e3,
        "launches": sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernel")),
        "kernels": {e.key: (_dev_us(e) / 1e3, e.count) for e, d in zip(ev, on_dev) if d and e.count},
        "host": [(e.key, e.self_cpu_time_total / 1e3) for e in host[:5]],
    }


def _kernel_list(window: dict) -> str:
    """"name: device ms a kernel event (events recorded)" of each kernel of a
    :func:`_profiled` window."""
    return ", ".join(f"{k.split('(')[0]}: {ms / c:.4f} ms ({c})" for k, (ms, c) in window["kernels"].items())


def _per_call(window: dict, launches: dict) -> float:
    """Device ms a call from a :func:`_profiled` window: each kernel's mean
    time a recorded event (the profiler may record fewer events than
    launches) times its launches a call, ``{name fragment: launches}``; 0
    where it recorded none."""
    total = 0.0
    for frag, k in launches.items():
        hits = [(ms, c) for key, (ms, c) in window["kernels"].items() if frag in key]
        total += sum(ms for ms, _ in hits) / max(1, sum(c for _, c in hits)) * k
    return total


def _kernels_ms(window: dict, prefix: str) -> float:
    """Device ms a call of the kernels of a :func:`_profiled` window whose
    name starts with ``prefix`` (a template instance's name reads "void
    name<argument>(...)"): each one's mean time a recorded event, summed."""
    return sum(ms / c for k, (ms, c) in window["kernels"].items() if k.removeprefix("void ").startswith(prefix))


def _lap(phase: str) -> None:
    """Print the wall seconds of the phase just ended and of the script so
    far, the process's peak host memory and the card memory the allocator
    holds."""
    import resource

    import torch

    _LAPS.append(time.perf_counter())
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB -> GiB
    held = torch.cuda.memory_reserved() / 2**30 if torch.cuda.is_available() else 0.0
    print(f"[time] {phase}: {_LAPS[-1] - _LAPS[-2]:.1f} s (script so far {_LAPS[-1] - _LAPS[0]:.1f} s; peak host "
          f"memory {rss:.1f} GiB, card memory held {held:.1f} GiB)", flush=True)


def _within(got, ref, rtol: float, atol: float) -> tuple[bool, float]:
    err = (got - ref).abs()
    return bool((err <= atol + rtol * ref.abs()).all()), float(err.max())


def _share(bound_ms: float, ms: float) -> str:
    """The bound's share of a time, or "not measured" where the time is 0."""
    return f"{bound_ms / ms:.2%}" if ms > 0 else "not measured"


def _dev(ms: float) -> str:
    """A device time, or "not measured" where the profiler recorded no kernel."""
    return f"{ms:.4f} ms" if ms > 0 else "not measured"


def _bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    t_b, t_o = n_bytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def _checked(name, got, plain, plain64, near=None):
    """K2's tolerance (rtol 1e-4, atol 1e-4 max|plain|); failing that, per
    group of rows -- those off and those near the float32 arccos clamp
    (``near``: the rows of a row-shaped output with a pair at the clamp),
    or all rows without it -- K2's tolerance or else the float32 budget of
    phase 4 per output column, over the group's rows: max|kernel - f32| <=
    2 max|f32 - f64| + 5e-5 + 2e-4 max|f64|. (ok, rule, max_abs_err)."""
    atol = 1e-4 * float(plain.abs().max())
    ok, err = _within(got, plain, rtol=1e-4, atol=atol)
    if ok:
        return True, "K2 tolerance", err
    g, p, p64 = (x.double().reshape(x.shape[0], -1) if x.dim() > 1 else x.double()[:, None]
                 for x in (got, plain, plain64))
    groups = [("all rows", slice(None))]
    if near is not None and g.shape[0] == near.shape[0]:
        groups = [(f"{int((~near).sum())} rows off the clamp", ~near), (f"{int(near.sum())} near it", near)]
    ok, rules = True, []
    for label, sel in groups:
        if g[sel].numel() == 0:
            continue
        ok_g, err_g = _within(got[sel], plain[sel], rtol=1e-4, atol=atol)
        if ok_g:
            rules.append(f"{label}: K2 tolerance, err {err_g:.2e}")
            continue
        gs, ps, p64s = g[sel], p[sel], p64[sel]
        err_k = (gs - ps).abs().amax(0)
        limit = 2 * (ps - p64s).abs().amax(0) + 5e-5 + 2e-4 * p64s.abs().amax(0)
        ok_g = bool((err_k <= limit).all())
        ok = ok and ok_g
        rules.append(f"{label}: float64 budget, err {err_g:.2e}")

        def col(v):
            return [f"{x:.1e}" for x in v.tolist()]

        print(f"    {name} {label}: column max|kernel-f32| {col(err_k)} |kernel-f64| {col((gs - p64s).abs().amax(0))} "
              f"|f32-f64| {col((ps - p64s).abs().amax(0))} limit {col(limit)} ok={ok_g}")
    return ok, "; ".join(rules), err


def _pair_geometry(ctx, ids, rows, site_cutoffs):
    """Per pair of a full/short-kind tile table, (nb, B, M) each: the full
    and triangular masks, the pairs inside the short-range, hydrogen-bond
    and Debye-only reaches (bare site distance against each term's site
    cutoff, dna2.per_term_site_cutoffs), and the distance of the pair's
    nearest-aligned angle cosine to +-1 in float32 ulps with that angle's
    index (float64 cosines: the 6 of hb/cross-stacking, then coax's 2)."""
    import torch

    from mythos_tpu_torch.ops import tiles

    sp = ctx.spec
    nb, b_sz = sp.n_blocks, sp.block_size
    ri, cj = tiles._split(rows, tiles._gather_cols(rows, ids, sp), sp)
    full = tiles._tile_mask(ri, cj, sp, triangular=False)
    tri = tiles._tile_mask(ri, cj, sp, triangular=True)
    r64 = rows.double()
    com, a1, a2, a3 = (r64[:, k : k + 3] for k in (0, 3, 6, 9))
    sites = {nm: com + cf[0] * a1 + cf[1] * a2 for nm, cf in site_cutoffs["sites"].items()}
    cols = (ids.long().clamp(max=nb - 1)[:, :, None] * b_sz + torch.arange(b_sz, device=ids.device)).reshape(nb, -1)

    def at_row(x):
        return x.reshape(nb, b_sz, 1, -1)

    def at_col(x):
        return x[cols][:, None]

    def sep(fa, fb):
        return at_col(sites[fb]) - at_row(sites[fa])

    def reach(pairs):
        hit = torch.zeros_like(full)
        for fa, fb, cut in pairs:
            hit |= (sep(fa, fb) ** 2).sum(-1) < cut * cut
            if fa != fb:
                hit |= (sep(fb, fa) ** 2).sum(-1) < cut * cut
        return hit

    terms = site_cutoffs["terms"]
    short = reach([pr for nm in tiles.KIND_TERMS["short"] for pr in terms[nm]])
    debye = (reach(terms["Debye"]) & ~short) if "Debye" in sp.terms else torch.zeros_like(short)
    hb = reach(terms["HydrogenBonding"])

    def unit(v):
        return v / v.norm(dim=-1, keepdim=True)

    def dot(x, y):
        return (x * y).sum(-1)

    u, us = unit(sep("base", "base")), unit(sep("stack", "stack"))
    a1i, a3i, a1j, a3j = at_row(a1), at_row(a3), at_col(a1), at_col(a3)
    cos = torch.stack([-dot(a1i, a1j), -dot(a1j, u), dot(a1i, u), dot(a3i, a3j), -dot(a3j, u), dot(a3i, u),
                       dot(a3i, us), -dot(a3j, us)], dim=-1)
    ulps, angle = ((1.0 - cos.abs()) / torch.finfo(torch.float32).eps).min(dim=-1)
    return full, tri, short, hb, debye, ulps, angle


def _worst_pair(got, plain, rows, params, ids, sp, geo, perm):
    """Name the pair behind the worst element of a row-shaped kernel output:
    the row's pairs' float32 and float64 row-side gradients (the plain
    formulas, one pair at a time), the pair whose two differ most in that
    column, and its nearest-aligned angle's distance to the clamp.
    (text, (row, column, partner row), original order of the slots)."""
    import torch

    from mythos_tpu_torch.ops import tiles

    nb, b_sz, f = sp.n_blocks, sp.block_size, sp.n_fields
    full, _, short, _, _, ulps, angle = geo
    r, k = divmod(int((got - plain).abs().argmax()), got.shape[1])
    blk, lane = divmod(r, b_sz)
    keep = full[blk, lane]
    cols = (ids[blk].long().clamp(max=nb - 1)[:, None] * b_sz + torch.arange(b_sz, device=ids.device)).reshape(-1)
    js = cols[keep]

    def pair_grads(x, p):
        with torch.enable_grad():
            ri = x[r].expand(len(js), f).clone().reshape(-1, 1, 1, f).requires_grad_(True)
            terms, _ = tiles._tile_terms(ri, x[js].reshape(-1, 1, 1, f), p, sp)
            e = sum(w * t for w, t in zip(tiles.term_weights(p, sp), terms, strict=True)).sum()
            (g,) = torch.autograd.grad(e, ri)
        return g.reshape(len(js), f)[:, k].double()

    d = pair_grads(rows, params) - pair_grads(rows.double(), params.double())
    m = int(d.abs().argmax())
    j = int(js[m])
    orig = (lambda s_: int(perm[s_])) if perm is not None else (lambda s_: s_)
    u_j, a_j = ulps[blk, lane][keep][m], angle[blk, lane][keep][m]
    rest = float(d.abs().sum() - d[m].abs())
    text = (f"row {r} (nucleotide {orig(r)}) column {k}: kernel {float(got[r, k]):.4f} f32 {float(plain[r, k]):.4f}; "
            f"of its {len(js)} pairs, ({r}, {j}) (nucleotides {orig(r)}, {orig(j)}; inside the short reach: "
            f"{bool(short[blk, lane][keep][m])}) carries the most f32-f64 of the pair-by-pair plain formulas, "
            f"{float(d[m]):+.3e} (the other pairs {rest:.1e} together); its angle cosine {int(a_j)} lies "
            f"{float(u_j):.2f} float32 eps from +-1 (the clamp: 8)")
    return text, (r, k, j), orig


def _gap_at(ctx, ids, body, r: int, k: int) -> str:
    """K3, its float32 plain version and the float64 one at element (r, k)
    for the rows of ``body``."""
    from mythos_tpu_torch.ops import tiles

    rows = tiles.dynamic_rows(ctx, body).contiguous()
    sp, P = ctx.spec, ctx.params
    vals = (tiles.tile_forces(rows, P, ids, sp)[r, k], tiles.tile_forces_plain(rows, P, ids, sp)[r, k],
            tiles.tile_forces_plain(rows.double(), P.double(), ids, sp)[r, k])
    kern, f32, f64 = (float(v) for v in vals)
    return f"kernel {kern:.4f} f32 {f32:.4f} f64 {f64:.4f} (|kernel-f32| {abs(kern - f32):.2e})"


def _turned(body, i: int, angle: float):
    """``body`` with nucleotide i's frame turned by ``angle`` about its a3
    (a1 toward a2)."""
    from mythos_tpu_torch.soa import BodySoA, Quat

    w, x, y, z = (c.clone() for c in body.orientation)
    cw, sz = math.cos(angle / 2), math.sin(angle / 2)
    w[i], x[i], y[i], z[i] = (w[i] * cw - z[i] * sz, x[i] * cw + y[i] * sz, y[i] * cw - x[i] * sz,
                              z[i] * cw + w[i] * sz)
    return BodySoA(body.center, Quat(w, x, y, z))


def _shifted(body, i: int):
    """``body`` translated so that nucleotide i sits at the origin."""
    from mythos_tpu_torch.soa import BodySoA, Vec3

    return BodySoA(Vec3(*(c - c[i] for c in body.center)), body.orientation)


def _k6_checked(got, plain, plain64) -> tuple[bool, str, float]:
    """K6's gradient tolerance (rtol 2e-4, atol 1e-4 max|plain|); failing
    that, the float32 budget of phase 4 per column (the three axes):
    max|kernel - f32| <= 2 max|f32 - f64| + 5e-5 + 2e-4 max|f64|."""
    ok, err = _within(got, plain, rtol=2e-4, atol=1e-4 * float(plain.abs().max()))
    if ok:
        return True, "rtol 2e-4", err
    g, p, p64 = (x.double().reshape(-1, 3) for x in (got, plain, plain64))
    err_k = (g - p).abs().amax(0)
    limit = 2 * (p - p64).abs().amax(0) + 5e-5 + 2e-4 * p64.abs().amax(0)
    print(f"    K6 per axis: max|kernel-f32| {err_k.tolist()} |f32-f64| {(p - p64).abs().amax(0).tolist()} "
          f"limit {limit.tolist()}")
    return bool((err_k <= limit).all()), "float64 budget", err


def _lj_pair_counts(positions, pair_mask, box) -> tuple[int, int, int]:
    """(masked unordered pairs, those inside the LJ cutoff, the distinct
    mask words that hold the bits of those inside -- each pair's bit in row
    min(i, j), the mask being symmetric) of one state."""
    import torch

    from mythos_tpu_torch.ops import lj

    n, step, words = pair_mask.n, 1024, pair_mask.words
    pairs = inside = words_in = 0
    for i0 in range(0, n, step):
        m = pair_mask.upper(i0, min(n, i0 + step))
        dr = positions[i0 : i0 + step, None, :] - positions[None, :, :]
        dr = dr - box * torch.round(dr / box)
        r2 = (dr * dr).sum(-1) + 1e-18
        hit = m & (r2 < lj.LJ_CUTOFF**2)
        pairs += int(m.sum())
        inside += int(hit.sum())
        padded = torch.zeros((hit.shape[0], words * 32), dtype=torch.bool, device=hit.device)
        padded[:, :n] = hit
        words_in += int(padded.reshape(hit.shape[0], words, 32).any(-1).sum())
    return pairs, inside, words_in


def _martini(dev, smi: str) -> list[dict]:
    """Phase 9: K6 against its plain versions at 10,160 beads, the NPT main
    path of that bilayer, and a 104-bead run card vs CPU. The K6 records."""
    import numpy as np
    import torch

    from mythos_tpu_torch.energy.martini.systems import default_bilayer_terms, lattice_bilayer
    from mythos_tpu_torch.observables import AreaPerLipid, MembraneThickness
    from mythos_tpu_torch.ops import lj
    from mythos_tpu_torch.simulators.martini import MartiniSimulator

    t9 = _LAPS[-1]
    # 9a. K6 against its plain versions, on the bilayer jittered by 0.03 nm
    n_x, n_y, w_l = MARTINI_LATTICE
    top, pos, box, masses = lattice_bilayer(n_x, n_y, water_layers=w_l)
    terms = default_bilayer_terms(top)
    lj_term = terms[2]
    jit = pos + np.random.default_rng(1).normal(scale=0.03, size=pos.shape)
    x = torch.as_tensor(jit, dtype=torch.float32, device=dev)
    b = torch.as_tensor(box, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    mask = lj_term.pair_mask(dev)
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - t0
    types, tables = lj_term.types(dev), lj_term.tables(dev, torch.float32)
    args = (x, types, mask, b, tables)
    args64 = (x.double(), types, mask, b.double(), tuple(t.double() for t in tables))
    e_ms, e_k = _events_ms(lambda: lj.lj_energy(*args), 20)
    g_ms, _ = _events_ms(lambda: lj.lj_grads(*args), 20)
    pe_ms, e_p = _events_ms(lambda: lj.lj_energy_plain(*args), 3)
    pg_ms, _ = _events_ms(lambda: lj.lj_grads_plain(*args), 3)
    e_64 = lj.lj_energy_plain(*args64)
    n, words, t = mask.n, mask.words, tables[0].shape[0]
    n_pairs, n_in, words_in = _lj_pair_counts(x, mask, b)

    def force_eval(a):
        """dU/d(positions, box) through LJPairEnergy, as the NPT path takes them."""
        xg, bg = a[0].detach().requires_grad_(True), a[3].detach().requires_grad_(True)
        return torch.autograd.grad(lj.lj_pair_energy(xg, a[1], a[2], bg, a[4]), (xg, bg))

    fwd_win = _profiled(lambda: lj.lj_energy(*args), 10)
    bwd_win = _profiled(lambda: lj.lj_grads(*args), 10)
    pair_win = _profiled(lambda: force_eval(args), 10)
    # bytes: the mask words that hold the bits of the pairs inside the
    # cutoff (each in row min(i, j)), positions, types, tables, box, outputs;
    # operations: the pairs inside the cutoff only. These bounds go into the
    # kernel records; beside them, printed only, the first designs' bounds
    # that charge whole mask regions (the energy: the upper half, from the
    # word of column i + 1; the backward: whole rows)
    upper_words = sum(words - (i + 1) // 32 for i in range(n))
    other_in = n * 3 * 4 + n * 4 + 2 * t * t * 4 + 3 * 4
    fwd_bound = _bound(upper_words * 4 + other_in + 4, n_in * (FLOP_LJ_TEST + FLOP_LJ_ENERGY))
    fwd_reach = _bound(words_in * 4 + other_in + 4, n_in * (FLOP_LJ_TEST + FLOP_LJ_ENERGY))
    bwd_bound = _bound(n * words * 4 + other_in + n * 3 * 4 + 3 * 4, n_in * (FLOP_LJ_TEST + FLOP_LJ_GRAD))
    reach_bound = _bound(words_in * 4 + other_in + n * 3 * 4 + 3 * 4, n_in * (FLOP_LJ_TEST + FLOP_LJ_GRAD))
    # each kernel of a standalone call launches once a call, so a call's
    # device time is the sum of its kernels' mean times per event recorded
    e_med, g_med = statistics.median(e_ms), statistics.median(g_ms)
    e_dev = sum(ms / c for ms, c in fwd_win["kernels"].values())
    g_dev = sum(ms / c for ms, c in bwd_win["kernels"].values())
    print(f"[9a K6] {n} beads, box {box.round(3).tolist()}: mask built in {mask_s:.3f} s ({words} words a row); "
          f"{n_pairs} masked pairs, {n_in} inside {lj.LJ_CUTOFF} nm, their bits in {words_in} mask words "
          f"({words_in * 4} B); energy kernel {float(e_k):.6f} plain {float(e_p):.6f} f64 {float(e_64):.6f}; "
          f"lj_energy {e_med:.4f} ms by events (plain {statistics.median(pe_ms):.2f}, bound {fwd_reach[0]:.6f} by "
          f"{fwd_reach[1]}: {_share(fwd_reach[0], e_med)} of the events' time, {_share(fwd_reach[0], e_dev)} of the "
          f"{e_dev:.4f} ms of device time a call; {fwd_win['launches'] / 10:g} kernel launches a call; device time: "
          f"{_kernel_list(fwd_win)}; the first design's bound over the whole upper half {fwd_bound[0]:.6f} by "
          f"{fwd_bound[1]}: {_share(fwd_bound[0], e_med)}, {_share(fwd_bound[0], e_dev)}); lj_grads {g_med:.4f} ms by "
          f"events (plain {statistics.median(pg_ms):.2f}, bound {reach_bound[0]:.6f} by {reach_bound[1]}: "
          f"{_share(reach_bound[0], g_med)} of the events' time, {_share(reach_bound[0], g_dev)} of the {g_dev:.4f} ms "
          f"of device time a call; {bwd_win['launches'] / 10:g} kernel launches a call; device time: "
          f"{_kernel_list(bwd_win)}; the first design's bound over whole rows ({n * words} words) {bwd_bound[0]:.6f} by "
          f"{bwd_bound[1]}: {_share(bwd_bound[0], g_med)}, {_share(bwd_bound[0], g_dev)}); a force evaluation through "
          f"LJPairEnergy (one cell build, the forward's cells reused by the backward): "
          f"{pair_win['device_ms'] / 10:.4f} ms of device time, {pair_win['launches'] / 10:g} kernel launches a call; "
          f"device time: {_kernel_list(pair_win)} on {smi}")

    # each direction where the cells could go wrong: the same beads permuted
    # (positions, types and mask alike), and the box and positions scaled, as
    # the barostat scales them, so that the cells per side change on the device
    perm = np.random.default_rng(2).permutation(n)
    inv = np.argsort(perm)
    ip = torch.as_tensor(perm, device=dev)
    scale = torch.tensor([0.98, 0.98, 1.02], device=dev)
    cases = {
        "jittered": args,
        "permuted": (x[ip].contiguous(), types[ip].contiguous(),
                     lj.PairMask.build(n, inv[np.asarray(lj_term.bonded_neighbors)], dev), b, tables),
        "scaled box": (x * scale, types, mask, b * scale, tables),
        # across the x and y faces of a box with more cells of side LJ_CELL
        # than the build holds (63 x 63 x 9): coarser cells
        "wide box": (x - torch.stack([b[0] / 2, b[1] / 2, torch.zeros_like(b[0])]), types, mask,
                     torch.tensor(WIDE_BOX, device=dev), tables),
    }
    err_e = err_g = err_b = 0.0
    for case, a in cases.items():
        cells_p = lj.cell_list_plain(a[0], a[3])

        def same_cells(c):
            return all(torch.equal(getattr(c, f), getattr(cells_p, f)) for f in ("dims", "cell_of", "start", "order"))

        e_c, cells_e = lj._lj_energy(*a)  # the cells this call's energy came from
        e_cp = lj.lj_energy_plain(*a)
        err_c = abs(float(e_c) - float(e_cp))
        ok_e = err_c <= 2e-5 * abs(float(e_cp)) and torch.equal(e_c, lj.lj_energy(*a))
        g_k, gb_k = lj.lj_grads(*a)
        g_k2, gb_k2, cells_g = lj._lj_grads(*a)  # the cells this call's gradients came from
        det = torch.equal(g_k, g_k2) and torch.equal(gb_k, gb_k2)
        builds = lj.lj_cells.launches
        g_fn, gb_fn = force_eval(a)  # the backward on the forward's cells
        one_build = lj.lj_cells.launches == builds + 1
        same_fn = torch.equal(g_fn, g_k) and torch.equal(gb_fn, gb_k)
        g_p, gb_p = lj.lj_grads_plain(*a)
        g_64, gb_64 = lj.lj_grads_plain(a[0].double(), a[1], a[2], a[3].double(), tuple(v.double() for v in a[4]))
        ok_g, rule_g, e_g = _k6_checked(g_k, g_p, g_64)
        ok_b, rule_b, e_b = _k6_checked(gb_k, gb_p, gb_64)
        tests = lj.candidate_tests(cells_p)
        err_e, err_g, err_b = max(err_e, err_c), max(err_g, e_g), max(err_b, e_b)
        print(f"  K6, {case}: cells {cells_e.dims[:3].tolist()}, the forward's and the backward's equal to "
              f"cell_list_plain's: {same_cells(cells_e)}, {same_cells(cells_g)}; {tests} candidates loaded a call by "
              f"each direction ({tests / (2 * n_pairs):.2%} of the dense backward's {2 * n_pairs}; the forward tests the "
              f"{(tests - n) // 2} with j > i against the mask, where the dense forward tested {n_pairs}); energy kernel "
              f"{float(e_c):.6f} plain {float(e_cp):.6f} (|diff| {err_c:.3e}, rtol 2e-5, deterministic: {ok_e}); "
              f"position gradient err {e_g:.3e} ({rule_g}); box gradient kernel {gb_k.tolist()} plain {gb_p.tolist()} "
              f"f64 {gb_64.tolist()} err {e_b:.3e} ({rule_b}); deterministic {det}; under LJPairEnergy one cell build: "
              f"{one_build}, gradients equal to lj_grads' bits: {same_fn}")
        if not (ok_e and same_cells(cells_e)):
            raise SystemExit(f"K6's forward disagrees with its plain version, its cells or itself ({case})")
        if not (ok_g and ok_b and det and same_cells(cells_g) and one_build and same_fn):
            raise SystemExit(f"K6's backward disagrees with its plain version, its cells or itself ({case})")
    _lap("9a K6")

    # 9b. the NPT main path at 10,160 beads: warm-up run, then the counted, timed run
    sim = MartiniSimulator(energy_fns=terms, box=box, masses=masses, save_every=MARTINI_SAVE,
                           barostat=MARTINI_BAROSTAT, device=dev)
    x0 = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    sim.run(None, x0, MARTINI_WARM, torch.Generator(device=dev).manual_seed(10))
    lj.lj_energy.launches = lj.lj_grads.launches = lj.lj_cells.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.run(None, x0, MARTINI_STEPS, torch.Generator(device=dev).manual_seed(11))
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    launches = {"K6 fwd": lj.lj_energy.launches, "K6 bwd": lj.lj_grads.launches, "K6 cells": lj.lj_cells.launches}
    tr = out.observables[0]
    heads = [i for i, nm in enumerate(top.atom_names) if nm == "PO4"]
    apl = AreaPerLipid(head_indices=heads)(tr)
    thick = MembraneThickness(thickness_indices=heads)(tr)
    finite = bool(torch.isfinite(tr.center).all() and torch.isfinite(tr.box_size).all())
    xy_equal = bool((tr.box_size[:, 0] == tr.box_size[:, 1]).all())
    kin = tr.metadata["kinetic_kT"]
    kt_late = float(kin[kin.shape[0] // 2 :].mean())
    print(f"[9b MARTINI NPT] {MARTINI_STEPS} steps at {n} beads ({len(heads)} lipids), dt {sim.dt} ps, barostat every "
          f"{MARTINI_BAROSTAT['every']}: {el:.3f} s = {MARTINI_STEPS / el * 60.0:.1f} steps/min on {smi}; launches "
          f"{launches}; states {tuple(tr.center.shape)} finite={finite} box x == box y: {xy_equal}; box first "
          f"{tr.box_size[0].tolist()} last {tr.box_size[-1].tolist()}; APL first {float(apl[0]):.4f} last "
          f"{float(apl[-1]):.4f} nm^2; thickness last {float(thick[-1]):.4f} nm; mean kinetic kT of the last half "
          f"{kt_late:.4f} (kT {sim.kT:.4f}); {launches['K6 cells'] / MARTINI_STEPS:g} cell builds a step, one a "
          f"force evaluation: {launches['K6 cells'] == launches['K6 fwd']}")
    if not (finite and xy_equal):
        raise SystemExit("the MARTINI NPT run produced a bad trajectory")
    if min(launches.values()) < 1:
        raise SystemExit(f"the MARTINI NPT run did not go through K6: {launches}")
    if launches["K6 cells"] != launches["K6 fwd"]:
        raise SystemExit(f"the MARTINI NPT run built other than one set of cells a force evaluation: {launches}")
    # where an NPT step's time goes: one saved interval under the profiler
    w = _profiled(lambda: sim.run(None, x0, MARTINI_SAVE, torch.Generator(device=dev).manual_seed(12)))
    top_dev = sorted(w["kernels"].items(), key=lambda kv: kv[1][0], reverse=True)[:4]
    print(f"[9b profile] {MARTINI_SAVE} steps under torch.profiler: wall {w['wall_ms']:.1f} ms, device kernels "
          f"{w['device_ms']:.1f} ms (idle share {1 - w['device_ms'] / w['wall_ms']:.0%}), "
          f"{w['launches'] / MARTINI_SAVE:.0f} launches per step; device top: "
          + ", ".join(f"{k[:40]} {ms:.1f} ms" for k, (ms, _) in top_dev)
          + "; host top: " + ", ".join(f"{k} {ms:.0f} ms" for k, ms in w["host"]))
    _lap("9b MARTINI NPT (warm-up, 1000 steps, profile)")

    # 9c. the 104-bead bilayer: card (K6) vs CPU plain versions, same noise
    top_s, pos_s, box_s, masses_s = lattice_bilayer(3, 3, water_layers=1)
    gen = torch.Generator().manual_seed(13)
    mom = torch.randn(pos_s.shape, generator=gen) * (float(masses_s[0]) * sim.kT) ** 0.5
    noise = torch.randn((50, *pos_s.shape), generator=gen)

    def small_run(device):
        s = MartiniSimulator(energy_fns=default_bilayer_terms(top_s), box=box_s, masses=masses_s, save_every=10,
                             barostat=MARTINI_BAROSTAT, device=device)
        return s.run(None, torch.as_tensor(pos_s, dtype=torch.float32), 50, init_momentum=mom,
                     noise=noise).observables[0]

    gpu, cpu = small_run(dev), small_run("cpu")
    okc, errc = _within(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    okb, errb = _within(gpu.box_size.cpu(), cpu.box_size, rtol=1e-4, atol=1e-5)
    print(f"[9c MARTINI small input] 104 beads, 50 steps, barostat every 10: card vs CPU center err {errc:.2e} "
          f"box err {errb:.2e} (rtol 1e-4, atol 1e-5)")
    if not (okc and okb):
        raise SystemExit("the card's MARTINI trajectory disagrees with the CPU plain versions")
    _lap("9c MARTINI card vs CPU")
    print(f"[time] 9 MARTINI in all: {_LAPS[-1] - t9:.1f} s")

    src = "mythos_tpu_torch/ops/csrc/lj.cu"
    return [
        {"name": "K6 lj_energy", "route": "cuda", "source": src, "replaces": "mythos_tpu/ops/lj.py:182",
         "launches": launches["K6 fwd"], "max_abs_err": err_e, "ms": e_med,
         "plain_ms": statistics.median(pe_ms), "bound_ms": fwd_reach[0], "bound_by": fwd_reach[1], "library_ms": None},
        {"name": "K6 lj_grads", "route": "cuda", "source": src, "replaces": "mythos_tpu/ops/lj.py:205",
         "launches": launches["K6 bwd"], "max_abs_err": max(err_g, err_b), "ms": g_med,
         "plain_ms": statistics.median(pg_ms), "bound_ms": reach_bound[0], "bound_by": reach_bound[1], "library_ms": None},
    ]


def _band_pair_geometry(ctx, dyn, site_cutoffs):
    """Per offset d of the band, for its unbonded pairs (i, i + d) of the
    (7, n) slot-order state (the sites of the context's family, float64):
    (d, inside a short-range term's site cutoff, inside Debye's alone, the
    distance of the pair's nearest-aligned angle cosine to +-1 in float32
    ulps -- the 6 of hb/cross stacking and coax's 2, as phase 6)."""
    import torch

    from mythos_tpu_torch.ops import stencil as st
    from mythos_tpu_torch.soa import Quat, Vec3, vdot

    P = st.unpack_params(ctx.params.double())
    sites = vars(st._sites(P, Vec3(*dyn[:3].double()), Quat(*dyn[3:].double()), ctx.family))
    n, terms = ctx.n, site_cutoffs["terms"]
    idx = torch.arange(n, device=dyn.device)
    eps = torch.finfo(torch.float32).eps
    for d in range(1, min(ctx.w_wide, n - 1) + 1):
        m = n - d
        valid = (ctx.partners[0, :m] != idx[:m] + d) & (ctx.partners[1, :m] != idx[:m] + d)

        def lo(v):
            return Vec3(*(c[:m] for c in v))

        def hi(v):
            return Vec3(*(c[d:] for c in v))

        def reach(pairs):
            hit = torch.zeros(m, dtype=torch.bool, device=dyn.device)
            for fa, fb, cut in pairs:
                for a, b in {(fa, fb), (fb, fa)}:
                    hit |= vdot(hi(sites[b]) - lo(sites[a]), hi(sites[b]) - lo(sites[a])) < cut * cut
            return hit & valid

        short = reach([pr for nm, prs in terms.items() if nm != "Debye" for pr in prs])
        debye = reach(terms.get("Debye", ())) & ~short

        def unit(v):
            return v * (1.0 / vdot(v, v).sqrt())

        u, us = unit(hi(sites["base"]) - lo(sites["base"])), unit(hi(sites["stack"]) - lo(sites["stack"]))
        a1i, a1j, a3i, a3j = lo(sites["a1"]), hi(sites["a1"]), lo(sites["a3"]), hi(sites["a3"])
        cos = torch.stack([-vdot(a1i, a1j), -vdot(a1j, u), vdot(a1i, u), vdot(a3i, a3j), -vdot(a3j, u), vdot(a3i, u),
                           vdot(a3i, us), -vdot(a3j, us)])
        yield d, short, debye, ((1.0 - cos.abs()) / eps).amin(0)


def _k2_held(label: str, ctx, dyn, ptx: dict, site_cutoffs=None) -> dict:
    """K2 of the context's family on a (7, n) slot-order state against its
    plain version (phases 3 and 10a): K2's tolerance, or, with the model's
    ``site_cutoffs`` (10a), as phase 6, K2's tolerance or else the float32
    budget on the slots with a short-range pair at the float32 arccos clamp
    (else all); equal bits on a second call; its tally of the
    band pairs by gate against band_gate_counts (within 1e-4 of the pairs, as
    phase 6's tallies: a distance within an ulp of a cutoff may round
    either way); its registers and spill (phase 2), none spilt. Fails on
    any. Returns its readings: err, ms (events) and plain_ms lists, dev_ms,
    tally, bound."""
    import torch

    from mythos_tpu_torch.ops import stencil as st

    n = ctx.n
    k2_ms, k2 = _events_ms(lambda: st.field_grads(ctx, dyn), 20)
    det = torch.equal(k2, st.field_grads(ctx, dyn))
    dev_ms = _per_call(_profiled(lambda: st.field_grads(ctx, dyn), 10), {"stencil_field_grads": 1})
    _, tally = st._field_grads(ctx, dyn, count=True)
    gate = st.band_gate_counts(ctx, dyn)
    tally_ok = sum(abs(tally[k] - gate[k]) for k in gate) <= 1e-4 * (gate["short"] + gate["debye"] + gate["skipped"])
    p_ms, plain = _events_ms(lambda: st.field_grads_plain(ctx, dyn), 3)
    near = torch.zeros(n, dtype=torch.bool, device=dyn.device)
    if site_cutoffs is None:
        ok, err = _within(k2, plain, rtol=1e-4, atol=1e-4 * float(plain.abs().max()))
        rule = "K2 tolerance"
    else:
        plain64 = st.field_grads_plain(ctx.astype(torch.float64), dyn.double())
        for d, short, _, ulps in _band_pair_geometry(ctx, dyn, site_cutoffs):
            at = short & (ulps <= CLAMP_ULPS)
            near[: n - d] |= at
            near[d:] |= at
        ok, rule, err = _checked(label, k2.T, plain.T, plain64.T, near)
        if rule != "K2 tolerance":
            r, t = divmod(int((k2 - plain).abs().argmax()), n)
            print(f"    {label} worst element: row {r}, slot {t} (z {float(dyn[2, t]):.1f}, near the clamp: "
                  f"{bool(near[t])}): kernel {float(k2[r, t]):.5f} f32 {float(plain[r, t]):.5f} f64 "
                  f"{float(plain64[r, t]):.5f}")
    regs, spill = ptx.get(_instance_key("stencil_field_grads", ctx.family, ctx.pseq), (0, -1))
    hbf_bytes = 10 * n * 4 if ctx.pseq else 0  # a pseq's hb factors
    bound = _bound(2 * 7 * n * 4 + hbf_bytes, tally["short"] * FLOP_PAIR_GRAD + tally["debye"] * FLOP_DEBYE_GRAD)
    clamp = "" if site_cutoffs is None else (f" {int(near.sum())} slots with a short-range pair whose angle cosine lies "
                                             f"within {CLAMP_ULPS} float32 ulps of +-1;")
    print(f"[{label}] n={n} w_terms={ctx.w_terms} w_wide={ctx.w_wide}:{clamp} max_abs_err={err:.3e} ({rule}) ok={ok}; "
          f"kernel {statistics.median(k2_ms):.4f} ms by events, {_dev(dev_ms)} of device time a call; plain "
          f"{statistics.median(p_ms):.2f} ms; equal bits on a second call: {det}; {regs} registers, {spill} B spill "
          f"stores; the band pairs by gate: kernel {tally}, plain gate {gate}; bound {bound[0]:.5f} ms ({bound[1]}): "
          f"{_share(bound[0], dev_ms)} of its device time")
    if not (ok and det):
        raise SystemExit(f"{label}: K2 disagrees with its plain version, or is not deterministic")
    if not tally_ok or spill != 0:
        raise SystemExit(f"{label}: K2's gate disagrees with the plain gate, or its registers spill ({spill} B)")
    return {"err": err, "ms": k2_ms, "plain_ms": p_ms, "dev_ms": dev_ms, "tally": tally, "bound": bound, "k2": k2}


def _instance_key(name: str, family: str, pseq: bool = False) -> str:
    """The key of a kernel instance in :func:`_ptxas`' dict."""
    return f"{name}_kernel<{FAMILY_CODE[family]}{',pseq' if pseq else ''}>"


def _ptxas(log_path) -> tuple[list, dict]:
    """What ``nvcc -Xptxas -v`` said of each kernel in the build log: the
    lines "kernel: registers..., spill" and {kernel: (registers, spill store
    bytes)}, a template instance named ``name<family>``, and a pseq instance
    (its second template argument true) ``name<family,pseq>``."""
    regs, fn, spill, ptx = [], "?", "", {}
    for ln in log_path.read_text().splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
            mangled = re.match(r"_Z(\d+)", fn)  # _Z<length><name>[I<template arguments>E]<arguments>
            if mangled:
                end = mangled.end() + int(mangled.group(1))
                targs = re.match(r"ILi(\d+)E(Lb([01])E)?", fn[end:])
                pseq = ",pseq" if targs and targs.group(3) == "1" else ""
                fn = fn[mangled.end() : end] + (f"<{targs.group(1)}{pseq}>" if targs else "")
        elif "spill stores" in ln:
            spill = ln.split(",", 1)[1].strip()
        elif "registers" in ln:
            regs.append(f"{fn}: {ln.split(':', 1)[1].strip()}, {spill}")
            used, stores = re.search(r"Used (\d+) registers", ln), re.search(r"(\d+) bytes spill stores", spill)
            ptx[fn] = (int(used.group(1)) if used else 0, int(stores.group(1)) if stores else -1)
    return regs, ptx


def _k1_held(label: str, ctx, sim, body, ou, gen) -> tuple:
    """K1 of the context's family over one chunk of ``sim.neighbor_update_every``
    steps from ``body`` with the same bf16 noise as its plain version
    (phases 10b and 15b): whether it meets rtol 2e-4 / atol 5e-5, whether it
    stays inside the float32 budget of phase 4 (per row, |K1 - f32| <= 2
    |f32 - f64| + 5e-5 + 2e-4 max|row|), equal bits on a second call; (fixed,
    budget, equal bits, max error, ms by events, plain ms, state, noise)."""
    import torch

    from mythos_tpu_torch.ops import stencil as st

    u = sim.neighbor_update_every
    state = sim.initial_state(ctx, body, gen)
    noise = torch.randn((u, 6, ctx.n), generator=gen, device=state.device).to(torch.bfloat16)
    k_ms, got = _events_ms(lambda: st.multistep_chunk(ctx, ou, noise, state), 5)
    det = torch.equal(got, st.multistep_chunk(ctx, ou, noise, state))
    p_ms, plain = _events_ms(lambda: st.multistep_chunk_plain(ctx, ou, noise, state), 1)
    plain64 = st.multistep_chunk_plain(ctx.astype(torch.float64), ou.double(), noise, state.double())
    err_k = (got - plain).abs().amax(1).double()
    err_32 = (plain.double() - plain64).abs().amax(1)
    budget = bool((err_k <= 2 * err_32 + 5e-5 + 2e-4 * plain64.abs().amax(1)).all())
    fixed, err = _within(got, plain, rtol=2e-4, atol=5e-5)
    rows = " ".join(f"{r}:{float(a):.1e}/{float(b_):.1e}" for r, (a, b_) in enumerate(zip(err_k, err_32)))
    print(f"[{label}] {u} steps at {ctx.n} nt: max|K1-plain|={err:.3e}; rtol 2e-4/atol 5e-5 met: {fixed}; float32 "
          f"budget met: {budget}; kernel {statistics.median(k_ms):.3f} ms plain {statistics.median(p_ms):.1f} ms; "
          f"two chunks equal: {det}; row:|K1-f32|/|f32-f64| {rows}")
    return fixed, budget, det, err, k_ms, p_ms, state, noise


def _rna2(dev, smi: str, ptx: dict) -> list[dict]:
    """Phase 10: the oxRNA2 stencil main path at 10k nt -- K2's and K1's
    rna2 instances against their plain versions, the main path through
    them, a 40-bp run card vs CPU. The K1 and K2 rna2 records."""
    import torch

    import mythos_tpu_torch.energy.rna2 as rna2
    from mythos_tpu_torch.entry import build_sim
    from mythos_tpu_torch.io.synthetic import coax_engaged, synthetic_duplex
    from mythos_tpu_torch.ops import stencil as st
    from mythos_tpu_torch.rigid_body import RigidBody

    topology, body = synthetic_duplex(N_BP, form="A", dtype=torch.float32, device=dev)
    energy_fn, sim = build_sim(topology, KT, model="rna2", init_centers=body.center,
                               init_orientation=body.orientation, device=dev)
    ctx = st.prepare_stencil_context(energy_fn, sim.band, device=dev)
    n, u = ctx.n, sim.neighbor_update_every
    band = sim.band
    print(f"[10 rna2] {n} nt A-form: family {ctx.family}, w_terms={ctx.w_terms} w_wide={ctx.w_wide} "
          f"check_dm={ctx.check_dm} {ctx.checks.shape[0]} exact checks, overflow at init={bool(band.did_overflow)}")
    gen = torch.Generator(device=dev).manual_seed(11)

    def jittered(b):
        q = b.orientation + 0.01 * torch.randn(b.orientation.shape, generator=gen, device=dev)
        c = b.center + 0.01 * torch.randn(b.center.shape, generator=gen, device=dev)
        return RigidBody(c, q / q.norm(dim=-1, keepdim=True))

    # 10a. K2 (rna2) against its plain version on a jittered state
    jb = jittered(body)
    dyn = torch.cat([ctx.to_slots(jb.center.T), ctx.to_slots(jb.orientation.T)]).contiguous()
    k2r = _k2_held("10a K2 rna2", ctx, dyn, ptx, rna2.per_term_site_cutoffs())
    # the same at 80 nt on three coaxially stacked pairs, coaxial stacking alone
    top_s, body_s = synthetic_duplex(40, form="A", dtype=torch.float32, device=dev)
    _, sim_s = build_sim(top_s, KT, model="rna2", init_centers=body_s.center, init_orientation=body_s.orientation,
                         device=dev)
    ctx_s = st.prepare_stencil_context(sim_s.energy_fn, sim_s.band, device=dev)
    com, quat = (ctx_s.to_slots(x.T.double()).T.cpu().numpy() for x in (body_s.center, body_s.orientation))
    com, quat = coax_engaged(com, quat, RNA2_COAX_PAIRS, seed=3)
    dyn_c = torch.cat([torch.as_tensor(com.T), torch.as_tensor(quat.T)]).float().to(dev).contiguous()
    p_c = ctx_s.params.clone()
    off = st.param_offsets()["GT"]
    p_c[off : off + 8] = torch.tensor([0, 0, 0, 1, 0, 0, 0, 0], dtype=torch.float32)
    ctx_c = dataclasses.replace(ctx_s, params=p_c)
    got_c, plain_c = st.field_grads(ctx_c, dyn_c), st.field_grads_plain(ctx_c, dyn_c)
    ok_c, err_c = _within(got_c, plain_c, rtol=1e-4, atol=1e-4 * float(plain_c.abs().max()))
    print(f"[10a K2 rna2 coax] 80 nt, pairs {RNA2_COAX_PAIRS} coaxially stacked, coax alone: max_abs_err={err_c:.3e} "
          f"of max|plain| {float(plain_c.abs().max()):.3e} ok={ok_c}")
    if not ok_c or float(plain_c.abs().max()) < 1.0:
        raise SystemExit("K2's rna2 coaxial stacking disagrees with its plain version")

    # 10b. K1 (rna2): one 40-step chunk, the same bf16 noise; 10k nt inside
    # the float32 budget of phase 4, 80 nt to the fixed tolerance (else that budget)
    ou = st.ou_constants(sim.dt, sim.kT, [sim.mass], [sim.inertia], [sim.gamma_t], [sim.gamma_r]).vector(dev)

    fixed, budget, det, err1, k1_ms, p1_ms, state, noise = _k1_held("10b K1 rna2 10k", ctx, sim, jittered(body), ou,
                                                                    gen)
    if not (budget and det):
        raise SystemExit("K1's rna2 instance is outside the float32 budget of its plain version, or not deterministic")
    k1_win = _profiled(lambda: st.multistep_chunk(ctx, ou, noise, state), 3)
    k1_dev = _per_call(k1_win, {"k1_step": u, "k1_entry": 1})
    print(f"[10b K1 rna2] device time {_dev(k1_dev)} a chunk ({_kernel_list(k1_win)})")
    fixed_s, budget_s, det_s, *_ = _k1_held("10b K1 rna2 80 nt", ctx_s, sim_s, jittered(body_s), ou, gen)
    if not ((fixed_s or budget_s) and det_s):
        raise SystemExit("K1's rna2 instance disagrees with its plain version at 80 nt")
    _lap("10a-b K2, K1 rna2")

    # 10c. the main path: warm-up run, then the counted, timed run
    params = energy_fn.opt_params()
    sim.run(params, body, N_STEPS, torch.Generator(device=dev).manual_seed(12))
    st.field_grads.launches = st.multistep_chunk.launches = 0
    st.field_grads.by_family = dict.fromkeys(st.FAMILIES, 0)
    st.multistep_chunk.by_family = dict.fromkeys(st.FAMILIES, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.run(params, body, N_STEPS, torch.Generator(device=dev).manual_seed(13))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"K1": st.multistep_chunk.by_family["rna2"], "K2": st.field_grads.by_family["rna2"]}
    traj = out.observables[0]
    finite = bool(torch.isfinite(traj.center).all() and torch.isfinite(traj.orientation).all())
    qdev = float((traj.orientation.norm(dim=-1) - 1.0).abs().max())
    overflow = bool(traj.metadata["neighbor_overflow"].any())
    print(f"[10c rna2 main path] {N_STEPS} steps at {n} nt: {elapsed:.3f} s = {N_STEPS / elapsed * 60.0:.1f} "
          f"steps/min on {smi}; states {tuple(traj.center.shape)} finite={finite} max||q|-1|={qdev:.2e} "
          f"overflow={overflow} launches={launches} (all families: K1 {st.multistep_chunk.launches}, "
          f"K2 {st.field_grads.launches})")
    if not finite or qdev > 1e-5 or overflow:
        raise SystemExit("the rna2 main path produced a bad trajectory")
    if launches["K1"] != N_STEPS // u or launches["K2"] < 1:
        raise SystemExit(f"the rna2 main path did not run through the rna2 kernels: {launches}")
    w = _profiled(lambda: sim.run(params, body, 10 * u, torch.Generator(device=dev).manual_seed(13)))
    k1_chunk = _per_call(w, {"k1_step": u, "k1_entry": 1})
    print(f"[10c profile] {10 * u} steps under torch.profiler: wall {w['wall_ms']:.1f} ms, device kernels "
          f"{w['device_ms']:.1f} ms (idle share {1 - w['device_ms'] / w['wall_ms']:.0%}), K1's kernels "
          f"{_dev(k1_chunk)} a chunk ({10 * k1_chunk / w['wall_ms']:.0%} of the wall), "
          f"{w['launches'] / (10 * u):.2f} launches per step; host top: "
          + ", ".join(f"{k} {ms:.0f} ms" for k, ms in w["host"]))

    def small_run(device):
        top, b = synthetic_duplex(40, form="A", dtype=torch.float32, device=device)
        e, s_ = build_sim(top, 0.0, model="rna2", init_centers=b.center, init_orientation=b.orientation,
                          neighbor_update_every=10, device=device)
        o = s_.replace(save_every=10).run(e.opt_params(), b, 40, torch.Generator(device=device).manual_seed(0))
        return o.observables[0]

    gpu, cpu = small_run(dev), small_run("cpu")
    okc, errc = _within(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    okq, errq = _within(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
    print(f"[10c small input] 40 bp A-form, 40 steps, kT=0: card vs CPU center err {errc:.2e} quat err {errq:.2e}")
    if not (okc and okq):
        raise SystemExit("the card's rna2 trajectory disagrees with the CPU")

    # 10d. a B-form init under rna2 relaxes out of the band sized from it:
    # K1's row 19 and the far sweep must raise the overflow flag
    top_b, body_b = synthetic_duplex(N_BP, form="B", dtype=torch.float32, device=dev)
    e_b, sim_b = build_sim(top_b, KT, model="rna2", init_centers=body_b.center, init_orientation=body_b.orientation,
                           device=dev)
    out_b = sim_b.run(e_b.opt_params(), body_b, N_STEPS, torch.Generator(device=dev).manual_seed(14))
    ovf_b = bool(out_b.observables[0].metadata["neighbor_overflow"].any())
    print(f"[10d rna2 from B-form] {N_STEPS} steps at {n} nt from the B-form helix (band w_terms="
          f"{sim_b.band.w_terms} w_wide={sim_b.band.w_wide}, overflow at init={bool(sim_b.band.did_overflow)}): "
          f"overflow={ovf_b}")

    # K1's bound from the band pairs of the jittered state K2 counted in 10a
    n_bonds = int((ctx.dirf != 0).sum())
    n_short, n_debye = k2r["tally"]["short"], k2r["tally"]["debye"]
    k1_bound = _bound(
        (19 + 20) * n * 4 + u * 6 * n * 2,
        u * (n_short * FLOP_PAIR_GRAD + n_debye * FLOP_DEBYE_GRAD + n_bonds * FLOP_BOND_GRAD_RNA2
             + n * FLOP_BODY_STEP),
    )
    print(f"[10 bounds] {n_short} band pairs inside a short-range cutoff, {n_debye} inside Debye's alone, "
          f"{n_bonds} bonds: K1 rna2 {k1_bound[0]:.4f} ms ({k1_bound[1]}; {_share(k1_bound[0], k1_dev)} of its device "
          f"time)")
    _lap("10 rna2")
    src = "mythos_tpu_torch/ops/csrc/"
    return [
        {"name": "K1 multistep_chunk (rna2)", "route": "cuda", "source": src + "multistep.cu",
         "replaces": "mythos_tpu/ops/stencil.py:2236", "launches": launches["K1"], "max_abs_err": err1,
         "ms": statistics.median(k1_ms), "plain_ms": statistics.median(p1_ms), "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "K2 field_grads (rna2)", "route": "cuda", "source": src + "stencil_grads.cu",
         "replaces": "mythos_tpu/ops/stencil.py:1420", "launches": None, "max_abs_err": k2r["err"],
         "ms": statistics.median(k2r["ms"]), "plain_ms": statistics.median(k2r["plain_ms"]),
         "bound_ms": k2r["bound"][0], "bound_by": k2r["bound"][1], "library_ms": None},
    ]


def _per_step(dev, smi: str) -> dict:
    """Phase 11: the stencil's per-step branch (``save_every`` 1) at 10k nt,
    oxDNA2 on the B-form and oxRNA2 on the A-form duplex: after a warm-up
    run, the counted, timed run (a state emitted every step, K2 launched
    once for the initial force and once a step, K1 never, no overflow), a
    torch.profiler window; then 40-bp per-step runs of both families and of
    the block tier, card vs CPU. K2's launches in each counted run."""
    import torch

    from mythos_tpu_torch.entry import build_sim
    from mythos_tpu_torch.io.synthetic import synthetic_duplex
    from mythos_tpu_torch.ops import stencil as st

    launches = {}
    for model, form in (("dna2", "B"), ("rna2", "A")):
        steps = PER_STEP_STEPS[model]
        topology, body = synthetic_duplex(N_BP, form=form, dtype=torch.float32, device=dev)
        energy_fn, sim = build_sim(topology, KT, model=model, init_centers=body.center,
                                   init_orientation=body.orientation, device=dev)
        sim = sim.replace(save_every=1)
        u, params = sim.neighbor_update_every, energy_fn.opt_params()
        sim.run(params, body, u, torch.Generator(device=dev).manual_seed(20))
        st.field_grads.launches = st.multistep_chunk.launches = 0
        st.field_grads.by_family = dict.fromkeys(st.FAMILIES, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sim.run(params, body, steps, torch.Generator(device=dev).manual_seed(21))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches[model] = k2 = st.field_grads.by_family[model]
        k1 = st.multistep_chunk.launches
        traj = out.observables[0]
        finite = bool(torch.isfinite(traj.center).all() and torch.isfinite(traj.orientation).all())
        qdev = float((traj.orientation.norm(dim=-1) - 1.0).abs().max())
        overflow = bool(traj.metadata["neighbor_overflow"].any())
        print(f"[11 per-step {model}] {steps} steps at {topology.n_nucleotides} nt, a state every step: {elapsed:.3f} s = "
              f"{steps / elapsed * 60.0:.1f} steps/min on {smi}; states {tuple(traj.center.shape)} finite={finite} "
              f"max||q|-1|={qdev:.2e} overflow={overflow}; K2 launches {k2} (all families {st.field_grads.launches}), "
              f"K1 {k1}")
        if not finite or qdev > 1e-5 or overflow or traj.center.shape[0] != steps:
            raise SystemExit(f"the {model} per-step branch produced a bad trajectory")
        if k2 != steps + 1 or k1 != 0:
            raise SystemExit(f"the {model} per-step branch did not launch K2 once a step (and K1 never): {k2}, {k1}")
        w = _profiled(lambda: sim.replace(neighbor_update_every=PER_STEP_WINDOW).run(
            params, body, PER_STEP_WINDOW, torch.Generator(device=dev).manual_seed(22)))
        k2_call = _per_call(w, {"stencil_field_grads": 1})
        step_ms = w["wall_ms"] / PER_STEP_WINDOW
        print(f"[11 profile {model}] {PER_STEP_WINDOW} steps under torch.profiler: wall {w['wall_ms']:.1f} ms "
              f"({step_ms:.3f} ms a step), device kernels {w['device_ms']:.1f} ms (idle share "
              f"{1 - w['device_ms'] / w['wall_ms']:.0%}), {w['launches'] / PER_STEP_WINDOW:.1f} launches a step; K2 "
              f"{_dev(k2_call)} of device time a call ({k2_call / step_ms:.2%} of a step); host top: "
              + ", ".join(f"{k} {ms:.0f} ms" for k, ms in w["host"]))

    def small_run(device, model, mode):
        top, b = synthetic_duplex(40, form="B" if model == "dna2" else "A", dtype=torch.float32, device=device)
        kw = {"init_orientation": b.orientation} if mode == "stencil" else {}
        e, s_ = build_sim(top, 0.0, mode=mode, model=model, init_centers=b.center, neighbor_update_every=5,
                          device=device, **kw)
        o = s_.replace(save_every=1).run(e.opt_params(), b, 20, torch.Generator(device=device).manual_seed(0))
        return o.observables[0]

    for model, mode in (("dna2", "stencil"), ("rna2", "stencil"), ("dna2", "block")):
        gpu, cpu = small_run(dev, model, mode), small_run("cpu", model, mode)
        okc, errc = _within(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
        okq, errq = _within(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
        print(f"[11 small input {model} {mode}] 40 bp, 20 steps emitted every step, kT=0: states "
              f"{tuple(gpu.center.shape)}, card vs CPU center err {errc:.2e} quat err {errq:.2e}")
        if not (okc and okq) or gpu.center.shape[0] != 20:
            raise SystemExit(f"the card's {model} {mode} per-step trajectory disagrees with the CPU")
    _lap("11 per-step branch")
    return launches


def _direct(dev, smi: str) -> dict:
    """Phase 12: direct differentiation through ``CudaSimulator.run`` --
    d loss / d every ``opt_params`` tensor by ``loss.backward()``, K1 and K2
    forward on the card, their plain versions backward (the reference's
    custom-JVP rule). 12a the reference's own configuration at 1,000 nt
    (the propeller-twist loss through DIRECT_STEPS steps), timed after a
    40-step warm-up; 12b 40 bp, one 40-step chunk at kT 0, card vs CPU, both
    families; 12c the per-step branch at 1,000 nt with ``checkpoint_every``
    1 against 0; 12d oxRNA2 at 1,000 nt, DIRECT_RNA2_STEPS steps. Returns {"K1", "K2",
    "K1 rna2": launches of 12a/12d; "bwd_ms_chunk": 12a's backward a chunk}."""
    import torch
    from torch.utils.checkpoint import checkpoint

    import mythos_tpu_torch.energy.dna2 as dna2
    from mythos_tpu_torch.entry import build_sim
    from mythos_tpu_torch.io.synthetic import synthetic_duplex
    from mythos_tpu_torch.observables import PropellerTwist
    from mythos_tpu_torch.ops import stencil as st
    from mythos_tpu_torch.rigid_body import RigidBody

    def leaves(e):
        return {k: v.detach().clone().requires_grad_(True) for k, v in e.opt_params().items()}

    def counted_eval(e, sim, body, n_steps, seed, loss_fn):
        """(loss, grads, forward s, backward s, forward launches, backward
        launches, MiB) of one evaluation (:func:`_grad_eval`)."""
        p = leaves(e)
        gen = torch.Generator(device=body.center.device).manual_seed(seed)
        r = _grad_eval(lambda: sim.run(p, body, n_steps, gen).observables[0], loss_fn,
                       {"K1": st.multistep_chunk, "K2": st.field_grads})
        return r["loss"], _grads_of(p), r["fwd_s"], r["bwd_s"], r["fwd"], r["bwd"], r

    def twist_loss(n_nt):
        bps = torch.tensor([[i, n_nt - 1 - i] for i in range(n_nt // 2)], device=dev)
        obs = PropellerTwist(rigid_body_transform_fn=dna2.default_transform_soa_fn(), h_bonded_base_pairs=bps)
        return lambda traj: (obs(traj).mean() - 21.7) ** 2

    # 12a. the full-width slice: 1,000 nt, DIRECT_STEPS steps, a state every 40
    topology, body = synthetic_duplex(DIRECT_N_BP, dtype=torch.float32, device=dev)
    n_nt = topology.n_nucleotides
    energy_fn, sim = build_sim(topology, KT, init_centers=body.center, init_orientation=body.orientation, device=dev)
    loss_fn = twist_loss(n_nt)
    counted_eval(energy_fn, sim, body, DIRECT_WARM, 30, loss_fn)
    loss, g, t_f, t_b, fwd, bwd, mem = counted_eval(energy_fn, sim, body, DIRECT_STEPS, 31, loss_fn)
    g_max, n_nonzero, finite = _grad_summary(g)
    chunks = DIRECT_STEPS // sim.neighbor_update_every
    print(f"[12a direct] {DIRECT_STEPS} steps at {n_nt} nt, propeller-twist loss {float(loss):.6g}: forward "
          f"{t_f:.3f} s, backward {t_b:.3f} s ({t_b / chunks:.3f} s a chunk, {t_b / (t_f + t_b):.0%} of the "
          f"evaluation) = {60.0 / (t_f + t_b):.2f} grad-evaluations/min, {DIRECT_STEPS * 60.0 / (t_f + t_b):.1f} "
          f"grad-steps/min on {smi}; max|grad| {g_max:.4g}, d/d eps_stack_base {float(g['eps_stack_base']):.6g}, "
          f"d/d eps_hb {float(g['eps_hb']):.6g}, {n_nonzero} of {len(g)} parameters nonzero; launches forward "
          f"{fwd}, backward {bwd}; peak memory {mem['peak']:.1f} MiB ({mem['rise']:.1f} above the start)")
    if not (finite and g_max > 0 and float(g["eps_stack_base"]) != 0 and bool(torch.isfinite(loss))):
        raise SystemExit("direct differentiation gave a non-finite or zero gradient, or none for eps_stack_base")
    if fwd != {"K1": chunks, "K2": 1} or bwd != {"K1": 0, "K2": 0}:
        raise SystemExit(f"the differentiated run did not launch K1 {chunks} times and K2 once: {fwd}, {bwd}")
    out = {"K1": fwd["K1"], "K2": fwd["K2"], "bwd_ms_chunk": t_b / chunks * 1e3}

    # 12b. 40 bp, one 40-step chunk at kT 0 from a jittered state: card vs CPU
    for model, form in (("dna2", "B"), ("rna2", "A")):
        top_s, b_s = synthetic_duplex(40, form=form, dtype=torch.float32, device="cpu")
        gen = torch.Generator().manual_seed(32)
        q = b_s.orientation + 0.01 * torch.randn(b_s.orientation.shape, generator=gen)
        c = b_s.center + 0.01 * torch.randn(b_s.center.shape, generator=gen)
        b_s = RigidBody(c, q / q.norm(dim=-1, keepdim=True))
        w = torch.randn((1, top_s.n_nucleotides, 7), generator=gen)

        def small(device):
            b = RigidBody(b_s.center.to(device), b_s.orientation.to(device))
            e, s_ = build_sim(top_s, 0.0, model=model, init_centers=b.center, init_orientation=b.orientation,
                              device=device)
            wd = w.to(device)

            def proj(traj):
                return (wd[..., :3] * traj.center).sum() + (wd[..., 3:] * traj.orientation).sum()

            p = leaves(e)
            value = proj(s_.run(p, b, s_.neighbor_update_every, torch.Generator(device=device).manual_seed(0))
                         .observables[0])
            value.backward()
            return float(value.detach()), {k: v.cpu() for k, v in _grads_of(p).items()}

        (l_gpu, g_gpu), (l_cpu, g_cpu) = small(dev), small("cpu")
        scale = max(float(v.abs().max()) for v in g_cpu.values())
        err = max(float((g_gpu[k] - g_cpu[k]).abs().max()) for k in g_cpu)
        ok_g = all(bool(((g_gpu[k] - g_cpu[k]).abs() <= 1e-2 * g_cpu[k].abs() + 1e-3 * scale).all()) for k in g_cpu)
        ok_l = abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
        print(f"[12b direct small input {model}] 40 bp, one 40-step chunk, kT=0: loss card {l_gpu:.8g} CPU "
              f"{l_cpu:.8g}; max|grad card - CPU| {err:.3e} (max|grad| {scale:.3e}; rtol 1e-2, atol 1e-3 max|grad|); "
              f"d/d eps_stack_base card {float(g_gpu['eps_stack_base']):.6g} CPU {float(g_cpu['eps_stack_base']):.6g}")
        if not (ok_l and ok_g) or float(g_cpu["eps_stack_base"]) == 0:
            raise SystemExit(f"the card's {model} gradient through a run disagrees with the CPU plain versions")

    # 12c. the per-step branch at 1,000 nt, 40 steps in 4 rebuild intervals,
    # a state every step: checkpoint_every 1 (each interval a checkpoint,
    # recomputed in the backward) against 0, after one small checkpointed
    # call (the checkpoint's first-call costs)
    x = torch.ones(1, device=dev, requires_grad=True)
    checkpoint(torch.sin, x, use_reentrant=False).backward()
    runs = {}
    for ck in (1, 0):
        sim_c = sim.replace(save_every=1, neighbor_update_every=DIRECT_PER_STEP // 4, checkpoint_every=ck)
        runs[ck] = counted_eval(energy_fn, sim_c, body, DIRECT_PER_STEP, 33, loss_fn)
        _, g_c, t_f, t_b, fwd, bwd, mem = runs[ck]
        print(f"[12c direct per-step checkpoint_every={ck}] {DIRECT_PER_STEP} steps at {n_nt} nt in 4 intervals, "
              f"a state every step: forward {t_f:.3f} s, backward {t_b:.3f} s = "
              f"{DIRECT_PER_STEP * 60.0 / (t_f + t_b):.1f} grad-steps/min on {smi}; max|grad| "
              f"{_grad_summary(g_c)[0]:.4g}; K2 launches forward {fwd['K2']}, backward {bwd['K2']}; K1 "
              f"{fwd['K1'] + bwd['K1']}; memory held after the forward {mem['held']:.1f} MiB, peak "
              f"{mem['rise']:.1f} MiB above the start ({mem['peak']:.1f} MiB in all)")
        want_bwd = DIRECT_PER_STEP if ck else 0
        if fwd != {"K1": 0, "K2": DIRECT_PER_STEP + 1} or bwd != {"K1": 0, "K2": want_bwd}:
            raise SystemExit(f"the per-step gradient run launched K2 {fwd}, {bwd} (checkpoint_every {ck})")
    g1, g0 = runs[1][1], runs[0][1]
    ck_err = max(float(((g1[k] - g0[k]).abs() / g0[k].abs().clamp_min(1e-30)).max()) for k in g0)
    ck_ok = all(bool(((g1[k] - g0[k]).abs() <= 1e-5 * g0[k].abs()).all()) for k in g0)
    print(f"[12c checkpoint] gradient with checkpoint_every 1 against 0: max relative difference {ck_err:.3e} "
          f"(rtol 1e-5); equal bits: {all(torch.equal(g1[k], g0[k]) for k in g0)}")
    if not ck_ok or not _grad_summary(g1)[2] or _grad_summary(g1)[0] == 0:
        raise SystemExit("checkpoint_every changed the per-step gradient, or it is not finite and nonzero")

    # 12d. oxRNA2 at 1,000 nt: two chunks through K1's rna2 instance
    top_r, body_r = synthetic_duplex(DIRECT_N_BP, form="A", dtype=torch.float32, device=dev)
    e_r, sim_r = build_sim(top_r, KT, model="rna2", init_centers=body_r.center, init_orientation=body_r.orientation,
                           device=dev)
    w_r = torch.randn((DIRECT_RNA2_STEPS // sim_r.save_every, top_r.n_nucleotides, 3),
                      generator=torch.Generator().manual_seed(34)).to(dev)
    st.multistep_chunk.by_family = dict.fromkeys(st.FAMILIES, 0)
    loss_r, g_r, t_f, t_b, fwd, bwd, _ = counted_eval(e_r, sim_r, body_r, DIRECT_RNA2_STEPS, 35,
                                                    lambda traj: (w_r * traj.center).sum())
    g_max, n_nonzero, finite = _grad_summary(g_r)
    k1_rna2 = st.multistep_chunk.by_family["rna2"]
    print(f"[12d direct rna2] {DIRECT_RNA2_STEPS} steps at {top_r.n_nucleotides} nt (A-form): "
          f"loss {float(loss_r):.6g}; "
          f"forward {t_f:.3f} s, backward {t_b:.3f} s on {smi}; max|grad| {g_max:.4g}, d/d eps_stack_base "
          f"{float(g_r['eps_stack_base']):.6g}, {n_nonzero} of {len(g_r)} nonzero; launches forward {fwd} "
          f"(K1 rna2 {k1_rna2}), backward {bwd}")
    chunks_r = DIRECT_RNA2_STEPS // sim_r.neighbor_update_every
    if not finite or g_max == 0 or float(g_r["eps_stack_base"]) == 0:
        raise SystemExit("the rna2 gradient through a run is not finite and nonzero")
    if fwd != {"K1": chunks_r, "K2": 1} or k1_rna2 != chunks_r or bwd != {"K1": 0, "K2": 0}:
        raise SystemExit(f"the rna2 differentiated run did not go through K1's rna2 instance: {fwd}, {k1_rna2}")
    out["K1 rna2"] = k1_rna2
    _lap("12 direct differentiation")
    return out


def _grad_eval(run, loss_fn, counters: dict) -> dict:
    """One grad evaluation of phases 13-14: ``loss_fn(run())`` then
    ``loss.backward()``, the launch counters (name: wrapper) set to 0 just
    before. {"loss", "fwd_s", "bwd_s", "fwd": launches of the forward,
    "bwd": of the backward, "held": MiB allocated after the forward less
    before it, "peak": max_memory_allocated over the evaluation in MiB,
    "rise": that peak less the allocation before it}."""
    import torch

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loss = loss_fn(run())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    held = torch.cuda.memory_allocated() - m0
    fwd = {k: fn.launches for k, fn in counters.items()}
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bwd = {k: fn.launches - fwd[k] for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    return {"loss": loss.detach(), "fwd_s": t1 - t0, "bwd_s": t2 - t1, "fwd": fwd, "bwd": bwd, "held": held / 2**20,
            "peak": peak / 2**20, "rise": (peak - m0) / 2**20}


def _grads_of(p: dict) -> dict:
    import torch

    return {k: (torch.zeros_like(v) if v.grad is None else v.grad).detach() for k, v in p.items()}


def _grad_summary(g: dict) -> tuple[float, int, bool]:
    """(max|grad|, parameters with a nonzero gradient, all finite)."""
    import torch

    g_max = max(float(v.abs().max()) for v in g.values())
    return g_max, sum(bool((v != 0).any()) for v in g.values()), all(bool(torch.isfinite(v).all()) for v in g.values())


def _card_vs_cpu(label: str, l_gpu: float, g_gpu: dict, l_cpu: float, g_cpu: dict, loss_rtol: float,
                 loss_atol: float = 0.0) -> None:
    """Print and hold a card gradient against the CPU's: the loss within
    ``loss_rtol`` (+ ``loss_atol``), every gradient within rtol 1e-2 / atol
    1e-3 max|grad|."""
    scale = max(float(v.abs().max()) for v in g_cpu.values())
    err = max(float((g_gpu[k].cpu() - g_cpu[k]).abs().max()) for k in g_cpu)
    ok_g = all(bool(((g_gpu[k].cpu() - g_cpu[k]).abs() <= 1e-2 * g_cpu[k].abs() + 1e-3 * scale).all()) for k in g_cpu)
    ok_l = abs(l_gpu - l_cpu) <= loss_rtol * abs(l_cpu) + loss_atol
    print(f"[{label}] loss card {l_gpu:.8g} CPU {l_cpu:.8g} (rtol {loss_rtol:g}); max|grad card - CPU| {err:.3e} "
          f"(max|grad| {scale:.3e}; rtol 1e-2, atol 1e-3 max|grad|)")
    if not (ok_l and ok_g) or scale == 0:
        raise SystemExit(f"{label}: the card's gradient disagrees with the CPU plain versions, or is zero")


def _block_direct(dev, smi: str) -> dict:
    """Phase 13: direct differentiation through ``BlockSimulator.run`` --
    d loss / d every ``opt_params`` tensor by ``loss.backward()``, K3 forward
    on the card through ``TileForces``, its plain version backward. 13a the
    1,000-nt duplex, the propeller-twist loss through DIRECT_STEPS steps after a
    40-step warm-up, K3 launched as the same run without gradients does and
    none backward; 13b 40 bp, 40 steps at kT 0, card vs CPU; 13c 1,000 nt,
    40 steps in 4 rebuild intervals, ``checkpoint_every`` 1 against 0; 13d
    the 10k-nt 270-degree arc of phase 7, 40 steps, a loss on the last
    state. Returns {"K3 fwd", "K3 bwd": 13a's launches, "bwd_s": 13a's
    backward seconds}."""
    import torch
    from torch.utils.checkpoint import checkpoint

    import mythos_tpu_torch.energy.dna2 as dna2
    from mythos_tpu_torch.entry import build_sim
    from mythos_tpu_torch.io.synthetic import synthetic_duplex
    from mythos_tpu_torch.observables import PropellerTwist
    from mythos_tpu_torch.ops import tiles
    from mythos_tpu_torch.rigid_body import RigidBody

    k3 = {"K3": tiles.tile_forces}

    def leaves(e):
        return {k: v.detach().clone().requires_grad_(True) for k, v in e.opt_params().items()}

    def twist_loss(n_nt):
        bps = torch.tensor([[i, n_nt - 1 - i] for i in range(n_nt // 2)], device=dev)
        obs = PropellerTwist(rigid_body_transform_fn=dna2.default_transform_soa_fn(), h_bonded_base_pairs=bps)
        return lambda traj: (obs(traj).mean() - 21.7) ** 2

    # 13a. 1,000 nt, DIRECT_STEPS steps, a rebuild and a state every 40
    topology, body = synthetic_duplex(DIRECT_N_BP, dtype=torch.float32, device=dev)
    n_nt = topology.n_nucleotides
    energy_fn, sim = build_sim(topology, KT, mode="block", init_centers=body.center, device=dev)
    loss_fn = twist_loss(n_nt)

    def run_with(p, n_steps, seed, s=sim):
        return lambda: s.run(p, body, n_steps, torch.Generator(device=dev).manual_seed(seed)).observables[0]

    _grad_eval(run_with(leaves(energy_fn), DIRECT_WARM, 40), loss_fn, k3)
    p = leaves(energy_fn)
    r = _grad_eval(run_with(p, DIRECT_STEPS, 41), loss_fn, k3)
    g = _grads_of(p)
    tiles.tile_forces.launches = 0
    with torch.no_grad():
        sim.run(energy_fn.opt_params(), body, DIRECT_STEPS, torch.Generator(device=dev).manual_seed(41))
    plain_k3 = tiles.tile_forces.launches
    g_max, n_nonzero, finite = _grad_summary(g)
    t_all = r["fwd_s"] + r["bwd_s"]
    print(f"[13a block direct] {DIRECT_STEPS} steps at {n_nt} nt, block tier, propeller-twist loss {float(r['loss']):.6g}: "
          f"forward {r['fwd_s']:.3f} s, backward {r['bwd_s']:.3f} s ({r['bwd_s'] / t_all:.0%} of the evaluation) = "
          f"{DIRECT_STEPS * 60.0 / t_all:.1f} grad-steps/min on {smi}; max|grad| {g_max:.4g}, d/d eps_stack_base "
          f"{float(g['eps_stack_base']):.6g}, d/d eps_hb {float(g['eps_hb']):.6g}, {n_nonzero} of {len(g)} nonzero; "
          f"K3 launches forward {r['fwd']['K3']} (the run without gradients {plain_k3}), backward {r['bwd']['K3']}; "
          f"peak memory {r['peak']:.1f} MiB ({r['rise']:.1f} above the start)")
    if not (finite and g_max > 0 and float(g["eps_stack_base"]) != 0 and bool(torch.isfinite(r["loss"]))):
        raise SystemExit("the block tier's gradient is non-finite or zero, or none for eps_stack_base")
    if r["fwd"]["K3"] != plain_k3 or plain_k3 < DIRECT_STEPS or r["bwd"]["K3"] != 0:
        raise SystemExit(f"the differentiated block run launched K3 {r['fwd']}, {r['bwd']}, without gradients {plain_k3}")
    out = {"K3 fwd": r["fwd"]["K3"], "K3 bwd": r["bwd"]["K3"], "bwd_s": r["bwd_s"]}

    # 13b. 40 bp, 40 steps at kT 0 from a jittered state: card vs CPU
    top_s, b_s = synthetic_duplex(40, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(42)
    q = b_s.orientation + 0.01 * torch.randn(b_s.orientation.shape, generator=gen)
    c = b_s.center + 0.01 * torch.randn(b_s.center.shape, generator=gen)
    b_s = RigidBody(c, q / q.norm(dim=-1, keepdim=True))
    w = torch.randn((1, top_s.n_nucleotides, 7), generator=gen)

    def small(device):
        b = RigidBody(b_s.center.to(device), b_s.orientation.to(device))
        e, s_ = build_sim(top_s, 0.0, mode="block", init_centers=b.center, device=device)
        wd = w.to(device)
        pp = leaves(e)
        traj = s_.run(pp, b, 40, torch.Generator(device=device).manual_seed(0)).observables[0]
        value = (wd[..., :3] * traj.center).sum() + (wd[..., 3:] * traj.orientation).sum()
        value.backward()
        return float(value.detach()), {k: v.cpu() for k, v in _grads_of(pp).items()}

    (l_gpu, g_gpu), (l_cpu, g_cpu) = small(dev), small("cpu")
    _card_vs_cpu("13b block direct small input: 40 bp, 40 steps, kT=0", l_gpu, g_gpu, l_cpu, g_cpu, 1e-5)
    if float(g_cpu["eps_stack_base"]) == 0:
        raise SystemExit("13b: no gradient for eps_stack_base")

    # 13c. 1,000 nt, 40 steps in 4 rebuild intervals, a state every interval:
    # checkpoint_every 1 (each save a checkpoint, recomputed in the backward)
    # against 0, after one small checkpointed call (its first-call costs)
    x = torch.ones(1, device=dev, requires_grad=True)
    checkpoint(torch.sin, x, use_reentrant=False).backward()
    u_c = DIRECT_PER_STEP // 4
    runs = {}
    for ck in (1, 0):
        sim_c = sim.replace(save_every=u_c, neighbor_update_every=u_c, checkpoint_every=ck)
        pc = leaves(energy_fn)
        runs[ck] = (_grad_eval(run_with(pc, DIRECT_PER_STEP, 43, sim_c), loss_fn, k3), _grads_of(pc))
        rc = runs[ck][0]
        print(f"[13c block direct checkpoint_every={ck}] {DIRECT_PER_STEP} steps at {n_nt} nt in 4 rebuild intervals: "
              f"forward {rc['fwd_s']:.3f} s, backward {rc['bwd_s']:.3f} s on {smi}; K3 launches forward "
              f"{rc['fwd']['K3']}, backward (the recompute) {rc['bwd']['K3']}; memory held after the forward "
              f"{rc['held']:.1f} MiB, peak {rc['rise']:.1f} MiB above the start ({rc['peak']:.1f} MiB in all)")
        n_tables = rc["fwd"]["K3"] // (DIRECT_PER_STEP + 1)
        want_bwd = n_tables * DIRECT_PER_STEP if ck else 0
        if rc["fwd"]["K3"] != n_tables * (DIRECT_PER_STEP + 1) or rc["bwd"]["K3"] != want_bwd:
            raise SystemExit(f"13c launched K3 {rc['fwd']}, {rc['bwd']} (checkpoint_every {ck})")
    g1, g0 = runs[1][1], runs[0][1]
    ck_err = max(float(((g1[k] - g0[k]).abs() / g0[k].abs().clamp_min(1e-30)).max()) for k in g0)
    ck_ok = all(bool(((g1[k] - g0[k]).abs() <= 1e-5 * g0[k].abs()).all()) for k in g0)
    print(f"[13c checkpoint] gradient with checkpoint_every 1 against 0: max relative difference {ck_err:.3e} "
          f"(rtol 1e-5); equal bits: {all(torch.equal(g1[k], g0[k]) for k in g0)}")
    if not ck_ok or not _grad_summary(g1)[2] or _grad_summary(g1)[0] == 0:
        raise SystemExit("checkpoint_every changed the block tier's gradient, or it is not finite and nonzero")

    # 13d. full width: the 10k-nt 270-degree arc, 40 steps, a loss on the last state
    top_a, body_a = synthetic_duplex(N_BP, bend=math.radians(270), dtype=torch.float32, device=dev)
    e_a, sim_a = build_sim(top_a, KT, mode="block", init_centers=body_a.center, device=dev)
    w_a = torch.randn((top_a.n_nucleotides, 3), generator=torch.Generator().manual_seed(44)).to(dev)
    pa = leaves(e_a)
    ra = _grad_eval(lambda: sim_a.run(pa, body_a, DIRECT_PER_STEP, torch.Generator(device=dev).manual_seed(45))
                    .observables[0], lambda traj: (w_a * traj.center[-1]).sum(), k3)
    g_max, n_nonzero, finite = _grad_summary(_grads_of(pa))
    print(f"[13d block direct full width] {DIRECT_PER_STEP} steps at {top_a.n_nucleotides} nt, 270-degree arc: loss "
          f"{float(ra['loss']):.6g}; forward {ra['fwd_s']:.3f} s, backward {ra['bwd_s']:.3f} s on {smi}; max|grad| "
          f"{g_max:.4g}, {n_nonzero} of {len(pa)} nonzero; K3 launches forward {ra['fwd']['K3']}, backward "
          f"{ra['bwd']['K3']}; peak memory {ra['peak']:.1f} MiB ({ra['rise']:.1f} above the start)")
    if not finite or g_max == 0:
        raise SystemExit("the full-width block gradient is not finite and nonzero")
    _lap("13 block direct differentiation")
    return out


def _martini_direct(dev, smi: str) -> dict:
    """Phase 14: direct differentiation through ``MartiniSimulator.run``
    (the barostat on) -- K6 forward on the card, its plain double backward
    (``ops.lj.LJGrads``). 14a the reference example's fit
    (examples/martini_bilayer_native.py): 5 Adam steps on lj_epsilon_C1_C1,
    each a 300-step NPT run; 14b the 10,160-bead bilayer of phase 9, 50
    steps, d (mean APL) / d lj_epsilon_C1_C1; 14c the 104-bead bilayer with
    the same pre-drawn noise, card vs CPU. Returns {"K6 fwd", "K6 bwd":
    14b's launches forward and backward, "bwd_s": 14b's backward seconds}."""
    import torch

    from mythos_tpu_torch.energy.martini.systems import default_bilayer_terms, lattice_bilayer
    from mythos_tpu_torch.observables import AreaPerLipid
    from mythos_tpu_torch.ops import lj
    from mythos_tpu_torch.simulators.martini import MartiniSimulator

    k6 = {"K6 fwd": lj.lj_energy, "K6 bwd": lj.lj_grads, "K6 cells": lj.lj_cells}

    def bilayer(n_x, n_y, layers, device, **kw):
        top, pos, box, masses = lattice_bilayer(n_x, n_y, water_layers=layers)
        sim = MartiniSimulator(energy_fns=default_bilayer_terms(top), box=box, masses=masses,
                               barostat=MARTINI_BAROSTAT, device=device, **kw)
        heads = [i for i, nm in enumerate(top.atom_names) if nm == "PO4"]
        return sim, torch.as_tensor(pos, dtype=torch.float32, device=device), AreaPerLipid(head_indices=heads)

    # 14a. the reference example's fit: 5 Adam steps on the tail-tail epsilon
    sim, x0, apl = bilayer(*MARTINI_FIT_LATTICE, dev, dt=0.02, save_every=50)
    eps = torch.tensor(3.5, device=dev, requires_grad=True)
    opt = torch.optim.Adam([eps], lr=0.1)
    t0 = time.perf_counter()
    for step in range(MARTINI_FIT_STEPS):
        opt.zero_grad()
        r = _grad_eval(lambda: sim.run({"lj_epsilon_C1_C1": eps}, x0, MARTINI_FIT_MD,
                                       torch.Generator(device=dev).manual_seed(step)).observables[0],
                       lambda traj: (apl(traj)[-3:].mean() - 0.64) ** 2, k6)
        grad = float(eps.grad)
        opt.step()
        print(f"[14a MARTINI fit] step {step}: loss={float(r['loss']):.5f} eps_C1_C1={float(eps.detach()):.3f} "
              f"grad={grad:+.4f}; forward {r['fwd_s']:.3f} s, backward {r['bwd_s']:.3f} s; launches forward "
              f"{r['fwd']}, backward {r['bwd']}; peak {r['peak']:.1f} MiB ({r['rise']:.1f} above the start)")
        if not (math.isfinite(grad) and bool(torch.isfinite(r["loss"]))) or r["fwd"]["K6 fwd"] < MARTINI_FIT_MD:
            raise SystemExit("the MARTINI fit gave a non-finite loss or gradient, or did not go through K6")
        if r["bwd"] != dict.fromkeys(k6, 0) or r["fwd"]["K6 cells"] != r["fwd"]["K6 fwd"]:
            raise SystemExit(f"the MARTINI fit launched K6 {r['fwd']}, {r['bwd']}")
    print(f"[14a MARTINI fit] {MARTINI_FIT_STEPS} Adam steps of {MARTINI_FIT_MD} NPT steps at {x0.shape[0]} beads: "
          f"{time.perf_counter() - t0:.3f} s on {smi}")

    # 14b. full width: the 10,160-bead bilayer, 50 steps, d (mean APL) / d epsilon
    sim_b, x_b, apl_b = bilayer(*MARTINI_LATTICE, dev, save_every=MARTINI_BAROSTAT["every"])
    eps_b = torch.tensor(3.5, device=dev, requires_grad=True)
    r = _grad_eval(lambda: sim_b.run({"lj_epsilon_C1_C1": eps_b}, x_b, MARTINI_DIRECT_STEPS,
                                     torch.Generator(device=dev).manual_seed(46)).observables[0],
                   lambda traj: apl_b(traj).mean(), k6)
    print(f"[14b MARTINI direct full width] {MARTINI_DIRECT_STEPS} NPT steps at {x_b.shape[0]} beads: mean APL "
          f"{float(r['loss']):.6f} nm^2, d/d lj_epsilon_C1_C1 {float(eps_b.grad):.6g}; forward {r['fwd_s']:.3f} s, "
          f"backward {r['bwd_s']:.3f} s on {smi}; launches forward {r['fwd']}, backward {r['bwd']}; peak memory "
          f"{r['peak']:.1f} MiB ({r['rise']:.1f} above the start)")
    evals = 1 + MARTINI_DIRECT_STEPS + MARTINI_DIRECT_STEPS // MARTINI_BAROSTAT["every"]
    if not math.isfinite(float(eps_b.grad)) or float(eps_b.grad) == 0.0:
        raise SystemExit("the full-width MARTINI gradient is not finite and nonzero")
    if r["fwd"] != dict.fromkeys(k6, evals) or r["bwd"] != dict.fromkeys(k6, 0):
        raise SystemExit(f"the differentiated NPT run launched K6 {r['fwd']}, {r['bwd']}, not {evals} each forward")
    out = {"K6 fwd": r["fwd"]["K6 fwd"], "K6 bwd": r["fwd"]["K6 bwd"], "bwd_s": r["bwd_s"]}

    # 14c. the 104-bead bilayer with the same pre-drawn noise: card vs CPU
    top_s, pos_s, _, masses_s = lattice_bilayer(3, 3, water_layers=1)
    gen = torch.Generator().manual_seed(47)
    mom = torch.randn(pos_s.shape, generator=gen) * (float(masses_s[0]) * sim.kT) ** 0.5
    noise = torch.randn((50, *pos_s.shape), generator=gen)

    def small(device):
        s_, x_s, apl_s = bilayer(3, 3, 1, device, save_every=10)
        pp = {"lj_epsilon_C1_C1": torch.tensor(3.5, device=device, requires_grad=True),
              "lj_sigma_C1_C1": torch.tensor(0.47, device=device, requires_grad=True)}
        traj = s_.run(pp, x_s, 50, init_momentum=mom, noise=noise).observables[0]
        value = apl_s(traj).mean()
        value.backward()
        return float(value.detach()), {k: v.grad.detach().cpu().reshape(1) for k, v in pp.items()}

    (l_gpu, g_gpu), (l_cpu, g_cpu) = small(dev), small("cpu")
    _card_vs_cpu("14c MARTINI direct small input: 104 beads, 50 NPT steps", l_gpu, g_gpu, l_cpu, g_cpu, 1e-4, 1e-5)
    _lap("14 MARTINI direct differentiation")
    return out


def _dna1(dev, smi: str, ptx: dict) -> list[dict]:
    """Phase 15: oxDNA1 -- K2's and K1's dna1 instances against their plain
    versions at 10k nt (15a, 15b), the stencil main path through them
    (15c), K3's dna1 instance on the one-level tables and the block tier on
    the arc (15d), the small-system path and the oxDNA file readers (15e).
    The K1, K2 and K3 dna1 records."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    import mythos_tpu_torch.energy.dna1 as dna1
    from mythos_tpu_torch import entry
    from mythos_tpu_torch.entry import build_sim
    from mythos_tpu_torch.io import topology as io_top
    from mythos_tpu_torch.io import trajectory as io_traj
    from mythos_tpu_torch.io.synthetic import synthetic_duplex
    from mythos_tpu_torch.ops import stencil as st
    from mythos_tpu_torch.ops import tiles
    from mythos_tpu_torch.rigid_body import RigidBody
    from mythos_tpu_torch.soa import Quat, quat_frame_soa, to_soa

    site_cutoffs = dna1.per_term_site_cutoffs()
    topology, body = synthetic_duplex(N_BP, dtype=torch.float32, device=dev)
    energy_fn, sim = build_sim(topology, KT, model="dna1", init_centers=body.center,
                               init_orientation=body.orientation, device=dev)
    ctx = st.prepare_stencil_context(energy_fn, sim.band, device=dev)
    n, u = ctx.n, sim.neighbor_update_every
    print(f"[15 dna1] {n} nt B-form: family {ctx.family}, w_terms={ctx.w_terms} w_wide={ctx.w_wide} "
          f"check_dm={ctx.check_dm} {ctx.checks.shape[0]} exact checks, overflow at init={bool(sim.band.did_overflow)}")
    gen = torch.Generator(device=dev).manual_seed(21)

    def jittered(b):
        q = b.orientation + 0.01 * torch.randn(b.orientation.shape, generator=gen, device=dev)
        c = b.center + 0.01 * torch.randn(b.center.shape, generator=gen, device=dev)
        return RigidBody(c, q / q.norm(dim=-1, keepdim=True))

    # 15a. K2 (dna1) against its plain version on the jittered 10k-nt duplex
    jb = jittered(body)
    dyn = torch.cat([ctx.to_slots(jb.center.T), ctx.to_slots(jb.orientation.T)]).contiguous()
    k2r = _k2_held("15a K2 dna1", ctx, dyn, ptx, site_cutoffs)
    if k2r["tally"]["debye"] or k2r["tally"]["Debye"]:
        raise SystemExit(f"K2's dna1 instance gated pairs in by Debye: {k2r['tally']}")

    # 15b. K1 (dna1): one 40-step chunk, the same bf16 noise; 10k nt inside the
    # float32 budget of phase 4, 80 nt to the fixed tolerance (else that budget)
    ou = st.ou_constants(sim.dt, sim.kT, [sim.mass], [sim.inertia], [sim.gamma_t], [sim.gamma_r]).vector(dev)
    _, budget, det, err1, k1_ms, p1_ms, state, noise = _k1_held("15b K1 dna1 10k", ctx, sim, jittered(body), ou, gen)
    if not (budget and det):
        raise SystemExit("K1's dna1 instance is outside the float32 budget of its plain version, or not deterministic")
    k1_win = _profiled(lambda: st.multistep_chunk(ctx, ou, noise, state), 3)
    k1_dev = _per_call(k1_win, {"k1_step": u, "k1_entry": 1})
    regs, spill = ptx.get(f"k1_step_kernel<{FAMILY_CODE['dna1']}>", (0, -1))
    print(f"[15b K1 dna1] device time {_dev(k1_dev)} a chunk ({_kernel_list(k1_win)}); k1_step_kernel<2>: {regs} "
          f"registers, {spill} B spill stores (the dna2 instance's: {ptx.get('k1_step_kernel<0>', (0, -1))})")
    top_s, body_s = synthetic_duplex(40, dtype=torch.float32, device=dev)
    _, sim_s = build_sim(top_s, KT, model="dna1", init_centers=body_s.center, init_orientation=body_s.orientation,
                         device=dev)
    ctx_s = st.prepare_stencil_context(sim_s.energy_fn, sim_s.band, device=dev)
    fixed_s, budget_s, det_s, *_ = _k1_held("15b K1 dna1 80 nt", ctx_s, sim_s, jittered(body_s), ou, gen)
    if not ((fixed_s or budget_s) and det_s):
        raise SystemExit("K1's dna1 instance disagrees with its plain version at 80 nt")
    _lap("15a-b K2, K1 dna1")

    # 15c. the stencil main path: warm-up run, then the counted, timed run
    params = energy_fn.opt_params()
    sim.run(params, body, N_STEPS, torch.Generator(device=dev).manual_seed(22))
    st.field_grads.launches = st.multistep_chunk.launches = 0
    st.field_grads.by_family = dict.fromkeys(st.FAMILIES, 0)
    st.multistep_chunk.by_family = dict.fromkeys(st.FAMILIES, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.run(params, body, N_STEPS, torch.Generator(device=dev).manual_seed(23))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"K1": st.multistep_chunk.by_family["dna1"], "K2": st.field_grads.by_family["dna1"]}
    traj = out.observables[0]
    finite = bool(torch.isfinite(traj.center).all() and torch.isfinite(traj.orientation).all())
    qdev = float((traj.orientation.norm(dim=-1) - 1.0).abs().max())
    overflow = bool(traj.metadata["neighbor_overflow"].any())
    print(f"[15c dna1 main path] {N_STEPS} steps at {n} nt: {elapsed:.3f} s = {N_STEPS / elapsed * 60.0:.1f} "
          f"steps/min on {smi}; states {tuple(traj.center.shape)} finite={finite} max||q|-1|={qdev:.2e} "
          f"overflow={overflow} (the band's B-DNA slacks, site margin 1) launches={launches}")
    if not finite or qdev > 1e-5:
        raise SystemExit("the dna1 main path produced a bad trajectory")
    if launches["K1"] != N_STEPS // u or launches["K2"] < 1:
        raise SystemExit(f"the dna1 main path did not run through the dna1 kernels: {launches}")
    w = _profiled(lambda: sim.run(params, body, 10 * u, torch.Generator(device=dev).manual_seed(23)))
    k1_chunk = _per_call(w, {"k1_step": u, "k1_entry": 1})
    print(f"[15c profile] {10 * u} steps under torch.profiler: wall {w['wall_ms']:.1f} ms, device kernels "
          f"{w['device_ms']:.1f} ms (idle share {1 - w['device_ms'] / w['wall_ms']:.0%}), K1's kernels "
          f"{_dev(k1_chunk)} a chunk, {w['launches'] / (10 * u):.2f} launches per step")

    def small_stencil(device):
        top, b = synthetic_duplex(40, dtype=torch.float32, device=device)
        e, s_ = build_sim(top, 0.0, model="dna1", init_centers=b.center, init_orientation=b.orientation,
                          neighbor_update_every=10, device=device)
        o = s_.replace(save_every=10).run(e.opt_params(), b, 40, torch.Generator(device=device).manual_seed(0))
        return o.observables[0]

    gpu, cpu = small_stencil(dev), small_stencil("cpu")
    okc, errc = _within(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    okq, errq = _within(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
    print(f"[15c small input] 40 bp, 40 steps, kT=0: card vs CPU center err {errc:.2e} quat err {errq:.2e}")
    if not (okc and okq):
        raise SystemExit("the card's dna1 stencil trajectory disagrees with the CPU")
    n_bonds = int((ctx.dirf != 0).sum())
    k1_bound = _bound(
        (19 + 20) * n * 4 + u * 6 * n * 2,
        u * (k2r["tally"]["short"] * FLOP_PAIR_GRAD + n_bonds * FLOP_BOND_GRAD + n * FLOP_BODY_STEP),
    )
    print(f"[15c bounds] {k2r['tally']['short']} band pairs inside a short-range cutoff, {n_bonds} bonds: K1 dna1 "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}; {_share(k1_bound[0], k1_dev)} of its device time)")
    _lap("15c dna1 main path")

    # 15d. K3 (dna1) against its plain version on the one-level tables of the
    # jittered duplex and the 270-degree arc; then the block tier on the arc
    k3 = {"err": 0.0}
    for label, bend in (("ideal", None), ("arc270", math.radians(270))):
        top_b, b0 = synthetic_duplex(N_BP, bend=bend, dtype=torch.float32, device=dev)
        e_b, sim_b = build_sim(top_b, KT, mode="block", model="dna1", block_size=8, init_centers=b0.center,
                               device=dev)
        nbl = sim_b.neighbors
        (tctx,) = tiles.prepare_contexts(e_b, nbl.idx, nbl.block_size, perm=nbl.perm)
        ids, sp, P = nbl.idx, tctx.spec, tctx.params
        rows = tiles.dynamic_rows(tctx, to_soa(jittered(b0))).contiguous()
        geo = _pair_geometry(tctx, ids, rows, site_cutoffs)
        full, tri, short, _, _, ulps, _ = geo
        near = ((ulps <= CLAMP_ULPS) & short & full).any(-1).reshape(-1)
        k_ms, got = _events_ms(lambda: tiles.tile_forces(rows, P, ids, sp), 20)
        p_ms, ref = _events_ms(lambda: tiles.tile_forces_plain(rows, P, ids, sp), 3)
        ok, rule, err = _checked("15d K3 dna1", got, ref, tiles.tile_forces_plain(rows.double(), P.double(), ids, sp),
                                 near)
        again, counts = tiles._tile_forces(rows, P, ids, sp, count=True)
        tally = dict(zip(("short", "debye", "skipped"), counts.tolist(), strict=True))
        gate = tiles.tile_gate_counts(rows, P, ids, sp)
        same = torch.equal(got, again)
        tally_ok = sum(abs(tally[k] - gate[k]) for k in gate) <= 1e-4 * sum(gate.values()) and tally["debye"] == 0
        win = _profiled(lambda: tiles.tile_forces(rows, P, ids, sp), 10)
        dev_ms = _kernels_ms(win, f"tile_forces_kernel<{FAMILY_CODE['dna1']}>")
        print(f"[15d K3 dna1 {label}] B={nbl.block_size} cap {nbl.capacity} (one table: {nbl.r_cutoff_inner is None}) "
              f"banded={nbl.banded} overflow={bool(nbl.did_overflow)}; {int(near.sum())} of {sp.n} rows near the "
              f"clamp; err {err:.2e} ({rule}) ok={ok}; kernel {statistics.median(k_ms):.4f} ms by events, "
              f"{_dev(dev_ms)} of device time a call, plain {statistics.median(p_ms):.2f} ms; the pairs a call: "
              f"kernel {tally}, plain gate {gate}; equal bits on a second call: {same}")
        if not (ok and same and tally_ok):
            raise SystemExit(f"K3's dna1 instance disagrees with its plain version or gate, or is not deterministic "
                             f"({label})")
        k3["err"] = max(k3["err"], err)
        if label == "ideal":
            n_short = int((short & tri).sum())
            in_bytes = sp.n_pad * sp.n_fields * 4 + sp.n_blocks * sp.cap * 4 + 4 * st.param_offsets()["TOTAL"]
            k3.update(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms), dev_ms=dev_ms,
                      bound=_bound(in_bytes + sp.n_pad * 12 * 4, n_short * FLOP_PAIR_GRAD))
            print(f"[15d bounds] {n_short} unordered pairs inside the short-range reach: K3 dna1 "
                  f"{k3['bound'][0]:.5f} ms ({k3['bound'][1]}; {_share(k3['bound'][0], dev_ms)} of its device time)")
    e_a, sim_a, body_a = e_b, sim_b, b0  # the arc's
    sim_a.run(e_a.opt_params(), body_a, sim_a.save_every, torch.Generator(device=dev).manual_seed(24))
    tiles.tile_forces.by_family = dict.fromkeys(tiles.tile_forces.by_family, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_a = sim_a.run(e_a.opt_params(), body_a, DNA1_BLOCK_STEPS, torch.Generator(device=dev).manual_seed(25))
    torch.cuda.synchronize()
    el_a = time.perf_counter() - t0
    k3_launches = tiles.tile_forces.by_family["dna1"]
    tr_a = out_a.observables[0]
    fin_a = bool(torch.isfinite(tr_a.center).all() and torch.isfinite(tr_a.orientation).all())
    ovf_a = bool(tr_a.metadata["neighbor_overflow"].any())
    print(f"[15d dna1 block tier] {DNA1_BLOCK_STEPS} steps at {n} nt, 270-degree arc, one table: {el_a:.3f} s = "
          f"{DNA1_BLOCK_STEPS / el_a * 60.0:.1f} steps/min on {smi}; K3 dna1 {k3_launches} launches; finite={fin_a} "
          f"overflow={ovf_a}")
    if not fin_a or ovf_a or k3_launches < DNA1_BLOCK_STEPS:
        raise SystemExit("the dna1 block tier produced a bad trajectory or did not run through K3's dna1 instance")
    u_a = PROFILE_STEPS
    w = _profiled(lambda: sim_a.replace(save_every=u_a, neighbor_update_every=u_a).run(
        e_a.opt_params(), body_a, u_a, torch.Generator(device=dev).manual_seed(26)))
    print(f"[15d profile] {u_a} steps under torch.profiler: wall {w['wall_ms']:.1f} ms, device kernels "
          f"{w['device_ms']:.1f} ms (idle share {1 - w['device_ms'] / w['wall_ms']:.0%}), "
          f"{w['launches'] / u_a:.0f} launches per step")

    def small_block(device):
        top, b = synthetic_duplex(40, dtype=torch.float32, device=device)
        e, s_ = build_sim(top, 0.0, mode="block", model="dna1", init_centers=b.center, neighbor_update_every=5,
                          device=device)
        return s_.replace(save_every=10).run(e.opt_params(), b, 40,
                                             torch.Generator(device=device).manual_seed(0)).observables[0]

    gpu, cpu = small_block(dev), small_block("cpu")
    okc, errc = _within(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    okq, errq = _within(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
    print(f"[15d small input] 40 bp, 40 steps, kT=0, block: card vs CPU center err {errc:.2e} quat err {errq:.2e}")
    if not (okc and okq):
        raise SystemExit("the card's dna1 block trajectory disagrees with the CPU")
    _lap("15d K3 dna1, block tier")

    # 15e. the small-system path: entry()'s step, the oxDNA files, pairs
    step, (s0,) = entry.entry(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ENTRY_STEPS):
        s0 = step(s0)
    torch.cuda.synchronize()
    el_e = time.perf_counter() - t0
    fin_e = bool(torch.isfinite(s0.position.center).all())
    print(f"[15e entry] {ENTRY_STEPS} steps of the 8-bp dna1 dense step on the card: {el_e:.3f} s "
          f"({el_e / ENTRY_STEPS * 1e3:.2f} ms a step), finite={fin_e}")
    top_f, body_f = synthetic_duplex(SMALL_BP, dtype=torch.float64, device="cpu")
    a1, _, a3 = (torch.stack(tuple(v), -1) for v in quat_frame_soa(Quat(*body_f.orientation.unbind(-1))))
    with tempfile.TemporaryDirectory() as tmp:
        top_path, conf_path = io_top.to_oxdna_files(Path(tmp), top_f, body_f)
        top_r = io_top.from_oxdna_file(top_path)
        state_r = io_traj.from_file(conf_path, top_r.strand_counts, is_5p_3p=False).states[0]
    body_r = state_r.to_rigid_body(dtype=torch.float32, device=dev)
    a1_r, _, a3_r = (torch.stack(tuple(v), -1) for v in quat_frame_soa(Quat(*body_r.orientation.double().unbind(-1))))
    io_err = max(float((body_r.center.double().cpu() - body_f.center).abs().max()),
                 float((a1_r.cpu() - a1).abs().max()), float((a3_r.cpu() - a3).abs().max()))
    same_top = (np.array_equal(top_r.seq, top_f.seq) and np.array_equal(top_r.bonded_neighbors, top_f.bonded_neighbors))
    print(f"[15e files] a {SMALL_BP}-bp duplex written as sys.top (classic) and init.conf, read back by the port's "
          f"readers: topology equal {same_top}, positions and frames within {io_err:.1e}")
    if not same_top or io_err > 1e-6:
        raise SystemExit("the oxDNA files did not read back as written")
    e_p, sim_p = build_sim(top_r, KT, mode="pairs", model="dna1", device=dev)
    params_p = e_p.opt_params()
    sim_p.run(params_p, body_r, 10, torch.Generator(device=dev).manual_seed(27))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = sim_p.run(params_p, body_r, SMALL_STEPS, torch.Generator(device=dev).manual_seed(28))
    torch.cuda.synchronize()
    el_p = time.perf_counter() - t0
    tr_p = out_p.observables[0]
    fin_p = bool(torch.isfinite(tr_p.center).all() and torch.isfinite(tr_p.orientation).all())
    w = _profiled(lambda: sim_p.run(params_p, body_r, PROFILE_STEPS, torch.Generator(device=dev).manual_seed(29)))
    print(f"[15e pairs] {SMALL_STEPS} steps of {top_r.n_nucleotides} nt on the pair list on the card: {el_p:.3f} s = "
          f"{SMALL_STEPS / el_p * 60.0:.1f} steps/min on {smi}; states {tuple(tr_p.center.shape)} finite={fin_p}; "
          f"{PROFILE_STEPS} steps under torch.profiler: {w['launches'] / PROFILE_STEPS:.0f} launches per step, idle "
          f"share {1 - w['device_ms'] / w['wall_ms']:.0%} (no kernel of the port: autograd on the card)")
    if not fin_p or tr_p.center.device.type != torch.device(dev).type:
        raise SystemExit("the small-system path produced a bad trajectory or left the card")

    def small_pairs(device):
        e, s_ = build_sim(top_r, 0.0, mode="pairs", model="dna1", device=device)
        b = RigidBody(body_r.center.to(device), body_r.orientation.to(device))
        return s_.run(e.opt_params(), b, 40, torch.Generator(device=device).manual_seed(0)).observables[0]

    gpu, cpu = small_pairs(dev), small_pairs("cpu")
    okc, errc = _within(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    okq, errq = _within(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
    print(f"[15e small input] {SMALL_BP} bp, 40 steps, kT=0, pairs: card vs CPU center err {errc:.2e} quat err "
          f"{errq:.2e}")
    if not (okc and okq and fin_e):
        raise SystemExit("the card's small-system trajectory disagrees with the CPU, or entry() gave non-finite states")
    _lap("15 dna1")
    src = "mythos_tpu_torch/ops/csrc/"
    return [
        {"name": "K1 multistep_chunk (dna1)", "route": "cuda", "source": src + "multistep.cu",
         "replaces": "mythos_tpu/ops/stencil.py:2236", "launches": launches["K1"], "max_abs_err": err1,
         "ms": statistics.median(k1_ms), "plain_ms": statistics.median(p1_ms), "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "K2 field_grads (dna1)", "route": "cuda", "source": src + "stencil_grads.cu",
         "replaces": "mythos_tpu/ops/stencil.py:1420", "launches": launches["K2"], "max_abs_err": k2r["err"],
         "ms": statistics.median(k2r["ms"]), "plain_ms": statistics.median(k2r["plain_ms"]),
         "bound_ms": k2r["bound"][0], "bound_by": k2r["bound"][1], "library_ms": None},
        {"name": "K3 tile_forces (dna1)", "route": "cuda", "source": src + "tiles.cu",
         "replaces": "mythos_tpu/ops/oxdna_tiles.py:1094", "launches": k3_launches, "max_abs_err": k3["err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound"][0], "bound_by": k3["bound"][1],
         "library_ms": None},
    ]


def _dna1_difftre(dev, smi: str, ptx: dict) -> list[dict]:
    """Phase 16: DiffTRe under oxDNA1 -- K4's and K5's dna1 instances
    against their plain versions at 10k nt (16a), the fit at full width
    through BoundSimulator, DiffTReObjective, SimpleOptimizer and
    ConsoleLogger (16b), the reference example's own shape at 40 bp through
    its ``main()``, its first step card vs CPU (16c), and the native
    trajectory parser on a 10k-nt, 50-state trajectory (16d). The K4 and K5
    dna1 records."""
    import functools
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    import mythos_tpu_torch.energy.dna1 as dna1
    from mythos_tpu_torch.entry import build_sim
    from mythos_tpu_torch.examples import difftre_propeller_fit as fit_example
    from mythos_tpu_torch.io import native
    from mythos_tpu_torch.io import topology as io_top
    from mythos_tpu_torch.io import trajectory as io_traj
    from mythos_tpu_torch.io.synthetic import synthetic_duplex
    from mythos_tpu_torch.ops import stencil as st
    from mythos_tpu_torch.ops import tiles
    from mythos_tpu_torch.optimization import DiffTReObjective, SimpleOptimizer
    from mythos_tpu_torch.rigid_body import RigidBody
    from mythos_tpu_torch.simulators.base import BoundSimulator
    from mythos_tpu_torch.simulators.neighbors import block_neighbor_list_for_topology, strand_interleave_perm
    from mythos_tpu_torch.soa import to_soa
    from mythos_tpu_torch.ui.loggers import ConsoleLogger

    topology, body = synthetic_duplex(N_BP, dtype=torch.float32, device=dev)
    energy_fn, sim = build_sim(topology, KT, model="dna1", init_centers=body.center,
                               init_orientation=body.orientation, device=dev)
    map_nbl = block_neighbor_list_for_topology(topology, dna1.default_neighbor_cutoff(), block_size=8,
                                               init_centers=body.center, perm=strand_interleave_perm(topology))
    gen = torch.Generator(device=dev).manual_seed(31)
    q = body.orientation + 0.01 * torch.randn(body.orientation.shape, generator=gen, device=dev)
    jb = RigidBody(body.center + 0.01 * torch.randn(body.center.shape, generator=gen, device=dev),
                   q / q.norm(dim=-1, keepdim=True))

    # 16a. K4 and K5 (dna1) against their plain versions on the jittered duplex's table
    (ctx,) = tiles.prepare_contexts(energy_fn, map_nbl.idx, map_nbl.block_size, perm=map_nbl.perm)
    sp, P, ids = ctx.spec, ctx.params, map_nbl.idx
    rows = tiles.dynamic_rows(ctx, to_soa(jb)).contiguous()
    rows64, P64 = rows.double(), P.double()
    geo = _pair_geometry(ctx, ids, rows, dna1.per_term_site_cutoffs())
    full, tri, short, hb, _, ulps, _ = geo
    near = ((ulps <= CLAMP_ULPS) & short & full).any(-1).reshape(-1)
    gt = tiles.term_weights(P, sp) * torch.linspace(0.5, 1.5, len(sp.terms), device=dev)
    print(f"[16a K4/K5 dna1] {sp.n} nt, B={sp.block_size} cap {sp.cap} banded={map_nbl.banded} kind {sp.kind} "
          f"overflow={bool(map_nbl.did_overflow)}; {int(near.sum())} rows near the float32 arccos clamp")
    runs = {
        "K4": ("tile_energies", lambda: tiles.tile_energies(rows, P, ids, sp),
               lambda: tiles.tile_energies_plain(rows, P, ids, sp),
               lambda: tiles.tile_energies_plain(rows64, P64, ids, sp),
               lambda: tiles._tile_energies(rows, P, ids, sp, count=True), True),
        "K5": ("tile_row_grads", lambda: tiles.tile_row_grads(rows, P, ids, gt, sp),
               lambda: tiles.tile_row_grads_plain(rows, P, ids, gt, sp),
               lambda: tiles.tile_row_grads_plain(rows64, P64, ids, gt.double(), sp),
               lambda: tiles._tile_row_grads(rows, P, ids, gt, sp, count=True), False),
    }
    rec = {}
    for key, (cname, kern, plain, plain64, counted, triangular) in runs.items():
        k_ms, got = _events_ms(kern, 20)
        p_ms, ref = _events_ms(plain, 3)
        ok, rule, err = _checked(f"16a {key} dna1", got, ref, plain64(), near)
        again, counts = counted()
        tally = dict(zip(("short", "debye", "skipped"), counts.tolist(), strict=True))
        gate = tiles.tile_gate_counts(rows, P, ids, sp, triangular=triangular)
        same = torch.equal(got, again)
        tally_ok = sum(abs(tally[k] - gate[k]) for k in gate) <= 1e-4 * sum(gate.values()) and tally["debye"] == 0
        win = _profiled(kern, 10)
        dev_ms = _kernels_ms(win, "tile_")
        regs, spill = ptx.get(f"{cname}_kernel<{FAMILY_CODE['dna1']}>", (0, -1))
        print(f"[16a {key} dna1] err {err:.2e} ({rule}) ok={ok}; {statistics.median(k_ms):.4f} ms by events, "
              f"{_dev(dev_ms)} of device time a call ({_kernel_list(win)}), plain {statistics.median(p_ms):.2f} ms; "
              f"{cname}_kernel<2>: {regs} registers, {spill} B spill stores (the dna2 instance's: "
              f"{ptx.get(f'{cname}_kernel<0>', (0, -1))}); the pairs a call: kernel {tally}, plain gate {gate}; "
              f"equal bits on a second call: {same}")
        if not (ok and same and tally_ok):
            raise SystemExit(f"{key}'s dna1 instance disagrees with its plain version or gate, or is not deterministic")
        rec[key] = dict(err=err, ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms), dev_ms=dev_ms)
    k5 = tiles.tile_row_grads(rows, P, ids, tiles.term_weights(P, sp), sp)[:, : sp.n_force_fields]
    ok35, err35 = _within(k5, tiles.tile_forces(rows, P, ids, sp), rtol=1e-5, atol=5e-6)
    n_short, n_hb = int((short & tri).sum()), int((hb & tri).sum())
    in_bytes = sp.n_pad * sp.n_fields * 4 + sp.n_blocks * sp.cap * 4 + 4 * st.param_offsets()["TOTAL"]
    rec["K4"]["bound"] = _bound(in_bytes + 5 * 4, n_short * FLOP_PAIR_ENERGY)
    rec["K5"]["bound"] = _bound(in_bytes + sp.n_pad * 16 * 4, n_short * FLOP_PAIR_GRAD + n_hb * FLOP_PAIR_HB)
    print(f"[16a bounds] {int(tri.sum())} unordered pairs, {n_short} inside the short-range reach ({n_hb} the hb "
          f"reach), none Debye: " + "; ".join(
              f"{k} {r['bound'][0]:.5f} ms ({r['bound'][1]}; {_share(r['bound'][0], r['dev_ms'])} of its device time)"
              for k, r in rec.items()) + f"; K5's body fields vs K3 dna1 {err35:.1e}")
    if not ok35:
        raise SystemExit("K5's dna1 body fields disagree with K3's dna1 instance")
    _lap("16a K4, K5 dna1")

    # 16b. the fit at full width: BoundSimulator over the dna1 stencil (K1, K2),
    # DiffTReObjective on the tile map (K4, K5), SimpleOptimizer with Adam, ConsoleLogger
    simulator = BoundSimulator(name="propeller_sim", simulator=sim.replace(save_every=FIT_SAVE),
                               run_args=(body, FIT_MD_STEPS))
    objective = DiffTReObjective(
        name="propeller", required_observables=tuple(simulator.exposes()),
        grad_or_loss_fn=fit_example.propeller_loss_fn(topology, 21.7, dev),
        energy_fn=energy_fn.replace(map_neighbors=map_nbl), n_equilibration_steps=FIT_EQ)
    optimizer = SimpleOptimizer(objective=objective, simulator=simulator,
                                optimizer=functools.partial(torch.optim.Adam, lr=FIT_LR), logger=ConsoleLogger())
    params = energy_fn.opt_params()
    kernels = {"K1": st.multistep_chunk, "K2": st.field_grads, "K4": tiles.tile_energies, "K5": tiles.tile_row_grads}
    steps, outs = [], []

    def counts():
        return {k: fn.by_family["dna1"] for k, fn in kernels.items()}

    def record(optimizer_output, step):
        torch.cuda.synchronize()
        seq = optimizer_output.state.component_state["propeller_sim"]["seq"]
        steps.append((time.perf_counter(), seq, counts()))
        outs.append(optimizer_output)
        return None, True

    for fn in kernels.values():
        fn.by_family = dict.fromkeys(fn.by_family, 0)
    torch.cuda.synchronize()
    steps.append((time.perf_counter(), 0, counts()))
    final = optimizer.run(params, FIT_OPT_STEPS, callback=record)
    n_states = FIT_MD_STEPS // FIT_SAVE - FIT_EQ
    fit_launches = counts()
    resim_s, cached_s = [], []
    for k in range(1, len(steps)):
        (t0, seq0, c0), (t1, seq1, c1) = steps[k - 1], steps[k]
        obs = outs[k - 1].observables["propeller"]
        launched = {name: c1[name] - c0[name] for name in c1}
        (resim_s if seq1 > seq0 else cached_s).append(t1 - t0)
        print(f"[16b fit step {k - 1}] {t1 - t0:.3f} s, {'with' if seq1 > seq0 else 'without'} a resimulation "
              f"({seq1 - seq0} runs of {FIT_MD_STEPS} steps); loss {float(obs['loss']):.6g} n_eff "
              f"{float(obs['neff']):.6g} propeller twist {float(obs['propeller_twist']):.6g}; launches {launched}")
    traj = final.state.observables[simulator.exposes()[0]]
    # a step on cached states (the objective at the reference parameters and
    # the update), where the fit resimulated at every step
    cached = SimpleOptimizer(objective=objective, simulator=simulator,
                             optimizer=functools.partial(torch.optim.Adam, lr=FIT_LR))
    state0 = final.state.replace(component_state={
        **final.state.component_state, "propeller": {"opt_steps": 0}})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_cached = cached.step(final.opt_params, state0)
    torch.cuda.synchronize()
    el_cached = time.perf_counter() - t0
    if out_cached.state.component_state["propeller_sim"]["seq"] != final.state.component_state["propeller_sim"]["seq"]:
        raise SystemExit("the step on cached states resimulated")
    finite = all(bool(torch.isfinite(g).all()) for o in outs for g in o.grads.values()) and all(
        math.isfinite(float(o.observables["propeller"]["loss"])) for o in outs)
    moved = not torch.equal(params["eps_stack_base"], final.opt_params["eps_stack_base"])
    overflow = bool(traj.metadata["neighbor_overflow"].any())
    states = traj.slice(slice(FIT_EQ, traj.length()))
    with torch.no_grad():
        e_map = objective.energy_fn.with_params(final.opt_params)
        e_map.map(states)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e_new = e_map.map(states)
        torch.cuda.synchronize()
        el_map = time.perf_counter() - t0
    print(f"[16b fit] {len(outs)} Adam steps (lr {FIT_LR}) at {sp.n} nt, {FIT_MD_STEPS} MD steps a simulation, "
          f"{n_states} states reweighted on a B={sp.block_size} table: a step {statistics.mean(resim_s):.3f} s with a "
          f"resimulation ({len(resim_s)} steps), " + (f"{statistics.mean(cached_s):.3f} s without ({len(cached_s)})"
                                                       if cached_s else "none without") +
          f", {el_cached:.3f} s a step on the cached states (objective at the reference parameters, Adam)" +
          f"; the map alone {n_states / el_map:.1f} states/s (finite {bool(torch.isfinite(e_new).all())}); launches in "
          f"the run {fit_launches}, a step K4 {fit_launches['K4'] / len(outs):.1f}, K5 {fit_launches['K5'] / len(outs):.1f}; "
          f"eps_stack_base {float(params['eps_stack_base']):.6g} -> {float(final.opt_params['eps_stack_base']):.6g}; "
          f"finite={finite} overflow={overflow} on {smi}")
    if not (finite and moved and not overflow and bool(torch.isfinite(e_new).all())):
        raise SystemExit("the dna1 DiffTRe fit gave a non-finite loss or gradient, moved no parameter, or overflowed")
    if fit_launches["K4"] < n_states or fit_launches["K5"] < n_states or fit_launches["K1"] < FIT_MD_STEPS // 40:
        raise SystemExit(f"the dna1 DiffTRe fit did not run through the dna1 kernels: {fit_launches}")
    _lap("16b dna1 DiffTRe fit")

    # 16c. the example's own shape: its main() on a 40-bp duplex read from
    # oxDNA files (the pair list, no kernel), the first step card vs CPU
    top_f, body_f = synthetic_duplex(SMALL_BP, dtype=torch.float64, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        top_path, conf_path = io_top.to_oxdna_files(Path(tmp), top_f, body_f, new_format=True)
        argv = [str(top_path), str(conf_path), "--sim-steps", str(EXAMPLE_MD), "--save-every", str(EXAMPLE_SAVE),
                "--n-eq-states", str(EXAMPLE_EQ), "--opt-steps", str(EXAMPLE_OPT)]
        ex_outs = []
        t0 = time.perf_counter()
        fit_example.main(argv + ["--device", str(dev)],
                         callback=lambda optimizer_output, step: (ex_outs.append(optimizer_output), (None, True))[1])
        torch.cuda.synchronize()
        el_ex = time.perf_counter() - t0
        cpu_opt, params_cpu = fit_example.build_fit(fit_example.parse_args(argv + ["--device", "cpu"]))
    first = ex_outs[0]
    name = cpu_opt.simulator.exposes()[0]
    traj_g = first.state.observables[name]
    traj_c = traj_g.replace(center=traj_g.center.cpu(), orientation=traj_g.orientation.cpu(),
                            temperature=traj_g.temperature.cpu())
    ref = cpu_opt.objective.calculate({name: traj_c}, opt_params=params_cpu)
    obs_g = first.observables["propeller"]
    loss_ok = abs(float(obs_g["loss"]) - float(ref.observables["loss"])) <= 1e-4 * abs(float(ref.observables["loss"])) + 1e-5
    g_scale = max(float(g.abs().max()) for g in ref.grads.values())
    g_err = max(float((first.grads[k].cpu() - g).abs().max()) for k, g in ref.grads.items())
    grads_ok = all(_within(first.grads[k].cpu(), g, rtol=1e-4, atol=1e-5 * g_scale)[0] for k, g in ref.grads.items())
    print(f"[16c example] examples/difftre_propeller_fit.py main() on the card: {SMALL_BP} bp from oxDNA files (new "
          f"format), {EXAMPLE_MD} MD steps on the pair list, {EXAMPLE_OPT} Adam steps: {el_ex:.3f} s; step 0 loss card "
          f"{float(obs_g['loss']):.8g} CPU {float(ref.observables['loss']):.8g}, n_eff {float(obs_g['neff']):.6g}; "
          f"max|grad card - CPU| {g_err:.3e} (max|grad| {g_scale:.3e}; rtol 1e-4, atol 1e-5 max|grad|)")
    if not (ref.is_ready and loss_ok and grads_ok):
        raise SystemExit("the example's first step on the card disagrees with the CPU")
    _lap("16c the example's shape")

    # 16d. the native parser on the fit's 10k-nt, 50-state trajectory
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "traj.dat"
        traj.to_file(path)
        n = topology.n_nucleotides
        t0 = time.perf_counter()
        got = native.parse_trajectory(path, n)
        el_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = io_traj.parse_numpy(path, n)
        el_numpy = time.perf_counter() - t0
        read = io_traj.from_file(path, topology.strand_counts, is_5p_3p=False)
        size = path.stat().st_size
    same = got is not None and all(np.array_equal(a, np.asarray(b)) for a, b in zip(got, plain, strict=True))
    print(f"[16d native parser] {len(read.states)} states x {n} nt ({size / 2**20:.1f} MiB): native {el_native:.3f} "
          f"s, numpy {el_numpy:.3f} s; equal {same}; library {native.library_path()}")
    if not same or len(read.states) != FIT_MD_STEPS // FIT_SAVE:
        raise SystemExit("the native parser's trajectory differs from the numpy parser's, or it is unavailable")
    _lap("16 dna1 DiffTRe")
    src = "mythos_tpu_torch/ops/csrc/tiles.cu"
    return [
        {"name": f"{k} {cname} (dna1)", "route": "cuda", "source": src, "replaces": repl,
         "launches": fit_launches[k], "max_abs_err": rec[k]["err"], "ms": rec[k]["ms"], "plain_ms": rec[k]["plain_ms"],
         "bound_ms": rec[k]["bound"][0], "bound_by": rec[k]["bound"][1], "library_ms": None}
        for k, cname, repl in (("K4", "tile_energies", "mythos_tpu/ops/oxdna_tiles.py:1079"),
                               ("K5", "tile_row_grads", "mythos_tpu/ops/oxdna_tiles.py:1094"))
    ]


def _pseq_energy(model: str, topology, dev, seed: int | None = None):
    """The default oxDNA1, oxDNA2 or oxRNA2 energy of ``topology`` (a duplex) under a
    probabilistic sequence, with ``from_bps`` over all its base pairs (i,
    n - 1 - i): ``bp_pseq`` drawn with numpy from ``seed``, or with ``seed``
    None the one-hot pseq of the duplex's own sequence. (energy, (up_pseq,
    bp_pseq))."""
    import importlib

    import numpy as np
    import torch

    from mythos_tpu_torch.io import sequence_constraints as seqc

    n = topology.n_nucleotides
    sc = seqc.from_bps(n, np.array([[i, n - 1 - i] for i in range(n // 2)]))
    if seed is None:
        up, bp = seqc.dseq_to_pseq(np.asarray(topology.seq), sc)
    else:
        bp = np.random.default_rng(seed).random((sc.n_bp, 4))
        up, bp = np.zeros((0, 4)), bp / bp.sum(1, keepdims=True)
    pseq = tuple(torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (up, bp))
    pkg = importlib.import_module(f"mythos_tpu_torch.energy.{model}")
    return pkg.create_default_energy_fn(topology, device=dev).with_params(pseq=pseq, pseq_constraints=sc), pseq


def _pseq(dev, smi: str, ptx: dict) -> list[dict]:
    """Phase 17: probabilistic sequences (sequence design) -- the pseq
    instances of K2 (oxDNA1, oxDNA2) and of K3, K4 and K5 (oxDNA1's short
    table, oxDNA2's full table) against their plain versions at 10k nt
    (17a), each on the one-hot pseq against its discrete instance (17b), a
    sequence-design step and the pseq runs of both tiers (17c, this phase's
    main path), and the pseq energy and its gradient card vs CPU at 40 bp
    (17d). The eight pseq records."""
    import importlib

    import torch

    from mythos_tpu_torch.entry import build_sim
    from mythos_tpu_torch.io.synthetic import synthetic_duplex
    from mythos_tpu_torch.losses import ObservableLossFn, SquaredError
    from mythos_tpu_torch.observables import PropellerTwist
    from mythos_tpu_torch.ops import stencil as st
    from mythos_tpu_torch.ops import tiles
    from mythos_tpu_torch.optimization import DiffTReObjective
    from mythos_tpu_torch.optimization.objective import compute_loss
    from mythos_tpu_torch.rigid_body import RigidBody
    from mythos_tpu_torch.simulators.io import SimulatorTrajectory
    from mythos_tpu_torch.simulators.neighbors import block_neighbor_list_for_topology, strand_interleave_perm
    from mythos_tpu_torch.soa import to_soa

    topology, body = synthetic_duplex(N_BP, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(41)
    q = body.orientation + 0.01 * torch.randn(body.orientation.shape, generator=gen, device=dev)
    jb = RigidBody(body.center + 0.01 * torch.randn(body.center.shape, generator=gen, device=dev),
                   q / q.norm(dim=-1, keepdim=True))
    pkgs = {m: importlib.import_module(f"mythos_tpu_torch.energy.{m}") for m in ("dna1", "dna2")}
    rec, setups = {}, {}
    tile_names = {"K3": "tile_forces", "K4": "tile_energies", "K5": "tile_row_grads"}
    for model, pkg in pkgs.items():
        e, _ = _pseq_energy(model, topology, dev, seed=PSEQ_SEED)
        e0, sim = build_sim(topology, KT, model=model, init_centers=body.center, init_orientation=body.orientation,
                            device=dev)
        ctx = st.prepare_stencil_context(e, sim.band, device=dev)
        dyn = torch.cat([ctx.to_slots(jb.center.T), ctx.to_slots(jb.orientation.T)]).contiguous()
        nbl = block_neighbor_list_for_topology(topology, pkg.default_neighbor_cutoff(), block_size=8,
                                               init_centers=jb.center, perm=strand_interleave_perm(topology))
        setups[model] = (e0, sim, dyn, nbl)
        # 17a. K2's pseq instance, then K3, K4 and K5's on the block table
        k2r = _k2_held(f"17a K2 {model} pseq", ctx, dyn, ptx, pkg.per_term_site_cutoffs())
        rec[f"K2 {model}"] = dict(err=k2r["err"], ms=statistics.median(k2r["ms"]),
                                  plain_ms=statistics.median(k2r["plain_ms"]), bound=k2r["bound"])
        (tctx,) = tiles.prepare_contexts(e, nbl.idx, nbl.block_size, perm=nbl.perm)
        sp, P, ids = tctx.spec, tctx.params, tiles.pad_ids(tctx.spec, nbl.idx)
        rows = tiles.dynamic_rows(tctx, to_soa(jb)).contiguous()
        rows64, P64 = rows.double(), P.double()
        full, tri, short, hb, debye, ulps, _ = _pair_geometry(tctx, ids, rows, pkg.per_term_site_cutoffs())
        near = ((ulps <= CLAMP_ULPS) & short & full).any(-1).reshape(-1)
        gt = tiles.term_weights(P, sp) * torch.linspace(0.5, 1.5, len(sp.terms), device=dev)
        print(f"[17a tiles {model} pseq] {sp.n} nt, B={sp.block_size} cap {sp.cap} kind {sp.kind} pseq {sp.pseq} "
              f"overflow={bool(nbl.did_overflow)}; {int(near.sum())} rows near the float32 arccos clamp")
        runs = {
            "K3": (lambda: tiles.tile_forces(rows, P, ids, sp), lambda: tiles.tile_forces_plain(rows, P, ids, sp),
                   lambda: tiles.tile_forces_plain(rows64, P64, ids, sp),
                   lambda: tiles._tile_forces(rows, P, ids, sp, count=True), False),
            "K4": (lambda: tiles.tile_energies(rows, P, ids, sp), lambda: tiles.tile_energies_plain(rows, P, ids, sp),
                   lambda: tiles.tile_energies_plain(rows64, P64, ids, sp),
                   lambda: tiles._tile_energies(rows, P, ids, sp, count=True), True),
            "K5": (lambda: tiles.tile_row_grads(rows, P, ids, gt, sp),
                   lambda: tiles.tile_row_grads_plain(rows, P, ids, gt, sp),
                   lambda: tiles.tile_row_grads_plain(rows64, P64, ids, gt.double(), sp),
                   lambda: tiles._tile_row_grads(rows, P, ids, gt, sp, count=True), False),
        }
        for key, (kern, plain, plain64, counted, triangular) in runs.items():
            k_ms, got = _events_ms(kern, 20)
            p_ms, ref = _events_ms(plain, 3)
            ok, rule, err = _checked(f"17a {key} {model} pseq", got, ref, plain64(), near)
            again, counts = counted()
            tally = dict(zip(("short", "debye", "skipped"), counts.tolist(), strict=True))
            gate = tiles.tile_gate_counts(rows, P, ids, sp, triangular=triangular)
            same = torch.equal(got, again)
            tally_ok = sum(abs(tally[k] - gate[k]) for k in gate) <= 1e-4 * sum(gate.values())
            dev_ms = _kernels_ms(_profiled(kern, 10), "tile_")
            regs, spill = ptx.get(_instance_key(tile_names[key], model, True), (0, -1))
            print(f"[17a {key} {model} pseq] {tuple(got.shape)} err {err:.2e} ({rule}) ok={ok}; "
                  f"{statistics.median(k_ms):.4f} ms by events, {_dev(dev_ms)} of device time a call, plain "
                  f"{statistics.median(p_ms):.2f} ms; {regs} registers, {spill} B spill stores (the discrete "
                  f"instance's: {ptx.get(_instance_key(tile_names[key], model), (0, -1))}); the pairs a call: kernel "
                  f"{tally}, plain gate {gate}; equal bits on a second call: {same}")
            if not (ok and same and tally_ok):
                raise SystemExit(f"{key}'s {model} pseq instance disagrees with its plain version or gate, or is not "
                                 "deterministic")
            rec[f"{key} {model}"] = dict(err=err, ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                                         dev_ms=dev_ms)
        n_short, n_hb, n_debye = (int((m & tri).sum()) for m in (short, hb, debye))
        in_bytes = sp.n_pad * sp.n_fields * 4 + sp.n_blocks * sp.cap * 4 + 4 * st.param_offsets()["TOTAL"]
        rec[f"K3 {model}"]["bound"] = _bound(in_bytes + sp.n_pad * 12 * 4,
                                             n_short * FLOP_PAIR_GRAD + n_debye * FLOP_DEBYE_GRAD)
        rec[f"K4 {model}"]["bound"] = _bound(in_bytes + 5 * 4,
                                             n_short * FLOP_PAIR_ENERGY + n_debye * FLOP_DEBYE_ENERGY)
        # K5 under pseq: 21 fields, and the role-swapped hb product on each pair in the hb reach
        rec[f"K5 {model}"]["bound"] = _bound(in_bytes + sp.n_pad * 21 * 4, n_short * FLOP_PAIR_GRAD
                                             + 2 * n_hb * FLOP_PAIR_HB + n_debye * FLOP_DEBYE_GRAD)
        print(f"[17a bounds {model}] {int(tri.sum())} unordered pairs, {n_short} inside the short-range reach "
              f"({n_hb} the hb reach), {n_debye} Debye only: " + "; ".join(
                  f"{k} {rec[f'{k} {model}']['bound'][0]:.5f} ms ({rec[f'{k} {model}']['bound'][1]}; "
                  f"{_share(rec[f'{k} {model}']['bound'][0], rec[f'{k} {model}']['dev_ms'])} of its device time)"
                  for k in ("K3", "K4", "K5")))
    _lap("17a pseq kernels")

    # 17b. on the one-hot pseq of the duplex's sequence, each pseq instance
    # against the discrete one (K2's tolerance)
    errs = {}
    for model, (e0, sim, dyn, nbl) in setups.items():
        e1, _ = _pseq_energy(model, topology, dev)
        ctx0 = st.prepare_stencil_context(e0, sim.band, device=dev)
        ctx1 = st.prepare_stencil_context(e1, sim.band, device=dev)
        outs = {"K2": (st.field_grads(ctx1, dyn), st.field_grads(ctx0, dyn))}
        pair = []
        for energy in (e1, e0):
            (tc,) = tiles.prepare_contexts(energy, nbl.idx, nbl.block_size, perm=nbl.perm)
            r, ids = tiles.dynamic_rows(tc, to_soa(jb)).contiguous(), tiles.pad_ids(tc.spec, nbl.idx)
            g = tiles.term_weights(tc.params, tc.spec)
            pair.append((tiles.tile_forces(r, tc.params, ids, tc.spec), tiles.tile_energies(r, tc.params, ids, tc.spec),
                         tiles.tile_row_grads(r, tc.params, ids, g, tc.spec)[:, :16]))
        outs.update({k: v for k, v in zip(("K3", "K4", "K5"), zip(*pair, strict=True), strict=True)})
        for key, (one, discrete) in outs.items():
            ok, err = _within(one, discrete, rtol=1e-4, atol=1e-4 * float(discrete.abs().max()))
            errs[f"{key} {model}"] = err
            if not ok:
                raise SystemExit(f"{key}'s {model} pseq instance on the one-hot pseq is off the discrete instance")
    print("[17b one-hot pseq vs discrete] max|pseq instance - discrete| (K2's tolerance met): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    _lap("17b one-hot")

    # 17c. the main path of this phase: a sequence-design step at 10k nt under
    # oxDNA1 -- PSEQ_MD_STEPS on the stencil's per-step branch (K2's pseq
    # instance; K1 refuses a pseq), the propeller-twist DiffTRe loss over the
    # saved states on a B = 8 table (K4, backward K5) and d loss / d bp_pseq
    # -- then oxDNA2's step at PSEQ_SHORT_STEPS, and both block tiers under
    # the pseq (K3), every pseq instance counted from 0
    bps = torch.tensor([[i, 2 * N_BP - 1 - i] for i in range(N_BP)], dtype=torch.int32, device=dev)
    for fn in (st.field_grads, st.multistep_chunk, tiles.tile_forces, tiles.tile_energies, tiles.tile_row_grads):
        fn.by_family = dict.fromkeys(fn.by_family, 0)
    design = {}
    for model, pkg in pkgs.items():
        n_md, save = (PSEQ_MD_STEPS, PSEQ_SAVE) if model == "dna1" else (PSEQ_SHORT_STEPS, PSEQ_SHORT_SAVE)
        e, (up, bp) = _pseq_energy(model, topology, dev, seed=PSEQ_SEED)
        _, sim = setups[model][0], setups[model][1]
        sim = sim.replace(energy_fn=e, save_every=save, neighbor_update_every=save)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj = sim.run(e.opt_params(), body, n_md, torch.Generator(device=dev).manual_seed(42)).observables[0]
        torch.cuda.synchronize()
        el_md = time.perf_counter() - t0
        finite = bool(torch.isfinite(traj.center).all() and torch.isfinite(traj.orientation).all())
        overflow = bool(traj.metadata["neighbor_overflow"].any())
        map_nbl = block_neighbor_list_for_topology(topology, pkg.default_neighbor_cutoff(), block_size=8,
                                                   init_centers=body.center, perm=strand_interleave_perm(topology))
        obs = ObservableLossFn(observable=PropellerTwist(rigid_body_transform_fn=pkg.default_transform_soa_fn(),
                                                         h_bonded_base_pairs=bps),
                               loss_fn=SquaredError(), return_observable=True)

        def loss_fn(ref_states, weights, *_, obs=obs):
            loss, measured = obs(ref_states, 21.7, weights)
            return loss, (("propeller_twist", measured), None)

        leaves = (up.clone().requires_grad_(True), bp.clone().requires_grad_(True))
        states = RigidBody(traj.center, traj.orientation)
        mapped = e.replace(map_neighbors=map_nbl)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, (n_eff, _, _) = compute_loss({"pseq": leaves}, mapped, 1.0 / KT, loss_fn, states, None, [])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        (g_bp,) = torch.autograd.grad(loss, leaves[1])
        torch.cuda.synchronize()
        el_map, el_bwd = t2 - t1, time.perf_counter() - t2
        objective = DiffTReObjective(name="design", required_observables=("traj",), grad_or_loss_fn=loss_fn,
                                     energy_fn=mapped)
        out = objective.calculate({"traj": SimulatorTrajectory(center=traj.center, orientation=traj.orientation,
                                                              temperature=traj.temperature)},
                                  opt_params={"pseq": (up, bp)})
        # the objective's beta is the trajectory's float32 1 / kT a state: float32 apart
        ok_obj = out.is_ready and _within(out.grads["pseq"][1], g_bp, rtol=1e-4, atol=1e-5 * float(g_bp.abs().max()))[0]
        g_max = float(g_bp.abs().max())
        print(f"[17c design {model}] {n_md} pseq MD steps at {topology.n_nucleotides} nt (the per-step branch, a state "
              f"every {save}): {el_md:.3f} s = {n_md / el_md * 60.0:.1f} steps/min on {smi}; states "
              f"{tuple(traj.center.shape)} finite={finite} overflow={overflow}; map of {traj.center.shape[0]} states "
              f"+ loss {el_map:.3f} s, backward {el_bwd:.3f} s; loss {float(loss.detach()):.6g} n_eff {float(n_eff):.6g} "
              f"max|d loss / d bp_pseq| {g_max:.4g} finite={bool(torch.isfinite(g_bp).all())}; DiffTReObjective's "
              f"gradient the same (rtol 1e-4, atol 1e-5 max): {ok_obj}")
        if not (finite and not overflow and bool(torch.isfinite(g_bp).all()) and g_max > 0 and ok_obj):
            raise SystemExit(f"the {model} sequence-design step gave a bad trajectory, overflowed, or a non-finite, "
                             "zero or inconsistent sequence gradient")
        design[model] = (el_md, el_map, el_bwd)
    for model in pkgs:
        e, _ = _pseq_energy(model, topology, dev, seed=PSEQ_SEED)
        _, sim_b = build_sim(topology, KT, mode="block", model=model, init_centers=body.center, device=dev)
        sim_b = sim_b.replace(energy_fn=e, save_every=PSEQ_SHORT_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = sim_b.run(e.opt_params(), body, PSEQ_SHORT_STEPS, torch.Generator(device=dev).manual_seed(43))
        torch.cuda.synchronize()
        el_b = time.perf_counter() - t0
        tr = tr.observables[0]
        ok_b = bool(torch.isfinite(tr.center).all()) and not bool(tr.metadata["neighbor_overflow"].any())
        print(f"[17c block {model} pseq] {PSEQ_SHORT_STEPS} steps at {topology.n_nucleotides} nt: {el_b:.3f} s = "
              f"{PSEQ_SHORT_STEPS / el_b * 60.0:.1f} steps/min; finite, no overflow: {ok_b}")
        if not ok_b:
            raise SystemExit(f"the {model} block tier under a pseq produced a bad trajectory")
    launches = {f"{k} {m}": fn.by_family[f"{m}_pseq"] for m in pkgs
                for k, fn in (("K2", st.field_grads), ("K3", tiles.tile_forces), ("K4", tiles.tile_energies),
                              ("K5", tiles.tile_row_grads))}
    print(f"[17c launches] the pseq instances in the design steps and block runs: {launches}; K1 "
          f"{sum(st.multistep_chunk.by_family.values())} (it refuses a pseq)")
    if min(launches.values()) < 1 or sum(st.multistep_chunk.by_family.values()):
        raise SystemExit(f"the pseq path did not run through every pseq instance, or ran K1: {launches}")
    if launches["K2 dna1"] != PSEQ_MD_STEPS + 1:
        raise SystemExit(f"the dna1 design step launched K2's pseq instance {launches['K2 dna1']} times")
    _lap("17c sequence design")

    # 17d. card vs CPU at 40 bp: the pseq energy on the tile map and d E / d bp_pseq
    def energy_grad(model, device):
        top40, b40 = synthetic_duplex(40, dtype=torch.float32, device="cpu")
        g40 = torch.Generator().manual_seed(44)
        q40 = b40.orientation + 0.01 * torch.randn(b40.orientation.shape, generator=g40)
        b40 = RigidBody((b40.center + 0.01 * torch.randn(b40.center.shape, generator=g40)).to(device),
                        (q40 / q40.norm(dim=-1, keepdim=True)).to(device))
        e40, (up40, bp40) = _pseq_energy(model, top40, device, seed=PSEQ_SEED)
        leaf = bp40.clone().requires_grad_(True)
        e40 = e40.with_params(pseq=(up40, leaf))
        nbl40 = block_neighbor_list_for_topology(top40, pkgs[model].default_neighbor_cutoff(), block_size=8,
                                                 init_centers=b40.center, perm=strand_interleave_perm(top40))
        ctxs = tiles.prepare_contexts(e40, nbl40.idx, nbl40.block_size, perm=nbl40.perm)
        energy = tiles.fused_energy_ctx(e40, ctxs, to_soa(b40), nbl40.idx)
        (g,) = torch.autograd.grad(energy, leaf)
        return energy.item(), g.cpu()

    for model in pkgs:
        (e_gpu, g_gpu), (e_cpu, g_cpu) = energy_grad(model, dev), energy_grad(model, "cpu")
        ok_e = abs(e_gpu - e_cpu) <= 1e-4 * abs(e_cpu) + 1e-5
        ok_g, err_g = _within(g_gpu, g_cpu, rtol=1e-4, atol=1e-5 * float(g_cpu.abs().max()))
        print(f"[17d card vs CPU {model}] 40 bp pseq energy card {e_gpu:.8g} CPU {e_cpu:.8g}; max|d E / d bp_pseq "
              f"card - CPU| {err_g:.3e} (max {float(g_cpu.abs().max()):.3e}; rtol 1e-4, atol 1e-5 max|grad|)")
        if not (ok_e and ok_g):
            raise SystemExit(f"the card's {model} pseq energy or its sequence gradient disagrees with the CPU")
    _lap("17 pseq")
    src = "mythos_tpu_torch/ops/csrc/"
    meta = {"K2": ("field_grads", "stencil_grads.cu", "mythos_tpu/ops/stencil.py:1420"),
            "K3": ("tile_forces", "tiles.cu", "mythos_tpu/ops/oxdna_tiles.py:1094"),
            "K4": ("tile_energies", "tiles.cu", "mythos_tpu/ops/oxdna_tiles.py:1079"),
            "K5": ("tile_row_grads", "tiles.cu", "mythos_tpu/ops/oxdna_tiles.py:1094")}
    return [
        {"name": f"{k} {meta[k][0]} ({m} pseq)", "route": "cuda", "source": src + meta[k][1], "replaces": meta[k][2],
         "launches": launches[f"{k} {m}"], "max_abs_err": rec[f"{k} {m}"]["err"], "ms": rec[f"{k} {m}"]["ms"],
         "plain_ms": rec[f"{k} {m}"]["plain_ms"], "bound_ms": rec[f"{k} {m}"]["bound"][0],
         "bound_by": rec[f"{k} {m}"]["bound"][1], "library_ms": None}
        for m in pkgs for k in ("K2", "K3", "K4", "K5")
    ]


def _na1_energy(topology, dev, dtype=None):
    """The oxNA hybrid composed as the reference's tests compose it (the
    package's recipe: each term's merged default table, the topology's
    nucleotide types, kT, salt 0.5, half-charged ends), and the COM cutoff
    of its tables: every unbonded term's site cutoff plus twice the largest
    site offset of either geometry."""
    import torch

    import mythos_tpu_torch.energy.dna2 as dna2
    import mythos_tpu_torch.energy.na1 as na1
    import mythos_tpu_torch.energy.rna2 as rna2
    from mythos_tpu_torch.energy.base import ComposedEnergyFunction, params_from_numpy

    _, params = na1.default_configs()
    shared = {"stacking": {"kt": KT}, "debye": {"kt": KT, "salt_conc": 0.5}}
    fns = []
    for key, cls, cfg_cls in na1.TERMS:
        values = params_from_numpy(params[key] | shared.get(key, {}), dev, dtype or torch.float32)
        extra = {"half_charged_ends": True} if key == "debye" else {}
        cfg = cfg_cls(**values, nt_type=topology.nt_type, **extra)
        fns.append(cls(cfg.init_params(), topology, na1.default_transform_soa_fn()))
    energy = ComposedEnergyFunction(fns)
    cut = max(fn.pair_cutoff() for fn in fns if hasattr(fn, "pair_energies"))
    return energy, cut + 2.0 * max(dna2.max_site_offset(), rna2.max_site_offset())


def _hybrid(n_bp: int, dev, dtype=None):
    """A duplex of one DNA strand and one RNA strand: (topology, body)."""
    import numpy as np
    import torch

    from mythos_tpu_torch.io.synthetic import synthetic_duplex
    from mythos_tpu_torch.io.topology import NucleotideType

    topology, body = synthetic_duplex(n_bp, dtype=dtype or torch.float32, device=dev)
    nt = np.array([NucleotideType.DNA] * n_bp + [NucleotideType.RNA] * n_bp, np.int32)
    return dataclasses.replace(topology, nt_type=nt), body


def _rna2_na1(dev, smi: str, ptx: dict) -> list[dict]:
    """Phase 18: the model paths the reference runs on XLA alone -- K2's
    oxRNA2 pseq instance against its plain version and one-hot against
    discrete (18a), the oxRNA2 block tier on the plain block sums (18b),
    an oxRNA2 DiffTRe step through them (18c), the oxNA hybrid on block
    tables and on a FixedCapacityNeighborList (18d), and an oxRNA2
    sequence-design step on the stencil's per-step branch (18e, the main
    path of K2's rna2 pseq instance). Its record."""
    import torch

    import mythos_tpu_torch.energy.rna2 as rna2
    from mythos_tpu_torch.entry import build_sim
    from mythos_tpu_torch.io.synthetic import synthetic_duplex
    from mythos_tpu_torch.losses import ObservableLossFn, SquaredError
    from mythos_tpu_torch.observables import PropellerTwist
    from mythos_tpu_torch.ops import stencil as st
    from mythos_tpu_torch.ops import tiles
    from mythos_tpu_torch.optimization.objective import compute_loss
    from mythos_tpu_torch.rigid_body import RigidBody
    from mythos_tpu_torch.simulators import neighbors as nbs
    from mythos_tpu_torch.simulators.cuda import BlockSimulator, PairSimulator
    from mythos_tpu_torch.soa import to_soa

    topology, body = synthetic_duplex(N_BP, form="A", dtype=torch.float32, device=dev)
    n = topology.n_nucleotides
    gen = torch.Generator(device=dev).manual_seed(18)
    q = body.orientation + 0.01 * torch.randn(body.orientation.shape, generator=gen, device=dev)
    jb = RigidBody(body.center + 0.01 * torch.randn(body.center.shape, generator=gen, device=dev),
                   q / q.norm(dim=-1, keepdim=True))
    bps = torch.tensor([[i, n - 1 - i] for i in range(n // 2)], dtype=torch.int32, device=dev)
    obs = ObservableLossFn(observable=PropellerTwist(rigid_body_transform_fn=rna2.default_transform_soa_fn(),
                                                     h_bonded_base_pairs=bps),
                           loss_fn=SquaredError(), return_observable=True)

    def loss_fn(ref_states, weights, *_):
        loss, measured = obs(ref_states, 21.7, weights)
        return loss, (("propeller_twist", measured), None)

    # 18a. K2's rna2 pseq instance against its plain version (slots off and
    # at the float32 arccos clamp apart), bits, registers, spill; on the
    # one-hot pseq of the duplex's sequence it gives the discrete bits
    e0, sim = build_sim(topology, KT, model="rna2", init_centers=body.center, init_orientation=body.orientation,
                        device=dev)
    e_pseq, (up, bp) = _pseq_energy("rna2", topology, dev, seed=PSEQ_SEED)
    ctx = st.prepare_stencil_context(e_pseq, sim.band, device=dev)
    dyn = torch.cat([ctx.to_slots(jb.center.T), ctx.to_slots(jb.orientation.T)]).contiguous()
    k2r = _k2_held("18a K2 rna2 pseq", ctx, dyn, ptx, rna2.per_term_site_cutoffs())
    e1, _ = _pseq_energy("rna2", topology, dev)
    one = st.field_grads(st.prepare_stencil_context(e1, sim.band, device=dev), dyn)
    discrete = st.field_grads(st.prepare_stencil_context(e0, sim.band, device=dev), dyn)
    same = torch.equal(one, discrete)
    print(f"[18a one-hot vs discrete] K2 rna2 pseq instance on the one-hot pseq: equal bits to the discrete "
          f"instance: {same} (max diff {float((one - discrete).abs().max()):.2e}); registers/spill of the discrete "
          f"instance {ptx.get(_instance_key('stencil_field_grads', 'rna2'), (0, -1))}")
    if not same:
        raise SystemExit("K2's rna2 pseq instance on the one-hot pseq does not give the discrete instance's bits")
    _lap("18a K2 rna2 pseq")

    # 18b. the rna2 block tier: one non-symmetric table, the block sums'
    # autograd as the force -- no K3 -- while dna2's block tier still
    # launches K3
    e_b, sim_b = build_sim(topology, KT, mode="block", model="rna2", init_centers=body.center,
                           neighbor_update_every=RNA2_BLOCK_UPDATE, device=dev)
    sim_b = sim_b.replace(save_every=RNA2_BLOCK_UPDATE)
    nbl = sim_b.neighbors
    k3_before = tiles.tile_forces.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = sim_b.run(e_b.opt_params(), body, RNA2_BLOCK_STEPS, torch.Generator(device=dev).manual_seed(181))
    torch.cuda.synchronize()
    el_b = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    tr = out.observables[0]
    fin_b = bool(torch.isfinite(tr.center).all() and torch.isfinite(tr.orientation).all())
    ovf_b = bool(torch.as_tensor(tr.metadata["neighbor_overflow"]).any())
    grad_fn = sim_b._grad_fn(e_b, False, False)
    w = _profiled(lambda: grad_fn(to_soa(body), nbl.idx), 3)
    k3_rna2 = tiles.tile_forces.launches - k3_before
    top_d, body_d = synthetic_duplex(N_BP, dtype=torch.float32, device=dev)
    e_d, sim_d = build_sim(top_d, KT, mode="block", model="dna2", init_centers=body_d.center, device=dev)
    k3_before = tiles.tile_forces.launches
    sim_d.run(e_d.opt_params(), body_d, 40, torch.Generator(device=dev).manual_seed(182))
    k3_dna2 = tiles.tile_forces.launches - k3_before
    print(f"[18b rna2 block] {RNA2_BLOCK_STEPS} steps at {n} nt, B={nbl.block_size}, one non-symmetric table of "
          f"{nbl.n_blocks} x {nbl.capacity} blocks over the strand interleave (rebuild every "
          f"{sim_b.neighbor_update_every}): {el_b:.3f} s = {RNA2_BLOCK_STEPS / el_b * 60.0:.1f} steps/min on {smi}; "
          f"peak card memory {peak:.2f} GiB; finite={fin_b} overflow={ovf_b}; a force evaluation under "
          f"torch.profiler: {w['launches'] / 3:.0f} kernel launches, {w['device_ms'] / 3:.2f} ms of device time of "
          f"{w['wall_ms'] / 3:.2f} ms wall (idle share {1 - w['device_ms'] / w['wall_ms']:.0%}); K3 launched "
          f"{k3_rna2} times under rna2, {k3_dna2} times in 40 dna2 block steps")
    if not fin_b or ovf_b or k3_rna2 != 0 or k3_dna2 < 40 or sim_b.uses_kernels() or not sim_d.uses_kernels():
        raise SystemExit("the rna2 block tier gave a bad trajectory, overflowed or launched K3, or dna2's did not")
    _lap("18b rna2 block")

    # 18c. an rna2 DiffTRe step: RNA2_DIFFTRE_MD stencil steps (K1 rna2), the
    # saved states mapped through the block sums on a non-symmetric table,
    # the propeller-twist loss and its gradient in every parameter
    k1_before = st.multistep_chunk.by_family["rna2"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = sim.replace(save_every=RNA2_DIFFTRE_SAVE).run(e0.opt_params(), body, RNA2_DIFFTRE_MD,
                                                         torch.Generator(device=dev).manual_seed(183)).observables[0]
    torch.cuda.synchronize()
    el_md = time.perf_counter() - t0
    k1_md = st.multistep_chunk.by_family["rna2"] - k1_before
    map_nbl = nbs.block_neighbor_list_for_topology(topology, rna2.default_neighbor_cutoff(), block_size=8,
                                                   init_centers=traj.center[0], perm=nbs.strand_interleave_perm(topology),
                                                   symmetric=False)
    e_map = rna2.create_default_energy_fn(topology, device=dev, block_unbonded=True, block_size=8).with_props(
        block_ids=map_nbl.idx, block_perm=map_nbl.perm)
    # every state is mapped through this one table: none may have a pair
    # inside the cutoff that it lacks (the block sums cannot flag it)
    ovf_map = torch.zeros((), dtype=torch.bool, device=dev)
    for c in traj.center:
        ovf_map = ovf_map | map_nbl.build(c, prev=map_nbl.idx)[1]
    ovf_map = bool(ovf_map)
    leaves = {k: v.clone().requires_grad_(True) for k, v in e_map.opt_params().items()}
    states = RigidBody(traj.center, traj.orientation)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss, (n_eff, _, energies) = compute_loss(leaves, e_map, 1.0 / KT, loss_fn, states, None, [])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    torch.cuda.synchronize()
    el_map, el_bwd = t2 - t1, time.perf_counter() - t2
    g = torch.stack([x.abs().max() for x in grads if x is not None])
    fin_c = bool(torch.isfinite(energies).all() and torch.isfinite(g).all())
    print(f"[18c rna2 DiffTRe] {RNA2_DIFFTRE_MD} stencil steps at {n} nt ({k1_md} K1 rna2 chunks): {el_md:.3f} s; map of "
          f"{traj.center.shape[0]} states through the block sums ({map_nbl.n_blocks} x {map_nbl.capacity} table) + "
          f"loss {el_map:.3f} s, backward {el_bwd:.3f} s on {smi}; a state's pair missing from the table: {ovf_map}; loss {float(loss.detach()):.6g} n_eff "
          f"{float(n_eff.detach()):.6g}; {len(g)} parameter gradients, max |grad| {float(g.max()):.4g}, finite={fin_c}")
    if not fin_c or ovf_map or float(g.max()) <= 0 or k1_md != RNA2_DIFFTRE_MD // sim.neighbor_update_every:
        raise SystemExit("the rna2 DiffTRe step gave non-finite or zero gradients, mapped a state its table does not "
                         "cover, or did not run K1")
    _lap("18c rna2 DiffTRe")

    # 18d. the oxNA hybrid: a 10k-nt DNA/RNA duplex on the block tier, then a
    # 40-bp one on PairSimulator over a FixedCapacityNeighborList, card vs CPU
    top_h, body_h = _hybrid(N_BP, dev)
    e_h, cut_h = _na1_energy(top_h, dev)
    nbl_h = nbs.block_neighbor_list_for_topology(top_h, cut_h, block_size=8, init_centers=body_h.center,
                                                 perm=nbs.strand_interleave_perm(top_h), symmetric=False)
    sim_h = BlockSimulator(energy_fn=e_h, neighbors=nbl_h, dt=5e-3, kT=KT, gamma_t=KT / 2.5, gamma_r=KT / 7.5,
                           save_every=NA1_BLOCK_UPDATE, neighbor_update_every=NA1_BLOCK_UPDATE)
    k3_before = tiles.tile_forces.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr_h = sim_h.run({}, body_h, NA1_BLOCK_STEPS, torch.Generator(device=dev).manual_seed(184)).observables[0]
    torch.cuda.synchronize()
    el_h = time.perf_counter() - t0
    e_last = e_h(RigidBody(tr_h.center[-1], tr_h.orientation[-1]))
    fin_h = bool(torch.isfinite(tr_h.center).all() and torch.isfinite(e_last))
    ovf_h = bool(torch.as_tensor(tr_h.metadata["neighbor_overflow"]).any())
    print(f"[18d na1 block] {NA1_BLOCK_STEPS} steps of the {top_h.n_nucleotides}-nt DNA/RNA hybrid on one "
          f"non-symmetric table ({nbl_h.n_blocks} x {nbl_h.capacity}, cutoff {cut_h:.3f}): {el_h:.3f} s = "
          f"{NA1_BLOCK_STEPS / el_h * 60.0:.1f} steps/min on {smi}; final energy {float(e_last):.6g} "
          f"({float(e_last) / top_h.n_nucleotides:.4f} a nucleotide), finite={fin_h} overflow={ovf_h}; K3 "
          f"{tiles.tile_forces.launches - k3_before} launches")
    if not fin_h or ovf_h or tiles.tile_forces.launches != k3_before:
        raise SystemExit("the na1 block run gave a bad trajectory or energy, overflowed or launched K3")

    builds = []
    build = nbs.FixedCapacityNeighborList.build

    def counted(self, centers, prev=None):
        builds.append(1)
        return build(self, centers, prev)

    def small(device, kt: float, steps: int, seed: int, update: int):
        top_s, body_s = _hybrid(NA1_SMALL_BP, device)
        e_s, cut_s = _na1_energy(top_s, device)
        fixed = nbs.neighbor_list_for_topology(top_s, cut_s, init_centers=body_s.center)
        sim_s = PairSimulator(energy_fn=e_s, neighbors=fixed, dt=5e-3, kT=kt, gamma_t=kt / 2.5, gamma_r=kt / 7.5,
                              neighbor_update_every=update)
        return sim_s.run({}, body_s, steps, torch.Generator(device=device).manual_seed(seed)).observables[0], fixed

    nbs.FixedCapacityNeighborList.build = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr_s, fixed = small(dev, KT, NA1_SMALL_STEPS, 185, NA1_SMALL_UPDATE)
        torch.cuda.synchronize()
        el_s = time.perf_counter() - t0
    finally:
        nbs.FixedCapacityNeighborList.build = build
    fin_s = bool(torch.isfinite(tr_s.center).all())
    ovf_s = bool(torch.as_tensor(tr_s.metadata["neighbor_overflow"]).any())
    (gpu, _), (cpu, _) = (small(d, 0.0, NA1_CMP_STEPS, 0, NA1_CMP_UPDATE) for d in (dev, "cpu"))
    okc, errc = _within(gpu.center.cpu(), cpu.center, rtol=1e-4, atol=1e-5)
    okq, errq = _within(gpu.orientation.cpu(), cpu.orientation, rtol=1e-4, atol=1e-5)
    print(f"[18d na1 pairs] {NA1_SMALL_STEPS} steps of the {2 * NA1_SMALL_BP}-nt hybrid on a FixedCapacityNeighborList "
          f"of capacity {fixed.capacity} rebuilt every {NA1_SMALL_UPDATE}: {len(builds)} rebuilds, {el_s:.3f} s = "
          f"{NA1_SMALL_STEPS / el_s * 60.0:.1f} steps/min on {smi}; finite={fin_s} overflow={ovf_s}; {NA1_CMP_STEPS} steps at "
          f"kT 0, rebuilt every {NA1_CMP_UPDATE}, card vs CPU: center err {errc:.2e}, quat err {errq:.2e} (rtol 1e-4, atol 1e-5)")
    if not (fin_s and not ovf_s and len(builds) == NA1_SMALL_STEPS // NA1_SMALL_UPDATE and okc and okq):
        raise SystemExit("the na1 pair-list run overflowed, missed rebuilds, or the card disagrees with the CPU")
    _lap("18d na1")

    # 18e. the main path of K2's rna2 pseq instance: an rna2 sequence-design
    # step at 10k nt -- RNA2_PSEQ_STEPS on the stencil's per-step branch (K1
    # refuses a pseq), the saved states mapped through the block sums, and
    # d loss / d bp_pseq -- its launches counted from 0
    st.field_grads.by_family = dict.fromkeys(st.field_grads.by_family, 0)
    st.multistep_chunk.by_family = dict.fromkeys(st.multistep_chunk.by_family, 0)
    sim_p = sim.replace(energy_fn=e_pseq, save_every=RNA2_PSEQ_SAVE, neighbor_update_every=RNA2_PSEQ_SAVE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr_p = sim_p.run(e_pseq.opt_params(), body, RNA2_PSEQ_STEPS, torch.Generator(device=dev).manual_seed(186))
    torch.cuda.synchronize()
    el_p = time.perf_counter() - t0
    launches = st.field_grads.by_family["rna2_pseq"]
    k1_p = sum(st.multistep_chunk.by_family.values())
    tr_p = tr_p.observables[0]
    leaf = bp.clone().requires_grad_(True)
    e_design = e_map.with_params(pseq=(up, leaf), pseq_constraints=e_pseq.energy_fns[2].params.pseq_constraints)
    t1 = time.perf_counter()
    loss_p, (n_eff_p, _, _) = compute_loss({}, e_design, 1.0 / KT, loss_fn, RigidBody(tr_p.center, tr_p.orientation),
                                           None, [])
    (g_bp,) = torch.autograd.grad(loss_p, leaf)
    torch.cuda.synchronize()
    el_d = time.perf_counter() - t1
    fin_p = bool(torch.isfinite(tr_p.center).all() and torch.isfinite(g_bp).all())
    print(f"[18e rna2 design] {RNA2_PSEQ_STEPS} pseq steps at {n} nt on the per-step branch: {el_p:.3f} s = "
          f"{RNA2_PSEQ_STEPS / el_p * 60.0:.1f} steps/min on {smi}; K2 rna2 pseq launches {launches}, K1 {k1_p}; map "
          f"of {tr_p.center.shape[0]} states through the block sums, loss and d loss / d bp_pseq {el_d:.3f} s: loss "
          f"{float(loss_p.detach()):.6g} n_eff {float(n_eff_p):.6g} max|grad| {float(g_bp.abs().max()):.4g} "
          f"finite={fin_p}")
    if not fin_p or launches != RNA2_PSEQ_STEPS + 1 or k1_p or float(g_bp.abs().max()) <= 0:
        raise SystemExit("the rna2 sequence-design step gave non-finite or zero gradients, ran K1, or missed K2's rna2 "
                         "pseq instance")
    _lap("18 rna2 block, rna2 pseq, na1")
    return [{"name": "K2 field_grads (rna2 pseq)", "route": "cuda",
             "source": "mythos_tpu_torch/ops/csrc/stencil_grads.cu", "replaces": "mythos_tpu/ops/stencil.py:1420",
             "launches": launches, "max_abs_err": k2r["err"], "ms": statistics.median(k2r["ms"]),
             "plain_ms": statistics.median(k2r["plain_ms"]), "bound_ms": k2r["bound"][0],
             "bound_by": k2r["bound"][1], "library_ms": None}]

def _against(root: str, ctx, dyn, ou, noise, state, k2, k1) -> None:
    """Build the kernels of the checkout at ``root`` and run its K2 and K1
    (oxDNA2) on phases 3 and 4's inputs: does its K1 give this checkout's
    bits, and its K2 this checkout's values within K2's tolerance (a K2 that
    sums in another order gives other bits)? Its K2 is called through its
    own C signature."""
    import ctypes
    import importlib.util
    from pathlib import Path

    import torch

    from mythos_tpu_torch.ops import _build
    from mythos_tpu_torch.ops import stencil as st

    spec = importlib.util.spec_from_file_location("other_build", Path(root) / "mythos_tpu_torch/ops/_build.py")
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    lib, own = other.load_library(), _build.load_library
    out = torch.empty_like(dyn)
    with_counts = len(other.SIGNATURES["stencil_field_grads"]) == len(_build.SIGNATURES["stencil_field_grads"])
    rc = lib.stencil_field_grads(*st._ctx_args(ctx), st._ptr(dyn), st._ptr(out),
                                 *((ctypes.c_void_p(None),) if with_counts else ()),
                                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    ok2, err2 = _within(out, k2, rtol=1e-4, atol=1e-4 * float(k2.abs().max()))
    _build.load_library = lambda: lib
    try:
        same1 = torch.equal(st.multistep_chunk(ctx, ou, noise, state), k1)
    finally:
        _build.load_library = own
    print(f"[3-4 against {root}] its K2 (rc {rc}) within K2's tolerance of this checkout's: {ok2} (max diff "
          f"{err2:.3e}, equal bits: {torch.equal(out, k2)}); its K1 gives this checkout's bits: {same1}")


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", metavar="DIR", help="a checkout whose K1 and K2 bits phases 3-4 compare")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 2

    import mythos_tpu_torch.energy.dna2 as dna2
    from mythos_tpu_torch.entry import build_sim
    from mythos_tpu_torch.io.synthetic import synthetic_duplex
    from mythos_tpu_torch.observables import PropellerTwist
    from mythos_tpu_torch.ops import _build, tiles
    from mythos_tpu_torch.ops import stencil as st
    from mythos_tpu_torch.optimization.difftre import difftre_loss, difftre_step
    from mythos_tpu_torch.rigid_body import RigidBody
    from mythos_tpu_torch.simulators.neighbors import block_neighbor_list_for_topology, strand_interleave_perm
    from mythos_tpu_torch.soa import to_soa

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
    regs, ptx = _ptxas(lib_path.parent / "build.log")
    print(f"[2 build] {lib_path.name}: nvcc {nvcc_s:.1f} s, total {time.perf_counter() - t0:.1f} s; "
          + " | ".join(regs))
    _lap("1-2 device, build")

    # setup: the 10k-nt duplex, its band and stencil context
    topology, body = synthetic_duplex(N_BP, dtype=torch.float32, device=dev)
    energy_fn, sim = build_sim(
        topology, KT, init_centers=body.center, init_orientation=body.orientation, device=dev
    )
    ctx = st.prepare_stencil_context(energy_fn, sim.band, device=dev)
    n = ctx.n
    dyn = torch.cat([ctx.to_slots(body.center.T), ctx.to_slots(body.orientation.T)]).contiguous()

    # 3. K2 vs twin, its gate, registers and spill
    k2r = _k2_held("3 K2", ctx, dyn, ptx)

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
    k1_det = torch.equal(k1, st.multistep_chunk(ctx, ou, noise, state))
    k1_win = _profiled(lambda: st.multistep_chunk(ctx, ou, noise, state), 3)
    k1_launches = k1_win["launches"] / 3
    k1_dev = _per_call(k1_win, {"k1_step": u, "k1_entry": 1})
    tw1_ms, twin1 = _events_ms(lambda: st.multistep_chunk_plain(ctx, ou, noise, state), 2)
    twin64 = st.multistep_chunk_plain(ctx.astype(torch.float64), ou.double(), noise, state.double())
    err_k = (k1 - twin1).abs().amax(1).double()
    err_32 = (twin1.double() - twin64).abs().amax(1)
    limit = 2 * err_32 + 5e-5 + 2e-4 * twin64.abs().amax(1)
    err1 = float(err_k.max())
    fixed_ok, _ = _within(k1, twin1, rtol=2e-4, atol=5e-5)
    rows = " ".join(f"{r}:{float(a):.1e}/{float(b):.1e}" for r, (a, b) in enumerate(zip(err_k, err_32)))
    print(f"[4 K1] {u} steps at {n} nt: max|K1-twin|={err1:.3e}; rtol 2e-4/atol 5e-5 met: {fixed_ok}; "
          f"kernel {statistics.median(k1_ms):.3f} ms by events, {_dev(k1_dev)} of device time; twin "
          f"{statistics.median(tw1_ms):.3f} ms; {k1_launches:g} kernel "
          f"launches a chunk ({_kernel_list(k1_win)}); two chunks equal: {k1_det}; row:|K1-f32|/|f32-f64| {rows}")
    if not bool((err_k <= limit).all()) or not k1_det:
        raise SystemExit("K1 is outside the float32 error budget of its twin, or not deterministic")

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
    if args.against:
        _against(args.against, ctx, dyn, ou, noise, state, k2r["k2"], k1)
    _lap("3-4 K2, K1")

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
    # where a main-path step's time goes: 10 chunks under the profiler
    w = _profiled(lambda: sim.run(params, body, 10 * u, torch.Generator(device=dev).manual_seed(3)))
    wall_ms, kernel_ms, n_launch = w["wall_ms"], w["device_ms"], w["launches"]
    k1_dev_ms = sum(ms for k, (ms, _) in w["kernels"].items() if "k1_" in k)
    print(f"[5 profile] {10 * u} steps under torch.profiler: wall {wall_ms:.1f} ms, device kernels {kernel_ms:.1f} ms "
          f"(idle share {1 - kernel_ms / wall_ms:.0%}), K1's kernels {k1_dev_ms:.1f} ms "
          f"({k1_dev_ms / wall_ms:.0%} of the wall), {n_launch / (10 * u):.2f} launches per step")

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
    _lap("5 main path")

    # 6. the tile kernels against their plain versions at 10k nt
    def table_sim(bend):
        top, b = synthetic_duplex(N_BP, bend=bend, dtype=torch.float32, device=dev)
        e, s_ = build_sim(top, KT, mode="block", block_size=8, init_centers=b.center, device=dev)
        return top, b, e, s_

    site_cutoffs = dna2.per_term_site_cutoffs()
    tile_rec = {k: {"err": 0.0} for k in ("K3", "K4", "K5")}
    for label, bend in (("ideal", None), ("arc270", math.radians(270))):
        _, b0, e_b, sim_b = table_sim(bend)
        nbl = sim_b.neighbors
        tables = nbl.idx if isinstance(nbl.idx, tuple) else (nbl.idx,)
        jb = to_soa(jittered(b0))
        print(f"[6 tiles] {label}: B={nbl.block_size} caps tight/wide {nbl.capacity_inner}/{nbl.capacity} "
              f"(two-level: {nbl.r_cutoff_inner is not None}) banded={nbl.banded} overflow={bool(nbl.did_overflow)}")
        ctxs = tiles.prepare_contexts(e_b, nbl.idx, nbl.block_size, perm=nbl.perm)
        # every kind the kernels know, on this run's tables: the sizing's
        # own contexts, plus short + debye on the one table when it collapsed
        checks = list(zip(ctxs, tables))
        if len(ctxs) == 1:
            checks += [(tiles.prepare_tile_context(e_b, tables[0], nbl.block_size, kind, nbl.perm),
                        tables[0]) for kind in ("short", "debye")]
        for ci, (tctx, ids) in enumerate(checks):
            sp = tctx.spec
            rows = tiles.dynamic_rows(tctx, jb).contiguous()
            P = tctx.params
            rows64, P64 = rows.double(), P.double()
            gt = tiles.term_weights(P, sp) * torch.linspace(0.5, 1.5, len(sp.terms), device=dev)
            geo = near = None
            if sp.kind != "debye":
                geo = _pair_geometry(tctx, ids, rows, site_cutoffs)
                full, _, short, _, debye, ulps, _ = geo
                near = ((ulps <= CLAMP_ULPS) & short & full).any(-1).reshape(-1)
                # K3's gate (its plain version) against these reaches: the gate
                # reads float32 cutoffs from P, the reaches float64 ones, so a
                # pair within a float32 rounding of a cutoff may fall either side
                gates = tiles.tile_gates_plain(rows64, P64, ids, sp)
                g_short = torch.stack([gates[nm] for nm in sp.terms if nm != "Debye"]).any(0)
                g_debye = gates["Debye"] & ~g_short if "Debye" in gates else torch.zeros_like(g_short)
                n_full = int(full.sum())
                gate_diff = int(((g_short ^ short) & full).sum()) + int(((g_debye ^ debye) & full).sum())
                print(f"  {sp.kind}: {int(near.sum())} of {sp.n} rows have a pair inside the short reach with an "
                      f"angle cosine within {CLAMP_ULPS} float32 ulps of +-1; K3's plain gate and the per-term site "
                      f"cutoffs class {gate_diff} of the {n_full} ordered pairs differently")
                if gate_diff > 1e-5 * n_full:
                    raise SystemExit("K3's gate and dna2.per_term_site_cutoffs disagree on the pairs in reach")
            runs = {
                "K3": (lambda: tiles.tile_forces(rows, P, ids, sp), lambda: tiles.tile_forces_plain(rows, P, ids, sp),
                       lambda: tiles.tile_forces_plain(rows64, P64, ids, sp)),
                "K4": (lambda: tiles.tile_energies(rows, P, ids, sp),
                       lambda: tiles.tile_energies_plain(rows, P, ids, sp),
                       lambda: tiles.tile_energies_plain(rows64, P64, ids, sp)),
                "K5": (lambda: tiles.tile_row_grads(rows, P, ids, gt, sp),
                       lambda: tiles.tile_row_grads_plain(rows, P, ids, gt, sp),
                       lambda: tiles.tile_row_grads_plain(rows64, P64, ids, gt.double(), sp)),
            }
            line, outs = [], {}
            for key, (kern, plain, plain64) in runs.items():
                k_ms, got = _events_ms(kern, 20)
                outs[key] = got
                p_ms, ref = _events_ms(plain, 3)
                ok, rule, err = _checked(key, got, ref, plain64(), near)
                line.append(f"{key} err {err:.2e} ({rule}) {statistics.median(k_ms):.4f}/{statistics.median(p_ms):.2f} ms")
                if rule != "K2 tolerance" and key == "K3" and geo is not None:
                    # name the pair behind the worst element, and show that the
                    # gap follows it: turn the partner's frame 0.01 rad off
                    # alignment; then the same for the worst element off the
                    # clamp rows, and moving the origin to its nucleotide
                    text, (r, k, j), orig = _worst_pair(got, ref, rows, P, ids, sp, geo, nbl.perm)
                    print(f"    K3 worst element: {text}\n      as is: {_gap_at(tctx, ids, jb, r, k)}; with nucleotide "
                          f"{orig(j)} turned 0.01 rad: " + _gap_at(tctx, ids, _turned(jb, orig(j), 0.01), r, k))
                    off = torch.where(near[:, None], ref, got)
                    text, (r, k, j), orig = _worst_pair(off, ref, rows, P, ids, sp, geo, nbl.perm)
                    print(f"    K3 worst element off the clamp rows: {text}\n      as is: {_gap_at(tctx, ids, jb, r, k)}; "
                          f"with the origin moved to nucleotide {orig(r)}: " + _gap_at(tctx, ids, _shifted(jb, orig(r)), r, k))
                if not ok:
                    raise SystemExit(f"{key} disagrees with its plain version ({label}, {sp.kind})")
                rec = tile_rec[key]
                rec["err"] = max(rec["err"], err)
                if label == "ideal" and ci == 0:  # the main path's table
                    rec.update(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms), geo=geo, spec=sp)
            k3 = tiles.tile_forces(rows, P, ids, sp)
            k5 = tiles.tile_row_grads(rows, P, ids, tiles.term_weights(P, sp), sp)[:, : sp.n_force_fields]
            ok35, err35 = _within(k5, k3, rtol=1e-5, atol=5e-6)
            # each kernel's own tally of the pairs it gated (K3 and K5 the
            # ordered pairs of the full mask, K4 the triangular mask's),
            # against the plain gate's (float32 sites, ordered otherwise: a
            # pair within an ulp of a cutoff may fall on either side, so 1e-4
            # of the pairs may differ), and its bits on a second call
            again = {"K3": tiles._tile_forces(rows, P, ids, sp, count=True),
                     "K4": tiles._tile_energies(rows, P, ids, sp, count=True),
                     "K5": tiles._tile_row_grads(rows, P, ids, gt, sp, count=True)}
            tallies, bad = [], []
            for key, (out2, counts) in again.items():
                tally = dict(zip(("short", "debye", "skipped"), counts.tolist(), strict=True))
                gate = tiles.tile_gate_counts(rows, P, ids, sp, triangular=key == "K4")
                same = torch.equal(outs[key], out2)
                tallies.append(f"{key} {tally} (plain gate {gate}), equal bits on a second call: {same}")
                if not same or sum(abs(tally[k] - gate[k]) for k in gate) > 1e-4 * sum(gate.values()):
                    bad.append(key)
                if label == "ideal" and ci == 0:
                    tile_rec[key]["classes"] = tally
            print(f"  {sp.kind} cap {sp.cap}: " + "; ".join(line) + f"; K5 body vs K3 {err35:.1e}; the pairs a call: "
                  + "; ".join(tallies))
            if not ok35:
                raise SystemExit("K5's body fields disagree with K3")
            if bad:
                raise SystemExit(f"{bad} not deterministic, or their gate disagrees with the plain gate")
            if ci == 0:  # the run's own table: each kernel's device time a call
                for key, (kern, _, _) in runs.items():
                    win = _profiled(kern, 10)
                    # the tile kernels only (K5's wrapper also copies the cotangent into the
                    # parameters); 0 (printed "not measured") where the profiler recorded none
                    tile_rec[key][f"dev_ms {label}"] = _kernels_ms(win, "tile_")
                    tile_rec[key][f"kernels {label}"] = _kernel_list(win)

    # bounds from the work each unordered pair of the jittered ideal duplex
    # needs: all short-range terms inside their reach, Debye alone inside its
    # reach, nothing beyond (K3/K5 evaluate the full mask, each pair twice,
    # but one evaluation gives both bodies' gradients; K1/K2 evaluate the
    # band, whose slot reach covers the same pairs and more)
    sp0, (_, tri0, short0, hb0, debye0, _, _) = tile_rec["K3"]["spec"], tile_rec["K3"]["geo"]
    n_short, n_hb, n_debye = (int((m & tri0).sum()) for m in (short0, hb0, debye0))
    in_bytes = sp0.n_pad * sp0.n_fields * 4 + sp0.n_blocks * sp0.cap * 4 + 4 * st.param_offsets()["TOTAL"]
    tile_rec["K3"]["bound"] = _bound(in_bytes + sp0.n_pad * 12 * 4, n_short * FLOP_PAIR_GRAD + n_debye * FLOP_DEBYE_GRAD)
    tile_rec["K4"]["bound"] = _bound(in_bytes + 5 * 4, n_short * FLOP_PAIR_ENERGY + n_debye * FLOP_DEBYE_ENERGY)
    tile_rec["K5"]["bound"] = _bound(
        in_bytes + sp0.n_pad * 16 * 4, n_short * FLOP_PAIR_GRAD + n_hb * FLOP_PAIR_HB + n_debye * FLOP_DEBYE_GRAD
    )
    print(f"[6 tiles] main-path table ({sp0.kind}, cap {sp0.cap}): {int(tri0.sum())} unordered pairs, {n_short} inside "
          f"the short-range reach ({n_hb} of them the hb reach), {n_debye} Debye only; the kernels gate the pairs a call "
          f"into K3 {tile_rec['K3']['classes']}, K4 {tile_rec['K4']['classes']}, K5 {tile_rec['K5']['classes']}; "
          + "; ".join(f"{k}: {v['ms']:.4f} ms by events, {_dev(v['dev_ms ideal'])} of device time a call (the arc's "
                      f"{_dev(v['dev_ms arc270'])}; kernels {v['kernels ideal']}), bound {v['bound'][0]:.5f} ms "
                      f"({v['bound'][1]}): {_share(v['bound'][0], v['ms'])} by events, "
                      f"{_share(v['bound'][0], v['dev_ms ideal'])} by device time" for k, v in tile_rec.items()))
    k1_bound = _bound(
        (19 + 20) * n * 4 + u * 6 * n * 2,
        u * (n_short * FLOP_PAIR_GRAD + n_debye * FLOP_DEBYE_GRAD + (n - 2) * FLOP_BOND_GRAD + n * FLOP_BODY_STEP),
    )
    print(f"[6 bounds] K1 {k1_bound[0]:.4f} ms ({k1_bound[1]})")
    _lap("6 tiles")

    # 7. the block tier on the 270-degree arc: warm-up run, then the counted, timed run
    top_a, body_a, e_a, sim_a = table_sim(math.radians(270))
    n_tables = 2 if sim_a.neighbors.r_cutoff_inner is not None else 1
    sim_a.run(e_a.opt_params(), body_a, sim_a.save_every, torch.Generator(device=dev).manual_seed(4))
    tiles.tile_forces.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_a = sim_a.run(e_a.opt_params(), body_a, BLOCK_STEPS, torch.Generator(device=dev).manual_seed(5))
    torch.cuda.synchronize()
    el_a = time.perf_counter() - t0
    k3_launches = tiles.tile_forces.launches
    tr_a = out_a.observables[0]
    fin_a = bool(torch.isfinite(tr_a.center).all() and torch.isfinite(tr_a.orientation).all())
    qdev_a = float((tr_a.orientation.norm(dim=-1) - 1.0).abs().max())
    ovf_a = bool(tr_a.metadata["neighbor_overflow"].any())
    print(f"[7 block tier] {BLOCK_STEPS} steps at {top_a.n_nucleotides} nt, 270-degree arc, {n_tables} table(s): "
          f"{el_a:.3f} s = {BLOCK_STEPS / el_a * 60.0:.1f} steps/min on {smi}; K3 {k3_launches} launches "
          f"(~{k3_launches * tile_rec['K3']['ms'] / 1e3 / el_a:.0%} of the run at phase 6's K3 time); "
          f"states {tuple(tr_a.center.shape)} finite={fin_a} max||q|-1|={qdev_a:.2e} overflow={ovf_a}")
    if not fin_a or qdev_a > 1e-5 or ovf_a:
        raise SystemExit("block tier produced a bad trajectory")
    if k3_launches < BLOCK_STEPS * n_tables:
        raise SystemExit(f"block tier did not run through K3: {k3_launches} launches")
    # where a block step's time goes: one short rebuild interval under the profiler
    # (its host overhead makes the idle share an upper bound)
    u_a = PROFILE_STEPS
    w = _profiled(lambda: sim_a.replace(save_every=u_a, neighbor_update_every=u_a).run(
        e_a.opt_params(), body_a, u_a, torch.Generator(device=dev).manual_seed(9)))
    print(f"[7 profile] {u_a} steps under torch.profiler: wall {w['wall_ms']:.1f} ms, device kernels "
          f"{w['device_ms']:.1f} ms (idle share {1 - w['device_ms'] / w['wall_ms']:.0%}), "
          f"{w['launches'] / u_a:.0f} launches per step; host top: " + ", ".join(f"{k} {ms:.0f} ms" for k, ms in w["host"]))
    _lap("7 block tier")

    # 8. one DiffTRe step at 10k nt: stencil MD -> tile map -> loss -> grads -> Adam
    map_nbl = block_neighbor_list_for_topology(
        topology, dna2.default_neighbor_cutoff(), block_size=8, init_centers=body.center,
        r_cutoff_inner=dna2.short_range_neighbor_cutoff(), perm=strand_interleave_perm(topology),
    )
    map_tables = 2 if map_nbl.r_cutoff_inner is not None else 1
    n_nt = topology.n_nucleotides
    bps = torch.tensor([[i, n_nt - 1 - i] for i in range(N_BP)], device=dev)
    observable = PropellerTwist(rigid_body_transform_fn=dna2.default_transform_soa_fn(), h_bonded_base_pairs=bps)
    sim_d = sim.replace(save_every=DIFFTRE_SAVE)

    def fresh_params():
        return {k: v.detach().clone().requires_grad_(True) for k, v in energy_fn.opt_params().items()}

    warm = fresh_params()  # warm-up step (first-call costs), then the counted, timed one
    difftre_step(energy_fn, sim_d, map_nbl, observable, 21.7, torch.optim.Adam(warm.values(), lr=1e-3),
                 torch.Generator(device=dev).manual_seed(7), opt_params=warm, init_state=body, n_steps=DIFFTRE_STEPS)
    opt = fresh_params()
    before = {k: v.detach().clone() for k, v in opt.items()}
    for fn in (st.field_grads, st.multistep_chunk, tiles.tile_energies, tiles.tile_row_grads, tiles.tile_forces):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = difftre_step(energy_fn, sim_d, map_nbl, observable, 21.7, torch.optim.Adam(opt.values(), lr=1e-3),
                       torch.Generator(device=dev).manual_seed(6), opt_params=opt, init_state=body,
                       n_steps=DIFFTRE_STEPS)
    torch.cuda.synchronize()
    el_d = time.perf_counter() - t0
    d_launches = {"K1": st.multistep_chunk.launches, "K2": st.field_grads.launches,
                  "K4": tiles.tile_energies.launches, "K5": tiles.tile_row_grads.launches}
    n_states = DIFFTRE_STEPS // DIFFTRE_SAVE
    traj_d = res["trajectory"]
    with torch.no_grad():
        e_map = energy_fn.replace(map_neighbors=map_nbl).with_params(res["params"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        e_map.map(RigidBody(traj_d.center, traj_d.orientation))
        torch.cuda.synchronize()
        el_map = time.perf_counter() - t1
    # the step's pieces on the same trajectory: MD alone, the map's forward
    # through the loss, and the backward (K5 and the parameter gradient)
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sim_d.run({k: v.detach() for k, v in opt.items()}, body, DIFFTRE_STEPS, torch.Generator(device=dev).manual_seed(6))
        torch.cuda.synchronize()
        el_md = time.perf_counter() - t1
    probe = fresh_params()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss_p, _ = difftre_loss(energy_fn, map_nbl, observable, 21.7, probe, RigidBody(traj_d.center, traj_d.orientation), KT)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    loss_p.backward()
    torch.cuda.synchronize()
    el_fwd, el_bwd = t2 - t1, time.perf_counter() - t2
    print(f"[8 difftre pieces] MD {el_md:.3f} s, map + loss forward {el_fwd:.3f} s, backward {el_bwd:.3f} s")
    g_max = max(float(g.abs().max()) for g in res["grads"].values())
    finite_g = all(bool(torch.isfinite(g).all()) for g in res["grads"].values())
    moved = any(not torch.equal(before[k], res["params"][k]) for k in opt)
    print(f"[8 difftre] {DIFFTRE_STEPS} MD steps + {n_states} states x {map_tables} table(s) at {n_nt} nt: "
          f"{el_d:.3f} s per step; map alone {n_states / el_map:.1f} states/s; loss {res['loss'].item():.6g} "
          f"n_eff {res['n_eff'].item():.6g} max|grad| {g_max:.4g} params moved={moved} launches={d_launches} on {smi}")
    if not (bool(torch.isfinite(res["loss"])) and finite_g and moved):
        raise SystemExit("the DiffTRe step gave a non-finite loss or gradient, or moved no parameter")
    if d_launches["K4"] != n_states * map_tables or d_launches["K5"] < 1 or d_launches["K1"] != DIFFTRE_STEPS // u:
        raise SystemExit(f"the DiffTRe step did not run through the kernels: {d_launches}")

    # 8b. a 40-bp DiffTRe loss on fixed states: card (K4, K5) vs CPU plain versions
    gen_c = torch.Generator().manual_seed(8)
    top_s2, body_c = synthetic_duplex(40, dtype=torch.float32, device="cpu")
    cs = body_c.center[None] + 0.01 * torch.randn((3, *body_c.center.shape), generator=gen_c)
    qs = body_c.orientation[None] + 0.01 * torch.randn((3, *body_c.orientation.shape), generator=gen_c)
    qs = qs / qs.norm(dim=-1, keepdim=True)
    n40 = top_s2.n_nucleotides
    bps40 = torch.tensor([[i, n40 - 1 - i] for i in range(40)])

    def small_loss(device):
        e40 = dna2.create_default_energy_fn(top_s2, device=device)
        states = RigidBody(cs.to(device), qs.to(device))
        nbl40 = block_neighbor_list_for_topology(
            top_s2, dna2.default_neighbor_cutoff(), block_size=8, init_centers=states.center[0],
            r_cutoff_inner=dna2.short_range_neighbor_cutoff(), perm=strand_interleave_perm(top_s2),
        )
        p40 = {k: v.detach().clone().requires_grad_(True) for k, v in e40.opt_params().items()}
        obs40 = PropellerTwist(rigid_body_transform_fn=dna2.default_transform_soa_fn(),
                               h_bonded_base_pairs=bps40.to(device))
        loss40, _ = difftre_loss(e40, nbl40, obs40, 21.7, p40, states, KT)
        loss40.backward()
        return loss40.item(), {k: (torch.zeros_like(v) if v.grad is None else v.grad).cpu() for k, v in p40.items()}

    before5 = tiles.tile_row_grads.launches
    (l_gpu, g_gpu), (l_cpu, g_cpu) = small_loss(dev), small_loss("cpu")
    g_scale = max(float(g.abs().max()) for g in g_cpu.values())
    g_err = max(float((g_gpu[k] - g_cpu[k]).abs().max()) for k in g_cpu)
    ok_g = all(bool(((g_gpu[k] - g_cpu[k]).abs() <= 1e-2 * g_cpu[k].abs() + 1e-3 * g_scale).all()) for k in g_cpu)
    ok_l = abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu) + 1e-6
    print(f"[8b difftre small input] 40 bp, 3 fixed states: loss card {l_gpu:.8g} CPU {l_cpu:.8g}; "
          f"max|grad card - CPU| {g_err:.3e} (max|grad| {g_scale:.3e}; rtol 1e-2, atol 1e-3 max|grad|); "
          f"K5 launches {tiles.tile_row_grads.launches - before5}")
    if not (ok_l and ok_g):
        raise SystemExit("the card's DiffTRe loss or gradients disagree with the CPU plain versions")
    _lap("8 DiffTRe")

    # 9. MARTINI: K6, the 10,160-bead NPT main path, and card vs CPU at 104 beads
    k6_records = _martini(dev, smi)

    # 10. the oxRNA2 main path: K2 and K1's rna2 instances, 2000 steps at 10k nt
    rna2_records = _rna2(dev, smi, ptx)

    # 11. the stencil's per-step branch: K2 every step, both families
    per_step = _per_step(dev, smi)
    for rec in rna2_records:
        if rec["launches"] is None:
            rec["launches"] = per_step["rna2"]

    # 12. direct differentiation through the stencil run
    direct = _direct(dev, smi)
    print(f"[12 kernels] a 1,000-nt grad evaluation of {DIRECT_STEPS} steps launched K1 {direct['K1']} times and "
          f"K2 {direct['K2']} (the oxRNA2 one of {DIRECT_RNA2_STEPS} steps K1 {direct['K1 rna2']}); the backward, the "
          f"plain versions, "
          f"took {direct['bwd_ms_chunk']:.1f} ms a chunk on {smi}")

    # 13. direct differentiation through the block tier
    block_direct = _block_direct(dev, smi)
    # 14. direct differentiation through MARTINI NPT
    martini_direct = _martini_direct(dev, smi)
    # 15. oxDNA1: K1, K2 and K3's dna1 instances, the stencil, block and small-system paths
    dna1_records = _dna1(dev, smi, ptx)
    # 16. DiffTRe under oxDNA1: K4 and K5's dna1 instances, the fit, the example, the native parser
    dna1_records += _dna1_difftre(dev, smi, ptx)
    # 17. probabilistic sequences: the pseq instances of K2-K5, one-hot vs discrete, a sequence-design step
    pseq_records = _pseq(dev, smi, ptx)
    # 18. the XLA-only model paths: K2's rna2 pseq instance, the rna2 block tier and DiffTRe, na1
    pseq_records += _rna2_na1(dev, smi, ptx)
    print(f"[13-14 kernels] a 1,000-nt block grad evaluation of {DIRECT_STEPS} steps launched K3 "
          f"{block_direct['K3 fwd']} times "
          f"forward and {block_direct['K3 bwd']} backward (the plain version, {block_direct['bwd_s']:.3f} s); a "
          f"10,160-bead NPT grad evaluation of {MARTINI_DIRECT_STEPS} steps launched K6's forward "
          f"{martini_direct['K6 fwd']} and backward {martini_direct['K6 bwd']} times forward, none backward (the plain "
          f"double backward, {martini_direct['bwd_s']:.3f} s) on {smi}")

    src = "mythos_tpu_torch/ops/csrc/"
    tile_launch = {"K3": k3_launches, "K4": d_launches["K4"], "K5": d_launches["K5"]}
    tile_meta = {
        "K3": ("tile_forces", "mythos_tpu/ops/oxdna_tiles.py:1094"),
        "K4": ("tile_energies", "mythos_tpu/ops/oxdna_tiles.py:1079"),
        "K5": ("tile_row_grads", "mythos_tpu/ops/oxdna_tiles.py:1094"),
    }
    kernels = [
        {"name": "K1 multistep_chunk", "route": "cuda", "source": src + "multistep.cu",
         "replaces": "mythos_tpu/ops/stencil.py:2236", "launches": launches["K1"], "max_abs_err": err1,
         "ms": statistics.median(k1_ms), "plain_ms": statistics.median(tw1_ms), "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "K2 field_grads", "route": "cuda", "source": src + "stencil_grads.cu",
         "replaces": "mythos_tpu/ops/stencil.py:1420", "launches": per_step["dna2"], "max_abs_err": k2r["err"],
         "ms": statistics.median(k2r["ms"]), "plain_ms": statistics.median(k2r["plain_ms"]),
         "bound_ms": k2r["bound"][0], "bound_by": k2r["bound"][1], "library_ms": None},
    ] + rna2_records + [
        {"name": f"{k} {tile_meta[k][0]}", "route": "cuda", "source": src + "tiles.cu", "replaces": tile_meta[k][1],
         "launches": tile_launch[k], "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": None}
        for k, r in tile_rec.items()
    ] + k6_records + dna1_records + pseq_records
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
