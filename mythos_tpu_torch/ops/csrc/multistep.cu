// K1: one chunk of n_inner rigid-body BAOAB Langevin steps of the oxDNA2,
// oxRNA2 or oxDNA1 stencil (unbonded band + bonded terms at slot offset 2),
// plus the exact in-band site checks at the chunk's entry positions. One
// instance per model family (template parameter kFam; multistep_chunk,
// multistep_chunk_rna2 and multistep_chunk_dna1): each instance compiles
// none of the other families' code.
//
// Replaces mythos_tpu/ops/stencil.py::_multistep_chunk_l (Pallas body
// _make_multistep_kernel). Plain twin: ops/stencil.py::multistep_chunk_plain.
// The rotor is the exact NO_SQUISH one (sinf/cosf), not the TPU kernel's
// small-angle Taylor rotor, so there is no |h| < 0.5 range limit.
//
// What bounds it on an H100: arithmetic. The force refresh evaluates the
// band's unbonded pairs (~1.5k flops each with all five terms, ~45 with
// Debye alone) and two bonded pairs (~1k flops) per slot, every pair from
// both of its slots (gather: no atomics), ~0.1 GFLOP a step at 10k nt
// against ~1 MB of state in L2. The integrator halves are a few hundred
// flops per slot.
//
// Design for the H100 (the first port ran one thread per slot, 157 blocks
// of 64 at 10k nt, ~2.4 warps an SM, and serialised 32 pair evaluations per
// thread: latency-bound at ~100 us a step):
//   * 32 lanes per 16 slots (stencil_physics.cuh, "K1's force refresh"):
//     lane l of warp w holds slot t0 + l % 16 and takes, on its side (i for
//     lanes 0-15, j for 16-31), the offsets d = w + 1, w + 9, ... <= w_wide,
//     so all lanes of a warp share one offset and one set of term branches
//     (short-range lanes never wait on a Debye-only branch of another offset
//     in the same pass); the last warp also takes the lane's bond. At 10k nt
//     that is 625 blocks of 8 warps, 160k threads (16 per slot), and each
//     warp runs at most two short-range passes.
//   * A fixed-order reduction through shared memory (warp 0..7, i-side then
//     j-side, per slot and gradient component): deterministic without atomics.
//   * The parameter vector (210 floats) staged in shared memory per block:
//     every lane of a warp reads the same entry, a broadcast.
//   * One launch per step: the force refresh of step s, its closing half
//     kick, and the B-A-O-A of step s + 1, which touches only the slot's own
//     rows. Positions ping-pong between the state and a second (7, n) buffer
//     (`alt`, allocated by the wrapper): the refresh reads step s's while the
//     same launch writes step s + 1's. The first launch runs the entry site
//     checks (one thread per slot) and step 0's B-A-O-A. So n_inner + 1
//     launches per chunk; the host never synchronises inside a chunk.
//   * The oxRNA2 instance (kFam = FAM_RNA2) has the same layout; its band is
//     wider (w_terms (21, 17, 17, 15), w_wide 25 at 10k nt), so warp 0 takes
//     offsets 1, 9, 17 and 25 and the other warps three, most of them full
//     physics, and its bond is bonded_pair_rna2. 128 registers, 780 B of
//     spill stores (the oxDNA2 instance: 772 B).
//   * The oxDNA1 instance (kFam = FAM_DNA1) has no Debye term, so its
//     w_wide is its widest short-range reach and every warp's offsets are
//     short-range ones; its bond is bonded_pair<FAM_DNA1> (FENE and the
//     stacking's cos phi sites on the one backbone site on a1).
//   * Registers: __launch_bounds__(256, 2) keeps two blocks (16 warps) on an
//     SM, which caps a thread at 128 registers; each lane reads both bodies
//     of a pair anew (L1 hits) rather than keep its own slot's body live.
//     The side is a run-time value of the lane, so the pair functions keep
//     both sides' site gradients and ptxas spills (~0.6 KB of stack). Making
//     it a compile-time constant of each warp (two compiled passes) spilled
//     1.5 KB and ran ~1.5x slower on an H100 80GB HBM3, so it stays.
//
// State: (20, n) f32 rows, updated in place (layout in stencil_physics.cuh);
// 19 x 10k x 4 B = 0.76 MB, resident in the 50 MB L2 across the chunk.
#include <cuda_runtime.h>

#include "stencil_physics.cuh"

// site checks at the entry positions into row 19, then step 0's B-A-O-A
// (noise0 null when the chunk has no steps)
template <int kFam>
__global__ void k1_entry_kernel(const float* __restrict__ P, const int* __restrict__ partners,
                                const float* __restrict__ checks, int n_checks, int check_dm,
                                const float* __restrict__ ou, const uint16_t* __restrict__ noise0, int n,
                                float* __restrict__ st, float* __restrict__ alt) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  st[19 * n + t] = slot_violations<kFam>(t, n, P, st, partners, checks, n_checks, check_dm);
  if (noise0) k1_first_baoa(t, n, ou, noise0, st, alt);
}

// one step: the force refresh at the positions in cur, the closing half
// kick, and the next step's B-A-O-A into nxt (k1_finish)
template <int kFam>
__global__ void __launch_bounds__(K1_WARPS * 32, 2)
    k1_step_kernel(const float* __restrict__ P, const float* __restrict__ ou, const int* __restrict__ seq,
                   const int* __restrict__ partners, const float* __restrict__ qf, const float* __restrict__ wstack,
                   const float* __restrict__ dirf, int n, int w0, int w1, int w2, int w3, int w_wide,
                   const uint16_t* __restrict__ noise_next, const float* __restrict__ cur, float* __restrict__ nxt,
                   float* __restrict__ st) {
  __shared__ float s_P[P_TOTAL];
  __shared__ float s_red[12 * K1_RED];
  __shared__ float s_g[12 * K1_SLOTS];
  for (int k = threadIdx.x; k < P_TOTAL; k += blockDim.x) s_P[k] = P[k];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * K1_SLOTS;
  const int w[4] = {w0, w1, w2, w3};
  Grad g = k1_lane_grad<kFam>(t0 + (lane & 15), lane >= 16, warp, s_P, cur, seq, partners, qf, wstack, dirf, n, w,
                              w_wide);
  k1_store(g, threadIdx.x, s_red);
  __syncthreads();
  if (threadIdx.x < 12 * K1_SLOTS) {
    s_g[threadIdx.x] = k1_reduce(s_red, threadIdx.x / K1_SLOTS, threadIdx.x % K1_SLOTS);
  }
  __syncthreads();
  const int s = threadIdx.x, t = t0 + s;
  if (s < K1_SLOTS && t < n) {
    Grad gs;
    gs.com = v3(s_g[0 * K1_SLOTS + s], s_g[1 * K1_SLOTS + s], s_g[2 * K1_SLOTS + s]);
    gs.a1 = v3(s_g[3 * K1_SLOTS + s], s_g[4 * K1_SLOTS + s], s_g[5 * K1_SLOTS + s]);
    gs.a2 = v3(s_g[6 * K1_SLOTS + s], s_g[7 * K1_SLOTS + s], s_g[8 * K1_SLOTS + s]);
    gs.a3 = v3(s_g[9 * K1_SLOTS + s], s_g[10 * K1_SLOTS + s], s_g[11 * K1_SLOTS + s]);
    k1_finish(t, n, gs, ou, noise_next, cur, nxt, st);
  }
}

// state: (20, n), rows 0-18 in, all 20 out; alt: (7, n) scratch
template <int kFam>
static int launch_chunk(const float* params, const int* seq, const int* partners, const float* qf, int n, int w0,
                        int w1, int w2, int w3, int w_wide, const float* wstack, const float* dirf, const float* checks,
                        int n_checks, int check_dm, const float* ou, const uint16_t* noise, int n_inner, float* state,
                        float* alt, void* stream) {
  if (n < 1 || n_inner < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  k1_entry_kernel<kFam><<<(n + 127) / 128, 128, 0, s>>>(params, partners, checks, n_checks, check_dm, ou,
                                                         n_inner > 0 ? noise : nullptr, n, state, alt);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int grid = (n + K1_SLOTS - 1) / K1_SLOTS;
  for (int step = 0; step < n_inner; ++step) {
    // the positions after step s's B-A-O-A lie in alt for even s, in the state for odd s
    float* cur = step % 2 == 0 ? alt : state;
    float* other = step % 2 == 0 ? state : alt;
    const bool last = step + 1 == n_inner;
    const uint16_t* noise_next = last ? nullptr : noise + (size_t)(step + 1) * 6 * n;
    float* nxt = last ? (cur == state ? nullptr : state) : other;
    k1_step_kernel<kFam><<<grid, K1_WARPS * 32, 0, s>>>(params, ou, seq, partners, qf, wstack, dirf, n, w0, w1, w2,
                                                        w3, w_wide, noise_next, cur, nxt, state);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

extern "C" int multistep_chunk(const float* params, const int* seq, const int* partners, const float* qf, int n,
                               int w0, int w1, int w2, int w3, int w_wide, const float* wstack, const float* dirf,
                               const float* checks, int n_checks, int check_dm, const float* ou,
                               const uint16_t* noise, int n_inner, float* state, float* alt, void* stream) {
  return launch_chunk<FAM_DNA2>(params, seq, partners, qf, n, w0, w1, w2, w3, w_wide, wstack, dirf, checks, n_checks,
                                check_dm, ou, noise, n_inner, state, alt, stream);
}

extern "C" int multistep_chunk_rna2(const float* params, const int* seq, const int* partners, const float* qf, int n,
                                    int w0, int w1, int w2, int w3, int w_wide, const float* wstack, const float* dirf,
                                    const float* checks, int n_checks, int check_dm, const float* ou,
                                    const uint16_t* noise, int n_inner, float* state, float* alt, void* stream) {
  return launch_chunk<FAM_RNA2>(params, seq, partners, qf, n, w0, w1, w2, w3, w_wide, wstack, dirf, checks, n_checks,
                                check_dm, ou, noise, n_inner, state, alt, stream);
}

extern "C" int multistep_chunk_dna1(const float* params, const int* seq, const int* partners, const float* qf, int n,
                                    int w0, int w1, int w2, int w3, int w_wide, const float* wstack, const float* dirf,
                                    const float* checks, int n_checks, int check_dm, const float* ou,
                                    const uint16_t* noise, int n_inner, float* state, float* alt, void* stream) {
  return launch_chunk<FAM_DNA1>(params, seq, partners, qf, n, w0, w1, w2, w3, w_wide, wstack, dirf, checks, n_checks,
                                check_dm, ou, noise, n_inner, state, alt, stream);
}
