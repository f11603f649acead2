// K1: one chunk of n_inner rigid-body BAOAB Langevin steps of the oxDNA2
// stencil (unbonded band + bonded terms at slot offset 2), plus the exact
// in-band site checks at the chunk's entry positions.
//
// Replaces mythos_tpu/ops/stencil.py::_multistep_chunk_l (Pallas body
// _make_multistep_kernel). Plain twin: ops/stencil.py::multistep_chunk_plain.
// The rotor is the exact NO_SQUISH one (sinf/cosf), not the TPU kernel's
// small-angle Taylor rotor, so there is no |h| < 0.5 range limit.
//
// What bounds it on an H100: the force refresh, as in K2 (stencil_grads.cu)
// plus the bonded pairs (~1k flops each, two per slot with the gather): about
// 0.3 GFLOP per step at 10k nt against ~1 MB of state traffic in L2 --
// arithmetic bound. The integrator halves are a few hundred flops per slot.
// At this size each launch also pays a few microseconds of launch latency,
// 2 per step; a CUDA graph or a persistent kernel is a later optimisation.
//
// j-side scatter: none -- gather, as K2: slot t evaluates every pair it
// belongs to (both the (t, t+d) and (t-d, t) orientations, and both bonds
// (t, t+2) and (t-2, t)) and keeps its own share. No atomics; deterministic.
//
// Step barrier: every step needs the drifted positions of all neighbours
// up to w_wide slots away before the force refresh. The chunk is split into
// two kernels per step on one stream: baoa_kernel (B, A, O, A: each slot
// touches only its own rows) and force_b_kernel (force/torque at the new
// positions, then the closing B). Stream order is the grid-wide barrier;
// the host never synchronises inside a chunk. The entry-position check
// kernel runs first and writes row 19.
//
// State: (20, n) f32 rows, updated in place (layout in stencil_physics.cuh);
// 19 x 10k x 4 B = 0.76 MB, resident in the 50 MB L2 across the chunk.
#include <cuda_runtime.h>

#include "stencil_physics.cuh"

__global__ void site_check_kernel(const float* __restrict__ P, const int* __restrict__ partners,
                                  const float* __restrict__ checks, int n_checks, int check_dm, int n,
                                  float* __restrict__ st) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  st[19 * n + t] = slot_violations(t, n, P, st, partners, checks, n_checks, check_dm);
}

__global__ void baoa_kernel(const float* __restrict__ ou, const uint16_t* __restrict__ noise_t, int n,
                            float* __restrict__ st) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  slot_baoa(t, n, ou, noise_t, st);
}

__global__ void force_b_kernel(const float* __restrict__ P, const float* __restrict__ ou,
                               const int* __restrict__ seq, const int* __restrict__ partners,
                               const float* __restrict__ qf, const float* __restrict__ wstack,
                               const float* __restrict__ dirf, int n, int w0, int w1, int w2, int w3, int w_wide,
                               float* st) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int w[4] = {w0, w1, w2, w3};
  slot_force_b(t, n, P, ou, seq, partners, qf, wstack, dirf, w, w_wide, st);
}

extern "C" int multistep_chunk(const float* params, const int* seq, const int* partners, const float* qf, int n,
                               int w0, int w1, int w2, int w3, int w_wide, const float* wstack, const float* dirf,
                               const float* checks, int n_checks, int check_dm, const float* ou,
                               const uint16_t* noise, int n_inner, float* state, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int block = 64;
  int grid = (n + block - 1) / block;
  site_check_kernel<<<grid, block, 0, s>>>(params, partners, checks, n_checks, check_dm, n, state);
  for (int step = 0; step < n_inner; ++step) {
    baoa_kernel<<<grid, block, 0, s>>>(ou, noise + (size_t)step * 6 * n, n, state);
    force_b_kernel<<<grid, block, 0, s>>>(params, ou, seq, partners, qf, wstack, dirf, n, w0, w1, w2, w3, w_wide,
                                          state);
  }
  return (int)cudaGetLastError();
}
