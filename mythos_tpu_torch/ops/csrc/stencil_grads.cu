// K2: one unbonded band evaluation of the oxDNA2 or oxRNA2 stencil -- (7, n)
// com + quaternion in, (7, n) dE/dcom + dE/dquat out. One instance per model
// family (template parameter kFam; stencil_field_grads and
// stencil_field_grads_rna2).
//
// Replaces mythos_tpu/ops/stencil.py::_kernel_field_grads (Pallas body
// _make_stencil_kernel). Plain twin: ops/stencil.py::field_grads_plain.
//
// What bounds it on an H100: arithmetic. A slot's pairs reach w_wide
// (16 at 10k nt) offsets on each side, the short-range terms up to 10;
// each full-physics pair costs ~1.5k flops (site geometry, 8 polynomial
// arccos, f1/f2/f3/f4 chains and their hand-written derivatives, an
// estimate from the source), a Debye-only pair ~60. With the gather design
// below every pair is evaluated twice: about 2 x (10 x 1.5k + 6 x 60) x 10k
// = 0.3 GFLOP per call, against 7 x 10k x 4 B = 0.28 MB read (state sits in
// L2) -- ~1000 flops per byte, far above the card's ~20 (fp32 CUDA cores:
// 67 TFLOP/s vs 3.35 TB/s). So the kernel is bound by fp32 instruction
// throughput and by the divergent branches of the piecewise functions,
// not by memory.
//
// j-side scatter: none. The TPU kernel evaluates each pair (i, i+d) once
// and rolls the j-side gradient back onto i+d, which relies on its grid
// running in order. Here blocks run in no order, so each thread gathers:
// slot t evaluates (t, t+d) as the i-side AND (t-d, t) as the j-side and
// keeps its own share. Twice the pair arithmetic, no atomics, and the sum
// order is fixed, so results are deterministic run to run. They differ
// from the twin only by f32 summation order and by hand-written vs
// autograd derivatives: tolerance atol = 1e-4 max|twin|, rtol = 1e-4.
//
// Step barrier: K2 is a single evaluation, so there is none; K1
// (multistep.cu) orders its steps by launch order on one stream.
//
// Layout: one thread per slot, 64 threads a block (10k slots -> 157
// blocks over the 132 SMs); positions and parameters are read from global
// memory / L2.
#include <cuda_runtime.h>

#include "stencil_physics.cuh"

template <int kFam>
__global__ void stencil_field_grads_kernel(const float* __restrict__ P, const int* __restrict__ seq,
                                           const int* __restrict__ partners, const float* __restrict__ qf, int n,
                                           int w0, int w1, int w2, int w3, int w_wide,
                                           const float* __restrict__ dyn, float* __restrict__ out) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int w[4] = {w0, w1, w2, w3};
  Grad g = slot_unbonded_grad<kFam>(t, P, dyn, seq, partners, qf, n, w, w_wide);
  float q[4] = {dyn[3 * n + t], dyn[4 * n + t], dyn[5 * n + t], dyn[6 * n + t]};
  float gq[4];
  frame_vjp(q, g, gq);
  out[t] = g.com.x;
  out[n + t] = g.com.y;
  out[2 * n + t] = g.com.z;
  for (int k = 0; k < 4; ++k) out[(3 + k) * n + t] = gq[k];
}

template <int kFam>
static int launch_field_grads(const float* params, const int* seq, const int* partners, const float* qf, int n,
                              int w0, int w1, int w2, int w3, int w_wide, const float* dyn, float* out, void* stream) {
  const int block = 64;
  int grid = (n + block - 1) / block;
  stencil_field_grads_kernel<kFam><<<grid, block, 0, (cudaStream_t)stream>>>(params, seq, partners, qf, n, w0, w1,
                                                                             w2, w3, w_wide, dyn, out);
  return (int)cudaGetLastError();
}

extern "C" int stencil_field_grads(const float* params, const int* seq, const int* partners, const float* qf,
                                   int n, int w0, int w1, int w2, int w3, int w_wide, const float* dyn, float* out,
                                   void* stream) {
  return launch_field_grads<FAM_DNA2>(params, seq, partners, qf, n, w0, w1, w2, w3, w_wide, dyn, out, stream);
}

extern "C" int stencil_field_grads_rna2(const float* params, const int* seq, const int* partners, const float* qf,
                                        int n, int w0, int w1, int w2, int w3, int w_wide, const float* dyn,
                                        float* out, void* stream) {
  return launch_field_grads<FAM_RNA2>(params, seq, partners, qf, n, w0, w1, w2, w3, w_wide, dyn, out, stream);
}
