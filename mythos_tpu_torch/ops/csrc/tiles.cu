// K3, K4, K5: the oxDNA2 unbonded terms over a symmetric block-neighbor
// table (the block tier and the DiffTRe re-evaluation).
//
// Replace, in mythos_tpu/ops/oxdna_tiles.py:
//   K3 tile_forces     <- _bwd_rows_impl(forces_only=True) (bodies
//                         _bwd_forces_analytic_body / _bwd_forces_kernel_body):
//                         row forces, full mask, row side only;
//   K4 tile_energies   <- _fwd_impl (_fwd_kernel_body): per-term energy sums
//                         under the triangular mask (each pair once);
//   K5 tile_row_grads  <- _bwd_rows_impl (_bwd_kernel_body): the row
//                         gradients of K4's sums for a cotangent gt.
// Plain versions: ops/tiles.py::tile_forces_plain, tile_energies_plain,
// tile_row_grads_plain.
//
// Inputs: rows (n_pad, F) row-major per-particle fields (ops/tiles.py
// layout: F = 26 for the "full"/"short" kinds -- com, a1, a2, a3, hb
// weight factors hw and oh, qf, bonded partners prev/nxt; F = 8 for the
// "debye" kind -- backbone site, qf, prev/nxt); ids (n_blocks, cap) int32
// column blocks per row block, >= n_blocks marking an empty slot (skipped,
// not clamped); the packed parameter vector of stencil_physics.cuh.
//
// Design: one thread per row particle i. It walks its row block's cap
// column blocks x B columns, applies the mask of oxdna_tiles._tile_mask (no
// self pair, no bonded partner, real rows and columns only; K4 and K5's hb
// weights keep j > i) and calls the same pair physics as K1/K2
// (unbonded_pair with every term on: d = 1 within all reaches). With a
// symmetric table and the full mask, the row-side gradient is the whole
// force (oxdna_tiles.py:25-32), so every thread writes only its own row: no
// atomics, and the sums are deterministic. K4 reduces each block's thread
// sums in shared memory in a fixed tree order and a one-block tail sums the
// block partials in block order, so a state's energy does not depend on
// scheduling.
//
// What bounds it on an H100: arithmetic. A full-physics pair costs ~1.5k
// flops (site geometry, 8 polynomial arccos, the f1/f2/f3/f4 chains and
// their derivatives; an estimate from the source); a row visits cap x B
// columns (e.g. 8 x 8 = 64 at 10k nt on the tight table) against 104 bytes
// of rows per column read from L2. That is ~15 flops a byte before caching,
// and every column row is reused by the B rows of its block, so fp32
// instruction throughput and the divergent piecewise branches bound it,
// as they bound K2. Shared-memory column panels, wgmma and CUDA graphs are
// later work.
#include <cuda_runtime.h>

#include "stencil_physics.cuh"

#define KIND_FULL 0
#define KIND_SHORT 1
#define KIND_DEBYE 2

// full/short row layout (ops/tiles.py)
#define F_ROW 26
#define R_HW 12
#define R_OH 16
#define R_QF 21
#define R_PREV 23
#define R_NXT 24
// debye row layout
#define F_DB 8
#define D_QF 3
#define D_PREV 4
#define D_NXT 5

#define TILE_BLOCK 64

__device__ __forceinline__ Body row_body(const float* r) {
  Body b;
  b.com = v3(r[0], r[1], r[2]);
  b.a1 = v3(r[3], r[4], r[5]);
  b.a2 = v3(r[6], r[7], r[8]);
  b.a3 = v3(r[9], r[10], r[11]);
  b.q[0] = b.q[1] = b.q[2] = b.q[3] = 0.f;
  return b;
}

// Calls f(j) for every column j of row i that the mask keeps: j != i
// (full mask) or j > i (triangular), j < n, and j not a bonded partner.
template <typename Fn>
__device__ __forceinline__ void for_each_pair(int i, const int* ids, int cap, int n_blocks, int bsz, int n, int prev,
                                              int nxt, bool triangular, Fn f) {
  const int* row_ids = ids + (size_t)(i / bsz) * cap;
  for (int k = 0; k < cap; ++k) {
    int c = row_ids[k];
    if (c < 0 || c >= n_blocks) continue;
    for (int jj = 0; jj < bsz; ++jj) {
      int j = c * bsz + jj;
      if (j >= n || j == i || j == prev || j == nxt || (triangular && j < i)) continue;
      f(j);
    }
  }
}

__device__ __forceinline__ float hb_weight(const float* ri, const float* rj) {
  return ri[R_HW] * rj[R_OH] + ri[R_HW + 1] * rj[R_OH + 1] + ri[R_HW + 2] * rj[R_OH + 2] + ri[R_HW + 3] * rj[R_OH + 3];
}

// dE/d(back_i) of the weighted Debye term of one backbone-site pair
__device__ __forceinline__ V3 debye_back_grad(const float* P, const float* ri, const float* rj, float gt) {
  V3 v = v3(rj[0] - ri[0], rj[1] - ri[1], rj[2] - ri[2]);
  float r = norm(v);
  float g_r = gt * ri[D_QF] * rj[D_QF] * debye(r, P + P_DEBYE).d;
  return v * (-g_r / r);
}

// Row gradients of the weighted symmetric-mask sum (K3), and for K5 the
// triangular hb-weight gradient (with_hw) or the Debye charge gradient.
template <bool kFull>
__device__ __forceinline__ void row_grads(int i, const float* P, const float* rows, const int* ids, int n, int n_blocks,
                                          int bsz, int cap, int kind, float* out, int width) {
  if (kind == KIND_DEBYE) {
    V3 g = zero3();
    float g_qf = 0.f;
    if (i < n) {
      const float* ri = rows + (size_t)i * F_DB;
      float gt = P[P_GT + 4];
      for_each_pair(i, ids, cap, n_blocks, bsz, n, (int)ri[D_PREV], (int)ri[D_NXT], false, [&](int j) {
        const float* rj = rows + (size_t)j * F_DB;
        g += debye_back_grad(P, ri, rj, gt);
        if (kFull) {
          float r = norm(v3(rj[0] - ri[0], rj[1] - ri[1], rj[2] - ri[2]));
          g_qf += gt * debye(r, P + P_DEBYE).v * rj[D_QF];
        }
      });
    }
    float* o = out + (size_t)i * width;
    o[0] = g.x;
    o[1] = g.y;
    o[2] = g.z;
    if (kFull) o[3] = g_qf;
    return;
  }
  Grad acc = zero_grad();
  float g_hw[4] = {0.f, 0.f, 0.f, 0.f};
  if (i < n) {
    const float* ri = rows + (size_t)i * F_ROW;
    Body bi = row_body(ri);
    const int w_on[4] = {1, 1, 1, 1};
    int w_wide = kind == KIND_FULL ? 1 : 0;
    float gt_hb = P[P_GT + 1];
    for_each_pair(i, ids, cap, n_blocks, bsz, n, (int)ri[R_PREV], (int)ri[R_NXT], false, [&](int j) {
      const float* rj = rows + (size_t)j * F_ROW;
      Body bj = row_body(rj);
      unbonded_pair(P, bi, bj, hb_weight(ri, rj), ri[R_QF] * rj[R_QF], 1, w_on, w_wide, false, acc);
      if (kFull && j > i) {
        float h = gt_hb * hb_prod(P, bi, bj);
        for (int k = 0; k < 4; ++k) g_hw[k] += h * rj[R_OH + k];
      }
    });
  }
  float* o = out + (size_t)i * width;
  V3 parts[4] = {acc.com, acc.a1, acc.a2, acc.a3};
  for (int k = 0; k < 4; ++k) {
    o[3 * k] = parts[k].x;
    o[3 * k + 1] = parts[k].y;
    o[3 * k + 2] = parts[k].z;
  }
  if (kFull)
    for (int k = 0; k < 4; ++k) o[12 + k] = g_hw[k];
}

// K3: (n_pad, 12) dE/d(com, a1, a2, a3), or (n_pad, 3) dE/d(back) for the
// debye kind, weighted by the term weights at P_GT
__global__ void tile_forces_kernel(const float* __restrict__ P, const float* __restrict__ rows,
                                   const int* __restrict__ ids, int n, int n_blocks, int bsz, int cap, int kind,
                                   int n_pad, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  row_grads<false>(i, P, rows, ids, n, n_blocks, bsz, cap, kind, out, kind == KIND_DEBYE ? 3 : 12);
}

// K5: (n_pad, 16) = K3's 12 fields + the triangular hb-weight gradient, or
// (n_pad, 4) = back site + charge factor for the debye kind; the cotangent
// sits at P_GT (the wrapper writes it there)
__global__ void tile_row_grads_kernel(const float* __restrict__ P, const float* __restrict__ rows,
                                      const int* __restrict__ ids, int n, int n_blocks, int bsz, int cap, int kind,
                                      int n_pad, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  row_grads<true>(i, P, rows, ids, n, n_blocks, bsz, cap, kind, out, kind == KIND_DEBYE ? 4 : 16);
}

// K4, first pass: each block's per-term sums over its rows' pairs j > i
__global__ void tile_energies_kernel(const float* __restrict__ P, const float* __restrict__ rows,
                                     const int* __restrict__ ids, int n, int n_blocks, int bsz, int cap, int kind,
                                     float* __restrict__ partials) {
  __shared__ float s[5][TILE_BLOCK];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  float e[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (i < n) {
    if (kind == KIND_DEBYE) {
      const float* ri = rows + (size_t)i * F_DB;
      for_each_pair(i, ids, cap, n_blocks, bsz, n, (int)ri[D_PREV], (int)ri[D_NXT], true, [&](int j) {
        const float* rj = rows + (size_t)j * F_DB;
        float r = norm(v3(rj[0] - ri[0], rj[1] - ri[1], rj[2] - ri[2]));
        e[4] += debye(r, P + P_DEBYE).v * ri[D_QF] * rj[D_QF];
      });
    } else {
      const float* ri = rows + (size_t)i * F_ROW;
      Body bi = row_body(ri);
      bool with_debye = kind == KIND_FULL;
      for_each_pair(i, ids, cap, n_blocks, bsz, n, (int)ri[R_PREV], (int)ri[R_NXT], true, [&](int j) {
        const float* rj = rows + (size_t)j * F_ROW;
        float ep[5];
        unbonded_pair_energy(P, bi, row_body(rj), hb_weight(ri, rj), ri[R_QF] * rj[R_QF], true, with_debye, ep);
        for (int t = 0; t < 5; ++t) e[t] += ep[t];
      });
    }
  }
  for (int t = 0; t < 5; ++t) s[t][threadIdx.x] = e[t];
  __syncthreads();
  for (int half = TILE_BLOCK / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half)
      for (int t = 0; t < 5; ++t) s[t][threadIdx.x] += s[t][threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x < 5) partials[blockIdx.x * 5 + threadIdx.x] = s[threadIdx.x][0];
}

// K4, second pass: out[t] = sum of the block partials, in block order
__global__ void tile_energies_sum_kernel(const float* __restrict__ partials, int n_parts, float* __restrict__ out) {
  int t = threadIdx.x;
  if (t >= 5) return;
  float acc = 0.f;
  for (int b = 0; b < n_parts; ++b) acc += partials[b * 5 + t];
  out[t] = acc;
}

static int tile_grid(int rows) { return (rows + TILE_BLOCK - 1) / TILE_BLOCK; }

extern "C" int tile_forces(const float* params, const float* rows, const int* ids, int n, int n_blocks, int bsz,
                           int cap, int kind, int n_pad, float* out, void* stream) {
  tile_forces_kernel<<<tile_grid(n_pad), TILE_BLOCK, 0, (cudaStream_t)stream>>>(params, rows, ids, n, n_blocks, bsz,
                                                                                 cap, kind, n_pad, out);
  return (int)cudaGetLastError();
}

extern "C" int tile_row_grads(const float* params, const float* rows, const int* ids, int n, int n_blocks, int bsz,
                              int cap, int kind, int n_pad, float* out, void* stream) {
  tile_row_grads_kernel<<<tile_grid(n_pad), TILE_BLOCK, 0, (cudaStream_t)stream>>>(params, rows, ids, n, n_blocks,
                                                                                    bsz, cap, kind, n_pad, out);
  return (int)cudaGetLastError();
}

// partials: (tile_grid(n), 5) scratch; out: (5,) per-term sums
extern "C" int tile_energies(const float* params, const float* rows, const int* ids, int n, int n_blocks, int bsz,
                             int cap, int kind, float* partials, float* out, void* stream) {
  int grid = tile_grid(n);
  tile_energies_kernel<<<grid, TILE_BLOCK, 0, (cudaStream_t)stream>>>(params, rows, ids, n, n_blocks, bsz, cap, kind,
                                                                      partials);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  tile_energies_sum_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(partials, grid, out);
  return (int)cudaGetLastError();
}
