// K6: the shifted 12-6 Lennard-Jones energy of the MARTINI nonbonded pairs
// and its position and box gradients, under the minimum image.
//
// Replace, in mythos_tpu/ops/lj.py:
//   lj_energy <- _lj_fwd_impl (_fwd_kernel): the energy summed over the
//                masked pairs;
//   lj_grads  <- _lj_vjp_bwd (_bwd_kernel): the position gradient over the
//                symmetrised mask, plus the box gradient dU/dbox, which the
//                TPU kernel's VJP does not return (the virial's image term).
// Plain versions: ops/lj.py::lj_energy_plain, lj_grads_plain.
//
// Inputs: positions (n, 3) float32; types (n,) int32 into the (t, t)
// sigma/epsilon tables (t <= 32); the symmetric pair mask bit-packed as
// (n, words) 32-bit words, bit j % 32 of word j / 32 of row i set where the
// pair (i, j) interacts -- lj_energy reads its upper half (j > i, each pair
// once), lj_grads whole rows; the box (3,) on the device (the barostat
// moves it there, so it is never read back to the host).
//
// Per pair (ops/lj.py::_lj_terms): d = dr - box * rint(dr / box), r2 =
// |d|^2 + 1e-18; inside r2 < cutoff^2 (the fixed 1.1 nm): x6 =
// min((sigma^2 / r2)^3, 1e15), V = 4 eps (x6^2 - x6) - V(cutoff), dV/dr2 =
// 4 eps (-12 x6^2 + 6 x6) / (2 r2). dU/dx_i = sum_j 2 dV/dr2 d_ij; dU/dbox_a = -sum over unordered
// pairs of 2 dV/dr2 d_a n_a, n = rint(dr / box).
//
// Design: one warp per row i (8 rows a block), lane l taking the columns
// 32 k + l of mask word k, so 10,160 rows put 325k threads on the card;
// the forward starts at the word of column i + 1.
// The warp reads each mask word once (a broadcast); a pair is evaluated
// only where its bit is set -- masked-out pairs are selected away, never
// multiplied by zero -- and only pairs inside the cutoff reach the type
// tables (in shared memory) and the LJ arithmetic. rint rounds ties to
// even, as torch.round and jnp.round do; dr * (1 / box) may round a ratio
// within an ulp of a half-integer the other way than dr / box, but such a
// pair is half a box (> cutoff) apart along that axis with either image,
// so it contributes nothing either way. The distance is formed without
// fma contraction, as the plain version forms it. Every sum has a fixed
// order: each lane adds its columns in order, the warp reduces by a fixed
// butterfly, a block adds its rows in row order, and a one-warp tail adds
// the block partials (energy) or the row partials (box gradient) in a
// fixed order; each row of the position gradient is written by its own
// warp. No atomics: two calls give the same bits. The minimum image holds
// only while every box side exceeds twice the cutoff; on a smaller box
// both kernels write NaN (the host-side callers raise first).
//
// What bounds it on an H100: bytes. The function needs the mask (13 MB at
// 10,160 beads, half of it for the energy) and 0.16 MB of positions and
// types, ~4 us at 3.35 TB/s; only the ~2e5 pairs inside 1.1 nm need
// arithmetic. The kernels do more than that: the distance test (~22
// flops) on every masked pair, 5.2e7 in the forward and twice that in
// lj_grads, which visits each pair from both rows (no scatter). A cell
// list (skip whole column tiles beyond the cutoff), column tiles in shared
// memory and a Newton-third-law scatter are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define LJ_ROWS 8  // rows (warps) per block; ops/lj.py::ROWS_PER_BLOCK
#define LJ_MAX_TYPES 32
#define LJ_CUTOFF 1.1f  // nm, the fixed MARTINI cutoff; ops/lj.py::LJ_CUTOFF
#define LJ_CUT2 1.21f   // LJ_CUTOFF^2 as ops/lj.py compares it in float32

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The type tables in shared memory: sigma, 4 eps, and V(cutoff) per type pair.
__device__ __forceinline__ void load_tables(const float* sig, const float* eps, int t, float* s_sig, float* s_e4,
                                            float* s_vc) {
  for (int k = threadIdx.x; k < t * t; k += blockDim.x) {
    float s = sig[k], e4 = 4.f * eps[k];
    float c = s / LJ_CUTOFF;
    float c6 = c * c * c * c * c * c;
    s_sig[k] = s;
    s_e4[k] = e4;
    s_vc[k] = e4 * (c6 * c6 - c6);
  }
}

// Minimum-image component and its image index n.
__device__ __forceinline__ float min_image(float xi, float xj, float b, float inv_b, float& n) {
  float d = __fsub_rn(xi, xj);
  n = rintf(d * inv_b);
  return __fsub_rn(d, __fmul_rn(b, n));
}

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)), 1e-18f);
}

__device__ __forceinline__ float lj_x6(float sig, float r2) {
  float inv = __fdiv_rn(sig * sig, r2);
  return fminf(inv * inv * inv, 1e15f);
}

#define NAN_F __int_as_float(0x7fc00000)

// K6 forward, first pass: partials[b] = the energy of block b's rows' pairs j > i.
__global__ void __launch_bounds__(LJ_ROWS * 32)
    lj_energy_kernel(const float* __restrict__ pos, const int* __restrict__ types, const uint32_t* __restrict__ mask,
                     int n, int words, const float* __restrict__ box, const float* __restrict__ sig,
                     const float* __restrict__ eps, int t, float* __restrict__ partials) {
  __shared__ float s_sig[LJ_MAX_TYPES * LJ_MAX_TYPES], s_e4[LJ_MAX_TYPES * LJ_MAX_TYPES],
      s_vc[LJ_MAX_TYPES * LJ_MAX_TYPES];
  __shared__ float s_rows[LJ_ROWS];
  load_tables(sig, eps, t, s_sig, s_e4, s_vc);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * LJ_ROWS + warp;
  const float bx = box[0], by = box[1], bz = box[2];
  const float ix = 1.f / bx, iy = 1.f / by, iz = 1.f / bz;
  float acc = 0.f;
  if (i < n) {
    const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    const int ti = types[i] * t;
    const uint32_t* row = mask + (size_t)i * words;
    for (int k = (i + 1) >> 5; k < words; ++k) {
      const uint32_t w = row[k];
      if (!((w >> lane) & 1u)) continue;
      const int j = (k << 5) + lane;
      if (j <= i || j >= n) continue;
      float nx, ny, nz;
      float dx = min_image(xi, pos[3 * j], bx, ix, nx);
      float dy = min_image(yi, pos[3 * j + 1], by, iy, ny);
      float dz = min_image(zi, pos[3 * j + 2], bz, iz, nz);
      float r2 = dist2(dx, dy, dz);
      if (r2 < LJ_CUT2) {
        const int tt = ti + types[j];
        float x6 = lj_x6(s_sig[tt], r2);
        acc += s_e4[tt] * (x6 * x6 - x6) - s_vc[tt];
      }
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) s_rows[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < LJ_ROWS; ++r) s += s_rows[r];
    partials[blockIdx.x] = fminf(bx, fminf(by, bz)) > 2.f * LJ_CUTOFF ? s : NAN_F;
  }
}

// One warp: out[c] = the sum over rows of x[row * stride + c], in a fixed order.
__global__ void lj_sum_kernel(const float* __restrict__ x, int rows, int stride, float* __restrict__ out) {
  const int c = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int r = lane; r < rows; r += 32) acc += x[(size_t)r * stride + c];
  acc = warp_sum(acc);
  if (lane == 0) out[c] = acc;
}

// K6 backward: grad[i] = sum_j 2 dV/dr2 d_ij over the symmetric mask;
// box_rows[i] = -sum_{j > i} 2 dV/dr2 d_ij * n_ij (each unordered pair once).
__global__ void __launch_bounds__(LJ_ROWS * 32)
    lj_grads_kernel(const float* __restrict__ pos, const int* __restrict__ types, const uint32_t* __restrict__ mask,
                    int n, int words, const float* __restrict__ box, const float* __restrict__ sig,
                    const float* __restrict__ eps, int t, float* __restrict__ grad, float* __restrict__ box_rows) {
  __shared__ float s_sig[LJ_MAX_TYPES * LJ_MAX_TYPES], s_e4[LJ_MAX_TYPES * LJ_MAX_TYPES],
      s_vc[LJ_MAX_TYPES * LJ_MAX_TYPES];
  load_tables(sig, eps, t, s_sig, s_e4, s_vc);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * LJ_ROWS + warp;
  if (i >= n) return;  // no barrier follows
  const float bx = box[0], by = box[1], bz = box[2];
  const float ix = 1.f / bx, iy = 1.f / by, iz = 1.f / bz;
  const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
  const int ti = types[i] * t;
  const uint32_t* row = mask + (size_t)i * words;
  float gx = 0.f, gy = 0.f, gz = 0.f, hx = 0.f, hy = 0.f, hz = 0.f;
  for (int k = 0; k < words; ++k) {
    const uint32_t w = row[k];
    if (!((w >> lane) & 1u)) continue;
    const int j = (k << 5) + lane;
    if (j >= n) continue;
    float nx, ny, nz;
    float dx = min_image(xi, pos[3 * j], bx, ix, nx);
    float dy = min_image(yi, pos[3 * j + 1], by, iy, ny);
    float dz = min_image(zi, pos[3 * j + 2], bz, iz, nz);
    float r2 = dist2(dx, dy, dz);
    if (r2 < LJ_CUT2) {
      const int tt = ti + types[j];
      float x6 = lj_x6(s_sig[tt], r2);
      float c = 2.f * (s_e4[tt] * (-12.f * x6 * x6 + 6.f * x6) / (2.f * r2));
      gx += c * dx;
      gy += c * dy;
      gz += c * dz;
      if (j > i) {
        hx -= c * dx * nx;
        hy -= c * dy * ny;
        hz -= c * dz * nz;
      }
    }
  }
  gx = warp_sum(gx);
  gy = warp_sum(gy);
  gz = warp_sum(gz);
  hx = warp_sum(hx);
  hy = warp_sum(hy);
  hz = warp_sum(hz);
  if (lane == 0) {
    const bool ok = fminf(bx, fminf(by, bz)) > 2.f * LJ_CUTOFF;
    grad[3 * i] = ok ? gx : NAN_F;
    grad[3 * i + 1] = ok ? gy : NAN_F;
    grad[3 * i + 2] = ok ? gz : NAN_F;
    box_rows[3 * i] = ok ? hx : NAN_F;
    box_rows[3 * i + 1] = ok ? hy : NAN_F;
    box_rows[3 * i + 2] = ok ? hz : NAN_F;
  }
}

static int lj_grid(int n) { return (n + LJ_ROWS - 1) / LJ_ROWS; }

// partials: (lj_grid(n),) scratch; out: the energy (a scalar)
extern "C" int lj_energy(const float* pos, const int* types, const uint32_t* mask, int n, int words, const float* box,
                         const float* sig, const float* eps, int t, float* partials, float* out, void* stream) {
  if (n < 1 || t < 1 || t > LJ_MAX_TYPES) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  lj_energy_kernel<<<lj_grid(n), LJ_ROWS * 32, 0, s>>>(pos, types, mask, n, words, box, sig, eps, t, partials);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  lj_sum_kernel<<<1, 32, 0, s>>>(partials, lj_grid(n), 1, out);
  return (int)cudaGetLastError();
}

// grad: (n, 3); box_rows: (n, 3) scratch; box_grad: (3,)
extern "C" int lj_grads(const float* pos, const int* types, const uint32_t* mask, int n, int words, const float* box,
                        const float* sig, const float* eps, int t, float* grad, float* box_rows, float* box_grad,
                        void* stream) {
  if (n < 1 || t < 1 || t > LJ_MAX_TYPES) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  lj_grads_kernel<<<lj_grid(n), LJ_ROWS * 32, 0, s>>>(pos, types, mask, n, words, box, sig, eps, t, grad, box_rows);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  lj_sum_kernel<<<1, 96, 0, s>>>(box_rows, n, 3, box_grad);
  return (int)cudaGetLastError();
}
