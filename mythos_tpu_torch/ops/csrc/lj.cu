// K6: the shifted 12-6 Lennard-Jones energy of the MARTINI nonbonded pairs
// and its position and box gradients, under the minimum image.
//
// Replace, in mythos_tpu/ops/lj.py:
//   lj_energy <- _lj_fwd_impl (_fwd_kernel): the energy summed over the
//                masked pairs;
//   lj_grads  <- _lj_vjp_bwd (_bwd_kernel): the position gradient over the
//                symmetrised mask, plus the box gradient dU/dbox, which the
//                TPU kernel's VJP does not return (the virial's image term).
// Plain versions: ops/lj.py::lj_energy_plain, lj_grads_plain, and
// cell_list_plain for the spatial cells both directions visit.
//
// Inputs: positions (n, 3) float32; types (n,) int32 into the (t, t)
// sigma/epsilon tables (t <= 32); the symmetric pair mask bit-packed as
// (n, words) 32-bit words, bit j % 32 of word j / 32 of row i set where the
// pair (i, j) interacts -- both directions read the words of the candidates
// they visit (the forward only those with j > i, each pair once); the box
// (3,) on the device (the barostat moves it there, so it is never read back
// to the host).
//
// Per pair (ops/lj.py::_lj_terms): d = dr - box * rint(dr / box), r2 =
// |d|^2 + 1e-18; inside r2 < cutoff^2 (the fixed 1.1 nm): x6 =
// min((sigma^2 / r2)^3, 1e15), V = 4 eps (x6^2 - x6) - V(cutoff), dV/dr2 =
// 4 eps (-12 x6^2 + 6 x6) / (2 r2). dU/dx_i = sum_j 2 dV/dr2 d_ij; dU/dbox_a = -sum over unordered
// pairs of 2 dV/dr2 d_a n_a, n = rint(dr / box).
//
// Both directions evaluate a pair only where its mask bit is set -- masked-out
// pairs are selected away, never multiplied by zero -- and only pairs inside
// the cutoff reach the type tables (in shared memory) and the LJ arithmetic.
// rint rounds ties to even, as torch.round and jnp.round do; dr * (1 / box)
// may round a ratio within an ulp of a half-integer the other way than
// dr / box, but such a pair is half a box (> cutoff) apart along that axis
// with either image, so it contributes nothing either way. The distance is
// formed without fma contraction, as the plain version forms it. No
// atomics touch a sum: two calls give the same bits. The minimum image
// holds only while every box side exceeds twice the cutoff; on a smaller box
// both directions write NaN (the host-side callers raise first).
//
// Both directions walk spatial cells, work bounded by the pairs in reach:
//   1. lj_cells_kernel (one block) bins the beads into spatial cells built
//      from the current positions and the box on the device, never from the
//      bead index (after diffusion or a permuted topology neighbouring
//      indices are not neighbours in space): floor(box / LJ_CELL) cells a
//      side, LJ_CELL = the cutoff plus 1e-4 nm, so that a bead placed one
//      cell off by float32 rounding at a border is still more than the
//      cutoff from every bead two cells away. Where that makes more than
//      LJ_MAX_CELLS cells (the build's shared histogram), the largest count
//      loses one cell at a time (x before y before z on ties) until they
//      fit: coarser cells, never thinner than LJ_CELL, so any box computes
//      and only the candidates per row grow (cell_dims; ops/lj.py::cell_dims
//      takes the same integers). A bead's cell comes from its
//      wrapped fraction f = x / box - floor(x / box), so positions outside
//      [0, box) bin where their image lies. Counts by shared-memory atomics,
//      an exclusive scan, placement at the arrival rank, then each bead's
//      place in its cell is the number of the cell's beads of lower index:
//      `order` lists the beads by (cell, index), whatever order the atomics
//      took.
//      One build serves a force evaluation: the forward builds the cells and
//      ops/lj.py::LJPairEnergy hands them to the backward.
//   2. lj_energy_kernel / lj_grads_kernel: one warp per row, rows taken in
//      cell order so that a block's eight warps read the same neighbour
//      cells from L1. Lanes 0..26 look up the row's distinct neighbour cells
//      (offsets -1, 0, +1 on an axis of 3 or more cells, 0, +1 on an axis of
//      2, where the two wrapped neighbours coincide, 0 on an axis of 1) and a
//      warp scan lays their beads end to end; lane l then takes candidates
//      l, l + 32, ... of that list (a binary search by shuffles finds each
//      one's cell), so the ~250 candidates of a row at the main path's
//      density fill the lanes. Each candidate still checks its bit in the
//      pair mask; the forward keeps only j > i (each unordered pair once).
//      The fixed candidate order (cells in offset order, beads by index) and
//      the fixed butterfly make each row's sum deterministic. The forward's
//      rows go into one partial per block in row order, the partials into
//      the energy by a one-warp tail; each row of the position gradient is
//      written by its own warp, the box gradient's rows (j > i: each
//      unordered pair once) are added in row order by the same tail.
//   A force evaluation launches five kernels: the cell build, the forward's
//   rows and tail, the backward's rows and tail.
//
// What bounds it on an H100: bytes. The function needs only the mask words
// that hold the bits of the pairs inside the cutoff (chip_smoke.py 9a
// counts them: ~68k words, 0.27 MB, at 10,160 beads; the kernel records'
// bounds charge those words, not the 13 MB mask's whole rows) and
// 0.16 MB of positions and types; only the ~2e5 pairs inside 1.1 nm need
// arithmetic. Each direction loads ~2.7e6 candidates (27 cells of ~9 beads
// a row) for the 201,832 unordered pairs in reach. What bounds the design
// now: the single-block cell build, serial in n on one SM (~0.029 ms of a
// force evaluation's ~0.076 ms of device time on an H100 at 10,160 beads,
// chip_smoke.py 9a), and those candidate loads (the rows kernels ~0.022
// ms forward, ~0.026 ms backward).
#include <cuda_runtime.h>
#include <stdint.h>

#define LJ_ROWS 8  // rows (warps) per block; ops/lj.py::ROWS_PER_BLOCK
#define LJ_MAX_TYPES 32
#define LJ_CUTOFF 1.1f  // nm, the fixed MARTINI cutoff; ops/lj.py::LJ_CUTOFF
#define LJ_CUT2 1.21f   // LJ_CUTOFF^2 as ops/lj.py compares it in float32
#define LJ_CELL 1.1001f  // least cell side; ops/lj.py::LJ_CELL
#define LJ_MAX_CELLS 32768  // ops/lj.py::MAX_CELLS: the build's shared histogram, 128 KB
#define LJ_BUILD_THREADS 1024

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

// One warp: out[c] = the sum over rows of x[row * stride + c], in a fixed order.
__global__ void lj_sum_kernel(const float* __restrict__ x, int rows, int stride, float* __restrict__ out) {
  const int c = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int r = lane; r < rows; r += 32) acc += x[(size_t)r * stride + c];
  acc = warp_sum(acc);
  if (lane == 0) out[c] = acc;
}

// Cells along a box side: floor(b / LJ_CELL), at least 1, at most LJ_MAX_CELLS.
__device__ __forceinline__ int cells_along(float b) {
  float c = floorf(__fdiv_rn(b, LJ_CELL));
  if (!(c >= 1.f)) return 1;
  return c > (float)LJ_MAX_CELLS ? LJ_MAX_CELLS : (int)c;
}

// The cells along x, y, z of a box: cells_along each side, then, while
// their product exceeds LJ_MAX_CELLS, the largest count loses one (x before
// y before z on ties). Every thread computes the same integers.
__device__ __forceinline__ void cell_dims(const float* box, int& ncx, int& ncy, int& ncz) {
  ncx = cells_along(box[0]);
  ncy = cells_along(box[1]);
  ncz = cells_along(box[2]);
  while ((long long)ncx * ncy * ncz > LJ_MAX_CELLS) {
    if (ncx >= ncy && ncx >= ncz)
      --ncx;
    else if (ncy >= ncz)
      --ncy;
    else
      --ncz;
  }
}

// The cell coordinate of x along a side of nc cells, from its wrapped fraction.
__device__ __forceinline__ int cell_coord(float x, float b, int nc) {
  float f = __fdiv_rn(x, b);
  f = __fsub_rn(f, floorf(f));
  int c = (int)__fmul_rn(f, (float)nc);
  return c < 0 ? 0 : (c >= nc ? nc - 1 : c);
}

// The spatial cells of the beads (one block): dims = the cells along x, y,
// z (cell_dims); cell_of[i] = (cx * ny + cy) * nz + cz; start[c] = the beads
// in cells below c (n from the last cell on, up to start[LJ_MAX_CELLS]);
// order = the beads by (cell, index); tmp (n,) scratch.
__global__ void __launch_bounds__(LJ_BUILD_THREADS)
    lj_cells_kernel(const float* __restrict__ pos, int n, const float* __restrict__ box, int* __restrict__ dims,
                    int* __restrict__ cell_of, int* __restrict__ start, int* __restrict__ order,
                    int* __restrict__ tmp) {
  extern __shared__ int s_hist[];  // LJ_MAX_CELLS counts, then starts
  __shared__ int s_warp[32];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const float bx = box[0], by = box[1], bz = box[2];
  int ncx, ncy, ncz;
  cell_dims(box, ncx, ncy, ncz);
  if (tid == 0) {
    dims[0] = ncx;
    dims[1] = ncy;
    dims[2] = ncz;
  }
  const int nc = ncx * ncy * ncz;
  for (int c = tid; c < nc; c += nt) s_hist[c] = 0;
  __syncthreads();
  // each bead's cell, and its arrival rank in it (kept in `order` until placed)
  for (int i = tid; i < n; i += nt) {
    const int c = (cell_coord(pos[3 * i], bx, ncx) * ncy + cell_coord(pos[3 * i + 1], by, ncy)) * ncz +
                  cell_coord(pos[3 * i + 2], bz, ncz);
    cell_of[i] = c;
    order[i] = atomicAdd(&s_hist[c], 1);
  }
  __syncthreads();
  // exclusive scan of the counts in place: thread tid takes a run of `per` cells
  const int per = (nc + nt - 1) / nt;
  const int c0 = min(tid * per, nc), c1 = min(c0 + per, nc);
  int run = 0;
  for (int c = c0; c < c1; ++c) run += s_hist[c];
  int incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < (nt >> 5) ? s_warp[lane] : 0;
    int w = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    s_warp[lane] = w - v;
  }
  __syncthreads();
  int acc = s_warp[warp] + incl - run;
  for (int c = c0; c < c1; ++c) {
    const int k = s_hist[c];
    s_hist[c] = acc;
    acc += k;
  }
  __syncthreads();
  for (int c = tid; c <= LJ_MAX_CELLS; c += nt) start[c] = c < nc ? s_hist[c] : n;
  // place each bead at its cell's start plus its arrival rank
  for (int i = tid; i < n; i += nt) tmp[s_hist[cell_of[i]] + order[i]] = i;
  __syncthreads();
  // sort each cell by bead index: a bead's place is the count of its cell's beads below it
  for (int i = tid; i < n; i += nt) {
    const int c = cell_of[i];
    const int s = s_hist[c], e = c + 1 < nc ? s_hist[c + 1] : n;
    int r = 0;
    for (int k = s; k < e; ++k) r += tmp[k] < i;
    order[s + r] = i;
  }
}

// Calls f(j) for each candidate j of row i -- the beads of the cells next to
// bead i's, cells in offset order, beads by index -- lane l taking
// candidates l, l + 32, ... Every lane of the warp must call it (shuffles).
template <typename Fn>
__device__ __forceinline__ void for_each_candidate(int lane, int i, const int* __restrict__ dims,
                                                   const int* __restrict__ cell_of, const int* __restrict__ start,
                                                   const int* __restrict__ order, Fn f) {
  const int ncx = dims[0], ncy = dims[1], ncz = dims[2];
  const int ci = cell_of[i];
  const int cz = ci % ncz, cy = (ci / ncz) % ncy, cx = ci / (ncz * ncy);
  const int kx = min(ncx, 3), ky = min(ncy, 3), kz = min(ncz, 3);
  // lane k < kx * ky * kz: the k-th distinct neighbour cell, its first bead and count
  int s = 0, cnt = 0;
  if (lane < kx * ky * kz) {
    const int a = lane / (ky * kz), b = (lane / kz) % ky, c = lane % kz;
    const int nx = (cx + (kx == 3 ? a - 1 : a) + ncx) % ncx;
    const int ny = (cy + (ky == 3 ? b - 1 : b) + ncy) % ncy;
    const int nz = (cz + (kz == 3 ? c - 1 : c) + ncz) % ncz;
    const int cc = (nx * ncy + ny) * ncz + nz;
    s = start[cc];
    cnt = start[cc + 1] - s;
  }
  int incl = cnt;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const int excl = incl - cnt, total = __shfl_sync(0xffffffffu, incl, 31);
  for (int base = 0; base < total; base += 32) {
    const int m = base + lane;
    int k = 0;  // the last neighbour cell whose first candidate is at or before m
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(0xffffffffu, excl, k + step) <= m) k += step;
    }
    const int sk = __shfl_sync(0xffffffffu, s, k), ek = __shfl_sync(0xffffffffu, excl, k);
    if (m < total) f(order[sk + m - ek]);
  }
}

__device__ __forceinline__ bool mask_bit(const uint32_t* row, int j) { return (row[j >> 5] >> (j & 31)) & 1u; }

// K6 forward, first pass: partials[b] = the energy of the pairs j > i of
// block b's rows (the beads order[8 b .. 8 b + 7]), rows added in order.
__global__ void __launch_bounds__(LJ_ROWS * 32)
    lj_energy_kernel(const float* __restrict__ pos, const int* __restrict__ types, const uint32_t* __restrict__ mask,
                     int n, int words, const float* __restrict__ box, const float* __restrict__ sig,
                     const float* __restrict__ eps, int t, const int* __restrict__ dims,
                     const int* __restrict__ cell_of, const int* __restrict__ start, const int* __restrict__ order,
                     float* __restrict__ partials) {
  __shared__ float s_sig[LJ_MAX_TYPES * LJ_MAX_TYPES], s_e4[LJ_MAX_TYPES * LJ_MAX_TYPES],
      s_vc[LJ_MAX_TYPES * LJ_MAX_TYPES];
  __shared__ float s_rows[LJ_ROWS];
  load_tables(sig, eps, t, s_sig, s_e4, s_vc);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * LJ_ROWS + warp;
  const float bx = box[0], by = box[1], bz = box[2];
  const bool ok = fminf(bx, fminf(by, bz)) > 2.f * LJ_CUTOFF;
  float acc = 0.f;
  if (ok && w < n) {  // uniform over the warp
    const float ix = 1.f / bx, iy = 1.f / by, iz = 1.f / bz;
    const int i = order[w];
    const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    const int ti = types[i] * t;
    const uint32_t* row = mask + (size_t)i * words;
    for_each_candidate(lane, i, dims, cell_of, start, order, [&](int j) {
      if (j <= i || !mask_bit(row, j)) return;
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
    });
  }
  acc = warp_sum(acc);
  if (lane == 0) s_rows[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < LJ_ROWS; ++r) s += s_rows[r];
    partials[blockIdx.x] = ok ? s : NAN_F;
  }
}

// K6 backward: grad[i] = sum_j 2 dV/dr2 d_ij over the symmetric mask;
// box_rows[i] = -sum_{j > i} 2 dV/dr2 d_ij * n_ij (each unordered pair once).
__global__ void __launch_bounds__(LJ_ROWS * 32)
    lj_grads_kernel(const float* __restrict__ pos, const int* __restrict__ types, const uint32_t* __restrict__ mask,
                    int n, int words, const float* __restrict__ box, const float* __restrict__ sig,
                    const float* __restrict__ eps, int t, const int* __restrict__ dims,
                    const int* __restrict__ cell_of, const int* __restrict__ start, const int* __restrict__ order,
                    float* __restrict__ grad, float* __restrict__ box_rows) {
  __shared__ float s_sig[LJ_MAX_TYPES * LJ_MAX_TYPES], s_e4[LJ_MAX_TYPES * LJ_MAX_TYPES],
      s_vc[LJ_MAX_TYPES * LJ_MAX_TYPES];
  load_tables(sig, eps, t, s_sig, s_e4, s_vc);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * LJ_ROWS + warp;
  if (w >= n) return;  // no barrier follows
  const float bx = box[0], by = box[1], bz = box[2];
  const bool ok = fminf(bx, fminf(by, bz)) > 2.f * LJ_CUTOFF;
  const int i = order[w];
  float gx = 0.f, gy = 0.f, gz = 0.f, hx = 0.f, hy = 0.f, hz = 0.f;
  if (ok) {
    const float ix = 1.f / bx, iy = 1.f / by, iz = 1.f / bz;
    const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    const int ti = types[i] * t;
    const uint32_t* row = mask + (size_t)i * words;
    for_each_candidate(lane, i, dims, cell_of, start, order, [&](int j) {
      if (!mask_bit(row, j)) return;
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
    });
  }
  gx = warp_sum(gx);
  gy = warp_sum(gy);
  gz = warp_sum(gz);
  hx = warp_sum(hx);
  hy = warp_sum(hy);
  hz = warp_sum(hz);
  if (lane == 0) {
    grad[3 * i] = ok ? gx : NAN_F;
    grad[3 * i + 1] = ok ? gy : NAN_F;
    grad[3 * i + 2] = ok ? gz : NAN_F;
    box_rows[3 * i] = ok ? hx : NAN_F;
    box_rows[3 * i + 1] = ok ? hy : NAN_F;
    box_rows[3 * i + 2] = ok ? hz : NAN_F;
  }
}

static int lj_grid(int n) { return (n + LJ_ROWS - 1) / LJ_ROWS; }

// The cells (dims: (3,); cell_of, order, tmp: (n,), tmp scratch; start:
// (LJ_MAX_CELLS + 1,)), as lj_cells_kernel fills them; its 128 KB of
// dynamic shared memory allowed once per device.
extern "C" int lj_cells(const float* pos, int n, const float* box, int* dims, int* cell_of, int* start, int* order,
                        int* tmp, void* stream) {
  static bool allowed[64] = {};
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int smem = LJ_MAX_CELLS * (int)sizeof(int);
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    rc = (int)cudaFuncSetAttribute(lj_cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
    allowed[dev] = true;
  }
  lj_cells_kernel<<<1, LJ_BUILD_THREADS, smem, (cudaStream_t)stream>>>(pos, n, box, dims, cell_of, start, order, tmp);
  return (int)cudaGetLastError();
}

// On cells lj_cells built from the same positions and box: partials
// (lj_grid(n),) scratch; out: the energy (a scalar)
extern "C" int lj_energy(const float* pos, const int* types, const uint32_t* mask, int n, int words, const float* box,
                         const float* sig, const float* eps, int t, const int* dims, const int* cell_of,
                         const int* start, const int* order, float* partials, float* out, void* stream) {
  if (n < 1 || t < 1 || t > LJ_MAX_TYPES) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  lj_energy_kernel<<<lj_grid(n), LJ_ROWS * 32, 0, s>>>(pos, types, mask, n, words, box, sig, eps, t, dims, cell_of,
                                                       start, order, partials);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  lj_sum_kernel<<<1, 32, 0, s>>>(partials, lj_grid(n), 1, out);
  return (int)cudaGetLastError();
}

// On cells lj_cells built from the same positions and box: grad (n, 3);
// box_rows (n, 3) scratch; box_grad (3,)
extern "C" int lj_grads(const float* pos, const int* types, const uint32_t* mask, int n, int words, const float* box,
                        const float* sig, const float* eps, int t, const int* dims, const int* cell_of,
                        const int* start, const int* order, float* grad, float* box_rows, float* box_grad,
                        void* stream) {
  if (n < 1 || t < 1 || t > LJ_MAX_TYPES) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  lj_grads_kernel<<<lj_grid(n), LJ_ROWS * 32, 0, s>>>(pos, types, mask, n, words, box, sig, eps, t, dims, cell_of,
                                                      start, order, grad, box_rows);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  lj_sum_kernel<<<1, 96, 0, s>>>(box_rows, n, 3, box_grad);
  return (int)cudaGetLastError();
}
