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
// tile_row_grads_plain; tile_gates_plain for K3's gate.
//
// Inputs: rows (n_pad, F) row-major per-particle fields (ops/tiles.py
// layout: F = 26 for the "full"/"short" kinds -- com, a1, a2, a3, hb
// weight factors hw and oh, qf, bonded partners prev/nxt; F = 8 for the
// "debye" kind -- backbone site, qf, prev/nxt); ids (n_blocks, cap) int32
// column blocks per row block, >= n_blocks marking an empty slot (skipped,
// not clamped); the packed parameter vector of stencil_physics.cuh. Every
// kernel applies the mask of oxdna_tiles._tile_mask: no self pair, no bonded
// partner, real rows and columns only (K4 and K5's hb weights keep j > i).
// With a symmetric table and the full mask, the row-side gradient is the
// whole force (oxdna_tiles.py:25-32), so each row is written once: no
// atomics touch a sum, and two calls give the same bits.
//
// K3, redesigned for the H100: a block of K3_THREADS takes up to K3_ROWS
// rows of one row block (all B of them at B = 8: 1,250 blocks at 10k nt)
// and walks their cap x B columns a panel of K3_PANEL column rows at a time:
//   1. the block's rows, the panel's columns and the parameters go to shared
//      memory with coalesced loads, each read once;
//   2. every (row, column) slot of the panel is masked and gated: its five
//      site distances (backbone-backbone, base-base, the two mixed ones,
//      stack-stack) against the upper cutoff each term's radial factor
//      reads from the parameters (unbonded_reach; past it the factor is
//      exactly (0, 0), so the gate drops only exact zeros);
//   3. warp ballots and prefix counts compact the kept slots, in slot
//      order, into shared lists: those needing a short-range term and those
//      needing Debye alone;
//   4. the block's threads take the short-range pairs first, then the
//      Debye-only ones, so the full physics runs on converged lanes, each
//      term only where its reach bit is set (unbonded_pair_gated); each
//      pair's row-side gradient goes to a shared slot at its list place;
//   5. one thread per (row, field) adds its row's slots in list order,
//      which is column order, as the first design added them.
// The short kind never evaluates Debye; the debye kind has only the
// backbone-site term.
//
// What bounds it on an H100: arithmetic, on the few pairs in reach. On
// the jittered 10k-nt duplex's table (chip_smoke.py phase 6) the full mask
// holds 610,004 ordered pairs a call: 31,126 need the short-range terms
// (~1.5k flops each, 8 polynomial arccos among them), 118,794 Debye alone
// (~45 flops), and 460,084 (75 %) are skipped after ~60 flops of
// distances. The short-range pairs, ~25 a block, leave most lanes idle
// while they run: the latency of one pair's dependent chain bounds a
// block. A column row (104 B) is read once per block, not once per row.
// Built for sm_90a: 80 registers, 12 B of spill stores (an 8-byte stack
// frame), 28.9 KB of static shared memory.
//
// K4 and K5 keep the first design: one thread per row particle i walking
// its row block's cap column blocks x B columns with every term on
// (unbonded_pair / unbonded_pair_energy with d = 1 within all reaches). K4
// reduces each block's thread sums in shared memory in a fixed tree order
// and a one-block tail sums the block partials in block order, so a
// state's energy does not depend on scheduling.
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

#define TILE_BLOCK 64  // K4/K5 rows (threads) a block

#define K3_ROWS 8
#define K3_THREADS 128
#define K3_WARPS (K3_THREADS / 32)
#define K3_PANEL 128
#define K3_SLOTS (K3_ROWS * K3_PANEL)

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

// K5: row i's gradients of the weighted symmetric-mask sum and the
// triangular hb-weight gradient, or for the debye kind the back-site and
// charge-factor gradients
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
        float r = norm(v3(rj[0] - ri[0], rj[1] - ri[1], rj[2] - ri[2]));
        g_qf += gt * debye(r, P + P_DEBYE).v * rj[D_QF];
      });
    }
    float* o = out + (size_t)i * width;
    o[0] = g.x;
    o[1] = g.y;
    o[2] = g.z;
    o[3] = g_qf;
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
      if (j > i) {
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
  for (int k = 0; k < 4; ++k) o[12 + k] = g_hw[k];
}

// The first of list[0..len) at or after place p (list ascending)
__device__ __forceinline__ int lower_bound(const short* list, int len, int p) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] < p)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// K3: (n_pad, 12) dE/d(com, a1, a2, a3), or (n_pad, 3) dE/d(back) for the
// debye kind, weighted by the term weights at P_GT. counts, if set, gains
// the ordered pairs under the mask that needed the short-range terms, Debye
// alone, and nothing.
__global__ void __launch_bounds__(K3_THREADS)
    tile_forces_kernel(const float* __restrict__ P_in, const float* __restrict__ rows, const int* __restrict__ ids,
                       int n, int n_blocks, int bsz, int cap, int kind, float* __restrict__ out,
                       int* __restrict__ counts) {
  __shared__ float P[P_TOTAL];
  __shared__ float s_row[K3_ROWS * F_ROW];
  __shared__ float s_col[K3_PANEL * F_ROW];
  __shared__ int s_cid[K3_PANEL];              // each panel column's particle, or -1
  __shared__ short s_kept[K3_SLOTS];           // the kept slots, in slot order
  __shared__ unsigned char s_reach[K3_SLOTS];  // their reach bits
  __shared__ short s_short[K3_SLOTS];          // places in s_kept of the short-range pairs,
  __shared__ short s_debye[K3_SLOTS];          // ... and of the Debye-only ones
  __shared__ short s_first[K3_ROWS + 1];       // each row's first place in s_kept
  __shared__ float s_res[K3_THREADS * 12];     // a batch's row-side gradients, by place
  __shared__ int s_warp[K3_WARPS][4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = (bsz + K3_ROWS - 1) / K3_ROWS;
  const int rb = blockIdx.x / groups, r_lo = (blockIdx.x - rb * groups) * K3_ROWS;
  const int nr = min(K3_ROWS, bsz - r_lo), i0 = rb * bsz + r_lo;
  const bool debye_kind = kind == KIND_DEBYE;
  const int F = debye_kind ? F_DB : F_ROW, nf = debye_kind ? 3 : 12;
  const int prev = debye_kind ? D_PREV : R_PREV, nxt = debye_kind ? D_NXT : R_NXT;
  const int* row_ids = ids + (size_t)rb * cap;
  for (int k = tid; k < P_TOTAL; k += K3_THREADS) P[k] = P_in[k];
  for (int k = tid; k < nr * F; k += K3_THREADS) s_row[k] = rows[(size_t)i0 * F + k];
  const unsigned below = (1u << lane) - 1u;
  const int sum_r = tid / nf, sum_f = tid - sum_r * nf;  // the row and field this thread adds up
  float acc = 0.f;
  int n_short_all = 0, n_debye_all = 0, n_skipped = 0;  // the tally of the ordered pairs
  const int n_cols = cap * bsz;
  for (int c0 = 0; c0 < n_cols; c0 += K3_PANEL) {
    const int nc = min(K3_PANEL, n_cols - c0);
    __syncthreads();  // the rows are in, the previous panel is done with
    for (int k = tid; k < nc * F; k += K3_THREADS) {
      const int c = k / F, f = k - c * F, col = c0 + c, blk = row_ids[col / bsz];
      const bool real = blk >= 0 && blk < n_blocks;
      const int j = real ? blk * bsz + col % bsz : -1;
      if (real) s_col[k] = rows[(size_t)j * F + f];
      if (f == 0) s_cid[c] = j < n ? j : -1;
    }
    __syncthreads();
    // mask, gate and compact the panel's slots s = r * nc + c
    const int n_slots = nr * nc;
    int n_kept = 0, n_short = 0, n_debye = 0;
    for (int s0 = 0; s0 < n_slots; s0 += K3_THREADS) {
      const int s = s0 + tid;
      int cls = 0, reach = 0;  // 0 masked out, 1 short-range, 2 Debye only, 3 skipped
      if (s < n_slots) {
        const int r = s / nc, c = s - r * nc, i = i0 + r, j = s_cid[c];
        const float* ri = s_row + r * F;
        if (i < n && j >= 0 && j != i && j != (int)ri[prev] && j != (int)ri[nxt]) {
          const float* rj = s_col + c * F;
          if (debye_kind) {
            reach = norm(v3(rj[0] - ri[0], rj[1] - ri[1], rj[2] - ri[2])) < P[P_DEBYE + 3] ? REACH_DEBYE : 0;
          } else {
            reach = unbonded_reach(P, row_body(ri), row_body(rj));
            if (kind == KIND_SHORT) reach &= REACH_SHORT;
          }
          cls = (reach & REACH_SHORT) ? 1 : (reach ? 2 : 3);
        }
      }
      const unsigned kb = __ballot_sync(0xffffffffu, cls == 1 || cls == 2);
      const unsigned sb = __ballot_sync(0xffffffffu, cls == 1), db = __ballot_sync(0xffffffffu, cls == 2);
      const unsigned xb = __ballot_sync(0xffffffffu, cls == 3);
      if (lane == 0) {
        s_warp[warp][0] = __popc(kb);
        s_warp[warp][1] = __popc(sb);
        s_warp[warp][2] = __popc(db);
        s_warp[warp][3] = __popc(xb);
      }
      __syncthreads();
      int ko = n_kept, so = n_short, dO = n_debye;
      for (int w = 0; w < warp; ++w) {
        ko += s_warp[w][0];
        so += s_warp[w][1];
        dO += s_warp[w][2];
      }
      const int place = ko + __popc(kb & below);
      if (cls == 1 || cls == 2) {
        s_kept[place] = (short)s;
        s_reach[place] = (unsigned char)reach;
        if (cls == 1)
          s_short[so + __popc(sb & below)] = (short)place;
        else
          s_debye[dO + __popc(db & below)] = (short)place;
      }
      if (s < n_slots && s % nc == 0) s_first[s / nc] = (short)place;
      for (int w = 0; w < K3_WARPS; ++w) {
        n_kept += s_warp[w][0];
        n_short += s_warp[w][1];
        n_debye += s_warp[w][2];
        n_skipped += s_warp[w][3];
      }
      __syncthreads();  // before s_warp is written again
    }
    if (tid == 0) s_first[nr] = (short)n_kept;
    n_short_all += n_short;
    n_debye_all += n_debye;
    __syncthreads();
    // the kept pairs in batches of K3_THREADS places, the short-range ones on the first threads
    for (int b0 = 0; b0 < n_kept; b0 += K3_THREADS) {
      const int b1 = min(b0 + K3_THREADS, n_kept);
      const int sl = lower_bound(s_short, n_short, b0), sh = lower_bound(s_short, n_short, b1);
      const int dl = lower_bound(s_debye, n_debye, b0);
      const int place = tid < sh - sl ? s_short[sl + tid] : (tid < b1 - b0 ? s_debye[dl + tid - (sh - sl)] : -1);
      if (place >= 0) {
        const int s = s_kept[place], r = s / nc, c = s - r * nc;
        const float* ri = s_row + r * F;
        const float* rj = s_col + c * F;
        float* res = s_res + (place - b0) * nf;
        if (debye_kind) {
          V3 g = debye_back_grad(P, ri, rj, P[P_GT + 4]);
          res[0] = g.x;
          res[1] = g.y;
          res[2] = g.z;
        } else {
          Grad g = zero_grad();
          unbonded_pair_gated(P, row_body(ri), row_body(rj), hb_weight(ri, rj), ri[R_QF] * rj[R_QF], s_reach[place],
                              g);
          const V3 parts[4] = {g.com, g.a1, g.a2, g.a3};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            res[3 * k] = parts[k].x;
            res[3 * k + 1] = parts[k].y;
            res[3 * k + 2] = parts[k].z;
          }
        }
      }
      __syncthreads();
      if (sum_r < nr) {
        const int k1 = min((int)s_first[sum_r + 1], b1);
        for (int k = max((int)s_first[sum_r], b0); k < k1; ++k) acc += s_res[(k - b0) * nf + sum_f];
      }
      __syncthreads();  // before s_res is written again
    }
  }
  if (sum_r < nr) out[(size_t)i0 * nf + tid] = acc;
  if (counts && tid == 0) {
    atomicAdd(counts, n_short_all);
    atomicAdd(counts + 1, n_debye_all);
    atomicAdd(counts + 2, n_skipped);
  }
}

// K5: (n_pad, 16) = K3's 12 fields + the triangular hb-weight gradient, or
// (n_pad, 4) = back site + charge factor for the debye kind; the cotangent
// sits at P_GT (the wrapper writes it there)
__global__ void tile_row_grads_kernel(const float* __restrict__ P, const float* __restrict__ rows,
                                      const int* __restrict__ ids, int n, int n_blocks, int bsz, int cap, int kind,
                                      int n_pad, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  row_grads(i, P, rows, ids, n, n_blocks, bsz, cap, kind, out, kind == KIND_DEBYE ? 4 : 16);
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

// out: (n_pad, 12), or (n_pad, 3) for the debye kind; counts: (3,) or null
extern "C" int tile_forces(const float* params, const float* rows, const int* ids, int n, int n_blocks, int bsz,
                           int cap, int kind, float* out, int* counts, void* stream) {
  if (bsz < 1 || cap < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  const int groups = (bsz + K3_ROWS - 1) / K3_ROWS;
  tile_forces_kernel<<<n_blocks * groups, K3_THREADS, 0, (cudaStream_t)stream>>>(params, rows, ids, n, n_blocks, bsz,
                                                                                 cap, kind, out, counts);
  return (int)cudaGetLastError();
}

extern "C" int tile_row_grads(const float* params, const float* rows, const int* ids, int n, int n_blocks, int bsz,
                              int cap, int kind, int n_pad, float* out, void* stream) {
  tile_row_grads_kernel<<<tile_grid(n_pad), TILE_BLOCK, 0, (cudaStream_t)stream>>>(params, rows, ids, n, n_blocks,
                                                                                    bsz, cap, kind, n_pad, out);
  return (int)cudaGetLastError();
}

// rows of the (rows, 5) partials scratch that tile_energies needs for n rows
extern "C" int tile_energies_partials(int n) { return tile_grid(n); }

// partials: (tile_energies_partials(n), 5) scratch; out: (5,) per-term sums
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
