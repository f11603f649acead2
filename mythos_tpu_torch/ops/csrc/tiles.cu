// K3, K4, K5: the oxDNA2 and oxDNA1 unbonded terms over a symmetric
// block-neighbor table (the block tier and the DiffTRe re-evaluation); each
// has an oxDNA1 instance (tile_forces_dna1, tile_energies_dna1,
// tile_row_grads_dna1).
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
// tile_row_grads_plain; tile_gates_plain for their gate.
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
// One design for all three, a shared kernel body (tile_block) templated on
// what it writes (K3 and K5 run the same walk over the full mask, K4 over
// the triangular one): a block of TILE_THREADS takes up to TILE_ROWS rows of
// one row block (all B of them at B = 8: 1,250 blocks at 10k nt) and walks
// their cap x B columns a panel of TILE_PANEL column rows at a time:
//   1. the block's rows, the panel's columns and the parameters go to shared
//      memory with coalesced loads, each read once;
//   2. every (row, column) slot of the panel is masked (K4 also keeps only
//      j > i) and gated: its five site distances (backbone-backbone,
//      base-base, the two mixed ones, stack-stack) against the upper cutoff
//      each term's radial factor reads from the parameters (unbonded_reach;
//      past it the factor and its value are exactly (0, 0), so the gate drops
//      only exact zeros, of the energies as of the gradients);
//   3. warp ballots and prefix counts compact the kept slots, in slot
//      order, into shared lists: those needing a short-range term and those
//      needing Debye alone;
//   4. the block's threads take the short-range pairs first, then the
//      Debye-only ones, so the full physics runs on converged lanes, each
//      term (each excluded-volume distance) only where its reach bit is set
//      (unbonded_pair_gated, unbonded_pair_energy_gated); each pair's
//      results go to a shared slot at its list place: K3's 12 row-side
//      gradient fields; K5's 16, the same 12 plus, for j > i with the HB bit
//      set, gt_hb x the weight-free HB product (taken from the same gated
//      evaluation) x oh_j; K4's 5 unweighted energies;
//   5. one thread per (row, field) adds its row's slots in list order,
//      which is column order (K3's sums are the first design's bit for
//      bit); K4 then adds its block's rows in row order into one partial
//      per block, and a one-block tail adds the partials in block order.
// No atomics touch a sum: a state's energies and gradients do not depend
// on scheduling, and two calls give the same bits. The short kind never
// evaluates Debye; the debye kind has only the backbone-site term (K5 adds
// its charge-factor field gt x debye(r) x qf_j). An optional tally counts
// the ordered pairs under each kernel's mask by class.
//
// What bounds them on an H100: arithmetic, on the few pairs in reach. On
// the jittered 10k-nt duplex's table (chip_smoke.py phase 6) the full mask
// holds 610,004 ordered pairs a call: 31,126 need the short-range terms
// (~1.5k flops each with the gradient, ~650 for the energies alone, 8
// polynomial arccos among them), 118,794 Debye alone (~45 flops), and
// 460,084 (75 %) are skipped after ~60 flops of distances; the triangular
// mask holds about half of each. The short-range pairs, ~25 a block for
// K3/K5 and ~12 for K4, leave most lanes idle while they run: the latency
// of one pair's dependent chain bounds a block. A column row (104 B) is
// read once per block, not once per row. Registers, spills and shared
// memory of each kernel: chip_smoke.py phase 2 (nvcc -Xptxas -v).
//
// Model family: tile_block is templated on it (kFam). The oxDNA2 instances
// are K3, K4 and K5 as above. Their oxDNA1 instances run the same walk on a
// one-level table of the short kind (oxDNA1 has no Debye-Hueckel term, so
// no Debye-only pair and no KIND_DEBYE table), with oxDNA1's backbone site
// (com + bx a1) and its coaxial stacking (the f5 of cos phi3 and cos phi4
// on the backbone sites); they read no charge factor, and K4's Debye sum
// stays 0.
//
// Probabilistic sequences (sequence design): tile_block is templated on
// kPseq too, and each family has a pseq instance of each kernel
// (tile_forces_pseq, tile_forces_dna1_pseq, ...; the discrete instances
// carry none of its code). Its hb weight adds the row's correction corr_i
// (row field 20) where the column is the row's base-pair partner (field 22,
// a slot id): hw_i . oh_j + [partner_i == j] corr_i, the reference's
// weight under pseq (oxdna_tiles.py:507-510, 884-888). K5's pseq instance
// writes 21 fields: K5's 16, then the right factor's gradient -- for j < i
// with the HB bit set, gt_hb x the HB product of pair (j, i)
// (hb_product_swapped, the same bodies with the roles swapped) x hw_j --
// and the correction's, gt_hb x the HB product where j > i and j is the
// partner: the triangular forward's derivatives in oh and corr
// (oxdna_tiles.py:664-724). A thread then adds up two (row, field) sums
// (8 rows x 21 fields on 128 threads), each in the same fixed order.
#include <cuda_runtime.h>

#include "stencil_physics.cuh"

#define KIND_FULL 0
#define KIND_SHORT 1
#define KIND_DEBYE 2

// full/short row layout (ops/tiles.py)
#define F_ROW 26
#define R_HW 12
#define R_OH 16
#define R_CORR 20
#define R_QF 21
#define R_PARTNER 22
#define R_PREV 23
#define R_NXT 24
// debye row layout
#define F_DB 8
#define D_QF 3
#define D_PREV 4
#define D_NXT 5

#define TILE_ROWS 8
#define TILE_THREADS 128
#define TILE_WARPS (TILE_THREADS / 32)
#define TILE_PANEL 128
#define TILE_SLOTS (TILE_ROWS * TILE_PANEL)

// what tile_block writes
#define OUT_FORCES 0     // K3: (n_pad, 12) row forces, or (n_pad, 3)
#define OUT_ROW_GRADS 1  // K5: (n_pad, 16) row gradients, or (n_pad, 4)
#define OUT_ENERGIES 2   // K4: (blocks, 5) per-term partial sums

__device__ __forceinline__ Body row_body(const float* r) {
  Body b;
  b.com = v3(r[0], r[1], r[2]);
  b.a1 = v3(r[3], r[4], r[5]);
  b.a2 = v3(r[6], r[7], r[8]);
  b.a3 = v3(r[9], r[10], r[11]);
  b.q[0] = b.q[1] = b.q[2] = b.q[3] = 0.f;
  return b;
}

// the hb weight of row i and column j (a slot id): hw_i . oh_j, plus under
// a probabilistic sequence corr_i where j is i's base-pair partner
template <bool kPseq>
__device__ __forceinline__ float hb_weight(const float* ri, const float* rj, int j) {
  const float w =
      ri[R_HW] * rj[R_OH] + ri[R_HW + 1] * rj[R_OH + 1] + ri[R_HW + 2] * rj[R_OH + 2] + ri[R_HW + 3] * rj[R_OH + 3];
  if constexpr (kPseq) return ri[R_PARTNER] == (float)j ? w + ri[R_CORR] : w;
  return w;
}

// dE/d(back_i) of the weighted Debye term of one backbone-site pair
__device__ __forceinline__ V3 debye_back_grad(const float* P, const float* ri, const float* rj, float gt) {
  V3 v = v3(rj[0] - ri[0], rj[1] - ri[1], rj[2] - ri[2]);
  float r = norm(v);
  float g_r = gt * ri[D_QF] * rj[D_QF] * debye(r, P + P_DEBYE).d;
  return v * (-g_r / r);
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

// Fields a pair writes: K3 12 (3 for the debye kind), K5 16 (4; 21 under
// pseq), K4 5.
__host__ __device__ constexpr int out_fields(int out, bool debye_kind, bool pseq = false) {
  return out == OUT_ENERGIES ? 5
                             : (out == OUT_ROW_GRADS ? (debye_kind ? 4 : (pseq ? 21 : 16)) : (debye_kind ? 3 : 12));
}

// A pair of the debye kind (the backbone site alone): its Debye energy (K4),
// the gradient on row i's backbone site (K3), and K5's charge-factor field.
template <int kOut>
__device__ __forceinline__ void pair_results_debye(const float* P, const float* ri, const float* rj, float* res) {
  if (kOut == OUT_ENERGIES) {
    const float r = norm(v3(rj[0] - ri[0], rj[1] - ri[1], rj[2] - ri[2]));
    res[0] = res[1] = res[2] = res[3] = 0.f;
    res[4] = debye(r, P + P_DEBYE).v * ri[D_QF] * rj[D_QF];
    return;
  }
  const float gt = P[P_GT + 4];
  V3 g = debye_back_grad(P, ri, rj, gt);
  res[0] = g.x;
  res[1] = g.y;
  res[2] = g.z;
  if (kOut == OUT_ROW_GRADS) {
    const float r = norm(v3(rj[0] - ri[0], rj[1] - ri[1], rj[2] - ri[2]));
    res[3] = gt * debye(r, P + P_DEBYE).v * rj[D_QF];
  }
}

// One pair's results into res (out_fields(kOut, debye_kind, kPseq) floats): row i
// (ri) and column j (rj) of family kFam, its reach bits. P_GT holds K3's term
// weights or K5's cotangent; K4 ignores it.
template <int kOut, int kFam, bool kPseq>
__device__ __forceinline__ void pair_results(const float* P, const float* ri, const float* rj, int i, int j,
                                             int reach, bool debye_kind, float* res) {
  if constexpr (has_debye<kFam>()) {
    if (debye_kind) {
      pair_results_debye<kOut>(P, ri, rj, res);
      return;
    }
  }
  if constexpr (kOut == OUT_ENERGIES) {
    const float qq = has_debye<kFam>() ? ri[R_QF] * rj[R_QF] : 0.f;  // oxDNA1 reads no charge factor
    unbonded_pair_energy_gated<kFam>(P, row_body(ri), row_body(rj), hb_weight<kPseq>(ri, rj, j), qq, reach, res);
  } else {
    Grad g = zero_grad();
    float hb = 0.f;
    const float qq = has_debye<kFam>() ? ri[R_QF] * rj[R_QF] : 0.f;  // oxDNA1 reads no charge factor
    unbonded_pair_gated<kFam>(P, row_body(ri), row_body(rj), hb_weight<kPseq>(ri, rj, j), qq, reach, g,
                              kOut == OUT_ROW_GRADS ? &hb : nullptr);
    const V3 parts[4] = {g.com, g.a1, g.a2, g.a3};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      res[3 * k] = parts[k].x;
      res[3 * k + 1] = parts[k].y;
      res[3 * k + 2] = parts[k].z;
    }
    if (kOut == OUT_ROW_GRADS) {
      // the triangular hb-weight gradient: past HB's r_c_high the product is
      // exactly 0, so pairs without the bit add nothing
      const float h = (j > i && (reach & REACH_HB)) ? P[P_GT + 1] * hb : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) res[12 + k] = h * rj[R_OH + k];
      if constexpr (kPseq) {
        // the right factor oh_i meets the column's left factor where i is the
        // column of the triangular sum (j < i); the correction its partner
        const float ht = (j < i && (reach & REACH_HB)) ? P[P_GT + 1] * hb_product_swapped(P, row_body(ri), row_body(rj))
                                                       : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) res[16 + k] = ht * rj[R_HW + k];
        res[20] = ri[R_PARTNER] == (float)j ? h : 0.f;
      }
    }
  }
}

// The shared body of K3, K4 and K5: one block's rows of family kFam (see the
// header). out: K3/K5 (n_pad, nf) row results, K4 (blocks, 5) partials;
// counts, if set, gains the ordered pairs under the mask that needed the
// short-range terms, Debye alone, and nothing.
template <int kOut, int kFam, bool kPseq>
__device__ __forceinline__ void tile_block(const float* __restrict__ P_in, const float* __restrict__ rows,
                                           const int* __restrict__ ids, int n, int n_blocks, int bsz, int cap,
                                           int kind, float* __restrict__ out, int* __restrict__ counts) {
  static_assert(kFam == FAM_DNA2 || kFam == FAM_DNA1, "the tile kernels have oxDNA2 and oxDNA1 instances");
  constexpr int NF = out_fields(kOut, false, kPseq);
  // a second (row, field) sum a thread adds up where TILE_ROWS x NF passes TILE_THREADS (K5's pseq instance)
  constexpr bool kTwo = TILE_ROWS * NF > TILE_THREADS;
  static_assert(TILE_ROWS * NF <= 2 * TILE_THREADS, "at most two (row, field) sums a thread");
  constexpr bool triangular = kOut == OUT_ENERGIES;
  __shared__ float P[P_TOTAL];
  __shared__ float s_row[TILE_ROWS * F_ROW];
  __shared__ float s_col[TILE_PANEL * F_ROW];
  __shared__ int s_cid[TILE_PANEL];              // each panel column's particle, or -1
  __shared__ short s_kept[TILE_SLOTS];           // the kept slots, in slot order
  __shared__ unsigned char s_reach[TILE_SLOTS];  // their reach bits
  __shared__ short s_short[TILE_SLOTS];          // places in s_kept of the short-range pairs,
  __shared__ short s_debye[TILE_SLOTS];          // ... and of the Debye-only ones
  __shared__ short s_first[TILE_ROWS + 1];       // each row's first place in s_kept
  __shared__ float s_res[TILE_THREADS * NF];     // a batch's pair results, by place
  __shared__ int s_warp[TILE_WARPS][4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = (bsz + TILE_ROWS - 1) / TILE_ROWS;
  const int rb = blockIdx.x / groups, r_lo = (blockIdx.x - rb * groups) * TILE_ROWS;
  const int nr = min(TILE_ROWS, bsz - r_lo), i0 = rb * bsz + r_lo;
  const bool debye_kind = has_debye<kFam>() && kind == KIND_DEBYE;
  const int F = debye_kind ? F_DB : F_ROW, nf = out_fields(kOut, debye_kind, kPseq);
  const int prev = debye_kind ? D_PREV : R_PREV, nxt = debye_kind ? D_NXT : R_NXT;
  const int* row_ids = ids + (size_t)rb * cap;
  for (int k = tid; k < P_TOTAL; k += TILE_THREADS) P[k] = P_in[k];
  for (int k = tid; k < nr * F; k += TILE_THREADS) s_row[k] = rows[(size_t)i0 * F + k];
  const unsigned below = (1u << lane) - 1u;
  const int sum_r = tid / nf, sum_f = tid - sum_r * nf;  // the row and field this thread adds up
  const int sum_r2 = (tid + TILE_THREADS) / nf, sum_f2 = tid + TILE_THREADS - sum_r2 * nf;  // with kTwo
  float acc = 0.f, acc2 = 0.f;
  int n_short_all = 0, n_debye_all = 0, n_skipped = 0;  // the tally of the ordered pairs
  const int n_cols = cap * bsz;
  for (int c0 = 0; c0 < n_cols; c0 += TILE_PANEL) {
    const int nc = min(TILE_PANEL, n_cols - c0);
    __syncthreads();  // the rows are in, the previous panel is done with
    for (int k = tid; k < nc * F; k += TILE_THREADS) {
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
    for (int s0 = 0; s0 < n_slots; s0 += TILE_THREADS) {
      const int s = s0 + tid;
      int cls = 0, reach = 0;  // 0 masked out, 1 short-range, 2 Debye only, 3 skipped
      if (s < n_slots) {
        const int r = s / nc, c = s - r * nc, i = i0 + r, j = s_cid[c];
        const float* ri = s_row + r * F;
        if (i < n && j >= 0 && (triangular ? j > i : j != i) && j != (int)ri[prev] && j != (int)ri[nxt]) {
          const float* rj = s_col + c * F;
          if (debye_kind) {
            reach = norm(v3(rj[0] - ri[0], rj[1] - ri[1], rj[2] - ri[2])) < P[P_DEBYE + 3] ? REACH_DEBYE : 0;
          } else {
            reach = unbonded_reach<kFam>(P, row_body(ri), row_body(rj));
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
      for (int w = 0; w < TILE_WARPS; ++w) {
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
    // the kept pairs in batches of TILE_THREADS places, the short-range ones on the first threads
    for (int b0 = 0; b0 < n_kept; b0 += TILE_THREADS) {
      const int b1 = min(b0 + TILE_THREADS, n_kept);
      const int sl = lower_bound(s_short, n_short, b0), sh = lower_bound(s_short, n_short, b1);
      const int dl = lower_bound(s_debye, n_debye, b0);
      const int place = tid < sh - sl ? s_short[sl + tid] : (tid < b1 - b0 ? s_debye[dl + tid - (sh - sl)] : -1);
      if (place >= 0) {
        const int s = s_kept[place], r = s / nc, c = s - r * nc;
        pair_results<kOut, kFam, kPseq>(P, s_row + r * F, s_col + c * F, i0 + r, s_cid[c], s_reach[place],
                                        debye_kind, s_res + (place - b0) * nf);
      }
      __syncthreads();
      if (sum_r < nr) {
        const int k1 = min((int)s_first[sum_r + 1], b1);
        for (int k = max((int)s_first[sum_r], b0); k < k1; ++k) acc += s_res[(k - b0) * nf + sum_f];
      }
      if constexpr (kTwo) {
        if (sum_r2 < nr) {
          const int k1 = min((int)s_first[sum_r2 + 1], b1);
          for (int k = max((int)s_first[sum_r2], b0); k < k1; ++k) acc2 += s_res[(k - b0) * nf + sum_f2];
        }
      }
      __syncthreads();  // before s_res is written again
    }
  }
  if (kOut == OUT_ENERGIES) {
    // the block's rows in row order: one partial per term
    if (sum_r < nr) s_res[tid] = acc;
    __syncthreads();
    if (tid < 5) {
      float e = 0.f;
      for (int r = 0; r < nr; ++r) e += s_res[r * 5 + tid];
      out[(size_t)blockIdx.x * 5 + tid] = e;
    }
  } else if (sum_r < nr) {
    out[(size_t)i0 * nf + tid] = acc;
  }
  if constexpr (kTwo) {
    if (sum_r2 < nr) out[(size_t)i0 * nf + tid + TILE_THREADS] = acc2;
  }
  if (counts && tid == 0) {
    atomicAdd(counts, n_short_all);
    atomicAdd(counts + 1, n_debye_all);
    atomicAdd(counts + 2, n_skipped);
  }
}

// K3: (n_pad, 12) dE/d(com, a1, a2, a3), or (n_pad, 3) dE/d(back) for the
// debye kind (oxDNA2 only), weighted by the term weights at P_GT. One
// instance per family.
template <int kFam, bool kPseq>
__global__ void __launch_bounds__(TILE_THREADS)
    tile_forces_kernel(const float* __restrict__ P, const float* __restrict__ rows, const int* __restrict__ ids,
                       int n, int n_blocks, int bsz, int cap, int kind, float* __restrict__ out,
                       int* __restrict__ counts) {
  tile_block<OUT_FORCES, kFam, kPseq>(P, rows, ids, n, n_blocks, bsz, cap, kind, out, counts);
}

// K5: (n_pad, 16) = K3's 12 fields + the triangular hb-weight gradient, or
// (n_pad, 4) = back site + charge factor for the debye kind, (n_pad, 21)
// under pseq; the cotangent sits at P_GT (the wrapper writes it there). One
// instance per family, and a pseq instance of each.
template <int kFam, bool kPseq>
__global__ void __launch_bounds__(TILE_THREADS)
    tile_row_grads_kernel(const float* __restrict__ P, const float* __restrict__ rows, const int* __restrict__ ids,
                          int n, int n_blocks, int bsz, int cap, int kind, float* __restrict__ out,
                          int* __restrict__ counts) {
  tile_block<OUT_ROW_GRADS, kFam, kPseq>(P, rows, ids, n, n_blocks, bsz, cap, kind, out, counts);
}

// K4, first pass: (blocks, 5) partials, each block's per-term sums over its
// rows' pairs j > i. One instance per family.
template <int kFam, bool kPseq>
__global__ void __launch_bounds__(TILE_THREADS)
    tile_energies_kernel(const float* __restrict__ P, const float* __restrict__ rows, const int* __restrict__ ids,
                         int n, int n_blocks, int bsz, int cap, int kind, float* __restrict__ partials,
                         int* __restrict__ counts) {
  tile_block<OUT_ENERGIES, kFam, kPseq>(P, rows, ids, n, n_blocks, bsz, cap, kind, partials, counts);
}

// K4, second pass: out[t] = sum of the block partials, in block order. The
// block stages TAIL_CHUNK partials at a time in shared memory, so that the
// five adding threads read them without a device-memory latency per add
// (read straight from device memory, 1,250 partials took 0.066 ms on an
// H100, chip_smoke.py phase 6).
#define TAIL_THREADS 256
#define TAIL_CHUNK 1024
__global__ void __launch_bounds__(TAIL_THREADS)
    tile_energies_sum_kernel(const float* __restrict__ partials, int n_parts, float* __restrict__ out) {
  __shared__ float s[TAIL_CHUNK * 5];
  const int t = threadIdx.x;
  float acc = 0.f;
  for (int b0 = 0; b0 < n_parts; b0 += TAIL_CHUNK) {
    const int nb = min(TAIL_CHUNK, n_parts - b0);
    __syncthreads();  // the previous chunk is added
    for (int k = t; k < nb * 5; k += TAIL_THREADS) s[k] = partials[(size_t)b0 * 5 + k];
    __syncthreads();
    if (t < 5) {
#pragma unroll 8
      for (int b = 0; b < nb; ++b) acc += s[b * 5 + t];
    }
  }
  if (t < 5) out[t] = acc;
}

// blocks of TILE_THREADS for a table of n_blocks row blocks of bsz rows
static int tile_grid(int n_blocks, int bsz) { return n_blocks * ((bsz + TILE_ROWS - 1) / TILE_ROWS); }

static bool tile_args_ok(int n_blocks, int bsz, int cap) { return bsz >= 1 && cap >= 1 && n_blocks >= 1; }

template <int kFam, bool kPseq = false>
static int launch_forces(const float* params, const float* rows, const int* ids, int n, int n_blocks, int bsz,
                         int cap, int kind, float* out, int* counts, void* stream) {
  tile_forces_kernel<kFam, kPseq><<<tile_grid(n_blocks, bsz), TILE_THREADS, 0, (cudaStream_t)stream>>>(
      params, rows, ids, n, n_blocks, bsz, cap, kind, out, counts);
  return (int)cudaGetLastError();
}

// out: (n_pad, 12), or (n_pad, 3) for the debye kind; counts: (3,) or null
extern "C" int tile_forces(const float* params, const float* rows, const int* ids, int n, int n_blocks, int bsz,
                           int cap, int kind, float* out, int* counts, void* stream) {
  if (!tile_args_ok(n_blocks, bsz, cap)) return (int)cudaErrorInvalidValue;
  return launch_forces<FAM_DNA2>(params, rows, ids, n, n_blocks, bsz, cap, kind, out, counts, stream);
}

// K3's oxDNA1 instance: out (n_pad, 12), kind KIND_SHORT; counts: (3,) or null
extern "C" int tile_forces_dna1(const float* params, const float* rows, const int* ids, int n, int n_blocks, int bsz,
                                int cap, int kind, float* out, int* counts, void* stream) {
  if (!tile_args_ok(n_blocks, bsz, cap) || kind != KIND_SHORT) return (int)cudaErrorInvalidValue;
  return launch_forces<FAM_DNA1>(params, rows, ids, n, n_blocks, bsz, cap, kind, out, counts, stream);
}

template <int kFam, bool kPseq = false>
static int launch_row_grads(const float* params, const float* rows, const int* ids, int n, int n_blocks, int bsz,
                            int cap, int kind, float* out, int* counts, void* stream) {
  tile_row_grads_kernel<kFam, kPseq><<<tile_grid(n_blocks, bsz), TILE_THREADS, 0, (cudaStream_t)stream>>>(
      params, rows, ids, n, n_blocks, bsz, cap, kind, out, counts);
  return (int)cudaGetLastError();
}

// out: (n_pad, 16), or (n_pad, 4) for the debye kind; counts: (3,) or null
extern "C" int tile_row_grads(const float* params, const float* rows, const int* ids, int n, int n_blocks, int bsz,
                              int cap, int kind, float* out, int* counts, void* stream) {
  if (!tile_args_ok(n_blocks, bsz, cap)) return (int)cudaErrorInvalidValue;
  return launch_row_grads<FAM_DNA2>(params, rows, ids, n, n_blocks, bsz, cap, kind, out, counts, stream);
}

// K5's oxDNA1 instance: out (n_pad, 16), kind KIND_SHORT; counts: (3,) or null
extern "C" int tile_row_grads_dna1(const float* params, const float* rows, const int* ids, int n, int n_blocks,
                                   int bsz, int cap, int kind, float* out, int* counts, void* stream) {
  if (!tile_args_ok(n_blocks, bsz, cap) || kind != KIND_SHORT) return (int)cudaErrorInvalidValue;
  return launch_row_grads<FAM_DNA1>(params, rows, ids, n, n_blocks, bsz, cap, kind, out, counts, stream);
}

// rows of the (rows, 5) partials scratch that tile_energies needs: one per block
extern "C" int tile_energies_partials(int n_blocks, int bsz) { return tile_grid(n_blocks, bsz); }

template <int kFam, bool kPseq = false>
static int launch_energies(const float* params, const float* rows, const int* ids, int n, int n_blocks, int bsz,
                           int cap, int kind, float* partials, float* out, int* counts, void* stream) {
  const int grid = tile_grid(n_blocks, bsz);
  tile_energies_kernel<kFam, kPseq><<<grid, TILE_THREADS, 0, (cudaStream_t)stream>>>(params, rows, ids, n, n_blocks, bsz,
                                                                             cap, kind, partials, counts);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  tile_energies_sum_kernel<<<1, TAIL_THREADS, 0, (cudaStream_t)stream>>>(partials, grid, out);
  return (int)cudaGetLastError();
}

// partials: (tile_energies_partials(n_blocks, bsz), 5) scratch; out: (5,)
// per-term sums; counts: (3,) or null (the triangular mask's pairs)
extern "C" int tile_energies(const float* params, const float* rows, const int* ids, int n, int n_blocks, int bsz,
                             int cap, int kind, float* partials, float* out, int* counts, void* stream) {
  if (!tile_args_ok(n_blocks, bsz, cap)) return (int)cudaErrorInvalidValue;
  return launch_energies<FAM_DNA2>(params, rows, ids, n, n_blocks, bsz, cap, kind, partials, out, counts, stream);
}

// K4's oxDNA1 instance: kind KIND_SHORT; out (5,), its Debye sum 0
extern "C" int tile_energies_dna1(const float* params, const float* rows, const int* ids, int n, int n_blocks,
                                  int bsz, int cap, int kind, float* partials, float* out, int* counts, void* stream) {
  if (!tile_args_ok(n_blocks, bsz, cap) || kind != KIND_SHORT) return (int)cudaErrorInvalidValue;
  return launch_energies<FAM_DNA1>(params, rows, ids, n, n_blocks, bsz, cap, kind, partials, out, counts, stream);
}

// The pseq instances (a probabilistic sequence's correction in the hb weight;
// K5 writes (n_pad, 21)), of the full or short kind: the same arguments as
// the discrete entries. oxDNA1's take KIND_SHORT alone.
static bool pseq_args_ok(int n_blocks, int bsz, int cap, int kind, bool dna1) {
  return tile_args_ok(n_blocks, bsz, cap) && (dna1 ? kind == KIND_SHORT : kind != KIND_DEBYE);
}

extern "C" int tile_forces_pseq(const float* params, const float* rows, const int* ids, int n, int n_blocks, int bsz,
                                int cap, int kind, float* out, int* counts, void* stream) {
  if (!pseq_args_ok(n_blocks, bsz, cap, kind, false)) return (int)cudaErrorInvalidValue;
  return launch_forces<FAM_DNA2, true>(params, rows, ids, n, n_blocks, bsz, cap, kind, out, counts, stream);
}

extern "C" int tile_forces_dna1_pseq(const float* params, const float* rows, const int* ids, int n, int n_blocks,
                                     int bsz, int cap, int kind, float* out, int* counts, void* stream) {
  if (!pseq_args_ok(n_blocks, bsz, cap, kind, true)) return (int)cudaErrorInvalidValue;
  return launch_forces<FAM_DNA1, true>(params, rows, ids, n, n_blocks, bsz, cap, kind, out, counts, stream);
}

extern "C" int tile_row_grads_pseq(const float* params, const float* rows, const int* ids, int n, int n_blocks,
                                   int bsz, int cap, int kind, float* out, int* counts, void* stream) {
  if (!pseq_args_ok(n_blocks, bsz, cap, kind, false)) return (int)cudaErrorInvalidValue;
  return launch_row_grads<FAM_DNA2, true>(params, rows, ids, n, n_blocks, bsz, cap, kind, out, counts, stream);
}

extern "C" int tile_row_grads_dna1_pseq(const float* params, const float* rows, const int* ids, int n, int n_blocks,
                                        int bsz, int cap, int kind, float* out, int* counts, void* stream) {
  if (!pseq_args_ok(n_blocks, bsz, cap, kind, true)) return (int)cudaErrorInvalidValue;
  return launch_row_grads<FAM_DNA1, true>(params, rows, ids, n, n_blocks, bsz, cap, kind, out, counts, stream);
}

extern "C" int tile_energies_pseq(const float* params, const float* rows, const int* ids, int n, int n_blocks,
                                  int bsz, int cap, int kind, float* partials, float* out, int* counts, void* stream) {
  if (!pseq_args_ok(n_blocks, bsz, cap, kind, false)) return (int)cudaErrorInvalidValue;
  return launch_energies<FAM_DNA2, true>(params, rows, ids, n, n_blocks, bsz, cap, kind, partials, out, counts,
                                         stream);
}

extern "C" int tile_energies_dna1_pseq(const float* params, const float* rows, const int* ids, int n, int n_blocks,
                                       int bsz, int cap, int kind, float* partials, float* out, int* counts,
                                       void* stream) {
  if (!pseq_args_ok(n_blocks, bsz, cap, kind, true)) return (int)cudaErrorInvalidValue;
  return launch_energies<FAM_DNA1, true>(params, rows, ids, n, n_blocks, bsz, cap, kind, partials, out, counts,
                                         stream);
}
