// K2: one unbonded band evaluation of the oxDNA2, oxRNA2 or oxDNA1 stencil --
// (7, n) com + quaternion in, (7, n) dE/dcom + dE/dquat out. One instance
// per model family (template parameter kFam; stencil_field_grads,
// stencil_field_grads_rna2 and stencil_field_grads_dna1). The oxDNA1
// instance has no Debye-Hueckel term: its band is w_wide = the widest
// short-range reach, it reads no charge factor, and its Debye-only list
// stays empty.
//
// Replaces mythos_tpu/ops/stencil.py::_kernel_field_grads (Pallas body
// _make_stencil_kernel). Plain version: ops/stencil.py::field_grads_plain;
// plain version of the gate: ops/stencil.py::band_gates_plain.
//
// What bounds it on an H100: the latency of the few pairs that need the
// physics. The band offers w_wide pairs a slot (160k at 10k nt for oxDNA2,
// w_wide 16; 250k for oxRNA2, w_wide 25), but only ~1.5 a slot lie inside a
// short-range cutoff (~1.5k flops each with the gradient: site geometry,
// 8 polynomial arccos, the f1/f2/f4 chains and their derivatives) and a few
// inside Debye's alone (~45 flops); the rest need the ~60 flops of their
// site distances and nothing more. The first design gave each slot one
// thread that walked its 2 w_wide pairs (each pair evaluated from both
// ends) through the full physics up to each term's offset reach: 157
// blocks of 64 threads, ~2.4 warps an SM, diverging on the term branches --
// 0.077 ms (oxDNA2) and 0.17 ms (oxRNA2) of device time a call at 10k nt on
// an H100 80GB HBM3 at 700 W, 0.2-0.5 % of the bound; this design 0.019 and
// 0.021-0.022 ms on the same card (chip_smoke.py phases 3 and 10a).
//
// This design:
//   1. A block owns K2_SLOTS consecutive slots [t0, t0 + S). It stages the
//      slots [t0 - w_wide, t0 + S + w_wide) in shared memory, each body's
//      frame formed once from its quaternion (com, a1, a2, a3), with its
//      sequence, bonded partners and Debye charge factor, and the parameters.
//   2. Its candidates are the band pairs (i, i + d), d = 1..w_wide, that
//      touch an owned slot: i owned (S x w_wide of them), or i in the left
//      halo and i + d owned (w_wide (w_wide + 1) / 2). One thread a candidate
//      forms the site distances and gates it by reach (band_reach<kFam>: each
//      term's radial factor inside its upper cutoff AND the pair within the
//      term's offset reach; past the cutoff the factor and its derivative
//      are exactly (0, 0), so the gate drops only exact zeros, and the
//      kernel takes exactly the reference's terms, also when the band has
//      overflowed). Warp ballots and prefix counts compact the kept
//      candidates into two lists: those needing a short-range term and those
//      needing Debye alone.
//   3. The block's threads take the kept pairs in batches of K2_THREADS,
//      the short-range ones first (full physics on converged lanes, each
//      term, each excluded-volume distance, only where its reach bit is set;
//      unbonded_pair_terms<true, kFam, true>), then the Debye-only ones on a
//      cheap path (the backbone distance alone). Each pair is evaluated once
//      and gives both bodies' shares; a pair that reaches into a neighbour
//      block's slots is evaluated by both blocks, each keeping its own side
//      (the halo: ~mean offset / S of the pairs, 10-30 %).
//   4. After each batch, one thread per (owned slot, one of com, a1, a2,
//      a3) adds the batch's shares of its slot in a fixed order: offsets
//      d = 1..w_wide, for each the i-side share of (t, t + d), then the
//      j-side share of (t - d, t) -- found through each candidate's place
//      in the batch. Then each owned slot's frame cotangent is pulled back
//      to d/dquat (frame_vjp) and written.
// No atomics touch a sum, so two calls give the same bits. The sums differ
// from the plain version's by float32 order and by hand-written against
// autograd derivatives: rtol 1e-4, atol 1e-4 max|plain| (at the float32
// arccos clamp the float32 budget, chip_smoke.py phases 3 and 10a).
// An optional tally counts the band pairs (each once, by the block owning
// its i side) by gate: each term's, then short-range, Debye only, skipped
// (ops/stencil.py::band_gate_counts) -- by warp ballots, one row of counts
// a block, which the wrapper adds up: no atomics anywhere.
//
// Probabilistic sequences (sequence design): the kernel is templated on
// kPseq too, and each family has a pseq instance (stencil_field_grads_pseq,
// stencil_field_grads_rna2_pseq, stencil_field_grads_dna1_pseq; the
// discrete instances carry none of its code). oxRNA2's stages the most:
// w_wide 25 gives 82 slots of 10 hb factors, 10,904 floats (43.6 KB) of
// dynamic shared memory a block in all. It takes the hb weight of band pair
// (i, i + d) from per-slot factors instead of the sequence and the weight
// table: hw_i . oh_{i+d}, plus corr_i where i + d is i's base-pair partner
// (the reference's weight_d under pseq, mythos_tpu/ops/stencil.py:360-371).
// The factors, (10, n) rows hw (4), oh (4), corr, partner (a slot id as a
// float), are staged with the slots, 10 floats a slot in place of the
// sequence's one int (ops/stencil.py::StencilContext.hbf).
//
// Step barrier: K2 is a single evaluation, so there is none; on the
// stencil's per-step branch the steps are ordered by launch order on one
// stream.
#include <cuda_runtime.h>

#include "stencil_physics.cuh"

#define K2_SLOTS 32
#define K2_THREADS 128
#define K2_WARPS (K2_THREADS / 32)
#define K2_BODY 12  // com, a1, a2, a3 of a staged slot
#define K2_RES 24   // a pair's two shares: body i's then body j's com, a1, a2, a3
#define K2_TALLY 8  // exc, hb, cross, coax, debye, short-range, Debye only, skipped
#define K2_HBF 10   // a pseq's hb factors of a slot: hw (4), oh (4), corr, partner

// The dynamic shared memory of a block, in floats/ints, for reach w_wide
// (the pseq instance's hb factors after the rest).
struct K2Smem {
  int n_loc, n_cand;
  int body, seq, pn0, pn1, qf, place, reach, shorts, debyes, res, hbf, total;
};

__host__ __device__ inline K2Smem k2_smem(int w_wide, bool pseq = false) {
  K2Smem m;
  m.n_loc = K2_SLOTS + 2 * w_wide;
  m.n_cand = (K2_SLOTS + w_wide) * w_wide;
  m.body = 0;
  m.seq = m.body + m.n_loc * K2_BODY;
  m.pn0 = m.seq + m.n_loc;
  m.pn1 = m.pn0 + m.n_loc;
  m.qf = m.pn1 + m.n_loc;
  m.place = m.qf + m.n_loc;
  m.reach = m.place + m.n_cand;
  m.shorts = m.reach + m.n_cand;
  m.debyes = m.shorts + m.n_cand;
  m.res = m.debyes + m.n_cand;
  m.hbf = m.res + K2_RES * K2_THREADS;
  m.total = m.hbf + (pseq ? K2_HBF * m.n_loc : 0);
  return m;
}

__device__ __forceinline__ Body staged_body(const float* s) {
  Body b;
  b.com = v3(s[0], s[1], s[2]);
  b.a1 = v3(s[3], s[4], s[5]);
  b.a2 = v3(s[6], s[7], s[8]);
  b.a3 = v3(s[9], s[10], s[11]);
  b.q[0] = b.q[1] = b.q[2] = b.q[3] = 0.f;
  return b;
}

// A Debye-only pair: body i's and body j's shares of the weighted Debye
// term on the backbone sites (oxDNA2, oxRNA2).
template <int kFam>
__device__ __forceinline__ void debye_pair(const float* P, const Body& bi, const Body& bj, float qq, Grad& gi,
                                           Grad& gj) {
  static_assert(kFam == FAM_DNA2 || kFam == FAM_RNA2, "a family without Debye-Hueckel has no Debye-only pair");
  const float bx = P[P_GEOM + 0], by = P[P_GEOM + 1];
  const V3 v = back_site<kFam>(bx, by, bj) - back_site<kFam>(bx, by, bi);
  const float r = norm(v);
  const V3 g = v * (P[P_GT + 4] * qq * debye(r, P + P_DEBYE).d / r);
  gi.com = -g;
  gj.com = g;
  gi.a1 = -bx * g;
  gj.a1 = bx * g;
  const V3 zero = zero3();
  if constexpr (kFam == FAM_RNA2) {
    gi.a2 = gj.a2 = zero;
    gi.a3 = -by * g;
    gj.a3 = by * g;
  } else {
    gi.a2 = -by * g;
    gj.a2 = by * g;
    gi.a3 = gj.a3 = zero;
  }
}

__device__ __forceinline__ void put_grad(float* res, int k, const Grad& g) {
  const V3 v[4] = {g.com, g.a1, g.a2, g.a3};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    res[(k + 3 * c) * K2_THREADS] = v[c].x;
    res[(k + 3 * c + 1) * K2_THREADS] = v[c].y;
    res[(k + 3 * c + 2) * K2_THREADS] = v[c].z;
  }
}

// The hb weight of staged slots il and jl = il + d (slot j): the table's
// entry of their bases, or under a pseq hw_il . oh_jl plus corr_il where j
// is il's partner.
template <bool kPseq>
__device__ __forceinline__ float band_hb_weight(const float* W_hb, const int* s_seq, const float* s_hbf, int n_loc,
                                                int il, int jl, int j) {
  if constexpr (kPseq) {
    float w = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) w += s_hbf[k * n_loc + il] * s_hbf[(4 + k) * n_loc + jl];
    return s_hbf[9 * n_loc + il] == (float)j ? w + s_hbf[8 * n_loc + il] : w;
  }
  return W_hb[s_seq[il] * 4 + s_seq[jl]];
}

template <int kFam, bool kPseq>
__global__ void __launch_bounds__(K2_THREADS)
    stencil_field_grads_kernel(const float* __restrict__ P_in, const int* __restrict__ seq,
                               const int* __restrict__ partners, const float* __restrict__ qf, int n, int w0, int w1,
                               int w2, int w3, int W, const float* __restrict__ hbf, const float* __restrict__ pos,
                               float* __restrict__ out, int* __restrict__ counts) {
  extern __shared__ float smem[];
  __shared__ float P[P_TOTAL];
  __shared__ int s_warp[K2_WARPS][2];
  __shared__ int s_tally[K2_WARPS][K2_TALLY];
  const K2Smem m = k2_smem(W, kPseq);
  float* s_body = smem + m.body;
  int* s_seq = (int*)(smem + m.seq);
  int* s_pn0 = (int*)(smem + m.pn0);
  int* s_pn1 = (int*)(smem + m.pn1);
  float* s_qf = smem + m.qf;
  int* s_place = (int*)(smem + m.place);  // kept candidate -> its place (short: k, Debye only: -(k + 2)); -1
  int* s_reach = (int*)(smem + m.reach);
  int* s_short = (int*)(smem + m.shorts);  // candidates needing a short-range term, in candidate order
  int* s_debye = (int*)(smem + m.debyes);  // ... and those needing Debye alone
  float* s_res = smem + m.res;             // a batch's pair shares, (K2_RES, K2_THREADS)
  float* s_hbf = smem + m.hbf;             // under a pseq, (K2_HBF, n_loc) hb factors
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * K2_SLOTS, base = t0 - W;  // local slot l is slot base + l
  const int w[4] = {w0, w1, w2, w3};

  // 1. stage the parameters and the slots [t0 - W, t0 + S + W)
  for (int k = tid; k < P_TOTAL; k += K2_THREADS) P[k] = P_in[k];
  for (int l = tid; l < m.n_loc; l += K2_THREADS) {
    const int g = base + l;
    float* b = s_body + l * K2_BODY;
    if (g >= 0 && g < n) {
      const Body bd = body_at(pos, n, g);
      const V3 v[4] = {bd.com, bd.a1, bd.a2, bd.a3};
      for (int c = 0; c < 4; ++c) {
        b[3 * c] = v[c].x;
        b[3 * c + 1] = v[c].y;
        b[3 * c + 2] = v[c].z;
      }
      s_seq[l] = seq[g];
      s_pn0[l] = partners[g];
      s_pn1[l] = partners[n + g];
      s_qf[l] = has_debye<kFam>() ? qf[g] : 0.f;  // oxDNA1 reads no charge factor
      if constexpr (kPseq)
        for (int k = 0; k < K2_HBF; ++k) s_hbf[k * m.n_loc + l] = hbf[(size_t)k * n + g];
    }
  }
  __syncthreads();

  // 2. gate the candidates c = il * W + (d - 1), pair (base + il, base + il + d)
  const unsigned below = (1u << lane) - 1u;
  int n_short = 0, n_debye = 0;
  int tally[K2_TALLY] = {0, 0, 0, 0, 0, 0, 0, 0};  // lane 0's: its warp's band pairs by gate
  for (int c0 = 0; c0 < m.n_cand; c0 += K2_THREADS) {
    const int c = c0 + tid;
    int cls = 0, reach = 0;  // 0 none, 1 short-range, 2 Debye only
    bool counted = false;    // a band pair of an owned i side
    if (c < m.n_cand) {
      const int il = c / W, d = c - il * W + 1, jl = il + d, i = base + il, j = i + d;
      const bool touches = il >= W || (jl >= W && jl < W + K2_SLOTS);  // i owned, or j
      if (touches && i >= 0 && j < n && s_pn0[il] != j && s_pn1[il] != j) {
        reach = band_reach<kFam>(P, staged_body(s_body + il * K2_BODY), staged_body(s_body + jl * K2_BODY), d, w,
                                 W);
        cls = (reach & REACH_SHORT) ? 1 : (reach ? 2 : 0);
        counted = il >= W;  // each band pair once, by the block owning its i side
      }
      s_reach[c] = reach;
    }
    if (counts) {
      const bool in[K2_TALLY] = {counted && (reach & REACH_EXC), counted && (reach & REACH_HB),
                                 counted && (reach & REACH_CROSS), counted && (reach & REACH_COAX),
                                 counted && (reach & REACH_DEBYE), counted && cls == 1,
                                 counted && cls == 2, counted && cls == 0};
      for (int k = 0; k < K2_TALLY; ++k) tally[k] += __popc(__ballot_sync(0xffffffffu, in[k]));
    }
    const unsigned sb = __ballot_sync(0xffffffffu, cls == 1), db = __ballot_sync(0xffffffffu, cls == 2);
    if (lane == 0) {
      s_warp[warp][0] = __popc(sb);
      s_warp[warp][1] = __popc(db);
    }
    __syncthreads();
    int so = n_short, dO = n_debye;
    for (int v = 0; v < warp; ++v) {
      so += s_warp[v][0];
      dO += s_warp[v][1];
    }
    if (c < m.n_cand) {
      int place = -1;
      if (cls == 1) {
        place = so + __popc(sb & below);
        s_short[place] = c;
      } else if (cls == 2) {
        const int k = dO + __popc(db & below);
        s_debye[k] = c;
        place = -(k + 2);
      }
      s_place[c] = place;
    }
    for (int v = 0; v < K2_WARPS; ++v) {
      n_short += s_warp[v][0];
      n_debye += s_warp[v][1];
    }
    __syncthreads();  // before s_warp is written again
  }
  if (counts && lane == 0)
    for (int k = 0; k < K2_TALLY; ++k) s_tally[warp][k] = tally[k];

  // 3-4. the kept pairs in batches, short-range first; each batch's shares
  // added into the owned slots' sums in a fixed order
  const int n_kept = n_short + n_debye;
  const int sum_s = tid >> 2, sum_v = tid & 3;  // the owned slot and the vector this thread adds up
  V3 acc = zero3();
  const float* W_hb = P + P_HB + 39;
  for (int b0 = 0; b0 < n_kept; b0 += K2_THREADS) {
    const int p = b0 + tid;
    if (p < n_kept) {
      const bool is_short = p < n_short;
      const int c = is_short ? s_short[p] : s_debye[p - n_short];
      const int il = c / W, d = c - il * W + 1, jl = il + d;
      const Body bi = staged_body(s_body + il * K2_BODY), bj = staged_body(s_body + jl * K2_BODY);
      const float qq = s_qf[il] * s_qf[jl];
      Grad gi = zero_grad(), gj = zero_grad();
      if (is_short) {
        unbonded_pair_terms<true, kFam, true>(P, bi, bj,
                                              band_hb_weight<kPseq>(W_hb, s_seq, s_hbf, m.n_loc, il, jl, base + jl),
                                              qq, d, w, W, s_reach[c], false, gi, nullptr, &gj);
      } else if constexpr (has_debye<kFam>()) {
        debye_pair<kFam>(P, bi, bj, qq, gi, gj);
      }
      put_grad(s_res + tid, 0, gi);
      put_grad(s_res + tid, 12, gj);
    }
    __syncthreads();
    if (sum_s < K2_SLOTS) {
      const int b1 = min(b0 + K2_THREADS, n_kept);
      const int own = W + sum_s;
      for (int d = 1; d <= W; ++d) {
        // i-side share of (t, t + d), then the j-side share of (t - d, t)
        const int ci = own * W + (d - 1), cj = (own - d) * W + (d - 1);
        int pi = s_place[ci], pj = s_place[cj];
        pi = pi < -1 ? n_short - pi - 2 : pi;
        pj = pj < -1 ? n_short - pj - 2 : pj;
        if (pi >= b0 && pi < b1) {
          const float* r = s_res + (3 * sum_v) * K2_THREADS + (pi - b0);
          acc += v3(r[0], r[K2_THREADS], r[2 * K2_THREADS]);
        }
        if (pj >= b0 && pj < b1) {
          const float* r = s_res + (12 + 3 * sum_v) * K2_THREADS + (pj - b0);
          acc += v3(r[0], r[K2_THREADS], r[2 * K2_THREADS]);
        }
      }
    }
    __syncthreads();  // before s_res is written again
  }

  // the owned slots' cotangents to d/dquat
  float* s_grad = s_res;  // (K2_SLOTS, 12)
  if (sum_s < K2_SLOTS) {
    float* g = s_grad + sum_s * 12 + 3 * sum_v;
    g[0] = acc.x;
    g[1] = acc.y;
    g[2] = acc.z;
  }
  __syncthreads();
  const int t = t0 + tid;
  if (tid < K2_SLOTS && t < n) {
    const float* g = s_grad + tid * 12;
    Grad gr;
    gr.com = v3(g[0], g[1], g[2]);
    gr.a1 = v3(g[3], g[4], g[5]);
    gr.a2 = v3(g[6], g[7], g[8]);
    gr.a3 = v3(g[9], g[10], g[11]);
    const float q[4] = {pos[3 * n + t], pos[4 * n + t], pos[5 * n + t], pos[6 * n + t]};
    float gq[4];
    frame_vjp(q, gr, gq);
    out[t] = gr.com.x;
    out[n + t] = gr.com.y;
    out[2 * n + t] = gr.com.z;
    for (int k = 0; k < 4; ++k) out[(3 + k) * n + t] = gq[k];
  }
  if (counts && tid < K2_TALLY) {
    int total = 0;
    for (int v = 0; v < K2_WARPS; ++v) total += s_tally[v][tid];
    counts[(size_t)blockIdx.x * K2_TALLY + tid] = total;
  }
}

template <int kFam, bool kPseq = false>
static int launch_field_grads(const float* params, const int* seq, const int* partners, const float* qf, int n,
                              int w0, int w1, int w2, int w3, int w_wide, const float* hbf, const float* dyn,
                              float* out, int* counts, void* stream) {
  if (n < 1 || w_wide < 1 || (kPseq && !hbf)) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)k2_smem(w_wide, kPseq).total * sizeof(float);
  static size_t allowed = 0;  // the dynamic shared memory this instance was allowed so far
  if (bytes > allowed) {
    const cudaError_t rc = cudaFuncSetAttribute(stencil_field_grads_kernel<kFam, kPseq>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
    allowed = bytes;
  }
  const int grid = (n + K2_SLOTS - 1) / K2_SLOTS;
  stencil_field_grads_kernel<kFam, kPseq><<<grid, K2_THREADS, bytes, (cudaStream_t)stream>>>(
      params, seq, partners, qf, n, w0, w1, w2, w3, w_wide, hbf, dyn, out, counts);
  return (int)cudaGetLastError();
}

// blocks of K2 for n slots: the rows of its (blocks, K2_TALLY) tally
extern "C" int stencil_field_grads_blocks(int n) { return (n + K2_SLOTS - 1) / K2_SLOTS; }

// counts: (stencil_field_grads_blocks(n), K2_TALLY) int32 or null (each
// block's tally)
extern "C" int stencil_field_grads(const float* params, const int* seq, const int* partners, const float* qf,
                                   int n, int w0, int w1, int w2, int w3, int w_wide, const float* dyn, float* out,
                                   int* counts, void* stream) {
  return launch_field_grads<FAM_DNA2>(params, seq, partners, qf, n, w0, w1, w2, w3, w_wide, nullptr, dyn, out,
                                      counts, stream);
}

extern "C" int stencil_field_grads_rna2(const float* params, const int* seq, const int* partners, const float* qf,
                                        int n, int w0, int w1, int w2, int w3, int w_wide, const float* dyn,
                                        float* out, int* counts, void* stream) {
  return launch_field_grads<FAM_RNA2>(params, seq, partners, qf, n, w0, w1, w2, w3, w_wide, nullptr, dyn, out,
                                      counts, stream);
}

extern "C" int stencil_field_grads_dna1(const float* params, const int* seq, const int* partners, const float* qf,
                                        int n, int w0, int w1, int w2, int w3, int w_wide, const float* dyn,
                                        float* out, int* counts, void* stream) {
  return launch_field_grads<FAM_DNA1>(params, seq, partners, qf, n, w0, w1, w2, w3, w_wide, nullptr, dyn, out,
                                      counts, stream);
}

// The pseq instances: the discrete entries' arguments with hbf, (10, n)
// slot-order hb factors, before dyn (seq is not read).
extern "C" int stencil_field_grads_pseq(const float* params, const int* seq, const int* partners, const float* qf,
                                        int n, int w0, int w1, int w2, int w3, int w_wide, const float* hbf,
                                        const float* dyn, float* out, int* counts, void* stream) {
  return launch_field_grads<FAM_DNA2, true>(params, seq, partners, qf, n, w0, w1, w2, w3, w_wide, hbf, dyn, out,
                                            counts, stream);
}

extern "C" int stencil_field_grads_rna2_pseq(const float* params, const int* seq, const int* partners,
                                             const float* qf, int n, int w0, int w1, int w2, int w3, int w_wide,
                                             const float* hbf, const float* dyn, float* out, int* counts,
                                             void* stream) {
  return launch_field_grads<FAM_RNA2, true>(params, seq, partners, qf, n, w0, w1, w2, w3, w_wide, hbf, dyn, out,
                                            counts, stream);
}

extern "C" int stencil_field_grads_dna1_pseq(const float* params, const int* seq, const int* partners,
                                             const float* qf, int n, int w0, int w1, int w2, int w3, int w_wide,
                                             const float* hbf, const float* dyn, float* out, int* counts,
                                             void* stream) {
  return launch_field_grads<FAM_DNA1, true>(params, seq, partners, qf, n, w0, w1, w2, w3, w_wide, hbf, dyn, out,
                                            counts, stream);
}
