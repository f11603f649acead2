// Per-slot oxDNA2 stencil physics shared by the K1 and K2 kernels.
//
// Every function here is written for ONE slot t and reads the positions of
// its band neighbours from global memory, so a kernel is one thread per
// slot. Functions are __host__ __device__ so that the same arithmetic can be
// compiled for the CPU as well; the kernels live in stencil_grads.cu (K2)
// and multistep.cu (K1).
//
// Derivatives are written by hand (the Pallas kernels differentiate their
// scalar chains with jax.vjp in-kernel): every smoothed base function
// returns its value and its derivative (VD), cosines are pulled back to the
// frame vectors and pair displacements with the chain rule, site gradients
// to (com, a1, a2, a3), and the frame cotangent to d/dquat (frame_vjp) and
// to the body torque (torque_of). The plain PyTorch twins in ops/stencil.py
// get the same gradients from torch.autograd, an independent check.
//
// Positions: `pos` holds the rows com.x, com.y, com.z, q.w, q.x, q.y, q.z
// of n slots each (row stride n), as the (7, n) K2 input or the first 7
// rows of the (20, n) K1 state.
//
// The parameter vector (P_* offsets below) is built by
// ops/stencil.py::pack_params from PARAM_GROUPS, in the same order.
// Group layouts: f1/f2 = r_low, r_high, r_c_low, r_c_high, a|k, r0, r_c,
// b_low, b_high; f3 = r_star, sigma, b, r_c; f4 = theta0,
// delta_theta_star, delta_theta_c, a, b; f5 = x_star, x_c, a, b.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define HD static __host__ __device__ __forceinline__
#else
#define HD static inline
#endif

// parameter groups (offsets into the flat vector)
#define P_EXC 0      // eps_exc; f3 x4: base, back_base, base_back, backbone
#define P_HB 17      // f1; f4 x6: angles 1, 2, 3, 4, 7, 8; 4x4 weights at +39
#define P_CROSS 72   // f2; f4 x6: angles 1, 2, 3, 4, 7, 8
#define P_COAX 111   // f2; f4 x4: angles 4, 1, 5, 6; f6 a at +29, theta0 at +30
#define P_DEBYE 142  // kappa, prefactor, smoothing_coeff, r_cut, r_high
#define P_FENE 147   // eps, r0, delta, fmax, finf
#define P_BEXC 152   // eps_exc; f3 x3: base, back_base, base_back
#define P_STACK 165  // f1; f4 x3: angles 4, 5, 6; f5 cosphi1 at +24, cosphi2 at +28
#define P_GEOM 197   // back a1, back a2, base a1, stack a1, dna1 back a1 offsets
#define P_GT 202     // term weights: exc, hb, cross, coax, debye, fene, bexc, stack
#define P_TOTAL 210

#define PI_F 3.14159265358979323846f

struct V3 {
  float x, y, z;
};

HD V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
HD V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
HD V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
HD V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
HD V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
HD V3 operator*(float s, V3 a) { return v3(a.x * s, a.y * s, a.z * s); }
HD void operator+=(V3& a, V3 b) { a = a + b; }
HD void operator-=(V3& a, V3 b) { a = a - b; }
HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
HD float norm(V3 a) { return sqrtf(dot(a, a) + 1e-18f); }
HD V3 zero3() { return v3(0.f, 0.f, 0.f); }
HD V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// value and derivative of a scalar function
struct VD {
  float v, d;
};
HD VD vd(float v, float d) {
  VD r;
  r.v = v;
  r.d = d;
  return r;
}

// one slot: center, frame and quaternion
struct Body {
  V3 com, a1, a2, a3;
  float q[4];
};

// dE/d(com, a1, a2, a3) of one slot
struct Grad {
  V3 com, a1, a2, a3;
};

HD Grad zero_grad() {
  Grad g;
  g.com = g.a1 = g.a2 = g.a3 = zero3();
  return g;
}

HD Body body_at(const float* pos, int n, int i) {
  Body b;
  b.com = v3(pos[i], pos[n + i], pos[2 * n + i]);
  float w = pos[3 * n + i], x = pos[4 * n + i], y = pos[5 * n + i], z = pos[6 * n + i];
  b.q[0] = w;
  b.q[1] = x;
  b.q[2] = y;
  b.q[3] = z;
  float q00 = w * w, q11 = x * x, q22 = y * y, q33 = z * z;
  float q01 = w * x, q02 = w * y, q03 = w * z, q12 = x * y, q13 = x * z, q23 = y * z;
  b.a1 = v3(q00 + q11 - q22 - q33, 2.f * (q12 + q03), 2.f * (q13 - q02));
  b.a2 = v3(2.f * (q12 - q03), q00 - q11 + q22 - q33, 2.f * (q23 + q01));
  b.a3 = v3(2.f * (q13 + q02), 2.f * (q23 - q01), q00 - q11 - q22 + q33);
  return b;
}

// Abramowitz & Stegun 4.4.45 polynomial arccos, clamped 8 ulps inside
// (-1, 1) with zero derivative outside (utils/math.py::arccos_poly)
HD VD acos_poly(float x) {
  const float eps = 8.f * 1.1920928955078125e-07f;
  float xc = x, dx = 1.f;
  if (x >= 1.f - eps) {
    xc = 1.f - eps;
    dx = 0.f;
  } else if (x <= -1.f + eps) {
    xc = -1.f + eps;
    dx = 0.f;
  }
  float a = xc < 0.f ? -xc : xc;
  const float c[8] = {-0.0012624911f, 0.0066700901f, -0.0170881256f, 0.0308918810f,
                      -0.0501743046f, 0.0889789874f, -0.2145988016f, 1.5707963050f};
  float p = c[0], dp = 0.f;
  for (int k = 1; k < 8; ++k) {
    dp = dp * a + p;
    p = p * a + c[k];
  }
  float s = sqrtf(1.f - a);
  float r = s * p;
  // d/dxc of (xc < 0 ? pi - r(-xc) : r(xc)) is dr/da on both branches
  float dr_da = -p / (2.f * s) + s * dp;
  return vd(xc < 0.f ? PI_F - r : r, dr_da * dx);
}

// f1: Morse radial with smoothed tails (energy/functions.py::f1)
HD VD f1(float r, const float* g, float eps) {
  float r_low = g[0], r_high = g[1], r_c_low = g[2], r_c_high = g[3];
  float a = g[4], r0 = g[5], r_c = g[6], b_low = g[7], b_high = g[8];
  if (r_low < r && r < r_high) {
    float e = expf(-(r - r0) * a), ec = expf(-(r_c - r0) * a);
    return vd(eps * ((1.f - e) * (1.f - e) - (1.f - ec) * (1.f - ec)), 2.f * eps * a * e * (1.f - e));
  }
  if (r_c_low < r && r < r_low) {
    float t = r_c_low - r;
    return vd(eps * b_low * t * t, -2.f * eps * b_low * t);
  }
  if (r_high < r && r < r_c_high) {
    float t = r_c_high - r;
    return vd(eps * b_high * t * t, -2.f * eps * b_high * t);
  }
  return vd(0.f, 0.f);
}

// f2: harmonic radial with smoothed tails
HD VD f2(float r, const float* g) {
  float r_low = g[0], r_high = g[1], r_c_low = g[2], r_c_high = g[3];
  float k = g[4], r0 = g[5], r_c = g[6], b_low = g[7], b_high = g[8];
  if (r_low < r && r < r_high) {
    return vd(0.5f * k * ((r - r0) * (r - r0) - (r_c - r0) * (r_c - r0)), k * (r - r0));
  }
  if (r_c_low < r && r < r_low) {
    float t = r_c_low - r;
    return vd(k * b_low * t * t, -2.f * k * b_low * t);
  }
  if (r_high < r && r < r_c_high) {
    float t = r_c_high - r;
    return vd(k * b_high * t * t, -2.f * k * b_high * t);
  }
  return vd(0.f, 0.f);
}

// f3 with the radius floored at 1e-2 (dna1/terms.py::exc_vol_f3)
HD VD exc_f3(float r, float eps, const float* g) {
  float r_star = g[0], sigma = g[1], b = g[2], r_c = g[3];
  bool floored = r < 1e-2f;
  float x = floored ? 1e-2f : r;
  VD out = vd(0.f, 0.f);
  if (x < r_star) {
    float s = sigma / x, s2 = s * s, s6 = s2 * s2 * s2, s12 = s6 * s6;
    out = vd(4.f * eps * (s12 - s6), 4.f * eps * (-12.f * s12 + 6.f * s6) / x);
  } else if (r_star < x && x < r_c) {
    float t = r_c - x;
    out = vd(eps * b * t * t, -2.f * eps * b * t);
  }
  if (floored) out.d = 0.f;
  return out;
}

// f4: angular modulation
HD VD f4(float th, const float* g) {
  float t0 = g[0], dts = g[1], dtc = g[2], a = g[3], b = g[4];
  if (t0 - dts < th && th < t0 + dts) {
    float u = th - t0;
    return vd(1.f - a * u * u, -2.f * a * u);
  }
  if (t0 - dtc < th && th < t0 - dts) {
    float u = t0 - dtc - th;
    return vd(b * u * u, -2.f * b * u);
  }
  if (t0 + dts < th && th < t0 + dtc) {
    float u = t0 + dtc - th;
    return vd(b * u * u, -2.f * b * u);
  }
  return vd(0.f, 0.f);
}

// f4(t) + f4(pi - t): the symmetrized modulations of cross/coax stacking
HD VD f4_sym(float th, const float* g) {
  VD a = f4(th, g), b = f4(PI_F - th, g);
  return vd(a.v + b.v, a.d - b.d);
}

// f5: one-sided modulation
HD VD f5(float x, const float* g) {
  float x_star = g[0], x_c = g[1], a = g[2], b = g[3];
  if (x > 0.f) return vd(1.f, 0.f);
  if (x_star < x && x < 0.f) return vd(1.f - a * x * x, -2.f * a * x);
  if (x_c < x && x < x_star) {
    float u = x_c - x;
    return vd(b * u * u, -2.f * b * u);
  }
  return vd(0.f, 0.f);
}

// f6: one-sided quadratic (oxDNA2 coax theta1)
HD VD f6(float th, float a, float t0) {
  if (th > t0) return vd(0.5f * a * (th - t0) * (th - t0), a * (th - t0));
  return vd(0.f, 0.f);
}

// Debye-Hueckel with quadratic smoothing to r_cut (dna2/terms.py)
HD VD debye(float r, const float* g) {
  float kappa = g[0], pref = g[1], sc = g[2], r_cut = g[3], r_high = g[4];
  if (!(r < r_cut)) return vd(0.f, 0.f);
  if (r < r_high) {
    bool floored = r < 1e-8f;
    float rs = floored ? 1e-8f : r;
    float v = expf(-kappa * rs) * (pref / rs);
    return vd(v, floored ? 0.f : -v * (kappa + 1.f / rs));
  }
  float t = r - r_cut;
  return vd(sc * t * t, 2.f * sc * t);
}

// dE/dr of the smoothed FENE spring (dna1/terms.py::v_fene_smooth)
HD float fene_dr(float r, const float* g) {
  float eps = g[0], r0 = g[1], delt = g[2], fmax = g[3], finf = g[4];
  float dr = r - r0;
  float diff = sqrtf(dr * dr + 1e-10f);
  float xmax = (-eps + sqrtf(eps * eps + 4.f * fmax * fmax * delt * delt)) / (2.f * fmax);
  float de;
  if (diff > xmax) {
    de = (fmax - finf) * xmax / diff + finf;
  } else {
    float x2 = diff * diff / (delt * delt);
    de = x2 < 0.99999f ? eps * diff / (delt * delt * (1.f - x2)) : 0.f;
  }
  return de * dr / diff;
}

// d(prod_k F_k)/dF_k = prod of the others, without division
template <int N>
HD void prod_others(const float* f, float* out) {
  float pre[N + 1];
  pre[0] = 1.f;
  for (int k = 0; k < N; ++k) pre[k + 1] = pre[k] * f[k];
  float suf = 1.f;
  for (int k = N - 1; k >= 0; --k) {
    out[k] = pre[k] * suf;
    suf *= f[k];
  }
}

// dE/dr of r = |v| (v = site_j - site_i) onto the two site gradients
HD void dist_grad(V3 v, float r, float g_r, V3& g_si, V3& g_sj) {
  V3 g = v * (g_r / r);
  g_sj += g;
  g_si -= g;
}

// pull a gradient on the unit vector u = v / r back to v
HD V3 unit_vjp(V3 g_u, V3 u, float r) { return (g_u - dot(g_u, u) * u) * (1.f / r); }

// Site gradients of one pair; `side_j` selects which body receives them.
struct PairSites {
  V3 back_i, back_j, base_i, base_j, stack_i, stack_j, dna1_i, dna1_j;
  V3 a1_i, a1_j, a2_i, a2_j, a3_i, a3_j;
};

HD void add_side(const float* P, const PairSites& g, bool side_j, Grad& acc) {
  float bx = P[P_GEOM + 0], by = P[P_GEOM + 1], hbo = P[P_GEOM + 2], sto = P[P_GEOM + 3], bd1 = P[P_GEOM + 4];
  V3 back = side_j ? g.back_j : g.back_i;
  V3 base = side_j ? g.base_j : g.base_i;
  V3 stack = side_j ? g.stack_j : g.stack_i;
  V3 dna1 = side_j ? g.dna1_j : g.dna1_i;
  acc.com += back + base + stack + dna1;
  acc.a1 += bx * back + hbo * base + sto * stack + bd1 * dna1 + (side_j ? g.a1_j : g.a1_i);
  acc.a2 += by * back + (side_j ? g.a2_j : g.a2_i);
  acc.a3 += side_j ? g.a3_j : g.a3_i;
}

HD PairSites zero_sites() {
  PairSites g;
  g.back_i = g.back_j = g.base_i = g.base_j = g.stack_i = g.stack_j = g.dna1_i = g.dna1_j = zero3();
  g.a1_i = g.a1_j = g.a2_i = g.a2_j = g.a3_i = g.a3_j = zero3();
  return g;
}

// Unbonded pair (i, j = i + d): gradient of the weighted excluded volume,
// HB, cross stacking, coax and Debye energies, each term only within its
// reach (w[0..3] for exc, hb, cross, coax; Debye out to w_wide). Adds body
// i's (side_j false) or body j's (side_j true) share to `acc`.
HD void unbonded_pair(const float* P, const Body& bi, const Body& bj, float w_hb, float qq, int d,
                      const int* w, int w_wide, bool side_j, Grad& acc) {
  float bx = P[P_GEOM + 0], by = P[P_GEOM + 1], hbo = P[P_GEOM + 2], sto = P[P_GEOM + 3];
  PairSites g = zero_sites();
  V3 back_i = bi.com + bx * bi.a1 + by * bi.a2, back_j = bj.com + bx * bj.a1 + by * bj.a2;
  V3 base_i = bi.com + hbo * bi.a1, base_j = bj.com + hbo * bj.a1;

  V3 v_bb = back_j - back_i;
  float r_bb = norm(v_bb), g_rbb = 0.f;
  if (d <= w[0]) {
    const float* E = P + P_EXC;
    float gt = P[P_GT + 0], eps = E[0];
    V3 v_ee = base_j - base_i, v_eb = base_j - back_i, v_be = back_j - base_i;
    float r_ee = norm(v_ee), r_eb = norm(v_eb), r_be = norm(v_be);
    dist_grad(v_ee, r_ee, gt * exc_f3(r_ee, eps, E + 1).d, g.base_i, g.base_j);
    dist_grad(v_eb, r_eb, gt * exc_f3(r_eb, eps, E + 5).d, g.back_i, g.base_j);
    dist_grad(v_be, r_be, gt * exc_f3(r_be, eps, E + 9).d, g.base_i, g.back_j);
    g_rbb += gt * exc_f3(r_bb, eps, E + 13).d;
  }
  if (d <= w_wide) g_rbb += P[P_GT + 4] * qq * debye(r_bb, P + P_DEBYE).d;
  dist_grad(v_bb, r_bb, g_rbb, g.back_i, g.back_j);

  if (d <= w[1] || d <= w[2]) {
    V3 v = base_j - base_i;
    float r = norm(v);
    V3 u = v * (1.f / r);
    // cosines of angles 1, 2, 3, 4, 7, 8
    float c[6] = {-dot(bi.a1, bj.a1), -dot(bj.a1, u), dot(bi.a1, u),
                  dot(bi.a3, bj.a3),  -dot(bj.a3, u), dot(bi.a3, u)};
    VD th[6];
    for (int k = 0; k < 6; ++k) th[k] = acos_poly(c[k]);
    th[5] = vd(PI_F - th[5].v, -th[5].d);  // theta8 = pi - acos(c8)
    float gc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, g_r = 0.f;
    bool rfloor = r < 1e-8f;
    float rr = rfloor ? 1e-8f : r;
    float F[7], dF[7], O[7];
    if (d <= w[1]) {
      VD fr = f1(rr, P + P_HB, 1.f);
      F[0] = fr.v;
      dF[0] = rfloor ? 0.f : fr.d;
      for (int k = 0; k < 6; ++k) {
        VD f = f4(th[k].v, P + P_HB + 9 + 5 * k);
        F[k + 1] = f.v;
        dF[k + 1] = f.d * th[k].d;
      }
      prod_others<7>(F, O);
      float s = P[P_GT + 1] * w_hb;
      g_r += s * dF[0] * O[0];
      for (int k = 0; k < 6; ++k) gc[k] += s * dF[k + 1] * O[k + 1];
    }
    if (d <= w[2]) {
      VD fr = f2(rr, P + P_CROSS);
      F[0] = fr.v;
      dF[0] = rfloor ? 0.f : fr.d;
      for (int k = 0; k < 6; ++k) {
        VD f = k < 3 ? f4(th[k].v, P + P_CROSS + 9 + 5 * k) : f4_sym(th[k].v, P + P_CROSS + 9 + 5 * k);
        F[k + 1] = f.v;
        dF[k + 1] = f.d * th[k].d;
      }
      prod_others<7>(F, O);
      float s = P[P_GT + 2];
      g_r += s * dF[0] * O[0];
      for (int k = 0; k < 6; ++k) gc[k] += s * dF[k + 1] * O[k + 1];
    }
    g.a1_i += -gc[0] * bj.a1 + gc[2] * u;
    g.a1_j += -gc[0] * bi.a1 - gc[1] * u;
    g.a3_i += gc[3] * bj.a3 + gc[5] * u;
    g.a3_j += gc[3] * bi.a3 - gc[4] * u;
    V3 g_u = -gc[1] * bj.a1 + gc[2] * bi.a1 - gc[4] * bj.a3 + gc[5] * bi.a3;
    V3 gv = unit_vjp(g_u, u, r) + g_r * u;
    g.base_j += gv;
    g.base_i -= gv;
  }

  if (d <= w[3]) {
    V3 stack_i = bi.com + sto * bi.a1, stack_j = bj.com + sto * bj.a1;
    V3 v = stack_j - stack_i;
    float r = norm(v);
    V3 u = v * (1.f / r);
    // cosines of angles 1, 4, 5, 6
    VD t1 = acos_poly(-dot(bi.a1, bj.a1)), t4 = acos_poly(dot(bi.a3, bj.a3));
    VD t5 = acos_poly(dot(bi.a3, u)), t6 = acos_poly(-dot(bj.a3, u));
    const float* C = P + P_COAX;
    bool rfloor = r < 1e-8f;
    VD fr = f2(rfloor ? 1e-8f : r, C);
    VD m4 = f4(t4.v, C + 9);
    VD m1 = f4(t1.v, C + 14), m6 = f6(t1.v, C[29], C[30]);
    VD m5 = f4_sym(t5.v, C + 19), m6s = f4_sym(t6.v, C + 24);
    float F[5] = {fr.v, m4.v, m1.v + m6.v, m5.v, m6s.v}, O[5];
    prod_others<5>(F, O);
    float s = P[P_GT + 3];
    float g_r = rfloor ? 0.f : s * fr.d * O[0];
    float g4 = s * m4.d * t4.d * O[1];
    float g1 = s * (m1.d + m6.d) * t1.d * O[2];
    float g5 = s * m5.d * t5.d * O[3];
    float g6 = s * m6s.d * t6.d * O[4];
    g.a1_i += -g1 * bj.a1;
    g.a1_j += -g1 * bi.a1;
    g.a3_i += g4 * bj.a3 + g5 * u;
    g.a3_j += g4 * bi.a3 - g6 * u;
    V3 gv = unit_vjp(g5 * bi.a3 - g6 * bj.a3, u, r) + g_r * u;
    g.stack_j += gv;
    g.stack_i -= gv;
  }
  add_side(P, g, side_j, acc);
}

// Bonded pair (i, j = i + 2) with direction flag dirf (+1: i is the
// 3'-side): FENE on the backbone sites, bonded excluded volume, and
// stacking against the dna1-compatible backbone site (ops/stencil.py::
// bonded_energy). Adds one body's share to `acc`.
HD void bonded_pair(const float* P, const Body& bi, const Body& bj, float dirf, float wstack, bool side_j,
                    Grad& acc) {
  float bx = P[P_GEOM + 0], by = P[P_GEOM + 1], hbo = P[P_GEOM + 2], sto = P[P_GEOM + 3], bd1 = P[P_GEOM + 4];
  bool pos = dirf > 0.f;
  PairSites g = zero_sites();
  V3 back_i = bi.com + bx * bi.a1 + by * bi.a2, back_j = bj.com + bx * bj.a1 + by * bj.a2;
  V3 base_i = bi.com + hbo * bi.a1, base_j = bj.com + hbo * bj.a1;

  // FENE
  V3 v = back_j - back_i;
  float r = norm(v);
  dist_grad(v, r, P[P_GT + 5] * fene_dr(r, P + P_FENE), g.back_i, g.back_j);

  // bonded excluded volume: base-base, back(3')-base(5'), base(3')-back(5')
  const float* B = P + P_BEXC;
  float gx = P[P_GT + 6], eps = B[0];
  V3 vee = base_j - base_i;
  float ree = norm(vee);
  dist_grad(vee, ree, gx * exc_f3(ree, eps, B + 1).d, g.base_i, g.base_j);
  V3 vu = base_j - back_i, vv = back_j - base_i;
  float ru = norm(vu), rv = norm(vv);
  dist_grad(vu, ru, gx * exc_f3(ru, eps, B + (pos ? 5 : 9)).d, g.back_i, g.base_j);
  dist_grad(vv, rv, gx * exc_f3(rv, eps, B + (pos ? 9 : 5)).d, g.base_i, g.back_j);

  // stacking
  const float* S = P + P_STACK;
  float sgn = pos ? -1.f : 1.f;
  V3 t_st = (bj.com + sto * bj.a1) - (bi.com + sto * bi.a1);
  float r_st = norm(t_st);
  V3 uh = t_st * (1.f / r_st), ust = sgn * uh;
  V3 t_bk = (bj.com + bd1 * bj.a1) - (bi.com + bd1 * bi.a1);
  float r_bk = norm(t_bk);
  V3 ubh = t_bk * (1.f / r_bk), ubk = sgn * ubh;
  V3 n3 = sel(pos, bi.a3, bj.a3), n5 = sel(pos, bj.a3, bi.a3);
  V3 a2_3 = sel(pos, bi.a2, bj.a2), a2_5 = sel(pos, bj.a2, bi.a2);
  VD t4 = acos_poly(dot(n3, n5));
  VD t5 = acos_poly(dot(n5, ust)), t6 = acos_poly(dot(n3, ust));
  t5 = vd(PI_F - t5.v, -t5.d);
  t6 = vd(PI_F - t6.v, -t6.d);
  VD fr = f1(r_st, S, 1.f), m4 = f4(t4.v, S + 9), m5 = f4(t5.v, S + 14), m6 = f4(t6.v, S + 19);
  VD p1 = f5(dot(a2_3, ubk), S + 24), p2 = f5(dot(a2_5, ubk), S + 28);  // f5(-cosphi)
  float F[6] = {fr.v, m4.v, m5.v, m6.v, p1.v, p2.v}, O[6];
  prod_others<6>(F, O);
  float s = P[P_GT + 7] * wstack;
  float g_r = s * fr.d * O[0];
  float g4 = s * m4.d * t4.d * O[1], g5 = s * m5.d * t5.d * O[2], g6 = s * m6.d * t6.d * O[3];
  float gp1 = s * p1.d * O[4], gp2 = s * p2.d * O[5];  // d/d(a2 . ubk)
  V3 gn3 = g4 * n5 + g6 * ust, gn5 = g4 * n3 + g5 * ust;
  V3 g_ust = g5 * n5 + g6 * n3;
  V3 g_ubk = gp1 * a2_3 + gp2 * a2_5;
  V3 ga2_3 = gp1 * ubk, ga2_5 = gp2 * ubk;
  V3 gst = sgn * unit_vjp(g_ust, uh, r_st) + g_r * uh;
  g.stack_j += gst;
  g.stack_i -= gst;
  V3 gbk = sgn * unit_vjp(g_ubk, ubh, r_bk);
  g.dna1_j += gbk;
  g.dna1_i -= gbk;
  if (pos) {
    g.a3_i += gn3;
    g.a3_j += gn5;
    g.a2_i += ga2_3;
    g.a2_j += ga2_5;
  } else {
    g.a3_j += gn3;
    g.a3_i += gn5;
    g.a2_j += ga2_3;
    g.a2_i += ga2_5;
  }
  add_side(P, g, side_j, acc);
}

// Gather form of the band: slot t evaluates every pair it belongs to, as
// the i-side of (t, t+d) and as the j-side of (t-d, t), and keeps only its
// own share (twice the pair arithmetic, no atomics, no cross-block order).
HD Grad slot_unbonded_grad(int t, const float* P, const float* pos, const int* seq, const int* partners,
                           const float* qf, int n, const int* w, int w_wide) {
  Grad acc = zero_grad();
  Body bt = body_at(pos, n, t);
  const float* W = P + P_HB + 39;
  for (int d = 1; d <= w_wide; ++d) {
    int j = t + d;
    if (j < n && partners[t] != j && partners[n + t] != j) {
      Body bj = body_at(pos, n, j);
      unbonded_pair(P, bt, bj, W[seq[t] * 4 + seq[j]], qf[t] * qf[j], d, w, w_wide, false, acc);
    }
    int i = t - d;
    if (i >= 0 && partners[i] != t && partners[n + i] != t) {
      Body bi = body_at(pos, n, i);
      unbonded_pair(P, bi, bt, W[seq[i] * 4 + seq[t]], qf[i] * qf[t], d, w, w_wide, true, acc);
    }
  }
  return acc;
}

HD void slot_bonded_grad(int t, const float* P, const float* pos, const float* wstack, const float* dirf, int n,
                         Grad& acc) {
  Body bt = body_at(pos, n, t);
  if (t + 2 < n && dirf[t] != 0.f) bonded_pair(P, bt, body_at(pos, n, t + 2), dirf[t], wstack[t], false, acc);
  if (t >= 2 && dirf[t - 2] != 0.f)
    bonded_pair(P, body_at(pos, n, t - 2), bt, dirf[t - 2], wstack[t - 2], true, acc);
}

// d/dquat of the frame cotangent (transpose of the quaternion -> frame map)
HD void frame_vjp(const float* q, const Grad& g, float* gq) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  V3 A = g.a1, B = g.a2, C = g.a3;
  gq[0] = 2.f * (A.x * w + A.y * z - A.z * y - B.x * z + B.y * w + B.z * x + C.x * y - C.y * x + C.z * w);
  gq[1] = 2.f * (A.x * x + A.y * y + A.z * z + B.x * y - B.y * x + B.z * w + C.x * z - C.y * w - C.z * x);
  gq[2] = 2.f * (-A.x * y + A.y * x - A.z * w + B.x * x + B.y * y + B.z * z + C.x * w + C.y * z - C.z * y);
  gq[3] = 2.f * (-A.x * z + A.y * w + A.z * x - B.x * w - B.y * z + B.z * y + C.x * x + C.y * y + C.z * z);
}

// body torque -0.5 vec(conj(q) * dE/dq)
HD V3 torque_of(const float* q, const float* gq) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  return v3(-0.5f * (w * gq[1] - x * gq[0] - y * gq[3] + z * gq[2]),
            -0.5f * (w * gq[2] + x * gq[3] - y * gq[0] - z * gq[1]),
            -0.5f * (w * gq[3] - x * gq[2] + y * gq[1] - z * gq[0]));
}

// exact NO_SQUISH free rotor for time dt (soa.py::free_rotor_soa)
HD void free_rotor(float* q, float* L, const float* inv_i, float dt) {
  const int axes[5] = {2, 1, 0, 1, 2};
  const float fracs[5] = {0.5f, 0.5f, 1.f, 0.5f, 0.5f};
  for (int st = 0; st < 5; ++st) {
    int ax = axes[st];
    float phi = (dt * fracs[st]) * L[ax] * inv_i[ax];
    float c = cosf(0.5f * phi), s = sinf(0.5f * phi);
    float w = q[0], x = q[1], y = q[2], z = q[3];
    if (ax == 0) {
      q[0] = w * c - x * s;
      q[1] = w * s + x * c;
      q[2] = y * c + z * s;
      q[3] = z * c - y * s;
    } else if (ax == 1) {
      q[0] = w * c - y * s;
      q[1] = x * c - z * s;
      q[2] = w * s + y * c;
      q[3] = z * c + x * s;
    } else {
      q[0] = w * c - z * s;
      q[1] = x * c + y * s;
      q[2] = y * c - x * s;
      q[3] = w * s + z * c;
    }
    float cc = cosf(phi), ss = sinf(phi);
    int j = (ax + 1) % 3, k = (ax + 2) % 3;
    float lj = L[j], lk = L[k];
    L[j] = cc * lj + ss * lk;
    L[k] = -ss * lj + cc * lk;
  }
  float inv = 1.f / sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3] + 1e-30f);
  for (int k = 0; k < 4; ++k) q[k] *= inv;
}

HD float bf16_to_float(uint16_t b) {
  uint32_t u = ((uint32_t)b) << 16;
  float f;
  memcpy(&f, &u, sizeof(f));
  return f;
}

// K1 state rows (stride n): com 0-2, quat 3-6, momentum 7-9, angmom 10-12,
// force 13-15, torque 16-18, band-check violations 19.
// OU vector: half_dt, half_inv_m, c_t, s_t, c_r[3], s_r[3], inv_inertia[3].

// B, A, O, A of one BAOAB step for slot t (the force refresh + B follows)
HD void slot_baoa(int t, int n, const float* ou, const uint16_t* noise_t, float* st) {
  float half = ou[0], him = ou[1], c_t = ou[2], s_t = ou[3];
  float p[3], L[3], q[4], x[3];
  for (int k = 0; k < 3; ++k) {
    p[k] = st[(7 + k) * n + t] + half * st[(13 + k) * n + t];
    L[k] = st[(10 + k) * n + t] + half * st[(16 + k) * n + t];
    x[k] = st[k * n + t] + him * p[k];
  }
  for (int k = 0; k < 4; ++k) q[k] = st[(3 + k) * n + t];
  free_rotor(q, L, ou + 10, half);
  for (int k = 0; k < 3; ++k) {
    p[k] = c_t * p[k] + s_t * bf16_to_float(noise_t[k * n + t]);
    L[k] = ou[4 + k] * L[k] + ou[7 + k] * bf16_to_float(noise_t[(3 + k) * n + t]);
    x[k] += him * p[k];
  }
  free_rotor(q, L, ou + 10, half);
  for (int k = 0; k < 3; ++k) {
    st[k * n + t] = x[k];
    st[(7 + k) * n + t] = p[k];
    st[(10 + k) * n + t] = L[k];
  }
  for (int k = 0; k < 4; ++k) st[(3 + k) * n + t] = q[k];
}

// force/torque refresh at the new positions + the closing half kick
HD void slot_force_b(int t, int n, const float* P, const float* ou, const int* seq, const int* partners,
                     const float* qf, const float* wstack, const float* dirf, const int* w, int w_wide, float* st) {
  Grad g = slot_unbonded_grad(t, P, st, seq, partners, qf, n, w, w_wide);
  slot_bonded_grad(t, P, st, wstack, dirf, n, g);
  float q[4], gq[4];
  for (int k = 0; k < 4; ++k) q[k] = st[(3 + k) * n + t];
  frame_vjp(q, g, gq);
  V3 tau = torque_of(q, gq);
  float f[3] = {-g.com.x, -g.com.y, -g.com.z}, tq[3] = {tau.x, tau.y, tau.z};
  float half = ou[0];
  for (int k = 0; k < 3; ++k) {
    st[(7 + k) * n + t] += half * f[k];
    st[(10 + k) * n + t] += half * tq[k];
    st[(13 + k) * n + t] = f[k];
    st[(16 + k) * n + t] = tq[k];
  }
}

// exact in-band site checks at slot t's current positions: the number of
// (offset, check) pairs whose site distance is inside the bare cutoff.
// checks: (n_checks, 5) = fam_a, fam_b (0 back, 1 base, 2 stack), cutoff,
// d_lo, d_hi; a check covers offsets d_lo < d <= d_hi.
HD float slot_violations(int t, int n, const float* P, const float* pos, const int* partners, const float* checks,
                         int n_checks, int check_dm) {
  float bx = P[P_GEOM + 0], by = P[P_GEOM + 1], hbo = P[P_GEOM + 2], sto = P[P_GEOM + 3];
  Body bt = body_at(pos, n, t);
  V3 st[3] = {bt.com + bx * bt.a1 + by * bt.a2, bt.com + hbo * bt.a1, bt.com + sto * bt.a1};
  float v = 0.f;
  for (int d = 1; d <= check_dm && t + d < n; ++d) {
    int j = t + d;
    if (partners[t] == j || partners[n + t] == j) continue;
    Body bj = body_at(pos, n, j);
    V3 sj[3] = {bj.com + bx * bj.a1 + by * bj.a2, bj.com + hbo * bj.a1, bj.com + sto * bj.a1};
    for (int c = 0; c < n_checks; ++c) {
      const float* ck = checks + 5 * c;
      if (!((float)d > ck[3] && (float)d <= ck[4])) continue;
      int fa = (int)ck[0], fb = (int)ck[1];
      float cu2 = ck[2] * ck[2];
      V3 e = sj[fb] - st[fa];
      bool hit = dot(e, e) < cu2;
      if (fa != fb) {
        V3 e2 = sj[fa] - st[fb];
        hit = hit || dot(e2, e2) < cu2;
      }
      v += hit ? 1.f : 0.f;
    }
  }
  return v;
}
