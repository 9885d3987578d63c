// Fused fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP: the per-env
// routine shared by the CUDA kernel (pdipm_fused_cuda.cu) and the CPU
// target (pdipm_fused_cpu.cc).
//
// It runs exactly the pure-JAX "ric_aug" backend of ops/pdipm.py with
// foot_split=True, refine_steps=1, corrector_form="delta", an f32
// refinement residual, kkt_scale="none" and a cold start — the shipped
// configuration — in float32. All Newton iterations of one env run inside
// one call.
//
// Each env is solved by a group of LANES = 16 lanes. A "lane vector" (V)
// holds one value per lane: a stage's 12-vector (x_t, u_t, y_t) in lanes
// 0..11, its 16 inequality rows in lanes 0..15, and lane i holds row i of
// every 12x12 block, so a 12x12 matrix is 12 lane vectors (its columns).
// The per-foot and y-chain Gauss-Jordan inverses eliminate all rows of a
// block at once; pivot searches and dot products go across lanes. The
// routine is written once against a backend K that supplies the lane
// vector types and the cross-lane operations: on the GPU a lane is a
// thread and those operations are warp shuffles, on the CPU a lane vector
// is a 16-entry array.
//
// Per-env input (`packed`, (input_len(T), B) batch-last), in this order:
//   q_diag[12] r_diag[12] Ad[12x12] Bd[12x12] cd[12] b0[12] g_u[16x12]
//   f[24T] d[16T]                            (matrices row-major)
// Output and scratch hold lane vectors, (n, B, LANES) with the lanes
// innermost: output_lvs(T) of them in the order x_t (T), u_t (T), s_t (T),
// z_t (T), y_t (T, 12 dynamics rows), ymx_t (T, lanes 0..1), residuals
// (lanes 0..3).
#pragma once

#include <cmath>

// PF_HD: sizes and layout, used by the host handlers and the solver.
// PF_DEV: the solver itself, which runs on the device under CUDA.
#ifdef __CUDACC__
#define PF_HD __host__ __device__ __forceinline__
#define PF_DEV __device__ __forceinline__
#else
#define PF_HD inline
#define PF_DEV inline
#endif

namespace pdipm_fused {

constexpr int NX = 12;  // states per knot
constexpr int NU = 12;  // inputs per stage [F_L, F_R, M_L, M_R]
constexpr int NI = 16;  // inequality rows per stage
constexpr int NB = 12;  // per-foot block [F(3), M_y, z_foot(8)]
constexpr int LANES = 16;
// Offsets of the constant input fields.
constexpr int IN_Q = 0, IN_R = 12, IN_AD = 24, IN_BD = 168, IN_CD = 312,
              IN_B0 = 324, IN_GU = 336, CONST_LEN = 528;

PF_HD int input_len(int T) { return CONST_LEN + 40 * T; }
PF_HD int output_lvs(int T) { return 6 * T + 1; }
PF_HD int mx_col(int f) { return 6 + 3 * f; }  // u index of M_x of foot f
PF_HD int mz_col(int f) { return 8 + 3 * f; }  // u index of M_z of foot f
// u index of the i-th of the 4 input entries of foot f's block.
PF_HD int foot_col(int f, int i) { return i < 3 ? 3 * f + i : 7 + 3 * f; }

struct Params {
  float beta, delta, frac_to_boundary, alpha_min, sz_floor;
  int iterations;
};

// Lane-vector indices in the scratch buffer. An "nz" vector is x_t (T)
// then u_t (T); an "ne" vector is the dynamics rows y_t (T) then the Mx
// rows (T, lanes 0..1); an "ni" vector is T lane vectors. The iterate
// (x, s, z, y, residuals) is contiguous in output order.
struct Layout {
  long kinv, yinv, adqad, f, d;        // factors and constant data
  long x, s, z, y, res;                // iterate
  long rx, rs, re, sig, w;             // residuals and scalings
  long ax, as, az, ay, cx, cs, cz, cy; // affine / corrector directions
  long r1, r2, rz, r4, e1, ez, e4, ex, ezz, ey, gg, total;
  PF_HD explicit Layout(int T) {
    long o = 0;
    kinv = o; o += 24L * T;  // per stage, per foot: 12 column vectors
    yinv = o; o += 12L * T;  // y-chain inverses, 12 columns per stage
    adqad = o; o += 12;      // Ad diag(q_inv) Ad^T
    f = o; o += 2L * T;
    d = o; o += T;
    x = o; o += 2L * T; s = o; o += T; z = o; o += T; y = o; o += 2L * T;
    res = o; o += 1;
    rx = o; o += 2L * T; rs = o; o += T; re = o; o += 2L * T;
    sig = o; o += T; w = o; o += T;
    ax = o; o += 2L * T; as = o; o += T; az = o; o += T; ay = o; o += 2L * T;
    cx = o; o += 2L * T; cs = o; o += T; cz = o; o += T; cy = o; o += 2L * T;
    r1 = o; o += 2L * T; r2 = o; o += T; rz = o; o += T; r4 = o; o += 2L * T;
    e1 = o; o += 2L * T; ez = o; o += T; e4 = o; o += 2L * T;
    ex = o; o += 2L * T; ezz = o; o += T; ey = o; o += 2L * T;
    gg = o; o += T;
    total = o;
  }
};

PF_HD long scratch_lvs(int T) { return Layout(T).total; }

// The solver for one env. K supplies: types V (float per lane), M (bool
// per lane), I (int per lane); lanes(); bcast(v, src) (uniform src);
// perm(v, src) (per-lane src); usum / umin (uniform reductions);
// ubcast(v, src) (one lane's value as a scalar); argmax(v) (first lane of
// the maximum, uniform); sel / seli; vabs / vmax / vmin; ld / st of a lane
// vector; gather (per-lane input element).
template <class K>
struct Solver {
  using V = typename K::V;
  using M = typename K::M;
  using I = typename K::I;

  K k;
  const float* in;   // this env's input column; element e at in[e * ins]
  long ins;
  float* sc;         // this env's lane vectors; vector g at sc + g * gs
  long gs;
  int T;
  Params prm;
  Layout L;
  I ln;              // lane index
  // Per-solve constants, lane i holding row i (*R) or column i (*C).
  V q, r, qi, cd, b0;
  V AdR[NX], AdC[NX], BdR[NX], BdC[NX], GuR[NU], GuC[NI];
  float qik[NX];          // q_inv as uniform scalars
  float k2[2][4];         // [M_x, nu] block inverses (row-major)
  float mzinv[2];         // 1 / (r_Mz + beta)

  PF_DEV Solver(K k_, const float* in_, long ins_, float* sc_, long gs_,
               int T_, Params prm_)
      : k(k_), in(in_), ins(ins_), sc(sc_), gs(gs_), T(T_), prm(prm_),
        L(T_), ln(k_.lanes()) {}

  PF_DEV V ld(long g) const { return k.ld(sc + g * gs); }
  PF_DEV void st(long g, V v) const { k.st(sc + g * gs, v); }
  PF_DEV V gin(I e, M valid) const { return k.gather(in, ins, e, valid); }

  // sum_j m[j] * x_j with m[j] this lane's row entries: a matvec whose
  // matrix columns are the lane vectors m[0..N).
  template <int N>
  PF_DEV V mv(const V (&m)[N], V x) const {
    V acc = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) acc = acc + m[j] * k.bcast(x, j);
    return acc;
  }
  // The same with the matrix columns stored as lane vectors g0..g0+11.
  PF_DEV V mv_ld(long g0, V x) const {
    V acc = 0.0f;
#pragma unroll
    for (int j = 0; j < NX; ++j) acc = acc + ld(g0 + j) * k.bcast(x, j);
    return acc;
  }

  // ---- set-up ----------------------------------------------------------

  PF_DEV void load_constants() {
    const M m12 = ln < NX;
    q = gin(ln + IN_Q, m12);
    r = gin(ln + IN_R, m12);
    qi = k.sel(m12, 1.0f / (q + prm.beta), 0.0f);
    cd = gin(ln + IN_CD, m12);
    b0 = gin(ln + IN_B0, m12);
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      AdR[j] = gin(ln * NX + (IN_AD + j), m12);
      AdC[j] = gin(ln + (IN_AD + j * NX), m12);
      BdR[j] = gin(ln * NU + (IN_BD + j), m12);
      BdC[j] = gin(ln + (IN_BD + j * NU), m12);
      GuR[j] = gin(ln * NU + (IN_GU + j), ln < NI);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) GuC[j] = gin(ln + (IN_GU + j * NU), m12);
#pragma unroll
    for (int j = 0; j < NX; ++j) qik[j] = k.ubcast(qi, j);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const float rr = k.ubcast(r, mx_col(f)) + prm.beta;
      const float det = -rr * prm.delta - 1.0f;
      k2[f][0] = -prm.delta / det;
      k2[f][1] = -1.0f / det;
      k2[f][2] = -1.0f / det;
      k2[f][3] = rr / det;
      mzinv[f] = 1.0f / (k.ubcast(r, mz_col(f)) + prm.beta);
    }
    // Ad diag(q_inv) Ad^T, column j: lane i sums Ad[i][c] q_inv[c] Ad[j][c].
    for (int j = 0; j < NX; ++j) {
      V col = 0.0f;
#pragma unroll
      for (int c = 0; c < NX; ++c)
        col = col + AdR[c] * (qik[c] * k.bcast(AdR[c], j));
      st(L.adqad + j, col);
    }
    for (int t = 0; t < T; ++t) {
      st(L.f + t, gin(ln + (CONST_LEN + t * NX), m12));
      st(L.f + T + t, gin(ln + (CONST_LEN + NX * T + t * NU), m12));
      st(L.d + t, gin(ln + (CONST_LEN + 24 * T + t * NI), ln < NI));
    }
  }

  // ---- structured QP operators (ops/qp.py), one stage at a time -------

  // (hd + shift) x + G^T zv + A^T yv [+ f]: nz vector at `out`.
  PF_DEV void kkt_row1(long x, long zv, long yv, float shift, bool add_f,
                      long out) const {
    for (int t = 0; t < T; ++t) {
      const V yd = ld(yv + t);
      V acc = (q + shift) * ld(x + t) + yd;
      if (t + 1 < T) acc = acc - mv(AdC, ld(yv + t + 1));
      if (add_f) acc = acc + ld(L.f + t);
      st(out + t, acc);
      const V ym = ld(yv + T + t);
      V au = (r + shift) * ld(x + T + t) + mv(GuC, ld(zv + t)) - mv(BdC, yd);
      au = au + k.sel(ln == mx_col(0), k.bcast(ym, 0), 0.0f)
              + k.sel(ln == mx_col(1), k.bcast(ym, 1), 0.0f);
      if (add_f) au = au + ld(L.f + T + t);
      st(out + T + t, au);
    }
  }
  PF_DEV V g_row(long x, int t) const { return mv(GuR, ld(x + T + t)); }
  PF_DEV V a_dyn(long x, int t, bool sub_b) const {
    V acc = ld(x + t) - mv(BdR, ld(x + T + t));
    if (t >= 1) acc = acc - mv(AdR, ld(x + t - 1));
    if (sub_b) acc = acc - (t == 0 ? b0 : cd);
    return acc;
  }
  PF_DEV V a_mx(long x, int t) const {
    const V u = ld(x + T + t);
    return k.sel(ln == 0, k.bcast(u, mx_col(0)),
                 k.sel(ln == 1, k.bcast(u, mx_col(1)), 0.0f));
  }

  // ---- Gauss-Jordan on 12 rows held one per lane ------------------------

  // In-place Gauss-Jordan inverse with partial (row) pivoting — the pivot
  // rule of ops/linalg.gauss_jordan_inverse: at step c the largest
  // |a[r][c]| over the rows not yet pivoted. Rows are not swapped: row p_c
  // pivots at step c, and the in-place result R then holds
  // A^-1[c][p_j] = R[p_c][j]. Stores A^-1's columns at g0..g0+11 (lanes
  // 12..15 zero).
  PF_DEV void gj_store(V (&a)[NB], long g0) const {
    M done = ln >= NB;
    I pc = 0;  // lane c ends up holding p_c
    int p_at[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const int p = k.argmax(k.sel(done, -1.0f, k.vabs(a[c])));
      p_at[c] = p;
      pc = k.seli(ln == c, p, pc);
      const M is_p = ln == p;
      V prow[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) prow[j] = k.bcast(a[j], p);
      const V fac = a[c];
      const V inv = 1.0f / prow[c];  // the same in every lane
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j == c) continue;
        const V pj = prow[j] * inv;
        a[j] = k.sel(is_p, pj, a[j] - fac * pj);
      }
      a[c] = k.sel(is_p, inv, 0.0f - fac * inv);
      done = done | is_p;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
      st(g0 + p_at[j], k.sel(ln < NB, k.perm(a[j], pc), 0.0f));
  }

  // ---- factorization (ops/pdipm.py::_factor_ric_aug, foot split) -------

  PF_DEV void factor() const {
    for (int t = 0; t < T; ++t) {
      const V wt = ld(L.w + t);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        // Block rows 0..3: u entries c_i; rows 4..11: z rows 8f + (i-4).
        const M top = ln < 4, bot = (ln >= 4) & (ln < NB);
        const I ci = k.seli(ln < 3, ln + 3 * f, 7 + 3 * f);
        const I zi = k.seli(bot, ln + (8 * f - 4), 0);
        const V rci = k.perm(r, k.seli(top, ci, 0)) + prm.beta;
        const V wk = k.perm(wt, zi);
        V a[NB];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const V gkj = k.perm(GuR[foot_col(f, j)], zi);  // g_u[z][c_j]
          a[j] = k.sel(top, k.sel(ln == j, rci, 0.0f), k.sel(bot, gkj, 0.0f));
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const V gik = k.perm(GuC[8 * f + kk], k.seli(top, ci, 0));
          a[4 + kk] = k.sel(top, gik, k.sel(ln == 4 + kk, 0.0f - wk, 0.0f));
        }
        gj_store(a, L.kinv + (2L * t + f) * NB);
      }
      // Y'_t = -delta I - Q~^-1 - [t>=1] Ad Q~^-1 Ad^T - Bd kuu_t Bd^T,
      // lane i holding row i. P = Bd kuu_t.
      V P[NU];
#pragma unroll
      for (int c = 0; c < NU; ++c) P[c] = 0.0f;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const V kc = ld(L.kinv + (2L * t + f) * NB + jj);
          V acc = 0.0f;
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
            acc = acc + BdR[foot_col(f, ii)] * k.bcast(kc, ii);
          P[foot_col(f, jj)] = acc;
        }
        P[mx_col(f)] = BdR[mx_col(f)] * k2[f][0];
        P[mz_col(f)] = BdR[mz_col(f)] * mzinv[f];
      }
      V a[NB];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        V m = 0.0f;
#pragma unroll
        for (int c = 0; c < NU; ++c) m = m + P[c] * k.bcast(BdR[c], j);
        V y = 0.0f - m - k.sel(ln == j, qi + prm.delta, 0.0f);
        if (t >= 1) y = y - ld(L.adqad + j);
        a[j] = y;
      }
      if (t >= 1) {
        // a -= S^T M_{t-1} S with S = Q~^-1 Ad^T: column j of tmp =
        // M_{t-1} S (rows in lanes), then lane i adds
        // sum_c q_inv[c] Ad[i][c] tmp[c][j].
        const long mp = L.yinv + (long)(t - 1) * NX;
        V mr[NX];
#pragma unroll
        for (int c = 0; c < NX; ++c) mr[c] = ld(mp + c);
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          V tj = 0.0f;
#pragma unroll
          for (int c = 0; c < NX; ++c)
            tj = tj + mr[c] * (qik[c] * k.bcast(AdR[c], j));
          V acc = 0.0f;
#pragma unroll
          for (int c = 0; c < NX; ++c)
            acc = acc + (qik[c] * AdR[c]) * k.bcast(tj, c);
          a[j] = a[j] - acc;
        }
      }
      gj_store(a, L.yinv + (long)t * NX);
    }
  }

  // ---- reduced solve (ops/pdipm.py::_solve_ric_aug) --------------------

  // K_t^-1 [ru, rz_t, rnu_t] -> du (u lanes), dz (16 lanes), dnu (lanes
  // 0..1).
  PF_DEV void kinv_apply(int t, V ru, V rzt, V rnu, V& du, V& dz,
                        V& dnu) const {
    V o[2];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const long g0 = L.kinv + (2L * t + f) * NB;
      V acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc = acc + ld(g0 + j) * k.bcast(ru, foot_col(f, j));
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        acc = acc + ld(g0 + 4 + kk) * k.bcast(rzt, 8 * f + kk);
      o[f] = acc;
    }
    const M inL = (ln < 3) | (ln == 7);
    const M inR = ((ln >= 3) & (ln < 6)) | (ln == 10);
    const I iL = k.seli(ln == 7, 3, k.seli(ln < 3, ln, 0));
    const I iR = k.seli(ln == 10, 3, k.seli(inR, ln - 3, 0));
    V u = k.sel(inL, k.perm(o[0], iL), k.sel(inR, k.perm(o[1], iR), 0.0f));
    float rm[2], nu[2];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      rm[f] = k.ubcast(ru, mx_col(f));
      nu[f] = k.ubcast(rnu, f);
      u = k.sel(ln == mx_col(f), k2[f][0] * rm[f] + k2[f][1] * nu[f], u);
      u = k.sel(ln == mz_col(f), ru * mzinv[f], u);
    }
    du = u;
    dnu = k.sel(ln == 0, k2[0][2] * rm[0] + k2[0][3] * nu[0],
                k.sel(ln == 1, k2[1][2] * rm[1] + k2[1][3] * nu[1], 0.0f));
    const I zs = k.seli(ln < 8, ln + 4, ln - 4);
    dz = k.sel(ln < 8, k.perm(o[0], zs), k.perm(o[1], zs));
  }

  PF_DEV void solve_aug(long r1, long rz, long r4, long dx, long dz,
                       long dy) const {
    for (int t = 0; t < T; ++t) {
      V ry = ld(r4 + t) - qi * ld(r1 + t);
      if (t >= 1) ry = ry + mv(AdR, qi * ld(r1 + t - 1));
      V du, dzt, dnu;
      kinv_apply(t, ld(r1 + T + t), ld(rz + t), ld(r4 + T + t), du, dzt, dnu);
      st(L.gg + t, ry + mv(BdR, du));
    }
    for (int t = 1; t < T; ++t) {
      const V v = mv_ld(L.yinv + (long)(t - 1) * NX, ld(L.gg + t - 1));
      st(L.gg + t, ld(L.gg + t) - mv(AdR, qi * v));
    }
    for (int t = T - 1; t >= 0; --t) {
      V g = ld(L.gg + t);
      if (t + 1 < T) g = g - qi * mv(AdC, ld(dy + t + 1));
      st(dy + t, mv_ld(L.yinv + (long)t * NX, g));
    }
    for (int t = 0; t < T; ++t) {
      const V wy = ld(dy + t);
      V du, dzt, dnu;
      kinv_apply(t, ld(r1 + T + t) + mv(BdC, wy), ld(rz + t),
                 ld(r4 + T + t), du, dzt, dnu);
      st(dx + T + t, du);
      st(dz + t, dzt);
      st(dy + T + t, dnu);
      V xs = ld(r1 + t) - wy;
      if (t + 1 < T) xs = xs + mv(AdC, ld(dy + t + 1));
      st(dx + t, qi * xs);
    }
  }

  // reduced_solve with one refinement step; r2 is kept for ds.
  PF_DEV void reduced_solve(long r1, long r2, long rz, long r4, long dx,
                           long ds, long dz, long dy) const {
    const float beta = prm.beta, delta = prm.delta;
    solve_aug(r1, rz, r4, dx, dz, dy);
    kkt_row1(dx, dz, dy, beta, false, L.e1);
    for (int g = 0; g < 2 * T; ++g) st(L.e1 + g, ld(r1 + g) - ld(L.e1 + g));
    for (int t = 0; t < T; ++t) {
      st(L.ez + t, ld(rz + t) - (g_row(dx, t) - ld(L.w + t) * ld(dz + t)));
      st(L.e4 + t,
         ld(r4 + t) - (a_dyn(dx, t, false) - delta * ld(dy + t)));
      st(L.e4 + T + t,
         ld(r4 + T + t) - (a_mx(dx, t) - delta * ld(dy + T + t)));
    }
    solve_aug(L.e1, L.ez, L.e4, L.ex, L.ezz, L.ey);
    for (int g = 0; g < 2 * T; ++g) {
      st(dx + g, ld(dx + g) + ld(L.ex + g));
      st(dy + g, ld(dy + g) + ld(L.ey + g));
    }
    for (int t = 0; t < T; ++t) {
      const V dzt = ld(dz + t) + ld(L.ezz + t);
      st(dz + t, dzt);
      st(ds + t, (ld(r2 + t) - dzt) / ld(L.sig + t));
    }
  }

  // min(1, frac * min_i cand_i) floored at alpha_min, cand_i = -v_i / dv_i
  // where dv_i < 0 and 1 elsewhere (ops/pdipm.py::_frac_to_boundary).
  PF_DEV float frac_to_boundary(long v, long dv) const {
    V m = 3.0e38f;
    for (int t = 0; t < T; ++t) {
      const V d = ld(dv + t);
      const M neg = d < 0.0f;
      m = k.vmin(m, k.sel(neg, (0.0f - ld(v + t)) / k.sel(neg, d, -1.0f),
                          1.0f));
    }
    const float alpha = fminf(1.0f, prm.frac_to_boundary * k.umin(m));
    return fmaxf(alpha, prm.alpha_min);
  }

  PF_DEV void iteration() const {
    const float delta = prm.delta;
    const float ni = (float)(NI * T);
    kkt_row1(L.x, L.z, L.y, 0.0f, true, L.rx);
    V sz = 0.0f;
    for (int t = 0; t < T; ++t) {
      st(L.re + t, a_dyn(L.x, t, true));
      st(L.re + T + t, a_mx(L.x, t));
      const V s = ld(L.s + t), z = ld(L.z + t);
      st(L.rs + t, g_row(L.x, t) + s - ld(L.d + t));
      sz = sz + s * z;
      const V sig = z / s + delta;
      st(L.sig + t, sig);
      st(L.w + t, 1.0f / sig + delta);
    }
    const float mu = k.usum(sz) / ni;
    factor();

    // Affine (predictor) direction.
    for (int g = 0; g < 2 * T; ++g) {
      st(L.r1 + g, 0.0f - ld(L.rx + g));
      st(L.r4 + g, 0.0f - ld(L.re + g));
    }
    for (int t = 0; t < T; ++t) {
      const V s = ld(L.s + t);
      const V r2 = 0.0f - (s * ld(L.z + t)) / s;
      st(L.r2 + t, r2);
      st(L.rz + t, (0.0f - ld(L.rs + t)) - r2 / ld(L.sig + t));
    }
    reduced_solve(L.r1, L.r2, L.rz, L.r4, L.ax, L.as, L.az, L.ay);
    const float a_ap = frac_to_boundary(L.s, L.as);
    const float a_ad = frac_to_boundary(L.z, L.az);
    V acc = 0.0f;
    for (int t = 0; t < T; ++t)
      acc = acc + (ld(L.s + t) + a_ap * ld(L.as + t)) *
                  (ld(L.z + t) + a_ad * ld(L.az + t));
    const float ratio = (k.usum(acc) / ni) / mu;
    const float sigma = ratio * ratio * ratio;

    // Corrector direction (zero KKT rhs).
    for (int g = 0; g < 2 * T; ++g) {
      st(L.r1 + g, 0.0f);
      st(L.r4 + g, 0.0f);
    }
    for (int t = 0; t < T; ++t) {
      const V s = ld(L.s + t), z = ld(L.z + t);
      const V rc = s * z + ld(L.as + t) * ld(L.az + t) - sigma * mu;
      const V r2 = 0.0f - rc / s;
      st(L.r2 + t, r2);
      st(L.rz + t, 0.0f - r2 / ld(L.sig + t));
    }
    reduced_solve(L.r1, L.r2, L.rz, L.r4, L.cx, L.cs, L.cz, L.cy);
    for (int g = 0; g < 2 * T; ++g) {
      st(L.ax + g, ld(L.ax + g) + ld(L.cx + g));
      st(L.ay + g, ld(L.ay + g) + ld(L.cy + g));
    }
    for (int t = 0; t < T; ++t) {
      st(L.as + t, ld(L.as + t) + ld(L.cs + t));
      st(L.az + t, ld(L.az + t) + ld(L.cz + t));
    }
    const float a_p = frac_to_boundary(L.s, L.as);
    const float a_d = frac_to_boundary(L.z, L.az);

    V nrx = 0.0f, nrs = 0.0f, nre = 0.0f, sz_new = 0.0f;
    for (int g = 0; g < 2 * T; ++g) {
      st(L.x + g, ld(L.x + g) + a_p * ld(L.ax + g));
      st(L.y + g, ld(L.y + g) + a_d * ld(L.ay + g));
      const V rxg = ld(L.rx + g), reg = ld(L.re + g);
      nrx = nrx + rxg * rxg;
      nre = nre + reg * reg;
    }
    for (int t = 0; t < T; ++t) {
      const V s = k.vmax(ld(L.s + t) + a_p * ld(L.as + t), prm.sz_floor);
      const V z = k.vmax(ld(L.z + t) + a_d * ld(L.az + t), prm.sz_floor);
      st(L.s + t, s);
      st(L.z + t, z);
      sz_new = sz_new + s * z;
      const V rst = ld(L.rs + t);
      nrs = nrs + rst * rst;
    }
    const float res0 = sqrtf(k.usum(nrx)), res1 = sqrtf(k.usum(nrs)),
                res2 = sqrtf(k.usum(nre)), res3 = k.usum(sz_new) / ni;
    st(L.res, k.sel(ln == 0, res0, k.sel(ln == 1, res1,
              k.sel(ln == 2, res2, k.sel(ln == 3, res3, 0.0f)))));
  }

  // Cold start (ops/pdipm.py::init_state) and the fixed-iteration loop.
  PF_DEV void solve() {
    load_constants();
    for (int t = 0; t < T; ++t) {
      st(L.x + t, 0.0f);
      st(L.x + T + t, 0.0f);
      st(L.s + t, k.vmax(ld(L.d + t), 1.0f));
      st(L.z + t, 1.0f);
      st(L.y + t, k.sel(ln < NX, 1.0f, 0.0f));
      st(L.y + T + t, k.sel(ln < 2, 1.0f, 0.0f));
    }
    st(L.res, 0.0f);
    for (int it = 0; it < prm.iterations; ++it) iteration();
  }

  // Copy the iterate (x, s, z, y, residuals) to the output lane vectors.
  PF_DEV void write_output(float* out, long ogs) const {
    for (long g = 0; g < output_lvs(T); ++g)
      k.st(out + g * ogs, ld(L.x + g));
  }
};

}  // namespace pdipm_fused
