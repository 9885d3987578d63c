// CPU baseline: batched SRBD-MPC QP assembly + Mehrotra PDIPM, C++/OpenMP.
//
// This framework's counterpart of the reference's native CPU benchmark
// drivers (`/root/reference/biped_pympc/cusadi/src/benchmark_functions/
// evaluate_serial_cpu.cpp` / `evaluate_parallel_cpu.cpp`): evaluates the same
// mathematical pipeline as the JAX path — closed-form QP assembly
// (srbd_constraints.py semantics) and the fixed-iteration Mehrotra
// predictor-corrector PDIPM (sparse_pdipm_solver.py:357-534 update rule) —
// once per environment, serially or with `#pragma omp parallel for`.
//
// Roles:
//   1. CPU speed baseline for solves/sec comparisons (bench_cpu.py).
//   2. Independent correctness oracle in a second language (ctypes-driven
//      cross-check against the JAX and NumPy implementations).
//
// Exposed C ABI (see biped_pympc_tpu/native.py):
//   srbd_mpc_solve_batch(... , int batch, int n_threads, double* x_out)
//
// Build: make -C native  (g++ -O3 -fopenmp -shared -fPIC)

#include <cmath>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int NX = 12;     // states per knot
constexpr int NU = 12;     // inputs per stage
constexpr int NI = 16;     // inequality rows per stage
constexpr int NMX = 2;     // Mx equality rows per stage
// Defaults only — all three are runtime parameters of build_qp /
// srbd_mpc_solve_batch (the reference bakes HECTOR's values into its
// compiled kernel for every robot: srbd_constraints.py:31,161-162).
constexpr double F_MAX = 500.0;
constexpr double LT = 0.07;   // toe lever arm (HECTOR)
constexpr double LH = 0.04;   // heel lever arm (HECTOR)
constexpr double GRAV = 9.81;

// --- tiny dense helpers (row-major) ---------------------------------------

inline void mat_mul(const double* a, const double* b, double* c, int n, int m,
                    int p) {
  // c(n,p) = a(n,m) b(m,p)
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < p; ++k) {
      double acc = 0.0;
      for (int j = 0; j < m; ++j) acc += a[i * m + j] * b[j * p + k];
      c[i * p + k] = acc;
    }
}

inline void mat3_inv(const double* m, double* inv) {
  double det = m[0] * (m[4] * m[8] - m[5] * m[7]) -
               m[1] * (m[3] * m[8] - m[5] * m[6]) +
               m[2] * (m[3] * m[7] - m[4] * m[6]);
  double id = 1.0 / det;
  inv[0] = (m[4] * m[8] - m[5] * m[7]) * id;
  inv[1] = (m[2] * m[7] - m[1] * m[8]) * id;
  inv[2] = (m[1] * m[5] - m[2] * m[4]) * id;
  inv[3] = (m[5] * m[6] - m[3] * m[8]) * id;
  inv[4] = (m[0] * m[8] - m[2] * m[6]) * id;
  inv[5] = (m[2] * m[3] - m[0] * m[5]) * id;
  inv[6] = (m[3] * m[7] - m[4] * m[6]) * id;
  inv[7] = (m[1] * m[6] - m[0] * m[7]) * id;
  inv[8] = (m[0] * m[4] - m[1] * m[3]) * id;
}

inline void skew3(const double* v, double* s) {
  s[0] = 0.0;   s[1] = -v[2]; s[2] = v[1];
  s[3] = v[2];  s[4] = 0.0;   s[5] = -v[0];
  s[6] = -v[1]; s[7] = v[0];  s[8] = 0.0;
}

// Dense LU with partial pivoting; solves in place for multiple RHS reuse.
struct LU {
  std::vector<double> a;
  std::vector<int> piv;
  int n = 0;
  bool factor(const double* m, int dim) {
    n = dim;
    a.assign(m, m + n * n);
    piv.resize(n);
    for (int k = 0; k < n; ++k) {
      int p = k;
      double mx = std::fabs(a[k * n + k]);
      for (int i = k + 1; i < n; ++i) {
        double v = std::fabs(a[i * n + k]);
        if (v > mx) { mx = v; p = i; }
      }
      piv[k] = p;
      if (mx == 0.0) return false;
      if (p != k)
        for (int j = 0; j < n; ++j) std::swap(a[k * n + j], a[p * n + j]);
      double inv = 1.0 / a[k * n + k];
      for (int i = k + 1; i < n; ++i) {
        double f = a[i * n + k] * inv;
        a[i * n + k] = f;
        for (int j = k + 1; j < n; ++j) a[i * n + j] -= f * a[k * n + j];
      }
    }
    return true;
  }
  void solve(double* b) const {
    // Row interchanges first (the stored L reflects the final permutation —
    // interleaving swaps with the forward sweep would pair updated values
    // with the wrong multipliers).
    for (int k = 0; k < n; ++k)
      if (piv[k] != k) std::swap(b[k], b[piv[k]]);
    for (int k = 0; k < n; ++k)
      for (int i = k + 1; i < n; ++i) b[i] -= a[i * n + k] * b[k];
    for (int i = n - 1; i >= 0; --i) {
      for (int j = i + 1; j < n; ++j) b[i] -= a[i * n + j] * b[j];
      b[i] /= a[i * n + i];
    }
  }
};

// --- per-env problem ------------------------------------------------------

struct Problem {
  int T;                    // horizon
  std::vector<double> Ad;   // (12,12)
  std::vector<double> Bd;   // (12,12)
  std::vector<double> cd;   // (12)
  std::vector<double> b0;   // (12) = Ad x0 + cd
  std::vector<double> hdiag;  // (nz)
  std::vector<double> f;      // (nz)
  std::vector<double> Gu;     // (16,12) per-stage inequality block
  std::vector<double> d;      // (T*16)
  int nz() const { return 2 * NX * T; }
  int neq() const { return (NX + NMX) * T; }
  int nineq() const { return NI * T; }
};

// Closed-form RK4 of the affine SRBD model (models/srbd.py semantics).
void build_dynamics(const double* rot, const double* iw, const double* bpos,
                    const double* lf, const double* rf, double mass,
                    const double* res_lin, const double* res_ang, double dt,
                    int euler_rt, Problem& P) {
  double Ac[NX * NX] = {0}, Bc[NX * NX] = {0}, cc[NX] = {0};
  // rm = R^T (rt_omega, shipped-CUDA semantics) or R
  double rm[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      rm[i * 3 + j] = euler_rt ? rot[j * 3 + i] : rot[i * 3 + j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      Ac[i * NX + (6 + j)] = rm[i * 3 + j];
      Ac[(3 + i) * NX + (9 + j)] = (i == j) ? 1.0 : 0.0;
    }
  double iwinv[9];
  mat3_inv(iw, iwinv);
  double pl[3] = {lf[0] - bpos[0], lf[1] - bpos[1], lf[2] - bpos[2]};
  double pr[3] = {rf[0] - bpos[0], rf[1] - bpos[1], rf[2] - bpos[2]};
  double skl[9], skr[9], tmp[9];
  skew3(pl, skl);
  skew3(pr, skr);
  mat_mul(iwinv, skl, tmp, 3, 3, 3);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Bc[(6 + i) * NX + j] = tmp[i * 3 + j];
  mat_mul(iwinv, skr, tmp, 3, 3, 3);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Bc[(6 + i) * NX + (3 + j)] = tmp[i * 3 + j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      Bc[(6 + i) * NX + (6 + j)] = iwinv[i * 3 + j];
      Bc[(6 + i) * NX + (9 + j)] = iwinv[i * 3 + j];
      Bc[(9 + i) * NX + j] = (i == j) ? 1.0 / mass : 0.0;
      Bc[(9 + i) * NX + (3 + j)] = (i == j) ? 1.0 / mass : 0.0;
    }
  for (int i = 0; i < 3; ++i) {
    cc[6 + i] = res_ang[i];
    cc[9 + i] = res_lin[i];
  }
  cc[11] += -GRAV;

  // Ad = I + dtA + (dtA)^2/2 + ... ; M = dt(I + dtA/2 + (dtA)^2/6 + (dtA)^3/24)
  double dA[NX * NX], dA2[NX * NX], dA3[NX * NX], dA4[NX * NX];
  for (int i = 0; i < NX * NX; ++i) dA[i] = dt * Ac[i];
  mat_mul(dA, dA, dA2, NX, NX, NX);
  mat_mul(dA2, dA, dA3, NX, NX, NX);
  mat_mul(dA3, dA, dA4, NX, NX, NX);
  P.Ad.assign(NX * NX, 0.0);
  std::vector<double> M(NX * NX, 0.0);
  for (int i = 0; i < NX; ++i) {
    P.Ad[i * NX + i] = 1.0;
    M[i * NX + i] = dt;
  }
  for (int i = 0; i < NX * NX; ++i) {
    P.Ad[i] += dA[i] + dA2[i] / 2.0 + dA3[i] / 6.0 + dA4[i] / 24.0;
    M[i] += dt * (dA[i] / 2.0 + dA2[i] / 6.0 + dA3[i] / 24.0);
  }
  P.Bd.assign(NX * NX, 0.0);
  mat_mul(M.data(), Bc, P.Bd.data(), NX, NX, NX);
  P.cd.assign(NX, 0.0);
  for (int i = 0; i < NX; ++i)
    for (int j = 0; j < NX; ++j) P.cd[i] += M[i * NX + j] * cc[j];
}

void build_qp(const double* x0, const double* xref, const double* contact,
              const double* Q, const double* Rw, double mu, int T, Problem& P,
              double lt = LT, double lh = LH, double f_max = F_MAX) {
  P.T = T;
  const int nz = P.nz();
  P.hdiag.assign(nz, 0.0);
  P.f.assign(nz, 0.0);
  for (int t = 0; t < T; ++t)
    for (int i = 0; i < NX; ++i) {
      P.hdiag[t * NX + i] = Q[i];
      P.hdiag[NX * T + t * NU + i] = Rw[i];
      P.f[t * NX + i] = -Q[i] * xref[t * NX + i];
    }
  P.b0.assign(NX, 0.0);
  for (int i = 0; i < NX; ++i) {
    P.b0[i] = P.cd[i];
    for (int j = 0; j < NX; ++j) P.b0[i] += P.Ad[i * NX + j] * x0[j];
  }
  // inequality block (srbd_constraints.py:194-222 row order)
  P.Gu.assign(NI * NU, 0.0);
  for (int foot = 0; foot < 2; ++foot) {
    int fc = 3 * foot, mc = 6 + 3 * foot, r = 8 * foot;
    P.Gu[(r + 0) * NU + fc] = -1.0;  P.Gu[(r + 0) * NU + fc + 2] = -mu;
    P.Gu[(r + 1) * NU + fc] = 1.0;   P.Gu[(r + 1) * NU + fc + 2] = -mu;
    P.Gu[(r + 2) * NU + fc + 1] = -1.0; P.Gu[(r + 2) * NU + fc + 2] = -mu;
    P.Gu[(r + 3) * NU + fc + 1] = 1.0;  P.Gu[(r + 3) * NU + fc + 2] = -mu;
    P.Gu[(r + 4) * NU + fc + 2] = -lt;  P.Gu[(r + 4) * NU + mc + 1] = -1.0;
    P.Gu[(r + 5) * NU + fc + 2] = -lh;  P.Gu[(r + 5) * NU + mc + 1] = 1.0;
    P.Gu[(r + 6) * NU + fc + 2] = -1.0;
    P.Gu[(r + 7) * NU + fc + 2] = 1.0;
  }
  P.d.assign(T * NI, 0.0);
  for (int t = 0; t < T; ++t) {
    P.d[t * NI + 7] = f_max * contact[t * 2 + 0];
    P.d[t * NI + 15] = f_max * contact[t * 2 + 1];
  }
}

// structured matvecs -------------------------------------------------------

void g_matvec(const Problem& P, const double* x, double* out) {
  const double* u = x + NX * P.T;
  for (int t = 0; t < P.T; ++t)
    for (int r = 0; r < NI; ++r) {
      double acc = 0.0;
      for (int j = 0; j < NU; ++j) acc += P.Gu[r * NU + j] * u[t * NU + j];
      out[t * NI + r] = acc;
    }
}

void gT_matvec(const Problem& P, const double* lam, double* out) {
  std::memset(out, 0, sizeof(double) * P.nz());
  double* gu = out + NX * P.T;
  for (int t = 0; t < P.T; ++t)
    for (int r = 0; r < NI; ++r) {
      double l = lam[t * NI + r];
      for (int j = 0; j < NU; ++j) gu[t * NU + j] += l * P.Gu[r * NU + j];
    }
}

void a_matvec(const Problem& P, const double* z, double* out) {
  const double* x = z;
  const double* u = z + NX * P.T;
  for (int t = 0; t < P.T; ++t)
    for (int i = 0; i < NX; ++i) {
      double acc = x[t * NX + i];
      if (t >= 1)
        for (int j = 0; j < NX; ++j)
          acc -= P.Ad[i * NX + j] * x[(t - 1) * NX + j];
      for (int j = 0; j < NX; ++j) acc -= P.Bd[i * NX + j] * u[t * NU + j];
      out[t * NX + i] = acc;
    }
  for (int t = 0; t < P.T; ++t) {
    out[NX * P.T + 2 * t] = u[t * NU + 6];
    out[NX * P.T + 2 * t + 1] = u[t * NU + 9];
  }
}

void aT_matvec(const Problem& P, const double* y, double* out) {
  std::memset(out, 0, sizeof(double) * P.nz());
  const double* ydyn = y;
  const double* ymx = y + NX * P.T;
  for (int t = 0; t < P.T; ++t) {
    for (int i = 0; i < NX; ++i) {
      double gx = ydyn[t * NX + i];
      if (t + 1 < P.T)
        for (int j = 0; j < NX; ++j)
          gx -= P.Ad[j * NX + i] * ydyn[(t + 1) * NX + j];
      out[t * NX + i] = gx;
    }
    for (int j = 0; j < NU; ++j) {
      double gu = 0.0;
      for (int i = 0; i < NX; ++i)
        gu -= P.Bd[i * NX + j] * ydyn[t * NX + i];
      out[NX * P.T + t * NU + j] = gu;
    }
    out[NX * P.T + t * NU + 6] += ymx[2 * t];
    out[NX * P.T + t * NU + 9] += ymx[2 * t + 1];
  }
}

// --- PDIPM (reference update rule, reduced 380-dim system) ---------------

void frac_to_boundary(const double* v, const double* dv, int n, double* alpha) {
  double mn = 1.0;
  for (int i = 0; i < n; ++i)
    if (dv[i] < 0.0) {
      double c = -v[i] / dv[i];
      if (c < mn) mn = c;
    }
  double a = 0.99 * mn;
  if (a > 1.0) a = 1.0;
  if (a < 1e-12) a = 1e-12;
  *alpha = a;
}

void pdipm_solve(const Problem& P, int iterations, double beta, double delta,
                 double* x, double* s, double* z, double* y) {
  const int T = P.T, nz = P.nz(), ne = P.neq(), ni = P.nineq();
  const int rd = nz + ne;  // reduced dim

  std::vector<double> rx(nz), re(ne), rs(ni), b(ne, 0.0);
  for (int i = 0; i < NX; ++i) b[i] = P.b0[i];
  for (int t = 1; t < T; ++t)
    for (int i = 0; i < NX; ++i) b[t * NX + i] = P.cd[i];

  std::vector<double> M(rd * rd), rhs(rd), tmp_nz(nz), tmp_ni(ni), tmp_ne(ne);
  std::vector<double> dxa(nz), dsa(ni), dza(ni), dya(ne);
  std::vector<double> dxc(nz), dsc(ni), dzc(ni), dyc(ne);
  LU lu;

  for (int it = 0; it < iterations; ++it) {
    // residuals
    gT_matvec(P, z, rx.data());
    aT_matvec(P, y, tmp_nz.data());
    for (int i = 0; i < nz; ++i)
      rx[i] += P.hdiag[i] * x[i] + P.f[i] + tmp_nz[i];
    a_matvec(P, x, re.data());
    for (int i = 0; i < ne; ++i) re[i] -= b[i];
    g_matvec(P, x, rs.data());
    for (int i = 0; i < ni; ++i) rs[i] += s[i] - P.d[i];
    double mu = 0.0;
    for (int i = 0; i < ni; ++i) mu += s[i] * z[i];
    mu /= ni;

    std::vector<double> sig(ni), winv(ni);
    for (int i = 0; i < ni; ++i) {
      sig[i] = z[i] / s[i] + delta;
      winv[i] = sig[i] / (1.0 + delta * sig[i]);
    }

    // reduced matrix [[H+b+G^T W^-1 G, A^T],[A, -dI]], order [x, u, y]
    std::fill(M.begin(), M.end(), 0.0);
    for (int i = 0; i < nz; ++i) M[i * rd + i] = P.hdiag[i] + beta;
    for (int i = 0; i < ne; ++i) M[(nz + i) * rd + (nz + i)] = -delta;
    for (int t = 0; t < T; ++t)  // u-block G^T W^-1 G
      for (int i = 0; i < NU; ++i)
        for (int j = 0; j < NU; ++j) {
          double acc = 0.0;
          for (int r = 0; r < NI; ++r)
            acc += P.Gu[r * NU + i] * winv[t * NI + r] * P.Gu[r * NU + j];
          M[(NX * T + t * NU + i) * rd + (NX * T + t * NU + j)] += acc;
        }
    // A blocks
    for (int t = 0; t < T; ++t) {
      for (int i = 0; i < NX; ++i) {
        int row = nz + t * NX + i;
        M[row * rd + t * NX + i] += 1.0;
        M[(t * NX + i) * rd + row] += 1.0;
        if (t >= 1)
          for (int j = 0; j < NX; ++j) {
            M[row * rd + (t - 1) * NX + j] -= P.Ad[i * NX + j];
            M[((t - 1) * NX + j) * rd + row] -= P.Ad[i * NX + j];
          }
        for (int j = 0; j < NX; ++j) {
          M[row * rd + NX * T + t * NU + j] -= P.Bd[i * NX + j];
          M[(NX * T + t * NU + j) * rd + row] -= P.Bd[i * NX + j];
        }
      }
      int r0 = nz + NX * T + 2 * t;
      M[r0 * rd + NX * T + t * NU + 6] += 1.0;
      M[(NX * T + t * NU + 6) * rd + r0] += 1.0;
      M[(r0 + 1) * rd + NX * T + t * NU + 9] += 1.0;
      M[(NX * T + t * NU + 9) * rd + (r0 + 1)] += 1.0;
    }
    lu.factor(M.data(), rd);

    auto reduced_solve = [&](const double* r1, const double* r2,
                             const double* r3, const double* r4, double* dx,
                             double* ds, double* dz, double* dy) {
      for (int i = 0; i < ni; ++i) tmp_ni[i] = winv[i] * (r3[i] - r2[i] / sig[i]);
      gT_matvec(P, tmp_ni.data(), tmp_nz.data());
      for (int i = 0; i < nz; ++i) rhs[i] = r1[i] + tmp_nz[i];
      for (int i = 0; i < ne; ++i) rhs[nz + i] = r4[i];
      lu.solve(rhs.data());
      std::memcpy(dx, rhs.data(), sizeof(double) * nz);
      std::memcpy(dy, rhs.data() + nz, sizeof(double) * ne);
      g_matvec(P, dx, tmp_ni.data());
      for (int i = 0; i < ni; ++i) {
        dz[i] = winv[i] * (tmp_ni[i] + r2[i] / sig[i] - r3[i]);
        ds[i] = (r2[i] - dz[i]) / sig[i];
      }
    };

    // affine direction
    std::vector<double> r1(nz), r2(ni), r3(ni), r4(ne);
    for (int i = 0; i < nz; ++i) r1[i] = -rx[i];
    for (int i = 0; i < ni; ++i) r2[i] = -(s[i] * z[i]) / s[i];
    for (int i = 0; i < ni; ++i) r3[i] = -rs[i];
    for (int i = 0; i < ne; ++i) r4[i] = -re[i];
    reduced_solve(r1.data(), r2.data(), r3.data(), r4.data(), dxa.data(),
                  dsa.data(), dza.data(), dya.data());

    double a_p, a_d;
    frac_to_boundary(s, dsa.data(), ni, &a_p);
    frac_to_boundary(z, dza.data(), ni, &a_d);
    double mu_aff = 0.0;
    for (int i = 0; i < ni; ++i)
      mu_aff += (s[i] + a_p * dsa[i]) * (z[i] + a_d * dza[i]);
    mu_aff /= ni;
    double ratio = mu_aff / mu;
    double sigma_c = ratio * ratio * ratio;

    // corrector
    std::fill(r1.begin(), r1.end(), 0.0);
    std::fill(r3.begin(), r3.end(), 0.0);
    std::fill(r4.begin(), r4.end(), 0.0);
    for (int i = 0; i < ni; ++i)
      r2[i] = -(s[i] * z[i] + dsa[i] * dza[i] - sigma_c * mu) / s[i];
    reduced_solve(r1.data(), r2.data(), r3.data(), r4.data(), dxc.data(),
                  dsc.data(), dzc.data(), dyc.data());

    for (int i = 0; i < nz; ++i) dxa[i] += dxc[i];
    for (int i = 0; i < ni; ++i) { dsa[i] += dsc[i]; dza[i] += dzc[i]; }
    for (int i = 0; i < ne; ++i) dya[i] += dyc[i];
    frac_to_boundary(s, dsa.data(), ni, &a_p);
    frac_to_boundary(z, dza.data(), ni, &a_d);

    for (int i = 0; i < nz; ++i) x[i] += a_p * dxa[i];
    for (int i = 0; i < ni; ++i) {
      s[i] = std::fmax(s[i] + a_p * dsa[i], 1e-8);
      z[i] = std::fmax(z[i] + a_d * dza[i], 1e-8);
    }
    for (int i = 0; i < ne; ++i) y[i] += a_d * dya[i];
  }
}

}  // namespace

extern "C" {

// Debug: solve M x = b with the internal LU (x overwrites b).
void srbd_mpc_debug_lu(int n, const double* m, double* b) {
  LU lu;
  lu.factor(m, n);
  lu.solve(b);
}

// Debug: dump the assembled per-env problem (Ad, Bd, cd, b0, hdiag, f, d)
// for cross-checking against the Python assembly in tests.
void srbd_mpc_dump_problem(
    int T, int euler_rt, double dt, double mu, double mass,
    const double* Q, const double* Rw, const double* x0, const double* xref,
    const double* contact, const double* rot, const double* iw,
    const double* bpos, const double* lf, const double* rf,
    const double* res_lin, const double* res_ang,
    double* ad_out, double* bd_out, double* cd_out, double* b0_out,
    double* hdiag_out, double* f_out, double* d_out) {
  Problem P;
  build_dynamics(rot, iw, bpos, lf, rf, mass, res_lin, res_ang, dt, euler_rt,
                 P);
  build_qp(x0, xref, contact, Q, Rw, mu, T, P);
  std::memcpy(ad_out, P.Ad.data(), sizeof(double) * NX * NX);
  std::memcpy(bd_out, P.Bd.data(), sizeof(double) * NX * NX);
  std::memcpy(cd_out, P.cd.data(), sizeof(double) * NX);
  std::memcpy(b0_out, P.b0.data(), sizeof(double) * NX);
  std::memcpy(hdiag_out, P.hdiag.data(), sizeof(double) * P.nz());
  std::memcpy(f_out, P.f.data(), sizeof(double) * P.nz());
  std::memcpy(d_out, P.d.data(), sizeof(double) * P.nineq());
}

// Solve `batch` SRBD-MPC QPs. Per-env input strides documented inline.
// x_out: (batch, 24*T) full primal solutions. n_threads: 0 = serial,
// otherwise OpenMP with that many threads (-1 = all cores).
void srbd_mpc_solve_batch(
    int batch, int T, int iterations, int euler_rt, double dt, double mu,
    double mass, double lt, double lh, double f_max,
    const double* Q,        // (12)
    const double* Rw,       // (12)
    const double* x0,       // (batch, 12)
    const double* xref,     // (batch, T*12)
    const double* contact,  // (batch, T*2)
    const double* rot,      // (batch, 9) row-major body rotation
    const double* iw,       // (batch, 9) world inertia
    const double* bpos,     // (batch, 3)
    const double* lf,       // (batch, 3) left foot pos (world)
    const double* rf,       // (batch, 3) right foot pos (world)
    const double* res_lin,  // (batch, 3)
    const double* res_ang,  // (batch, 3)
    int n_threads, double* x_out) {
  const int nz = 2 * NX * T;

  auto solve_one = [&](int e) {
    Problem P;
    build_dynamics(rot + 9 * e, iw + 9 * e, bpos + 3 * e, lf + 3 * e,
                   rf + 3 * e, mass, res_lin + 3 * e, res_ang + 3 * e, dt,
                   euler_rt, P);
    build_qp(x0 + NX * e, xref + NX * T * e, contact + 2 * T * e, Q, Rw, mu, T,
             P, lt, lh, f_max);
    // init per mpc_controller_cusadi.py:138-141: x=0, s=max(d,1), z=1, y=1
    std::vector<double> x(nz, 0.0), s(P.nineq()), z(P.nineq(), 1.0),
        y(P.neq(), 1.0);
    for (int i = 0; i < P.nineq(); ++i) s[i] = std::fmax(P.d[i], 1.0);
    pdipm_solve(P, iterations, 1e-8, 1e-8, x.data(), s.data(), z.data(),
                y.data());
    std::memcpy(x_out + nz * e, x.data(), sizeof(double) * nz);
  };

  if (n_threads == 0) {
    for (int e = 0; e < batch; ++e) solve_one(e);
  } else {
#ifdef _OPENMP
    if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel for schedule(dynamic)
    for (int e = 0; e < batch; ++e) solve_one(e);
#else
    for (int e = 0; e < batch; ++e) solve_one(e);
#endif
  }
}

}  // extern "C"
