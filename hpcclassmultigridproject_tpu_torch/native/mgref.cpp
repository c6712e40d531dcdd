// Native host runtime: bit-faithful serial CPU oracle for the TPU framework.
//
// A from-scratch C++ implementation of the capability contract in SURVEY.md §0
// (2-D advection–diffusion, Crank–Nicolson, geometric multigrid with red–black
// Gauss–Seidel).  It plays the role the serial C++ path plays in the reference
// (the cross-implementation oracle, SURVEY §4.2) — the TPU compute path is
// validated against this library in the test suite via ctypes.
//
// Design differences from the reference implementation (deliberate, this is
// not a translation): coefficient fields are precomputed once per level
// instead of recomputed per point per sweep; levels are owned by a
// std::vector-based Hierarchy; the velocity-tower restriction uses the correct
// per-level sizes (the reference mis-sizes them, SURVEY §2.9.1); and the
// whole library is exposed as a flat extern "C" API for ctypes.
//
// Build: g++ -O2 -shared -fPIC mgref.cpp -o libmgref.so   (see build.py)

#include <cmath>
#include <cstring>
#include <vector>

namespace {

using std::vector;

// One grid level: (n+1)^2 nodes, coefficient fields stored interior-shaped
// at full-grid indexing for simplicity.
struct Lvl {
  int n;
  double h;
  double diag_a, diag_b, inv_diag;
  vector<double> aa, bb, cc, dd;  // (n+1)^2, valid on interior
  vector<double> u, rhs, res;     // work fields
};

inline int at(int n, int i, int j) { return i * (n + 1) + j; }

// Precompute CN coefficients on a level from its velocity samples.
// Formulas: r = dt/(2h^2); aa/bb from v2 (j +/- 1), cc/dd from v1 (i +/- 1).
void set_coeffs(Lvl &L, const vector<double> &v1, const vector<double> &v2,
                double dt, double nu) {
  const int n = L.n;
  const double rr = 0.5 * dt / (L.h * L.h);
  const double hh = 0.5 * L.h;
  L.diag_a = 1.0 - 4.0 * rr * nu;
  L.diag_b = 1.0 + 4.0 * rr * nu;
  L.inv_diag = 1.0 / L.diag_a;
  L.aa.assign((n + 1) * (n + 1), 0.0);
  L.bb = L.aa; L.cc = L.aa; L.dd = L.aa;
  for (int i = 1; i < n; ++i)
    for (int j = 1; j < n; ++j) {
      const int p = at(n, i, j);
      L.aa[p] = rr * (-v2[p] * hh + nu);
      L.bb[p] = rr * ( v2[p] * hh + nu);
      L.cc[p] = rr * (-v1[p] * hh + nu);
      L.dd[p] = rr * ( v1[p] * hh + nu);
    }
}

// rhs = B u on the interior (explicit CN half-step).
void rhs_of(const Lvl &L, const double *u, double *out) {
  const int n = L.n;
  for (int i = 1; i < n; ++i)
    for (int j = 1; j < n; ++j) {
      const int p = at(n, i, j);
      out[p] = L.diag_b * u[p]
             - L.cc[p] * u[p - (n + 1)] - L.dd[p] * u[p + (n + 1)]
             - L.aa[p] * u[p - 1]       - L.bb[p] * u[p + 1];
    }
}

// res = rhs - A u on the interior.
void residual_of(const Lvl &L, const double *u, const double *rhs, double *out) {
  const int n = L.n;
  for (int i = 1; i < n; ++i)
    for (int j = 1; j < n; ++j) {
      const int p = at(n, i, j);
      out[p] = rhs[p] - (L.diag_a * u[p]
             + L.cc[p] * u[p - (n + 1)] + L.dd[p] * u[p + (n + 1)]
             + L.aa[p] * u[p - 1]       + L.bb[p] * u[p + 1]);
    }
}

double norm_of(const Lvl &L, const double *res) {
  const int n = L.n;
  double s = 0.0;
  for (int i = 1; i < n; ++i)
    for (int j = 1; j < n; ++j) {
      const double v = res[at(n, i, j)];
      s += v * v;
    }
  return std::sqrt(s);
}

// One red-black GS sweep: all (i+j)-even interior nodes, then all odd.
void gs_sweep(const Lvl &L, double *u, const double *rhs) {
  const int n = L.n;
  for (int color = 0; color < 2; ++color)
    for (int i = 1; i < n; ++i) {
      int j = 1 + ((i + 1 + color) % 2);  // first j with (i+j)%2 == color
      for (; j < n; j += 2) {
        const int p = at(n, i, j);
        u[p] = (rhs[p]
              - L.cc[p] * u[p - (n + 1)] - L.dd[p] * u[p + (n + 1)]
              - L.aa[p] * u[p - 1]       - L.bb[p] * u[p + 1]) * L.inv_diag;
      }
    }
}

// Injection restriction (2n+1)^2 -> (n+1)^2.
void inject(const double *fine, int nf, double *coarse) {
  const int nc = nf / 2;
  for (int i = 0; i <= nc; ++i)
    for (int j = 0; j <= nc; ++j)
      coarse[at(nc, i, j)] = fine[at(nf, 2 * i, 2 * j)];
}

// Bilinear prolongation (n+1)^2 -> (2n+1)^2.
void prolong(const double *coarse, int nc, double *fine) {
  const int nf = 2 * nc;
  for (int i = 0; i <= nf; ++i)
    for (int j = 0; j <= nf; ++j) {
      const int ic = i / 2, jc = j / 2;
      double v;
      if (i % 2 == 0 && j % 2 == 0)
        v = coarse[at(nc, ic, jc)];
      else if (j % 2 == 0)
        v = 0.5 * (coarse[at(nc, ic, jc)] + coarse[at(nc, ic + 1, jc)]);
      else if (i % 2 == 0)
        v = 0.5 * (coarse[at(nc, ic, jc)] + coarse[at(nc, ic, jc + 1)]);
      else
        v = 0.25 * (coarse[at(nc, ic, jc)] + coarse[at(nc, ic + 1, jc)]
                  + coarse[at(nc, ic, jc + 1)] + coarse[at(nc, ic + 1, jc + 1)]);
      fine[at(nf, i, j)] = v;
    }
}

struct Hierarchy {
  vector<Lvl> lvls;
  int niter, shape, max_cycles, coarse_maxiter;
  double tol, coarse_tol;
};

// One V/W-cycle at level l (shape=1 V, 2 W); coarsest solved by iterated GS.
void cycle(Hierarchy &H, int l) {
  Lvl &L = H.lvls[l];
  const int n = L.n;
  for (int sh = 0; sh < H.shape; ++sh) {
    if (l == (int)H.lvls.size() - 1) {
      double r = 1.0;
      for (int it = 0; it < H.coarse_maxiter && r > H.coarse_tol; ++it) {
        gs_sweep(L, L.u.data(), L.rhs.data());
        residual_of(L, L.u.data(), L.rhs.data(), L.res.data());
        r = norm_of(L, L.res.data());
      }
    } else {
      Lvl &C = H.lvls[l + 1];
      for (int it = 0; it < H.niter; ++it) gs_sweep(L, L.u.data(), L.rhs.data());
      residual_of(L, L.u.data(), L.rhs.data(), L.res.data());
      inject(L.res.data(), n, C.rhs.data());
      std::fill(C.u.begin(), C.u.end(), 0.0);
      cycle(H, l + 1);
      prolong(C.u.data(), C.n, L.res.data());
      for (int p = 0; p < (n + 1) * (n + 1); ++p) L.u[p] += L.res[p];
      for (int it = 0; it < H.niter; ++it) gs_sweep(L, L.u.data(), L.rhs.data());
    }
  }
}

// Outer solve: cycles until rel. residual <= tol or max_cycles.
int solve(Hierarchy &H) {
  Lvl &F = H.lvls[0];
  residual_of(F, F.u.data(), F.rhs.data(), F.res.data());
  const double r0 = norm_of(F, F.res.data());
  double r = r0;
  int it = 0;
  for (; it < H.max_cycles && r / r0 > H.tol; ++it) {
    cycle(H, 0);
    residual_of(F, F.u.data(), F.rhs.data(), F.res.data());
    r = norm_of(F, F.res.data());
  }
  return it;
}

Hierarchy build(int n, int num_levels, double nu, double dt,
                const double *v1, const double *v2,
                int niter, int shape, int max_cycles, double tol,
                double coarse_tol, int coarse_maxiter) {
  Hierarchy H;
  H.niter = niter; H.shape = shape; H.max_cycles = max_cycles;
  H.tol = tol; H.coarse_tol = coarse_tol; H.coarse_maxiter = coarse_maxiter;
  vector<double> v1l(v1, v1 + (n + 1) * (n + 1));
  vector<double> v2l(v2, v2 + (n + 1) * (n + 1));
  for (int l = 0; l < num_levels; ++l) {
    Lvl L;
    L.n = n >> l;
    L.h = (1 << l) / double(n);
    const int sz = (L.n + 1) * (L.n + 1);
    L.u.assign(sz, 0.0); L.rhs.assign(sz, 0.0); L.res.assign(sz, 0.0);
    set_coeffs(L, v1l, v2l, dt, nu);
    H.lvls.push_back(std::move(L));
    if (l + 1 < num_levels) {  // correctly sized per-level restriction
      const int nc = (n >> l) / 2;
      vector<double> t1((nc + 1) * (nc + 1)), t2(t1.size());
      inject(v1l.data(), n >> l, t1.data());
      inject(v2l.data(), n >> l, t2.data());
      v1l.swap(t1); v2l.swap(t2);
    }
  }
  return H;
}

}  // namespace

extern "C" {

// Full timestepped run.  u0/v1/v2/uT are (n+1)*(n+1) row-major doubles;
// cycles_out (len nsteps, may be null) receives per-step cycle counts.
void adr_run(int n, int num_levels, double nu, double dt, int nsteps,
             double tol, int max_cycles, int niter, int shape,
             double coarse_tol, int coarse_maxiter,
             const double *u0, const double *v1, const double *v2,
             double *uT, int *cycles_out) {
  Hierarchy H = build(n, num_levels, nu, dt, v1, v2, niter, shape, max_cycles,
                      tol, coarse_tol, coarse_maxiter);
  Lvl &F = H.lvls[0];
  std::memcpy(F.u.data(), u0, F.u.size() * sizeof(double));
  for (int s = 0; s < nsteps; ++s) {
    rhs_of(F, F.u.data(), F.rhs.data());
    const int c = solve(H);
    if (cycles_out) cycles_out[s] = c;
  }
  std::memcpy(uT, F.u.data(), F.u.size() * sizeof(double));
}

// Single-kernel entry points for kernel-level golden tests.  All fields are
// (n+1)*(n+1); coefficient inputs are velocity fields (coefficients are
// derived internally, matching the framework's cn_coefficients).

static Lvl make_lvl(int n, double h, double dt, double nu,
                    const double *v1, const double *v2) {
  Lvl L; L.n = n; L.h = h;
  const int sz = (n + 1) * (n + 1);
  vector<double> v1v(v1, v1 + sz), v2v(v2, v2 + sz);
  set_coeffs(L, v1v, v2v, dt, nu);
  return L;
}

void adr_compute_rhs(int n, double h, double dt, double nu,
                     const double *v1, const double *v2,
                     const double *u, double *out) {
  Lvl L = make_lvl(n, h, dt, nu, v1, v2);
  rhs_of(L, u, out);
}

void adr_residual(int n, double h, double dt, double nu,
                  const double *v1, const double *v2,
                  const double *u, const double *rhs, double *out) {
  Lvl L = make_lvl(n, h, dt, nu, v1, v2);
  residual_of(L, u, rhs, out);
}

double adr_norm(int n, const double *res) {
  Lvl L; L.n = n;
  return norm_of(L, res);
}

void adr_gs_sweep(int n, double h, double dt, double nu,
                  const double *v1, const double *v2,
                  double *u, const double *rhs, int nsweeps) {
  Lvl L = make_lvl(n, h, dt, nu, v1, v2);
  for (int s = 0; s < nsweeps; ++s) gs_sweep(L, u, rhs);
}

void adr_prolong(int nc, const double *coarse, double *fine) {
  prolong(coarse, nc, fine);
}

void adr_restrict(int nf, const double *fine, double *coarse) {
  inject(fine, nf, coarse);
}

}  // extern "C"
