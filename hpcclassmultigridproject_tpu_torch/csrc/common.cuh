// Device code shared by the port's kernels: the CN coefficient recompute,
// the delta step's opening (K1, K8), the from_v red-black Gauss-Seidel block
// on a shared-memory window with its three coefficient sources (recomputed
// from (v1, v2), five stored bands, nine stored bands with a varying
// diagonal) and its variants (the tower's transfers, K8's opening), and the
// per-point bilinear prolongation.
//
// Every expression keeps the operation order of the JAX package's Pallas
// kernels and of the port's plain PyTorch versions (ops/padded.py), and the
// library is built with -fmad=false, so a kernel can be compared with its
// plain version on the card to the bit or near it.  Never build this with
// --use_fast_math: the TwoSum of the opening depends on IEEE ordering.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <map>
#include <mutex>
#include <utility>

namespace mg {

// How a smoothing block forms the starting iterate of each window cell.
enum LoadMode {
  LOAD_ZERO = 0,       // u = 0 (correction solves, K8's pre-smooth)
  LOAD_U = 1,          // u
  LOAD_U_CORR = 2,     // u + corr (the prolonged correction, post-smooth)
  LOAD_U_PROLONG = 3,  // u + bilinear prolongation of a coarser field
                       // (the tower's ascent, smooth_from_v<FV_PROLONG>)
};

// What it writes of the trailing residual rhs - A u.
enum ResMode {
  RES_NONE = 0,
  RES_FULL = 1,      // (rows, cols)
  RES_ROWS_DEC = 2,  // even global rows only, (rows / 2, cols)
  RES_INJECT = 3,    // coarse[I, J] = res[2I, 2J] (the tower's descent,
                     // smooth_from_v<FV_INJECT>; tower.cu's zero_past
                     // writes the coarse cells past the fine array)
};

// Where a from_v block takes the stencil coefficients from (smooth_from_v's
// FORM, a compile-time variant).
enum CoefForm {
  FORM_FROM_V = 0,  // recomputed from (v1, v2): the CN levels (K2, K3, K4,
                    // K7, K8)
  FORM_FIVE = 1,    // stored aa, bb, cc, dd; scalar diagonal (K5)
  FORM_NINE = 2,    // stored aa..dd, ne, nw, se, sw and diag (K6)
};

// Stored arrays: FORM_FIVE reads bands[0..3] = aa, bb, cc, dd; FORM_NINE
// also bands[4..7] = ne, nw, se, sw and bands[8] = diag.
constexpr int MAX_BANDS = 9;

template <typename T>
struct SmoothArgs {
  const T* u;       // LOAD_U, LOAD_U_CORR, LOAD_U_PROLONG
  const T* corr;    // LOAD_U_CORR
  const T* src;     // LOAD_U_PROLONG: the coarser field, (src_rows, src_cols)
  const T* rhs;     // all but K8, which forms it
  const T* hi;      // K8: the state pair and the pending correction
  const T* lo;
  const T* d;
  const T* v1;      // FORM_FROM_V
  const T* v2;
  const T* bands[MAX_BANDS];  // FORM_FIVE, FORM_NINE
  T* u_out;         // (rows, cols)
  T* res_out;       // (res_rows, res_cols), unless RES_NONE
  T* hi_out;        // K8: (hi', lo', rhs_delta) at the tile's cells
  T* lo_out;
  T* rhs_out;
  int rows, cols, n, nsweeps;
  int row_off;      // FORM_FROM_V: global row of array row 0 (K7's block
                    // of a row-partitioned level; 0 on a whole level)
  int src_rows, src_cols, res_rows, res_cols;
  int load_mode, res_mode;
  T rr, hh, nu, diag, inv_diag;  // constants, rounded to T on the host
                                 // (FORM_NINE reads none of them)
  T two_rnu, r_h;                // K8: 2 r nu and r h, likewise
};

template <typename T>
__device__ __forceinline__ T interior_at(int gi, int gj, int n) {
  return (gi >= 1 && gi <= n - 1 && gj >= 1 && gj <= n - 1) ? T(1) : T(0);
}

template <typename T>
struct Pair {
  T hi, lo;
};

// (h, l) + x by TwoSum with a Fast2Sum renormalization
// (mg/delta.py::_accumulate): the accumulated pair (hi', lo').
template <typename T>
__device__ __forceinline__ Pair<T> accumulate(T h, T l, T x) {
  const T t = h + x;
  const T bv = t - h;
  const T err = (h - (t - bv)) + (x - bv);
  const T lo2 = l + err;
  const T hi2 = t + lo2;
  const T lo3 = lo2 - (hi2 - t);
  return {hi2, lo3};
}

// accumulate at node (i, j) of the arrays, or (0, 0) past them.
template <typename T>
__device__ __forceinline__ Pair<T> accumulate_at(const T* hi, const T* lo,
                                                 const T* d, int rows,
                                                 int cols, int i, int j) {
  if (i < 0 || i >= rows || j < 0 || j >= cols) return {T(0), T(0)};
  const size_t g = static_cast<size_t>(i) * cols + j;
  return accumulate(hi[g], lo[g], d[g]);
}

// lap, D_i and D_j of one member of the accumulated pair at a node, from
// its value there (x) and at its four neighbours (mg/delta.py::_dform).
template <typename T>
struct DForm {
  T lap, di, dj;
};

template <typename T>
__device__ __forceinline__ DForm<T> dform(T x, T up, T dn, T lf, T rt) {
  return {(up - x) + (dn - x) + (lf - x) + (rt - x), dn - up, rt - lf};
}

// The difference-form delta rhs at a node from the dform of hi' (h) and of
// lo' (l),
//   rhs = -2 r nu lap(hi' + lo') - r h (v1 D_i + v2 D_j),
// times the interior mask m, in the operation order of
// mg/delta.py::delta_rhs: the hi' terms plus the lo' terms, then the rest.
// K1 and K8 both call dform and this, so their rhs agree to the bit.
template <typename T>
__device__ __forceinline__ T delta_rhs(const DForm<T>& h, const DForm<T>& l,
                                       T v1, T v2, T m, T two_rnu, T r_h) {
  const T lap = h.lap + l.lap, di = h.di + l.di, dj = h.dj + l.dj;
  return (-(two_rnu * lap) - r_h * (v1 * di + v2 * dj)) * m;
}

template <typename T>
struct Opened {
  T hi, lo, rhs;
};

// K1's opening at node (i, j) of the array: the accumulated pair and the
// delta rhs, masked to the open interior.  A neighbour's (hi', lo') is a
// pointwise function of that neighbour's (hi, lo, d), so it is recomputed
// from their loads.
template <typename T>
__device__ __forceinline__ Opened<T> delta_open_at(
    const T* hi, const T* lo, const T* d, const T* v1, const T* v2, int rows,
    int cols, int i, int j, int n, T two_rnu, T r_h) {
  const Pair<T> x = accumulate_at(hi, lo, d, rows, cols, i, j);
  const Pair<T> up = accumulate_at(hi, lo, d, rows, cols, i - 1, j);
  const Pair<T> dn = accumulate_at(hi, lo, d, rows, cols, i + 1, j);
  const Pair<T> lf = accumulate_at(hi, lo, d, rows, cols, i, j - 1);
  const Pair<T> rt = accumulate_at(hi, lo, d, rows, cols, i, j + 1);
  const size_t g = static_cast<size_t>(i) * cols + j;
  return {x.hi, x.lo,
          delta_rhs(dform(x.hi, up.hi, dn.hi, lf.hi, rt.hi),
                    dform(x.lo, up.lo, dn.lo, lf.lo, rt.lo), v1[g], v2[g],
                    interior_at<T>(i, j, n), two_rnu, r_h)};
}

template <typename T>
struct Coefs {
  T aa, bb, cc, dd;
};

// aa -> u[i,j-1], bb -> u[i,j+1], cc -> u[i-1,j], dd -> u[i+1,j], zero
// outside the open interior (m = 0).
template <typename T>
__device__ __forceinline__ Coefs<T> coefs_at(T v1, T v2, T m, T rr, T hh,
                                             T nu) {
  Coefs<T> k;
  k.aa = rr * (-v2 * hh + nu) * m;
  k.bb = rr * (v2 * hh + nu) * m;
  k.cc = rr * (-v1 * hh + nu) * m;
  k.dd = rr * (v1 * hh + nu) * m;
  return k;
}

template <typename T>
__device__ __forceinline__ T at_or_zero(const T* x, int rows, int cols, int i,
                                        int j) {
  return (i < rows && j < cols) ? x[static_cast<size_t>(i) * cols + j] : T(0);
}

// Bilinear prolongation of the coarse field c at the fine nodes (i, j) and
// (i, j + 1), j even: rows first, then columns, as
// ops/padded.py::prolong_bilinear interleaves them (an odd row's odd
// column is half the sum of its even neighbour's value and the next
// column's row average).
template <typename T>
__device__ __forceinline__ void prolong_pair(const T* c, int rows_c,
                                             int cols_c, int i, int j, T& p0,
                                             T& p1) {
  const int I = i >> 1, J = j >> 1;
  const T half = T(0.5);
  const T c00 = at_or_zero(c, rows_c, cols_c, I, J);
  const T c01 = at_or_zero(c, rows_c, cols_c, I, J + 1);
  if (!(i & 1)) {
    p0 = c00;
    p1 = half * (c00 + c01);
    return;
  }
  const T c10 = at_or_zero(c, rows_c, cols_c, I + 1, J);
  const T c11 = at_or_zero(c, rows_c, cols_c, I + 1, J + 1);
  p0 = half * (c00 + c10);
  p1 = half * (p0 + half * (c01 + c11));
}

// ---------------------------------------------------------------------------
// The from_v smoothing block: K2 and K7 (mg_smooth), every level of the
// tower (K3, K4: tower.cu, with their transfers as compile-time variants),
// K8's whole-step opening (delta_step.cu, FV_OPEN: the opening forms the
// rhs in the window), and with its coefficients loaded from stored bands in
// place of their recompute from (v1, v2), K5 (mg_smooth5, FORM_FIVE) and K6
// (mg_smooth9, FORM_NINE).  A red-black cascade on a shared-memory window
// is bound by instruction issue once its bytes are read once: the block
// forms no index, parity, mask or coefficient in a color pass, reads no
// neighbour through a bounds test, and touches no shared word twice in a
// warp's access.  It:
//
//  - has a window of fixed shape, FV_WIN_H x FV_WIN_W = 64 x 64, whose
//    halo follows nsweeps: hr = 2*nsweeps+1 rows and hc = hr rounded up to
//    FV_COL_ALIGN columns on each side, so the output tile is
//    (64 - 2 hr) x (64 - 2 hc): 50 x 48 at nsweeps 3 (the window 1.71x
//    the tile), 58 x 56 at nsweeps 1;
//  - stores the window as two planes, its even and its odd columns (32
//    cells a row each).  In a row one plane holds the red cells and the
//    other the black, so a color pass reads and writes whole warps of
//    consecutive words: no bank conflict.  A zero border (row -1 and
//    FV_WIN_H, pair -1 and FV_PAIRS) gives a cell whose neighbour lies past
//    the window 0 there, with no bounds test;
//  - maps threads to cells once: warp g owns window rows g, g+16, g+32 and
//    g+48, lane k the pair of columns (2k, 2k+1) of each.  The thread
//    issues the global loads of its pairs (two values at a time where the
//    rows are aligned) together, five a cell, before it uses any, forms
//    their rhs and edge coefficients once, and keeps them in registers
//    (FV_ROWS x 2 x 5 values), so a five-point color pass is, per cell,
//    four shared loads, the neighbour sum, the update and one shared
//    store.  A warp's rows share a parity, so which column of its pairs is
//    red is fixed per warp, and a pass branches on it once;
//  - in FORM_NINE (K6) also keeps each cell's corner bands and 1/diag,
//    formed once a launch as T(1) / diag, in dynamic shared memory, one
//    word a thread in a row (FV_NINE_WORDS a cell), where registers cannot
//    hold them in float64.  A nine-point pass reads the corners, which
//    share the cell's color and are updated in the same pass, at their
//    values from before it: every thread forms its cells' updates into
//    registers, the block meets at a barrier, then stores them.  The
//    diagonal itself is read once more at the residual;
//  - in FV_OPEN (K8) loads hi, lo and d where the others load rhs, u and
//    corr, folds each cell once and stores (hi', lo') at the tile's cells;
//    the u planes then hold hi' of the window, whose lap, D_i and D_j each
//    thread forms for its cells, then lo', whose terms complete each cell's
//    rhs (0 past the window), then u = 0.  One plane pair serves both, so
//    the block takes no dynamic memory and leaves the SM its L1: on the
//    H100 a second, dynamic pair for lo' measured 1.4% slower, and 13%
//    slower under the max-shared carveout that K6's launch asks for;
//  - runs two blocks of 512 threads per SM in float32 (64 registers, no
//    spill) and one in float64.
//
// Every expression keeps the operation order of the plain versions
// (coefs_at; cc*up + dd*dn + aa*lf + bb*rt, then + ne*ur + nw*ul + se*dr +
// sw*dl on a nine-band level; (rhs - nb)*inv; rhs - diag*u - nb).  The
// window holds exactly what a global barrier between colors would give:
// each side's halo is at least 2*nsweeps+1 cells, a cell whose neighbour
// lies past the window reads 0 there, and the error that makes moves one
// cell a pass (corners included: the nine-point stencil has radius 1 too),
// so after the cascade and the residual it has not reached the tile.  In
// FV_OPEN the rhs is wrong only at the window's edge cells, whose
// neighbours past the window read 0 in the pair planes; from u = 0 the
// error then reaches depth p after pass p and depth 2*nsweeps at the
// residual, as before (the JAX kernel's own argument,
// ops/pallas/delta_step.py::_kernel_open_smooth).  Cells past the array are
// 0 and stay 0: the from_v mask, the stored bands, the rhs and an opened
// pair are 0 there, and a nine-band diagonal is 1 there, so 1/diag stays
// finite.
constexpr int FV_WIN_H = 64;
constexpr int FV_WIN_W = 64;
constexpr int FV_COL_ALIGN = 4;
constexpr int FV_PAIRS = FV_WIN_W / 2;  // one warp's lanes
constexpr int FV_WARPS = 16;
constexpr int FV_THREADS = FV_WARPS * FV_PAIRS;
constexpr int FV_ROWS = FV_WIN_H / FV_WARPS;  // window rows a thread owns
constexpr int FV_STRIDE = FV_PAIRS + 2;       // a plane row, with its border
static_assert(FV_PAIRS == 32 && FV_WARPS % 2 == 0 && FV_WIN_H % FV_WARPS == 0,
              "a warp owns one half-row; a thread's rows share a parity");

// Halo of the from_v block on each side: rows, and columns (rounded up),
// and the output tile they leave in the window.
__host__ __device__ constexpr int fv_halo_rows(int nsweeps) {
  return 2 * nsweeps + 1;
}
__host__ __device__ constexpr int fv_halo_cols(int nsweeps) {
  return (2 * nsweeps + FV_COL_ALIGN) / FV_COL_ALIGN * FV_COL_ALIGN;
}
__host__ __device__ constexpr int fv_tile_rows(int nsweeps) {
  return FV_WIN_H - 2 * fv_halo_rows(nsweeps);
}
__host__ __device__ constexpr int fv_tile_cols(int nsweeps) {
  return FV_WIN_W - 2 * fv_halo_cols(nsweeps);
}

// The most sweeps one run of the block takes (a tile of at least 2 x 2
// left); more run as a chain of runs, each from the last one's iterate.
constexpr int FV_MAX_SWEEPS = 13;
static_assert(fv_tile_rows(FV_MAX_SWEEPS) >= 2 &&
                  fv_tile_cols(FV_MAX_SWEEPS) >= 2 &&
                  fv_tile_cols(FV_MAX_SWEEPS + 1) < 2,
              "FV_MAX_SWEEPS is the last nsweeps that leaves a tile");

// Blocks per SM the register budget is set for: two in float32 (64
// registers a thread); in float64 the coefficient registers double.
template <typename T>
constexpr int fv_min_blocks() {
  return sizeof(T) == 4 ? 2 : 1;
}

// A cell's rhs and coefficients, formed once a launch.
template <typename T>
struct FvCell {
  T rhs, aa, bb, cc, dd;
};

// Two adjacent values: one load or store where they are aligned as a pair.
template <typename T>
struct FvPair;
template <>
struct FvPair<float> {
  using type = float2;
};
template <>
struct FvPair<double> {
  using type = double2;
};

// How the block moves a thread's two values of a row: as one aligned pair
// (every row of every array starts aligned to a pair), or one by one.
enum FvAccess { FV_SINGLES = 0, FV_PAIRED = 1 };

// (p[at], p[at + 1]), each 0 where it lies past the array (!in0, !in1).
// FV_PAIRED: the two are one aligned pair, inside or past the array alike.
template <int ACCESS, typename T>
__device__ __forceinline__ void fv_load(const T* p, size_t at, bool in0,
                                        bool in1, T& x, T& y) {
  if constexpr (ACCESS == FV_PAIRED) {
    using T2 = typename FvPair<T>::type;
    const T2 v = in0 ? *reinterpret_cast<const T2*>(p + at) : T2{T(0), T(0)};
    x = v.x;
    y = v.y;
  } else {
    x = in0 ? p[at] : T(0);
    y = in1 ? p[at + 1] : T(0);
  }
}

template <int ACCESS, typename T>
__device__ __forceinline__ void fv_store(T* p, size_t at, bool in0, bool in1,
                                         T x, T y) {
  if constexpr (ACCESS == FV_PAIRED) {
    if (in0) *reinterpret_cast<typename FvPair<T>::type*>(p + at) = {x, y};
  } else {
    if (in0) p[at] = x;
    if (in1) p[at + 1] = y;
  }
}

// One color pass over the thread's cells of one column parity: they lie
// in `self` (the plane of that parity), whose rows above and below hold
// the other color, and their left and right neighbours in `other`, at
// offsets `lf` and `lf + 1` from the thread's first cell `cell`.
template <typename T>
__device__ __forceinline__ void fv_pass(T* self, const T* __restrict__ other,
                                        const FvCell<T> (&c)[FV_ROWS],
                                        int cell, int lf, T inv) {
#pragma unroll
  for (int j = 0; j < FV_ROWS; ++j) {
    const int at = cell + j * FV_WARPS * FV_STRIDE;
    const int side = lf + j * FV_WARPS * FV_STRIDE;
    const T nb = c[j].cc * self[at - FV_STRIDE] +
                 c[j].dd * self[at + FV_STRIDE] + c[j].aa * other[side] +
                 c[j].bb * other[side + 1];
    self[at] = (c[j].rhs - nb) * inv;
  }
}

// FORM_NINE keeps each cell's corner bands (ne, nw, se, sw) and 1/diag in
// dynamic shared memory: word q of the thread's cell in row j and column
// parity p at ((q * FV_ROWS + j) * 2 + p) * FV_THREADS + threadIdx.x, so a
// warp reads 32 consecutive words.
constexpr int FV_NINE_WORDS = 5;
constexpr int FV_NINE_Q = FV_ROWS * 2 * FV_THREADS;  // word q to word q + 1
template <typename T>
constexpr size_t fv_nine_smem_bytes() {
  return static_cast<size_t>(FV_NINE_WORDS) * FV_NINE_Q * sizeof(T);
}

// The nine-point neighbour sum of the cell at `at` of `self` (left
// neighbour other[side]), whose corner words start at `x`.
template <typename T>
__device__ __forceinline__ T fv_nb9(const T* self, const T* other,
                                    const FvCell<T>& c, const T* x, int at,
                                    int side) {
  return c.cc * self[at - FV_STRIDE] + c.dd * self[at + FV_STRIDE] +
         c.aa * other[side] + c.bb * other[side + 1] +
         x[0] * other[side + 1 - FV_STRIDE] +
         x[FV_NINE_Q] * other[side - FV_STRIDE] +
         x[2 * FV_NINE_Q] * other[side + 1 + FV_STRIDE] +
         x[3 * FV_NINE_Q] * other[side + FV_STRIDE];
}

// fv_pass on a nine-band level: the updates of the thread's cells of one
// column parity (whose row-0 words start at `x`), all read before any is
// stored, into `upd`; the caller stores them after a barrier.
template <typename T>
__device__ __forceinline__ void fv_pass9(const T* self, const T* other,
                                         const FvCell<T> (&c)[FV_ROWS],
                                         const T* x, int cell, int lf,
                                         T (&upd)[FV_ROWS]) {
#pragma unroll
  for (int j = 0; j < FV_ROWS; ++j) {
    const int at = cell + j * FV_WARPS * FV_STRIDE;
    const int side = lf + j * FV_WARPS * FV_STRIDE;
    const T* xj = x + j * 2 * FV_THREADS;
    upd[j] = (c[j].rhs - fv_nb9(self, other, c[j], xj, at, side)) *
             xj[4 * FV_NINE_Q];
  }
}

// What a from_v block does besides smoothing, fixed at compile time so that
// K2 and K7 carry none of the other kernels' code: nothing (K2, K7); the
// descent's injection of the residual into the next coarser rhs (K3,
// RES_INJECT); the ascent's bilinear prolongation of the coarser solution,
// added to u as it is loaded (K4, LOAD_U_PROLONG); or the delta step's
// opening, which forms the rhs the cascade from u = 0 then takes (K8).
enum FvXfer { FV_SMOOTH = 0, FV_INJECT = 1, FV_PROLONG = 2, FV_OPEN = 3 };

// FV_OPEN: dform of the pair member in the planes at the cell `at` of
// `self`, whose left neighbour is other[side].
template <typename T>
__device__ __forceinline__ DForm<T> fv_dform(const T* self, const T* other,
                                             int at, int side) {
  return dform(self[at], self[at - FV_STRIDE], self[at + FV_STRIDE],
               other[side], other[side + 1]);
}

// What changes between the runs of the block on one level: the iterate it
// starts from and the one it writes, the sweeps, the load and residual
// modes, under SmoothArgs' names.  The tower changes them from link to link
// of a level chained past FV_MAX_SWEEPS; K2 and K7 pass their SmoothArgs.
template <typename T>
struct FvRun {
  const T* u;
  T* u_out;
  int nsweeps, load_mode, res_mode;
};

// One run of the block on tile (ty, tx) of the level `a`, with the iterate,
// sweeps and modes of `run` (a's own for K2, K5, K6 and K7, an FvRun for a
// link of the tower), and the coefficients of FORM.  Every global array the
// tower writes in one level phase and reads in a later one (the coarser
// rhs, the coarser solution, a chain's iterate) is read by plain loads:
// nothing here takes the read-only path (no __ldg, no const __restrict__ on
// a global pointer), whose cache does not see those writes.
template <typename T, int ACCESS, int XFER = FV_SMOOTH, int FORM = FORM_FROM_V,
          typename Run>
__device__ void smooth_from_v(const SmoothArgs<T>& a, const Run& run, int ty,
                              int tx) {
  static_assert(FORM == FORM_FROM_V || XFER == FV_SMOOTH,
                "the tower's transfers run on from_v levels");
  static_assert(XFER != FV_OPEN || FORM == FORM_FROM_V,
                "the opening runs on from_v levels");
  __shared__ T plane[2][(FV_WIN_H + 2) * FV_STRIDE];  // even, odd columns
  extern __shared__ __align__(16) unsigned char mg_smem[];  // FORM_NINE
  const int hr = fv_halo_rows(run.nsweeps), hc = fv_halo_cols(run.nsweeps);
  const int gi0 = ty * (FV_WIN_H - 2 * hr) - hr;
  const int gj0 = tx * (FV_WIN_W - 2 * hc) - hc;
  const int k = threadIdx.x % FV_PAIRS, g = threadIdx.x / FV_PAIRS;
  const int gj = gj0 + 2 * k;  // the thread's columns: gj and gj + 1
  const int cell = (g + 1) * FV_STRIDE + k + 1;
  // the tile's columns [hc, FV_WIN_W - hc) hold the thread's pair whole or
  // none of it
  const bool tile_pair = 2 * k >= hc && 2 * k < FV_WIN_W - hc;
  // the odd column of the thread's pairs is red: rows of g's parity
  const bool odd_red = (gi0 + gj0 + g) & 1;
  // FORM_NINE: the corner words of the thread's cell in row j, parity p
  const auto nine = [&](int j, int p) {
    return reinterpret_cast<T*>(mg_smem) + (j * 2 + p) * FV_THREADS +
           threadIdx.x;
  };

  for (int q = threadIdx.x; q < 2 * (FV_WIN_H + 2); q += FV_THREADS) {
    T* row = plane[q & 1] + (q >> 1) * FV_STRIDE;
    row[0] = row[FV_STRIDE - 1] = T(0);
  }
  for (int q = threadIdx.x; q < 2 * FV_STRIDE; q += FV_THREADS) {
    plane[q & 1][q >> 1] = plane[q & 1][(FV_WIN_H + 1) * FV_STRIDE + (q >> 1)] =
        T(0);
  }

  // The thread's global loads are issued before any is used, so they are
  // in flight together: rhs, v1, v2, u and corr (or the prolongation; or
  // FV_OPEN's hi, v1, v2, lo and d) land in the five slots of the cell,
  // which the coefficients then take over.
  // The band forms land rhs, aa, bb, u and corr there, and once u + corr
  // is in the plane, the cc and dd bands take the slots u and corr held:
  // seven loads a cell in flight at once spill at the 64 registers of two
  // blocks an SM in float32, and measured slower.  FORM_NINE first loads
  // the corners and the diagonal (1 past the array) into shared memory,
  // with 1/diag.
  const bool col_in0 = gj >= 0 && gj < a.cols;
  const bool col_in1 = gj + 1 >= 0 && gj + 1 < a.cols;
  if constexpr (FORM == FORM_NINE) {
#pragma unroll
    for (int j = 0; j < FV_ROWS; ++j) {
      const int gi = gi0 + g + j * FV_WARPS;
      const bool row_in = gi >= 0 && gi < a.rows;
      const bool in0 = row_in && col_in0, in1 = row_in && col_in1;
      const size_t at = row_in ? static_cast<size_t>(gi) * a.cols + gj : 0;
      T e0[FV_NINE_WORDS], e1[FV_NINE_WORDS];
#pragma unroll
      for (int q = 0; q < FV_NINE_WORDS; ++q)
        fv_load<ACCESS>(a.bands[4 + q], at, in0, in1, e0[q], e1[q]);
      e0[4] = T(1) / (in0 ? e0[4] : T(1));
      e1[4] = T(1) / (in1 ? e1[4] : T(1));
#pragma unroll
      for (int q = 0; q < FV_NINE_WORDS; ++q) {
        nine(j, 0)[q * FV_NINE_Q] = e0[q];
        nine(j, 1)[q * FV_NINE_Q] = e1[q];
      }
    }
  }
  FvCell<T> c0[FV_ROWS], c1[FV_ROWS];  // columns gj, gj + 1
#pragma unroll
  for (int j = 0; j < FV_ROWS; ++j) {
    const int gi = gi0 + g + j * FV_WARPS;
    const bool row_in = gi >= 0 && gi < a.rows;
    const bool in0 = row_in && col_in0, in1 = row_in && col_in1;
    const size_t at = row_in ? static_cast<size_t>(gi) * a.cols + gj : 0;
    fv_load<ACCESS>(XFER == FV_OPEN ? a.hi : a.rhs, at, in0, in1, c0[j].rhs,
                    c1[j].rhs);
    const bool load_u = run.load_mode != LOAD_ZERO;
    if constexpr (FORM == FORM_FROM_V) {
      fv_load<ACCESS>(a.v1, at, in0, in1, c0[j].aa, c1[j].aa);
      fv_load<ACCESS>(a.v2, at, in0, in1, c0[j].bb, c1[j].bb);
      if constexpr (XFER == FV_OPEN) {
        fv_load<ACCESS>(a.lo, at, in0, in1, c0[j].cc, c1[j].cc);
        fv_load<ACCESS>(a.d, at, in0, in1, c0[j].dd, c1[j].dd);
      } else {
        fv_load<ACCESS>(run.u, at, in0 && load_u, in1 && load_u, c0[j].cc,
                        c1[j].cc);
      }
      if constexpr (XFER == FV_SMOOTH) {
        const bool load_corr = run.load_mode == LOAD_U_CORR;
        fv_load<ACCESS>(a.corr, at, in0 && load_corr, in1 && load_corr,
                       c0[j].dd, c1[j].dd);
      } else if constexpr (XFER == FV_PROLONG) {
        // 0 past the array, as u is there (in1 implies in0: gj is even)
        c0[j].dd = c1[j].dd = T(0);
        if (in0 && run.load_mode == LOAD_U_PROLONG) {
          prolong_pair(a.src, a.src_rows, a.src_cols, gi, gj, c0[j].dd,
                       c1[j].dd);
          if (!in1) c1[j].dd = T(0);
        }
      }
    } else {
      fv_load<ACCESS>(a.bands[0], at, in0, in1, c0[j].aa, c1[j].aa);
      fv_load<ACCESS>(a.bands[1], at, in0, in1, c0[j].bb, c1[j].bb);
      const bool load_corr = run.load_mode == LOAD_U_CORR;
      fv_load<ACCESS>(run.u, at, in0 && load_u, in1 && load_u, c0[j].cc,
                     c1[j].cc);
      fv_load<ACCESS>(a.corr, at, in0 && load_corr, in1 && load_corr,
                     c0[j].dd, c1[j].dd);
    }
  }
  if constexpr (FORM == FORM_FROM_V) {
    // u + corr (K2, K7) or u + the prolongation (K4), in that order
    const bool add = XFER == FV_PROLONG ? run.load_mode == LOAD_U_PROLONG
                     : XFER == FV_SMOOTH && run.load_mode == LOAD_U_CORR;
    // the interior mask at (gi + row_off, gj), 0 past the array
    const bool col_int0 = col_in0 && gj >= 1 && gj <= a.n - 1;
    const bool col_int1 = col_in1 && gj + 1 >= 1 && gj + 1 <= a.n - 1;
    [[maybe_unused]] DForm<T> h0[FV_ROWS], h1[FV_ROWS];  // FV_OPEN: of hi'
    if constexpr (XFER == FV_OPEN) {
      // each cell's (hi', lo') once, to the arrays at the tile's cells; hi'
      // into the window's planes, lo' into the cell's u slot
#pragma unroll
      for (int j = 0; j < FV_ROWS; ++j) {
        const int r = g + j * FV_WARPS, gi = gi0 + r;
        const int at = cell + j * FV_WARPS * FV_STRIDE;
        const Pair<T> x0 = accumulate(c0[j].rhs, c0[j].cc, c0[j].dd);
        const Pair<T> x1 = accumulate(c1[j].rhs, c1[j].cc, c1[j].dd);
        plane[0][at] = x0.hi;
        plane[1][at] = x1.hi;
        c0[j].cc = x0.lo;
        c1[j].cc = x1.lo;
        if (tile_pair && r >= hr && r < FV_WIN_H - hr && gi < a.rows) {
          const size_t out = static_cast<size_t>(gi) * a.cols + gj;
          fv_store<ACCESS>(a.hi_out, out, col_in0, col_in1, x0.hi, x1.hi);
          fv_store<ACCESS>(a.lo_out, out, col_in0, col_in1, x0.lo, x1.lo);
        }
      }
      __syncthreads();
      // the hi' terms of each cell's rhs, then lo' takes the planes
#pragma unroll
      for (int j = 0; j < FV_ROWS; ++j) {
        const int at = cell + j * FV_WARPS * FV_STRIDE;
        h0[j] = fv_dform(plane[0], plane[1], at, at - 1);
        h1[j] = fv_dform(plane[1], plane[0], at, at);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < FV_ROWS; ++j) {
        const int at = cell + j * FV_WARPS * FV_STRIDE;
        plane[0][at] = c0[j].cc;
        plane[1][at] = c1[j].cc;
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < FV_ROWS; ++j) {
      const int gi = gi0 + g + j * FV_WARPS, row = gi + a.row_off;
      const bool row_int =
          gi >= 0 && gi < a.rows && row >= 1 && row <= a.n - 1;
      const int at = cell + j * FV_WARPS * FV_STRIDE;
      if constexpr (XFER == FV_OPEN) {
        // the rhs with the lo' terms, stored at the tile's cells
        c0[j].rhs = delta_rhs(h0[j], fv_dform(plane[0], plane[1], at, at - 1),
                              c0[j].aa, c0[j].bb,
                              row_int && col_int0 ? T(1) : T(0), a.two_rnu,
                              a.r_h);
        c1[j].rhs = delta_rhs(h1[j], fv_dform(plane[1], plane[0], at, at),
                              c1[j].aa, c1[j].bb,
                              row_int && col_int1 ? T(1) : T(0), a.two_rnu,
                              a.r_h);
        const int r = gi - gi0;
        if (tile_pair && r >= hr && r < FV_WIN_H - hr && gi < a.rows)
          fv_store<ACCESS>(a.rhs_out, static_cast<size_t>(gi) * a.cols + gj,
                           col_in0, col_in1, c0[j].rhs, c1[j].rhs);
      }
      // FV_OPEN writes u = 0 once every rhs has read its neighbours' lo'
      auto form = [&](FvCell<T>& x, bool col_int, T* to) {
        if constexpr (XFER != FV_OPEN) *to = add ? x.cc + x.dd : x.cc;
        const Coefs<T> co = coefs_at(x.aa, x.bb,
                                     row_int && col_int ? T(1) : T(0), a.rr,
                                     a.hh, a.nu);
        x = {x.rhs, co.aa, co.bb, co.cc, co.dd};
      };
      form(c0[j], col_int0, &plane[0][at]);
      form(c1[j], col_int1, &plane[1][at]);
    }
    if constexpr (XFER == FV_OPEN) {
      __syncthreads();
#pragma unroll
      for (int j = 0; j < FV_ROWS; ++j)
        plane[0][cell + j * FV_WARPS * FV_STRIDE] =
            plane[1][cell + j * FV_WARPS * FV_STRIDE] = T(0);
    }
  } else {
    const bool add = run.load_mode == LOAD_U_CORR;  // u + corr
#pragma unroll
    for (int j = 0; j < FV_ROWS; ++j) {
      plane[0][cell + j * FV_WARPS * FV_STRIDE] =
          add ? c0[j].cc + c0[j].dd : c0[j].cc;
      plane[1][cell + j * FV_WARPS * FV_STRIDE] =
          add ? c1[j].cc + c1[j].dd : c1[j].cc;
    }
    // then the cc and dd bands into the slots u and corr held
#pragma unroll
    for (int j = 0; j < FV_ROWS; ++j) {
      const int gi = gi0 + g + j * FV_WARPS;
      const bool row_in = gi >= 0 && gi < a.rows;
      const bool in0 = row_in && col_in0, in1 = row_in && col_in1;
      const size_t at = row_in ? static_cast<size_t>(gi) * a.cols + gj : 0;
      fv_load<ACCESS>(a.bands[2], at, in0, in1, c0[j].cc, c1[j].cc);
      fv_load<ACCESS>(a.bands[3], at, in0, in1, c0[j].dd, c1[j].dd);
    }
  }
  __syncthreads();

  // an even-column cell's left neighbour is odd pair k - 1, an odd-column
  // cell's even pair k
  for (int s = 0; s < run.nsweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      if constexpr (FORM == FORM_NINE) {
        // the corners share the pass's color: form every update, meet,
        // then store
        const bool odd = odd_red != (color == 1);
        T upd[FV_ROWS];
        if (odd) {
          fv_pass9(plane[1], plane[0], c1, nine(0, 1), cell, cell, upd);
        } else {
          fv_pass9(plane[0], plane[1], c0, nine(0, 0), cell, cell - 1, upd);
        }
        __syncthreads();
        T* self = plane[odd ? 1 : 0];
#pragma unroll
        for (int j = 0; j < FV_ROWS; ++j)
          self[cell + j * FV_WARPS * FV_STRIDE] = upd[j];
      } else if (odd_red != (color == 1)) {
        fv_pass(plane[1], plane[0], c1, cell, cell, a.inv_diag);
      } else {
        fv_pass(plane[0], plane[1], c0, cell, cell - 1, a.inv_diag);
      }
      __syncthreads();
    }
  }

  // write back the tile (window rows [hr, FV_WIN_H - hr), columns [hc,
  // FV_WIN_W - hc): a thread's pair lies inside or outside it whole) and
  // the residual where it is written
  if (!tile_pair) return;
  const auto residual = [&](const FvCell<T>& co, const T* self,
                            const T* other, int at, int side) {
    return co.rhs - a.diag * self[at] -
           (co.cc * self[at - FV_STRIDE] + co.dd * self[at + FV_STRIDE] +
            co.aa * other[side] + co.bb * other[side + 1]);
  };
  // FORM_NINE: the diagonal of the thread's rows, read again for the
  // residual, all rows' loads issued first
  [[maybe_unused]] T diag0[FV_ROWS], diag1[FV_ROWS];
  if constexpr (FORM == FORM_NINE) {
    const bool load = run.res_mode != RES_NONE;
#pragma unroll
    for (int j = 0; j < FV_ROWS; ++j) {
      const int gi = gi0 + g + j * FV_WARPS;
      const bool row_in = load && gi >= 0 && gi < a.rows;
      const size_t at = row_in ? static_cast<size_t>(gi) * a.cols + gj : 0;
      fv_load<ACCESS>(a.bands[8], at, row_in && col_in0, row_in && col_in1,
                      diag0[j], diag1[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < FV_ROWS; ++j) {
    const int r = g + j * FV_WARPS, gi = gi0 + r;
    if (r < hr || r >= FV_WIN_H - hr || gi >= a.rows) continue;
    const int at = cell + j * FV_WARPS * FV_STRIDE;
    const size_t out = static_cast<size_t>(gi) * a.cols + gj;
    fv_store<ACCESS>(run.u_out, out, col_in0, col_in1, plane[0][at],
                    plane[1][at]);
    if constexpr (XFER == FV_INJECT) {
      // at even (gi, gj) alone, into coarse cell (gi/2, gj/2): neighbouring
      // lanes write neighbouring cells
      const int I = gi >> 1, J = gj >> 1;
      if (run.res_mode != RES_INJECT || (gi & 1) || !col_in0 ||
          I >= a.res_rows || J >= a.res_cols)
        continue;
      a.res_out[static_cast<size_t>(I) * a.res_cols + J] =
          residual(c0[j], plane[0], plane[1], at, at - 1);
    } else if constexpr (XFER == FV_SMOOTH || XFER == FV_OPEN) {
      // every row, or the even rows alone
      if (run.res_mode == RES_NONE ||
          (run.res_mode == RES_ROWS_DEC &&
           ((gi & 1) || (gi >> 1) >= a.res_rows)))
        continue;
      T res0, res1;
      if constexpr (FORM == FORM_NINE) {
        res0 = c0[j].rhs - diag0[j] * plane[0][at] -
               fv_nb9(plane[0], plane[1], c0[j], nine(j, 0), at, at - 1);
        res1 = c1[j].rhs - diag1[j] * plane[1][at] -
               fv_nb9(plane[1], plane[0], c1[j], nine(j, 1), at, at);
      } else {
        res0 = residual(c0[j], plane[0], plane[1], at, at - 1);
        res1 = residual(c1[j], plane[1], plane[0], at, at);
      }
      fv_store<ACCESS>(a.res_out,
                      run.res_mode == RES_FULL
                          ? out
                          : static_cast<size_t>(gi >> 1) * a.cols + gj,
                      col_in0, col_in1, res0, res1);
    }
  }
}

// Let `kernel` take `smem` bytes of dynamic shared memory on the current
// device, with the max-shared carveout: set once per kernel, device and
// size, and remembered, so that a launch inside a stream capture (a CUDA
// graph) makes no attribute call once a warm-up has set it.
template <typename T>
cudaError_t reserve_dynamic_smem(void (*kernel)(SmoothArgs<T>), size_t smem) {
  static std::mutex lock;
  static std::map<std::pair<const void*, int>, size_t> reserved;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  size_t& have = reserved[{reinterpret_cast<const void*>(kernel), dev}];
  if (have >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) have = smem;
  return err;
}

// Launch the from_v block over a.rows x a.cols, one block per tile, with
// `paired` (smooth_from_v<T, FV_PAIRED, ...>) where every row of every
// array starts aligned to a pair of values (the window's columns start
// even), else with `singles` (smooth_from_v<T, FV_SINGLES, ...>), and
// `smem` bytes of dynamic shared memory (FORM_NINE's corner words).  A
// block's static and dynamic shared memory together pass 48 KB only under
// cudaFuncAttributeMaxDynamicSharedMemorySize, so it is set whenever the
// block takes dynamic memory (`reserve_dynamic_smem`).  An nsweeps whose
// halo leaves no tile is refused with cudaErrorInvalidValue; returns the
// launch error.
template <typename T>
cudaError_t launch_smooth_from_v(void (*paired)(SmoothArgs<T>),
                                 void (*singles)(SmoothArgs<T>),
                                 const SmoothArgs<T>& a, cudaStream_t stream,
                                 size_t smem = 0) {
  if (a.nsweeps < 0) return cudaErrorInvalidValue;
  const int th = fv_tile_rows(a.nsweeps), tw = fv_tile_cols(a.nsweeps);
  if (th < 2 || tw < 2) return cudaErrorInvalidValue;
  const T* arrays[] = {a.u,     a.corr,    a.rhs,    a.v1,     a.v2,
                       a.hi,    a.lo,      a.d,      a.u_out,  a.res_out,
                       a.hi_out, a.lo_out, a.rhs_out};
  bool aligned = a.cols % 2 == 0;
  for (const T* x : arrays)
    aligned = aligned && reinterpret_cast<size_t>(x) % (2 * sizeof(T)) == 0;
  for (const T* x : a.bands)
    aligned = aligned && reinterpret_cast<size_t>(x) % (2 * sizeof(T)) == 0;
  const dim3 grid((a.cols + tw - 1) / tw, (a.rows + th - 1) / th);
  void (*kernel)(SmoothArgs<T>) = aligned ? paired : singles;
  if (smem > 0) {
    const cudaError_t err = reserve_dynamic_smem(kernel, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, FV_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Fill the CN constants of a SmoothArgs from the host's double values.
template <typename T>
void set_constants(SmoothArgs<T>& a, double rr, double hh, double nu,
                   double diag, double inv_diag) {
  a.rr = static_cast<T>(rr);
  a.hh = static_cast<T>(hh);
  a.nu = static_cast<T>(nu);
  a.diag = static_cast<T>(diag);
  a.inv_diag = static_cast<T>(inv_diag);
}

}  // namespace mg
