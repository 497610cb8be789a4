// The fit's normal equations for a batch of frames, for Hopper: the
// windowed basis and its three Hermitian Grams, padded and equilibrated.
//
// Replaces eaqhm_tpu/ops/solver.py `build_gram_split` (:212-247) fed by
// `iqhm_gram` (:402-422, the stationary fit of adaptation 0) and
// `eaqhm_gram` (:508-587, every eaQHM adaptation, with `repair_tracks` at
// :441-505), which XLA fuses on the TPU.  No Pallas kernel stood for them.
// Per frame b (window rows n = 0..N-1 at offsets o[n], W = (N-1)/2) the fit
// builds the basis E1 [N, Kc2] (Kc2 = 2Kc+1 column slots: harmonics
// -Kc..-1, DC, 1..Kc), A = w E1 with the frame's window w and B = o A, and
// returns
//     R = [[G0, G1], [G1^H, G2]],  G0 = A^H A, G1 = A^H B, G2 = B^H B,
// with identity rows and columns at masked slots and Jacobi equilibration
// R_ij dinv_i dinv_j, dinv = rsqrt(max(Re diag R, 1e-30)), the right-hand
// side [A^H (w s), B^H (w s)] dinv and dinv [M] (M = 2 Kc2).
//
// Two kernels:
// - fit_basis (one frame and 64 column units per block; each thread walks
//   rows of its columns in order).  iQHM mode: one column per thread, phase
//   ((2pi/fs) o) (k f0).  eaQHM mode: two lanes per harmonic, each writing
//   half the rows of both of its columns (+k and the time-reversed -k), and
//   one thread for the DC column: the zero-gap repair of the tracks
//   (previous and next nonzero inside the window, linear fill, constant
//   extension, zero outside), the integer split q = rint(fm), r = fm - q,
//   the inclusive cumsums recentred at W, torch.remainder's mod fs, rho, and
//   the negative block's one-sample shift.  Both lanes first walk rows
//   0..W for the centre values; the second lane then goes on from there, so
//   the cumsums are summed in row order as torch.cumsum defines them.  Every
//   elementwise step rounds where the torch ops (and JAX) round, in their
//   order: the products and sums are __fmul_rn / __fadd_rn and never
//   contracted, sincos and cos are the accurate ones.  It writes A once [B,
//   N, Kc2] (interleaved complex, the layout fit_gram reads), and per column
//   the right-hand side, dinv (the Gram's diagonal is the column's sum of
//   |A|^2 and |B|^2, so the basis knows it before the Gram runs) and the
//   column mask.
// - fit_gram (one frame and one 64 x 64 tile per block).  R is E^H E over
//   the virtual basis E = [A, o A] of M columns, B formed as a tile is
//   loaded (o is an exact integer).  The tiles cover the upper triangle over
//   the 4 Kc columns but the two DC ones (so the tile grid fits 4 Kc, a
//   multiple of 64 at the stress and SA19 orders, and not M = 4 Kc + 2);
//   strip blocks take the DC columns against every column.  Each entry
//   below the diagonal is written as the conjugate of its mirror: G0 and G2
//   are Hermitian, G1^H is the lower-left block as JAX writes it, and G1
//   (Hermitian too: o is real) is taken as one triangle where 2 Kc falls on
//   a tile boundary (Kc a multiple of 32); the diagonal's imaginary part,
//   zero in exact arithmetic, is written as zero.  Each entry is the sum
//   JAX's einsum defines, in another order, or its mirror's conjugate.  The
//   epilogue adds the identity at masked slots and scales by dinv_i dinv_j:
//   R is written once.
//
// What bounds it on an H100: the Grams take 3 M^2 N real flops per frame
// with one triangle of each (the least this function needs; 6 M^2 N as full
// products), against N Kc2 basis elements read and M^2 written: at the main
// path's orders (M = 130-1950, N = 241-2897) arithmetic bounds it.  The
// tiles compute 3.7-4.0 M^2 N flops at the stress orders (G1 as one
// triangle, the padding of 64-column tiles included), 4 M^2 N and the
// padding where G1 is taken in full.  complex64 runs full-FP32
// FFMA register tiles (no TF32 in any form: it would move what the float32
// gate decides); complex128 the FP64 tensor cores (mma.sync m8n8k4, four
// real products per complex one, two blocks a SM).
//
// Every launch is on the caller's stream, allocates nothing and does not
// synchronize; each entry point returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemMax = 232448;   // shared memory one block can use (H100)
constexpr int kBasisThreads = 64;  // column units per fit_basis block
constexpr int kTile = 64;          // fit_gram output tile (complex entries)
constexpr int kGramThreads = 256;
constexpr double kPi = 3.141592653589793;

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };

// Rounded once each, never fused into an FMA: the torch ops' rounding.
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rdiv(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ void rsincos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void rsincos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ float rcos(float x) { return cosf(x); }
__device__ __forceinline__ double rcos(double x) { return cos(x); }
__device__ __forceinline__ float rrint(float x) { return rintf(x); }
__device__ __forceinline__ double rrint(double x) { return rint(x); }
__device__ __forceinline__ float rrsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rrsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float rfmod(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double rfmod(double a, double b) { return fmod(a, b); }

// torch.remainder: the sign of the divisor.
template <typename T>
__device__ __forceinline__ T remainder_t(T a, T b) {
  T m = rfmod(a, b);
  if (m != T(0) && ((b < T(0)) != (m < T(0)))) m = radd(m, b);
  return m;
}

// rsqrt(clamp(d, min=1e-30)), NaN kept (torch.clamp's rule).
template <typename T>
__device__ __forceinline__ T equil(T d) {
  const T lo = T(1e-30);
  return rrsqrt(d < lo ? lo : d);
}

// One column's running sums: the right-hand side A^H ws and B^H ws, and
// the Gram's diagonal entries |A|^2 and |B|^2 (B = o A as fit_gram forms it).
template <typename T>
struct ColSums {
  T ra_x = 0, ra_y = 0, rb_x = 0, rb_y = 0, da = 0, db = 0;
  __device__ __forceinline__ void add(T ax, T ay, T on, T wsn) {
    const T bx = rmul(on, ax), by = rmul(on, ay);
    ra_x = fma(ax, wsn, ra_x);
    ra_y = fma(-ay, wsn, ra_y);
    rb_x = fma(bx, wsn, rb_x);
    rb_y = fma(-by, wsn, rb_y);
    da = fma(ax, ax, fma(ay, ay, da));
    db = fma(bx, bx, fma(by, by, db));
  }
  // Across a pair of lanes (mask: both of them): each ends with the first
  // lane's sums plus the second's.
  static __device__ __forceinline__ T pair_sum(unsigned mask, T x,
                                               int second) {
    const T other = __shfl_xor_sync(mask, x, 1);
    return second ? other + x : x + other;
  }
  __device__ __forceinline__ void combine(unsigned mask, int second) {
    ra_x = pair_sum(mask, ra_x, second);
    ra_y = pair_sum(mask, ra_y, second);
    rb_x = pair_sum(mask, rb_x, second);
    rb_y = pair_sum(mask, rb_y, second);
    da = pair_sum(mask, da, second);
    db = pair_sum(mask, db, second);
  }
  // slot j of block 0 and Kc2 + j of block 1: rhs * dinv, dinv
  template <typename C>
  __device__ __forceinline__ void store(C* rhs, T* dinv, int j, int Kc2,
                                        bool live) const {
    const T d0 = live ? equil(da) : T(1), d1 = live ? equil(db) : T(1);
    C v;
    v.x = live ? rmul(ra_x, d0) : T(0);
    v.y = live ? rmul(ra_y, d0) : T(0);
    rhs[j] = v;
    v.x = live ? rmul(rb_x, d1) : T(0);
    v.y = live ? rmul(rb_y, d1) : T(0);
    rhs[Kc2 + j] = v;
    dinv[j] = d0;
    dinv[Kc2 + j] = d1;
  }
};

// The zero-gap repair of one track column (repair_tracks), walked row by
// row: the last nonzero at or before the row and the first at or after it
// (found once per run of zeros), both inside the window |o| <= wl.
template <typename T>
struct Repair {
  const T* fm;
  const T* am;
  const T* o;
  T wl;
  int stride, N;
  int prev, next;
  T pf, pa, nf, na;
  __device__ void reset() {
    prev = -1;
    next = -1;   // below the row: not yet searched
  }
  __device__ bool nonzero(int m) const {
    return fabs(o[m]) <= wl && fm[(size_t)m * stride] != T(0);
  }
  __device__ void at(int n, T& fo, T& ao) {
    const T f = fm[(size_t)n * stride], a = am[(size_t)n * stride];
    if (!(fabs(o[n]) <= wl)) {
      fo = ao = T(0);
      return;
    }
    if (f != T(0)) {
      prev = n;
      pf = f;
      pa = a;
      fo = f;
      ao = a;
      return;
    }
    if (next < n) {
      int m = n + 1;
      while (m < N && !nonzero(m)) ++m;
      next = m;
      if (m < N) {
        nf = fm[(size_t)m * stride];
        na = am[(size_t)m * stride];
      }
    }
    const bool hp = prev >= 0, hn = next < N;
    if (hp && hn) {
      const T g = rdiv(T(n - prev), T(next - prev));
      fo = radd(pf, rmul(rsub(nf, pf), g));
      ao = radd(pa, rmul(rsub(na, pa), g));
    } else if (hp) {
      fo = pf;
      ao = pa;
    } else if (hn) {
      fo = nf;
      ao = na;
    } else {
      fo = ao = T(0);
    }
  }
};

extern __shared__ __align__(16) unsigned char g_smem[];

// fit_basis, eaQHM mode.  fm, am: [B, N, Kc] track windows; s: [B, N];
// o: [N]; wl: [B]; cmask: [B, Kc] selected harmonics (bytes 0 / 1).
// A: [B, N, Kc2]; rhs: [B, M]; dinv: [B, M]; mask: [B, Kc2] out.
template <typename T>
__global__ void __launch_bounds__(kBasisThreads)
    basis_eaqhm(const T* __restrict__ fm, const T* __restrict__ am,
                const T* __restrict__ s, const T* __restrict__ o,
                const T* __restrict__ wl, const uint8_t* __restrict__ cmask,
                typename Cplx<T>::type* __restrict__ A,
                typename Cplx<T>::type* __restrict__ rhs, T* __restrict__ dinv,
                uint8_t* __restrict__ mask, int N, int Kc, int groups, T fs,
                T c, T eps) {
  using C = typename Cplx<T>::type;
  T* w_s = reinterpret_cast<T*>(g_smem);
  T* ws_s = w_s + N;
  const int b = blockIdx.x / groups, grp = blockIdx.x - b * groups;
  const int W = (N - 1) / 2, Kc2 = 2 * Kc + 1, M = 2 * Kc2;
  const T wlb = wl[b];
  // hamming_window: 0.54 + 0.46 cos((pi o) / wl), 0 outside +-wl; ws = w s
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const T on = o[n];
    T w = radd(T(0.54), rmul(T(0.46), rcos(rdiv(rmul(T(kPi), on), wlb))));
    w = fabs(on) <= wlb ? w : T(0);
    w_s[n] = w;
    ws_s[n] = rmul(w, s[(size_t)b * N + n]);
  }
  __syncthreads();
  const int u = grp * kBasisThreads + threadIdx.x;
  if (u > 2 * Kc) return;
  C* Ab = A + (size_t)b * N * Kc2;
  C* rb = rhs + (size_t)b * M;
  T* db = dinv + (size_t)b * M;
  ColSums<T> sp, sn;
  if (u == 2 * Kc) {                   // the DC column: E1 = 1
    mask[(size_t)b * Kc2 + Kc] = 1;
    for (int n = 0; n < N; ++n) {
      C v;
      v.x = w_s[n];
      v.y = T(0);
      Ab[(size_t)n * Kc2 + Kc] = v;
      sp.add(v.x, v.y, o[n], ws_s[n]);
    }
    sp.store(rb, db, Kc, Kc2, true);
    return;
  }
  // two threads per harmonic (adjacent lanes): rows 0..W and W+1..N-1 of
  // the positive column (rows N-1-n of the negative one)
  const int k = u >> 1, half = u & 1, jp = Kc + 1 + k, jn = Kc - 1 - k;
  const int n_lo = half ? W + 1 : 0, n_hi = half ? N : W + 1;
  const bool live = cmask[(size_t)b * Kc + k] != 0;
  if (!live) {
    C z;
    z.x = z.y = T(0);
    for (int n = n_lo; n < n_hi; ++n) {
      Ab[(size_t)n * Kc2 + jp] = z;
      Ab[(size_t)(N - 1 - n) * Kc2 + jn] = z;
    }
  } else {
    Repair<T> rep;
    rep.fm = fm + (size_t)b * N * Kc + k;
    rep.am = am + (size_t)b * N * Kc + k;
    rep.o = o;
    rep.wl = wlb;
    rep.stride = Kc;
    rep.N = N;
    // walk 1: the centre values (cumsums at W, fm's split and am at W)
    T cq = 0, cr = 0, qW = 0, rW = 0, amW = 0;
    rep.reset();
    for (int n = 0; n <= W; ++n) {
      T f, a;
      rep.at(n, f, a);
      const T q = rrint(f), r = rsub(f, q);
      cq = radd(cq, q);
      cr = radd(cr, r);
      if (n == W) {
        qW = q;
        rW = r;
        amW = a;
      }
    }
    const T cqW = cq, crW = cr;
    // walk 2: row n of the positive column, row N-1-n of the negative one
    // (phase_neg(N-1-n) = (2pi/fs) (mod(psi_q(n-1) + q(W)) + psi_r(n-1) +
    // r(W)), psi(-1) = -C(W); rho(n) on both).  The second half goes on
    // from walk 1's state at W (psi(W) = 0).
    T pq_prev = T(0), pr_prev = T(0);
    if (!half) {
      rep.reset();
      cq = cr = T(0);
      pq_prev = -cqW;
      pr_prev = -crW;
    }
    const T den = radd(amW, eps);
    for (int n = n_lo; n < n_hi; ++n) {
      T f, a;
      rep.at(n, f, a);
      const T q = rrint(f), r = rsub(f, q);
      cq = radd(cq, q);
      cr = radd(cr, r);
      const T psq = rsub(cq, cqW), psr = rsub(cr, crW);
      const T ph = rmul(c, radd(remainder_t(psq, fs), psr));
      const T nph = rmul(c, radd(remainder_t(radd(pq_prev, qW), fs),
                                 radd(pr_prev, rW)));
      pq_prev = psq;
      pr_prev = psr;
      const T rho = rdiv(radd(a, eps), den);
      T sinp, cosp, sinn, cosn;
      rsincos(ph, &sinp, &cosp);
      rsincos(nph, &sinn, &cosn);
      const int t = N - 1 - n;
      C vp, vn;
      vp.x = rmul(rmul(rho, cosp), w_s[n]);
      vp.y = rmul(rmul(rho, sinp), w_s[n]);
      vn.x = rmul(rmul(rho, cosn), w_s[t]);
      vn.y = rmul(rmul(rho, sinn), w_s[t]);
      Ab[(size_t)n * Kc2 + jp] = vp;
      Ab[(size_t)t * Kc2 + jn] = vn;
      sp.add(vp.x, vp.y, o[n], ws_s[n]);
      sn.add(vn.x, vn.y, o[t], ws_s[t]);
    }
  }
  // the pair's sums: the first half's plus the second's
  const unsigned pair = 3u << ((threadIdx.x & 31) & ~1);
  sp.combine(pair, half);
  sn.combine(pair, half);
  if (half) return;
  mask[(size_t)b * Kc2 + jp] = live;
  mask[(size_t)b * Kc2 + jn] = live;
  sp.store(rb, db, jp, Kc2, live);
  sn.store(rb, db, jn, Kc2, live);
}

// fit_basis, iQHM mode.  s: [B, N]; o: [N]; wl, f0: [B]; K: [B] int64
// harmonic counts.  Outputs as basis_eaqhm.
template <typename T>
__global__ void __launch_bounds__(kBasisThreads)
    basis_iqhm(const T* __restrict__ s, const T* __restrict__ o,
               const T* __restrict__ wl, const T* __restrict__ f0,
               const long long* __restrict__ K,
               typename Cplx<T>::type* __restrict__ A,
               typename Cplx<T>::type* __restrict__ rhs, T* __restrict__ dinv,
               uint8_t* __restrict__ mask, int N, int Kc, int groups, T c) {
  using C = typename Cplx<T>::type;
  T* w_s = reinterpret_cast<T*>(g_smem);
  T* ws_s = w_s + N;
  T* t_s = ws_s + N;
  const int b = blockIdx.x / groups, grp = blockIdx.x - b * groups;
  const int Kc2 = 2 * Kc + 1, M = 2 * Kc2;
  const T wlb = wl[b];
  // blackman_window: r = o / wl, 0.42 + 0.5 cos(pi r) + 0.08 cos(2pi r),
  // 0 outside +-wl; ws = w s; t = (2pi/fs) o
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const T on = o[n];
    const T r = rdiv(on, wlb);
    T w = radd(radd(T(0.42), rmul(T(0.5), rcos(rmul(T(kPi), r)))),
               rmul(T(0.08), rcos(rmul(T(2 * kPi), r))));
    w = fabs(on) <= wlb ? w : T(0);
    w_s[n] = w;
    ws_s[n] = rmul(w, s[(size_t)b * N + n]);
    t_s[n] = rmul(c, on);
  }
  __syncthreads();
  const int j = grp * kBasisThreads + threadIdx.x;
  if (j >= Kc2) return;
  const int k = j - Kc;
  const bool live = (long long)(k < 0 ? -k : k) <= K[b];
  C* Ab = A + (size_t)b * N * Kc2;
  mask[(size_t)b * Kc2 + j] = live;
  ColSums<T> sj;
  if (!live) {
    C z;
    z.x = z.y = T(0);
    for (int n = 0; n < N; ++n) Ab[(size_t)n * Kc2 + j] = z;
  } else {
    const T kf = rmul(T(k), f0[b]);
    for (int n = 0; n < N; ++n) {
      T sn, cn;
      rsincos(rmul(t_s[n], kf), &sn, &cn);
      C v;
      v.x = rmul(cn, w_s[n]);
      v.y = rmul(sn, w_s[n]);
      Ab[(size_t)n * Kc2 + j] = v;
      sj.add(v.x, v.y, o[n], ws_s[n]);
    }
  }
  sj.store(rhs + (size_t)b * M, dinv + (size_t)b * M, j, Kc2, live);
}

// fit_gram's work per frame.  The tiles run over the 4 Kc columns of R
// but its two DC columns (p-space: column p < 2Kc is slot p of block 0,
// skipping the DC slot Kc; 2Kc + p the same slot of block 1), so that the
// tile grid fits the stress and SA19 orders (4 Kc a multiple of 64 there).
// Tiles (I, J), I <= J, of the upper triangle of T x T tiles; when the
// blocks' boundary 2Kc falls on a tile boundary (Kc a multiple of 32), the
// tiles of G1 below its own diagonal are skipped and each entry of G1 is
// written with its Hermitian mirror too.  Then ceil(M / 64) strip blocks:
// the two DC columns against every column of R.
struct Plan {
  int Kc, Kc2, M, h, T, H, ntiles, nstrips;
  bool g1tri;
  __device__ __host__ explicit Plan(int Kc_) : Kc(Kc_) {
    Kc2 = 2 * Kc + 1;
    M = 2 * Kc2;
    h = 2 * Kc;
    T = (4 * Kc + kTile - 1) / kTile;
    g1tri = h % kTile == 0;
    H = h / kTile;
    ntiles = T * (T + 1) / 2;
    nstrips = (M + kTile - 1) / kTile;
  }
  // slot of p-space column p (p < 4Kc), and whether it is in block 1
  __device__ __forceinline__ int slot(int p) const {
    const int g = p >= h ? p - h : p;
    return g < Kc ? g : g + 1;
  }
  __device__ __forceinline__ int vcol(int p) const {
    return p >= h ? Kc2 + slot(p) : slot(p);
  }
};

// (I, J), I <= J, of the t-th tile of the upper triangle, row by row.
__device__ __forceinline__ void tile_of(int t, int T, int& I, int& J) {
  I = 0;
  while (t >= T - I) {
    t -= T - I;
    ++I;
  }
  J = I + t;
}

// R[r, c] = (re, im) * dinv_c dinv_r (the identity already added).
template <typename C, typename T>
__device__ __forceinline__ void put(C* Rb, const T* db, int M, int r, int c,
                                    T re, T im) {
  const T d = db[c] * db[r];
  C v;
  v.x = re * d;
  v.y = im * d;
  Rb[(size_t)r * M + c] = v;
}

// One computed entry (pi, pj), pi <= pj, of a tile, with its mirrors: the
// diagonal real, the identity at a masked slot; G1 taken as one triangle
// where the plan says so (G1[gj][gi] = conj G1[gi][gj]).
template <typename C, typename T>
__device__ __forceinline__ void tile_entry(C* Rb, const T* db,
                                           const uint8_t* mb, const Plan& P,
                                           int pi, int pj, T re, T im) {
  const int vi = P.vcol(pi), vj = P.vcol(pj), M = P.M;
  if (P.g1tri && pi < P.h && pj >= P.h) {
    const int gi = pi, gj = pj - P.h;
    if (gi > gj) return;
    if (gi == gj) {
      put(Rb, db, M, vi, vj, re, T(0));
      put(Rb, db, M, vj, vi, re, T(0));
      return;
    }
    const int ui = P.vcol(gj), uj = P.vcol(gi + P.h);
    put(Rb, db, M, vi, vj, re, im);
    put(Rb, db, M, vj, vi, re, -im);
    put(Rb, db, M, ui, uj, re, -im);
    put(Rb, db, M, uj, ui, re, im);
    return;
  }
  if (pi == pj) {
    if (!mb[P.slot(pi)]) re += T(1);
    put(Rb, db, M, vi, vj, re, T(0));
    return;
  }
  put(Rb, db, M, vi, vj, re, im);
  put(Rb, db, M, vj, vi, re, -im);
}

// A strip block: columns v of [64 s, 64 s + 64) of R against the two DC
// columns (E_dc = w and o w, real): S_v = sum_n conj(E_v) E_dc, written at
// (v, dc) and conjugated at (dc, v); the pair of DC columns by the first
// strip only.  256 threads: 64 columns x 4 interleaved row groups, summed
// in order through shared memory (red: 4 x 4 x 64 reals).
template <typename C, typename T>
__device__ void strip_block(const C* Ab, const T* o, const T* db, C* Rb,
                            const Plan& P, int N, int s, T* red) {
  const int tid = threadIdx.x, lc = tid & (kTile - 1), grp = tid >> 6;
  const int v = s * kTile + lc, Kc2 = P.Kc2, Kc = P.Kc;
  const bool ok = v < P.M, sc = v >= Kc2;
  const int a = sc ? v - Kc2 : v;
  T sar = 0, sai = 0, sbr = 0, sbi = 0;
  if (ok) {
    for (int n = grp; n < N; n += 4) {
      const T on = o[n];
      C e = Ab[(size_t)n * Kc2 + a];
      if (sc) {
        e.x = on * e.x;
        e.y = on * e.y;
      }
      const T wa = Ab[(size_t)n * Kc2 + Kc].x, wb = on * wa;
      sar = fma(e.x, wa, sar);
      sai = fma(-e.y, wa, sai);
      sbr = fma(e.x, wb, sbr);
      sbi = fma(-e.y, wb, sbi);
    }
  }
  red[(grp * 4 + 0) * kTile + lc] = sar;
  red[(grp * 4 + 1) * kTile + lc] = sai;
  red[(grp * 4 + 2) * kTile + lc] = sbr;
  red[(grp * 4 + 3) * kTile + lc] = sbi;
  __syncthreads();
  if (grp != 0 || !ok) return;
  T t[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    t[c] = red[c * kTile + lc];
#pragma unroll
    for (int g = 1; g < 4; ++g) t[c] += red[(g * 4 + c) * kTile + lc];
  }
  const int dA = Kc, dB = Kc2 + Kc, M = P.M;
  if (v == dA) {
    put(Rb, db, M, v, dA, t[0], T(0));
  } else {
    put(Rb, db, M, v, dA, t[0], t[1]);
    put(Rb, db, M, dA, v, t[0], -t[1]);
  }
  if (v == dB) {
    put(Rb, db, M, v, dB, t[2], T(0));
  } else if (v != dA) {
    put(Rb, db, M, v, dB, t[2], t[3]);
    put(Rb, db, M, dB, v, t[2], -t[3]);
  }
}

// The tile's block of a fit_gram launch: frame b, tile (I, J); false for a
// skipped tile of G1.
__device__ __forceinline__ bool tile_here(const Plan& P, int t, int& I,
                                          int& J) {
  tile_of(t, P.T, I, J);
  return !(P.g1tri && I < P.H && J >= P.H && J - P.H < I);
}

// The loader of both types: tile column lc (of 64) of p-space tile X at
// depth rows n0 + lr + 4 r, B = o A formed here.
template <typename C, typename T, int kRows>
struct TileLoader {
  const C* Ab;
  const T* o;
  int N, Kc2, sx, sy;
  bool okx, oky, scx, scy;
  C px[kRows], py[kRows];
  __device__ TileLoader(const C* Ab_, const T* o_, const Plan& P, int N_,
                        int I, int J, int lc)
      : Ab(Ab_), o(o_), N(N_), Kc2(P.Kc2) {
    const int pi = I * kTile + lc, pj = J * kTile + lc, P4 = 4 * P.Kc;
    okx = pi < P4;
    oky = pj < P4;
    scx = okx && pi >= P.h;
    scy = oky && pj >= P.h;
    sx = okx ? P.slot(pi) : 0;
    sy = oky ? P.slot(pj) : 0;
  }
  __device__ __forceinline__ void load(int n0, int lr) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int n = n0 + lr + 4 * r;
      C vx, vy;
      vx.x = vx.y = vy.x = vy.y = T(0);
      if (n < N) {
        const T on = o[n];
        if (okx) {
          vx = Ab[(size_t)n * Kc2 + sx];
          if (scx) {
            vx.x = on * vx.x;
            vx.y = on * vx.y;
          }
        }
        if (oky) {
          vy = Ab[(size_t)n * Kc2 + sy];
          if (scy) {
            vy.x = on * vy.x;
            vy.y = on * vy.y;
          }
        }
      }
      px[r] = vx;
      py[r] = vy;
    }
  }
};

// fit_gram, complex64: 256 threads, each a 4 x 4 register tile of complex
// entries on FP32 FFMA; the depth (rows n) in steps of 16 through a double
// buffer in shared memory (planar re / im), the next step's elements held
// in registers while the current one computes.
constexpr int kDepth32 = 16;

__global__ void __launch_bounds__(kGramThreads)
    gram_c64(const float2* __restrict__ A, const float* __restrict__ o,
             const float* __restrict__ dinv, const uint8_t* __restrict__ mask,
             float2* __restrict__ R, int N, int Kc) {
  __shared__ __align__(16) float xs[2][2][kDepth32][kTile];
  __shared__ __align__(16) float ys[2][2][kDepth32][kTile];
  const Plan P(Kc);
  const int per = P.ntiles + P.nstrips;
  const int b = blockIdx.x / per, t = blockIdx.x - b * per;
  const float2* Ab = A + (size_t)b * N * P.Kc2;
  float2* Rb = R + (size_t)b * P.M * P.M;
  const float* db = dinv + (size_t)b * P.M;
  if (t >= P.ntiles) {
    strip_block(Ab, o, db, Rb, P, N, t - P.ntiles, &xs[0][0][0][0]);
    return;
  }
  int I, J;
  if (!tile_here(P, t, I, J)) return;
  const int tid = threadIdx.x, lc = tid & (kTile - 1), lr = tid >> 6;
  TileLoader<float2, float, kDepth32 / 4> ld(Ab, o, P, N, I, J, lc);
  auto stage = [&](int buf) {
#pragma unroll
    for (int r = 0; r < kDepth32 / 4; ++r) {
      const int kr = lr + 4 * r;
      xs[buf][0][kr][lc] = ld.px[r].x;
      xs[buf][1][kr][lc] = ld.px[r].y;
      ys[buf][0][kr][lc] = ld.py[r].x;
      ys[buf][1][kr][lc] = ld.py[r].y;
    }
  };
  // compute: rows ty * 4 + a, columns tx * 4 + c of the tile
  const int ty = tid >> 4, tx = tid & 15;
  float cr[4][4], ci[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) cr[a][c] = ci[a][c] = 0.f;
  ld.load(0, lr);
  stage(0);
  __syncthreads();
  int buf = 0;
  for (int n0 = 0; n0 < N; n0 += kDepth32) {
    const bool more = n0 + kDepth32 < N;
    if (more) ld.load(n0 + kDepth32, lr);
#pragma unroll
    for (int k = 0; k < kDepth32; ++k) {
      const float4 xr4 = *reinterpret_cast<const float4*>(&xs[buf][0][k][ty * 4]);
      const float4 xi4 = *reinterpret_cast<const float4*>(&xs[buf][1][k][ty * 4]);
      const float4 yr4 = *reinterpret_cast<const float4*>(&ys[buf][0][k][tx * 4]);
      const float4 yi4 = *reinterpret_cast<const float4*>(&ys[buf][1][k][tx * 4]);
      const float xr[4] = {xr4.x, xr4.y, xr4.z, xr4.w};
      const float xi[4] = {xi4.x, xi4.y, xi4.z, xi4.w};
      const float yr[4] = {yr4.x, yr4.y, yr4.z, yr4.w};
      const float yi[4] = {yi4.x, yi4.y, yi4.z, yi4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // conj(x) y
          cr[a][c] = fmaf(xr[a], yr[c], cr[a][c]);
          cr[a][c] = fmaf(xi[a], yi[c], cr[a][c]);
          ci[a][c] = fmaf(xr[a], yi[c], ci[a][c]);
          ci[a][c] = fmaf(-xi[a], yr[c], ci[a][c]);
        }
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  const uint8_t* mb = mask + (size_t)b * P.Kc2;
  const int P4 = 4 * Kc;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int pi = I * kTile + ty * 4 + a;
    if (pi >= P4) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int pj = J * kTile + tx * 4 + c;
      if (pj >= P4 || pj < pi) continue;
      tile_entry(Rb, db, mb, P, pi, pj, cr[a][c], ci[a][c]);
    }
  }
}

// d[0..1] += a * b on the FP64 tensor cores: one m8n8k4 product per warp.
// Fragments (PTX ISA, m8n8k4 .f64): A[g][q], B[q][g], C[g][2q + e] with
// g = lane / 4, q = lane % 4.  Not volatile: the operands carry every
// dependence, and the compiler may interleave the products with the loads.
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// fit_gram, complex128: 8 warps, each a 32 x 16 piece of the tile as 4 x 2
// m8n8k4 products (four real products per complex one), two blocks a SM.
// The depth runs in steps of 8 rows through a ring of kStages64 buffers in
// dynamic shared memory, filled by cp.async straight from device memory
// (interleaved complex, rows padded to 66 elements: the fragments' 16-byte
// reads fall on distinct banks); B = o A is formed as the fragments are read.
constexpr int kDepth64 = 8;
constexpr int kLd64 = kTile + 2;
constexpr int kStages64 = 4;
constexpr int kStage64 = 2 * kDepth64 * kLd64;     // double2 per stage
constexpr int kSmem64 = kStages64 * kStage64 * (int)sizeof(double2);

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__global__ void __launch_bounds__(kGramThreads, 2)
    gram_c128(const double2* __restrict__ A, const double* __restrict__ o,
              const double* __restrict__ dinv,
              const uint8_t* __restrict__ mask, double2* __restrict__ R,
              int N, int Kc) {
  double2* ring = reinterpret_cast<double2*>(g_smem);
  const Plan P(Kc);
  const int per = P.ntiles + P.nstrips;
  const int b = blockIdx.x / per, t = blockIdx.x - b * per;
  const double2* Ab = A + (size_t)b * N * P.Kc2;
  double2* Rb = R + (size_t)b * P.M * P.M;
  const double* db = dinv + (size_t)b * P.M;
  if (t >= P.ntiles) {
    strip_block(Ab, o, db, Rb, P, N, t - P.ntiles,
                reinterpret_cast<double*>(g_smem));
    return;
  }
  int I, J;
  if (!tile_here(P, t, I, J)) return;
  const int tid = threadIdx.x, lc = tid & (kTile - 1), lr = tid >> 6;
  const int P4 = 4 * Kc;
  // this thread's copies: column lc of X and of Y, rows lr and lr + 4
  const int pxc = I * kTile + lc, pyc = J * kTile + lc;
  const bool okx = pxc < P4, oky = pyc < P4;
  const double2* srcx = Ab + (okx ? P.slot(pxc) : 0);
  const double2* srcy = Ab + (oky ? P.slot(pyc) : 0);
  const int nsteps = (N + kDepth64 - 1) / kDepth64;
  auto issue = [&](int step) {
    double2* st = ring + (step % kStages64) * kStage64;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = lr + 4 * r, n = step * kDepth64 + k;
      const bool in = n < N;
      const size_t off = (size_t)(in ? n : 0) * P.Kc2;
      cp_async16(st + k * kLd64 + lc, srcx + off, in && okx);
      cp_async16(st + (kDepth64 + k) * kLd64 + lc, srcy + off, in && oky);
    }
  };
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int wi = (warp >> 2) * 32, wj = (warp & 3) * 16;
  bool scx[4], scy[2];
#pragma unroll
  for (int u = 0; u < 4; ++u) scx[u] = I * kTile + wi + 8 * u + g >= P.h;
#pragma unroll
  for (int v = 0; v < 2; ++v) scy[v] = J * kTile + wj + 8 * v + g >= P.h;
  double cr[4][2][2], ci[4][2][2];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int e = 0; e < 2; ++e) cr[u][v][e] = ci[u][v][e] = 0.0;
#pragma unroll
  for (int sidx = 0; sidx < kStages64 - 1; ++sidx) {
    if (sidx < nsteps) issue(sidx);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int step = 0; step < nsteps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages64 - 2));
    __syncthreads();
    if (step + kStages64 - 1 < nsteps) issue(step + kStages64 - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const double2* st = ring + (step % kStages64) * kStage64;
#pragma unroll
    for (int k0 = 0; k0 < kDepth64; k0 += 4) {
      const int k = k0 + q, n = step * kDepth64 + k;
      const double on = n < N ? o[n] : 0.0;
      double xr[4], xi[4], yr[2], yi[2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        double2 x = st[k * kLd64 + wi + 8 * u + g];
        if (scx[u]) {
          x.x = on * x.x;
          x.y = on * x.y;
        }
        xr[u] = x.x;
        xi[u] = x.y;
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        double2 y = st[(kDepth64 + k) * kLd64 + wj + 8 * v + g];
        if (scy[v]) {
          y.x = on * y.x;
          y.y = on * y.y;
        }
        yr[v] = y.x;
        yi[v] = y.y;
      }
      // conj(x) y, the four real products in four sweeps, so that
      // consecutive products go to different accumulators
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) mma_f64(cr[u][v], xr[u], yr[v]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) mma_f64(ci[u][v], xr[u], yi[v]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) mma_f64(cr[u][v], xi[u], yi[v]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) mma_f64(ci[u][v], -xi[u], yr[v]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  const uint8_t* mb = mask + (size_t)b * P.Kc2;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int pi = I * kTile + wi + 8 * u + g;
    if (pi >= P4) continue;
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pj = J * kTile + wj + 8 * v + 2 * q + e;
        if (pj >= P4 || pj < pi) continue;
        tile_entry(Rb, db, mb, P, pi, pj, cr[u][v][e], ci[u][v][e]);
      }
  }
}

// Shared memory of one fit_basis block (bytes): 2 (eaQHM) or 3 (iQHM)
// real vectors of N.
template <typename T>
int basis_smem(int N, bool iqhm) {
  return (iqhm ? 3 : 2) * N * (int)sizeof(T);
}

// Blocks of one fit_gram launch per frame (tiles, skipped ones included,
// and strips).
int gram_blocks(int Kc) {
  const Plan P(Kc);
  return P.ntiles + P.nstrips;
}

int set_smem(const void* fn) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
}

template <typename T>
int launch_eaqhm(const void* fm, const void* am, const void* s, const void* o,
                 const void* wl, const void* cmask, void* A, void* rhs,
                 void* dinv, void* mask, int B, int N, int Kc, double fs,
                 double c, double eps, void* stream) {
  using C = typename Cplx<T>::type;
  const int smem = basis_smem<T>(N, false);
  if (B < 1 || N < 1 || Kc < 0 || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int groups = (2 * Kc + 1 + kBasisThreads - 1) / kBasisThreads;
  basis_eaqhm<T><<<B * groups, kBasisThreads, smem, (cudaStream_t)stream>>>(
      (const T*)fm, (const T*)am, (const T*)s, (const T*)o, (const T*)wl,
      (const uint8_t*)cmask, (C*)A, (C*)rhs, (T*)dinv, (uint8_t*)mask, N, Kc,
      groups, (T)fs, (T)c, (T)eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_iqhm(const void* s, const void* o, const void* wl, const void* f0,
                const void* K, void* A, void* rhs, void* dinv, void* mask,
                int B, int N, int Kc, double c, void* stream) {
  using C = typename Cplx<T>::type;
  const int smem = basis_smem<T>(N, true);
  if (B < 1 || N < 1 || Kc < 0 || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int groups = (2 * Kc + 1 + kBasisThreads - 1) / kBasisThreads;
  basis_iqhm<T><<<B * groups, kBasisThreads, smem, (cudaStream_t)stream>>>(
      (const T*)s, (const T*)o, (const T*)wl, (const T*)f0,
      (const long long*)K, (C*)A, (C*)rhs, (T*)dinv, (uint8_t*)mask, N, Kc,
      groups, (T)c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Set the dynamic shared-memory attribute of the basis kernels and the
// complex128 Gram on the current device.
// Returns the cudaError_t (0 on success).
int fit_prepare() {
  int e;
  if ((e = set_smem((const void*)basis_eaqhm<float>))) return e;
  if ((e = set_smem((const void*)basis_eaqhm<double>))) return e;
  if ((e = set_smem((const void*)basis_iqhm<float>))) return e;
  if ((e = set_smem((const void*)basis_iqhm<double>))) return e;
  return set_smem((const void*)gram_c128);
}

// fit_basis, eaQHM mode (types float32 / float64; see basis_eaqhm).
// c = 2pi/fs.  Returns the cudaError_t of the launch.
int fit_basis_eaqhm_f32(const void* fm, const void* am, const void* s,
                        const void* o, const void* wl, const void* cmask,
                        void* A, void* rhs, void* dinv, void* mask, int B,
                        int N, int Kc, double fs, double c, double eps,
                        void* stream) {
  return launch_eaqhm<float>(fm, am, s, o, wl, cmask, A, rhs, dinv, mask, B,
                             N, Kc, fs, c, eps, stream);
}

int fit_basis_eaqhm_f64(const void* fm, const void* am, const void* s,
                        const void* o, const void* wl, const void* cmask,
                        void* A, void* rhs, void* dinv, void* mask, int B,
                        int N, int Kc, double fs, double c, double eps,
                        void* stream) {
  return launch_eaqhm<double>(fm, am, s, o, wl, cmask, A, rhs, dinv, mask, B,
                              N, Kc, fs, c, eps, stream);
}

// fit_basis, iQHM mode (see basis_iqhm).  c = 2pi/fs.
int fit_basis_iqhm_f32(const void* s, const void* o, const void* wl,
                       const void* f0, const void* K, void* A, void* rhs,
                       void* dinv, void* mask, int B, int N, int Kc, double c,
                       void* stream) {
  return launch_iqhm<float>(s, o, wl, f0, K, A, rhs, dinv, mask, B, N, Kc, c,
                            stream);
}

int fit_basis_iqhm_f64(const void* s, const void* o, const void* wl,
                       const void* f0, const void* K, void* A, void* rhs,
                       void* dinv, void* mask, int B, int N, int Kc, double c,
                       void* stream) {
  return launch_iqhm<double>(s, o, wl, f0, K, A, rhs, dinv, mask, B, N, Kc, c,
                             stream);
}

// fit_gram: A [B, N, 2Kc+1] complex64 / complex128, o [N] and dinv [B, M]
// real, mask [B, 2Kc+1] bytes -> R [B, M, M].
int fit_gram_c64(const void* A, const void* o, const void* dinv,
                 const void* mask, void* R, int B, int N, int Kc,
                 void* stream) {
  if (B < 1 || N < 1 || Kc < 1) return (int)cudaErrorInvalidValue;
  gram_c64<<<B * gram_blocks(Kc), kGramThreads, 0,
             (cudaStream_t)stream>>>((const float2*)A, (const float*)o,
                                     (const float*)dinv, (const uint8_t*)mask,
                                     (float2*)R, N, Kc);
  return (int)cudaGetLastError();
}

int fit_gram_c128(const void* A, const void* o, const void* dinv,
                  const void* mask, void* R, int B, int N, int Kc,
                  void* stream) {
  if (B < 1 || N < 1 || Kc < 1) return (int)cudaErrorInvalidValue;
  gram_c128<<<B * gram_blocks(Kc), kGramThreads, kSmem64,
              (cudaStream_t)stream>>>((const double2*)A, (const double*)o,
                                      (const double*)dinv,
                                      (const uint8_t*)mask, (double2*)R, N,
                                      Kc);
  return (int)cudaGetLastError();
}

}  // extern "C"
