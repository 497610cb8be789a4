// The fit's normal equations for a batch of frames, for Hopper: the
// windowed basis read from the track tables, and its three Hermitian Grams,
// padded and equilibrated.
//
// Replaces eaqhm_tpu/ops/solver.py `build_gram_split` (:212-247) fed by
// `iqhm_gram` (:402-422, the stationary fit of adaptation 0) and
// `eaqhm_gram` (:508-587, every eaQHM adaptation, with `repair_tracks` at
// :441-505), and the window gathers before them in eaqhm_tpu/models/
// engine.py (`dead_overlay_windows` :149-164, `_iqhm_stage` :188,
// `_eaqhm_bucket` :244), which XLA fuses on the TPU.  No Pallas kernel stood
// for them.  Per frame b the window's rows n = 0..N-1 (offsets o = n - W,
// W = (N-1)/2) are rows clamp(ctr[b] + o, 0, L-1) of utterance utt[b]'s
// tables (L samples).  The fit builds the basis E1 [N, Kc2] (Kc2 = 2Kc+1
// column slots: harmonics -Kc..-1, DC, 1..Kc), A = w E1 with the frame's
// window w and B = o A, and returns
//     R = [[G0, G1], [G1^H, G2]],  G0 = A^H A, G1 = A^H B, G2 = B^H B,
// with identity rows and columns at masked slots and Jacobi equilibration
// R_ij dinv_i dinv_j, dinv = rsqrt(max(Re diag R, 1e-30)), the right-hand
// side [A^H (w s), B^H (w s)] dinv and dinv [M] (M = 2 Kc2).
//
// Two kernels:
// - fit_basis (one frame and 8 harmonics a block, a warp a harmonic, its
//   lanes on 32 rows at a time).  It reads s, and in eaQHM mode the track
//   tables fm, am [utterances, L, >= Kc] through their strides and the dead
//   centres, and applies the dead-track overlay itself (harmonic 1 reads
//   140 Hz / 1e-3 at a dead centre left of the frame's centre, or at it
//   when the frame is dead).  iQHM mode: phase ((2pi/fs) o) (k f0).  eaQHM
//   mode: the zero-gap repair (the previous and next nonzero inside the
//   window from the warp's ballot, with a lookahead past the chunk only
//   where a run of zeros crosses its end), the integer split q = rint(fm),
//   r = fm - q, the inclusive cumsums over the warp's lanes (q as an
//   integer scan while its partial sums are exact, else in row order as
//   torch.cumsum rounds them; r in a tree order), recentred at W,
//   torch.remainder's mod fs, rho, and the negative block's one-sample
//   shift; a first pass over rows 0..W gives the centre values.
//   Every elementwise step rounds where the torch ops (and JAX) round, in
//   their order: products and sums are __fmul_rn / __fadd_rn and never
//   contracted, sincos and cos are the accurate ones.  A [B, N, Kc2] is
//   written once (interleaved complex; a block's 8 columns of 32 rows are
//   staged in shared memory, so a row's 8 entries go out together), and
//   per column the right-hand side, dinv (the Gram's diagonal is the
//   column's sum of |A|^2 and |B|^2), the column mask, and R's entries
//   against the DC column: the DC column is the real w and its B column is
//   o w, so those Gram entries are three more running sums per column (sum
//   w a, w b, (o w) b above the DC; the conjugates of sum a w, a (o w),
//   b (o w) below it), and every block sums the DC column's own (w^2,
//   (o w)^2, w (o w), the right-hand side) in one fixed order.
// - fit_gram (one frame and one 32 x 32 tile a block, 4 warps, a warp a
//   16 x 16 piece of all three Grams).  The tiles run over the 2 Kc columns
//   but the DC ("g-space"): each Gram is Hermitian (o is real), so each is
//   taken as its own upper triangle at every Kc, and a warp skips a piece
//   wholly below the diagonal or past the edge.  Executed work (the live
//   pieces) over the least (one triangle of each Gram, 3 M^2 N real flops a
//   frame) is 1.02-1.30 at the main paths' orders (Kc = 24-487): 16-column
//   pieces are the coarsest grain under 1.35 there (32-column pieces give
//   1.45-2.56 at Kc = 24, 32, 40, 59).  Each entry below the diagonal is
//   written as the conjugate of its mirror; the diagonal's imaginary part
//   is zero.  Each entry is the sum JAX's einsum defines, in another order
//   (B = o A rounded as JAX rounds it), or its mirror's conjugate.  The
//   epilogue adds the identity at masked slots and scales by dinv_i dinv_j:
//   with fit_basis's DC entries, R is written once.  The depth (rows n)
//   streams through a four-stage cp.async ring in dynamic shared memory
//   (the first complex64 engine staged through registers and spent 73% of
//   a tile's clocks waiting on its loads).  complex64: FP32 FFMA, a thread
//   4 x 2 entries of each Gram (no TF32 in any form, no three-multiplication
//   product: either would move what the float32 gate decides); complex128:
//   the FP64 tensor cores through mma.sync m16n8k4, which runs at the full
//   FP64 tensor rate on an H100 where m8n8k4 runs at half
//   (tools/bench_fit_phases.py --probe: 66.4 against 33.3 TFLOP/s).
//
// What bounds it on an H100: the Grams take 3 M^2 N real flops per frame
// (the least this function needs) against N Kc2 basis elements read and M^2
// written: at the main path's orders (M = 98-1950, N = 241-2897) arithmetic
// bounds fit_gram.  fit_basis moves the table rows its windows cover and A
// (about 0.15 ms of bytes at 3.35 TB/s for a 512 x 609 x 96 batch in
// complex64); its walk is latency-bound, and the warp-wide repair and scans
// shorten it.
//
// Every launch is on the caller's stream, allocates nothing and does not
// synchronize; each entry point returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemMax = 232448;   // shared memory one block can use (H100)
constexpr int kBasisWarps = 8;     // harmonics per fit_basis block
constexpr int kBasisThreads = 32 * kBasisWarps;
constexpr int kGramThreads = 128;  // 4 warps, a piece each
constexpr int kPiece = 16;         // a warp's piece of the Grams (entries)
constexpr int kTileR = 32;         // a fit_gram tile: rows of g-space
constexpr int kTileC = 32;         // and columns
constexpr int kLd = kTileR + kTileC;  // elements of one staged depth row
constexpr int kStages = 4;            // the cp.async ring
constexpr int kDepth32 = 16;          // depth rows a stage, complex64
constexpr int kDepth64 = 8;           // complex128
constexpr int kGramSmem = kStages * kDepth32 * kLd * 8;  // both types
constexpr double kPi = 3.141592653589793;
constexpr double kDeadF0 = 140.0;  // the dead-track bootstrap (reference
constexpr double kDeadAm = 1e-3;   // functions.py:209-210)

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

// torch.remainder(a, b) of an integer-valued a by an integer-valued b > 0
// (b below 2^24): the result is an integer in [0, b), so fmod's is exact,
// and so is this one, from a rounded quotient (off by at most one while
// |a| / b < 2^22) and one correction; fmod is a loop, this is five
// operations.  Other arguments take remainder_t.
template <typename T>
__device__ __forceinline__ T remainder_of(T a, T b, T inv_b, bool b_int) {
  if (!b_int || !(fabs(a) < T(4194304) * b)) return remainder_t(a, b);
  T m = fma(-b, floor(a * inv_b), a);
  if (m < T(0))
    m = radd(m, b);
  else if (m >= b)
    m = rsub(m, b);
  return m;
}

// rsqrt(clamp(d, min=1e-30)), NaN kept (torch.clamp's rule).
template <typename T>
__device__ __forceinline__ T equil(T d) {
  const T lo = T(1e-30);
  return rrsqrt(d < lo ? lo : d);
}

// R[r, c] = (re, im) * d, d = dinv_c dinv_r (the identity already added).
template <typename C, typename T>
__device__ __forceinline__ void put(C* Rb, int M, int r, int c, T re, T im,
                                    T d) {
  C v;
  v.x = re * d;
  v.y = im * d;
  Rb[(size_t)r * M + c] = v;
}

// The eight entries of R that slots r < c give, from the upper-triangle
// entries (re, im)[q] of G0, G1, G2 at (r, c) and the scales r0, r1, c0, c1
// (dinv of r, K2 + r, c, K2 + c): the mirrors conjugated, G1^H's block from
// G1.
template <typename C, typename T>
__device__ __forceinline__ void put_pair(C* Rb, int M, int K2, int r, int c,
                                         const T (&re)[3], const T (&im)[3],
                                         T r0, T r1, T c0, T c1) {
  put(Rb, M, r, c, re[0], im[0], c0 * r0);
  put(Rb, M, c, r, re[0], -im[0], r0 * c0);
  put(Rb, M, r, K2 + c, re[1], im[1], c1 * r0);
  put(Rb, M, c, K2 + r, re[1], -im[1], r1 * c0);
  put(Rb, M, K2 + c, r, re[1], -im[1], r0 * c1);
  put(Rb, M, K2 + r, c, re[1], im[1], c0 * r1);
  put(Rb, M, K2 + r, K2 + c, re[2], im[2], c1 * r1);
  put(Rb, M, K2 + c, K2 + r, re[2], -im[2], r1 * c1);
}

// The four entries of slot r's diagonal: real, the identity at a masked
// slot (G0 and G2 only).
template <typename C, typename T>
__device__ __forceinline__ void put_diag(C* Rb, int M, int K2, int r,
                                         const T (&re)[3], bool masked, T r0,
                                         T r1) {
  const T one = masked ? T(1) : T(0);
  put(Rb, M, r, r, re[0] + one, T(0), r0 * r0);
  put(Rb, M, r, K2 + r, re[1], T(0), r1 * r0);
  put(Rb, M, K2 + r, r, re[1], T(0), r0 * r1);
  put(Rb, M, K2 + r, K2 + r, re[2] + one, T(0), r1 * r1);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

// Inclusive scans over the warp's lanes (Hillis-Steele).
__device__ __forceinline__ int scan_int(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += t;
  }
  return x;
}

template <typename T>
__device__ __forceinline__ T scan_real(T x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T t = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = radd(t, x);
  }
  return x;
}

// The running sum carry + q_0 + ... + q_lane of integer-valued q, rounded
// as torch.cumsum rounds it on a column (in row order): while every partial
// sum is an integer below 2^24 (float) or 2^53 (double), exactly, as an
// integer scan; past it, in row order, each lane adding the broadcast
// values one by one.
template <typename T>
__device__ __forceinline__ T scan_rows(T q, T carry, int lane) {
  constexpr T kExact = sizeof(T) == 4 ? T(16777216.0) : T(9007199254740992.0);
  const T aq = fabs(q);
  const unsigned amax = __reduce_max_sync(
      0xffffffffu, aq < T(1 << 25) ? (unsigned)aq : 1u << 25);
  if (amax < (1u << 25) && fabs(carry) + T(32) * T(amax) < kExact)
    return T((long long)carry + scan_int((int)q, lane));
  T x = carry;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const T v = __shfl_sync(0xffffffffu, q, i);
    if (i <= lane) x = radd(x, v);
  }
  return x;
}

extern __shared__ __align__(16) unsigned char g_smem[];

// Profiling build (-DFIT_PHASE_CLOCKS, tools/bench_fit_phases.py --clocks):
// clock64 cycles summed per (kernel, phase) over the blocks of a launch, as
// thread 0 of each block sees them; slot kClkSlots - 1 counts the blocks.
// The port's own build has none of it.
constexpr int kClkKinds = 4;    // gram_c64, gram_c128, basis eaQHM, iQHM
constexpr int kClkSlots = 8;
#ifdef FIT_PHASE_CLOCKS
__device__ unsigned long long g_clk[kClkKinds][kClkSlots];
struct Clk {
  int kind;
  long long prev;
  unsigned long long c[kClkSlots];
  __device__ explicit Clk(int k) : kind(k) {
    prev = clock64();
    for (int q = 0; q < kClkSlots; ++q) c[q] = 0;
  }
  __device__ __forceinline__ void mark(int slot) {
    const long long now = clock64();
    c[slot] += (unsigned long long)(now - prev);
    prev = now;
  }
  __device__ void flush() {
    if (threadIdx.x != 0) return;
    for (int q = 0; q < kClkSlots - 1; ++q)
      if (c[q]) atomicAdd(&g_clk[kind][q], c[q]);
    atomicAdd(&g_clk[kind][kClkSlots - 1], 1ull);
  }
};
#else
struct Clk {
  __device__ explicit Clk(int) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ void flush() {}
};
#endif

// ---------------------------------------------------------------- fit_basis

template <typename T>
struct BasisArgs {
  const T* s;               // [utterances, L]
  const T* fm;              // eaQHM: [utterances, L, >= Kc] (strides su, sl)
  const T* am;
  const uint8_t* dead;      // eaQHM: [utterances, L] dead centres
  const long long* utt;     // [B] the frame's utterance
  const long long* ctr;     // [B] its centre row
  const uint8_t* dd;        // eaQHM: [B] the frame is dead
  const T* wl;              // [B] window half-widths
  const T* f0;              // iQHM: [B]
  const long long* K;       // iQHM: [B] harmonic counts
  const uint8_t* cmask;     // eaQHM: [B, Kc] selected harmonics
  typename Cplx<T>::type* A;     // [B, N, Kc2] out
  typename Cplx<T>::type* R;     // [B, M, M] out: the entries against DC
  typename Cplx<T>::type* rhs;   // [B, M] out
  T* dinv;                       // [B, M] out
  uint8_t* mask;                 // [B, Kc2] out
  long long L, su, sl;
  int N, Kc, groups;
  T fs, c, eps;
};

// One harmonic's track column read through the tables, with the overlay.
template <typename T>
struct Track {
  const T* fm;              // at the utterance's row 0 and this harmonic
  const T* am;
  const uint8_t* dead;      // at the utterance's row 0
  long long ctr, L, sl;
  int N, W;
  T wl;
  bool first, ddb;          // harmonic 1; the frame is dead
  // row n's (f, a), overlaid; whether it lies inside the window; returns
  // whether f is a nonzero inside it
  __device__ bool load(int n, T& f, T& a, bool& in) const {
    f = a = T(0);
    in = false;
    if (n >= N) return false;
    long long l = ctr + n - W;
    l = l < 0 ? 0 : (l >= L ? L - 1 : l);
    f = fm[l * sl];
    a = am[l * sl];
    if (first && dead[l] && (n < W || (n == W && ddb))) {
      f = T(kDeadF0);
      a = T(kDeadAm);
    }
    in = fabs(T(n - W)) <= wl;
    return in && f != T(0);
  }
};

// The zero-gap repair (repair_tracks) of rows n0 + lane, a chunk of 32 at a
// time in row order: the previous nonzero (at or before the row) from the
// chunk's ballot or the carry of the chunks before; the next (at or after
// it) from the ballot or a lookahead, which runs once per run of zeros that
// crosses a chunk's end.
template <typename T>
struct Repair {
  int prev, nxt;            // rows; -1: none before / not yet searched
  T pf, pa, nf, na;
  __device__ void reset() {
    prev = -1;
    nxt = -1;
  }
  __device__ void search(const Track<T>& tr, int from, int lane) {
    for (int m0 = from; m0 < tr.N; m0 += 32) {
      T f, a;
      bool in;
      const bool nz = tr.load(m0 + lane, f, a, in);
      const unsigned m = __ballot_sync(0xffffffffu, nz);
      if (m) {
        const int pos = __ffs(m) - 1;
        nxt = m0 + pos;
        nf = __shfl_sync(0xffffffffu, f, pos);
        na = __shfl_sync(0xffffffffu, a, pos);
        return;
      }
    }
    nxt = tr.N;
  }
  // the chunk's rows as Track::load gave them (f, a, in, nz): loaded a
  // chunk ahead, so that the loads overlap the chunk before
  __device__ void chunk(const Track<T>& tr, int n0, int lane, T f, T a,
                        bool in, bool nz, T& fo, T& ao) {
    const unsigned m = __ballot_sync(0xffffffffu, nz);
    if (!(m >> 31) && nxt < n0 + 32) search(tr, n0 + 32, lane);
    const unsigned lo = m & (0xffffffffu >> (31 - lane));
    const unsigned hi = m & (0xffffffffu << lane);
    const int pp = lo ? 31 - __clz(lo) : 0, np = hi ? __ffs(hi) - 1 : 0;
    const T spf = __shfl_sync(0xffffffffu, f, pp);
    const T spa = __shfl_sync(0xffffffffu, a, pp);
    const T snf = __shfl_sync(0xffffffffu, f, np);
    const T sna = __shfl_sync(0xffffffffu, a, np);
    const int p = lo ? n0 + pp : prev, q = hi ? n0 + np : nxt;
    const T xpf = lo ? spf : pf, xpa = lo ? spa : pa;
    const T xnf = hi ? snf : nf, xna = hi ? sna : na;
    if (m) {
      const int top = 31 - __clz(m);
      prev = n0 + top;
      pf = __shfl_sync(0xffffffffu, f, top);
      pa = __shfl_sync(0xffffffffu, a, top);
    }
    const int n = n0 + lane;
    const bool hp = p >= 0, hn = q < tr.N;
    if (!in) {
      fo = ao = T(0);
    } else if (nz) {
      fo = f;
      ao = a;
    } else if (hp && hn) {
      const T g = rdiv(T(n - p), T(q - p));
      fo = radd(xpf, rmul(rsub(xnf, xpf), g));
      ao = radd(xpa, rmul(rsub(xna, xpa), g));
    } else if (hp) {
      fo = xpf;
      ao = xpa;
    } else if (hn) {
      fo = xnf;
      ao = xna;
    } else {
      fo = ao = T(0);
    }
  }
};

// One column's running sums over its rows: the right-hand side A^H ws and
// B^H ws, the Gram's diagonal |A|^2 and |B|^2 (B = o A rounded), and its
// Gram entries against the DC column (a_dc = w, b_dc = o w): above the DC
// (positive harmonics) sum w a, w b, b_dc b; below it (NEG) sum a w, a b_dc,
// b b_dc, whose conjugates are the entries.
template <typename T>
struct ColSums {
  T v[12] = {};   // ra x, y; rb x, y; da; db; g0 x, y; g1 x, y; g2 x, y
  template <bool NEG>
  __device__ __forceinline__ void add(T ax, T ay, T on, T wsn, T wn, T bdn) {
    const T bx = rmul(on, ax), by = rmul(on, ay);
    v[0] = fma(ax, wsn, v[0]);
    v[1] = fma(-ay, wsn, v[1]);
    v[2] = fma(bx, wsn, v[2]);
    v[3] = fma(-by, wsn, v[3]);
    v[4] = fma(ax, ax, fma(ay, ay, v[4]));
    v[5] = fma(bx, bx, fma(by, by, v[5]));
    v[6] = fma(wn, ax, v[6]);
    v[7] = fma(wn, ay, v[7]);
    v[8] = NEG ? fma(bdn, ax, v[8]) : fma(wn, bx, v[8]);
    v[9] = NEG ? fma(bdn, ay, v[9]) : fma(wn, by, v[9]);
    v[10] = fma(bdn, bx, v[10]);
    v[11] = fma(bdn, by, v[11]);
  }
  __device__ __forceinline__ void reduce() {
#pragma unroll
    for (int i = 0; i < 12; ++i) v[i] = warp_sum(v[i]);
  }
  // slot j: rhs * dinv and dinv of j and Kc2 + j
  template <typename C>
  __device__ __forceinline__ void store(C* rhs, T* dinv, int j, int K2,
                                        bool live, T& d0, T& d1) const {
    d0 = live ? equil(v[4]) : T(1);
    d1 = live ? equil(v[5]) : T(1);
    C r;
    r.x = live ? rmul(v[0], d0) : T(0);
    r.y = live ? rmul(v[1], d0) : T(0);
    rhs[j] = r;
    r.x = live ? rmul(v[2], d1) : T(0);
    r.y = live ? rmul(v[3], d1) : T(0);
    rhs[K2 + j] = r;
    dinv[j] = d0;
    dinv[K2 + j] = d1;
  }
};

// fit_basis: grid B * groups blocks (frame, 8 harmonics), kBasisThreads.
// Shared memory: w, w s, o w (and iQHM's (2pi/fs) o) per row, then the
// staged A rows [2][2][32][8] and the DC partial sums [8][5].
// Blocks a SM holds: the walk is latency-bound, so the registers are capped
// for more warps (3 blocks of float eaQHM at <= 80 registers, 4 of float
// iQHM, 2 of double).
template <typename T, bool EA>
constexpr int basis_min_blocks() {
  return sizeof(T) == 4 ? (EA ? 3 : 4) : 2;
}

template <typename T, bool EA>
__global__ void __launch_bounds__(kBasisThreads, (basis_min_blocks<T, EA>()))
    basis_kernel(const BasisArgs<T> p) {
  using C = typename Cplx<T>::type;
  const int N = p.N, Kc = p.Kc, K2 = 2 * Kc + 1, M = 2 * K2, W = (N - 1) / 2;
  const int b = blockIdx.x / p.groups, grp = blockIdx.x - b * p.groups;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int reals = (EA ? 3 : 4) * N;
  T* w_s = reinterpret_cast<T*>(g_smem);
  T* ws_s = w_s + N;
  T* bd_s = ws_s + N;
  T* t_s = bd_s + N;                                   // iQHM only
  C* stage = reinterpret_cast<C*>(w_s + reals + (reals & 1));
  T* red = reinterpret_cast<T*>(stage + 2 * 2 * 32 * kBasisWarps);
  const long long u = p.utt[b], ctr = p.ctr[b];
  const long long L = p.L;
  const T* sb = p.s + u * L;
  const T wlb = p.wl[b];
  C* Ab = p.A + (size_t)b * N * K2;
  C* Rb = p.R + (size_t)b * M * M;
  Clk clk(EA ? 2 : 3);
  // the windows (hamming for eaQHM, blackman for iQHM; 0 outside +-wl),
  // w s, o w; the DC column's sums
  T dsum[5] = {};   // w^2, (o w)^2, w ws, (o w) ws, w (o w)
  for (int n = tid; n < N; n += kBasisThreads) {
    const T on = T(n - W);
    T w;
    if (EA) {
      w = radd(T(0.54), rmul(T(0.46), rcos(rdiv(rmul(T(kPi), on), wlb))));
    } else {
      const T r = rdiv(on, wlb);
      w = radd(radd(T(0.42), rmul(T(0.5), rcos(rmul(T(kPi), r)))),
               rmul(T(0.08), rcos(rmul(T(2 * kPi), r))));
      t_s[n] = rmul(p.c, on);
    }
    w = fabs(on) <= wlb ? w : T(0);
    long long l = ctr + n - W;
    l = l < 0 ? 0 : (l >= L ? L - 1 : l);
    const T ws = rmul(w, sb[l]), bd = rmul(on, w);
    w_s[n] = w;
    ws_s[n] = ws;
    bd_s[n] = bd;
    dsum[0] = fma(w, w, dsum[0]);
    dsum[1] = fma(bd, bd, dsum[1]);
    dsum[2] = fma(w, ws, dsum[2]);
    dsum[3] = fma(bd, ws, dsum[3]);
    dsum[4] = fma(w, bd, dsum[4]);
    if (grp == 0) {                     // the DC column of A: E1 = 1
      C v;
      v.x = w;
      v.y = T(0);
      Ab[(size_t)n * K2 + Kc] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    dsum[i] = warp_sum(dsum[i]);
    if (lane == 0) red[warp * 5 + i] = dsum[i];
  }
  __syncthreads();
  // the DC column's totals, summed over the warps in one order by every
  // thread (the same in every block of the frame)
  T dc[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    dc[i] = red[i];
    for (int q = 1; q < kBasisWarps; ++q) dc[i] += red[q * 5 + i];
  }
  const T dc0 = equil(dc[0]), dc1 = equil(dc[1]);
  if (grp == 0 && tid == 0) {
    C v;
    v.x = rmul(dc[2], dc0);
    v.y = T(0);
    p.rhs[(size_t)b * M + Kc] = v;
    v.x = rmul(dc[3], dc1);
    p.rhs[(size_t)b * M + K2 + Kc] = v;
    p.dinv[(size_t)b * M + Kc] = dc0;
    p.dinv[(size_t)b * M + K2 + Kc] = dc1;
    p.mask[(size_t)b * K2 + Kc] = 1;
    const T g[3] = {dc[0], dc[4], dc[1]};
    put_diag(Rb, M, K2, Kc, g, false, dc0, dc1);
  }
  clk.mark(0);
  // this warp's harmonic (k + 1): columns jp = Kc + 1 + k and jn = Kc - 1 - k
  const int k = grp * kBasisWarps + warp;
  const bool have = k < Kc;
  bool live = false;
  if (have) live = EA ? p.cmask[(size_t)b * Kc + k] != 0 : k + 1 <= p.K[b];
  const int jp = Kc + 1 + k, jn = Kc - 1 - k;
  ColSums<T> sp, sn;
  Track<T> tr;
  Repair<T> rep;
  T cqW = T(0), qW = T(0), crW = T(0), rW = T(0), amW = T(0);
  T kfp = T(0), kfn = T(0);
  if (EA && live) {
    tr.fm = p.fm + u * p.su + k;
    tr.am = p.am + u * p.su + k;
    tr.dead = p.dead + u * L;
    tr.ctr = ctr;
    tr.L = L;
    tr.sl = p.sl;
    tr.N = N;
    tr.W = W;
    tr.wl = wlb;
    tr.first = k == 0;
    tr.ddb = p.dd[b] != 0;
    // walk 1: the centre values (cumsums at W, fm's split and am at W)
    rep.reset();
    T cq = T(0), cr = T(0), f, a;
    bool in, nz = tr.load(lane, f, a, in);
    for (int n0 = 0; n0 <= W; n0 += 32) {
      T fo, ao, f1 = T(0), a1 = T(0);
      bool in1 = false, nz1 = false;
      if (n0 + 32 <= W) nz1 = tr.load(n0 + 32 + lane, f1, a1, in1);
      rep.chunk(tr, n0, lane, f, a, in, nz, fo, ao);
      f = f1;
      a = a1;
      in = in1;
      nz = nz1;
      const T qf = rrint(fo), r = rsub(fo, qf);
      const T sq = scan_rows(qf, cq, lane);
      const T sr = radd(cr, scan_real(r, lane));
      if (W < n0 + 32) {
        const int src = W - n0;
        cqW = __shfl_sync(0xffffffffu, sq, src);
        crW = __shfl_sync(0xffffffffu, sr, src);
        qW = __shfl_sync(0xffffffffu, qf, src);
        rW = __shfl_sync(0xffffffffu, r, src);
        amW = __shfl_sync(0xffffffffu, ao, src);
      }
      cq = __shfl_sync(0xffffffffu, sq, 31);
      cr = __shfl_sync(0xffffffffu, sr, 31);
    }
    rep.reset();
  }
  if (!EA && live) {
    kfp = rmul(T(k + 1), p.f0[b]);
    kfn = rmul(T(-(k + 1)), p.f0[b]);
  }
  clk.mark(1);
  // walk 2, every warp in step (the staged rows go out together): row n of
  // the positive column, row N-1-n (eaQHM) or n (iQHM) of the negative one.
  // eaQHM: phase_neg(N-1-n) = (2pi/fs) (mod(psi_q(n-1) + q(W)) + psi_r(n-1)
  // + r(W)), psi(-1) = -C(W); rho(n) on both.
  T cq = T(0), pq = -cqW, cr = T(0), pr = -crW, f = T(0), a = T(0);
  bool in = false, nz = false;
  if (EA && live) nz = tr.load(lane, f, a, in);
  const T den = radd(amW, p.eps);
  // the phases' remainders mod fs: psi_q is integer-valued (a sum of
  // integers, rounded to integers), so an integer fs takes remainder_of
  const bool fs_int = p.fs > T(0) && p.fs == rrint(p.fs) &&
                      p.fs < T(16777216);
  const T inv_fs = T(1) / p.fs;
  for (int n0 = 0, buf = 0; n0 < N; n0 += 32, buf ^= 1) {
    const int n = n0 + lane, t = EA ? N - 1 - n : n;
    C vp, vn;
    vp.x = vp.y = vn.x = vn.y = T(0);
    if (live) {
      T php, pvn;   // the two phases
      T rho = T(1);
      if (EA) {
        T fo, ao, f1 = T(0), a1 = T(0);
        bool in1 = false, nz1 = false;
        if (n0 + 32 < N) nz1 = tr.load(n0 + 32 + lane, f1, a1, in1);
        rep.chunk(tr, n0, lane, f, a, in, nz, fo, ao);
        f = f1;
        a = a1;
        in = in1;
        nz = nz1;
        clk.mark(2);
        const T qf = rrint(fo), r = rsub(fo, qf);
        const T sq = scan_rows(qf, cq, lane);
        const T sr = radd(cr, scan_real(r, lane));
        const T psq = rsub(sq, cqW), psr = rsub(sr, crW);
        T ppq = __shfl_up_sync(0xffffffffu, psq, 1);
        T ppr = __shfl_up_sync(0xffffffffu, psr, 1);
        if (lane == 0) {
          ppq = pq;
          ppr = pr;
        }
        cq = __shfl_sync(0xffffffffu, sq, 31);
        cr = __shfl_sync(0xffffffffu, sr, 31);
        pq = __shfl_sync(0xffffffffu, psq, 31);
        pr = __shfl_sync(0xffffffffu, psr, 31);
        php = rmul(p.c, radd(remainder_of(psq, p.fs, inv_fs, fs_int), psr));
        pvn = rmul(p.c, radd(remainder_of(radd(ppq, qW), p.fs, inv_fs, fs_int),
                             radd(ppr, rW)));
        rho = rdiv(radd(ao, p.eps), den);
        clk.mark(3);
      } else {
        const T tn = n < N ? t_s[n] : T(0);
        php = rmul(tn, kfp);
        pvn = rmul(tn, kfn);
      }
      if (n < N) {
        T sinp, cosp, sinn, cosn;
        rsincos(php, &sinp, &cosp);
        rsincos(pvn, &sinn, &cosn);
        if (EA) {
          vp.x = rmul(rmul(rho, cosp), w_s[n]);
          vp.y = rmul(rmul(rho, sinp), w_s[n]);
          vn.x = rmul(rmul(rho, cosn), w_s[t]);
          vn.y = rmul(rmul(rho, sinn), w_s[t]);
        } else {
          vp.x = rmul(cosp, w_s[n]);
          vp.y = rmul(sinp, w_s[n]);
          vn.x = rmul(cosn, w_s[t]);
          vn.y = rmul(sinn, w_s[t]);
        }
        clk.mark(4);
        sp.template add<false>(vp.x, vp.y, T(n - W), ws_s[n], w_s[n],
                               bd_s[n]);
        sn.template add<true>(vn.x, vn.y, T(t - W), ws_s[t], w_s[t],
                              bd_s[t]);
        clk.mark(5);
      }
    }
    C* st = stage + buf * 2 * 32 * kBasisWarps;
    st[lane * kBasisWarps + warp] = vp;
    st[32 * kBasisWarps + lane * kBasisWarps + warp] = vn;
    __syncthreads();
    {   // thread (row r, harmonic h of the block) writes both entries
      const int r = tid / kBasisWarps, h = tid - r * kBasisWarps;
      const int kk = grp * kBasisWarps + h, nn = n0 + r;
      if (kk < Kc && nn < N) {
        const int tt = EA ? N - 1 - nn : nn;
        Ab[(size_t)nn * K2 + Kc + 1 + kk] = st[r * kBasisWarps + h];
        Ab[(size_t)tt * K2 + Kc - 1 - kk] =
            st[32 * kBasisWarps + r * kBasisWarps + h];
      }
    }
    clk.mark(4);
  }
  if (have) {
    sp.reduce();
    sn.reduce();
    if (lane == 0) {
      C* rb = p.rhs + (size_t)b * M;
      T* db = p.dinv + (size_t)b * M;
      p.mask[(size_t)b * K2 + jp] = live;
      p.mask[(size_t)b * K2 + jn] = live;
      T dp0, dp1, dn0, dn1;
      sp.store(rb, db, jp, K2, live, dp0, dp1);
      sn.store(rb, db, jn, K2, live, dn0, dn1);
      // the entries against DC: (DC, jp) from the positive column's sums;
      // (jn, DC) the conjugates of the negative column's
      const T gp_re[3] = {sp.v[6], sp.v[8], sp.v[10]};
      const T gp_im[3] = {sp.v[7], sp.v[9], sp.v[11]};
      const T gn_re[3] = {sn.v[6], sn.v[8], sn.v[10]};
      const T gn_im[3] = {-sn.v[7], -sn.v[9], -sn.v[11]};
      put_pair(Rb, M, K2, Kc, jp, gp_re, gp_im, dc0, dc1, dp0, dp1);
      put_pair(Rb, M, K2, jn, Kc, gn_re, gn_im, dn0, dn1, dc0, dc1);
    }
  }
  clk.mark(5);
  clk.flush();
}

// ----------------------------------------------------------------- fit_gram

// fit_gram's plan per frame.  g-space: the 2 Kc columns of a Gram but the
// DC (g < Kc is slot g, g >= Kc slot g + 1).  Tiles (I, J) of kTileR x
// kTileC are launched where a piece of them is live (32 x 32: the warps of
// the launched tiles that hold a live piece are 50-96% at the main paths'
// orders, 38-89% with 32 x 64 tiles, which lost to cuBLAS at Kc = 40): a piece (r0, c0) of
// 16 x 16 entries is live where it holds an entry of the upper triangle
// (c0 + 15 >= r0) inside the edge.  The wrapper's counts and the kernel's
// walk come from this one code.
struct Plan {
  int Kc, K2, M, n, RT, CT, ntiles;
  __host__ __device__ explicit Plan(int Kc_) : Kc(Kc_) {
    K2 = 2 * Kc + 1;
    M = 2 * K2;
    n = 2 * Kc;
    RT = (n + kTileR - 1) / kTileR;
    CT = (n + kTileC - 1) / kTileC;
    ntiles = 0;
    for (int J = 0; J < CT; ++J) ntiles += rows_of(J);
  }
  // row tiles of column tile J: those with a piece on or above the diagonal
  __host__ __device__ int rows_of(int J) const {
    const int r = (J * kTileC + kTileC - 1) / kTileR + 1;
    return r < RT ? r : RT;
  }
  __host__ __device__ void tile(int t, int& I, int& J) const {
    J = 0;
    while (t >= rows_of(J)) {
      t -= rows_of(J);
      ++J;
    }
    I = t;
  }
  __host__ __device__ int slot(int g) const { return g < Kc ? g : g + 1; }
  __host__ __device__ bool live(int r0, int c0) const {
    return r0 < n && c0 < n && c0 + kPiece - 1 >= r0;
  }
  // live pieces per frame
  __host__ __device__ long long live_pieces() const {
    long long c = 0;
    for (int r0 = 0; r0 < n; r0 += kPiece)
      for (int c0 = 0; c0 < n; c0 += kPiece) c += live(r0, c0);
    return c;
  }
};

// A piece's entry (gi, gj) of the three Grams into R: the upper triangle
// and the diagonal; nothing below it or past the edge.
template <typename C, typename T>
__device__ __forceinline__ void gram_entry(C* Rb, const T* db,
                                           const uint8_t* mb, const Plan& P,
                                           int gi, int gj, const T (&re)[3],
                                           const T (&im)[3]) {
  if (gi >= P.n || gj >= P.n || gj < gi) return;
  const int si = P.slot(gi), sj = P.slot(gj), K2 = P.K2;
  const T r0 = db[si], r1 = db[K2 + si];
  if (gi == gj) {
    put_diag(Rb, P.M, K2, si, re, mb[si] == 0, r0, r1);
    return;
  }
  put_pair(Rb, P.M, K2, si, sj, re, im, r0, r1, db[sj], db[K2 + sj]);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// The ring's copies of one thread: element threadIdx.x + i kGramThreads of
// a stage is depth row k_i, column slot col_i of the tile's kTileR row
// columns then its kTileC columns (-1 past the edge); fixed per thread.
template <int D>
struct Copies {
  static constexpr int kEl = D * kLd / kGramThreads;
  static_assert(D * kLd % kGramThreads == 0, "stage split");
  int k[kEl], col[kEl];
  __device__ Copies(const Plan& P, int I, int J) {
#pragma unroll
    for (int i = 0; i < kEl; ++i) {
      const int idx = threadIdx.x + i * kGramThreads;
      const int e = idx % kLd;
      const int g = e < kTileR ? I * kTileR + e : J * kTileC + e - kTileR;
      k[i] = idx / kLd;
      col[i] = g < P.n ? P.slot(g) : -1;
    }
  }
  // depth rows n0..n0+D-1 into stage st; zeros past N and past the edge
  template <typename C>
  __device__ __forceinline__ void issue(C* st, const C* Ab, int K2, int n0,
                                        int N) const {
#pragma unroll
    for (int i = 0; i < kEl; ++i) {
      const int nrow = n0 + k[i];
      const bool ok = col[i] >= 0 && nrow < N;
      const C* src = Ab + (ok ? (size_t)nrow * K2 + col[i] : 0);
      C* dst = st + threadIdx.x + i * kGramThreads;
      if (sizeof(C) == 8)
        cp_async8(dst, src, ok);
      else
        cp_async16(dst, src, ok);
    }
  }
};

// fit_gram, complex64: a thread 4 x 2 entries (rows tr*4 + a, columns
// tc*2 + c of its warp's piece) of each Gram on FP32 FFMA, B = o A formed
// from the staged A as JAX rounds it.
__global__ void __launch_bounds__(kGramThreads, 4)
    gram_c64(const float2* __restrict__ A, const float* __restrict__ dinv,
             const uint8_t* __restrict__ mask, float2* __restrict__ R, int N,
             int Kc) {
  float2* ring = reinterpret_cast<float2*>(g_smem);
  const Plan P(Kc);
  const int b = blockIdx.x / P.ntiles, t = blockIdx.x - b * P.ntiles;
  int I, J;
  P.tile(t, I, J);
  const float2* Ab = A + (size_t)b * N * P.K2;
  const int W = (N - 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pr = warp / (kTileC / kPiece), pc = warp % (kTileC / kPiece);
  const int r0 = I * kTileR + pr * kPiece, c0 = J * kTileC + pc * kPiece;
  const bool work = P.live(r0, c0);
  const int tr = lane >> 3, tc = lane & 7;
  const int xo = pr * kPiece + tr * 4, yo = kTileR + pc * kPiece + tc * 2;
  Clk clk(0);
  float cr[3][4][2], ci[3][4][2];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) cr[q][a][c] = ci[q][a][c] = 0.f;
  const int nsteps = (N + kDepth32 - 1) / kDepth32;
  constexpr int kStage = kDepth32 * kLd;
  const Copies<kDepth32> cp(P, I, J);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) cp.issue(ring + s * kStage, Ab, P.K2, s * kDepth32, N);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  clk.mark(0);
  for (int step = 0; step < nsteps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    const int nx = step + kStages - 1;
    if (nx < nsteps)
      cp.issue(ring + (nx % kStages) * kStage, Ab, P.K2, nx * kDepth32, N);
    asm volatile("cp.async.commit_group;\n" ::);
    clk.mark(1);
    if (work) {
      const float2* st = ring + (step % kStages) * kStage;
      const float on0 = (float)(step * kDepth32 - W);
#pragma unroll 4
      for (int k = 0; k < kDepth32; ++k) {
        const float on = on0 + (float)k;   // exact: integers below 2^24
        const float4 x01 = *reinterpret_cast<const float4*>(st + k * kLd + xo);
        const float4 x23 =
            *reinterpret_cast<const float4*>(st + k * kLd + xo + 2);
        const float4 y01 = *reinterpret_cast<const float4*>(st + k * kLd + yo);
        const float ar[4] = {x01.x, x01.z, x23.x, x23.z};
        const float ai[4] = {x01.y, x01.w, x23.y, x23.w};
        const float yr[2] = {y01.x, y01.z};
        const float yi[2] = {y01.y, y01.w};
        float br[4], bi[4], dr[2], di[2];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          br[a] = __fmul_rn(on, ar[a]);
          bi[a] = __fmul_rn(on, ai[a]);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          dr[c] = __fmul_rn(on, yr[c]);
          di[c] = __fmul_rn(on, yi[c]);
        }
        // conj(x) y: G0 (a, a), G1 (a, b), G2 (b, b)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            cr[0][a][c] = fmaf(ar[a], yr[c], cr[0][a][c]);
            cr[0][a][c] = fmaf(ai[a], yi[c], cr[0][a][c]);
            ci[0][a][c] = fmaf(ar[a], yi[c], ci[0][a][c]);
            ci[0][a][c] = fmaf(-ai[a], yr[c], ci[0][a][c]);
            cr[1][a][c] = fmaf(ar[a], dr[c], cr[1][a][c]);
            cr[1][a][c] = fmaf(ai[a], di[c], cr[1][a][c]);
            ci[1][a][c] = fmaf(ar[a], di[c], ci[1][a][c]);
            ci[1][a][c] = fmaf(-ai[a], dr[c], ci[1][a][c]);
            cr[2][a][c] = fmaf(br[a], dr[c], cr[2][a][c]);
            cr[2][a][c] = fmaf(bi[a], di[c], cr[2][a][c]);
            ci[2][a][c] = fmaf(br[a], di[c], ci[2][a][c]);
            ci[2][a][c] = fmaf(-bi[a], dr[c], ci[2][a][c]);
          }
      }
    }
    clk.mark(2);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  if (work) {
    float2* Rb = R + (size_t)b * P.M * P.M;
    const float* db = dinv + (size_t)b * P.M;
    const uint8_t* mb = mask + (size_t)b * P.K2;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float re[3] = {cr[0][a][c], cr[1][a][c], cr[2][a][c]};
        const float im[3] = {ci[0][a][c], ci[1][a][c], ci[2][a][c]};
        gram_entry(Rb, db, mb, P, r0 + tr * 4 + a, c0 + tc * 2 + c, re, im);
      }
  }
  clk.mark(3);
  clk.flush();
}

// d[0..3] += a * b on the FP64 tensor cores: one m16n8k4 product per warp.
// Fragments (PTX ISA, m16n8k4 .f64): A[g][q] and A[g + 8][q], B[q][g],
// C[g][2q + e] and C[g + 8][2q + e], with g = lane / 4, q = lane % 4.  Not
// volatile: the operands carry every dependence.
__device__ __forceinline__ void mma_f64(double (&d)[4], double a0, double a1,
                                        double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// fit_gram, complex128: a warp's 16 x 16 piece as one m16 row block and two
// n8 column blocks of each Gram, four real products a complex one (24
// mma.sync a depth step of 4); B = o A formed on the fragments.
__global__ void __launch_bounds__(kGramThreads, 2)
    gram_c128(const double2* __restrict__ A, const double* __restrict__ dinv,
              const uint8_t* __restrict__ mask, double2* __restrict__ R,
              int N, int Kc) {
  double2* ring = reinterpret_cast<double2*>(g_smem);
  const Plan P(Kc);
  const int b = blockIdx.x / P.ntiles, t = blockIdx.x - b * P.ntiles;
  int I, J;
  P.tile(t, I, J);
  const double2* Ab = A + (size_t)b * N * P.K2;
  const int W = (N - 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pr = warp / (kTileC / kPiece), pc = warp % (kTileC / kPiece);
  const int r0 = I * kTileR + pr * kPiece, c0 = J * kTileC + pc * kPiece;
  const bool work = P.live(r0, c0);
  const int g = lane >> 2, q = lane & 3;
  const int xo = pr * kPiece + g, yo = kTileR + pc * kPiece + g;
  Clk clk(1);
  double cr[3][2][4], ci[3][2][4];
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e) cr[m][v][e] = ci[m][v][e] = 0.0;
  const int nsteps = (N + kDepth64 - 1) / kDepth64;
  constexpr int kStage = kDepth64 * kLd;
  const Copies<kDepth64> cp(P, I, J);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) cp.issue(ring + s * kStage, Ab, P.K2, s * kDepth64, N);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  clk.mark(0);
  for (int step = 0; step < nsteps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    const int nx = step + kStages - 1;
    if (nx < nsteps)
      cp.issue(ring + (nx % kStages) * kStage, Ab, P.K2, nx * kDepth64, N);
    asm volatile("cp.async.commit_group;\n" ::);
    clk.mark(1);
    if (work) {
      const double2* st = ring + (step % kStages) * kStage;
#pragma unroll
      for (int k0 = 0; k0 < kDepth64; k0 += 4) {
        const int k = k0 + q;
        const double on = (double)(step * kDepth64 + k - W);
        const double2 x0 = st[k * kLd + xo], x1 = st[k * kLd + xo + 8];
        const double2 y0 = st[k * kLd + yo], y1 = st[k * kLd + yo + 8];
        // a and b = o a of the row block (x) and both column blocks (y)
        const double xar[2] = {x0.x, x1.x}, xai[2] = {x0.y, x1.y};
        const double xbr[2] = {__dmul_rn(on, x0.x), __dmul_rn(on, x1.x)};
        const double xbi[2] = {__dmul_rn(on, x0.y), __dmul_rn(on, x1.y)};
        const double yar[2] = {y0.x, y1.x}, yai[2] = {y0.y, y1.y};
        const double ybr[2] = {__dmul_rn(on, y0.x), __dmul_rn(on, y1.x)};
        const double ybi[2] = {__dmul_rn(on, y0.y), __dmul_rn(on, y1.y)};
        // conj(x) y as four real products, swept so that consecutive
        // products go to different accumulators
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          mma_f64(cr[0][v], xar[0], xar[1], yar[v]);
          mma_f64(cr[1][v], xar[0], xar[1], ybr[v]);
          mma_f64(cr[2][v], xbr[0], xbr[1], ybr[v]);
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          mma_f64(ci[0][v], xar[0], xar[1], yai[v]);
          mma_f64(ci[1][v], xar[0], xar[1], ybi[v]);
          mma_f64(ci[2][v], xbr[0], xbr[1], ybi[v]);
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          mma_f64(cr[0][v], xai[0], xai[1], yai[v]);
          mma_f64(cr[1][v], xai[0], xai[1], ybi[v]);
          mma_f64(cr[2][v], xbi[0], xbi[1], ybi[v]);
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          mma_f64(ci[0][v], -xai[0], -xai[1], yar[v]);
          mma_f64(ci[1][v], -xai[0], -xai[1], ybr[v]);
          mma_f64(ci[2][v], -xbi[0], -xbi[1], ybr[v]);
        }
      }
    }
    clk.mark(2);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  if (work) {
    double2* Rb = R + (size_t)b * P.M * P.M;
    const double* db = dinv + (size_t)b * P.M;
    const uint8_t* mb = mask + (size_t)b * P.K2;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = 2 * h + e;
          const double re[3] = {cr[0][v][f], cr[1][v][f], cr[2][v][f]};
          const double im[3] = {ci[0][v][f], ci[1][v][f], ci[2][v][f]};
          gram_entry(Rb, db, mb, P, r0 + g + 8 * h, c0 + 8 * v + 2 * q + e,
                     re, im);
        }
  }
  clk.mark(3);
  clk.flush();
}

// Shared memory of one fit_basis block (bytes): 3 (eaQHM) or 4 (iQHM) real
// vectors of N, the staged rows and the DC partial sums.
template <typename T>
int basis_smem(int N, bool iqhm) {
  const int reals = (iqhm ? 4 : 3) * N;
  return (reals + (reals & 1)) * (int)sizeof(T) +
         2 * 2 * 32 * kBasisWarps * 2 * (int)sizeof(T) +
         5 * kBasisWarps * (int)sizeof(T);
}

int set_smem(const void* fn) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
}

template <typename T, bool EA>
int launch_basis(BasisArgs<T> p, int B, void* stream) {
  const int smem = basis_smem<T>(p.N, !EA);
  if (B < 1 || p.N < 1 || p.Kc < 1 || p.L < 1 || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  p.groups = (p.Kc + kBasisWarps - 1) / kBasisWarps;
  basis_kernel<T, EA><<<B * p.groups, kBasisThreads, smem,
                        (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
BasisArgs<T> basis_args(const void* s, const void* utt, const void* ctr,
                        const void* wl, void* A, void* R, void* rhs,
                        void* dinv, void* mask, int N, int Kc, long long L,
                        double c) {
  using C = typename Cplx<T>::type;
  BasisArgs<T> p = {};
  p.s = (const T*)s;
  p.utt = (const long long*)utt;
  p.ctr = (const long long*)ctr;
  p.wl = (const T*)wl;
  p.A = (C*)A;
  p.R = (C*)R;
  p.rhs = (C*)rhs;
  p.dinv = (T*)dinv;
  p.mask = (uint8_t*)mask;
  p.N = N;
  p.Kc = Kc;
  p.L = L;
  p.c = (T)c;
  return p;
}

template <typename T>
int launch_eaqhm(const void* s, const void* fm, const void* am,
                 const void* dead, const void* utt, const void* ctr,
                 const void* dd, const void* wl, const void* cmask, void* A,
                 void* R, void* rhs, void* dinv, void* mask, int B, int N,
                 int Kc, long long L, long long su, long long sl, double fs,
                 double c, double eps, void* stream) {
  BasisArgs<T> p = basis_args<T>(s, utt, ctr, wl, A, R, rhs, dinv, mask, N,
                                 Kc, L, c);
  p.fm = (const T*)fm;
  p.am = (const T*)am;
  p.dead = (const uint8_t*)dead;
  p.dd = (const uint8_t*)dd;
  p.cmask = (const uint8_t*)cmask;
  p.su = su;
  p.sl = sl;
  p.fs = (T)fs;
  p.eps = (T)eps;
  return launch_basis<T, true>(p, B, stream);
}

template <typename T>
int launch_iqhm(const void* s, const void* utt, const void* ctr,
                const void* wl, const void* f0, const void* K, void* A,
                void* R, void* rhs, void* dinv, void* mask, int B, int N,
                int Kc, long long L, double c, void* stream) {
  BasisArgs<T> p = basis_args<T>(s, utt, ctr, wl, A, R, rhs, dinv, mask, N,
                                 Kc, L, c);
  p.f0 = (const T*)f0;
  p.K = (const long long*)K;
  return launch_basis<T, false>(p, B, stream);
}

}  // namespace

extern "C" {

// Set the dynamic shared-memory attribute of every kernel of the library
// on the current device.  Returns the cudaError_t (0 on success).
int fit_prepare() {
  int e;
  if ((e = set_smem((const void*)basis_kernel<float, true>))) return e;
  if ((e = set_smem((const void*)basis_kernel<double, true>))) return e;
  if ((e = set_smem((const void*)basis_kernel<float, false>))) return e;
  if ((e = set_smem((const void*)basis_kernel<double, false>))) return e;
  if ((e = set_smem((const void*)gram_c64))) return e;
  return set_smem((const void*)gram_c128);
}

// fit_basis, eaQHM mode (types float32 / float64; see BasisArgs): s [U, L];
// fm, am [U, L, >= Kc] at strides (su, sl, 1); dead [U, L] bytes; utt, ctr
// [B] int64; dd [B] bytes; wl [B]; cmask [B, Kc] bytes -> A [B, N, Kc2],
// R's entries against DC [B, M, M], rhs [B, M], dinv [B, M], mask [B, Kc2].
// c = 2pi/fs.  Returns the cudaError_t of the launch.
int fit_basis_eaqhm_f32(const void* s, const void* fm, const void* am,
                        const void* dead, const void* utt, const void* ctr,
                        const void* dd, const void* wl, const void* cmask,
                        void* A, void* R, void* rhs, void* dinv, void* mask,
                        int B, int N, int Kc, long long L, long long su,
                        long long sl, double fs, double c, double eps,
                        void* stream) {
  return launch_eaqhm<float>(s, fm, am, dead, utt, ctr, dd, wl, cmask, A, R,
                             rhs, dinv, mask, B, N, Kc, L, su, sl, fs, c, eps,
                             stream);
}

int fit_basis_eaqhm_f64(const void* s, const void* fm, const void* am,
                        const void* dead, const void* utt, const void* ctr,
                        const void* dd, const void* wl, const void* cmask,
                        void* A, void* R, void* rhs, void* dinv, void* mask,
                        int B, int N, int Kc, long long L, long long su,
                        long long sl, double fs, double c, double eps,
                        void* stream) {
  return launch_eaqhm<double>(s, fm, am, dead, utt, ctr, dd, wl, cmask, A, R,
                              rhs, dinv, mask, B, N, Kc, L, su, sl, fs, c,
                              eps, stream);
}

// fit_basis, iQHM mode: s [U, L]; utt, ctr [B] int64; wl, f0 [B]; K [B]
// int64 harmonic counts.  Outputs as eaQHM mode.
int fit_basis_iqhm_f32(const void* s, const void* utt, const void* ctr,
                       const void* wl, const void* f0, const void* K, void* A,
                       void* R, void* rhs, void* dinv, void* mask, int B,
                       int N, int Kc, long long L, double c, void* stream) {
  return launch_iqhm<float>(s, utt, ctr, wl, f0, K, A, R, rhs, dinv, mask, B,
                            N, Kc, L, c, stream);
}

int fit_basis_iqhm_f64(const void* s, const void* utt, const void* ctr,
                       const void* wl, const void* f0, const void* K, void* A,
                       void* R, void* rhs, void* dinv, void* mask, int B,
                       int N, int Kc, long long L, double c, void* stream) {
  return launch_iqhm<double>(s, utt, ctr, wl, f0, K, A, R, rhs, dinv, mask,
                             B, N, Kc, L, c, stream);
}

// fit_gram: A [B, N, 2Kc+1] complex64 / complex128, dinv [B, M] real, mask
// [B, 2Kc+1] bytes -> every entry of R [B, M, M] but those against the DC
// slots (fit_basis writes them).
int fit_gram_c64(const void* A, const void* dinv, const void* mask, void* R,
                 int B, int N, int Kc, void* stream) {
  if (B < 1 || N < 1 || Kc < 1) return (int)cudaErrorInvalidValue;
  gram_c64<<<B * Plan(Kc).ntiles, kGramThreads, kGramSmem,
             (cudaStream_t)stream>>>((const float2*)A, (const float*)dinv,
                                     (const uint8_t*)mask, (float2*)R, N, Kc);
  return (int)cudaGetLastError();
}

int fit_gram_c128(const void* A, const void* dinv, const void* mask, void* R,
                  int B, int N, int Kc, void* stream) {
  if (B < 1 || N < 1 || Kc < 1) return (int)cudaErrorInvalidValue;
  gram_c128<<<B * Plan(Kc).ntiles, kGramThreads, kGramSmem,
              (cudaStream_t)stream>>>((const double2*)A, (const double*)dinv,
                                      (const uint8_t*)mask, (double2*)R, N,
                                      Kc);
  return (int)cudaGetLastError();
}

// fit_gram's plan at Kc: out[0] tiles (blocks) per frame, out[1] live
// pieces per frame, out[2] piece slots of the launched tiles (warps).
// Returns 0.
int fit_gram_plan(int Kc, long long* out) {
  const Plan P(Kc);
  out[0] = P.ntiles;
  out[1] = P.live_pieces();
  out[2] = (long long)P.ntiles * (kTileR / kPiece) * (kTileC / kPiece);
  return 0;
}

// Blocks of one kernel that a SM holds at once (the CUDA runtime's
// occupancy for the launch a fit of N rows makes): kernel 0 fit_gram
// complex64, 1 complex128, 2 / 3 fit_basis eaQHM float32 / float64, 4 / 5
// fit_basis iQHM float32 / float64.  -1 for another kernel.
int fit_occupancy(int kernel, int N) {
  int n = -1;
  cudaError_t e = cudaErrorInvalidValue;
  switch (kernel) {
    case 0:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, gram_c64, kGramThreads, kGramSmem);
      break;
    case 1:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, gram_c128, kGramThreads, kGramSmem);
      break;
    case 2:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, basis_kernel<float, true>, kBasisThreads,
          basis_smem<float>(N, false));
      break;
    case 3:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, basis_kernel<double, true>, kBasisThreads,
          basis_smem<double>(N, false));
      break;
    case 4:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, basis_kernel<float, false>, kBasisThreads,
          basis_smem<float>(N, true));
      break;
    case 5:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, basis_kernel<double, false>, kBasisThreads,
          basis_smem<double>(N, true));
      break;
  }
  return e == cudaSuccess ? n : -1;
}

// Profiling build: copies the phase clocks (FIT_PHASE_CLOCKS) to
// out[4][8] (kernel, slot) and zeroes them; -1 in the port's own build.
int fit_phase_clocks(unsigned long long* out) {
#ifdef FIT_PHASE_CLOCKS
  cudaError_t e = cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[kClkKinds][kClkSlots] = {};
  return (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(g_clk));
#else
  (void)out;
  return -1;
#endif
}

}  // extern "C"
