// The tracks, synthesis and SRER stage of one adaptation, for Hopper.
//
// Replaces eaqhm_tpu/models/tracks.py `interpolate_tracks_anchors`
// (:143-269) with `_segmented_notaknot_M` (:43-126), eaqhm_tpu/ops/interp.py
// `cubic4_eval` (:124-158) and `notaknot_interp_uniform` (:161-208, the DC
// track), and eaqhm_tpu/models/engine.py `_combine_buckets` (:424),
// `_scatter_and_interp` (:549) and `_masked_srer` (:451), which XLA fuses on
// the TPU (as eaqhm_tpu/parallel/batch_engine.py `_interp_and_synth` :321
// and the masked SRER of its step).  No Pallas kernel stood for them.
//
// Columns are independent: K harmonics of each of G groups (utterances),
// side by side, plus one DC track per group.  Anchor i of a column sits at
// sample i*step (n anchors, n_pairs = n - 1 segments, Lp = n_pairs*step + 1
// rows; rows Lp..L-1 are zero for the harmonics, the DC extrapolates).  A
// harmonic anchor is accepted where its am (after the optional acceptance
// mask) is nonzero; runs are maximal sequences of accepted anchors.
//
// The anchors come in one of two forms (Src): a dense grid [G, n, K] (any
// strides with the last 1), or, for one group, the per-tier frame results
// of the sequential engine read through a frame map (row * 16 + tier, -1
// for a frame in no tier), each tier's am, fm, ph [Nb, Kb] with its own row
// stride, its acceptance and its DC; columns at Kb and above read as zero.
// So no grid is scattered before the kernels.
//
// Launches, in order on one stream (all bytes-bound on this card):
// - track_spline, two kernels: the second derivatives M of the not-a-knot
//   spline of every run of every column (the DC column is one run over all
//   anchors), as JAX's segmented Thomas solve defines them (the second and
//   second-last anchors of a run known, M = d/(6h); the elimination
//   multipliers cp from the table 1/(4 - cp) by position in the run, clamped
//   at 48; the run's ends extrapolated linearly).  The grid is (32 columns,
//   R anchors) tiles, a warp each, so a warp reads one row of 32 adjacent
//   columns at a time.  spline_tiles: per tile the position at its first row
//   (read back over at most 48 anchors' flags, stopping at the first anchor
//   outside a run's unknown interior), the forward walk with the entering
//   value 0 (dp into M, the codes beside it), the tile's forward map dp ->
//   A_f dp + B_f and its backward map M(first) = A_b M(next tile) + B0 + B1
//   dp_in.  spline_apply: per tile the entering dp and the M after the tile
//   as sums over the neighbouring tiles' maps in tile order (nearest first,
//   stopping where the product of the maps falls below 2^-100, which the
//   decay of the multipliers, ~0.27 an anchor, reaches within ~55 anchors;
//   the terms left weigh less than 1e-30 of their values), the entering
//   dp folded into the tile's first rows, the backward walk, and the runs'
//   ends: a start anchor is written by the tile of the anchor after it, an
//   end anchor by the tile two anchors before it, so every value an end
//   reads is the writing tile's own or the M after it.  No block waits for
//   another and no counter is kept: the result is the same at every launch.
//   The maps compose in another order than JAX's log-depth scan, so M
//   agrees to rounding.  Bound: the anchors read once and M written once.
// - track_synth: a block holds S segments of one group side by side (a
//   thread a (segment, harmonic column); S = 256 / K where K <= 128, whole
//   warps, so a block has at least 4), J such slices in turn.  The masked
//   values and accepted flags of the block's anchors and their neighbours
//   are read once into shared memory.  Per (segment, column): the linear
//   am, the cubic fm (the spline, or for a run of 2-3 anchors the 4-point
//   cubic through the synthetic anchors at slots 0, 1 and the run, which a
//   warp evaluates for its lanes' short runs together, a lane a row),
//   evaluated once a row from a per-block table of Bc = e/h, Ac = 1 - Bc,
//   Ac^3 - Ac, Bc^3 - Bc (JAX's roundings) and kept in shared memory
//   between the phase-end pass and the row pass;
//   the in-segment phase sum, Mw = rint(...) (round half to even, as
//   jnp.round), the sine-bump correction, the corrected phase of a run-end
//   anchor, fm_current from the wrapped phase differences (torch.remainder's
//   floor mod, and its tie rule), and am cos(ph), staged in shared memory.
//   Each row's sum over K is then taken in a fixed order (pieces of 16
//   columns in column order, the pieces in order; no atomics, so two runs
//   agree bit for bit).  A segment writes the rows after its left anchor up
//   to its right anchor (segment 0 also row 0), so the fm_current of an
//   anchor row reads the phase of the row before it in the same thread.  It
//   writes dense am and fm_current [G, L, K] (what the next adaptation's
//   fit reads), the anchor rows of am, fm and the corrected ph ([3, G, n,
//   K], what the packaging reads), optionally dense fm and ph (the public
//   functions), and per group s = [a0 +] 2 sum_k am cos(ph) [G, L] with the
//   DC cubic (extrapolated past the last anchor) added or written apart (the
//   batch engine all-reduces the harmonic sum over its model shards).
//   Steps above 15 or K above 256 take the rows in chunks and evaluate fm
//   twice (a second instantiation).  The wrapped difference's fmod is taken
//   exactly with an fma from the quotient it implies.  Bound: the anchors
//   read once and the dense outputs written once, against one cos per
//   (row, column); the float64 build is limited by its FP64 work (cos).
// - track_srer: the masked SRER over the first n_valid samples,
//   20 log10(std_det / std(det - s)), mean first and deviation second as
//   JAX writes it (std_det given, or the masked std of det), in two
//   launches over (chunk, group) blocks of 256 threads (a chunk of
//   L / nch samples, nch from the wrapper): the first writes each chunk's
//   sums, the second each chunk's sums of squared deviations from the mean
//   of the first's, and the block that finishes a group last (a counter the
//   first launch sets to 0) sums the chunks in chunk order.  Every sum is
//   taken in an order fixed by the shapes alone, so the SRER is the same bit
//   for bit from run to run.  Bound: det and s read (twice: the second pass
//   mostly from L2); at the main paths' lengths a launch's latency sets the
//   time.
//
// Every product and sum rounds on its own as the torch ops (and JAX) round
// them: the library is built with -fmad=false; cos, fmod, rint, log10 and
// sqrt are the accurate ones.  Sums over K and over samples run in another
// order than torch.sum, so s and the SRER agree to rounding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tracks_plan.h"

namespace {

using tracks_plan::align16;
using tracks_plan::kPiece;
using tracks_plan::kSplineWarps;
using tracks_plan::kSrerThreads;
using tracks_plan::kSynthMaxSmem;
using tracks_plan::kSynthRows;
using tracks_plan::kSynthThreads;
using tracks_plan::synth_threads;

constexpr int kCpLen = 48;          // the cp table's last entry
constexpr uint8_t kKnown = 60;      // code of an anchor with M = d / (6h)
constexpr uint8_t kStart = 61;      // a run's first anchor
constexpr uint8_t kEnd = 62;        // a run's last anchor
constexpr int kChunk = 8;           // rows a walk loads ahead
constexpr int kAgg = 5;             // A_f, B_f, A_b, B0, B1 of a tile
constexpr int kMaxTiers = 12;

// Profiling build (-DTRACKS_PHASE_CLOCKS, tools/bench_tracks_phases.py
// --clocks): clock64 cycles summed per (kernel, phase) over the blocks of a
// launch, as thread 0 of each block sees them; slot kClkSlots - 1 counts the
// blocks.  The port's own build has none of it.
constexpr int kClkKinds = 6;  // spline_tiles, spline_apply, synth; f32, f64
constexpr int kClkSlots = 8;
#ifdef TRACKS_PHASE_CLOCKS
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
    if (threadIdx.x != 0 || threadIdx.y != 0) return;
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

template <typename T>
__device__ __forceinline__ int clk_kind(int base) {
  return 2 * base + (sizeof(T) == 8 ? 1 : 0);
}

__device__ __forceinline__ bool unknown_code(uint8_t c) {
  return c >= 1 && c <= kCpLen;
}

__device__ __forceinline__ bool interior_code(uint8_t c) {
  return c != 0 && c <= kKnown;     // 1..48 unknown (its position), known
}

// ------------------------------------------------------------------ sources

template <typename T>
struct Tier {
  const T* am; const T* fm; const T* ph;   // [Nb, Kb] row stride sn
  const uint8_t* acc;                      // [Nb, Kb] row stride asn
  const T* a0;                             // [Nb] stride a0s
  long long sn, asn, a0s;
  int kb;
};

// Where the anchors are read: a dense grid (fmap null) or tiers.
template <typename T>
struct Src {
  const int* fmap;                         // [n]: row * 16 + tier, or -1
  int ntiers;
  const T* am; const T* fm; const T* ph;   // dense [G, n, K] (sg, sn, 1)
  const uint8_t* acc;                      // dense [G, n, K] or null
  const T* a0;                             // dense [G, n]
  const uint8_t* voiced;                   // [G, n] or null (both forms)
  long long sg, sn;
  int G, K, n;
  Tier<T> tier[kMaxTiers];
};

// the host's description (one long long each): fmap, ntiers, am, fm, ph,
// acc, a0, voiced, sg, sn, then per tier am, fm, ph, acc, a0, sn, asn, a0s,
// kb
constexpr int kSrcHead = 10;
constexpr int kSrcTier = 9;

template <typename T>
bool read_src(const long long* d, int G, int K, int n, Src<T>& s) {
  s.fmap = (const int*)d[0];
  s.ntiers = (int)d[1];
  s.am = (const T*)d[2]; s.fm = (const T*)d[3]; s.ph = (const T*)d[4];
  s.acc = (const uint8_t*)d[5]; s.a0 = (const T*)d[6];
  s.voiced = (const uint8_t*)d[7];
  s.sg = d[8]; s.sn = d[9];
  s.G = G; s.K = K; s.n = n;
  if (s.ntiers < 0 || s.ntiers > kMaxTiers) return false;
  if (s.fmap != nullptr && G != 1) return false;
  for (int t = 0; t < kMaxTiers; ++t) {
    Tier<T>& r = s.tier[t];
    if (t < s.ntiers) {
      const long long* e = d + kSrcHead + kSrcTier * t;
      r.am = (const T*)e[0]; r.fm = (const T*)e[1]; r.ph = (const T*)e[2];
      r.acc = (const uint8_t*)e[3]; r.a0 = (const T*)e[4];
      r.sn = e[5]; r.asn = e[6]; r.a0s = e[7]; r.kb = (int)e[8];
    } else {
      r = Tier<T>{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0};
    }
  }
  return true;
}

// The tier table in shared memory (a kernel parameter indexed by a
// runtime tier would be copied to local memory).
template <typename T>
__device__ __forceinline__ void load_tiers(const Src<T>& a, Tier<T>* sm,
                                           int tid) {
#pragma unroll
  for (int t = 0; t < kMaxTiers; ++t)
    if (tid == t) sm[t] = a.tier[t];
}

// One anchor row of a group: the pointers of its harmonic values and how
// many columns it has (0: no values).
template <typename T>
struct Row {
  const T* am; const T* fm; const T* ph; const uint8_t* acc;
  int kb;
};

template <typename T>
__device__ __forceinline__ Row<T> row_at(const Src<T>& a, const Tier<T>* tiers,
                                         int g, int s) {
  Row<T> r{nullptr, nullptr, nullptr, nullptr, 0};
  if (s < 0 || s >= a.n) return r;
  if (a.fmap == nullptr) {
    const long long o = g * a.sg + (long long)s * a.sn;
    r.am = a.am + o; r.fm = a.fm + o; r.ph = a.ph + o;
    r.acc = a.acc ? a.acc + ((long long)g * a.n + s) * a.K : nullptr;
    r.kb = a.K;
  } else {
    const int code = a.fmap[s];
    if (code >= 0) {
      const Tier<T>& t = tiers[code & 15];
      const long long row = code >> 4;
      r.am = t.am + row * t.sn; r.fm = t.fm + row * t.sn;
      r.ph = t.ph + row * t.sn; r.acc = t.acc + row * t.asn;
      r.kb = t.kb;
    }
  }
  return r;
}

// The DC anchor s of a group (0 outside the grid, off the voiced mask and
// at a frame in no tier).
template <typename T>
__device__ __forceinline__ T dc_at(const Src<T>& a, const Tier<T>* tiers,
                                   int g, int s) {
  if (s < 0 || s >= a.n) return T(0);
  if (a.voiced && !a.voiced[(long long)g * a.n + s]) return T(0);
  if (a.fmap == nullptr) return a.a0[(long long)g * a.n + s];
  const int code = a.fmap[s];
  if (code < 0) return T(0);
  const Tier<T>& t = tiers[code & 15];
  return t.a0[(long long)(code >> 4) * t.a0s];
}

// Column k of a row, masked by the fit's acceptance: the value loads do
// not wait for the acceptance byte.
template <typename T>
struct Cell {
  bool keep;
  T am, fm, ph;
};

template <typename T>
__device__ __forceinline__ Cell<T> cell(const Row<T>& r, int k, bool ph) {
  const bool in = k < r.kb;
  const T am = in ? r.am[k] : T(0);
  const T fm = in ? r.fm[k] : T(0);
  const T pv = in && ph ? r.ph[k] : T(0);
  const bool kp = in && (r.acc == nullptr || r.acc[k]);
  return Cell<T>{kp, kp ? am : T(0), kp ? fm : T(0), kp ? pv : T(0)};
}

// ------------------------------------------------------------------ spline

// One column of the spline's input (the source is passed to each read: a
// kernel parameter whose address is kept would be copied to local memory).
template <typename T>
struct Column {
  const Tier<T>* tiers;
  int g, k;
  bool dc;              // the DC track: every anchor in one run

  // row s's accepted flag and value y
  __device__ __forceinline__ void load(const Src<T>& src, int s, bool& a,
                                       T& y) const {
    if (dc) {
      a = s >= 0 && s < src.n;
      y = dc_at(src, tiers, g, s);
      return;
    }
    const Cell<T> c = cell(row_at(src, tiers, g, s), k, false);
    a = c.keep && c.am != T(0);
    y = c.fm;
  }
  __device__ __forceinline__ bool flag(const Src<T>& src, int s) const {
    if (dc) return s >= 0 && s < src.n;
    const Cell<T> c = cell(row_at(src, tiers, g, s), k, false);
    return c.keep && c.am != T(0);
  }
};

// The row's code: 0 outside the runs' interiors and ends, 1..48 an unknown
// interior anchor (its position after the run's second anchor, clamped),
// kKnown, kStart, kEnd.  w[j] is the accepted flag of row s - 2 + j.
__device__ __forceinline__ uint8_t classify(const bool* w, int s,
                                            int& last_nonun) {
  uint8_t code = 0;
  if (w[2] && w[1] && w[3]) {
    if (w[0] && w[4]) {
      int pos = s - last_nonun;
      code = (uint8_t)(pos < kCpLen ? pos : kCpLen);
    } else {
      code = kKnown;
    }
  } else if (w[2] && !w[1] && w[3]) {
    code = kStart;
  } else if (w[2] && w[1] && !w[3]) {
    code = kEnd;
  }
  if (!unknown_code(code)) last_nonun = s;
  return code;
}

// The last row before s0 that is not an unknown interior anchor, read back
// over at most kCpLen rows (further back the position is clamped anyway),
// kChunk rows' flags loaded at a time.
template <typename T>
__device__ __forceinline__ int look_back(const Src<T>& src,
                                         const Column<T>& col, int s0) {
  bool w[5];                            // flags of rows r - 2 .. r + 2
#pragma unroll
  for (int j = 0; j < 5; ++j) w[j] = col.flag(src, s0 - 3 + j);
  const int stop = s0 - kCpLen > 0 ? s0 - kCpLen : 0;
  for (int r0 = s0 - 1; r0 >= stop; r0 -= kChunk) {
    bool fb[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) fb[j] = col.flag(src, r0 - j - 3);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int r = r0 - j;
      if (r < stop) break;
      if (!(w[0] && w[1] && w[2] && w[3] && w[4])) return r;
#pragma unroll
      for (int i = 4; i > 0; --i) w[i] = w[i - 1];
      w[0] = fb[j];
    }
  }
  return s0 - kCpLen - 1;
}

// Walks rows [sa, sb) in order with the window of rows s-2..s+2 loaded, the
// next kChunk rows read while a chunk is walked; f(s, code, y_prev, y,
// y_next).
template <typename T, typename F>
__device__ __forceinline__ void walk(const Src<T>& src,
                                     const Column<T>& col, int sa, int sb,
                                     int& last_nonun, F f) {
  bool w[5], wb[kChunk];
  T y[5], yb[kChunk];
#pragma unroll
  for (int j = 0; j < 5; ++j) col.load(src, sa - 2 + j, w[j], y[j]);
#pragma unroll
  for (int j = 0; j < kChunk; ++j) col.load(src, sa + 3 + j, wb[j], yb[j]);
  for (int s0 = sa; s0 < sb; s0 += kChunk) {
    bool wn[kChunk];
    T yn[kChunk];
    if (s0 + kChunk < sb) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        col.load(src, s0 + kChunk + 3 + j, wn[j], yn[j]);
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int s = s0 + j;
      if (s < sb) {
        const uint8_t code = classify(w, s, last_nonun);
        f(s, code, y[1], y[2], y[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) { w[i] = w[i + 1]; y[i] = y[i + 1]; }
      w[4] = wb[j];
      y[4] = yb[j];
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) { wb[j] = wn[j]; yb[j] = yn[j]; }
  }
}

template <typename T>
struct SplineArgs {
  Src<T> src;
  const T* ctab;                                  // [kCpLen + 1]
  T* M;                                           // [n, G*K + G]
  uint8_t* code;                                  // [n, G*K + G]
  T* agg;                                         // [kAgg, tiles, G*K + G]
  int R, tiles;
  double h;
};

// the forward coefficients by position in the run, as the torch ops round
// them: g = 4 - cp_prev, a = -1 / g, and h g for b = d / (h g)
template <typename T>
__device__ __forceinline__ void spline_tables(const T* ctab, double h,
                                              T* tabA, T* tabHG, T* tabCP,
                                              int tid, int nthreads) {
  for (int i = tid; i <= kCpLen; i += nthreads) {
    const T cp_prev = ctab[i > 0 ? i - 1 : 0];
    const T g = T(4) - cp_prev;
    tabA[i] = T(-1) / g;
    if (tabHG) tabHG[i] = T(h) * g;
    tabCP[i] = ctab[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kSplineWarps)
spline_tiles(SplineArgs<T> a) {
  __shared__ T tabA[kCpLen + 1], tabHG[kCpLen + 1], tabCP[kCpLen + 1];
  __shared__ Tier<T> tiers[kMaxTiers];
  Clk clk(clk_kind<T>(0));
  const int tid = threadIdx.y * 32 + threadIdx.x;
  spline_tables(a.ctab, a.h, tabA, tabHG, tabCP, tid, 32 * kSplineWarps);
  load_tiers(a.src, tiers, tid);
  __syncthreads();
  const int G = a.src.G, K = a.src.K, n = a.src.n;
  const int Ctot = G * K + G;
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int t = blockIdx.y * kSplineWarps + threadIdx.y;
  if (c >= Ctot || t >= a.tiles) return;
  Column<T> col;
  col.tiers = tiers;
  col.dc = c >= G * K;
  col.g = col.dc ? c - G * K : c / K;
  col.k = col.dc ? 0 : c % K;
  const int s0 = t * a.R;
  const int s1 = min(n, s0 + a.R);
  const T six_h = T(6.0 / a.h), known_div = T(6.0 * a.h);

  // the position at s0 matters only where its anchor and two each side are
  // accepted (an unknown interior anchor); then it is read back
  bool first_un = s0 > 0;
#pragma unroll
  for (int j = 0; j < 5; ++j)
    first_un = first_un && col.flag(a.src, s0 - 2 + j);
  int last = first_un ? look_back(a.src, col, s0) : s0 - 1;
  clk.mark(0);
  // forward rows with the entering value 0: dp_local into M, the codes;
  // alpha the weight of the entering value in dp (0 past the first anchor
  // outside an unknown interior); the backward map of the tile, M(s0) =
  // A M(s + 1) + B0 + B1 dp_in after row s
  T dp = T(0), alpha = T(1), A = T(1), B0 = T(0), B1 = T(0);
  T* Mc = a.M + c;
  uint8_t* Cc = a.code + c;
  walk(a.src, col, s0, s1, last,
       [&](int s, uint8_t code, T yp, T y, T yn) {
    // one division a row, no branch: rows overlap in the unrolled walk
    const bool un = unknown_code(code), in = interior_code(code);
    const int ci = un ? code : 0;
    const T d = six_h * ((yn - T(2) * y) + yp);
    const T b = d / (code == kKnown ? known_div : tabHG[ci]);
    const T am_ = un ? tabA[ci] : T(0);
    const T b_ = in ? b : T(0);
    dp = un ? am_ * dp + b_ : b_;
    alpha = un ? am_ * alpha : T(0);
    Mc[(long long)s * Ctot] = dp;
    Cc[(long long)s * Ctot] = code;
    B0 = A * (in ? dp : T(0)) + B0;
    B1 = A * (in ? alpha : T(0)) + B1;
    A = A * (un ? -tabCP[ci] : T(0));
  });
  const long long plane = (long long)a.tiles * Ctot;
  T* ag = a.agg + (long long)t * Ctot + c;
  ag[0] = alpha;
  ag[plane] = dp;
  ag[2 * plane] = A;
  ag[3 * plane] = B0;
  ag[4 * plane] = B1;
  clk.mark(1);
  clk.flush();
}

// Where a sum over the neighbouring tiles' maps stops: the product of the
// maps below 2^-100 (exactly 0 a few tiles later), so the terms left weigh
// less than 1e-30 of their values.
constexpr double kFoldTiny = 7.888609052210118e-31;
constexpr int kFold = 4;                // tiles' maps loaded at a time

template <typename T>
__global__ void __launch_bounds__(32 * kSplineWarps)
spline_apply(SplineArgs<T> a) {
  __shared__ T tabA[kCpLen + 1], tabCP[kCpLen + 1];
  Clk clk(clk_kind<T>(1));
  const int tid = threadIdx.y * 32 + threadIdx.x;
  spline_tables(a.ctab, a.h, tabA, (T*)nullptr, tabCP, tid,
                32 * kSplineWarps);
  __syncthreads();
  const int G = a.src.G, K = a.src.K, n = a.src.n;
  const int Ctot = G * K + G;
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int t = blockIdx.y * kSplineWarps + threadIdx.y;
  if (c >= Ctot || t >= a.tiles) return;
  const int tiles = a.tiles;
  const long long plane = (long long)tiles * Ctot;
  const T* Af = a.agg + c;
  const T* Bf = Af + plane;
  const T* Ab = Af + 2 * plane;
  const T* B0 = Af + 3 * plane;
  const T* B1 = Af + 4 * plane;
  const T tiny = T(kFoldTiny);
  // dp at the row before tile u: the earlier tiles' forward maps, nearest
  // first
  auto dp_in_of = [&](int u) -> T {
    T sum = T(0), P = T(1);
    for (int w0 = u - 1; w0 >= 0; w0 -= kFold) {
      T af[kFold], bf[kFold];
#pragma unroll
      for (int j = 0; j < kFold; ++j) {
        const long long w = w0 - j;
        af[j] = w >= 0 ? Af[w * Ctot] : T(0);
        bf[j] = w >= 0 ? Bf[w * Ctot] : T(0);
      }
#pragma unroll
      for (int j = 0; j < kFold; ++j) {
        if (w0 - j < 0) return sum;
        sum = sum + P * bf[j];
        P = P * af[j];
        if (fabs(P) < tiny) return sum;
      }
    }
    return sum;
  };
  const T din = dp_in_of(t);
  // M at the row after the tile: the later tiles' backward maps
  T Min = T(0);
  {
    T P = T(1);
    bool go = true;
    for (int u0 = t + 1; go && u0 < tiles; u0 += kFold) {
      T ab[kFold], b0[kFold], b1[kFold];
#pragma unroll
      for (int j = 0; j < kFold; ++j) {
        const long long u = u0 + j;
        ab[j] = u < tiles ? Ab[u * Ctot] : T(0);
        b0[j] = u < tiles ? B0[u * Ctot] : T(0);
        b1[j] = u < tiles ? B1[u * Ctot] : T(0);
      }
#pragma unroll
      for (int j = 0; j < kFold; ++j) {
        if (!go || u0 + j >= tiles) { go = false; break; }
        const T cu = b1[j] != T(0) ? b0[j] + b1[j] * dp_in_of(u0 + j)
                                   : b0[j];
        Min = Min + P * cu;
        P = P * ab[j];
        if (fabs(P) < tiny) go = false;
      }
    }
  }
  clk.mark(0);
  const int s0 = t * a.R;
  const int s1 = min(n, s0 + a.R);
  T* Mc = a.M + c;
  const uint8_t* Cc = a.code + c;
  // the entering dp through the tile's first rows (alpha as spline_tiles)
  if (din != T(0)) {
    T al = T(1);
    bool go = true;
    for (int sc = s0; go && sc < s1; sc += kChunk) {
      uint8_t cb[kChunk];
      T mb[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int s = sc + j;
        cb[j] = s < s1 ? Cc[(long long)s * Ctot] : (uint8_t)0;
        mb[j] = s < s1 ? Mc[(long long)s * Ctot] : T(0);
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (!go || !unknown_code(cb[j])) { go = false; break; }
        al = tabA[cb[j]] * al;
        if (al == T(0)) { go = false; break; }
        Mc[(long long)(sc + j) * Ctot] = mb[j] + al * din;
      }
    }
  }
  clk.mark(1);
  // backward rows: M = -cp M_next + dp (unknown), dp (known), 0 elsewhere;
  // pre(x) the interior value the ends read (0 elsewhere); the next chunk's
  // rows read while a chunk is walked
  auto code_at = [&](int s) -> uint8_t {
    return s < n ? Cc[(long long)s * Ctot] : (uint8_t)0;
  };
  uint8_t c1 = code_at(s1), c2 = code_at(s1 + 1);
  T nxt = Min;
  T p1 = interior_code(c1) ? Min : T(0), p2 = T(0);
  uint8_t cb[kChunk];
  T db[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int s = s1 - 1 - j;
    cb[j] = s >= s0 ? Cc[(long long)s * Ctot] : (uint8_t)0;
    db[j] = s >= s0 ? Mc[(long long)s * Ctot] : T(0);
  }
  for (int sh = s1; sh > s0; sh -= kChunk) {
    uint8_t cn[kChunk];
    T dn[kChunk];
    if (sh - kChunk > s0) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int s = sh - kChunk - 1 - j;
        cn[j] = s >= s0 ? Cc[(long long)s * Ctot] : (uint8_t)0;
        dn[j] = s >= s0 ? Mc[(long long)s * Ctot] : T(0);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int s = sh - 1 - j;
      if (s >= s0) {
        const uint8_t cs = cb[j];
        T v;
        if (unknown_code(cs)) v = -tabCP[cs] * nxt + db[j];
        else if (cs == kKnown) v = db[j];
        else v = T(0);
        const T p0 = interior_code(cs) ? v : T(0);
        if (cs == kStart) {
          // the tile of the anchor after it writes a start
          if (s < s1 - 1) Mc[(long long)s * Ctot] = T(2) * p1 - p2;
        } else if (cs != kEnd) {
          Mc[(long long)s * Ctot] = v;
        }
        // an end two anchors after s: written here, from pre(s+1), pre(s)
        if (c2 == kEnd) Mc[(long long)(s + 2) * Ctot] = T(2) * p1 - p0;
        p2 = p1; p1 = p0;
        c2 = c1; c1 = cs;
        nxt = v;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) { cb[j] = cn[j]; db[j] = dn[j]; }
  }
  // a start at the row before the tile; the first tile also writes an end
  // at row 1 (a run of the anchors 0 and 1), from pre(0) and nothing before
  if (s0 > 0 && Cc[(long long)(s0 - 1) * Ctot] == kStart)
    Mc[(long long)(s0 - 1) * Ctot] = T(2) * p1 - p2;
  if (s0 == 0 && c2 == kEnd) Mc[Ctot] = T(2) * p1 - T(0);
  clk.mark(2);
  clk.flush();
}

// ------------------------------------------------------------------- synth

template <typename T>
struct SynthArgs {
  Src<T> src;
  const T* M;                                                 // [n, G*K+G]
  const T* bump;                                              // [step]
  T* am_out; T* fmc_out; T* fm_out; T* ph_out;                // [G, L, K]
  T* anchors;                                                 // [3, G, n, K]
  T* a0_anchor;                                               // [G, n]
  T* s_out; T* a0_out;                                        // [G, L]
  int step, add_dc;
  int Kl, S, J;     // lanes a segment, segments side by side, slices
  long long L;
  double fs;
};

template <typename T>
__device__ __forceinline__ T cosine(T x);
template <>
__device__ __forceinline__ float cosine<float>(float x) { return cosf(x); }
template <>
__device__ __forceinline__ double cosine<double>(double x) { return cos(x); }

// fmod(x, y) for y > 0 and |x / y| < 2^50, exactly: with the quotient q
// that fmod's result implies, x - q y is representable and one fma gives
// it; a product x (1 / y) off by one is seen from the sign or size of the
// first remainder and taken again.
template <typename T>
__device__ __forceinline__ T fmod_pos(T x, T y, T inv_y) {
  T q = trunc(x * inv_y);
  T r = fma(-q, y, x);
  if (x >= T(0) ? r < T(0) : r > T(0)) {
    q = x >= T(0) ? q - T(1) : q + T(1);
    r = fma(-q, y, x);
  } else if (fabs(r) >= y) {
    q = x >= T(0) ? q + T(1) : q - T(1);
    r = fma(-q, y, x);
  }
  return r;
}

// torch.remainder(x + pi, 2 pi) - pi, with the tie rule of
// eaqhm_tpu/models/tracks.py:263-264
template <typename T>
__device__ __forceinline__ T wrap_phase(T x, T pi, T two_pi) {
  const T a = x + pi;
  T r = fabs(a) < T(1e6) ? fmod_pos(a, two_pi, T(1) / two_pi)
                          : fmod(a, two_pi);
  if (r != T(0) && ((r < T(0)) != (two_pi < T(0)))) r += two_pi;
  T d = r - pi;
  if (d == -pi && x > T(0)) d = pi;
  return d;
}

// Blocks of 256 threads a SM the registers are bounded for: the kept build
// at 128 registers in float64 (80 spill) and 80 in float32; the other,
// whose pass 2 evaluates fm again, at 255.
template <typename T, bool kKept>
constexpr int synth_min_blocks() {
  return kKept ? (sizeof(T) == 8 ? 2 : 3) : 1;
}

template <typename T, bool kKept>
__global__ void __launch_bounds__(kSynthThreads, synth_min_blocks<T, kKept>())
track_synth(SynthArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Tier<T> tiers[kMaxTiers];
  Clk clk(clk_kind<T>(2));
  const int G = a.src.G, K = a.src.K, n = a.src.n;
  const int step = a.step, Kl = a.Kl, S = a.S;
  const int NT = synth_threads(S, Kl);
  const int rows_n = kKept ? step + 1 : kSynthRows;
  const int pieces = (Kl + kPiece - 1) / kPiece;
  const int TS = S * a.J;
  const int Kh = K > 0 ? K : 1;           // columns of the anchor arrays
  unsigned char* p_sm = smem_raw;
  T* tab = (T*)p_sm;                      // Bc, Ac, A3, B3 [step+1]; bump
  const int E1 = step + 1;
  if (kKept) p_sm += align16((size_t)(5 * step + 4) * sizeof(T));
  // [rows_n][RS]: a row's values at an odd stride, so the threads that sum
  // rows side by side read distinct banks
  const int RS = NT | 1;
  T* rows = (T*)p_sm;
  p_sm += align16((size_t)rows_n * RS * sizeof(T));
  T* part = (T*)p_sm;                     // [S][rows_n][pieces]
  if (pieces > 1) p_sm += align16((size_t)rows_n * S * pieces * sizeof(T));
  T* amv = (T*)p_sm;                      // [TS + 5][Kh] from seg_base - 2
  T* fmv = amv + (TS + 5) * Kh;
  T* phv = fmv + (TS + 5) * Kh;
  T* f01 = phv + (TS + 5) * Kh;           // fm of anchors 0, 1 [2][Kh]
  p_sm += align16((size_t)(3 * (TS + 5) + 2) * Kh * sizeof(T));
  T* dcv = (T*)p_sm;                      // DC anchors seg_base.. [TS + 3]
  T* dcm = dcv + (TS + 3);                // and their M
  p_sm += align16((size_t)2 * (TS + 3) * sizeof(T));
  uint8_t* fl = (uint8_t*)p_sm;           // [TS + 5][Kh]

  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const int seg_base = blockIdx.x * TS;
  const int n_pairs = n - 1;
  const long long L = a.L;
  const long long Lp = (long long)n_pairs * step + 1;
  const int Ctot = G * K + G;
  const long long n_virtual = L > Lp ? (L - Lp + step - 1) / step : 0;
  const long long n_seg = n_pairs + n_virtual;
  const T h = T((double)step), hh = T((double)step * (double)step);
  const T six = T(6), one = T(1), two = T(2);
  const T c_ph = T(2.0 * 3.141592653589793 / a.fs);
  const T c_fm = T(a.fs / (2.0 * 3.141592653589793));
  const T pi = T(3.141592653589793), two_pi = T(2.0 * 3.141592653589793);
  const T two_h = T(2.0 * (double)step);
  const long long plane = (long long)G * n * K;

  load_tiers(a.src, tiers, tid);
  if (kKept) {
    for (int e = tid; e <= step; e += NT) {
      const T Bc = T((double)e) / h;
      const T Ac = one - Bc;
      tab[e] = Bc;
      tab[E1 + e] = Ac;
      tab[2 * E1 + e] = Ac * Ac * Ac - Ac;
      tab[3 * E1 + e] = Bc * Bc * Bc - Bc;
      if (e < step) tab[4 * E1 + e] = a.bump[e];
    }
  }
  __syncthreads();
  // the block's anchors seg_base - 2 .. seg_base + TS + 2 (and anchors 0,
  // 1): masked values and accepted flags, read once
#pragma unroll 4
  for (int i = tid; i < (TS + 7) * K; i += NT) {
    const int ai = i / K, k = i % K;
    const int s = ai < TS + 5 ? seg_base - 2 + ai : ai - (TS + 5);
    const Cell<T> v = cell(row_at(a.src, tiers, g, s), k, true);
    if (ai < TS + 5) {
      fl[ai * Kh + k] = v.keep && v.am != T(0);
      amv[ai * Kh + k] = v.am;
      fmv[ai * Kh + k] = v.fm;
      phv[ai * Kh + k] = v.ph;
    } else {
      f01[(ai - (TS + 5)) * Kh + k] = v.fm;
    }
  }
  for (int i = tid; i < TS + 3; i += NT) {
    const int s = seg_base + i;
    dcv[i] = dc_at(a.src, tiers, g, s);
    dcm[i] = s < n ? a.M[(long long)s * Ctot + G * K + g] : T(0);
  }
  __syncthreads();
  clk.mark(0);

  const int j = tid / Kl, kl = tid % Kl;   // j >= S: no segment
  auto row_of = [&](int p, int e) -> long long {
    return p < n_pairs ? (long long)p * step + e
                       : Lp - 1 + (long long)(p - n_pairs) * step + e;
  };
  const T* y_dc_m = a.M + G * K + g;
  // the DC anchor s and its M: from shared memory where the block read them
  auto dc_y = [&](long long s) -> T {
    const long long i = s - seg_base;
    return i >= 0 && i < TS + 3 ? dcv[i] : dc_at(a.src, tiers, g, (int)s);
  };
  auto dc_m = [&](long long s) -> T {
    const long long i = s - seg_base;
    return i >= 0 && i < TS + 3 ? dcm[i] : y_dc_m[s * Ctot];
  };

  for (int it = 0; it < a.J; ++it) {
    const int p = seg_base + it * S + j;
    const bool real = p < n_pairs;
    for (int c0 = 0; c0 < (kKept ? 1 : step + 1); c0 += rows_n) {
      for (int e = 0; e < rows_n; ++e) rows[e * RS + tid] = T(0);
      for (int k = kl; k < Kh; k += Kl) {
        const bool active = j < S && k < K && p < n_seg;
        // per (segment, column) state, from the block's anchor arrays
        const int ia = j < S ? (p - seg_base) * Kh + k : 0;   // anchor p - 2
        bool pair = false, small = false, start_q = false, end_q = false;
        bool in_q = false;
        int nl = 0, nr = 0;
        T fm_p = 0, fm_q = 0, M_p = 0, M_q = 0, er = 0;
        if (active && real) {
          const int p0 = p, q = p0 + 1;
          const bool a_m2 = fl[ia], a_m1 = fl[ia + Kh];
          const bool a_p = fl[ia + 2 * Kh], a_q = fl[ia + 3 * Kh];
          const bool a_q1 = fl[ia + 4 * Kh], a_q2 = fl[ia + 5 * Kh];
          fm_p = fmv[ia + 2 * Kh];
          fm_q = fmv[ia + 3 * Kh];
          pair = a_p && a_q;
          in_q = a_q && (a_p || a_q1);
          start_q = a_q && !a_p && a_q1;
          end_q = a_q && a_p && !a_q1;
          nl = 1 + (int)a_m1 + (int)(a_m1 && a_m2);
          nr = 1 + (int)a_q1 + (int)(a_q1 && a_q2);
          small = pair && nl + nr < 4;
          if (pair && !small) {
            M_p = a.M[(long long)p0 * Ctot + g * K + k];
            M_q = a.M[(long long)q * Ctot + g * K + k];
          }
        }
        clk.mark(1);
        // fm at offset e (1..step-1) of a pair segment: the 4-point cubic
        // through the synthetic anchors (its constants made where they are
        // used, so they hold registers only there) or the spline, the
        // per-offset constants from the table (kept)
        struct Cubic { T x1, scale, xn[4], y4[4], den[4]; };
        auto cubic = [&](int p, int k, int nl, int nr) -> Cubic {
          Cubic c;
          const int st = p - (nl - 1);
          int sl[4];
          // m = 3: slots 0, st, st+1, st+2; m = 2: 0, 1, st, st+1
          const bool three = nl + nr == 3;
          sl[0] = 0;
          sl[1] = three ? st : 1;
          sl[2] = three ? st + 1 : st;
          sl[3] = three ? st + 2 : st + 1;
          T x4[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            sl[m] = min(max(sl[m], 0), n - 1);
            x4[m] = T((double)sl[m]) * h;
            const int rel = sl[m] - (seg_base - 2);
            c.y4[m] = rel >= 0 && rel < TS + 5 ? fmv[rel * Kh + k]
                                               : f01[sl[m] * Kh + k];
          }
          c.x1 = x4[1];
          c.scale = fabs(x4[3] - x4[1]);
          // torch.clamp(min=1e-30): NaN stays NaN
          if (c.scale < T(1e-30)) c.scale = T(1e-30);
#pragma unroll
          for (int m = 0; m < 4; ++m) c.xn[m] = (x4[m] - c.x1) / c.scale;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            T d = one;
#pragma unroll
            for (int m = 0; m < 4; ++m)
              if (m != jj) d = d * (c.xn[jj] - c.xn[m]);
            c.den[jj] = d;
          }
          return c;
        };
        auto fm_small = [&](const Cubic& c, int p, int e) -> T {
          const T qv = T((double)p) * h + T((double)e);
          const T qn = (qv - c.x1) / c.scale;
          T out = T(0);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            T num = one;
#pragma unroll
            for (int m = 0; m < 4; ++m)
              if (m != jj) num = num * (qn - c.xn[m]);
            out = out + c.y4[jj] * (num / c.den[jj]);
          }
          return out;
        };
        auto fm_spline = [&](int e) -> T {
          T Bc, Ac, A3, B3;
          if (kKept) {
            Bc = tab[e]; Ac = tab[E1 + e];
            A3 = tab[2 * E1 + e]; B3 = tab[3 * E1 + e];
          } else {
            Bc = T((double)e) / h; Ac = one - Bc;
            A3 = Ac * Ac * Ac - Ac; B3 = Bc * Bc * Bc - Bc;
          }
          return (Ac * fm_p + Bc * fm_q) + ((A3 * M_p + B3 * M_q) * hh) / six;
        };
        // pass 1: the segment's phase end, Mw and the correction; the kept
        // build leaves each row's fm in its slot for pass 2
        if (kKept) {
          // the warp's short runs one at a time, a lane a row (step <= 15):
          // a lane with a short run would otherwise hold its warp for
          // step - 1 rows of the cubic
          const int lane = tid & 31;
          unsigned todo = __ballot_sync(0xffffffffu, small);
          while (todo) {
            const int src = __ffs(todo) - 1;
            todo &= todo - 1u;
            const int sp = __shfl_sync(0xffffffffu, p, src);
            const int sk = __shfl_sync(0xffffffffu, k, src);
            const int snl = __shfl_sync(0xffffffffu, nl, src);
            const int snr = __shfl_sync(0xffffffffu, nr, src);
            const int e = lane + 1;
            if (e < step)
              rows[e * RS + (tid & ~31) + src] =
                  fm_small(cubic(sp, sk, snl, snr), sp, e);
          }
          __syncwarp();
        }
        if (pair) {
          T cs = T(0);
          if (small) {
            const Cubic cu = kKept ? Cubic{} : cubic(p, k, nl, nr);
            for (int e = 1; e < step; ++e) {
              const T f = kKept ? rows[e * RS + tid] : fm_small(cu, p, e);
              cs = cs + f;
            }
          } else {
            for (int e = 1; e < step; ++e) {
              const T f = fm_spline(e);
              if (kKept) rows[e * RS + tid] = f;
              cs = cs + f;
            }
          }
          cs = cs + fm_q;
          const T ph_p = phv[ia + 2 * Kh], ph_q = phv[ia + 3 * Kh];
          const T pm_end = ph_p + cs * c_ph;
          const T Mw = rint((pm_end - ph_q) / two_pi);
          er = (pi * ((pm_end - ph_q) - two_pi * Mw)) / two_h;
        }
        clk.mark(2);
        // pass 2: every row of the segment; am cos(ph) into the row slots
        const Cubic cu2 = !kKept && small ? cubic(p, k, nl, nr) : Cubic{};
        const T am_p = amv[ia + 2 * Kh], am_q = amv[ia + 3 * Kh];
        const T ph_p = phv[ia + 2 * Kh], ph_q = phv[ia + 3 * Kh];
        const T* bump = kKept ? tab + 4 * E1 : a.bump;
        // the segment's first row in the outputs; a row e at e * K past it
        const long long ob = ((long long)g * L + row_of(p, 0)) * K + k;
        const bool want_fm = a.fm_out != nullptr;
        const bool want_ph = a.ph_out != nullptr;
        auto emits = [&](int e) {
          return kKept || (e >= c0 && e < c0 + rows_n);
        };
        auto put = [&](int e, T o_am, T o_fmc, T o_fm, T o_ph) {
          const long long o = ob + e * K;
          a.am_out[o] = o_am;
          a.fmc_out[o] = o_fmc;
          if (want_fm) a.fm_out[o] = o_fm;
          if (want_ph) a.ph_out[o] = o_ph;
          const T v = o_am * cosine(o_ph);
          if (kKept) rows[e * RS + tid] = v;
          else rows[(e - c0) * RS + tid] = rows[(e - c0) * RS + tid] + v;
        };
        if (active && real) {
          // row 0 (segment 0): the left anchor
          if (p == 0 && emits(0)) {
            if (a.anchors) {
              const long long ai = (long long)g * n * K + k;
              a.anchors[ai] = am_p;
              a.anchors[plane + ai] = fm_p;
              a.anchors[2 * plane + ai] = ph_p;
            }
            put(0, am_p, pair ? fm_p : T(0), fm_p, ph_p);
          }
          T cs = T(0), prev = ph_p;
          if (pair) {
            for (int e = 1; e < step; ++e) {
              const T f = kKept ? rows[e * RS + tid]
                                : (small ? fm_small(cu2, p, e)
                                         : fm_spline(e));
              cs = cs + f;
              const T pmc = (ph_p + cs * c_ph) - er * bump[e - 1];
              if (emits(e)) {
                T Bc, Ac;
                if (kKept) {
                  Bc = tab[e]; Ac = tab[E1 + e];
                } else {
                  Bc = T((double)e) / h; Ac = one - Bc;
                }
                put(e, Ac * am_p + Bc * am_q,
                    c_fm * wrap_phase(pmc - prev, pi, two_pi), f, pmc);
              }
              prev = pmc;
            }
          } else {
            // the rows inside a segment that is not a pair: zero
            for (int e = max(1, c0); e < min(step, c0 + rows_n); ++e)
              put(e, T(0), T(0), T(0), T(0));
          }
          // the right anchor's row; a run's end takes the corrected phase
          if (emits(step)) {
            T ph2 = ph_q;
            if (pair) {
              cs = cs + fm_q;
              const T pmc = (ph_p + cs * c_ph) - er * bump[step - 1];
              if (end_q) ph2 = pmc;
            }
            if (a.anchors) {
              const long long ai = ((long long)g * n + p + 1) * K + k;
              a.anchors[ai] = am_q;
              a.anchors[plane + ai] = fm_q;
              a.anchors[2 * plane + ai] = ph2;
            }
            put(step, am_q,
                start_q ? fm_q
                        : in_q ? c_fm * wrap_phase(ph2 - prev, pi, two_pi)
                               : T(0),
                fm_q, ph2);
          }
        } else if (active) {
          // the rows past Lp: zero harmonics
          for (int e = max(1, c0); e <= min(step, c0 + rows_n - 1); ++e)
            if (row_of(p, e) < L) put(e, T(0), T(0), T(0), T(0));
        }
        clk.mark(3);
      }
      __syncthreads();
      // each row's sum over K: pieces of kPiece columns in column order
      // (one piece: summed below)
      const int Kc = K < Kl ? K : Kl;
      auto piece_sum = [&](int jj, int e, int pc) -> T {
        const T* r = rows + e * RS + jj * Kl;
        T sum = T(0);
        const int kend = min(Kc, (pc + 1) * kPiece);
        for (int k = pc * kPiece; k < kend; ++k) sum = sum + r[k];
        return sum;
      };
      if (pieces > 1) {
        // the rows of a (segment, piece) side by side across the threads
        for (int w = tid; w < S * rows_n * pieces; w += NT) {
          const int e = w % rows_n, jp = w / rows_n;
          part[(jp / pieces * rows_n + e) * pieces + jp % pieces] =
              piece_sum(jp / pieces, e, jp % pieces);
        }
        __syncthreads();
      }
      // per row: the pieces in order, the DC cubic, s and the DC outputs
      for (int w = tid; w < S * rows_n; w += NT) {
        const int jj = w / rows_n, ei = w % rows_n;
        const int e = ei + c0;
        const int pr = seg_base + it * S + jj;
        if (pr >= n_seg || e > step || (e == 0 && pr != 0)) continue;
        const long long row = row_of(pr, e);
        if (row >= L) continue;
        T sum;
        if (pieces > 1) {
          sum = part[w * pieces];
          for (int pc = 1; pc < pieces; ++pc)
            sum = sum + part[w * pieces + pc];
        } else {
          sum = piece_sum(jj, ei, 0);
        }
        const long long pd = min(row / step, (long long)(n - 2));
        const int r = (int)(row - pd * step);
        T Bc, Ac, A3, B3;
        if (kKept && r <= step) {
          Bc = tab[r]; Ac = tab[E1 + r];
          A3 = tab[2 * E1 + r]; B3 = tab[3 * E1 + r];
        } else {
          Bc = T((double)r) / h; Ac = one - Bc;
          A3 = Ac * Ac * Ac - Ac; B3 = Bc * Bc * Bc - Bc;
        }
        const T ys = dc_y(pd), ye = dc_y(pd + 1);
        const T Ms = dc_m(pd), Me = dc_m(pd + 1);
        const T dc = (Ac * ys + Bc * ye) + ((A3 * Ms + B3 * Me) * hh) / six;
        a.s_out[(long long)g * L + row] =
            a.add_dc ? dc + two * sum : two * sum;
        if (a.a0_out) a.a0_out[(long long)g * L + row] = dc;
        if (a.a0_anchor && row % step == 0 && row / step < n)
          a.a0_anchor[(long long)g * n + row / step] = dc;
      }
      __syncthreads();
      clk.mark(4);
    }
  }
  clk.flush();
}

// -------------------------------------------------------------------- srer

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T s = T(0);
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s = s + red[w];
  return s;
}

template <typename T>
__device__ __forceinline__ T log10_(T x);
template <>
__device__ __forceinline__ float log10_<float>(float x) { return log10f(x); }
template <>
__device__ __forceinline__ double log10_<double>(double x) { return log10(x); }

// The masked SRER in two passes over blocks (chunk c, group g); part
// [G][nch][4]: the chunk's sums of det - s and of det (pass 0), of their
// squared deviations from the means (pass 1); cnt [G] counts the blocks of
// a group done with pass 1.
template <typename T>
__global__ void __launch_bounds__(kSrerThreads)
track_srer(const T* det, const T* s, const long long* lens,
           const T* std_det, T* srer, T* part, int* cnt, long long L,
           long long det_sg, long long n_valid, int pass) {
  __shared__ T red[kSrerThreads / 32];
  __shared__ int last;
  const int c = blockIdx.x, nch = gridDim.x;
  const long long g = blockIdx.y;
  long long nv = lens ? lens[g] : n_valid;
  nv = nv < L ? (nv > 0 ? nv : 0) : L;
  const T nf = T((double)(nv > 1 ? nv : 1));
  const long long chunk = (L + nch - 1) / nch;
  const long long l0 = c * chunk, l1 = min(l0 + chunk, nv);
  const T* dg = det + g * det_sg;
  const T* sg = s + g * L;
  const bool own_std = std_det == nullptr;
  T* pg = part + g * nch * 4;
  T sr = T(0), sd = T(0);
  if (pass == 0) {
    for (long long l = l0 + threadIdx.x; l < l1; l += kSrerThreads) {
      sr = sr + (dg[l] - sg[l]);
      if (own_std) sd = sd + dg[l];
    }
    sr = block_sum(sr, red);
    if (own_std) sd = block_sum(sd, red);
    if (threadIdx.x == 0) {
      pg[4 * c] = sr;
      pg[4 * c + 1] = sd;
      if (c == 0) cnt[g] = 0;
    }
    return;
  }
  // the means, from every chunk's sums in a fixed order
  T mr = T(0), md = T(0);
  for (int k = threadIdx.x; k < nch; k += kSrerThreads) {
    mr = mr + pg[4 * k];
    if (own_std) md = md + pg[4 * k + 1];
  }
  mr = block_sum(mr, red) / nf;
  if (own_std) md = block_sum(md, red) / nf;
  for (long long l = l0 + threadIdx.x; l < l1; l += kSrerThreads) {
    const T r = (dg[l] - sg[l]) - mr;
    sr = sr + r * r;
    if (own_std) {
      const T e = dg[l] - md;
      sd = sd + e * e;
    }
  }
  sr = block_sum(sr, red);
  if (own_std) sd = block_sum(sd, red);
  if (threadIdx.x == 0) {
    pg[4 * c + 2] = sr;
    pg[4 * c + 3] = sd;
    __threadfence();
    last = atomicAdd(cnt + g, 1) == nch - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  sr = sd = T(0);
  for (int k = threadIdx.x; k < nch; k += kSrerThreads) {
    sr = sr + __ldcg(pg + 4 * k + 2);
    if (own_std) sd = sd + __ldcg(pg + 4 * k + 3);
  }
  sr = block_sum(sr, red);
  if (own_std) sd = block_sum(sd, red);
  if (threadIdx.x == 0) {
    const T ref = own_std ? sqrt(sd / nf) : *std_det;
    srer[g] = T(20) * log10_(ref / sqrt(sr / nf));
  }
}

// ---------------------------------------------------------------- launches

template <typename T>
int spline_launch(const long long* desc, const void* ctab, void* M,
                  void* code, void* agg, int agg_tiles, int G, int K, int n,
                  int step, void* stream) {
  if (G < 1 || K < 0 || n < 2 || step < 1) return (int)cudaErrorInvalidValue;
  const tracks_plan::SplinePlan plan = tracks_plan::spline_plan(G, n, K);
  if (plan.tiles > agg_tiles) return (int)cudaErrorInvalidValue;
  SplineArgs<T> a;
  if (!read_src(desc, G, K, n, a.src)) return (int)cudaErrorInvalidValue;
  a.ctab = (const T*)ctab;
  a.M = (T*)M;
  a.code = (uint8_t*)code;
  a.agg = (T*)agg;
  a.R = plan.R;
  a.tiles = plan.tiles;
  a.h = (double)step;
  const int Ctot = G * K + G;
  dim3 block(32, kSplineWarps);
  dim3 grid((Ctot + 31) / 32, (a.tiles + kSplineWarps - 1) / kSplineWarps);
  spline_tiles<T><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  spline_apply<T><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int synth_launch(const long long* desc, const void* M, const void* bump,
                 void* am_out, void* fmc_out, void* fm_out, void* ph_out,
                 void* anchors, void* a0_anchor, void* s_out, void* a0_out,
                 int G, int K, int n, int step, long long L, int add_dc,
                 double fs, void* stream) {
  if (G < 1 || K < 0 || n < 2 || step < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const long long Lp = (long long)(n - 1) * step + 1;
  if (K > 0 && L < Lp) return (int)cudaErrorInvalidValue;
  const tracks_plan::SynthPlan plan =
      tracks_plan::synth_plan(G, n, K, step, L, sizeof(T));
  if (plan.smem > kSynthMaxSmem) return (int)cudaErrorInvalidValue;
  SynthArgs<T> a;
  if (!read_src(desc, G, K, n, a.src)) return (int)cudaErrorInvalidValue;
  a.M = (const T*)M;
  a.bump = (const T*)bump;
  a.am_out = (T*)am_out; a.fmc_out = (T*)fmc_out;
  a.fm_out = (T*)fm_out; a.ph_out = (T*)ph_out;
  a.anchors = (T*)anchors; a.a0_anchor = (T*)a0_anchor;
  a.s_out = (T*)s_out; a.a0_out = (T*)a0_out;
  a.step = step; a.add_dc = add_dc;
  a.Kl = plan.Kl; a.S = plan.S; a.J = plan.J;
  a.L = L; a.fs = fs;
  dim3 grid((unsigned)(plan.blocks / G), G);
  if (plan.kept)
    track_synth<T, true><<<grid, plan.threads, plan.smem,
                           (cudaStream_t)stream>>>(a);
  else
    track_synth<T, false><<<grid, plan.threads, plan.smem,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int srer_launch(const void* det, const void* s, const void* lens,
                const void* std_det, void* srer, void* part, void* cnt,
                int G, int nch, long long L, long long det_sg,
                long long n_valid, void* stream) {
  if (G < 1 || G > 65535 || L < 1 || nch != tracks_plan::srer_chunks(L))
    return (int)cudaErrorInvalidValue;
  for (int pass = 0; pass < tracks_plan::kSrerLaunches; ++pass)
    track_srer<T><<<dim3(nch, G), kSrerThreads, 0, (cudaStream_t)stream>>>(
        (const T*)det, (const T*)s, (const long long*)lens,
        (const T*)std_det, (T*)srer, (T*)part, (int*)cnt, L, det_sg,
        n_valid, pass);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// track_spline (float32 / float64), two launches: desc the anchors' source
// (host array, read before the launch: kSrcHead + kSrcTier per tier long
// longs), ctab [49] -> M [n, G*K + G] (harmonic columns g*K + k, then the G
// DC columns); code [n, G*K + G] bytes and agg [5, agg_tiles, G*K + G]
// scratch (agg_tiles at least the plan's tiles, track_spline_plan).  Returns
// the cudaError_t of the launches.
int track_spline_f32(const long long* desc, const void* ctab, void* M,
                     void* code, void* agg, int agg_tiles, int G, int K,
                     int n, int step, void* stream) {
  return spline_launch<float>(desc, ctab, M, code, agg, agg_tiles, G, K, n,
                              step, stream);
}

int track_spline_f64(const long long* desc, const void* ctab, void* M,
                     void* code, void* agg, int agg_tiles, int G, int K,
                     int n, int step, void* stream) {
  return spline_launch<double>(desc, ctab, M, code, agg, agg_tiles, G, K, n,
                               step, stream);
}

// track_synth (float32 / float64): desc as track_spline's, M from it, bump
// [step] (the cumulative sine bump) -> am_out, fmc_out [G, L, K]; fm_out,
// ph_out [G, L, K] or null (dense fm and ph); anchors [3, G, n, K] or null
// (the anchor rows of am, fm, corrected ph); a0_anchor [G, n] or null; s_out
// [G, L] (add_dc: a0 + 2 sum, else 2 sum); a0_out [G, L] or null (the DC
// track).  The block shape is track_synth_plan's.  Returns the
// cudaError_t.
int track_synth_f32(const long long* desc, const void* M, const void* bump,
                    void* am_out, void* fmc_out, void* fm_out, void* ph_out,
                    void* anchors, void* a0_anchor, void* s_out,
                    void* a0_out, int G, int K, int n, int step, long long L,
                    int add_dc, double fs, void* stream) {
  return synth_launch<float>(desc, M, bump, am_out, fmc_out, fm_out, ph_out,
                             anchors, a0_anchor, s_out, a0_out, G, K, n, step,
                             L, add_dc, fs, stream);
}

int track_synth_f64(const long long* desc, const void* M, const void* bump,
                    void* am_out, void* fmc_out, void* fm_out, void* ph_out,
                    void* anchors, void* a0_anchor, void* s_out,
                    void* a0_out, int G, int K, int n, int step, long long L,
                    int add_dc, double fs, void* stream) {
  return synth_launch<double>(desc, M, bump, am_out, fmc_out, fm_out,
                              ph_out, anchors, a0_anchor, s_out, a0_out, G, K,
                              n, step, L, add_dc, fs, stream);
}

// track_srer (float32 / float64): det [G, L] (row stride det_sg), s [G, L],
// lens [G] int64 or null (then n_valid for every group), std_det [1] or
// null (then the masked std of det) -> srer [G]; part [G, nch, 4] and cnt
// [G] int32 are scratch, nch the chunks a group (tracks_plan.h
// srer_chunks(L), checked; two launches of nch x G blocks).  Returns the
// cudaError_t.
int track_srer_f32(const void* det, const void* s, const void* lens,
                   const void* std_det, void* srer, void* part, void* cnt,
                   int G, int nch, long long L, long long det_sg,
                   long long n_valid, void* stream) {
  return srer_launch<float>(det, s, lens, std_det, srer, part, cnt, G, nch,
                            L, det_sg, n_valid, stream);
}

int track_srer_f64(const void* det, const void* s, const void* lens,
                   const void* std_det, void* srer, void* part, void* cnt,
                   int G, int nch, long long L, long long det_sg,
                   long long n_valid, void* stream) {
  return srer_launch<double>(det, s, lens, std_det, srer, part, cnt, G, nch,
                             L, det_sg, n_valid, stream);
}

// Sets track_synth's dynamic shared-memory limit (once per device, before
// any launch).  Returns the cudaError_t.
int track_prepare() {
  const void* fns[4] = {(const void*)track_synth<float, true>,
                        (const void*)track_synth<double, true>,
                        (const void*)track_synth<float, false>,
                        (const void*)track_synth<double, false>};
  for (const void* f : fns) {
    const cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSynthMaxSmem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Blocks of one kernel that a SM holds at once at a launch of this block
// size and dynamic shared memory (the CUDA runtime's occupancy): kernel 0 /
// 1 spline_tiles float32 / float64, 2 / 3 spline_apply, 4 / 5 track_synth
// (fm kept between the passes), 6 / 7 track_synth (fm evaluated twice); -1
// for another kernel.
int track_occupancy(int kernel, int threads, int smem) {
  int blocks = -1;
  cudaError_t e = cudaErrorInvalidValue;
  switch (kernel) {
    case 0: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, spline_tiles<float>, threads, smem); break;
    case 1: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, spline_tiles<double>, threads, smem); break;
    case 2: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, spline_apply<float>, threads, smem); break;
    case 3: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, spline_apply<double>, threads, smem); break;
    case 4: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, track_synth<float, true>, threads, smem); break;
    case 5: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, track_synth<double, true>, threads, smem); break;
    case 6: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, track_synth<float, false>, threads, smem); break;
    case 7: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, track_synth<double, false>, threads, smem); break;
  }
  return e == cudaSuccess ? blocks : -1;
}

// Profiling build: copies the phase clocks (TRACKS_PHASE_CLOCKS) to
// out[6][8] (kernel, slot) and zeroes them; -1 in the port's own build.
int track_phase_clocks(unsigned long long* out) {
#ifdef TRACKS_PHASE_CLOCKS
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
