// The tracks, synthesis and SRER stage of one adaptation, for Hopper.
//
// Replaces eaqhm_tpu/models/tracks.py `interpolate_tracks_anchors`
// (:143-269) with `_segmented_notaknot_M` (:43-126), eaqhm_tpu/ops/interp.py
// `cubic4_eval` (:124-158) and `notaknot_interp_uniform` (:161-208, the DC
// track), and eaqhm_tpu/models/engine.py `_scatter_and_interp` (:549) and
// `_masked_srer` (:451), which XLA fuses on the TPU (as
// eaqhm_tpu/parallel/batch_engine.py `_interp_and_synth` :321 and the
// masked SRER of its step).  No Pallas kernel stood for them.
//
// Columns are independent: K harmonics of each of G groups (utterances),
// side by side, plus one DC track per group.  Anchor i of a column sits at
// sample i*step (n anchors, n_pairs = n - 1 segments, Lp = n_pairs*step + 1
// rows; rows Lp..L-1 are zero for the harmonics, the DC extrapolates).  A
// harmonic anchor is accepted where its am (after the optional acceptance
// mask) is nonzero; runs are maximal sequences of accepted anchors.
//
// Three kernels, launched in order on one stream:
// - track_spline: the second derivatives M of the not-a-knot spline of
//   every run of every column (the DC column is one run over all anchors),
//   as JAX's segmented Thomas solve defines them: the second and
//   second-last anchors of a run known (M = d/(6h)), the elimination
//   multipliers cp from the table 1/(4 - cp) by position in the run
//   (clamped at 48), the run's ends extrapolated linearly.  Each column's
//   anchors are cut into P pieces of at least 64 (P <= 128), one thread a
//   piece (8 columns x P pieces a block): a piece composes its rows'
//   forward maps dp -> a dp + b, the block chains the pieces' maps per
//   column, then each piece runs its rows from its entering value; the
//   backward sweep M -> -cp M + dp the same way in reverse.  A piece
//   starts by reading up to 49 anchors before it, which fixes the position
//   in the run of its first rows.  The maps compose in another order
//   than JAX's log-depth scan, so M agrees to rounding.  Bound: the
//   anchors read once and M written once (the scratch passes are this
//   design's).
// - track_synth: one block per tile of segments of one group, a thread a
//   harmonic column (looping when K exceeds the block).  Per (segment,
//   column): the linear am, the cubic fm (the spline, or for a run of 2-3
//   anchors the 4-point cubic through the synthetic anchors at slots 0, 1
//   and the run), the in-segment phase sum, Mw = rint(...) (round half to
//   even, as jnp.round), the sine-bump correction, the corrected phase of a
//   run-end anchor, fm_current from the wrapped phase differences
//   (torch.remainder's floor mod, and its tie rule), and am cos(ph).  A
//   segment writes the rows after its left anchor up to its right anchor
//   (segment 0 also row 0), so the fm_current of an anchor row reads the
//   phase of the row before it in the same thread.  It writes dense am and
//   fm_current [G, L, K] (what the next adaptation's fit reads), the anchor
//   rows of am, fm and the corrected ph ([3, G, n, K], what the packaging
//   reads), optionally dense fm and ph (the public functions), and per group
//   s = [a0 +] 2 sum_k am cos(ph) [G, L]: each warp sums its lanes in a
//   fixed tree, the warps add in order (no atomics, so two runs agree bit
//   for bit), and the DC cubic (extrapolated past the last anchor) is added
//   or written apart (the batch engine all-reduces the harmonic sum over
//   its model shards).  Bound: the anchors read once and the dense outputs
//   written once, against one cos per (row, column).
// - track_srer: one block per group: the masked SRER over the first n_valid
//   samples, 20 log10(std_det / std(det - s)), mean first and deviation
//   second as JAX writes it (std_det given, or the masked std of det).
//
// Every product and sum rounds on its own as the torch ops (and JAX) round
// them: the library is built with -fmad=false; cos, fmod, rint, log10 and
// sqrt are the accurate ones.  Sums over K and over samples run in another
// order than torch.sum, so s and the SRER agree to rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCpLen = 48;          // the cp table's last entry
constexpr uint8_t kKnown = 60;      // code of an anchor with M = d / (6h)
constexpr uint8_t kStart = 61;      // a run's first anchor
constexpr uint8_t kEnd = 62;        // a run's last anchor
constexpr int kChunk = 8;           // rows a walk loads ahead
constexpr int kSplineCols = 8;      // columns of a spline block
constexpr int kSrerThreads = 1024;

__device__ __forceinline__ bool interior_code(uint8_t c) {
  return c != 0 && c <= kKnown;     // 1..48 unknown (its position), known
}

// One column of the spline's input: row s's accepted flag and value y.
template <typename T>
struct Column {
  const T* am;          // harmonic: am and fm at (row s, this column)
  const T* fm;
  const uint8_t* acc;   // harmonic: acceptance (or null); DC: voiced
  long long sn;         // row stride of am / fm (acc rows are K apart)
  long long acc_sn;
  int n;
  bool dc;              // the DC track: every anchor in one run

  __device__ __forceinline__ void load(int s, bool& a, T& y) const {
    if (s < 0 || s >= n) { a = false; y = T(0); return; }
    if (dc) {
      a = true;
      T v = fm[s];
      y = (acc == nullptr || acc[s]) ? v : T(0);
      return;
    }
    const bool keep = acc == nullptr || acc[(long long)s * acc_sn];
    const T va = keep ? am[(long long)s * sn] : T(0);
    a = va != T(0);
    y = keep ? fm[(long long)s * sn] : T(0);
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
  if (code == 0 || code > kCpLen) last_nonun = s;
  return code;
}

// Walks rows [sa, sb) in order with the window of rows s-2..s+2 loaded,
// kChunk rows read ahead at a time; f(s, code, y_prev, y, y_next).
template <typename T, typename F>
__device__ __forceinline__ void walk(const Column<T>& col, int sa, int sb,
                                     int& last_nonun, F f) {
  bool w[5];
  T y[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) col.load(sa - 2 + j, w[j], y[j]);
  for (int s0 = sa; s0 < sb; s0 += kChunk) {
    bool wb[kChunk];
    T yb[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) col.load(s0 + 3 + j, wb[j], yb[j]);
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
  }
}

template <typename T>
struct SplineArgs {
  const T* am; const T* fm; const uint8_t* acc;   // [G, n, K] (strides sg, sn)
  const T* a0; const uint8_t* voiced;             // [G, n]
  const T* ctab;                                  // [kCpLen + 1]
  T* M;                                           // [n, G*K + G]
  uint8_t* code;                                  // [n, G*K + G]
  int G, K, n;
  long long sg, sn;
  double h;
};

template <typename T>
__global__ void __launch_bounds__(1024) track_spline(SplineArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  const int P = blockDim.y;
  T* fA = (T*)smem_raw;                 // [P][kSplineCols] forward maps
  T* fB = fA + P * kSplineCols;
  T* gA = fB + P * kSplineCols;         // backward maps
  T* gB = gA + P * kSplineCols;
  T* vin = gB + P * kSplineCols;        // entering values
  __shared__ T tabA[kCpLen + 1], tabHG[kCpLen + 1], tabCP[kCpLen + 1];

  const int tx = threadIdx.x, piece = threadIdx.y;
  for (int i = piece * kSplineCols + tx; i <= kCpLen;
       i += kSplineCols * P) {
    // forward coefficients by position in the run, as the torch ops round
    // them: g = 4 - cp_prev, a = -1 / g, and h g for b = d / (h g)
    const T cp_prev = a.ctab[i > 0 ? i - 1 : 0];
    const T g = T(4) - cp_prev;
    tabA[i] = T(-1) / g;
    tabHG[i] = T(a.h) * g;
    tabCP[i] = a.ctab[i];
  }
  __syncthreads();

  const int Ctot = a.G * a.K + a.G;
  const int c = blockIdx.x * kSplineCols + tx;
  const bool active = c < Ctot;
  Column<T> col;
  col.n = a.n;
  col.acc_sn = a.K;
  if (active && c < a.G * a.K) {
    const int g = c / a.K, k = c % a.K;
    col.dc = false;
    col.am = a.am + g * a.sg + k;
    col.fm = a.fm + g * a.sg + k;
    col.acc = a.acc ? a.acc + ((long long)g * a.n) * a.K + k : nullptr;
    col.sn = a.sn;
  } else {
    const int g = active ? c - a.G * a.K : 0;
    col.dc = true;
    col.am = nullptr;
    col.fm = a.a0 + (long long)g * a.n;
    col.acc = a.voiced ? a.voiced + (long long)g * a.n : nullptr;
    col.sn = 1;
  }
  const T six_h = T(6.0 / a.h), known_div = T(6.0 * a.h);
  const int R = (a.n + P - 1) / P;
  const int s0 = piece * R;
  const int s1 = min(a.n, s0 + R);
  T* Mc = a.M + c;
  uint8_t* Cc = a.code + c;

  // the position in the run at the piece's first row: up to 49 rows back
  auto start_pos = [&]() {
    int last = s0 - 2 * kCpLen;
    const int sl = max(0, s0 - kCpLen - 1);
    if (sl == 0) last = -1;
    walk(col, sl, s0, last, [](int, uint8_t, T, T, T) {});
    return last;
  };
  auto fwd = [&](uint8_t code, T yp, T y, T yn, T& am_, T& b_) {
    if (code == 0 || code > kKnown) { am_ = T(0); b_ = T(0); return; }
    const T d = six_h * ((yn - T(2) * y) + yp);
    if (code == kKnown) { am_ = T(0); b_ = d / known_div; return; }
    am_ = tabA[code];
    b_ = d / tabHG[code];
  };

  // forward: the piece's composite map, then the chained entering values
  T A = T(1), B = T(0);
  if (active && s0 < s1) {
    int last = start_pos();
    walk(col, s0, s1, last, [&](int, uint8_t code, T yp, T y, T yn) {
      T am_, b_;
      fwd(code, yp, y, yn, am_, b_);
      if (code >= 1 && code <= kCpLen) { A = am_ * A; B = am_ * B + b_; }
      else { A = T(0); B = b_; }
    });
  }
  fA[piece * kSplineCols + tx] = A;
  fB[piece * kSplineCols + tx] = B;
  __syncthreads();
  if (piece == 0) {
    T v = T(0);
    for (int p = 0; p < P; ++p) {
      vin[p * kSplineCols + tx] = v;
      v = fA[p * kSplineCols + tx] * v + fB[p * kSplineCols + tx];
    }
  }
  __syncthreads();
  // forward rows: dp into M, the codes; the piece's backward composite
  // v -> A v + B over its rows (M_s0 = G(M at s1))
  A = T(1);
  B = T(0);
  if (active && s0 < s1) {
    int last = start_pos();
    T dp = vin[piece * kSplineCols + tx];
    walk(col, s0, s1, last, [&](int s, uint8_t code, T yp, T y, T yn) {
      T am_, b_;
      fwd(code, yp, y, yn, am_, b_);
      const bool un = code >= 1 && code <= kCpLen;
      dp = un ? am_ * dp + b_ : b_;
      Mc[(long long)s * Ctot] = dp;
      Cc[(long long)s * Ctot] = code;
      const T ab = un ? -tabCP[code] : T(0);
      const T bb = interior_code(code) ? dp : T(0);
      B = A * bb + B;
      A = A * ab;
    });
  }
  __syncthreads();
  gA[piece * kSplineCols + tx] = A;
  gB[piece * kSplineCols + tx] = B;
  __syncthreads();
  if (piece == 0) {
    T v = T(0);
    for (int p = P - 1; p >= 0; --p) {
      vin[p * kSplineCols + tx] = v;
      v = gA[p * kSplineCols + tx] * v + gB[p * kSplineCols + tx];
    }
  }
  __syncthreads();
  // backward rows: M = -cp M_next + dp (unknown), dp (known), 0 elsewhere
  if (active && s0 < s1) {
    T v = vin[piece * kSplineCols + tx];
    for (int sh = s1; sh > s0; sh -= kChunk) {
      uint8_t cb[kChunk];
      T db[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int s = sh - 1 - j;
        if (s >= s0) {
          cb[j] = Cc[(long long)s * Ctot];
          db[j] = Mc[(long long)s * Ctot];
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int s = sh - 1 - j;
        if (s >= s0) {
          const uint8_t code = cb[j];
          if (code >= 1 && code <= kCpLen) v = -tabCP[code] * v + db[j];
          else if (code == kKnown) v = db[j];
          else v = T(0);
          Mc[(long long)s * Ctot] = v;
        }
      }
    }
  }
  __syncthreads();
  // the runs' ends: M extrapolated linearly from the interior values
  if (active && s0 < s1) {
    auto pre = [&](int x) -> T {
      if (x < 0 || x >= a.n) return T(0);
      return interior_code(Cc[(long long)x * Ctot]) ? Mc[(long long)x * Ctot]
                                                     : T(0);
    };
    for (int s = s0; s < s1; ++s) {
      const uint8_t code = Cc[(long long)s * Ctot];
      if (code == kStart)
        Mc[(long long)s * Ctot] = T(2) * pre(s + 1) - pre(s + 2);
      else if (code == kEnd)
        Mc[(long long)s * Ctot] = T(2) * pre(s - 1) - pre(s - 2);
    }
  }
}

template <typename T>
struct SynthArgs {
  const T* am; const T* fm; const T* ph; const uint8_t* acc;  // [G, n, K]
  const T* a0; const uint8_t* voiced;                         // [G, n]
  const T* M;                                                 // [n, G*K+G]
  const T* bump;                                              // [step]
  T* am_out; T* fmc_out; T* fm_out; T* ph_out;                // [G, L, K]
  T* anchors;                                                 // [3, G, n, K]
  T* a0_anchor;                                               // [G, n]
  T* s_out; T* a0_out;                                        // [G, L]
  int G, K, n, step, TS, add_dc;
  long long L, sg, sn;
  double fs;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T cosine(T x);
template <>
__device__ __forceinline__ float cosine<float>(float x) { return cosf(x); }
template <>
__device__ __forceinline__ double cosine<double>(double x) { return cos(x); }

// torch.remainder(x + pi, 2 pi) - pi, with the tie rule of
// eaqhm_tpu/models/tracks.py:263-264
template <typename T>
__device__ __forceinline__ T wrap_phase(T x, T pi, T two_pi) {
  T r = fmod(x + pi, two_pi);
  if (r != T(0) && ((r < T(0)) != (two_pi < T(0)))) r += two_pi;
  T d = r - pi;
  if (d == -pi && x > T(0)) d = pi;
  return d;
}

template <typename T>
__global__ void track_synth(SynthArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  const int nwarps = blockDim.x / 32;
  const int E = a.step + 1;                 // row slots of a segment
  T* red = (T*)smem_raw;                    // [nwarps][TS][E]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < nwarps * a.TS * E; i += blockDim.x) red[i] = T(0);
  __syncthreads();

  const int g = blockIdx.y;
  const int n = a.n, K = a.K, step = a.step;
  const int n_pairs = n - 1;
  const long long L = a.L;
  const long long Lp = (long long)n_pairs * step + 1;
  const int Ctot = a.G * K + a.G;
  const int seg0 = blockIdx.x * a.TS;
  const long long n_virtual = L > Lp ? (L - Lp + step - 1) / step : 0;
  const long long n_seg = n_pairs + n_virtual;
  const T h = T((double)step), hh = T((double)step * (double)step);
  const T six = T(6), one = T(1), two = T(2);
  const T c_ph = T(2.0 * 3.141592653589793 / a.fs);
  const T c_fm = T(a.fs / (2.0 * 3.141592653589793));
  const T pi = T(3.141592653589793), two_pi = T(2.0 * 3.141592653589793);
  const T two_h = T(2.0 * (double)step);
  const long long plane = (long long)a.G * n * K;

  // the row of slot e of segment p (real: after its left anchor; virtual:
  // the tail past Lp)
  auto row_of = [&](long long p, int e) -> long long {
    return p < n_pairs ? p * step + e : Lp - 1 + (p - n_pairs) * step + e;
  };

  const int J = (K + blockDim.x - 1) / blockDim.x;
  for (int j = 0; j < J; ++j) {
    const int k = j * blockDim.x + tid;
    const bool active = k < K;
    const T* am = a.am + g * a.sg + (active ? k : 0);
    const T* fm = a.fm + g * a.sg + (active ? k : 0);
    const T* ph = a.ph + g * a.sg + (active ? k : 0);
    const uint8_t* acc =
        a.acc ? a.acc + (long long)g * n * K + (active ? k : 0) : nullptr;
    const T* Mc = a.M + g * K + (active ? k : 0);
    const long long out_base = (long long)g * L * K + k;
    // masked anchor values (the fit's acceptance) and accepted flags
    auto keep = [&](int s) {
      return acc == nullptr || acc[(long long)s * K];
    };
    auto am_at = [&](int s) -> T {
      return keep(s) ? am[(long long)s * a.sn] : T(0);
    };
    auto fm_at = [&](int s) -> T {
      return keep(s) ? fm[(long long)s * a.sn] : T(0);
    };
    auto ph_at = [&](int s) -> T {
      return keep(s) ? ph[(long long)s * a.sn] : T(0);
    };
    auto accepted = [&](int s) -> bool {
      return s >= 0 && s < n && am_at(s) != T(0);
    };
    for (int i = 0; i < a.TS; ++i) {
      const long long p = seg0 + i;
      if (p >= n_seg) break;                 // uniform over the block
      const bool real = p < n_pairs;
      const int e_lo = p == 0 ? 0 : 1;
      // per-column state of this segment
      bool pair = false, small = false, start_q = false, end_q = false;
      bool in_q = false;
      T am_p = 0, am_q = 0, fm_p = 0, fm_q = 0, ph_p = 0, ph_q = 0;
      T M_p = 0, M_q = 0, er = 0, x1 = 0, scale = 1;
      T xn[4] = {0, 0, 0, 0}, y4[4] = {0, 0, 0, 0}, den[4] = {1, 1, 1, 1};
      bool start_0 = false;
      if (active && real) {
        const int p0 = (int)p, q = p0 + 1;
        const bool a_m2 = accepted(p0 - 2), a_m1 = accepted(p0 - 1);
        const bool a_p = accepted(p0), a_q = accepted(q);
        const bool a_q1 = accepted(q + 1), a_q2 = accepted(q + 2);
        am_p = am_at(p0); am_q = am_at(q);
        fm_p = fm_at(p0); fm_q = fm_at(q);
        ph_p = ph_at(p0); ph_q = ph_at(q);
        pair = a_p && a_q;
        in_q = a_q && (a_p || a_q1);
        start_q = a_q && !a_p && a_q1;
        end_q = a_q && a_p && !a_q1;
        start_0 = a_p && a_q;                  // row 0 of segment 0
        if (pair) {
          const int nl = 1 + (int)a_m1 + (int)(a_m1 && a_m2);
          const int nr = 1 + (int)a_q1 + (int)(a_q1 && a_q2);
          small = nl + nr < 4;
          if (small) {
            const int st = p0 - (nl - 1);
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
              y4[m] = fm_at(sl[m]);
            }
            x1 = x4[1];
            scale = fabs(x4[3] - x4[1]);
            // torch.clamp(min=1e-30): NaN stays NaN
            if (scale < T(1e-30)) scale = T(1e-30);
#pragma unroll
            for (int m = 0; m < 4; ++m) xn[m] = (x4[m] - x1) / scale;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              T d = one;
#pragma unroll
              for (int m = 0; m < 4; ++m)
                if (m != jj) d = d * (xn[jj] - xn[m]);
              den[jj] = d;
            }
          } else {
            M_p = Mc[(long long)p0 * Ctot];
            M_q = Mc[(long long)q * Ctot];
          }
        }
      }
      // fm at offset e (1..step-1) of a pair segment
      auto fm_fill = [&](int e) -> T {
        if (small) {
          const T qv = T((double)p) * h + T((double)e);
          const T qn = (qv - x1) / scale;
          T out = T(0);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            T num = one;
#pragma unroll
            for (int m = 0; m < 4; ++m)
              if (m != jj) num = num * (qn - xn[m]);
            out = out + y4[jj] * (num / den[jj]);
          }
          return out;
        }
        const T Bc = T((double)e) / h;
        const T Ac = one - Bc;
        return (Ac * fm_p + Bc * fm_q)
               + (((Ac * Ac * Ac - Ac) * M_p + (Bc * Bc * Bc - Bc) * M_q)
                  * hh) / six;
      };
      // pass 1: the segment's phase end, Mw and the correction
      if (pair) {
        T cs = T(0);
        for (int e = 1; e <= step; ++e)
          cs = cs + (e < step ? fm_fill(e) : fm_q);
        const T pm_end = ph_p + cs * c_ph;
        const T Mw = rint((pm_end - ph_q) / two_pi);
        er = (pi * ((pm_end - ph_q) - two_pi * Mw)) / two_h;
      }
      // pass 2: every row of the segment; the warps sum am cos(ph) per row
      T cs = T(0), prev = ph_p;
      for (int e = e_lo; e <= step; ++e) {
        const long long row = row_of(p, e);
        T v = T(0);
        if (active && row < L) {
          T o_am = 0, o_fm = 0, o_ph = 0, o_fmc = 0;
          if (!real) {
            // tail rows past Lp: zero harmonics
          } else if (e == 0) {
            o_am = am_p; o_fm = fm_p; o_ph = ph_p;
            o_fmc = start_0 ? fm_p : T(0);
            if (a.anchors) {
              const long long ai = ((long long)g * n) * K + k;
              a.anchors[ai] = am_p;
              a.anchors[plane + ai] = fm_p;
              a.anchors[2 * plane + ai] = ph_p;
            }
          } else if (e < step) {
            if (pair) {
              const T f = fm_fill(e);
              cs = cs + f;
              const T pm = ph_p + cs * c_ph;
              const T pmc = pm - er * a.bump[e - 1];
              const T Bc = T((double)e) / h;
              o_am = (one - Bc) * am_p + Bc * am_q;
              o_fm = f;
              o_ph = pmc;
              o_fmc = c_fm * wrap_phase(pmc - prev, pi, two_pi);
              prev = pmc;
            }
          } else {
            T ph2 = ph_q;
            if (pair) {
              cs = cs + fm_q;
              const T pmc = (ph_p + cs * c_ph) - er * a.bump[step - 1];
              if (end_q) ph2 = pmc;
            }
            o_am = am_q; o_fm = fm_q; o_ph = ph2;
            o_fmc = start_q ? fm_q
                    : in_q ? c_fm * wrap_phase(ph2 - prev, pi, two_pi)
                           : T(0);
            if (a.anchors) {
              const long long ai = ((long long)g * n + p + 1) * K + k;
              a.anchors[ai] = am_q;
              a.anchors[plane + ai] = fm_q;
              a.anchors[2 * plane + ai] = ph2;
            }
          }
          const long long o = out_base + row * K;
          a.am_out[o] = o_am;
          a.fmc_out[o] = o_fmc;
          if (a.fm_out) a.fm_out[o] = o_fm;
          if (a.ph_out) a.ph_out[o] = o_ph;
          v = o_am * cosine(o_ph);
        }
        v = warp_sum(v);
        if (lane == 0) red[(warp * a.TS + i) * E + e] += v;
      }
    }
  }
  __syncthreads();
  // per row: the warps' sums in order, the DC cubic, s and the DC outputs
  const T* y_dc = a.a0 + (long long)g * n;
  const uint8_t* vo = a.voiced ? a.voiced + (long long)g * n : nullptr;
  const T* Mdc = a.M + a.G * K + g;
  auto y_at = [&](int s) -> T {
    return (vo == nullptr || vo[s]) ? y_dc[s] : T(0);
  };
  for (int idx = tid; idx < a.TS * E; idx += blockDim.x) {
    const int i = idx / E, e = idx % E;
    const long long p = seg0 + i;
    if (p >= n_seg || (e == 0 && p != 0)) continue;
    const long long row = row_of(p, e);
    if (row >= L) continue;
    T sum = T(0);
    for (int w = 0; w < nwarps; ++w) sum = sum + red[(w * a.TS + i) * E + e];
    const long long pd = min(row / step, (long long)(n - 2));
    const T r = T((double)(row - pd * step));
    const T Bc = r / h, Ac = one - Bc;
    const T ys = y_at((int)pd), ye = y_at((int)pd + 1);
    const T Ms = Mdc[pd * Ctot], Me = Mdc[(pd + 1) * Ctot];
    const T dc = (Ac * ys + Bc * ye)
                 + (((Ac * Ac * Ac - Ac) * Ms + (Bc * Bc * Bc - Bc) * Me) * hh)
                       / six;
    a.s_out[(long long)g * L + row] = a.add_dc ? dc + two * sum : two * sum;
    if (a.a0_out) a.a0_out[(long long)g * L + row] = dc;
    if (a.a0_anchor && row % step == 0 && row / step < n)
      a.a0_anchor[(long long)g * n + row / step] = dc;
  }
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

// the masked std over the first nv samples of x - y (y null: of x)
template <typename T>
__device__ T masked_std(const T* x, const T* y, long long nv, T nf, T* red) {
  T s = T(0);
  for (long long l = threadIdx.x; l < nv; l += blockDim.x)
    s = s + (y ? x[l] - y[l] : x[l]);
  const T mu = block_sum(s, red) / nf;
  s = T(0);
  for (long long l = threadIdx.x; l < nv; l += blockDim.x) {
    const T d = (y ? x[l] - y[l] : x[l]) - mu;
    s = s + d * d;
  }
  return sqrt(block_sum(s, red) / nf);
}

template <typename T>
__global__ void __launch_bounds__(kSrerThreads)
track_srer(const T* det, const T* s, const long long* lens,
           const T* std_det, T* srer, long long L, long long det_sg,
           long long n_valid) {
  __shared__ T red[kSrerThreads / 32];
  const int g = blockIdx.x;
  long long nv = lens ? lens[g] : n_valid;
  nv = nv < L ? nv : L;
  const T nf = T((double)(nv > 1 ? nv : 1));
  const T* dg = det + g * det_sg;
  const T sd = masked_std(dg, s + g * L, nv > 0 ? nv : 0, nf, red);
  const T ref = std_det ? *std_det : masked_std(dg, (const T*)nullptr,
                                                nv > 0 ? nv : 0, nf, red);
  if (threadIdx.x == 0) srer[g] = T(20) * log10_(ref / sd);
}

template <typename T>
int spline_launch(const void* am, const void* fm, const void* acc,
                  const void* a0, const void* voiced, const void* ctab,
                  void* M, void* code, int G, int K, int n, long long sg,
                  long long sn, int step, void* stream) {
  if (G < 1 || K < 0 || n < 2 || step < 1) return (int)cudaErrorInvalidValue;
  SplineArgs<T> a{(const T*)am, (const T*)fm, (const uint8_t*)acc,
                  (const T*)a0, (const uint8_t*)voiced, (const T*)ctab,
                  (T*)M, (uint8_t*)code, G, K, n, sg, sn, (double)step};
  const int Ctot = G * K + G;
  int P = (n + 63) / 64;
  P = P < 1 ? 1 : (P > 128 ? 128 : P);
  dim3 block(kSplineCols, P);
  dim3 grid((Ctot + kSplineCols - 1) / kSplineCols);
  const size_t smem = 5 * (size_t)P * kSplineCols * sizeof(T);
  track_spline<T><<<grid, block, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int synth_threads(int K) {
  int t = ((K + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

int synth_tile(int threads, int step, int elem) {
  // segments a block: the warps' row sums fit in 24 KB of shared memory
  const int per = (threads / 32) * (step + 1) * elem;
  int ts = 24576 / per;
  return ts < 1 ? 1 : (ts > 8 ? 8 : ts);
}

template <typename T>
int synth_launch(const void* am, const void* fm, const void* ph,
                 const void* acc, const void* a0, const void* voiced,
                 const void* M, const void* bump, void* am_out,
                 void* fmc_out, void* fm_out, void* ph_out, void* anchors,
                 void* a0_anchor, void* s_out, void* a0_out, int G, int K,
                 int n, int step, long long L, long long sg, long long sn,
                 int add_dc, double fs, void* stream) {
  if (G < 1 || K < 0 || n < 2 || step < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const long long Lp = (long long)(n - 1) * step + 1;
  if (K > 0 && L < Lp) return (int)cudaErrorInvalidValue;
  const int threads = synth_threads(K);
  const int TS = synth_tile(threads, step, (int)sizeof(T));
  const size_t smem = (size_t)(threads / 32) * TS * (step + 1) * sizeof(T);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  SynthArgs<T> a{(const T*)am, (const T*)fm, (const T*)ph,
                 (const uint8_t*)acc, (const T*)a0, (const uint8_t*)voiced,
                 (const T*)M, (const T*)bump, (T*)am_out, (T*)fmc_out,
                 (T*)fm_out, (T*)ph_out, (T*)anchors, (T*)a0_anchor,
                 (T*)s_out, (T*)a0_out, G, K, n, step, TS, add_dc, L, sg, sn,
                 fs};
  const long long n_seg = (long long)(n - 1)
                          + (L > Lp ? (L - Lp + step - 1) / step : 0);
  dim3 grid((unsigned)((n_seg + TS - 1) / TS), G);
  track_synth<T><<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int srer_launch(const void* det, const void* s, const void* lens,
                const void* std_det, void* srer, int G, long long L,
                long long det_sg, long long n_valid, void* stream) {
  if (G < 1 || L < 1) return (int)cudaErrorInvalidValue;
  track_srer<T><<<G, kSrerThreads, 0, (cudaStream_t)stream>>>(
      (const T*)det, (const T*)s, (const long long*)lens,
      (const T*)std_det, (T*)srer, L, det_sg, n_valid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// track_spline (float32 / float64): am, fm [G, n, K] at strides (sg, sn, 1);
// acc [G, n, K] bytes or null; a0 [G, n]; voiced [G, n] bytes or null; ctab
// [49] -> M [n, G*K + G] (harmonic columns g*K + k, then the G DC columns),
// code [n, G*K + G] bytes (scratch).  Returns the cudaError_t of the launch.
int track_spline_f32(const void* am, const void* fm, const void* acc,
                     const void* a0, const void* voiced, const void* ctab,
                     void* M, void* code, int G, int K, int n, long long sg,
                     long long sn, int step, void* stream) {
  return spline_launch<float>(am, fm, acc, a0, voiced, ctab, M, code, G, K,
                              n, sg, sn, step, stream);
}

int track_spline_f64(const void* am, const void* fm, const void* acc,
                     const void* a0, const void* voiced, const void* ctab,
                     void* M, void* code, int G, int K, int n, long long sg,
                     long long sn, int step, void* stream) {
  return spline_launch<double>(am, fm, acc, a0, voiced, ctab, M, code, G, K,
                               n, sg, sn, step, stream);
}

// track_synth (float32 / float64): the inputs as track_spline's, ph beside
// am and fm, M from it, bump [step] (the cumulative sine bump) ->
// am_out, fmc_out [G, L, K]; fm_out, ph_out [G, L, K] or null (dense fm and
// ph); anchors [3, G, n, K] or null (the anchor rows of am, fm, corrected
// ph); a0_anchor [G, n] or null; s_out [G, L] (add_dc: a0 + 2 sum, else
// 2 sum); a0_out [G, L] or null (the DC track).  Returns the cudaError_t.
int track_synth_f32(const void* am, const void* fm, const void* ph,
                    const void* acc, const void* a0, const void* voiced,
                    const void* M, const void* bump, void* am_out,
                    void* fmc_out, void* fm_out, void* ph_out, void* anchors,
                    void* a0_anchor, void* s_out, void* a0_out, int G, int K,
                    int n, int step, long long L, long long sg, long long sn,
                    int add_dc, double fs, void* stream) {
  return synth_launch<float>(am, fm, ph, acc, a0, voiced, M, bump, am_out,
                             fmc_out, fm_out, ph_out, anchors, a0_anchor,
                             s_out, a0_out, G, K, n, step, L, sg, sn, add_dc,
                             fs, stream);
}

int track_synth_f64(const void* am, const void* fm, const void* ph,
                    const void* acc, const void* a0, const void* voiced,
                    const void* M, const void* bump, void* am_out,
                    void* fmc_out, void* fm_out, void* ph_out, void* anchors,
                    void* a0_anchor, void* s_out, void* a0_out, int G, int K,
                    int n, int step, long long L, long long sg, long long sn,
                    int add_dc, double fs, void* stream) {
  return synth_launch<double>(am, fm, ph, acc, a0, voiced, M, bump, am_out,
                              fmc_out, fm_out, ph_out, anchors, a0_anchor,
                              s_out, a0_out, G, K, n, step, L, sg, sn, add_dc,
                              fs, stream);
}

// track_srer (float32 / float64): det [G, L] (row stride det_sg), s [G, L],
// lens [G] int64 or null (then n_valid for every group), std_det [1] or
// null (then the masked std of det) -> srer [G].  Returns the cudaError_t.
int track_srer_f32(const void* det, const void* s, const void* lens,
                   const void* std_det, void* srer, int G, long long L,
                   long long det_sg, long long n_valid, void* stream) {
  return srer_launch<float>(det, s, lens, std_det, srer, G, L, det_sg,
                            n_valid, stream);
}

int track_srer_f64(const void* det, const void* s, const void* lens,
                   const void* std_det, void* srer, int G, long long L,
                   long long det_sg, long long n_valid, void* stream) {
  return srer_launch<double>(det, s, lens, std_det, srer, G, L, det_sg,
                             n_valid, stream);
}

}  // extern "C"
