// Batched Hermitian-positive-definite Cholesky factor-and-solve for Hopper.
//
// Replaces the Pallas TPU kernel eaqhm_tpu/ops/pallas_chol.py
// `_chol_solve_kernel` (driven by `chol_solve_planar` / `chol_solve`): for
// each of B equilibrated complex HPD systems R x = b (R [M, M], b [M]),
// factor R = L L^H and solve L y = b, L^H x = y.  Two entry points:
//   chol_factor_solve_*  factor + solve; optionally also writes the factor
//                        (row-packed lower triangle and its real diagonal);
//   chol_subst_*         both substitutions with a kept factor and a new
//                        right-hand side (the refinement step: one
//                        factorization per refined solve).
// Two pivot rules, chosen per call:
//   guard  the Pallas kernel's rsqrt(max(d, 1e-30)) (solve_method "pallas");
//   nan    a pivot <= 0 or NaN makes the system's x (and kept diagonal) NaN,
//          as jnp.linalg.cholesky does (solve_method "cholesky").
// In both, L[j, j] = d * rd and L[i, j] = (updated A[i, j]) * rd with
// rd = rsqrt(pivot), as in the Pallas kernel.
//
// What bounds it on an H100: a system does M^3/6 complex multiply-adds
// against M(M+1)/2 complex reads, about M/3 multiply-adds per element read,
// so at the main path's M = 130..194 the ideal kernel is bound by arithmetic
// in both types.  The design keeps the arithmetic's operands on chip:
//
// - Resident path: one block of 256 threads per system holds the lower
//   triangle, row-packed (row i at i(i+1)/2, i+1 entries), in shared memory
//   (up to 227 KB: complex64 up to M = 238, complex128 up to M = 167).  It is
//   loaded once from R with asynchronous copies (cp.async), row by row
//   (coalesced); several systems share an SM where they fit (complex64
//   M = 130: three).
// - Blocked right-looking factorization with panels of NB = 16 columns, two
//   barriers per panel (about 2M/16 per system, against 2M in a column loop):
//   (1) one warp factors the NB x NB diagonal block in registers (lane r holds
//       row r; the column values travel by warp shuffles);
//   (2) every thread solves one row of the panel below it, L21 = A21 L11^-H,
//       in registers against L11 read by broadcast; the forward substitution
//       L y = b rides along (one thread solves the block, step 3 updates the
//       rows below), so no separate forward sweep is needed;
//   (3) one rank-NB update of the trailing lower triangle in 16 x 16 warp
//       tiles (tiles above the diagonal are skipped; the lanes of a warp read
//       neighbouring rows, so the row-packed layout gives no bank conflicts):
//       each trailing element is read and written once per panel, not once
//       per column.  Look-ahead: warp 0 takes the tile of the next diagonal
//       block and factors it (step 1 of the next panel) while warps 1-7 do
//       the rest, so step 1 costs no barrier and leaves no warp idle.
//   complex64 runs in FP32 FMA on the CUDA cores, 4 x 2 register tiles per
//   lane (no TF32); complex128 on the FP64 tensor cores (mma.sync m8n8k4
//   f64, 2 x 2 tiles per warp, four real products per complex one).
//   A tile's elements are read before its products, so the latency of
//   shared memory overlaps the arithmetic.
// - Tiled path, for every order whose triangle does not fit (complex128
//   M > 167, complex64 M > 238; see chol_tiled_panel): one system spread
//   over the whole card by a sequence of launches, a panel launch and a
//   trailing-update launch per 64 columns and a backward-substitution launch
//   per 64 rows, each a grid over (system, 64-row tile) pairs; panels in
//   pairs (each trailing element read and written once per 128 columns),
//   complex128 on mma.sync m16n8k4.
// - The resident path's backward substitution L^H x = y, and both sweeps of
//   the substitution entry point's one-block kernel, are blocked the same
//   way: one warp solves each NB-row diagonal block with shuffles, then all
//   threads update the remaining rows (forward) or columns (backward), two
//   barriers per block.  The one-block kernel stages the packed factor in
//   shared memory (cp.async) at the resident sizes, reads it from device
//   memory with y in shared memory where y fits, and otherwise keeps y in x
//   as well.
// - The substitution entry point's tiled path, every M above one row block
//   (chol_plan.h subst_route), where B blocks of the one-block kernel leave
//   most of the card idle for its 2 M / 16 serial steps: each system spread
//   over the card, a forward launch per 64 rows (chol_subst_forward, a
//   block per 64-row tile below the block being solved) and a backward
//   launch per 64 rows (chol_subst_backward, the tiled path's backward
//   substitution on the kept factor), each launch started while the one
//   ahead ends (programmatic dependent launch).  Its bound is the factor's
//   bytes; its time, the chain of 64-row diagonal solves.  Above one row
//   block the one-block kernel runs only when asked for by name, as the
//   yardstick the tiled path is measured against.
//
// It takes any M >= 1 and any B: no padding to a panel width, no batch
// padding.  Complex values are interleaved (float2 / double2), which is the
// layout of torch.complex64 / torch.complex128.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <math.h>

#include <atomic>

#include "chol_plan.h"

#ifdef CHOL_PHASE_CLOCKS
// Profiling build only (tools/bench_chol_phases.py): thread 0 of each block
// of the resident kernel adds the cycles of each phase of its block's
// timeline, barrier waits included, to g_clk: 0 load, 1 diagonal block, 2
// panel rows, 3 trailing update with the next diagonal block (look-ahead),
// 4 backward substitution, 5 output, 7 blocks (6 unused); the first
// diagonal block counts in 1.
__device__ unsigned long long g_clk[8];
#define CLK_START long long clk_prev = clock64(); unsigned long long clk[8] = {0};
#define CLK_MARK(slot)                                       \
  if (tid == 0) {                                            \
    const long long now = clock64();                         \
    clk[slot] += now - clk_prev;                             \
    clk_prev = now;                                          \
  }
#define CLK_FLUSH_TO(dst)                                    \
  if (tid == 0) {                                            \
    clk[7] = 1;                                              \
    for (int q = 0; q < 8; ++q) atomicAdd(&dst[q], clk[q]);  \
  }
#define CLK_FLUSH CLK_FLUSH_TO(g_clk)
// The tiled path's kernels add theirs to g_tclk: 0 load of the panel
// kernels (chol_tiled_diag0, chol_tiled_panel), 1 their four steps, 2 the
// steps of the next diagonal block in the trailing update, 3 the panels'
// stores (L11, y1, L21), 4 trailing update (operand loads and products), 5
// its epilogue (the tile and y written), 6 backward substitution, 7 blocks
// of all four kernels.
__device__ unsigned long long g_tclk[8];
#define TCLK_FLUSH CLK_FLUSH_TO(g_tclk)
// The substitution with a kept factor (chol_subst_kernel, and the tiled
// substitution's chol_subst_forward / chol_subst_backward) adds its phases
// to g_sclk: 0 load (the staged factor, rhs, 1 / diag), 1 forward diagonal
// blocks, 2 forward row updates, 3 backward diagonal blocks, 4 backward
// column updates, 5 waits (barriers, and a tiled launch's wait for the
// launch ahead of it), 6 output, 7 blocks.
__device__ unsigned long long g_sclk[8];
#define SCLK_FLUSH CLK_FLUSH_TO(g_sclk)
#else
#define CLK_START
#define CLK_MARK(slot)
#define CLK_FLUSH
#define TCLK_FLUSH
#define SCLK_FLUSH
#endif

namespace {

template <typename T> struct Cplx;
template <> struct Cplx<float> {
  using type = float2;
  static constexpr int kMinBlocks = 3;   // complex64 M = 130: three per SM
};
template <> struct Cplx<double> {
  using type = double2;
  static constexpr int kMinBlocks = 1;
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int NB = 16;          // panel width
constexpr size_t kSmemMax = 232448;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }
template <typename T> __device__ __forceinline__ T nan_t();
template <> __device__ __forceinline__ float nan_t<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double nan_t<double>() {
  return __longlong_as_double(0x7ff8000000000000ll);
}

__host__ __device__ __forceinline__ long long tri_off(long long i) {
  return i * (i + 1) / 2;
}

// a -= x * y
template <typename C>
__device__ __forceinline__ void sub_mul(C& a, const C& x, const C& y) {
  a.x -= x.x * y.x - x.y * y.y;
  a.y -= x.x * y.y + x.y * y.x;
}
// a -= x * conj(y)
template <typename C>
__device__ __forceinline__ void sub_mul_conj(C& a, const C& x, const C& y) {
  a.x -= x.x * y.x + x.y * y.y;
  a.y -= x.y * y.x - x.x * y.y;
}
// a += x * conj(y)
template <typename C>
__device__ __forceinline__ void add_mul_conj(C& a, const C& x, const C& y) {
  a.x += x.x * y.x + x.y * y.y;
  a.y += x.y * y.x - x.x * y.y;
}
// the same as four fused multiply-adds (two a component)
template <typename C>
__device__ __forceinline__ void fma_mul_conj(C& a, const C& x, const C& y) {
  a.x = fma(x.x, y.x, a.x);
  a.x = fma(x.y, y.y, a.x);
  a.y = fma(x.y, y.x, a.y);
  a.y = fma(-x.x, y.y, a.y);
}
template <typename C, typename T>
__device__ __forceinline__ void scale(C& a, T s) {
  a.x *= s;
  a.y *= s;
}
template <typename C>
__device__ __forceinline__ C shfl(const C& v, int src) {
  C r;
  r.x = __shfl_sync(kFull, v.x, src);
  r.y = __shfl_sync(kFull, v.y, src);
  return r;
}

// d[0..1] += a * b on the FP64 tensor cores: one m8n8k4 product per warp
// (each lane passes its fragment elements).
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// Shared memory of the resident kernel: y [M] C, the triangle, rd [M] T,
// dinv [M] T, failure flag.
template <typename T>
size_t smem_bytes(int M) {
  using C = typename Cplx<T>::type;
  return (M + (size_t)tri_off(M)) * sizeof(C) + 2 * (size_t)M * sizeof(T) +
         16;
}

// A sweep's phase marks (SCLK slots; no-ops outside CHOL_PHASE_CLOCKS
// builds and for callers that pass none).
struct NoMark {
  __device__ void operator()(int) const {}
};

// dv[j] is 1 / L[j, j] (kInv false) or L[j, j] itself (kInv true).
template <typename T, bool kInv>
__device__ __forceinline__ T inv_diag(const T* dv, int j) {
  const T v = dv[j];
  return kInv ? T(1) / v : v;
}

// Forward L y = b, in place in y (shared or device memory).  L: row-packed
// lower triangle (shared or device memory), dv: its real diagonal or the
// inverse (kInv).  One warp solves each NB-row diagonal block with
// shuffles, then all threads update the rows below; all threads of the
// block call it.
template <typename T, bool kInv = false, typename MARK = NoMark>
__device__ void forward(const typename Cplx<T>::type* L, const T* dv,
                        typename Cplx<T>::type* y, int M,
                        MARK mark = MARK()) {
  using C = typename Cplx<T>::type;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const C zero = {T(0), T(0)};
  for (int j0 = 0; j0 < M; j0 += NB) {
    const int jb = min(NB, M - j0);
    if (tid < 32) {
      C v = lane < jb ? y[j0 + lane] : zero;
      const C* lr = L + tri_off(j0 + min(lane, jb - 1)) + j0;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        if (c < jb) {
          if (lane == c) scale(v, inv_diag<T, kInv>(dv, j0 + c));
          const C yc = shfl(v, c);
          if (lane > c && lane < jb) sub_mul(v, lr[c], yc);
        }
      }
      if (lane < jb) y[j0 + lane] = v;
    }
    mark(1);
    __syncthreads();
    mark(5);
    for (int i = j0 + jb + tid; i < M; i += kThreads) {
      const C* lr = L + tri_off(i) + j0;
      C s = y[i];
      for (int c = 0; c < jb; ++c)
        sub_mul(s, lr[c], y[j0 + c]);
      y[i] = s;
    }
    mark(2);
    __syncthreads();
    mark(5);
  }
}

// Backward L^H x = y, in place in y; the same blocking from the last block
// (row j of L is column j of L^H, read by neighbouring threads).
template <typename T, bool kInv = false, typename MARK = NoMark>
__device__ void backward(const typename Cplx<T>::type* L, const T* dv,
                         typename Cplx<T>::type* y, int M,
                         MARK mark = MARK()) {
  using C = typename Cplx<T>::type;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const C zero = {T(0), T(0)};
  for (int j0 = ((M - 1) / NB) * NB; j0 >= 0; j0 -= NB) {
    const int jb = min(NB, M - j0);
    if (tid < 32) {
      C v = lane < jb ? y[j0 + lane] : zero;
#pragma unroll
      for (int c = NB - 1; c >= 0; --c) {
        if (c < jb) {
          if (lane == c) scale(v, inv_diag<T, kInv>(dv, j0 + c));
          const C xc = shfl(v, c);
          // L^H[lane, c] = conj(L[c, lane])
          if (lane < c)
            sub_mul_conj(v, xc, L[tri_off(j0 + c) + j0 + lane]);
        }
      }
      if (lane < jb) y[j0 + lane] = v;
    }
    mark(3);
    __syncthreads();
    mark(5);
    for (int k = tid; k < j0; k += kThreads) {
      C s = y[k];
      for (int c = 0; c < jb; ++c)
        sub_mul_conj(s, y[j0 + c], L[tri_off(j0 + c) + k]);
      y[k] = s;
    }
    mark(4);
    __syncthreads();
    mark(5);
  }
}

// Factor a jb x jb diagonal block (jb <= NB; row r of the block starts at
// row(r)) in place, by one warp: lane r holds row r in registers and the
// column values travel by shuffles.  Writes rd[r] = rsqrt(pivot) and, where
// dv is given, dv[r] = 1 / L[r, r] (or L[r, r] itself with dv_plain) for the
// block's rows, and sets *flag (where given) on a failed pivot in the "nan"
// rule.
template <typename T, typename ROW>
__device__ void factor_block(ROW row, int jb, T* rd, T* dv, bool dv_plain,
                             int nan_mode, int* flag) {
  using C = typename Cplx<T>::type;
  const int r = threadIdx.x & 31;
  const C zero = {T(0), T(0)};
  C* pr = row(min(r, jb - 1));
  C a[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) a[c] = (r < jb && c <= r) ? pr[c] : zero;
  bool failed = false;
  T myd = T(1), myrd = T(1);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    if (c < jb) {
      const T d = __shfl_sync(kFull, a[c].x, c);
      T rdc;
      if (nan_mode) {
        failed |= !(d > T(0));
        rdc = rsqrt_t(d);
      } else {
        rdc = rsqrt_t(d < T(1e-30) ? T(1e-30) : d);   // NaN stays NaN
      }
      if (r == c) {
        a[c].x = d * rdc;
        a[c].y = T(0);
        myd = d * rdc;
        myrd = rdc;
      } else if (r > c) {
        scale(a[c], rdc);
      }
#pragma unroll
      for (int k = c + 1; k < NB; ++k) {
        const C lk = shfl(a[c], k);                     // L[j0 + k, j0 + c]
        if (k <= r && k < jb) sub_mul_conj(a[k], a[c], lk);
      }
    }
  }
  if (r < jb) {
#pragma unroll
    for (int c = 0; c < NB; ++c)
      if (c <= r) pr[c] = a[c];
    rd[r] = myrd;
    if (dv != nullptr) dv[r] = dv_plain ? myd : T(1) / myd;
  }
  if (failed && r == 0 && flag != nullptr) *flag = 1;
}

// The diagonal block at (j0, j0) of the packed triangle A.
template <typename T>
__device__ void factor_diagonal_block(typename Cplx<T>::type* A, int j0,
                                      int jb, T* rd, T* dv, bool dv_plain,
                                      int nan_mode, int* flag) {
  factor_block<T>([=](int r) { return A + tri_off(j0 + r) + j0; }, jb, rd,
                  dv, dv_plain, nan_mode, flag);
}

// complex128 tiles on the FP64 tensor cores: 2 x 2 tiles of mma.m8n8k4.f64
// per 16 x 16 warp tile, four real products per complex one.  Fragments
// (PTX ISA, m8n8k4 .f64): A[g][q], B[q][g], C[g][2q + e] with g = lane / 4,
// q = lane % 4.  The k operand of a tile, in B-fragment order: fb[c][h] is
// column 4c + q of panel row 8h + g of the k block (pk(k) for k < nk; the
// last valid row stands in for the rows past the matrix).
using KFrag = double2[NB / 4][2];

template <typename PK>
__device__ __forceinline__ void load_kfrag(KFrag& fb, PK pk, int nk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const double2* r = pk(min(8 * h + g, nk - 1));
#pragma unroll
    for (int c = 0; c < NB / 4; ++c) fb[c][h] = r[4 * c + q];
  }
}

// A[I0 + i, K0 + k] -= sum_c Pi[i][c] conj(Pk[k][c]) for one complex128
// tile whose k operand is loaded (fb); see update_tile.  The tile's
// elements are read first, so their latency overlaps the products.
template <typename PI, typename OUT>
__device__ __forceinline__ void tile_c128(PI pi, const KFrag& fb, OUT out,
                                          int ni, int I0, int K0) {
  using C = double2;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const C* pa[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pa[h] = pi(min(8 * h + g, ni - 1));
  C el[2][2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = 8 * u + g;
    if (i >= ni) continue;
    const C* row = out(i);
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * v + 2 * q + e;
        if (K0 + k <= I0 + i) el[u][v][e] = row[k];
      }
  }
  double cr[2][2][2], ci[2][2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int e = 0; e < 2; ++e) cr[u][v][e] = ci[u][v][e] = 0.0;
#pragma unroll
  for (int c = 0; c < NB / 4; ++c) {
    C fa[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) fa[h] = pa[h][4 * c + q];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        mma_f64(cr[u][v], fa[u].x, fb[c][v].x);
        mma_f64(cr[u][v], fa[u].y, fb[c][v].y);
        mma_f64(ci[u][v], fa[u].y, fb[c][v].x);
        mma_f64(ci[u][v], -fa[u].x, fb[c][v].y);
      }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = 8 * u + g;
    if (i >= ni) continue;
    C* row = out(i);
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * v + 2 * q + e;
        if (K0 + k <= I0 + i) {
          el[u][v][e].x -= cr[u][v][e];
          el[u][v][e].y -= ci[u][v][e];
          row[k] = el[u][v][e];
        }
      }
  }
}

// One 16 x 16 tile of the rank-NB trailing update, by one warp:
// A[I0 + i, K0 + k] -= sum_c Pi[i][c] conj(Pk[k][c]) over the NB panel
// columns, for the rows i < ni and the lower triangle K0 + k <= I0 + i.
// pi(i) / pk(k): the panel row (NB entries) of matrix row I0 + i / K0 + k,
// called with i < ni / k < nk only (the last valid row stands in for the
// rows past the matrix; their results are dropped); out(i): row I0 + i of
// the packed triangle from column K0.
template <typename T, typename PI, typename PK, typename OUT>
__device__ __forceinline__ void update_tile(PI pi, PK pk, OUT out, int ni,
                                            int nk, int I0, int K0) {
  using C = typename Cplx<T>::type;
  if constexpr (sizeof(T) == 8) {
    KFrag fb;
    load_kfrag(fb, pk, nk);
    tile_c128(pi, fb, out, ni, I0, K0);
  } else {
    // complex64 in FP32 FMA: lane (gi, gk) = (lane / 8, lane % 8) owns rows
    // gi + 4u (u < 4) and columns gk + 8v (v < 2) of the tile, so the lanes
    // of a warp read neighbouring panel rows (no bank conflicts).
    const int lane = threadIdx.x & 31;
    const int i0 = lane >> 3, k0 = lane & 7;
    const C zero = {0.f, 0.f};
    const C* pa[4];
    const C* pb[2];
#pragma unroll
    for (int u = 0; u < 4; ++u) pa[u] = pi(min(i0 + 4 * u, ni - 1));
#pragma unroll
    for (int v = 0; v < 2; ++v) pb[v] = pk(min(k0 + 8 * v, nk - 1));
    C el[4][2];                // the tile's elements, read first
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 4 * u;
      if (i >= ni) continue;
      const C* row = out(i);
#pragma unroll
      for (int v = 0; v < 2; ++v)
        if (K0 + k0 + 8 * v <= I0 + i) el[u][v] = row[k0 + 8 * v];
    }
    C acc[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) acc[u][v] = zero;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      C li[4], lk[2];
#pragma unroll
      for (int u = 0; u < 4; ++u) li[u] = pa[u][c];
#pragma unroll
      for (int v = 0; v < 2; ++v) lk[v] = pb[v][c];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) add_mul_conj(acc[u][v], li[u], lk[v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 4 * u;
      if (i >= ni) continue;
      C* row = out(i);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int k = k0 + 8 * v;
        if (K0 + k <= I0 + i) {
          el[u][v].x -= acc[u][v].x;
          el[u][v].y -= acc[u][v].y;
          row[k] = el[u][v];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Cplx<T>::kMinBlocks)
chol_factor_solve_kernel(const typename Cplx<T>::type* __restrict__ R,
                         const typename Cplx<T>::type* __restrict__ rhs,
                         typename Cplx<T>::type* __restrict__ x,
                         typename Cplx<T>::type* __restrict__ Lout,
                         T* __restrict__ dout, int M, int nan_mode) {
  using C = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* y = reinterpret_cast<C*>(smem_raw);             // [M] rhs -> y -> x
  C* A = y + M;                                      // the triangle
  T* rdv = reinterpret_cast<T*>(A + tri_off(M));
  T* dinv = rdv + M;                                 // [M] 1 / L[j, j]
  int* flag = reinterpret_cast<int*>(dinv + M);

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long P = tri_off(M);
  const C zero = {T(0), T(0)};
  CLK_START

  {    // asynchronous copies: all rows in flight at once
    const C* Rb = R + b * (long long)M * M;
    for (int i = warp; i < M; i += kWarps) {
      C* dst = A + tri_off(i);
      const C* src = Rb + (long long)i * M;
      for (int k = lane; k <= i; k += 32)
        __pipeline_memcpy_async(dst + k, src + k, sizeof(C));
    }
    for (int i = tid; i < M; i += kThreads) y[i] = rhs[b * M + i];
    if (tid == 0) *flag = 0;
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();
  CLK_MARK(0)
  if (warp == 0)
    factor_diagonal_block<T>(A, 0, min(NB, M), rdv, dinv, false, nan_mode,
                             flag);
  __syncthreads();
  CLK_MARK(1)

  for (int j0 = 0; j0 < M; j0 += NB) {
    const int jb = min(NB, M - j0);
    const int np = M - j0;                           // panel rows
    // row r of the panel (matrix row j0 + r, columns j0 ..)
    auto prow = [&](int r) -> C* { return A + tri_off(j0 + r) + j0; };

    // (2) panel rows below the diagonal block (factored in the previous
    //     step): L21 = A21 L11^-H, one row per thread; the last thread also
    //     solves L11 y1 = b1 (the forward substitution of this block, fused
    //     into the factorization)
    for (int r = jb + tid; r < np; r += kThreads) {
      C* pr = prow(r);
      C a[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) a[c] = c < jb ? pr[c] : zero;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        if (c < jb) {
          const C* lc = prow(c);
#pragma unroll
          for (int k = 0; k < c; ++k) sub_mul_conj(a[c], a[k], lc[k]);
          scale(a[c], rdv[j0 + c]);
        }
      }
#pragma unroll
      for (int c = 0; c < NB; ++c)
        if (c < jb) pr[c] = a[c];
    }
    if (tid == kThreads - 1) {
      for (int c = 0; c < jb; ++c) {
        const C* lc = prow(c);
        C v = y[j0 + c];
        for (int k = 0; k < c; ++k) sub_mul(v, lc[k], y[j0 + k]);
        scale(v, dinv[j0 + c]);
        y[j0 + c] = v;
      }
    }
    __syncthreads();
    CLK_MARK(2)

    // (3) trailing update A[i, k] -= sum_c L[i, c] conj(L[k, c]),
    //     j0 + jb <= k <= i < M, in 16 x 16 warp tiles of the lower
    //     triangle (update_tile).  Look-ahead: warp 0 takes tile (0, 0), the
    //     next diagonal block, and then factors it, while warps 1.. update
    //     the rest and the forward substitution's rows below: y2 -= L21 y1.
    //     A trailing update exists only below a full panel (jb == NB).
    const int n = np - jb;
    auto tile = [&](int t) {
      int bi = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while (bi * (bi + 1) / 2 > t) --bi;
      while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
      const int bk = t - bi * (bi + 1) / 2;
      const int ri = jb + 16 * bi, rk = jb + 16 * bk;    // panel rows
      update_tile<T>(
          [&](int i) -> const C* { return prow(ri + i); },
          [&](int k) -> const C* { return prow(rk + k); },
          [&](int i) -> C* { return A + tri_off(j0 + ri + i) + j0 + rk; },
          min(16, np - ri), min(16, np - rk), ri, rk);
    };
    if (warp == 0) {
      if (n > 0) {
        tile(0);
        __syncwarp();
        factor_diagonal_block<T>(A, j0 + jb, min(NB, n), rdv + j0 + jb,
                                 dinv + j0 + jb, false, nan_mode, flag);
      }
    } else {
      for (int r = jb + tid - 32; r < np; r += kThreads - 32) {
        const C* pr = prow(r);
        C v = y[j0 + r];
        for (int c = 0; c < jb; ++c) sub_mul(v, pr[c], y[j0 + c]);
        y[j0 + r] = v;
      }
      const int nbk = (n + 15) / 16;
      const int ntiles = nbk * (nbk + 1) / 2;
      for (int t = warp; t < ntiles; t += kWarps - 1) tile(t);
    }
    __syncthreads();
    CLK_MARK(3)
  }

  backward<T>(A, dinv, y, M);
  CLK_MARK(4)

  const bool bad = *flag != 0;
  const C cnan = {nan_t<T>(), nan_t<T>()};
  for (int i = tid; i < M; i += kThreads) x[b * M + i] = bad ? cnan : y[i];
  if (dout != nullptr)
    for (int i = tid; i < M; i += kThreads)
      dout[b * M + i] = bad ? nan_t<T>() : A[tri_off(i) + i].x;
  if (Lout != nullptr) {
    C* dst = Lout + b * P;
    for (long long e = tid; e < P; e += kThreads) dst[e] = A[e];
  }
  CLK_MARK(5)
  CLK_FLUSH
}

// The tiled path: one system spread over the card, for the orders where one
// block per system leaves SMs idle or moves too many bytes (path_of).  The
// packed triangle lives in the workspace Lw (the factor output), y in x,
// L[j, j] in dw, the current diagonal block's rsqrt pivots in wk [B][kTB].
// Per panel of kTB = 64 columns:
//   the diagonal block is factored by one block of 256 threads, in four
//   steps of NB = 16 columns (one warp factors the 16 x 16 diagonal
//   sub-block, a thread per row solves the rows below it, warp tiles update
//   the columns right of it: the resident path's in-panel work), which then
//   writes L11, L[j, j], rd and y1 = L11^-1 y1 (diag_finish).  The first
//   panel's is chol_tiled_diag0; every later one is taken by the block of
//   the previous trailing update that updates it, right after its update;
//   chol_tiled_panel   a block per 64-row tile of the panel below the
//                      diagonal block (blockIdx.y the system): its rows
//                      solved against the finished L11 in the same four
//                      steps (L21 = A21 L11^-H, each entry updated * rd);
//   chol_tiled_update  a block per 64 x 64 tile (I, K) of the trailing lower
//                      triangle of every system: A[I, K] -= L[I] L[K]^H
//                      over the panel columns it takes (depth 64 or 128),
//                      both operands streamed through a two-stage cp.async
//                      ring of 16 columns (the products of one chunk run
//                      while the next arrives), 84 KB a block, so two
//                      blocks share an SM and one's loads and stores run
//                      under the other's products; complex128 on mma.sync
//                      m16n8k4 (a warp 16 x 32 of the tile, four real
//                      products per complex one), complex64 on FP32 FFMA (a
//                      thread 4 x 4 entries, four FFMA a complex product);
//                      the tile's entries are staged in the ring's space
//                      after the products (in registers they spilled).  The
//                      diagonal tiles also take y2 -= L21 y1 for their
//                      rows; tile (0, 0), the next diagonal block, is then
//                      factored in place (above).
// The panels go in pairs (p, p + 1): panel p's rows, the update of the
// first column of tiles right of it with panel p alone (depth 64), panel
// p + 1's rows, then the update of every tile right of both with both
// (depth 128); a last panel without a partner updates all it has to (depth
// 64).  So each trailing element is read and written once per 128 columns
// (about M^3/384 accesses a system, an eighth of the 16-column paths'),
// and the launches stay two a panel: 32 bytes of device memory (complex128)
// against 1024 flops a visit, above the card's 20 flops a byte, so the
// update is bound by its arithmetic, not its bytes.  No launch reads what
// another block of the same launch writes.  The first panel's launches read
// R itself (its lower triangle), so R is copied into the workspace by the
// launches that update it.  Then one launch per 64-row block u, from the
// last, runs the backward substitution (chol_tiled_backward): a
// block per 64-column chunk c <= u subtracts block u + 1's finished x from
// its chunk (four row groups, summed in order), and the block of chunk u
// then solves its diagonal block with one warp from a staged copy.  In the
// "nan" rule a failed pivot leaves L[j, j] NaN (rsqrt of a pivot <= 0 or
// NaN), and the last launch turns x and the diagonal of every system with a
// NaN on its diagonal to NaN.  The sequence is chol_plan.h's
// tiled_schedule: 3 ceil(M / 64) - 1 launches a call (for each 65535
// systems); no host synchronisation, nothing allocated, every
// launch's grid a function of (B, M): a CUDA graph captures the sequence.
constexpr int kTB = chol_plan::kTB;      // panel width and tile edge
constexpr int kPL = kTB + 1;             // panel kernels' staged row stride
// update kernel's: complex128 fragments read rows g and g + 1 at columns q
// (a stride of 4 mod 8 double2 keeps each quarter warp on its own banks)
template <typename T>
constexpr int kUL = sizeof(T) == 8 ? kTB + 4 : kTB + 1;

// row of the lower-triangle index t (t = row (row + 1) / 2 + col)
__device__ __forceinline__ int tri_row(int t) {
  int r = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (r * (r + 1) / 2 > t) --r;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  return r;
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d[0..3] += a * b on the FP64 tensor cores, one m16n8k4 product per warp.
// Fragments (PTX ISA, m16n8k4 .f64): A[g][q] and A[g + 8][q], B[q][g],
// C[g][2q + e] and C[g + 8][2q + e], g = lane / 4, q = lane % 4.
__device__ __forceinline__ void mma16_f64(double (&d)[4], double a0,
                                          double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// The four NB-column steps of a 64-column panel, on staged rows: row(r) is
// column 0 of the panel in staged row r; rows 0..jb-1 the diagonal block
// (lower triangle), rows kTB..kTB+nown-1 rows below it.  With factor, the
// diagonal block is factored (its rsqrt pivots to rd) and the own rows
// solved with it; without, the diagonal block is already L11 (and rd its
// pivots) and only the own rows are solved.  All threads of the block call
// it; it ends with a barrier.
template <typename T, typename ROW>
__device__ void panel_steps(ROW row, int jb, int nown, T* rd, bool factor,
                            int nan_mode) {
  using C = typename Cplx<T>::type;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const C zero = {T(0), T(0)};
  for (int c0 = 0; c0 < jb; c0 += NB) {
    const int sb = min(NB, jb - c0);
    if (factor) {
      if (warp == 0)
        factor_block<T>([&](int r) { return row(c0 + r) + c0; }, sb,
                        rd + c0, (T*)nullptr, false, nan_mode,
                        (int*)nullptr);
      __syncthreads();
    }
    // rows below the sub-block, in its columns: L21 = A21 L11^-H
    const int nd = jb - c0 - sb;                     // columns right of it
    const int ndr = factor ? nd : 0;                 // diagonal-block rows
    for (int w = tid; w < ndr + nown; w += kThreads) {
      C* pr = (w < ndr ? row(c0 + sb + w) : row(kTB + w - ndr)) + c0;
      C a[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) a[c] = c < sb ? pr[c] : zero;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        if (c < sb) {
          const C* lc = row(c0 + c) + c0;
#pragma unroll
          for (int k = 0; k < c; ++k) sub_mul_conj(a[c], a[k], lc[k]);
          scale(a[c], rd[c0 + c]);
        }
      }
#pragma unroll
      for (int c = 0; c < NB; ++c)
        if (c < sb) pr[c] = a[c];
    }
    __syncthreads();
    // the panel's columns right of the sub-block: rank-16 update in 16 x 16
    // warp tiles, the diagonal block's lower tiles (factor) and every tile
    // of the own rows
    if (nd > 0) {
      const int ncg = (nd + NB - 1) / NB;
      const int ntd = factor ? ncg * (ncg + 1) / 2 : 0;
      const int nt = ntd + ((nown + NB - 1) / NB) * ncg;
      for (int tt = warp; tt < nt; tt += kWarps) {
        int ri, ni, kg, I0, K0;
        if (tt < ntd) {
          const int gi = tri_row(tt);
          kg = tt - gi * (gi + 1) / 2;
          ri = c0 + sb + NB * gi;
          ni = min(NB, jb - ri);
          I0 = ri;
          K0 = c0 + sb + NB * kg;
        } else {
          const int u = tt - ntd, gi = u / ncg;
          kg = u - gi * ncg;
          ri = kTB + NB * gi;
          ni = min(NB, nown - NB * gi);
          I0 = 1 << 20;                              // every column
          K0 = 0;
        }
        const int ck = c0 + sb + NB * kg;
        update_tile<T>(
            [&](int i) -> const C* { return row(ri + i) + c0; },
            [&](int k) -> const C* { return row(ck + k) + c0; },
            [&](int i) -> C* { return row(ri + i) + ck; }, ni,
            min(NB, jb - ck), I0, K0);
      }
    }
    __syncthreads();
  }
}

// After panel_steps factored the diagonal block at (j0, j0) (rows row(r),
// pivots rd): L11 to the workspace A, L[j, j] to dg, rd to wk, and
// y1 = L11^-1 y1 from ys to y (one warp, lane l rows l and l + 32).
template <typename T, typename ROW>
__device__ void diag_finish(ROW row, int jb, int j0, const T* rd,
                            typename Cplx<T>::type* A, T* dg, T* wk,
                            const typename Cplx<T>::type* ys,
                            typename Cplx<T>::type* y) {
  using C = typename Cplx<T>::type;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const C zero = {T(0), T(0)};
  for (int e = tid; e < jb * jb; e += kThreads) {
    const int r = e / jb, c = e - r * jb;
    if (c <= r) A[tri_off(j0 + r) + j0 + c] = row(r)[c];
  }
  for (int r = tid; r < jb; r += kThreads) {
    dg[j0 + r] = row(r)[r].x;
    wk[r] = rd[r];
  }
  if (tid < 32) {
    C v0 = lane < jb ? ys[j0 + lane] : zero;
    C v1 = lane + 32 < jb ? ys[j0 + lane + 32] : zero;
    // 1 / L[r, r] of the lane's rows, ahead of the serial loop
    const T inv0 = lane < jb ? T(1) / row(lane)[lane].x : T(1);
    const T inv1 = lane + 32 < jb ? T(1) / row(lane + 32)[lane + 32].x : T(1);
    for (int c = 0; c < jb; ++c) {
      C yc;
      if (c < 32) {
        if (lane == c) scale(v0, inv0);
        yc = shfl(v0, c);
      } else {
        if (lane == c - 32) scale(v1, inv1);
        yc = shfl(v1, c - 32);
      }
      if (lane > c && lane < jb) sub_mul(v0, row(lane)[c], yc);
      if (lane + 32 > c && lane + 32 < jb)
        sub_mul(v1, row(lane + 32)[c], yc);
    }
    if (lane < jb) y[j0 + lane] = v0;
    if (lane + 32 < jb) y[j0 + lane + 32] = v1;
  }
}

template <typename T>
size_t tiled_panel_smem() {       // the diagonal block, 64 own rows, rd
  using C = typename Cplx<T>::type;
  return 2 * kTB * kPL * sizeof(C) + kTB * sizeof(T);
}

// The update kernel's operand ring: two stages of kChunk columns of X and
// Y; its row stride (complex128 4 mod 8 double2, as kUL; complex64 odd).
// After the products the same space holds the next diagonal block
// (stride kUL) while it is factored.
constexpr int kChunk = 16;
template <typename T>
constexpr int kRL = sizeof(T) == 8 ? kChunk + 4 : kChunk + 1;
template <typename T>
constexpr int kUpdRegion = 4 * kTB * kRL<T> > kTB * kUL<T>
                               ? 4 * kTB * kRL<T> : kTB * kUL<T>;

template <typename T>
size_t tiled_update_smem() {      // the ring (or the block), rd
  using C = typename Cplx<T>::type;
  return (size_t)kUpdRegion<T> * sizeof(C) + kTB * sizeof(T);
}

// The first panel's diagonal block, from R: a block per system.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_tiled_diag0(const typename Cplx<T>::type* __restrict__ R,
                 const typename Cplx<T>::type* __restrict__ rhs,
                 typename Cplx<T>::type* __restrict__ x,
                 typename Cplx<T>::type* __restrict__ Lw,
                 T* __restrict__ dw, T* __restrict__ wk, int M,
                 int nan_mode) {
  using C = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* S = reinterpret_cast<C*>(smem_raw);             // [kTB][kPL]
  T* rd = reinterpret_cast<T*>(S + 2 * kTB * kPL);   // [kTB]
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int jb = min(kTB, M);
  const C* Rb = R + b * (long long)M * M;
  auto row = [&](int r) -> C* { return S + r * kPL; };
  CLK_START
  for (int e = tid; e < jb * jb; e += kThreads) {
    const int r = e / jb, c = e - r * jb;
    if (c <= r)
      __pipeline_memcpy_async(row(r) + c, Rb + (long long)r * M + c,
                              sizeof(C));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  CLK_MARK(0)
  panel_steps<T>(row, jb, 0, rd, true, nan_mode);
  CLK_MARK(1)
  diag_finish<T>(row, jb, 0, rd, Lw + b * tri_off(M), dw + b * M,
                 wk + b * kTB, rhs + b * M, x + b * M);
  CLK_MARK(3)
  TCLK_FLUSH
}

// A panel's rows below its diagonal block: tile t = blockIdx.x + 1 of the
// panel at column j0 (rows j0 + 64 t ..), system blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_tiled_panel(const typename Cplx<T>::type* __restrict__ R,
                 typename Cplx<T>::type* __restrict__ Lw,
                 const T* __restrict__ wk, int M, int j0) {
  using C = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* S = reinterpret_cast<C*>(smem_raw);             // [2 kTB][kPL]
  T* rd = reinterpret_cast<T*>(S + 2 * kTB * kPL);   // [kTB]
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int jb = kTB;                                // rows below: full
  const int r0 = j0 + kTB * (blockIdx.x + 1);
  const int nown = min(kTB, M - r0);
  C* A = Lw + b * tri_off(M);
  const C* Rb = R + b * (long long)M * M;
  auto row = [&](int r) -> C* { return S + r * kPL; };
  CLK_START
  for (int e = tid; e < jb * jb; e += kThreads) {    // L11, finished
    const int r = e / jb, c = e - r * jb;
    if (c <= r)
      __pipeline_memcpy_async(row(r) + c, A + tri_off(j0 + r) + j0 + c,
                              sizeof(C));
  }
  for (int e = tid; e < nown * jb; e += kThreads) {
    const int r = e / jb, c = e - r * jb;
    __pipeline_memcpy_async(row(kTB + r) + c,
                            j0 == 0 ? Rb + (long long)(r0 + r) * M + c
                                    : A + tri_off(r0 + r) + j0 + c,
                            sizeof(C));
  }
  __pipeline_commit();
  if (tid < jb) rd[tid] = wk[b * kTB + tid];
  __pipeline_wait_prior(0);
  __syncthreads();
  CLK_MARK(0)
  panel_steps<T>(row, jb, nown, rd, false, 0);
  CLK_MARK(1)
  for (int e = tid; e < nown * jb; e += kThreads) {
    const int r = e / jb, c = e - r * jb;
    A[tri_off(r0 + r) + j0 + c] = row(kTB + r)[c];
  }
  CLK_MARK(3)
  TCLK_FLUSH
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chol_tiled_update(const typename Cplx<T>::type* __restrict__ R,
                  const typename Cplx<T>::type* __restrict__ rhs,
                  typename Cplx<T>::type* __restrict__ x,
                  typename Cplx<T>::type* __restrict__ Lw,
                  T* __restrict__ dw, T* __restrict__ wk, int M, int j0,
                  int depth, int col_only, int nan_mode) {
  using C = typename Cplx<T>::type;
  constexpr int RL = kRL<T>, LD = kUL<T>;
  constexpr int kStage = 2 * kTB * RL;               // X then Y, 16 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* ring = reinterpret_cast<C*>(smem_raw);          // [2][kStage]
  T* rd = reinterpret_cast<T*>(ring + kUpdRegion<T>);  // [kTB]
  const int t = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bi = col_only ? t : tri_row(t);
  const int bk = col_only ? 0 : t - bi * (bi + 1) / 2;
  const int I = j0 + depth + kTB * bi, K = j0 + depth + kTB * bk;
  const int ni = min(kTB, M - I), nk = min(kTB, M - K);
  const int nchunk = depth / kChunk;
  const bool diag = bi == bk;
  const bool next = t == 0;          // the next panel's diagonal block
  C* A = Lw + b * tri_off(M);
  const C* Rb = R + b * (long long)M * M;
  const bool first = j0 == 0;
  auto live = [&](int i, int k) {
    return i < ni && k < nk && (!diag || k <= i);
  };
  // the tile's entries (R in the first panel's update) into the ring's
  // space once the products are done (Cs, stride LD), read back by the
  // thread that updates each: the latency under the other block of the SM
  C* Cs = ring;
  auto stage_tile = [&]() {
    for (int e = tid; e < kTB * kTB; e += kThreads) {
      const int i = e / kTB, k = e % kTB;
      if (live(i, k))
        __pipeline_memcpy_async(
            Cs + i * LD + k,
            first ? Rb + (long long)(I + i) * M + K + k
                  : A + tri_off(I + i) + K + k,
            sizeof(C));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  };
  // the updated entry: to the workspace, or for the next diagonal block,
  // which is factored below, in place in Cs
  auto put = [&](int i, int k, const C& v) {
    if (next) Cs[i * LD + k] = v;
    else A[tri_off(I + i) + K + k] = v;
  };
  // columns j0 + 16 g .. of rows I.. and K.. into stage g % 2
  auto issue = [&](int g) {
    C* st = ring + (g & 1) * kStage;
#pragma unroll
    for (int e = tid; e < kTB * kChunk; e += kThreads) {
      const int r = e / kChunk, c = e % kChunk;
      const long long col = j0 + kChunk * g + c;
      if (r < ni)
        __pipeline_memcpy_async(st + r * RL + c, A + tri_off(I + r) + col,
                                sizeof(C));
      if (!diag && r < nk)
        __pipeline_memcpy_async(st + (kTB + r) * RL + c,
                                A + tri_off(K + r) + col, sizeof(C));
    }
    __pipeline_commit();
  };
  CLK_START
  issue(0);
  issue(1);                          // depth >= 2 chunks

  if constexpr (sizeof(T) == 8) {
    // warp (wr, wc): rows 16 wr.., columns 32 wc.. of the tile; lane
    // entries (16 wr + g + 8 h, 32 wc + 8 n + 2 q + e)
    const int wr = warp >> 1, wc = warp & 1;
    const int g = lane >> 2, q = lane & 3;
    double cr[4][4], ci[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) cr[n][e] = ci[n][e] = 0.0;
#pragma unroll 1
    for (int gc = 0; gc < nchunk; ++gc) {
      if (gc + 1 < nchunk) cp_wait<1>();
      else cp_wait<0>();
      __syncthreads();
      const C* Xs = ring + (gc & 1) * kStage;
      const C* Ys = diag ? Xs : Xs + kTB * RL;
      const C* xa = Xs + (16 * wr + g) * RL + q;
      const C* yb = Ys + (32 * wc + g) * RL + q;
#pragma unroll
      for (int s = 0; s < kChunk / 4; ++s) {
        const C a0 = xa[4 * s], a1 = xa[8 * RL + 4 * s];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const C bb = yb[8 * n * RL + 4 * s];
          mma16_f64(cr[n], a0.x, a1.x, bb.x);
          mma16_f64(cr[n], a0.y, a1.y, bb.y);
          mma16_f64(ci[n], a0.y, a1.y, bb.x);
          mma16_f64(ci[n], -a0.x, -a1.x, bb.y);
        }
      }
      __syncthreads();
      if (gc + 2 < nchunk) issue(gc + 2);
    }
    CLK_MARK(4)
    stage_tile();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 16 * wr + g + 8 * h, k = 32 * wc + 8 * n + 2 * q + e;
          if (live(i, k)) {
            C v = Cs[i * LD + k];
            v.x -= cr[n][2 * h + e];
            v.y -= ci[n][2 * h + e];
            put(i, k, v);
          }
        }
  } else {
    // thread (ty, tx): rows ty + 16 u, columns tx + 16 v of the tile
    const int ty = tid >> 4, tx = tid & 15;
    C acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v].x = acc[u][v].y = 0.f;
#pragma unroll 1
    for (int gc = 0; gc < nchunk; ++gc) {
      if (gc + 1 < nchunk) cp_wait<1>();
      else cp_wait<0>();
      __syncthreads();
      const C* Xs = ring + (gc & 1) * kStage;
      const C* Ys = diag ? Xs : Xs + kTB * RL;
#pragma unroll 4
      for (int c = 0; c < kChunk; ++c) {
        C li[4], lk[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) li[u] = Xs[(ty + 16 * u) * RL + c];
#pragma unroll
        for (int v = 0; v < 4; ++v) lk[v] = Ys[(tx + 16 * v) * RL + c];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) fma_mul_conj(acc[u][v], li[u], lk[v]);
      }
      __syncthreads();
      if (gc + 2 < nchunk) issue(gc + 2);
    }
    CLK_MARK(4)
    stage_tile();
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = ty + 16 * u, k = tx + 16 * v;
        if (live(i, k)) {
          C w = Cs[i * LD + k];
          w.x -= acc[u][v].x;
          w.y -= acc[u][v].y;
          put(i, k, w);
        }
      }
  }
  if (diag && tid < ni) {      // y2 -= L21 y1 on this tile's rows (L2)
    const C* pr = A + tri_off(I + tid) + j0;
    const C* y1 = x + b * M + j0;
    C v = (first ? rhs : x)[b * M + I + tid];
#pragma unroll 8
    for (int c = 0; c < depth; ++c) sub_mul(v, pr[c], y1[c]);
    x[b * M + I + tid] = v;
  }
  CLK_MARK(5)
  if (next) {                  // factor the next panel's diagonal block
    __syncthreads();
    auto row = [&](int r) -> C* { return ring + r * LD; };
    panel_steps<T>(row, ni, 0, rd, true, nan_mode);
    CLK_MARK(2)
    diag_finish<T>(row, ni, I, rd, A, dw + b * M, wk + b * kTB, x + b * M,
                   x + b * M);
    CLK_MARK(3)
  }
  TCLK_FLUSH
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_tiled_backward(typename Cplx<T>::type* __restrict__ x,
                    const typename Cplx<T>::type* __restrict__ Lw,
                    T* __restrict__ dw, int M, int u, int nan_mode) {
  using C = typename Cplx<T>::type;
  __shared__ __align__(16) C Ld[kTB * (kTB + 1) / 2];   // diagonal block
  __shared__ C part[kThreads / kTB][kTB];
  const int c = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nbk = (M + kTB - 1) / kTB;
  const int k0 = kTB * c, nkc = min(kTB, M - k0);
  const C zero = {T(0), T(0)};
  C* y = x + b * M;
  const C* A = Lw + b * tri_off(M);
  T* dg = dw + b * M;
  CLK_START
  if (c == u) {              // staged while the update below runs
    for (int r = warp; r < nkc; r += kWarps)
      for (int k = lane; k <= r; k += 32)
        __pipeline_memcpy_async(Ld + tri_off(r) + k,
                                A + tri_off(k0 + r) + k0 + k, sizeof(C));
    __pipeline_commit();
  }
  if (u + 1 < nbk) {
    // x[k] -= sum_j conj(L[j, k]) x[j] over block u + 1's rows j, for the
    // chunk's k: row group jg takes rows jg, jg + 4, ..; groups in order
    const int s0 = kTB * (u + 1), ns = min(kTB, M - s0);
    const int kk = tid % kTB, jg = tid / kTB;
    C acc = zero;
    if (kk < nkc) {
#pragma unroll 4
      for (int j = jg; j < ns; j += kThreads / kTB)
        add_mul_conj(acc, y[s0 + j], A[tri_off(s0 + j) + k0 + kk]);
    }
    part[jg][kk] = acc;
    __syncthreads();
    if (tid < nkc) {
      C v = y[k0 + tid];
#pragma unroll
      for (int r = 0; r < kThreads / kTB; ++r) {
        v.x -= part[r][tid].x;
        v.y -= part[r][tid].y;
      }
      y[k0 + tid] = v;
    }
  }
  if (c == u) {              // L_uu^H x_u = y_u: lane l holds rows l, l + 32
    __pipeline_wait_prior(0);
    __syncthreads();
    if (warp == 0) {
      C v0 = lane < nkc ? y[k0 + lane] : zero;
      C v1 = lane + 32 < nkc ? y[k0 + lane + 32] : zero;
      // 1 / L[r, r] of the lane's rows, ahead of the serial loop
      const int l1 = lane + 32;
      const T inv0 = lane < nkc ? T(1) / Ld[tri_off(lane) + lane].x : T(1);
      const T inv1 = l1 < nkc ? T(1) / Ld[tri_off(l1) + l1].x : T(1);
      for (int r = nkc - 1; r >= 0; --r) {
        const C* lr = Ld + tri_off(r);
        C xr;
        if (r < 32) {
          if (lane == r) scale(v0, inv0);
          xr = shfl(v0, r);
        } else {
          if (lane == r - 32) scale(v1, inv1);
          xr = shfl(v1, r - 32);
        }
        // L^H[l, r] = conj(L[r, l])
        if (lane < r) sub_mul_conj(v0, xr, lr[lane]);
        if (lane + 32 < r) sub_mul_conj(v1, xr, lr[lane + 32]);
      }
      if (lane < nkc) y[k0 + lane] = v0;
      if (lane + 32 < nkc) y[k0 + lane + 32] = v1;
    }
  }
  if (u == 0 && nan_mode) {  // this block is its system's last
    __syncthreads();
    int bad = 0;
    for (int i = tid; i < M; i += kThreads) bad |= !(dg[i] == dg[i]);
    if (__syncthreads_or(bad)) {
      const C cnan = {nan_t<T>(), nan_t<T>()};
      for (int i = tid; i < M; i += kThreads) {
        y[i] = cnan;
        dg[i] = nan_t<T>();
      }
    }
  }
  CLK_MARK(6)
  TCLK_FLUSH
}

// The tiled substitution with a kept factor (packed Lw, diagonal dw): a
// forward launch per 64-row block u, then a backward launch per 64-row
// block u from the last (chol_plan.h subst_schedule).  Each launch's
// critical path is the block that solves block u's diagonal block: the
// strip of L it applies, its diagonal block and the kept diagonal are read
// before the launch waits for its predecessor (a programmatic dependent
// launch: the launch before lets it start at once, griddepcontrol), so
// only x's 64 finished entries and the serial solve are left after the
// wait; one warp solves the diagonal block, lane l rows l and l + 32, from
// a copy in shared memory laid out so the lanes of a step read
// neighbouring entries, with the reciprocals of the kept diagonal taken
// ahead of the loop.  Every row's sums go in one fixed order, whatever B or
// the grid, and no block reads what another block of its launch writes.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
// x as the launch ahead left it: read at the L2 cache, not through the
// SM's L1, which may hold lines of x that a launch running beside this one
// on the same SM read before the launch ahead wrote them
template <typename C>
__device__ __forceinline__ C ld_x(const C* p) {
  return __ldcg(p);
}

// Column c of a 64 x 64 lower triangle stored by columns (rows c..63
// contiguous): entry (r, c) at col_off(c) + r - c.
__device__ __forceinline__ int col_off(int c) {
  return c * kTB - c * (c - 1) / 2;
}

// Forward launch u, block (tile t = u + blockIdx.x, system blockIdx.y).  For
// u >= 1 every tile t >= u subtracts L[t, u - 1] y_{u - 1} from its rows: a
// warp per row (rows w, w + 8, .. of the tile for warp w), lane l reading
// columns l and l + 32 of the strip (a row's 64 entries are contiguous in
// the packed layout, so each load is one coalesced row segment), the two
// products summed by the lane and the 32 lane sums by a butterfly of
// shuffles.  Tile u then solves its diagonal block (stored by columns) and
// writes y_u to x.  The rows' values come from rhs until launch 1 has
// written them (tiles t >= 1 are first touched there), from x after.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_subst_forward(const typename Cplx<T>::type* __restrict__ Lw,
                   const T* __restrict__ dw,
                   const typename Cplx<T>::type* __restrict__ rhs,
                   typename Cplx<T>::type* __restrict__ x, int M, int u) {
  using C = typename Cplx<T>::type;
  constexpr int kRows = kTB / kWarps;                 // rows a warp updates
  __shared__ __align__(16) C Lc[kTB * (kTB + 1) / 2];   // by columns
  __shared__ C yu[kTB];                               // tile u's rows
  pdl_launch_dependents();
  const int t = u + blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = kTB * t, nr = min(kTB, M - r0);
  const bool diag = t == u;
  const C zero = {T(0), T(0)};
  const C* A = Lw + b * tri_off(M);
  C* y = x + b * M;
  const C* src = (u <= 1 ? rhs : x) + b * M;
  CLK_START
  T dl0 = T(1), dl1 = T(1);  // warp 0 of the diagonal block: L[r, r]
  if (diag) {                // staged while the update below runs
    for (int r = warp; r < nr; r += kWarps)
      for (int k = lane; k <= r; k += 32)
        __pipeline_memcpy_async(Lc + col_off(k) + r - k,
                                A + tri_off(r0 + r) + r0 + k, sizeof(C));
    __pipeline_commit();
    if (warp == 0) {
      if (lane < nr) dl0 = dw[b * M + r0 + lane];
      if (lane + 32 < nr) dl1 = dw[b * M + r0 + lane + 32];
    }
  }
  const int rq = warp + kWarps * lane;                // lane q < kRows: row
  const bool own = lane < kRows && rq < nr;
  if (u > 0) {
    const int c0 = kTB * (u - 1);                     // a full block
    C la[kRows], lb[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const C* row = A + tri_off(r0 + min(warp + kWarps * q, nr - 1)) + c0;
      la[q] = row[lane];
      lb[q] = row[lane + 32];
    }
    CLK_MARK(2)
    pdl_wait();              // y_{u - 1} and the rows' values are ready
    CLK_MARK(5)
    const C ya = ld_x(y + c0 + lane), yb = ld_x(y + c0 + lane + 32);
    const C cur = own ? ld_x(src + r0 + rq) : zero;
    C acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      acc[q].x = la[q].x * ya.x - la[q].y * ya.y;
      acc[q].y = la[q].x * ya.y + la[q].y * ya.x;
      acc[q].x = fma(lb[q].x, yb.x, acc[q].x);
      acc[q].x = fma(-lb[q].y, yb.y, acc[q].x);
      acc[q].y = fma(lb[q].x, yb.y, acc[q].y);
      acc[q].y = fma(lb[q].y, yb.x, acc[q].y);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        acc[q].x += __shfl_xor_sync(kFull, acc[q].x, off);
        acc[q].y += __shfl_xor_sync(kFull, acc[q].y, off);
      }
    C tot = zero;            // lane q < kRows: row rq's sum
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      if (lane == q) tot = acc[q];
    if (own) {
      C v = cur;
      v.x -= tot.x;
      v.y -= tot.y;
      if (diag) yu[rq] = v;
      else y[r0 + rq] = v;
    }
  } else {                   // launch 0: tile 0 alone, from rhs
    pdl_wait();
    CLK_MARK(5)
    if (own) yu[rq] = ld_x(src + rq);
  }
  CLK_MARK(2)
  if (diag) {                // L_uu y_u = yu: lane l holds rows l, l + 32
    __pipeline_wait_prior(0);
    __syncthreads();
    CLK_MARK(5)
    if (warp == 0) {
      const int l1 = lane + 32;
      C v0 = lane < nr ? yu[lane] : zero;
      C v1 = l1 < nr ? yu[l1] : zero;
      const T inv0 = T(1) / dl0, inv1 = T(1) / dl1;
#pragma unroll
      for (int c = 0; c < kTB; ++c) {
        if (c < nr) {
          // column c's rows lane and lane + 32 (in bounds for every lane)
          const C* col = Lc + col_off(c) - c;
          const C a0 = col[lane], a1 = col[l1];
          C yc;
          if (c < 32) {
            if (lane == c) scale(v0, inv0);
            yc = shfl(v0, c);
          } else {
            if (lane == c - 32) scale(v1, inv1);
            yc = shfl(v1, c - 32);
          }
          if (lane > c && lane < nr) sub_mul(v0, a0, yc);
          if (l1 > c && l1 < nr) sub_mul(v1, a1, yc);
        }
      }
      if (lane < nr) y[r0 + lane] = v0;
      if (l1 < nr) y[r0 + l1] = v1;
    }
    CLK_MARK(1)
  }
  SCLK_FLUSH
}

// Backward launch u, block (64-column chunk c <= u, system blockIdx.y): as
// chol_tiled_backward on the kept factor, the diagonal's reciprocals from
// the kept diagonal dw (as the one-block kernel and the plain version read
// it) and no "nan" pass.  Chunk c subtracts block u + 1's finished x from
// its entries (row group jg takes rows jg, jg + 4, ..; the four groups'
// sums subtracted in order), and the block of chunk u then solves L_uu^H
// x_u = y_u from a copy of its diagonal block stored by rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_subst_backward(typename Cplx<T>::type* __restrict__ x,
                    const typename Cplx<T>::type* __restrict__ Lw,
                    const T* __restrict__ dw, int M, int u) {
  using C = typename Cplx<T>::type;
  constexpr int kGroups = kThreads / kTB;
  __shared__ __align__(16) C Ld[kTB * (kTB + 1) / 2];   // by rows
  __shared__ C part[kGroups][kTB];
  __shared__ C ys[kTB];                               // chunk u's entries
  pdl_launch_dependents();
  const int c = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nbk = (M + kTB - 1) / kTB;
  const int k0 = kTB * c, nkc = min(kTB, M - k0);
  const bool diag = c == u;
  const C zero = {T(0), T(0)};
  C* y = x + b * M;
  const C* A = Lw + b * tri_off(M);
  CLK_START
  T dl0 = T(1), dl1 = T(1);
  if (diag) {                // staged while the update below runs
    for (int r = warp; r < nkc; r += kWarps)
      for (int k = lane; k <= r; k += 32)
        __pipeline_memcpy_async(Ld + tri_off(r) + k,
                                A + tri_off(k0 + r) + k0 + k, sizeof(C));
    __pipeline_commit();
    if (warp == 0) {
      if (lane < nkc) dl0 = dw[b * M + k0 + lane];
      if (lane + 32 < nkc) dl1 = dw[b * M + k0 + lane + 32];
    }
  }
  const int kk = tid % kTB, jg = tid / kTB;
  if (u + 1 < nbk) {
    // x[k] -= sum_j conj(L[j, k]) x[j] over block u + 1's rows j
    const int s0 = kTB * (u + 1), ns = min(kTB, M - s0);
    C lj[kTB / kGroups];
#pragma unroll
    for (int q = 0; q < kTB / kGroups; ++q) {
      const int j = min(jg + kGroups * q, ns - 1);
      lj[q] = A[tri_off(s0 + j) + k0 + min(kk, nkc - 1)];
    }
    CLK_MARK(4)
    pdl_wait();              // block u + 1's x and this chunk's y are ready
    CLK_MARK(5)
    const C cur = tid < nkc ? ld_x(y + k0 + tid) : zero;
    C acc = zero;
#pragma unroll
    for (int q = 0; q < kTB / kGroups; ++q) {
      const int j = jg + kGroups * q;
      if (j < ns) add_mul_conj(acc, ld_x(y + s0 + j), lj[q]);
    }
    part[jg][kk] = acc;
    __syncthreads();
    if (tid < nkc) {
      C v = cur;
#pragma unroll
      for (int r = 0; r < kGroups; ++r) {
        v.x -= part[r][tid].x;
        v.y -= part[r][tid].y;
      }
      if (diag) ys[tid] = v;
      else y[k0 + tid] = v;
    }
  } else {                   // the last block: no x below it
    pdl_wait();
    CLK_MARK(5)
    if (tid < nkc) ys[tid] = ld_x(y + k0 + tid);
  }
  CLK_MARK(4)
  if (diag) {                // L_uu^H x_u = y_u: lane l holds rows l, l + 32
    __pipeline_wait_prior(0);
    __syncthreads();
    CLK_MARK(5)
    if (warp == 0) {
      const int l1 = lane + 32;
      C v0 = lane < nkc ? ys[lane] : zero;
      C v1 = l1 < nkc ? ys[l1] : zero;
      const T inv0 = T(1) / dl0, inv1 = T(1) / dl1;
#pragma unroll
      for (int r = kTB - 1; r >= 0; --r) {
        if (r < nkc) {
          // row r's columns lane and lane + 32 (in bounds for every lane)
          const C* lr = Ld + tri_off(r);
          const C a0 = lr[lane], a1 = lr[l1];
          C xr;
          if (r < 32) {
            if (lane == r) scale(v0, inv0);
            xr = shfl(v0, r);
          } else {
            if (lane == r - 32) scale(v1, inv1);
            xr = shfl(v1, r - 32);
          }
          // L^H[l, r] = conj(L[r, l])
          if (lane < r) sub_mul_conj(v0, xr, a0);
          if (l1 < r) sub_mul_conj(v1, xr, a1);
        }
      }
      if (lane < nkc) y[k0 + lane] = v0;
      if (l1 < nkc) y[k0 + l1] = v1;
    }
    CLK_MARK(3)
  }
  SCLK_FLUSH
}

// Both substitutions with a kept factor.  kMode 0 (the factor's resident
// sizes): the packed factor is copied to shared memory with asynchronous
// copies first, so the serial sweeps run at shared-memory latency; 1: the
// factor is read from device memory, y and 1 / diag in shared memory; 2
// (y does not fit): y in x, the diagonal read from d.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
chol_subst_kernel(const typename Cplx<T>::type* __restrict__ L,
                  const T* __restrict__ d,
                  const typename Cplx<T>::type* __restrict__ rhs,
                  typename Cplx<T>::type* __restrict__ x, int M) {
  using C = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long b = blockIdx.x;
  const long long P = tri_off(M);
  const C* Lb = L + b * P;
  [[maybe_unused]] const int tid = threadIdx.x;
  CLK_START
  auto mark = [&](int slot) {
    (void)slot;
    CLK_MARK(slot)
  };
  if constexpr (kMode == 2) {
    C* y = x + b * M;
    for (int i = threadIdx.x; i < M; i += kThreads) y[i] = rhs[b * M + i];
    __syncthreads();
    CLK_MARK(0)
    forward<T, true>(Lb, d + b * M, y, M, mark);
    backward<T, true>(Lb, d + b * M, y, M, mark);
    SCLK_FLUSH
    return;
  } else {
    C* y = reinterpret_cast<C*>(smem_raw);
    C* Ls = y + M;                                   // [M(M+1)/2] if staged
    T* dinv = reinterpret_cast<T*>(Ls + (kMode == 0 ? tri_off(M) : 0));
    if (kMode == 0) {
      for (long long e = threadIdx.x; e < P; e += kThreads)
        __pipeline_memcpy_async(Ls + e, Lb + e, sizeof(C));
      __pipeline_commit();
    }
    for (int i = threadIdx.x; i < M; i += kThreads) {
      y[i] = rhs[b * M + i];
      dinv[i] = T(1) / d[b * M + i];
    }
    if (kMode == 0) __pipeline_wait_prior(0);
    __syncthreads();
    CLK_MARK(0)
    const C* Lu = kMode == 0 ? Ls : Lb;
    forward<T, false>(Lu, dinv, y, M, mark);
    backward<T, false>(Lu, dinv, y, M, mark);
    for (int i = threadIdx.x; i < M; i += kThreads) x[b * M + i] = y[i];
    CLK_MARK(6)
    SCLK_FLUSH
  }
}

template <typename K>
int prepare(K kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

// Opt every kernel of this file in to the largest dynamic shared memory,
// once per device (cudaFuncSetAttribute applies to the current device
// only): at the first launch on a device, or in chol_prepare ahead of a
// CUDA graph capture.  A launch after that makes no CUDA call besides
// cudaGetDevice and the launch itself, so it is captured as it is.  The
// per-device flags are atomics: threads driving other devices, or the same
// one, may prepare at once (setting an attribute twice is harmless).
constexpr int kMaxDevices = 64;
std::atomic<int> g_prepared[kMaxDevices];

int prepare_all() {
  int dev = 0;
  const cudaError_t g = cudaGetDevice(&dev);
  if (g != cudaSuccess) return (int)g;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (g_prepared[dev].load(std::memory_order_acquire)) return 0;
  int e = prepare(chol_factor_solve_kernel<float>);
  if (!e) e = prepare(chol_factor_solve_kernel<double>);
  if (!e) e = prepare(chol_subst_kernel<float, 0>);
  if (!e) e = prepare(chol_subst_kernel<float, 1>);
  if (!e) e = prepare(chol_subst_kernel<float, 2>);
  if (!e) e = prepare(chol_subst_kernel<double, 0>);
  if (!e) e = prepare(chol_subst_kernel<double, 1>);
  if (!e) e = prepare(chol_subst_kernel<double, 2>);
  if (!e) e = prepare(chol_tiled_diag0<float>);
  if (!e) e = prepare(chol_tiled_diag0<double>);
  if (!e) e = prepare(chol_tiled_panel<float>);
  if (!e) e = prepare(chol_tiled_panel<double>);
  if (!e) e = prepare(chol_tiled_update<float>);
  if (!e) e = prepare(chol_tiled_update<double>);
  if (!e) g_prepared[dev].store(1, std::memory_order_release);
  return e;
}

enum Path { kResidentPath = 0, kTiledPath = 1 };

// Routing, by measurement (tools/torch_chol_route.py on an NVIDIA H100 80GB
// HBM3 at 700.00 W; the table is in PERF.md): the resident path wherever
// the triangle fits (one block a system wins there), the tiled path above.
template <typename T>
int path_of(int M) {
  if (M <= 0) return -1;
  return smem_bytes<T>(M) <= kSmemMax ? kResidentPath : kTiledPath;
}

// The tiled path's launch sequence (chol_plan.h tiled_schedule), over the
// systems in groups of at most kMaxGridY (the grids' y extent); stops at
// the first launch that fails.
template <typename T>
int launch_tiled(const void* R, const void* rhs, void* x, void* L, void* d,
                 void* wk, int B, int M, int nan_mode, cudaStream_t s) {
  using C = typename Cplx<T>::type;
  using chol_plan::Launch;
  for (int b0 = 0; b0 < B; b0 += chol_plan::kMaxGridY) {
    const int nb = min(chol_plan::kMaxGridY, B - b0);
    const C* Rg = (const C*)R + (long long)b0 * M * M;
    const C* rg = (const C*)rhs + (long long)b0 * M;
    C* xg = (C*)x + (long long)b0 * M;
    C* Lg = (C*)L + (long long)b0 * tri_off(M);
    T* dg = (T*)d + (long long)b0 * M;
    T* wg = (T*)wk + (long long)b0 * kTB;
    const int e = chol_plan::tiled_schedule(M, [&](const Launch& l) {
      const dim3 grid(l.blocks, nb);
      switch (l.kind) {
        case chol_plan::kDiag0:
          chol_tiled_diag0<T><<<nb, kThreads, tiled_panel_smem<T>(), s>>>(
              Rg, rg, xg, Lg, dg, wg, M, nan_mode);
          break;
        case chol_plan::kPanel:
          chol_tiled_panel<T><<<grid, kThreads, tiled_panel_smem<T>(), s>>>(
              Rg, Lg, wg, M, l.p * kTB);
          break;
        case chol_plan::kUpdate:
          chol_tiled_update<T><<<grid, kThreads, tiled_update_smem<T>(),
                                 s>>>(Rg, rg, xg, Lg, dg, wg, M, l.p * kTB,
                                      l.depth, l.col_only, nan_mode);
          break;
        default:
          chol_tiled_backward<T><<<grid, kThreads, 0, s>>>(xg, Lg, dg, M,
                                                           l.p, nan_mode);
      }
      return (int)cudaGetLastError();
    });
    if (e) return e;
  }
  return 0;
}

template <typename T>
int launch_factor_solve(const void* R, const void* rhs, void* x, void* L,
                        void* d, void* wk, int B, int M, int nan_mode,
                        int path, void* stream) {
  using C = typename Cplx<T>::type;
  if (B <= 0) return 0;
  if (M <= 0) return (int)cudaErrorInvalidValue;
  if (path < 0) path = path_of<T>(M);
  const bool fits = path == kResidentPath ? smem_bytes<T>(M) <= kSmemMax
                                          : path == kTiledPath;
  if (!fits) return (int)cudaErrorInvalidValue;
  if (path == kTiledPath && (L == nullptr || d == nullptr || wk == nullptr))
    return (int)cudaErrorInvalidValue;
  const int e = prepare_all();
  if (e) return e;
  cudaStream_t s = (cudaStream_t)stream;
  if (path == kTiledPath)
    return launch_tiled<T>(R, rhs, x, L, d, wk, B, M, nan_mode, s);
  chol_factor_solve_kernel<T><<<B, kThreads, smem_bytes<T>(M), s>>>(
      (const C*)R, (const C*)rhs, (C*)x, (C*)L, (T*)d, M, nan_mode);
  return (int)cudaGetLastError();
}

enum SubstPath { kOneBlock = 0, kTiledSubst = 1 };

// The tiled substitution's launch sequence (chol_plan.h subst_schedule),
// over the systems in groups of at most kMaxGridY; stops at the first
// launch that fails.
template <typename T>
int launch_subst_tiled(const void* L, const void* d, const void* rhs,
                       void* x, int B, int M, cudaStream_t s) {
  using C = typename Cplx<T>::type;
  using chol_plan::Launch;
  for (int b0 = 0; b0 < B; b0 += chol_plan::kMaxGridY) {
    const int nb = min(chol_plan::kMaxGridY, B - b0);
    const C* Lg = (const C*)L + (long long)b0 * tri_off(M);
    const T* dg = (const T*)d + (long long)b0 * M;
    const C* rg = (const C*)rhs + (long long)b0 * M;
    C* xg = (C*)x + (long long)b0 * M;
    bool first = true;
    const int e = chol_plan::subst_schedule(M, [&](const Launch& l) {
      // every launch but a group's first may start before the one ahead of
      // it ends (its kernels wait for it before they read x)
      cudaLaunchAttribute pdl;
      pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
      pdl.val.programmaticStreamSerializationAllowed = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(l.blocks, nb);
      cfg.blockDim = dim3(kThreads);
      cfg.stream = s;
      cfg.attrs = &pdl;
      cfg.numAttrs = first ? 0 : 1;
      first = false;
      const cudaError_t err =
          l.kind == chol_plan::kForward
              ? cudaLaunchKernelEx(&cfg, chol_subst_forward<T>, Lg,
                                   dg, rg, xg, M, l.p)
              : cudaLaunchKernelEx(&cfg, chol_subst_backward<T>, xg, Lg,
                                   dg, M, l.p);
      return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
    });
    if (e) return e;
  }
  return 0;
}

// path: -1 the route's (chol_plan.h subst_route), or a SubstPath.
template <typename T>
int launch_subst(const void* L, const void* d, const void* rhs, void* x, int B,
                 int M, int path, void* stream) {
  using C = typename Cplx<T>::type;
  if (B <= 0) return 0;
  if (M <= 0 || path < -1 || path > kTiledSubst)
    return (int)cudaErrorInvalidValue;
  const int e = prepare_all();
  if (e) return e;
  cudaStream_t s = (cudaStream_t)stream;
  if (path < 0) path = chol_plan::subst_route(M);
  if (path == kTiledSubst)
    return launch_subst_tiled<T>(L, d, rhs, x, B, M, s);
  const size_t staged = ((size_t)M + tri_off(M)) * sizeof(C) + M * sizeof(T);
  const size_t vec = (size_t)M * (sizeof(C) + sizeof(T));
  if (path_of<T>(M) == kResidentPath && staged <= kSmemMax) {
    chol_subst_kernel<T, 0><<<B, kThreads, staged, s>>>(
        (const C*)L, (const T*)d, (const C*)rhs, (C*)x, M);
  } else if (vec <= kSmemMax) {
    chol_subst_kernel<T, 1><<<B, kThreads, vec, s>>>(
        (const C*)L, (const T*)d, (const C*)rhs, (C*)x, M);
  } else {
    chol_subst_kernel<T, 2><<<B, kThreads, 0, s>>>(
        (const C*)L, (const T*)d, (const C*)rhs, (C*)x, M);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Set the kernels' shared-memory attributes on the current device now
// (launches do it at first use otherwise).  Returns the cudaError_t (0 on
// success).
int chol_prepare() { return prepare_all(); }

// Profiling build: copies the phase clocks (see CHOL_PHASE_CLOCKS) to
// out[8] and zeroes them; -1 in the normal build.
int chol_phase_clocks(unsigned long long* out) {
#ifdef CHOL_PHASE_CLOCKS
  cudaError_t e = cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[8] = {0};
  return (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(g_clk));
#else
  (void)out;
  return -1;
#endif
}

// The same for the tiled path's kernels (g_tclk).
int chol_tiled_clocks(unsigned long long* out) {
#ifdef CHOL_PHASE_CLOCKS
  cudaError_t e = cudaMemcpyFromSymbol(out, g_tclk, sizeof(g_tclk));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[8] = {0};
  return (int)cudaMemcpyToSymbol(g_tclk, zero, sizeof(g_tclk));
#else
  (void)out;
  return -1;
#endif
}

// The same for the substitution with a kept factor (g_sclk).
int chol_subst_clocks(unsigned long long* out) {
#ifdef CHOL_PHASE_CLOCKS
  cudaError_t e = cudaMemcpyFromSymbol(out, g_sclk, sizeof(g_sclk));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[8] = {0};
  return (int)cudaMemcpyToSymbol(g_sclk, zero, sizeof(g_sclk));
#else
  (void)out;
  return -1;
#endif
}

// Which path a system of order M takes: 0 resident (triangle in shared
// memory), 1 tiled (a sequence of launches spreading each system over the
// card); -1 for M < 1.
int chol_path(int M, int c128) {
  return c128 ? path_of<double>(M) : path_of<float>(M);
}

// R: [B, M, M], rhs / x: [B, M] complex64.  L: [B, M(M+1)/2] packed factor
// out (may be NULL on the resident path; required on the tiled path, where
// it is the workspace), d: [B, M] float32 real diagonal out (may be NULL on
// the resident path; required on the tiled path), wk: [B, 64] float32
// scratch of the tiled path (NULL on the resident).  nan_mode: 0 guard, 1
// NaN on a failed pivot.  path: -1 for chol_path's choice, or 0-1 to ask
// for one (refused where it does not fit).  Returns the cudaError_t
// of the launch (0 on success; the tiled path's launches stop at the first
// that fails).
int chol_factor_solve_c64(const void* R, const void* rhs, void* x, void* L,
                          void* d, void* wk, int B, int M, int nan_mode,
                          int path, void* stream) {
  return launch_factor_solve<float>(R, rhs, x, L, d, wk, B, M, nan_mode,
                                    path, stream);
}

// The same for complex128 (d and wk float64).
int chol_factor_solve_c128(const void* R, const void* rhs, void* x, void* L,
                           void* d, void* wk, int B, int M, int nan_mode,
                           int path, void* stream) {
  return launch_factor_solve<double>(R, rhs, x, L, d, wk, B, M, nan_mode,
                                     path, stream);
}

// x = (L L^H)^-1 rhs with a factor from chol_factor_solve_c64 (L the
// packed triangle, d its real diagonal).  path: -1 for chol_subst_route's
// choice, 0 the one-block kernel (one launch, a block a system), 1 the
// tiled substitution (chol_subst_plan's launches).  Returns the
// cudaError_t of the launches (0 on success; the tiled substitution's
// launches stop at the first that fails).
int chol_subst_c64(const void* L, const void* d, const void* rhs, void* x,
                   int B, int M, int path, void* stream) {
  return launch_subst<float>(L, d, rhs, x, B, M, path, stream);
}

int chol_subst_c128(const void* L, const void* d, const void* rhs, void* x,
                    int B, int M, int path, void* stream) {
  return launch_subst<double>(L, d, rhs, x, B, M, path, stream);
}

}  // extern "C"
