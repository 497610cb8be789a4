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
// - Global path, for sizes whose triangle does not fit (complex128 M > 167,
//   complex64 M > 238): the same blocked algorithm over a packed triangle in a
//   device-memory workspace (the factor output), with each panel staged in
//   shared memory (row stride NB + 1 against bank conflicts) so the rank-NB
//   update reads its operands on chip and streams each trailing element once
//   per panel (about M/16 passes over the triangle, which stay in L2 while
//   the batch's workspaces fit its 50 MB).  The wrapper picks the path from
//   (type, M) via chol_path().
// - Backward substitution L^H x = y, and both sweeps of the substitution
//   entry point, are blocked the same way: one warp solves each NB-row
//   diagonal block with shuffles, then all threads update the remaining rows
//   (forward) or columns (backward), two barriers per block.  The
//   substitution entry point stages the packed factor in shared memory
//   (cp.async) at the resident sizes and reads it from device memory
//   otherwise, on the same (type, M) rule.
//
// It takes any M and any B: no padding to a panel width, no batch padding.
// Complex values are interleaved (float2 / double2), which is the layout of
// torch.complex64 / torch.complex128.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <math.h>

#include <atomic>

#ifdef CHOL_PHASE_CLOCKS
// Profiling build only (tools/bench_chol_phases.py): thread 0 of each block
// adds the cycles of each phase of its block's timeline, barrier waits
// included, to g_clk: 0 load, 1 diagonal block, 2 panel rows, 3 trailing
// update with the next diagonal block (look-ahead), 4 panel staging, 5
// backward substitution, 6 output, 7 blocks; the first diagonal block counts
// in 1.
__device__ unsigned long long g_clk[8];
#define CLK_START long long clk_prev = clock64(); unsigned long long clk[8] = {0};
#define CLK_MARK(slot)                                       \
  if (tid == 0) {                                            \
    const long long now = clock64();                         \
    clk[slot] += now - clk_prev;                             \
    clk_prev = now;                                          \
  }
#define CLK_FLUSH                                            \
  if (tid == 0) {                                            \
    clk[7] = 1;                                              \
    for (int q = 0; q < 8; ++q) atomicAdd(&g_clk[q], clk[q]); \
  }
#else
#define CLK_START
#define CLK_MARK(slot)
#define CLK_FLUSH
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
constexpr int kPS = NB + 1;     // staged panel row stride (global path)
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

template <typename T>
size_t smem_bytes(int M, bool resident) {
  using C = typename Cplx<T>::type;
  const size_t store = resident ? (size_t)tri_off(M) : (size_t)M * kPS;
  // y [M] C, triangle or panel, rd [M] T, dinv [M] T, failure flag
  return (M + store) * sizeof(C) + 2 * (size_t)M * sizeof(T) + 16;
}

// Forward L y = b, in place in y (shared memory).  L: row-packed lower
// triangle (shared or device memory), dinv: 1 / its real diagonal.  One warp
// solves each NB-row diagonal block with shuffles, then all threads update
// the rows below; all threads of the block call it.
template <typename T>
__device__ void forward(const typename Cplx<T>::type* L, const T* dinv,
                        typename Cplx<T>::type* y, int M) {
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
          if (lane == c) scale(v, dinv[j0 + c]);
          const C yc = shfl(v, c);
          if (lane > c && lane < jb) sub_mul(v, lr[c], yc);
        }
      }
      if (lane < jb) y[j0 + lane] = v;
    }
    __syncthreads();
    for (int i = j0 + jb + tid; i < M; i += kThreads) {
      const C* lr = L + tri_off(i) + j0;
      C s = y[i];
      for (int c = 0; c < jb; ++c) sub_mul(s, lr[c], y[j0 + c]);
      y[i] = s;
    }
    __syncthreads();
  }
}

// Backward L^H x = y, in place in y; the same blocking from the last block
// (row j of L is column j of L^H, read by neighbouring threads).
template <typename T>
__device__ void backward(const typename Cplx<T>::type* L, const T* dinv,
                         typename Cplx<T>::type* y, int M) {
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
          if (lane == c) scale(v, dinv[j0 + c]);
          const C xc = shfl(v, c);
          // L^H[lane, c] = conj(L[c, lane])
          if (lane < c) sub_mul_conj(v, xc, L[tri_off(j0 + c) + j0 + lane]);
        }
      }
      if (lane < jb) y[j0 + lane] = v;
    }
    __syncthreads();
    for (int k = tid; k < j0; k += kThreads) {
      C s = y[k];
      for (int c = 0; c < jb; ++c)
        sub_mul_conj(s, y[j0 + c], L[tri_off(j0 + c) + k]);
      y[k] = s;
    }
    __syncthreads();
  }
}

// Factor the jb x jb diagonal block at (j0, j0) of the packed triangle A in
// place, by one warp: lane r holds row j0 + r in registers and the column
// values travel by shuffles.  Writes rd = rsqrt(pivot) and 1 / L[j, j] for
// the block's columns, and sets *flag on a failed pivot in the "nan" rule.
template <typename T>
__device__ void factor_diagonal_block(typename Cplx<T>::type* A, int j0,
                                      int jb, T* rdv, T* dinv, int nan_mode,
                                      int* flag) {
  using C = typename Cplx<T>::type;
  const int r = threadIdx.x & 31;
  const C zero = {T(0), T(0)};
  C* pr = A + tri_off(j0 + min(r, jb - 1)) + j0;
  C a[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) a[c] = (r < jb && c <= r) ? pr[c] : zero;
  bool failed = false;
  T myd = T(1), myrd = T(1);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    if (c < jb) {
      const T d = __shfl_sync(kFull, a[c].x, c);
      T rd;
      if (nan_mode) {
        failed |= !(d > T(0));
        rd = rsqrt_t(d);
      } else {
        rd = rsqrt_t(d < T(1e-30) ? T(1e-30) : d);   // NaN stays NaN
      }
      if (r == c) {
        a[c].x = d * rd;
        a[c].y = T(0);
        myd = d * rd;
        myrd = rd;
      } else if (r > c) {
        scale(a[c], rd);
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
    rdv[j0 + r] = myrd;
    dinv[j0 + r] = T(1) / myd;
  }
  if (failed && r == 0) *flag = 1;
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads, Cplx<T>::kMinBlocks)
chol_factor_solve_kernel(const typename Cplx<T>::type* __restrict__ R,
                         const typename Cplx<T>::type* __restrict__ rhs,
                         typename Cplx<T>::type* __restrict__ x,
                         typename Cplx<T>::type* __restrict__ Lout,
                         T* __restrict__ dout, int M, int nan_mode) {
  using C = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* y = reinterpret_cast<C*>(smem_raw);             // [M] rhs -> y -> x
  C* S = y + M;                                      // triangle or panel
  T* rdv = reinterpret_cast<T*>(S + (kResident ? tri_off(M) : (long long)M * kPS));
  T* dinv = rdv + M;                                 // [M] 1 / L[j, j]
  int* flag = reinterpret_cast<int*>(dinv + M);

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long P = tri_off(M);
  const C zero = {T(0), T(0)};
  // the packed triangle: shared memory, or the device-memory factor output
  C* A = kResident ? S : Lout + b * P;
  CLK_START

  {
    const C* Rb = R + b * (long long)M * M;
    for (int i = warp; i < M; i += kWarps) {
      C* dst = A + tri_off(i);
      const C* src = Rb + (long long)i * M;
      if (kResident) {   // asynchronous copies: all rows in flight at once
        for (int k = lane; k <= i; k += 32)
          __pipeline_memcpy_async(dst + k, src + k, sizeof(C));
      } else {
#pragma unroll 4
        for (int k = lane; k <= i; k += 32) dst[k] = src[k];
      }
    }
    for (int i = tid; i < M; i += kThreads) y[i] = rhs[b * M + i];
    if (tid == 0) *flag = 0;
    if (kResident) {
      __pipeline_commit();
      __pipeline_wait_prior(0);
    }
  }
  __syncthreads();
  CLK_MARK(0)
  if (warp == 0)
    factor_diagonal_block<T>(A, 0, min(NB, M), rdv, dinv, nan_mode, flag);
  __syncthreads();
  CLK_MARK(1)

  for (int j0 = 0; j0 < M; j0 += NB) {
    const int jb = min(NB, M - j0);
    const int np = M - j0;                           // panel rows
    // row r of the panel (matrix row j0 + r, columns j0 ..)
    auto prow = [&](int r) -> C* {
      return kResident ? A + tri_off(j0 + r) + j0 : S + (long long)r * kPS;
    };
    if (!kResident) {
      for (int e = tid; e < np * NB; e += kThreads) {
        const int r = e / NB, c = e % NB;
        if (c < jb && c <= r) S[r * kPS + c] = A[tri_off(j0 + r) + j0 + c];
      }
      __syncthreads();
      CLK_MARK(4)
    }

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

    if (!kResident) {           // the finished panel back to the workspace
      for (int e = tid; e < np * NB; e += kThreads) {
        const int r = e / NB, c = e % NB;
        if (jb <= r && c < jb) A[tri_off(j0 + r) + j0 + c] = S[r * kPS + c];
      }
    }

    // (3) trailing update A[i, k] -= sum_c L[i, c] conj(L[k, c]),
    //     j0 + jb <= k <= i < M, in 16 x 16 warp tiles of the lower
    //     triangle: lane (gi, gk) = (lane / 8, lane % 8) owns rows
    //     gi + 4u (u < 4) and columns gk + 8v (v < 2) of its tile, so the
    //     lanes of a warp read neighbouring rows of the panel (no bank
    //     conflicts in the row-packed layout).  Look-ahead: warp 0 takes
    //     tile (0, 0), the next diagonal block, and then factors it, while
    //     warps 1.. update the rest and the forward substitution's rows
    //     below: y2 -= L21 y1.
    const int n = np - jb;
    auto tile = [&](int t) {
      int bi = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while (bi * (bi + 1) / 2 > t) --bi;
      while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
      const int bk = t - bi * (bi + 1) / 2;
      if constexpr (sizeof(T) == 8) {
        // complex128 on the FP64 tensor cores: 2 x 2 tiles of
        // mma.m8n8k4.f64 per warp tile, four real products per complex
        // one.  Fragments (PTX ISA, m8n8k4 .f64): A[g][q], B[q][g],
        // C[g][2q + e] with g = lane / 4, q = lane % 4.  A trailing update
        // exists only below a full panel, so jb == NB here.
        const int g = lane >> 2, q = lane & 3;
        const C* pa[2];
        const C* pb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pa[h] = prow(min(jb + 16 * bi + 8 * h + g, np - 1));
          pb[h] = prow(min(jb + 16 * bk + 8 * h + g, np - 1));
        }
        double cr[2][2][2], ci[2][2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 2; ++v)
#pragma unroll
            for (int e = 0; e < 2; ++e) cr[u][v][e] = ci[u][v][e] = 0.0;
#pragma unroll
        for (int c0 = 0; c0 < NB; c0 += 4) {
          C fa[2], fb[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            fa[h] = pa[h][c0 + q];
            fb[h] = pb[h][c0 + q];
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              mma_f64(cr[u][v], fa[u].x, fb[v].x);
              mma_f64(cr[u][v], fa[u].y, fb[v].y);
              mma_f64(ci[u][v], fa[u].y, fb[v].x);
              mma_f64(ci[u][v], -fa[u].x, fb[v].y);
            }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = jb + 16 * bi + 8 * u + g;
          if (i >= np) continue;
          C* row = A + tri_off(j0 + i) + j0;
#pragma unroll
          for (int v = 0; v < 2; ++v)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = jb + 16 * bk + 8 * v + 2 * q + e;
              if (k <= i) {
                C el = row[k];
                el.x -= cr[u][v][e];
                el.y -= ci[u][v][e];
                row[k] = el;
              }
            }
        }
        return;
      }
      const int i0 = jb + 16 * bi + (lane >> 3);     // panel rows
      const int k0 = jb + 16 * bk + (lane & 7);
      const C* pi[4];
      const C* pk[2];
#pragma unroll
      for (int u = 0; u < 4; ++u) pi[u] = prow(min(i0 + 4 * u, np - 1));
#pragma unroll
      for (int v = 0; v < 2; ++v) pk[v] = prow(min(k0 + 8 * v, np - 1));
      C acc[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) acc[u][v] = zero;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        if (c < jb) {
          C li[4], lk[2];
#pragma unroll
          for (int u = 0; u < 4; ++u) li[u] = pi[u][c];
#pragma unroll
          for (int v = 0; v < 2; ++v) lk[v] = pk[v][c];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 2; ++v) add_mul_conj(acc[u][v], li[u], lk[v]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 4 * u;
        if (i >= np) continue;
        C* row = A + tri_off(j0 + i) + j0;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int k = k0 + 8 * v;
          if (k <= i) {
            C e = row[k];
            e.x -= acc[u][v].x;
            e.y -= acc[u][v].y;
            row[k] = e;
          }
        }
      }
    };
    if (warp == 0) {
      if (n > 0) {
        tile(0);
        __syncwarp();
        factor_diagonal_block<T>(A, j0 + jb, min(NB, n), rdv, dinv,
                                 nan_mode, flag);
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
  CLK_MARK(5)

  const bool bad = *flag != 0;
  const C cnan = {nan_t<T>(), nan_t<T>()};
  for (int i = tid; i < M; i += kThreads) x[b * M + i] = bad ? cnan : y[i];
  if (dout != nullptr)
    for (int i = tid; i < M; i += kThreads)
      dout[b * M + i] = bad ? nan_t<T>() : A[tri_off(i) + i].x;
  if (kResident && Lout != nullptr) {
    C* dst = Lout + b * P;
    for (long long e = tid; e < P; e += kThreads) dst[e] = S[e];
  }
  CLK_MARK(6)
  CLK_FLUSH
}

// Both substitutions with a kept factor.  Staged (the factor's resident
// sizes): the packed factor is copied to shared memory with asynchronous
// copies first, so the serial sweeps run at shared-memory latency; otherwise
// they read it from device memory.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
chol_subst_kernel(const typename Cplx<T>::type* __restrict__ L,
                  const T* __restrict__ d,
                  const typename Cplx<T>::type* __restrict__ rhs,
                  typename Cplx<T>::type* __restrict__ x, int M) {
  using C = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* y = reinterpret_cast<C*>(smem_raw);
  C* Ls = y + M;                                     // [M(M+1)/2] if staged
  T* dinv = reinterpret_cast<T*>(Ls + (kStaged ? tri_off(M) : 0));
  const long long b = blockIdx.x;
  const long long P = tri_off(M);
  const C* Lb = L + b * P;
  if (kStaged) {
    for (long long e = threadIdx.x; e < P; e += kThreads)
      __pipeline_memcpy_async(Ls + e, Lb + e, sizeof(C));
    __pipeline_commit();
  }
  for (int i = threadIdx.x; i < M; i += kThreads) {
    y[i] = rhs[b * M + i];
    dinv[i] = T(1) / d[b * M + i];
  }
  if (kStaged) __pipeline_wait_prior(0);
  __syncthreads();
  const C* Lu = kStaged ? Ls : Lb;
  forward<T>(Lu, dinv, y, M);
  backward<T>(Lu, dinv, y, M);
  for (int i = threadIdx.x; i < M; i += kThreads) x[b * M + i] = y[i];
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
  int e = prepare(chol_factor_solve_kernel<float, true>);
  if (!e) e = prepare(chol_factor_solve_kernel<float, false>);
  if (!e) e = prepare(chol_factor_solve_kernel<double, true>);
  if (!e) e = prepare(chol_factor_solve_kernel<double, false>);
  if (!e) e = prepare(chol_subst_kernel<float, true>);
  if (!e) e = prepare(chol_subst_kernel<float, false>);
  if (!e) e = prepare(chol_subst_kernel<double, true>);
  if (!e) e = prepare(chol_subst_kernel<double, false>);
  if (!e) g_prepared[dev].store(1, std::memory_order_release);
  return e;
}

template <typename T>
int path_of(int M) {
  if (M <= 0) return -1;
  if (smem_bytes<T>(M, true) <= kSmemMax) return 0;
  if (smem_bytes<T>(M, false) <= kSmemMax) return 1;
  return -1;
}

template <typename T>
int launch_factor_solve(const void* R, const void* rhs, void* x, void* L,
                        void* d, int B, int M, int nan_mode, void* stream) {
  using C = typename Cplx<T>::type;
  if (B <= 0) return 0;
  const int path = path_of<T>(M);
  if (path < 0 || (path == 1 && L == nullptr)) return (int)cudaErrorInvalidValue;
  const bool resident = path == 0;
  const size_t smem = smem_bytes<T>(M, resident);
  const int e = prepare_all();
  if (e) return e;
  if (resident) {
    chol_factor_solve_kernel<T, true><<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const C*)R, (const C*)rhs, (C*)x, (C*)L, (T*)d, M, nan_mode);
  } else {
    chol_factor_solve_kernel<T, false><<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const C*)R, (const C*)rhs, (C*)x, (C*)L, (T*)d, M, nan_mode);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_subst(const void* L, const void* d, const void* rhs, void* x, int B,
                 int M, void* stream) {
  using C = typename Cplx<T>::type;
  if (B <= 0) return 0;
  const int path = path_of<T>(M);
  if (path < 0) return (int)cudaErrorInvalidValue;
  const bool staged = path == 0;
  const size_t smem = ((size_t)M + (staged ? (size_t)tri_off(M) : 0)) *
                          sizeof(C) + (size_t)M * sizeof(T);
  const int e = prepare_all();
  if (e) return e;
  if (staged) {
    chol_subst_kernel<T, true><<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const C*)L, (const T*)d, (const C*)rhs, (C*)x, M);
  } else {
    chol_subst_kernel<T, false><<<B, kThreads, smem, (cudaStream_t)stream>>>(
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

// Which path a system of order M takes: 0 resident (triangle in shared
// memory), 1 global (device-memory workspace, panel staged), -1 too large.
int chol_path(int M, int c128) {
  return c128 ? path_of<double>(M) : path_of<float>(M);
}

// R: [B, M, M], rhs / x: [B, M] complex64.  L: [B, M(M+1)/2] packed factor
// out (may be NULL on the resident path; required on the global path, where
// it is the workspace), d: [B, M] float32 real diagonal out (may be NULL).
// nan_mode: 0 guard, 1 NaN on a failed pivot.  Returns the cudaError_t of
// the launch (0 on success).
int chol_factor_solve_c64(const void* R, const void* rhs, void* x, void* L,
                          void* d, int B, int M, int nan_mode, void* stream) {
  return launch_factor_solve<float>(R, rhs, x, L, d, B, M, nan_mode, stream);
}

// The same for complex128 (d float64).
int chol_factor_solve_c128(const void* R, const void* rhs, void* x, void* L,
                           void* d, int B, int M, int nan_mode, void* stream) {
  return launch_factor_solve<double>(R, rhs, x, L, d, B, M, nan_mode, stream);
}

// x = (L L^H)^-1 rhs with a factor from chol_factor_solve_c64.
int chol_subst_c64(const void* L, const void* d, const void* rhs, void* x,
                   int B, int M, void* stream) {
  return launch_subst<float>(L, d, rhs, x, B, M, stream);
}

int chol_subst_c128(const void* L, const void* d, const void* rhs, void* x,
                    int B, int M, void* stream) {
  return launch_subst<double>(L, d, rhs, x, B, M, stream);
}

}  // extern "C"
