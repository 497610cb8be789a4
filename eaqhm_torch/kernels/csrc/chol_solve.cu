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
//   the batch's workspaces fit its 50 MB).  Its staged panel, M x 17 entries,
//   caps it at complex128 M = 764 and complex64 M = 1529; complex64 takes it
//   up to M = 706 (the routing table at path_of).
// - Cluster path, for every order whose staged panel does not fit one block
//   (and, by measurement, complex64 orders past 706: path_of): one system is
//   split over a thread-block cluster of C = 2..8 blocks on neighbouring SMs.
//   The NB-row blocks of the matrix go to the cluster's blocks
//   block-cyclically (row block rb to rank rb % C), so the shrinking trailing
//   triangle stays balanced.  Each rank stages only its own panel rows, about (M / C) x 17
//   entries, which lifts the order limit C-fold; per panel (two cluster
//   barriers):
//   (a) each rank stages its own panel rows; every rank copies L11 (factored
//       into the workspace by the diagonal block's owner in the previous
//       panel's look-ahead) and its rsqrt pivots (from the owner's shared
//       memory, through distributed shared memory) into a local copy;
//   (b) each rank solves its own panel rows against L11; the owner solves
//       y1; cluster barrier;
//   (c) each rank updates the tiles (i, k) of its own row blocks i, reading
//       panel rows of block k from their owner's shared memory through
//       distributed shared memory (map_shared_rank; complex128 reads them
//       once per column of its tiles and keeps them in registers), and its
//       own rows of y2 -= L21 y1; the owner of the next diagonal block
//       takes that tile and factors it with one warp (look-ahead); cluster
//       barrier.
//   The forward substitution's y and the diagonal live in device memory (x
//   and d: the wrapper always gives d here), so shared memory holds the
//   staged rows and a few NB-sized buffers only.  Rank 0 runs the backward
//   substitution alone at the end, as the global path does.  Global loads
//   of data another rank wrote go through L2 (ld.global.cg).
//   In (c) complex64 copies block k's rows into a per-warp shared buffer
//   once per column instead (no registers to spare).  On every path a
//   tile's elements are read before its products, so the latency of device
//   memory overlaps the arithmetic.
// - Slab path, past the cluster path's capacity at C = 8 (complex128
//   M > 6656, complex64 M > 12416): the same cluster kernel with nothing
//   staged; each warp reads the two 16-row slabs of panel rows its tile
//   needs straight from the workspace (L2), so shared memory is a fixed
//   4.5 KB (complex128) or 19.3 KB (complex64) for any M.  Slow, and it
//   takes every M whose tensors the caller can allocate.
// - Backward substitution L^H x = y, and both sweeps of the substitution
//   entry point, are blocked the same way: one warp solves each NB-row
//   diagonal block with shuffles, then all threads update the remaining rows
//   (forward) or columns (backward), two barriers per block.  The
//   substitution entry point stages the packed factor in shared memory
//   (cp.async) at the resident sizes, reads it from device memory with y in
//   shared memory where y fits, and otherwise keeps y in x as well.
//
// It takes any M >= 1 and any B: no padding to a panel width, no batch
// padding.  Complex values are interleaved (float2 / double2), which is the
// layout of torch.complex64 / torch.complex128.
#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <math.h>

#include <atomic>

namespace cg = cooperative_groups;

#ifdef CHOL_PHASE_CLOCKS
// Profiling build only (tools/bench_chol_phases.py): thread 0 of each block
// adds the cycles of each phase of its block's timeline, barrier waits
// included, to g_clk: 0 load, 1 diagonal block, 2 panel rows, 3 trailing
// update with the next diagonal block (look-ahead), 4 panel staging, 5
// backward substitution, 6 output, 7 blocks; the first diagonal block counts
// in 1.  On the cluster and slab paths every block of a cluster counts, the
// cluster barriers count in the phase they close (2 and 3), and only rank 0
// has phases 5 and 6.
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
constexpr int kPS = NB + 1;     // staged panel row stride
constexpr size_t kSmemMax = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 8;  // the portable cluster size

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

// A load from device memory through L2 only (kCg: data another block of the
// cluster wrote), or a plain load (shared memory, or data of this block).
template <bool kCg, typename V>
__device__ __forceinline__ V ldx(const V* p) {
  if constexpr (kCg) return __ldcg(p);
  else return *p;
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

// Shared memory of one block of the cluster kernel: its own staged panel
// rows (none on the slab path), the local copy of L11, complex64 only a
// k block per warp (kKWarp), rd of the diagonal block it factored and the
// local copy of the current panel's rd, a flag.
template <typename T>
constexpr int kKWarp = sizeof(T) == 4 ? kWarps : 0;

template <typename T>
size_t cluster_smem_bytes(int M, int C, bool staged) {
  using Cx = typename Cplx<T>::type;
  const long long nrb = (M + NB - 1) / NB;
  const size_t nslot = staged ? (size_t)((nrb + C - 1) / C) : 0;
  return (nslot + 1 + kKWarp<T>) * NB * kPS * sizeof(Cx) +
         2 * NB * sizeof(T) + 16;
}

// dv[j] is 1 / L[j, j] (kInv false) or L[j, j] itself (kInv true).
template <typename T, bool kInv, bool kCg>
__device__ __forceinline__ T inv_diag(const T* dv, int j) {
  const T v = ldx<kCg>(dv + j);
  return kInv ? T(1) / v : v;
}

// Forward L y = b, in place in y (shared or device memory).  L: row-packed
// lower triangle (shared or device memory), dv: its real diagonal or the
// inverse (kInv).  One warp solves each NB-row diagonal block with
// shuffles, then all threads update the rows below; all threads of the
// block call it.
template <typename T, bool kInv = false, bool kCg = false>
__device__ void forward(const typename Cplx<T>::type* L, const T* dv,
                        typename Cplx<T>::type* y, int M) {
  using C = typename Cplx<T>::type;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const C zero = {T(0), T(0)};
  for (int j0 = 0; j0 < M; j0 += NB) {
    const int jb = min(NB, M - j0);
    if (tid < 32) {
      C v = lane < jb ? ldx<kCg>(y + j0 + lane) : zero;
      const C* lr = L + tri_off(j0 + min(lane, jb - 1)) + j0;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        if (c < jb) {
          if (lane == c) scale(v, inv_diag<T, kInv, kCg>(dv, j0 + c));
          const C yc = shfl(v, c);
          if (lane > c && lane < jb) sub_mul(v, ldx<kCg>(lr + c), yc);
        }
      }
      if (lane < jb) y[j0 + lane] = v;
    }
    __syncthreads();
    for (int i = j0 + jb + tid; i < M; i += kThreads) {
      const C* lr = L + tri_off(i) + j0;
      C s = ldx<kCg>(y + i);
      for (int c = 0; c < jb; ++c)
        sub_mul(s, ldx<kCg>(lr + c), ldx<kCg>(y + j0 + c));
      y[i] = s;
    }
    __syncthreads();
  }
}

// Backward L^H x = y, in place in y; the same blocking from the last block
// (row j of L is column j of L^H, read by neighbouring threads).
template <typename T, bool kInv = false, bool kCg = false>
__device__ void backward(const typename Cplx<T>::type* L, const T* dv,
                         typename Cplx<T>::type* y, int M) {
  using C = typename Cplx<T>::type;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const C zero = {T(0), T(0)};
  for (int j0 = ((M - 1) / NB) * NB; j0 >= 0; j0 -= NB) {
    const int jb = min(NB, M - j0);
    if (tid < 32) {
      C v = lane < jb ? ldx<kCg>(y + j0 + lane) : zero;
#pragma unroll
      for (int c = NB - 1; c >= 0; --c) {
        if (c < jb) {
          if (lane == c) scale(v, inv_diag<T, kInv, kCg>(dv, j0 + c));
          const C xc = shfl(v, c);
          // L^H[lane, c] = conj(L[c, lane])
          if (lane < c)
            sub_mul_conj(v, xc, ldx<kCg>(L + tri_off(j0 + c) + j0 + lane));
        }
      }
      if (lane < jb) y[j0 + lane] = v;
    }
    __syncthreads();
    for (int k = tid; k < j0; k += kThreads) {
      C s = ldx<kCg>(y + k);
      for (int c = 0; c < jb; ++c)
        sub_mul_conj(s, ldx<kCg>(y + j0 + c),
                     ldx<kCg>(L + tri_off(j0 + c) + k));
      y[k] = s;
    }
    __syncthreads();
  }
}

// Factor the jb x jb diagonal block at (j0, j0) of the packed triangle A in
// place, by one warp: lane r holds row j0 + r in registers and the column
// values travel by shuffles.  Writes rd[r] = rsqrt(pivot) and dv[r] =
// 1 / L[j0 + r, j0 + r] (or L[j0 + r, j0 + r] itself with dv_plain) for the
// block's rows, and sets *flag on a failed pivot in the "nan" rule.
template <typename T>
__device__ void factor_diagonal_block(typename Cplx<T>::type* A, int j0,
                                      int jb, T* rd, T* dv, bool dv_plain,
                                      int nan_mode, int* flag) {
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
    dv[r] = dv_plain ? myd : T(1) / myd;
  }
  if (failed && r == 0) *flag = 1;
}

// complex128 tiles on the FP64 tensor cores: 2 x 2 tiles of mma.m8n8k4.f64
// per 16 x 16 warp tile, four real products per complex one.  Fragments
// (PTX ISA, m8n8k4 .f64): A[g][q], B[q][g], C[g][2q + e] with g = lane / 4,
// q = lane % 4.  The k operand of a tile, in B-fragment order: fb[c][h] is
// column 4c + q of panel row 8h + g of the k block (pk(k) for k < nk; the
// last valid row stands in for the rows past the matrix).
using KFrag = double2[NB / 4][2];

template <bool kCg, typename PK>
__device__ __forceinline__ void load_kfrag(KFrag& fb, PK pk, int nk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const double2* r = pk(min(8 * h + g, nk - 1));
#pragma unroll
    for (int c = 0; c < NB / 4; ++c) fb[c][h] = ldx<kCg>(r + 4 * c + q);
  }
}

// A[I0 + i, K0 + k] -= sum_c Pi[i][c] conj(Pk[k][c]) for one complex128
// tile whose k operand is loaded (fb); see update_tile.  The tile's
// elements are read first, so their latency overlaps the products.
template <bool kCgI, typename PI, typename OUT>
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
    for (int h = 0; h < 2; ++h) fa[h] = ldx<kCgI>(pa[h] + 4 * c + q);
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
// the packed triangle from column K0.  kCgI / kCgK: the rows of pi / pk
// are device memory another block wrote.
template <typename T, bool kCgI, bool kCgK, typename PI, typename PK,
          typename OUT>
__device__ __forceinline__ void update_tile(PI pi, PK pk, OUT out, int ni,
                                            int nk, int I0, int K0) {
  using C = typename Cplx<T>::type;
  if constexpr (sizeof(T) == 8) {
    KFrag fb;
    load_kfrag<kCgK>(fb, pk, nk);
    tile_c128<kCgI>(pi, fb, out, ni, I0, K0);
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
      for (int u = 0; u < 4; ++u) li[u] = ldx<kCgI>(pa[u] + c);
#pragma unroll
      for (int v = 0; v < 2; ++v) lk[v] = ldx<kCgK>(pb[v] + c);
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
    factor_diagonal_block<T>(A, 0, min(NB, M), rdv, dinv, false, nan_mode,
                             flag);
  __syncthreads();
  CLK_MARK(1)

  for (int j0 = 0; j0 < M; j0 += NB) {
    const int jb = min(NB, M - j0);
    const int np = M - j0;                           // panel rows
    // row r of the panel (matrix row j0 + r, columns j0 ..)
    auto prow = [&](int r) -> C* {
      return kResident ? A + tri_off(j0 + r) + j0 : S + (long long)r * kPS;
    };
    if (!kResident) {          // unrolled: eight rows' loads in flight
      const int c = tid % NB;
#pragma unroll 8
      for (int r = tid / NB; r < np; r += kThreads / NB)
        if (c < jb && c <= r) S[r * kPS + c] = A[tri_off(j0 + r) + j0 + c];
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
      const int c = tid % NB;
#pragma unroll 8
      for (int r = tid / NB; r < np; r += kThreads / NB)
        if (jb <= r && c < jb) A[tri_off(j0 + r) + j0 + c] = S[r * kPS + c];
    }

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
      update_tile<T, false, false>(
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

// The cluster path (kStaged) and the slab path (!kStaged): one system per
// cluster of gridDim-consecutive blocks, the packed triangle in the
// workspace Lw (the factor output), y in x, L[j, j] in dw.  Row block rb
// (matrix rows 16 rb ..) belongs to rank rb % C and sits in its staging
// slot rb / C.  Two launch bounds' blocks per SM: at the stress widths a
// rank's shared memory is small enough for two.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads, 2)
chol_cluster_kernel(const typename Cplx<T>::type* __restrict__ R,
                    const typename Cplx<T>::type* __restrict__ rhs,
                    typename Cplx<T>::type* __restrict__ x,
                    typename Cplx<T>::type* __restrict__ Lw,
                    T* __restrict__ dw, int M, int nan_mode) {
  using C = typename Cplx<T>::type;
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int nrb = (M + NB - 1) / NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* L11 = reinterpret_cast<C*>(smem_raw);           // [NB][kPS] local copy
  C* Kw = L11 + NB * kPS;                            // [kKWarp][NB][kPS]
  C* S = Kw + kKWarp<T> * NB * kPS;                  // own panel rows
  const int nslot = kStaged ? (nrb + nc - 1) / nc : 0;
  T* rdb = reinterpret_cast<T*>(S + (long long)nslot * NB * kPS);
  T* rds = rdb + NB;                                 // this panel's rd
  int* flag = reinterpret_cast<int*>(rds + NB);

  const long long b = blockIdx.x / nc;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const C zero = {T(0), T(0)};
  C* A = Lw + b * tri_off(M);
  C* y = x + b * M;
  T* dg = dw + b * M;
  auto srow = [&](C* base, int rb, int r) -> C* {    // staged row r of rb
    return base + ((long long)(rb / nc) * NB + r) * kPS;
  };
  CLK_START

  {  // own rows of R's lower triangle into the workspace, own rows of rhs
    const C* Rb = R + b * (long long)M * M;
    const int nown = q < nrb ? (nrb - 1 - q) / nc + 1 : 0;
    for (int t = warp; t < nown * NB; t += kWarps) {
      const int i = (q + nc * (t / NB)) * NB + t % NB;
      if (i >= M) continue;
      C* dst = A + tri_off(i);
      const C* src = Rb + (long long)i * M;
#pragma unroll 4
      for (int k = lane; k <= i; k += 32) dst[k] = src[k];
    }
    for (int t = tid; t < nown * NB; t += kThreads) {
      const int i = (q + nc * (t / NB)) * NB + t % NB;
      if (i < M) y[i] = rhs[b * M + i];
    }
    if (tid == 0) *flag = 0;
  }
  __syncthreads();
  CLK_MARK(0)
  if (q == 0 && warp == 0)
    factor_diagonal_block<T>(A, 0, min(NB, M), rdb, dg, true, nan_mode, flag);
  cluster.sync();
  CLK_MARK(1)

  for (int p = 0; p < nrb; ++p) {
    const int j0 = p * NB, jb = min(NB, M - j0);
    const int od = p % nc;                           // owner of the diagonal
    const int first = p + ((q - p % nc) + nc) % nc;  // own blocks >= p
    const int fb = first == p ? first + nc : first;  // own blocks > p
    const int nown = fb < nrb ? (nrb - 1 - fb) / nc + 1 : 0;
    // own panel row t (t < nown * NB): block fb + nc (t / NB), row t % NB
    auto own_row = [&](int t) -> C* {
      const int rb = fb + nc * (t / NB), r = t % NB;
      return kStaged ? srow(S, rb, r) : A + tri_off(rb * NB + r) + j0;
    };

    // (a) stage own panel rows below the diagonal block; copy L11 (from
    //     the workspace) and its rd
    if (kStaged) {
      const int r = tid / NB, c = tid % NB;
#pragma unroll 4
      for (int rb = fb; rb < nrb; rb += nc) {
        const int i = rb * NB + r;
        if (i < M && c < jb) srow(S, rb, r)[c] = A[tri_off(i) + j0 + c];
      }
    }
    {
      const int r = tid / NB, c = tid % NB;
      if (r < jb && c <= r)
        L11[r * kPS + c] = ldx<true>(A + tri_off(j0 + r) + j0 + c);
      if (tid < jb) rds[tid] = cluster.map_shared_rank(rdb, od)[tid];
    }
    __syncthreads();
    CLK_MARK(4)

    // (b) own panel rows below the diagonal block: L21 = A21 L11^-H; the
    //     owner of the diagonal block solves L11 y1 = b1
    for (int t = tid; t < nown * NB; t += kThreads) {
      if ((fb + nc * (t / NB)) * NB + t % NB >= M) continue;
      C* pr = own_row(t);
      C a[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) a[c] = c < jb ? pr[c] : zero;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        if (c < jb) {
#pragma unroll
          for (int k = 0; k < c; ++k)
            sub_mul_conj(a[c], a[k], L11[c * kPS + k]);
          scale(a[c], rds[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < NB; ++c)
        if (c < jb) pr[c] = a[c];
    }
    if (q == od && tid == kThreads - 1) {
      for (int c = 0; c < jb; ++c) {
        C v = y[j0 + c];
        for (int k = 0; k < c; ++k) sub_mul(v, L11[c * kPS + k], y[j0 + k]);
        scale(v, T(1) / dg[j0 + c]);
        y[j0 + c] = v;
      }
    }
    cluster.sync();
    CLK_MARK(2)

    if (kStaged) {              // own finished panel rows to the workspace
      const int r = tid / NB, c = tid % NB;
#pragma unroll 4
      for (int rb = fb; rb < nrb; rb += nc) {
        const int i = rb * NB + r;
        if (i < M && c < jb) A[tri_off(i) + j0 + c] = srow(S, rb, r)[c];
      }
    }

    // (c) trailing update of the tiles (i, k) of own row blocks i, k in
    //     p + 1 .. i; rows of block k from their owner (distributed shared
    //     memory, or the workspace through L2 on the slab path).
    //     Look-ahead: the owner of block p + 1 takes its diagonal tile and
    //     factors it with warp 0; the other warps do the rest and the own
    //     rows of y2 -= L21 y1.  complex128: a warp's task is one k block
    //     and every own i block below it (a column of tiles), so the k
    //     operand is read from its owner once per column and kept in
    //     registers; tasks go to the warps in snake order (the columns
    //     shorten down the panel).  complex64 (no registers to spare for
    //     the operand): tiles one by one, round robin.
    auto pk_of = [&](int rbk) {
      C* Sk = kStaged ? cluster.map_shared_rank(S, rbk % nc) : nullptr;
      return [=](int k) -> const C* {
        return kStaged ? srow(Sk, rbk, k) : A + tri_off(rbk * NB + k) + j0;
      };
    };
    auto pi_of = [&](int rbi) {
      return [=](int i) -> const C* {
        return kStaged ? srow(S, rbi, i) : A + tri_off(rbi * NB + i) + j0;
      };
    };
    auto out_of = [&](int rbi, int rbk) {
      return [=](int i) -> C* { return A + tri_off(rbi * NB + i) + rbk * NB; };
    };
    auto tile = [&](int rbi, int rbk) {
      update_tile<T, !kStaged, !kStaged>(
          pi_of(rbi), pk_of(rbk), out_of(rbi, rbk), min(NB, M - rbi * NB),
          min(NB, M - rbk * NB), rbi * NB, rbk * NB);
    };
    const int nx = p + 1;
    const bool la = nx < nrb && nx % nc == q;
    if (la && warp == 0) {
      tile(nx, nx);
      __syncwarp();
      factor_diagonal_block<T>(A, nx * NB, min(NB, M - nx * NB), rdb,
                               dg + nx * NB, true, nan_mode, flag);
    } else {
      const int w = la ? warp - 1 : warp;
      const int nw = la ? kWarps - 1 : kWarps;
      const int t0 = la ? tid - 32 : tid;
      for (int t = t0; t < nown * NB; t += nw * 32) {
        const int i = (fb + nc * (t / NB)) * NB + t % NB;
        if (i >= M) continue;
        const C* pr = own_row(t);
        C v = y[i];
        for (int c = 0; c < jb; ++c)
          sub_mul(v, pr[c], ldx<true>(y + j0 + c));
        y[i] = v;
      }
      for (int rbk = nx; rbk < nrb; ++rbk) {
        const int t = rbk - nx, round = t / nw, pos = t % nw;
        if ((round & 1 ? nw - 1 - pos : pos) != w) continue;
        int rbi = rbk + ((q - rbk % nc) + nc) % nc;     // own blocks >= k
        if (la && rbi == nx) rbi += nc;                 // the look-ahead's
        if (rbi >= nrb) continue;
        const int nk = min(NB, M - rbk * NB);
        if constexpr (sizeof(T) == 8) {
          KFrag kf;
          load_kfrag<!kStaged>(kf, pk_of(rbk), nk);
          for (; rbi < nrb; rbi += nc)
            tile_c128<!kStaged>(pi_of(rbi), kf, out_of(rbi, rbk),
                                min(NB, M - rbi * NB), rbi * NB, rbk * NB);
        } else {
          C* kw = Kw + warp * NB * kPS;
          const auto pk = pk_of(rbk);
          __syncwarp();
          for (int e = lane; e < NB * NB; e += 32)
            kw[(e / NB) * kPS + e % NB] =
                ldx<!kStaged>(pk(min(e / NB, nk - 1)) + e % NB);
          __syncwarp();
          for (; rbi < nrb; rbi += nc)
            update_tile<T, !kStaged, false>(
                pi_of(rbi), [=](int k) -> const C* { return kw + k * kPS; },
                out_of(rbi, rbk), min(NB, M - rbi * NB), nk, rbi * NB,
                rbk * NB);
        }
      }
    }
    cluster.sync();
    CLK_MARK(3)
  }

  // every rank's failure flag to rank 0; the others leave after that
  if (q == 0 && tid == 0) {
    int f = 0;
    for (int r = 0; r < nc; ++r) f |= *cluster.map_shared_rank(flag, r);
    *flag = f;
  }
  cluster.sync();
  if (q != 0) {
    CLK_FLUSH
    return;
  }
  backward<T, true, true>(A, dg, y, M);
  CLK_MARK(5)
  if (*flag != 0) {
    const C cnan = {nan_t<T>(), nan_t<T>()};
    for (int i = tid; i < M; i += kThreads) {
      y[i] = cnan;
      dg[i] = nan_t<T>();
    }
  }
  CLK_MARK(6)
  CLK_FLUSH
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
  if constexpr (kMode == 2) {
    C* y = x + b * M;
    for (int i = threadIdx.x; i < M; i += kThreads) y[i] = rhs[b * M + i];
    __syncthreads();
    forward<T, true>(Lb, d + b * M, y, M);
    backward<T, true>(Lb, d + b * M, y, M);
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
    const C* Lu = kMode == 0 ? Ls : Lb;
    forward<T>(Lu, dinv, y, M);
    backward<T>(Lu, dinv, y, M);
    for (int i = threadIdx.x; i < M; i += kThreads) x[b * M + i] = y[i];
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
  int e = prepare(chol_factor_solve_kernel<float, true>);
  if (!e) e = prepare(chol_factor_solve_kernel<float, false>);
  if (!e) e = prepare(chol_factor_solve_kernel<double, true>);
  if (!e) e = prepare(chol_factor_solve_kernel<double, false>);
  if (!e) e = prepare(chol_cluster_kernel<float, true>);
  if (!e) e = prepare(chol_cluster_kernel<float, false>);
  if (!e) e = prepare(chol_cluster_kernel<double, true>);
  if (!e) e = prepare(chol_cluster_kernel<double, false>);
  if (!e) e = prepare(chol_subst_kernel<float, 0>);
  if (!e) e = prepare(chol_subst_kernel<float, 1>);
  if (!e) e = prepare(chol_subst_kernel<float, 2>);
  if (!e) e = prepare(chol_subst_kernel<double, 0>);
  if (!e) e = prepare(chol_subst_kernel<double, 1>);
  if (!e) e = prepare(chol_subst_kernel<double, 2>);
  if (!e) g_prepared[dev].store(1, std::memory_order_release);
  return e;
}

enum Path { kResidentPath = 0, kGlobalPath = 1, kClusterPath = 2,
            kSlabPath = 3 };

// Routing, by measurement (tools/torch_chol_route.py on an NVIDIA H100 80GB
// HBM3 at 700.00 W): the fused factor + solve ("nan" rule, no factor kept)
// on each path that fits, ms, with cuSOLVER's route beside it:
//   type  B x M       global  cl. C=2  C=4     C=8     slab    cuSOLVER
//   c64   512 x 194      0.97    1.65    2.67    4.48    4.38    1.61
//   c64   512 x 258      1.72    2.68    4.06    6.33    6.32    2.69
//   c64   512 x 386      4.80    6.42    8.09   12.06   12.38    5.99
//   c64   256 x 514      4.80    6.44    7.53   10.16   11.01    5.93
//   c64   256 x 642      8.77   11.29   12.85   15.78   18.57    9.53
//   c64   128 x 770      9.18    9.10   11.02   12.38   16.63    7.78
//   c64    64 x 770      8.29    5.93    6.85    6.84    9.37    4.88
//   c64    32 x 1026    17.88   10.11    8.33    8.55   12.25    5.74
//   c64    27 x 1294    33.48   17.32   11.62   10.20   16.09    8.12
//   c64    16 x 1294    33.12   16.66   10.34    8.80   13.14    6.51
//   c64    11 x 1950        -   48.59   27.52   18.22   32.94   11.48
//   c64     8 x 1950        -   48.21   27.03   17.04   30.27    9.53
//   c128  512 x 194      1.37    2.08    3.09    5.14    5.03    2.64
//   c128  512 x 258      2.85    3.71    4.64    7.42    7.34    4.68
//   c128  256 x 290      1.96    2.41    3.06    4.58    4.57    3.16
//   c128  256 x 386      4.17    4.63    5.48    7.24    7.39    5.72
//   c128  128 x 514      4.64    4.68    6.01    6.91    7.53    5.78
//   c128  128 x 642      8.53    8.33   10.34   11.74   13.09    9.27
//   c128   82 x 770         -   10.54   11.28   12.27   14.01    9.56
//   c128   64 x 770         -    8.11   10.43    9.88   11.34    7.87
//   c128   32 x 1026        -   12.94   11.22   12.59   14.84    8.68
//   c128   27 x 1294        -   22.93   16.20   15.28   18.20   12.66
//   c128   16 x 1294        -   21.10   13.50   12.14   14.45    9.33
//   c128   11 x 1950        -       -   36.95   25.33   30.70   17.31
//   c128    8 x 1950        -       -   35.28   22.97   27.25   15.14
//   c128    2 x 6146        -       -       -  458.09  593.39   78.03
// (c64 2 x 6146: C=4 634.57, C=8 333.97, slab 790.98, cuSOLVER 45.98.)
// Unrolling the global path's panel staging afterwards took another 1-5%
// off its times at M = 194-642 (an A/B in one run on the same card).
// The rule: the resident path wherever the triangle fits; the global path
// wherever its panel fits, except complex64 past M = 706 (the cluster path
// ties it at 128 x 770 and wins from 64 x 770 on); the cluster path with
// C = 2 up to M = 770, 4 up to 1026, 8 above; past C = 8's capacity the
// slab path (8 blocks).
constexpr int kGlobalTopC64 = 706;

template <typename T>
int cluster_size(int M) {
  int c = M <= 770 ? 2 : M <= 1026 ? 4 : kMaxCluster;
  while (c < kMaxCluster && cluster_smem_bytes<T>(M, c, true) > kSmemMax)
    c *= 2;
  return c;
}

template <typename T>
int path_of(int M) {
  if (M <= 0) return -1;
  if (smem_bytes<T>(M, true) <= kSmemMax) return kResidentPath;
  if (smem_bytes<T>(M, false) <= kSmemMax &&
      (sizeof(T) == 8 || M <= kGlobalTopC64))
    return kGlobalPath;
  if (cluster_smem_bytes<T>(M, kMaxCluster, true) <= kSmemMax)
    return kClusterPath;
  return kSlabPath;
}

template <typename T, bool kStaged>
int launch_cluster(const void* R, const void* rhs, void* x, void* L, void* d,
                   int B, int M, int nan_mode, int csize,
                   cudaStream_t stream) {
  using C = typename Cplx<T>::type;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)csize);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = cluster_smem_bytes<T>(M, csize, kStaged);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, chol_cluster_kernel<T, kStaged>,
                                 (const C*)R, (const C*)rhs, (C*)x, (C*)L,
                                 (T*)d, M, nan_mode);
}

template <typename T>
int launch_factor_solve(const void* R, const void* rhs, void* x, void* L,
                        void* d, int B, int M, int nan_mode, int path,
                        int csize, void* stream) {
  using C = typename Cplx<T>::type;
  if (B <= 0) return 0;
  if (M <= 0) return (int)cudaErrorInvalidValue;
  if (path < 0) path = path_of<T>(M);
  const bool fits =
      path == kResidentPath ? smem_bytes<T>(M, true) <= kSmemMax
      : path == kGlobalPath ? smem_bytes<T>(M, false) <= kSmemMax
      : path == kClusterPath || path == kSlabPath;
  if (path == kClusterPath || path == kSlabPath) {
    if (csize <= 0) csize = path == kSlabPath ? kMaxCluster : cluster_size<T>(M);
    if (csize < 2 || csize > kMaxCluster) return (int)cudaErrorInvalidValue;
  }
  if (!fits || (path == kClusterPath &&
                cluster_smem_bytes<T>(M, csize, true) > kSmemMax))
    return (int)cudaErrorInvalidValue;
  if (path != kResidentPath && L == nullptr) return (int)cudaErrorInvalidValue;
  if ((path == kClusterPath || path == kSlabPath) && d == nullptr)
    return (int)cudaErrorInvalidValue;
  const int e = prepare_all();
  if (e) return e;
  cudaStream_t s = (cudaStream_t)stream;
  if (path == kClusterPath)
    return launch_cluster<T, true>(R, rhs, x, L, d, B, M, nan_mode, csize, s);
  if (path == kSlabPath)
    return launch_cluster<T, false>(R, rhs, x, L, d, B, M, nan_mode, csize, s);
  const size_t smem = smem_bytes<T>(M, path == kResidentPath);
  if (path == kResidentPath) {
    chol_factor_solve_kernel<T, true><<<B, kThreads, smem, s>>>(
        (const C*)R, (const C*)rhs, (C*)x, (C*)L, (T*)d, M, nan_mode);
  } else {
    chol_factor_solve_kernel<T, false><<<B, kThreads, smem, s>>>(
        (const C*)R, (const C*)rhs, (C*)x, (C*)L, (T*)d, M, nan_mode);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_subst(const void* L, const void* d, const void* rhs, void* x, int B,
                 int M, void* stream) {
  using C = typename Cplx<T>::type;
  if (B <= 0) return 0;
  if (M <= 0) return (int)cudaErrorInvalidValue;
  const int e = prepare_all();
  if (e) return e;
  cudaStream_t s = (cudaStream_t)stream;
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

// Which path a system of order M takes: 0 resident (triangle in shared
// memory), 1 global (device-memory workspace, panel staged), 2 cluster
// (one system over a cluster, each rank staging its own panel rows), 3 slab
// (the cluster kernel with nothing staged); -1 for M < 1.
int chol_path(int M, int c128) {
  return c128 ? path_of<double>(M) : path_of<float>(M);
}

// The cluster size the cluster path (2) or the slab path (3) takes at
// order M when the caller leaves it to the kernel (csize 0).
int chol_cluster_size(int M, int c128, int path) {
  if (path == kSlabPath) return kMaxCluster;
  return c128 ? cluster_size<double>(M) : cluster_size<float>(M);
}

// R: [B, M, M], rhs / x: [B, M] complex64.  L: [B, M(M+1)/2] packed factor
// out (may be NULL on the resident path; required on the others, where it
// is the workspace), d: [B, M] float32 real diagonal out (may be NULL on
// the resident and global paths; required on the cluster and slab paths).
// nan_mode: 0 guard, 1 NaN on a failed pivot.  path: -1 for chol_path's
// choice, or 0-3 to ask for one (refused where it does not fit); csize: the
// cluster size of paths 2 and 3 (0: the kernel's choice).  Returns the
// cudaError_t of the launch (0 on success).
int chol_factor_solve_c64(const void* R, const void* rhs, void* x, void* L,
                          void* d, int B, int M, int nan_mode, int path,
                          int csize, void* stream) {
  return launch_factor_solve<float>(R, rhs, x, L, d, B, M, nan_mode, path,
                                    csize, stream);
}

// The same for complex128 (d float64).
int chol_factor_solve_c128(const void* R, const void* rhs, void* x, void* L,
                           void* d, int B, int M, int nan_mode, int path,
                           int csize, void* stream) {
  return launch_factor_solve<double>(R, rhs, x, L, d, B, M, nan_mode, path,
                                     csize, stream);
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
