// Batched Hermitian-positive-definite solve by recursive block inverse, for
// Hopper: the float32 default solve of the JAX package.
//
// Replaces the "block_inverse" branch of eaqhm_tpu/ops/solver.py
// `solve_gram` (`hpd_block_inverse` at :89 with its Gauss-Jordan leaves
// `gj_inverse` at :66, and the refinements at :316-352), which XLA fuses on
// the TPU.  For each of B equilibrated complex HPD systems R x = b
// (R [M, M], b [M]):
//   1. Ri by JAX's recursion.  [[P, Q], [Q^H, S]] is split at
//      m = (M/2 + 7) & ~7 for M >= 32, M/2 below, at most M - 1; with
//      T = P^-1 Q, Sc = S - Q^H T and U = T Sc^-1,
//          Ri = [[P^-1 + U T^H, -U], [-U^H, Sc^-1]];
//      blocks of order <= 16 are inverted by Gauss-Jordan elimination with
//      no pivoting.  The split rule, the leaf order and the four products
//      are JAX's, each taken as JAX writes it (Sc from Q^H T, not from its
//      Hermitian mirror): they fix the float32 rounding, and with it which
//      batches trip the gate.
//   2. x = Ri b, then two refinements x += Ri (b - R x), each residual
//      against R in the same type.
//   3. The gate inputs per system: ||b - R x||inf / ||b||inf of the returned
//      x (0 where the residual is 0, NaN where it is NaN) and whether every
//      entry of x is finite; and one flag for the batch, cleared when any
//      system is not finite or its ratio is not <= the caller's gate.
//
// What bounds it on an H100: at a node of order n each of the four
// products takes n^3/8 complex multiply-adds, n^3/2 in all; summed over the
// levels that is 2M^3/3 per system, against M^2 elements of R read.  The
// bound (chip_smoke.py bi_cost) counts M^3/2: Sc and P^-1 + U T^H as one
// triangle each, the least those products need.  The kernel computes both
// in full, because one triangle mirrored is not JAX's rounding: with Gauss-
// Jordan leaves whose error is not Hermitian it moves what the gate decides
// (PERF.md).  So it is bound by arithmetic at every order of the main path
// (M = 98-1294).  complex64 runs on FP32 FMA on the CUDA cores (no TF32 in
// any form: it would move what the float32 gate decides), complex128's
// block products on the FP64 tensor cores (mma.sync m8n8k4).
//
// Two entry points and two paths (bi_path):
// - Resident (complex64 M <= 168, complex128 M <= 118): one block per
//   system holds R, then Ri, in shared memory and builds Ri in place; the
//   refinements and the gate read R again from device memory (L2) and keep
//   x and the residual in shared memory.  One launch per batch; x, the
//   ratios and the flags are its only writes.
// - Hybrid, beyond: Ri is built in a device-memory workspace W.  Every
//   subtree of the recursion whose order fits one block (complex64 <= 170,
//   complex128 <= 120) is one launch of bi_invert_*, which stages the block
//   in shared memory (from R down the tree's left edge, from W where a
//   Schur complement was written, so R is never copied), runs the same
//   in-place recursion and writes it into W.  The levels above are JAX's
//   four products through torch.matmul (cuBLAS, as JAX leaves them to XLA)
//   and a copy of -U^H.  Then bi_refine_* runs steps 2 and 3 from W: one
//   block of 512 threads per system, a warp per row, each lane with two to
//   four 16-byte loads in flight, two blocks per SM: six passes over M^2
//   elements in device memory (Ri three times, R three times), which bound
//   it at the memory's rate.
//
// The in-block engine (both paths' shared-memory recursion) runs 512
// threads a block in complex64 (16 warps; one block per SM, shared memory
// being the limit) and 256 where two systems fit one SM's shared memory
// (complex64 resident M <= 118, subtrees <= 120: two blocks per SM, so one
// block's leaves overlap the other's products); 256 in complex128.  Nodes
// of order <= 32 (small_node): their Gauss-Jordan leaves belong to warps 0
// and 1, which hold the leaf in registers (four elements a lane) and pass
// the pivot column through shared memory with one 64-thread barrier a step
// and the pivot row by shuffles; their four products give one element to
// each thread.  Above, on the node [[P, Q], [Q^H, S]] of the shared matrix
// (row stride ld even, so every block of a node of order > 32 starts
// 16-byte aligned: o and m are multiples of 8):
//   L = T^H = (P^-1 Q)^H     (lower left)
//   S = S - Q^H T            (Sc: (L Q)^H subtracted)
//   S = Sc^-1                (recursion)
//   Q = -T S = -U            (T read as L^H)
//   P = P - Q L              (P^-1 + U T^H)
//   L = Q^H                  (-U^H)
// In complex64 each product gives every thread a 4 x 4 complex tile of
// the result in registers (2 x 2 where 4 x 4 tiles would leave half the
// block idle) and reads its operands two complex values at a time
// (float4): one load per four complex multiply-adds (16 FMAs) at 4 x 4;
// every result row is stored row-wise, the conjugate-transposed results
// (L, Sc) and the last copy as rows of two or four from registers, so no
// store walks a column.  In complex128 each warp takes a 16 x 16 tile on
// the FP64 tensor cores (product_mma: 2 x 2 m8n8k4 tiles, four real
// products per complex one).
//
// Complex values are interleaved (float2 / double2), the layout of
// torch.complex64 / torch.complex128.  The kernels make no CUDA call but
// their launch and allocate nothing, so a CUDA graph captures them.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

// Phase clocks (profiling build only, tools/bench_block_inverse_phases.py):
// thread 0 of each block adds the cycles of each phase of its block's
// timeline, barrier waits included, to g_clk[kind] (kind 0 the resident
// kernel, 1 the subtree kernel, 2 the refinement kernel): 0 load, 1 the
// nodes of order <= 32 but for their leaves, 2-6 the products and copies
// of the recursion's levels at depth 0-4, 7 x = Ri b and the refinements,
// 8 the gate's residual and reductions, 9 output, 10 the Gauss-Jordan
// leaves, 11 blocks.
constexpr int kClkSlots = 12;
constexpr int kClkKinds = 3;
#ifdef BI_PHASE_CLOCKS
__device__ unsigned long long g_clk[kClkKinds][kClkSlots];
struct Clk {
  int kind;
  long long prev;
  unsigned long long c[kClkSlots];
  __device__ explicit Clk(int k) : kind(k) {
    prev = clock64();
    for (int q = 0; q < kClkSlots; ++q) c[q] = 0;
  }
  __device__ void mark(int slot) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      c[slot] += now - prev;
      prev = now;
    }
  }
  __device__ void flush() {
    if (threadIdx.x == 0) {
      c[kClkSlots - 1] = 1;
      for (int q = 0; q < kClkSlots; ++q) atomicAdd(&g_clk[kind][q], c[q]);
    }
  }
};
#else
struct Clk {
  __device__ explicit Clk(int) {}
  __device__ void mark(int) {}
  __device__ void flush() {}
};
#endif

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };

// threads of an in-block kernel (resident, subtree) where one block fills an
// SM; complex64 systems small enough that two blocks share an SM take half
// (kThreads2Of, two_per_sm).  The in-block code reads blockDim.x.
template <typename T> constexpr int kThreadsOf = sizeof(T) == 4 ? 512 : 256;
template <typename T> constexpr int kThreads2Of = kThreadsOf<T> / 2;
constexpr size_t kSmemSM = 233472;   // shared memory of one SM
constexpr size_t kSmemPerBlock = 1024;  // what the SM reserves for a block
constexpr int kMaxWarps = 16;     // the reduction scratch's size
constexpr int kLeaf = 16;         // Gauss-Jordan leaf order (JAX _GJ_BASE)
constexpr int kWarpNode = 32;     // nodes of order <= 32: small_node
constexpr int kMaxDepth = 3;      // below order 171 every node of depth 3 is <= 32
constexpr int kPad = 8;           // elements past the matrix that a tile reads
constexpr size_t kSmemMax = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRefineThreads = 512;

// The in-block kernels' shared memory: the matrix at offset 0.  The
// functions below that are not inlined address it by element offsets from
// this symbol, so the compiler emits shared-memory loads and stores, not
// generic ones.
extern __shared__ __align__(16) unsigned char smem_raw[];
template <typename C> __device__ __forceinline__ C* smem() {
  return reinterpret_cast<C*>(smem_raw);
}

// Row stride of the shared matrix: even, so that rows start 16-byte aligned.
__host__ __device__ inline int ld_of(int n) { return n + (n & 1); }

// Shared memory of the in-block kernels: the n x ld matrix and its padding,
// the leaves' exchange buffers, x and the residual (solve only), the
// reduction scratch.  ops/block_inverse.py computes the same sizes
// (smem_bytes).
template <typename T>
__host__ __device__ size_t smem_bytes(int n, bool solve) {
  using C = typename Cplx<T>::type;
  return ((size_t)n * ld_of(n) + kPad + 2 * (kLeaf + 1) +
          (solve ? 2 * (size_t)n : 0)) *
             sizeof(C) +
         2 * kMaxWarps * sizeof(T);
}

__host__ __device__ inline int split_of(int n) {
  const int m = n >= 32 ? ((n / 2 + 7) & ~7) : n / 2;
  return m < n - 1 ? m : n - 1;
}

template <typename C> __device__ __forceinline__ C czero() {
  C r;
  r.x = 0;
  r.y = 0;
  return r;
}
template <typename C> __device__ __forceinline__ C cconj(const C& a) {
  C r;
  r.x = a.x;
  r.y = -a.y;
  return r;
}
template <typename C> __device__ __forceinline__ C cneg(const C& a) {
  C r;
  r.x = -a.x;
  r.y = -a.y;
  return r;
}
template <typename C> __device__ __forceinline__ C cmul(const C& a, const C& b) {
  C r;
  r.x = a.x * b.x - a.y * b.y;
  r.y = a.x * b.y + a.y * b.x;
  return r;
}
// s += a * b
template <typename C>
__device__ __forceinline__ void mac(C& s, const C& a, const C& b) {
  s.x = fma(a.x, b.x, s.x);
  s.x = fma(-a.y, b.y, s.x);
  s.y = fma(a.x, b.y, s.y);
  s.y = fma(a.y, b.x, s.y);
}
template <typename C> __device__ __forceinline__ C csub(const C& a, const C& b) {
  C r;
  r.x = a.x - b.x;
  r.y = a.y - b.y;
  return r;
}
template <typename C> __device__ __forceinline__ C crecip(const C& d) {
  const auto den = d.x * d.x + d.y * d.y;
  C r;
  r.x = d.x / den;
  r.y = -d.y / den;
  return r;
}
__device__ __forceinline__ float cabs_t(const float2& a) { return hypotf(a.x, a.y); }
__device__ __forceinline__ double cabs_t(const double2& a) { return hypot(a.x, a.y); }
template <typename C> __device__ __forceinline__ bool cfinite(const C& a) {
  return isfinite(a.x) && isfinite(a.y);
}
template <typename C> __device__ __forceinline__ C shfl_xor(const C& v, int m) {
  C r;
  r.x = __shfl_xor_sync(kFull, v.x, m);
  r.y = __shfl_xor_sync(kFull, v.y, m);
  return r;
}
template <typename C> __device__ __forceinline__ C shfl(const C& v, int src) {
  C r;
  r.x = __shfl_sync(kFull, v.x, src);
  r.y = __shfl_sync(kFull, v.y, src);
  return r;
}
// max that keeps a NaN (torch's amax propagates NaN)
template <typename T> __device__ __forceinline__ T nanmax(T a, T b) {
  return (a != a || b != b) ? (a != a ? a : b) : (a > b ? a : b);
}

// Two neighbouring complex values: one 16-byte access in complex64 (p
// 16-byte aligned), two in complex128.
__device__ __forceinline__ void ld2(const float2* p, float2& a, float2& b) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a = make_float2(v.x, v.y);
  b = make_float2(v.z, v.w);
}
__device__ __forceinline__ void ld2(const double2* p, double2& a, double2& b) {
  a = p[0];
  b = p[1];
}
__device__ __forceinline__ void st2(float2* p, const float2& a, const float2& b) {
  *reinterpret_cast<float4*>(p) = make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st2(double2* p, const double2& a, const double2& b) {
  p[0] = a;
  p[1] = b;
}

// acc[r][c] += a[r] b[c]
template <typename C, int TS>
__device__ __forceinline__ void mac_tile(C (&acc)[TS][TS], const C (&a)[TS],
                                         const C (&b)[TS]) {
#pragma unroll
  for (int r = 0; r < TS; ++r)
#pragma unroll
    for (int c = 0; c < TS; ++c) mac(acc[r][c], a[r], b[c]);
}

// Gauss-Jordan inverse with no pivoting of the n x n block at aoff (row
// stride ld, n <= kLeaf), in place, by warps 0 and 1 (JAX gj_inverse,
// eaqhm_tpu/ops/solver.py:66: the augmented [A | I] elimination, whose right
// half is kept where the left half's eliminated columns were).  Lane l of
// warp w holds row l % 16, columns 8 w + 4 (l / 16) .. +3, in registers,
// the identity past n (its rows and columns never reach the block's).  At
// step j the lanes holding column j publish it at xoff (two buffers of
// kLeaf + 1, used in turn, so one barrier of the 64 threads a step
// suffices); the pivot row reaches a warp's lanes by shuffles.
template <typename C>
__device__ __noinline__ void gj_leaf(int aoff, int ld, int n, int xoff) {
  C* a = smem<C>() + aoff;
  C* xch = smem<C>() + xoff;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane & 15, hq = lane >> 4, c0 = 8 * w + 4 * hq;
  C v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int c = c0 + t;
    if (r < n && c < n) {
      v[t] = a[r * ld + c];
    } else {
      v[t] = czero<C>();
      if (r == c) v[t].x = 1;
    }
  }
#pragma unroll
  for (int j = 0; j < kLeaf; ++j) {
    if (j < n) {  // uniform across the 64 threads
      C* buf = xch + (j & 1) * (kLeaf + 1);
      if (w == (j >> 3) && hq == ((j >> 2) & 1)) buf[r] = v[j & 3];
      asm volatile("bar.sync 1, 64;" ::: "memory");
      const C p = crecip(buf[j]);
      const C cj = buf[r];
      C rowj[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) rowj[t] = shfl(v[t], j + 16 * hq);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = c0 + t;
        const C rj = c == j ? p : cmul(rowj[t], p);
        if (r == j) v[t] = rj;
        else if (c == j) v[t] = cneg(cmul(cj, p));
        else v[t] = csub(v[t], cmul(cj, rj));
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int c = c0 + t;
    if (r < n && c < n) a[r * ld + c] = v[t];
  }
}

// out(i, j, sum_q A(i, q) B(q, j)) for i < rows, j < cols, one element
// per thread of the block; a barrier at the end.
template <typename T, typename FA, typename FB, typename FO>
__device__ __forceinline__ void sproduct(int rows, int cols, int kk, FA A,
                                         FB B, FO out) {
  using C = typename Cplx<T>::type;
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int i = e / cols, j = e - i * cols;
    C s = czero<C>();
    for (int q = 0; q < kk; ++q) mac(s, A(i, q), B(q, j));
    out(i, j, s);
  }
  __syncthreads();
}

// The node of order n <= kWarpNode at (o, o) of the shared matrix: a leaf,
// or one split into two leaves (as invert, below).  The leaves belong to
// warps 0 and 1 (gj_leaf, exchanging through xoff); the node's four
// products and its copy give one element to each thread of the block.  The
// whole block calls it; a barrier at the end.
template <typename T>
__device__ __noinline__ void small_node(int ld, int o, int n, int xoff,
                                        Clk& clk) {
  using C = typename Cplx<T>::type;
  const bool w0 = threadIdx.x < 64;
  C* P = smem<C>() + o * ld + o;
  clk.mark(1);
  if (n <= kLeaf) {
    if (w0) gj_leaf<C>(o * ld + o, ld, n, xoff);
    __syncthreads();
    clk.mark(10);
    return;
  }
  const int m = split_of(n), k = n - m;
  C* Q = P + m;
  C* L = P + m * ld;
  C* S = L + m;
  if (w0) gj_leaf<C>(o * ld + o, ld, m, xoff);
  __syncthreads();
  clk.mark(10);
  // L = T^H, T = P^-1 Q
  sproduct<T>(m, k, m, [=](int i, int q) { return P[i * ld + q]; },
              [=](int q, int j) { return Q[q * ld + j]; },
              [=](int i, int j, const C& v) { L[j * ld + i] = cconj(v); });
  // Sc = S - Q^H T: Sc[j, i] = S[j, i] - conj((L Q)[i, j])
  sproduct<T>(k, k, m, [=](int i, int q) { return L[i * ld + q]; },
              [=](int q, int j) { return Q[q * ld + j]; },
              [=](int i, int j, const C& v) {
                S[j * ld + i] = csub(S[j * ld + i], cconj(v));
              });
  clk.mark(1);
  if (w0) gj_leaf<C>((o + m) * ld + o + m, ld, k, xoff);
  __syncthreads();
  clk.mark(10);
  // Q = -U = -T Sc^-1, T[i, q] = conj(L[q, i])
  sproduct<T>(m, k, k, [=](int i, int q) { return cconj(L[q * ld + i]); },
              [=](int q, int j) { return S[q * ld + j]; },
              [=](int i, int j, const C& v) { Q[i * ld + j] = cneg(v); });
  // P = P^-1 + U T^H = P^-1 - Q L
  sproduct<T>(m, m, k, [=](int i, int q) { return Q[i * ld + q]; },
              [=](int q, int j) { return L[q * ld + j]; },
              [=](int i, int j, const C& v) {
                P[i * ld + j] = csub(P[i * ld + j], v);
              });
  // L = Q^H = -U^H
  for (int e = threadIdx.x; e < m * k; e += blockDim.x) {
    const int i = e / k, j = e - i * k;
    L[j * ld + i] = cconj(Q[i * ld + j]);
  }
  __syncthreads();
}

enum { kStoreCT = 0, kStoreNeg = 1, kSub = 2, kSubCT = 3 };

// out = op(sum_q A(i, q) B(q, j)) for i < rows, j < cols over blocks of the
// shared matrix (row stride ld) at offsets aoff (A), boff (Bm), ooff (out),
// by the whole block: A(i, q) = A[i ld + q] (kAT false) or conj(A[q ld + i])
// (kAT true), B(q, j) = Bm[q ld + j].  Each thread a TS x TS tile in
// registers; operands read two complex values at a time from
// 16-byte-aligned addresses (the blocks of a node of order > 32 start at
// even offsets).  kStoreNeg: out[i, j] = -s; kSub: out[i, j] -= s;
// kStoreCT: out[j, i] = conj(s); kSubCT: out[j, i] -= conj(s) (the
// conjugate transpose, so a product JAX takes as Q^H T is read from the
// operands the shared matrix holds).  Every store walks a row of out: the
// transposed modes write a column of the tile as a row.  Reads past a
// tile's last row or column stay inside the matrix and its padding and
// reach only results that are not stored.  A barrier at the end.
template <typename T, bool kAT, int kMode, int TS>
__device__ __noinline__ void product_ts(int aoff, int boff, int ooff, int ld,
                                        int rows, int cols, int kk) {
  using C = typename Cplx<T>::type;
  const C* A = smem<C>() + aoff;
  const C* Bm = smem<C>() + boff;
  C* O = smem<C>() + ooff;
  const int tr = (rows + TS - 1) / TS, tc = (cols + TS - 1) / TS;
  for (int t = threadIdx.x; t < tr * tc; t += blockDim.x) {
    const int ti = t / tc, tj = t - ti * tc;
    const int i0 = TS * ti, j0 = TS * tj;
    C acc[TS][TS];
#pragma unroll
    for (int r = 0; r < TS; ++r)
#pragma unroll
      for (int c = 0; c < TS; ++c) acc[r][c] = czero<C>();
    const C* bp = Bm + j0;
    if (kAT) {
      const C* ap = A + i0;
#pragma unroll 2
      for (int q = 0; q < kk; ++q) {
        C a[TS], b[TS];
#pragma unroll
        for (int h = 0; h < TS; h += 2) {
          ld2(ap + q * ld + h, a[h], a[h + 1]);
          ld2(bp + q * ld + h, b[h], b[h + 1]);
        }
#pragma unroll
        for (int r = 0; r < TS; ++r) a[r] = cconj(a[r]);
        mac_tile(acc, a, b);
      }
    } else {
      const C* ar[TS];
#pragma unroll
      for (int r = 0; r < TS; ++r) ar[r] = A + min(i0 + r, rows - 1) * ld;
      int q = 0;
#pragma unroll 2
      for (; q + 1 < kk; q += 2) {
        C a0[TS], a1[TS], b[TS];
#pragma unroll
        for (int r = 0; r < TS; ++r) ld2(ar[r] + q, a0[r], a1[r]);
#pragma unroll
        for (int h = 0; h < TS; h += 2) ld2(bp + q * ld + h, b[h], b[h + 1]);
        mac_tile(acc, a0, b);
#pragma unroll
        for (int h = 0; h < TS; h += 2)
          ld2(bp + (q + 1) * ld + h, b[h], b[h + 1]);
        mac_tile(acc, a1, b);
      }
      if (q < kk) {
        C a0[TS], b[TS];
#pragma unroll
        for (int r = 0; r < TS; ++r) a0[r] = ar[r][q];
#pragma unroll
        for (int h = 0; h < TS; h += 2) ld2(bp + q * ld + h, b[h], b[h + 1]);
        mac_tile(acc, a0, b);
      }
    }
    if (kMode == kStoreCT || kMode == kSubCT) {
#pragma unroll
      for (int c = 0; c < TS; ++c) {
        const int j = j0 + c;
        if (j >= cols) break;
        C* orow = O + j * ld + i0;
#pragma unroll
        for (int h = 0; h < TS; h += 2) {
          C v0 = cconj(acc[h][c]), v1 = cconj(acc[h + 1][c]);
          if (i0 + h + 1 < rows) {
            if (kMode == kSubCT) {
              C o0, o1;
              ld2(orow + h, o0, o1);
              v0 = csub(o0, v0);
              v1 = csub(o1, v1);
            }
            st2(orow + h, v0, v1);
          } else if (i0 + h < rows) {
            orow[h] = kMode == kSubCT ? csub(orow[h], v0) : v0;
          }
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < TS; ++r) {
        const int i = i0 + r;
        if (i >= rows) break;
        C* orow = O + i * ld + j0;
#pragma unroll
        for (int h = 0; h < TS; h += 2) {
          C v0 = acc[r][h], v1 = acc[r][h + 1];
          if (j0 + h + 1 < cols) {
            if (kMode == kSub) {
              C o0, o1;
              ld2(orow + h, o0, o1);
              v0 = csub(o0, v0);
              v1 = csub(o1, v1);
            } else {
              v0 = cneg(v0);
              v1 = cneg(v1);
            }
            st2(orow + h, v0, v1);
          } else if (j0 + h < cols) {
            orow[h] = kMode == kSub ? csub(orow[h], v0) : cneg(v0);
          }
        }
      }
    }
  }
  __syncthreads();
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

// product_ts in complex128 on the FP64 tensor cores: each warp a 16 x 16
// tile of the result as 2 x 2 tiles of mma.m8n8k4.f64, four real products
// per complex one (as chol_solve.cu's tile_c128).  Fragments (PTX ISA,
// m8n8k4 .f64): A[g][q], B[q][g], C[g][2q + e] with g = lane / 4,
// q = lane % 4; the depth's last chunk reads zeros past kk, rows and
// columns past the result repeat its last one and are not stored.  The
// same operands, modes and stores as product_ts; a barrier at the end.
template <bool kAT, int kMode>
__device__ __noinline__ void product_mma(int aoff, int boff, int ooff, int ld,
                                         int rows, int cols, int kk) {
  using C = double2;
  const C* A = smem<C>() + aoff;
  const C* Bm = smem<C>() + boff;
  C* O = smem<C>() + ooff;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int nwarps = blockDim.x >> 5;
  const int tr = (rows + 15) >> 4, tc = (cols + 15) >> 4;
  for (int t = threadIdx.x >> 5; t < tr * tc; t += nwarps) {
    const int i0 = 16 * (t / tc), j0 = 16 * (t - (t / tc) * tc);
    int ia[2], jb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ia[h] = min(i0 + 8 * h + g, rows - 1);
      jb[h] = min(j0 + 8 * h + g, cols - 1);
    }
    double cr[2][2][2], ci[2][2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int e = 0; e < 2; ++e) cr[u][v][e] = ci[u][v][e] = 0.0;
#pragma unroll 2
    for (int k0 = 0; k0 < kk; k0 += 4) {
      const int k = k0 + q;
      C fa[2], fb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (k < kk) {
          fa[h] = kAT ? cconj(A[k * ld + ia[h]]) : A[ia[h] * ld + k];
          fb[h] = Bm[k * ld + jb[h]];
        } else {
          fa[h] = fb[h] = czero<C>();
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          mma_f64(cr[u][v], fa[u].x, fb[v].x);
          mma_f64(cr[u][v], -fa[u].y, fb[v].y);
          mma_f64(ci[u][v], fa[u].x, fb[v].y);
          mma_f64(ci[u][v], fa[u].y, fb[v].x);
        }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + 8 * u + g;
      if (i >= rows) continue;
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * v + 2 * q + e;
          if (j >= cols) continue;
          C s;
          s.x = cr[u][v][e];
          s.y = ci[u][v][e];
          if (kMode == kStoreCT) {
            O[j * ld + i] = cconj(s);
          } else if (kMode == kSubCT) {
            O[j * ld + i] = csub(O[j * ld + i], cconj(s));
          } else if (kMode == kSub) {
            O[i * ld + j] = csub(O[i * ld + j], s);
          } else {
            O[i * ld + j] = cneg(s);
          }
        }
    }
  }
  __syncthreads();
}

// The block's products: complex128 on the FP64 tensor cores
// (product_mma); complex64 on the FP32 pipes (product_ts) with 4 x 4 tiles
// where they keep half the block busy, 2 x 2 below (the middle levels of
// the recursion: at M = 130 a 4 x 4 tiling of the order-72 node's
// T = P^-1 Q gives 80 tiles for 512 threads).
template <typename T, bool kAT, int kMode>
__device__ __forceinline__ void product(int aoff, int boff, int ooff, int ld,
                                        int rows, int cols, int kk) {
  if constexpr (sizeof(T) == 8) {
    product_mma<kAT, kMode>(aoff, boff, ooff, ld, rows, cols, kk);
  } else {
    if (2 * ((rows + 3) / 4) * ((cols + 3) / 4) >= (int)blockDim.x)
      product_ts<T, kAT, kMode, 4>(aoff, boff, ooff, ld, rows, cols, kk);
    else
      product_ts<T, kAT, kMode, 2>(aoff, boff, ooff, ld, rows, cols, kk);
  }
}

// L[j, i] = conj(Q[i, j]) for the m x k block Q (offsets qoff, loff), as
// 4 x 4 tiles: rows of four read, rows of four written.  A barrier at the
// end.
template <typename T>
__device__ __noinline__ void copy_ct(int qoff, int loff, int ld, int m,
                                     int k) {
  using C = typename Cplx<T>::type;
  const C* Q = smem<C>() + qoff;
  C* L = smem<C>() + loff;
  const int tr = (m + 3) >> 2, tc = (k + 3) >> 2;
  for (int t = threadIdx.x; t < tr * tc; t += blockDim.x) {
    const int ti = t / tc, tj = t - ti * tc;
    const int i0 = 4 * ti, j0 = 4 * tj;
    if (i0 + 3 < m && j0 + 3 < k) {
      C v[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ld2(Q + (i0 + r) * ld + j0, v[r][0], v[r][1]);
        ld2(Q + (i0 + r) * ld + j0 + 2, v[r][2], v[r][3]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        st2(L + (j0 + c) * ld + i0, cconj(v[0][c]), cconj(v[1][c]));
        st2(L + (j0 + c) * ld + i0 + 2, cconj(v[2][c]), cconj(v[3][c]));
      }
    } else {
      for (int r = 0; r < 4 && i0 + r < m; ++r)
        for (int c = 0; c < 4 && j0 + c < k; ++c)
          L[(j0 + c) * ld + i0 + r] = cconj(Q[(i0 + r) * ld + j0 + c]);
    }
  }
  __syncthreads();
}

// In-place inverse of the HPD node of order n at (o, o) of the shared
// matrix (row stride ld), by JAX's recursion (see the note above); xoff:
// the leaves' exchange buffers.
template <typename T, int D>
__device__ void invert(int ld, int o, int n, int xoff, Clk& clk) {
  if (n <= kWarpNode) {
    small_node<T>(ld, o, n, xoff, clk);
    clk.mark(1);
    return;
  }
  if constexpr (D < kMaxDepth) {
    const int m = split_of(n), k = n - m;
    const int P = o * ld + o;   // m x m
    const int Q = P + m;        // m x k (upper right)
    const int L = P + m * ld;   // k x m (lower left)
    const int S = L + m;        // k x k
    invert<T, D + 1>(ld, o, m, xoff, clk);
    // L = T^H, T = P^-1 Q
    product<T, false, kStoreCT>(P, Q, L, ld, m, k, m);
    // S = S - Q^H T = Sc: Sc[j, i] = S[j, i] - conj((L Q)[i, j])
    product<T, false, kSubCT>(L, Q, S, ld, k, k, m);
    clk.mark(2 + D);
    invert<T, D + 1>(ld, o + m, k, xoff, clk);
    // Q = -(T S) = -T Sc^-1 = -U, T[i, q] = conj(L[q, i])
    product<T, true, kStoreNeg>(L, S, Q, ld, m, k, k);
    // P = P - Q L = P^-1 + U T^H
    product<T, false, kSub>(Q, L, P, ld, m, m, k);
    // L = Q^H = -U^H
    copy_ct<T>(Q, L, ld, m, k);
    clk.mark(2 + D);
  } else {
    __trap();  // unreachable: the launchers take no order above 170
  }
}

// y[i] = sum_k A[i, k] v[k] (kMode 1: y[i] = w[i] - ..., 2: y[i] += ...),
// one warp per row, each lane two neighbouring elements of the row at a
// time, kU of them in flight.  A may lie in shared or device memory
// (generic pointers; a row of a complex64 A that starts 8 bytes off its
// 16-byte alignment takes its first element alone); a barrier at the end.
template <typename T, int kMode, int kU>
__device__ void gemv(const typename Cplx<T>::type* A, int lda,
                     const typename Cplx<T>::type* v,
                     const typename Cplx<T>::type* w,
                     typename Cplx<T>::type* y, int n) {
  using C = typename Cplx<T>::type;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += nwarps) {
    const C* row = A + (size_t)i * lda;
    C s = czero<C>();
    int k0 = 0;
    if (sizeof(C) == 8 && (reinterpret_cast<uintptr_t>(row) & 15)) {
      if (lane == 0) mac(s, row[0], v[0]);
      k0 = 1;
    }
    for (int kb = k0 + 2 * lane; kb < n; kb += 64 * kU) {
      C av[kU][2], vv[kU][2];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int q = kb + 64 * u;
        if (q + 1 < n) {
          ld2(row + q, av[u][0], av[u][1]);
          vv[u][0] = v[q];
          vv[u][1] = v[q + 1];
        } else if (q < n) {
          av[u][0] = row[q];
          vv[u][0] = v[q];
          av[u][1] = vv[u][1] = czero<C>();
        } else {
          av[u][0] = av[u][1] = vv[u][0] = vv[u][1] = czero<C>();
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        mac(s, av[u][0], vv[u][0]);
        mac(s, av[u][1], vv[u][1]);
      }
    }
#pragma unroll
    for (int d = 16; d; d >>= 1) {
      const C o = shfl_xor(s, d);
      s.x += o.x;
      s.y += o.y;
    }
    if (lane == 0) {
      if (kMode == 0) {
        y[i] = s;
      } else if (kMode == 1) {
        y[i] = csub(w[i], s);
      } else {
        y[i].x += s.x;
        y[i].y += s.y;
      }
    }
  }
  __syncthreads();
}

// The same product for the short rows of the resident path (n <= 168):
// four lanes per row, eight rows a warp, each lane two neighbouring
// elements at a time with two sums, so a pass over the matrix takes one or
// two rounds of the warps instead of one per row; a barrier at the end.
template <typename T, int kMode>
__device__ void gemv_short(const typename Cplx<T>::type* A, int lda,
                           const typename Cplx<T>::type* v,
                           const typename Cplx<T>::type* w,
                           typename Cplx<T>::type* y, int n) {
  using C = typename Cplx<T>::type;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane & 3;
  for (int i0 = warp * 8; i0 < n; i0 += nwarps * 8) {
    const int i = i0 + (lane >> 2);
    const C* row = A + (size_t)min(i, n - 1) * lda;
    C s0 = czero<C>(), s1 = czero<C>();
    int k0 = 0;
    if (sizeof(C) == 8 && (reinterpret_cast<uintptr_t>(row) & 15)) {
      if (sub == 0) mac(s0, row[0], v[0]);
      k0 = 1;
    }
#pragma unroll 4
    for (int q = k0 + 2 * sub; q < n; q += 8) {
      if (q + 1 < n) {
        C a0, a1;
        ld2(row + q, a0, a1);
        mac(s0, a0, v[q]);
        mac(s1, a1, v[q + 1]);
      } else {
        mac(s0, row[q], v[q]);
      }
    }
    s0.x += s1.x;
    s0.y += s1.y;
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      const C o = shfl_xor(s0, d);
      s0.x += o.x;
      s0.y += o.y;
    }
    if (sub == 0 && i < n) {
      if (kMode == 0) {
        y[i] = s0;
      } else if (kMode == 1) {
        y[i] = csub(w[i], s0);
      } else {
        y[i].x += s0.x;
        y[i].y += s0.y;
      }
    }
  }
  __syncthreads();
}

template <typename T, bool kShort, int kU, int kMode>
__device__ __forceinline__ void mv_pass(const typename Cplx<T>::type* A,
                                        int lda,
                                        const typename Cplx<T>::type* v,
                                        const typename Cplx<T>::type* w,
                                        typename Cplx<T>::type* y, int n) {
  if (kShort)
    gemv_short<T, kMode>(A, lda, v, w, y, n);
  else
    gemv<T, kMode, kU>(A, lda, v, w, y, n);
}

// Steps 2 and 3 for one system: x = Ri b, two refinements, the gate
// inputs.  Ri (row stride ldr) and x, r (n each) in shared or device
// memory; R [n, n] and b in device memory; red: 2 kMaxWarps T of shared
// memory.  kShort: gemv_short (the resident path), else gemv with kU
// pairs a lane in flight (the hybrid path's long rows in device memory).
template <typename T, bool kShort, int kU>
__device__ void refine(const typename Cplx<T>::type* Ri, int ldr,
                       const typename Cplx<T>::type* R,
                       const typename Cplx<T>::type* b,
                       typename Cplx<T>::type* x, typename Cplx<T>::type* r,
                       T* red, int n, T gate, T* ratio,
                       unsigned char* finite, unsigned char* ok, Clk& clk) {
  mv_pass<T, kShort, kU, 0>(Ri, ldr, b, nullptr, x, n);
  for (int it = 0; it < 2; ++it) {
    mv_pass<T, kShort, kU, 1>(R, n, x, b, r, n);
    mv_pass<T, kShort, kU, 2>(Ri, ldr, r, nullptr, x, n);
  }
  clk.mark(7);
  mv_pass<T, kShort, kU, 1>(R, n, x, b, r, n);
  T rmax = 0, bmax = 0;
  bool fin = true;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    rmax = nanmax(rmax, cabs_t(r[i]));
    bmax = nanmax(bmax, cabs_t(b[i]));
    fin = fin && cfinite(x[i]);
  }
  fin = __syncthreads_and(fin);
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    rmax = nanmax(rmax, __shfl_xor_sync(kFull, rmax, d));
    bmax = nanmax(bmax, __shfl_xor_sync(kFull, bmax, d));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = rmax;
    red[kMaxWarps + warp] = bmax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      rmax = nanmax(rmax, red[w]);
      bmax = nanmax(bmax, red[kMaxWarps + w]);
    }
    const T q = rmax == T(0) ? T(0) : rmax / bmax;
    *ratio = q;
    *finite = fin ? 1 : 0;
    if (!(fin && q <= gate)) *ok = 0;
  }
  clk.mark(8);
}

// The n x n block at src (row stride lds) into the shared matrix a (row
// stride ld) by asynchronous copies, every element in flight at once; a
// barrier at the end.
template <typename C>
__device__ void load_block(const C* src, long long lds, C* a, int ld, int n) {
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    __pipeline_memcpy_async(a + i * ld + j, src + (size_t)i * lds + j,
                            sizeof(C));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Resident path: the whole solve of one system per block (NT threads).
template <typename T, int NT>
__global__ void __launch_bounds__(NT, kThreadsOf<T> / NT)
    bi_resident_kernel(const typename Cplx<T>::type* R,
                       const typename Cplx<T>::type* rhs,
                       typename Cplx<T>::type* x, T* ratio,
                       unsigned char* finite, unsigned char* ok, int n,
                       T gate) {
  using C = typename Cplx<T>::type;
  const int ld = ld_of(n);
  C* a = smem<C>();
  const int xoff = n * ld + kPad;
  C* xs = a + xoff + 2 * (kLeaf + 1);
  C* rs = xs + n;
  T* red = reinterpret_cast<T*>(rs + n);
  const size_t b = blockIdx.x;
  const C* Rb = R + b * n * n;
  Clk clk(0);
  load_block(Rb, n, a, ld, n);
  clk.mark(0);
  invert<T, 0>(ld, 0, n, xoff, clk);
  refine<T, true, 2>(a, ld, Rb, rhs + b * n, xs, rs, red, n, gate, ratio + b,
                  finite + b, ok, clk);
  for (int i = threadIdx.x; i < n; i += NT) x[b * n + i] = xs[i];
  clk.mark(9);
  clk.flush();
}

// Hybrid path, one subtree: the n x n block of each system at src (system
// stride bs, row stride ldg) inverted into dst (the same strides), NT
// threads.
template <typename T, int NT>
__global__ void __launch_bounds__(NT, kThreadsOf<T> / NT)
    bi_invert_kernel(const typename Cplx<T>::type* src,
                     typename Cplx<T>::type* dst, long long bs, int ldg,
                     int n) {
  using C = typename Cplx<T>::type;
  const int ld = ld_of(n);
  C* a = smem<C>();
  const size_t off = (size_t)blockIdx.x * bs;
  Clk clk(1);
  load_block(src + off, ldg, a, ld, n);
  clk.mark(0);
  invert<T, 0>(ld, 0, n, n * ld + kPad, clk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += NT / 32) {
    C* drow = dst + off + (size_t)i * ldg;
    for (int j = lane; j < n; j += 32) drow[j] = a[i * ld + j];
  }
  clk.mark(9);
  clk.flush();
}

// Hybrid path, steps 2 and 3 from the workspace Ri [B, n, n]; x and r
// [B, n] in device memory (a block reads back only what it wrote, after a
// barrier).  Two blocks per SM.
template <typename T>
__global__ void __launch_bounds__(kRefineThreads, 2)
    bi_refine_kernel(const typename Cplx<T>::type* Ri,
                     const typename Cplx<T>::type* R,
                     const typename Cplx<T>::type* rhs,
                     typename Cplx<T>::type* x, typename Cplx<T>::type* r,
                     T* ratio, unsigned char* finite, unsigned char* ok,
                     int n, T gate) {
  __shared__ T red[2 * kMaxWarps];
  const size_t b = blockIdx.x;
  Clk clk(2);
  refine<T, false, sizeof(T) == 4 ? 4 : 2>(
      Ri + b * n * n, n, R + b * n * n, rhs + b * n, x + b * n, r + b * n, red,
      n, gate, ratio + b, finite + b, ok, clk);
  clk.flush();
}

template <typename K>
int prepare(K kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

// The kernels' shared-memory attributes, once per device (as in
// chol_solve.cu: at the first launch on a device, or in bi_prepare ahead of
// a CUDA graph capture).
constexpr int kMaxDevices = 64;
std::atomic<int> g_prepared[kMaxDevices];

int prepare_all() {
  int dev = 0;
  const cudaError_t g = cudaGetDevice(&dev);
  if (g != cudaSuccess) return (int)g;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (g_prepared[dev].load(std::memory_order_acquire)) return 0;
  int e = prepare(bi_resident_kernel<float, kThreadsOf<float>>, kSmemMax);
  if (!e) e = prepare(bi_resident_kernel<float, kThreads2Of<float>>, kSmemMax);
  if (!e) e = prepare(bi_resident_kernel<double, kThreadsOf<double>>, kSmemMax);
  if (!e) e = prepare(bi_invert_kernel<float, kThreadsOf<float>>, kSmemMax);
  if (!e) e = prepare(bi_invert_kernel<float, kThreads2Of<float>>, kSmemMax);
  if (!e) e = prepare(bi_invert_kernel<double, kThreadsOf<double>>, kSmemMax);
  if (!e) g_prepared[dev].store(1, std::memory_order_release);
  return e;
}

template <typename T>
int path_of(int M) {
  if (M < 1) return -1;
  return smem_bytes<T>(M, true) <= kSmemMax ? 0 : 1;
}

// Whether two blocks of half the threads take the in-block kernel at this
// order: complex64, and two fit one SM's shared memory (two blocks of 128
// threads measured no faster than one of 256 in complex128 on an NVIDIA H100
// 80GB HBM3 at 700 W).
template <typename T>
bool two_per_sm(size_t smem) {
  return sizeof(T) == 4 && 2 * (smem + kSmemPerBlock) <= kSmemSM;
}

template <typename T>
int subtree_max() {
  int n = 1;
  while (smem_bytes<T>(n + 1, false) <= kSmemMax) ++n;
  return n;
}

template <typename T>
int launch_resident(const void* R, const void* rhs, void* x, void* ratio,
                    void* finite, void* ok, int B, int M, double gate,
                    void* stream) {
  using C = typename Cplx<T>::type;
  if (B <= 0) return 0;
  if (path_of<T>(M) != 0) return (int)cudaErrorInvalidValue;
  const int e = prepare_all();
  if (e) return e;
  const size_t smem = smem_bytes<T>(M, true);
  if (two_per_sm<T>(smem))
    bi_resident_kernel<T, kThreads2Of<T>><<<B, kThreads2Of<T>, smem,
                                       (cudaStream_t)stream>>>(
        (const C*)R, (const C*)rhs, (C*)x, (T*)ratio, (unsigned char*)finite,
        (unsigned char*)ok, M, (T)gate);
  else
    bi_resident_kernel<T, kThreadsOf<T>><<<B, kThreadsOf<T>, smem,
                                           (cudaStream_t)stream>>>(
        (const C*)R, (const C*)rhs, (C*)x, (T*)ratio, (unsigned char*)finite,
        (unsigned char*)ok, M, (T)gate);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_invert(const void* src, void* dst, long long bs, int ld, int B,
                  int n, void* stream) {
  using C = typename Cplx<T>::type;
  if (B <= 0) return 0;
  if (n < 1 || n > ld || smem_bytes<T>(n, false) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int e = prepare_all();
  if (e) return e;
  const size_t smem = smem_bytes<T>(n, false);
  if (two_per_sm<T>(smem))
    bi_invert_kernel<T, kThreads2Of<T>><<<B, kThreads2Of<T>, smem,
                                     (cudaStream_t)stream>>>(
        (const C*)src, (C*)dst, bs, ld, n);
  else
    bi_invert_kernel<T, kThreadsOf<T>><<<B, kThreadsOf<T>, smem,
                                         (cudaStream_t)stream>>>(
        (const C*)src, (C*)dst, bs, ld, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_refine(const void* Ri, const void* R, const void* rhs, void* x,
                  void* r, void* ratio, void* finite, void* ok, int B, int M,
                  double gate, void* stream) {
  using C = typename Cplx<T>::type;
  if (B <= 0) return 0;
  if (M < 1) return (int)cudaErrorInvalidValue;
  bi_refine_kernel<T><<<B, kRefineThreads, 0, (cudaStream_t)stream>>>(
      (const C*)Ri, (const C*)R, (const C*)rhs, (C*)x, (C*)r, (T*)ratio,
      (unsigned char*)finite, (unsigned char*)ok, M, (T)gate);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Set the kernels' shared-memory attributes on the current device now.
// Returns the cudaError_t (0 on success).
int bi_prepare() { return prepare_all(); }

// Profiling build: copies the phase clocks (see BI_PHASE_CLOCKS) to
// out[3][12] (kind, slot) and zeroes them; -1 in the normal build.
int bi_phase_clocks(unsigned long long* out) {
#ifdef BI_PHASE_CLOCKS
  cudaError_t e = cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[kClkKinds][kClkSlots] = {};
  return (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(g_clk));
#else
  (void)out;
  return -1;
#endif
}

// 0: resident (one launch per batch), 1: hybrid; -1 for M < 1.
int bi_path(int M, int c128) {
  return c128 ? path_of<double>(M) : path_of<float>(M);
}

// The largest subtree order one bi_invert launch takes.
int bi_subtree_max(int c128) {
  return c128 ? subtree_max<double>() : subtree_max<float>();
}

// Resident path.  R: [B, M, M], rhs / x: [B, M] complex64; ratio: [B]
// float32, finite: [B] bool out; ok: one bool the caller set to true,
// cleared when a system fails the gate (ratio <= gate, x finite).  Returns
// the cudaError_t of the launch (invalid value where M is not resident).
int bi_solve_resident_c64(const void* R, const void* rhs, void* x,
                          void* ratio, void* finite, void* ok, int B, int M,
                          double gate, void* stream) {
  return launch_resident<float>(R, rhs, x, ratio, finite, ok, B, M, gate,
                                stream);
}

int bi_solve_resident_c128(const void* R, const void* rhs, void* x,
                           void* ratio, void* finite, void* ok, int B, int M,
                           double gate, void* stream) {
  return launch_resident<double>(R, rhs, x, ratio, finite, ok, B, M, gate,
                                 stream);
}

// Hybrid path, one subtree: the n x n blocks at src (system stride bs
// elements, row stride ld) inverted into dst (the same strides; dst may be
// src).
int bi_invert_c64(const void* src, void* dst, long long bs, int ld, int B,
                  int n, void* stream) {
  return launch_invert<float>(src, dst, bs, ld, B, n, stream);
}

int bi_invert_c128(const void* src, void* dst, long long bs, int ld, int B,
                   int n, void* stream) {
  return launch_invert<double>(src, dst, bs, ld, B, n, stream);
}

// Hybrid path, the solve: Ri, R [B, M, M]; rhs, x, r (scratch) [B, M];
// ratio, finite, ok as for the resident path.
int bi_refine_c64(const void* Ri, const void* R, const void* rhs, void* x,
                  void* r, void* ratio, void* finite, void* ok, int B, int M,
                  double gate, void* stream) {
  return launch_refine<float>(Ri, R, rhs, x, r, ratio, finite, ok, B, M, gate,
                              stream);
}

int bi_refine_c128(const void* Ri, const void* R, const void* rhs, void* x,
                   void* r, void* ratio, void* finite, void* ok, int B, int M,
                   double gate, void* stream) {
  return launch_refine<double>(Ri, R, rhs, x, r, ratio, finite, ok, B, M,
                               gate, stream);
}

}  // extern "C"
