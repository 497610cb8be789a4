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
//      no pivoting.  The split rule and the leaf order are JAX's: they fix
//      the float32 rounding, and with it which batches trip the gate.
//   2. x = Ri b, then two refinements x += Ri (b - R x), each residual
//      against R in the same type.
//   3. The gate inputs per system: ||b - R x||inf / ||b||inf of the returned
//      x (0 where the residual is 0, NaN where it is NaN) and whether every
//      entry of x is finite; and one flag for the batch, cleared when any
//      system is not finite or its ratio is not <= the caller's gate.
//
// What bounds it on an H100: the recursion does 2M^3/3 complex
// multiply-adds per system against M^2 elements of R read, so it is bound
// by arithmetic at every order of the main path (M = 98-1294).  complex64
// runs on FP32 FMA on the CUDA cores (no TF32), complex128 in FP64.
//
// Two entry points and two paths (bi_path):
// - Resident (complex64 M <= 169, complex128 M <= 119): one block of 256
//   threads per system holds R, then Ri, in shared memory and builds Ri in
//   place; the refinements and the gate read R again from device memory
//   (L2) and keep x and the residual in shared memory.  One launch per
//   batch; x, the ratios and the flags are its only writes.
// - Hybrid, beyond: the caller keeps Ri in a device-memory workspace (a
//   copy of R).  Every subtree of the recursion whose order fits one block
//   (complex64 <= 170, complex128 <= 120) is one launch of bi_invert_*,
//   which stages the block in shared memory, runs the same in-place
//   recursion and writes it back; the levels above are batched matrix
//   products (cuBLAS through torch.matmul, as JAX left them to XLA); then
//   bi_refine_* runs step 2 and 3 from the workspace, with x and the
//   residual in device memory.
//
// The in-place recursion on a node [[P, Q], [Q^H, S]] of the shared matrix
// (row stride ld) needs no storage beyond it: P^-1 in place; T^H = (P^-1 Q)^H
// into the lower-left block; Sc = S - T^H Q in place (T^H Q = Q^H T, P^-1
// being Hermitian); Sc^-1 in place; -U = -T Sc^-1 into the upper right;
// P^-1 + U T^H = P^-1 - (-U) T^H in place; -U^H into the lower left.  Every
// product reads its operands row-wise (no bank conflicts) except the
// transposed stores.  Each thread computes a 2 x 2 tile of a product in
// registers.
//
// Complex values are interleaved (float2 / double2), the layout of
// torch.complex64 / torch.complex128.  The kernels make no CUDA call but
// their launch and allocate nothing, so a CUDA graph captures them.
#include <cuda_runtime.h>

#include <math.h>

#include <atomic>

namespace {

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };

constexpr int kThreads = 256;     // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kLeaf = 16;         // Gauss-Jordan leaf order (JAX _GJ_BASE)
constexpr int kMaxDepth = 4;      // below order 171 every depth-4 node is a leaf
constexpr size_t kSmemMax = 232448;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of the resident kernels: the n x n matrix, the leaf's pivot
// row and column, x and the residual (solve only), the reduction scratch.
// ops/block_inverse.py computes the same sizes (smem_bytes).
template <typename T>
__host__ __device__ size_t smem_bytes(int n, bool solve) {
  using C = typename Cplx<T>::type;
  return ((size_t)n * n + 2 * kLeaf + (solve ? 2 * (size_t)n : 0)) *
             sizeof(C) +
         2 * kWarps * sizeof(T);
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
// max that keeps a NaN (torch's amax propagates NaN)
template <typename T> __device__ __forceinline__ T nanmax(T a, T b) {
  return (a != a || b != b) ? (a != a ? a : b) : (a > b ? a : b);
}

// Gauss-Jordan inverse with no pivoting of the n x n block at a (row stride
// ld, n <= kLeaf), in place (JAX gj_inverse, eaqhm_tpu/ops/solver.py:66:
// the augmented [A | I] elimination, whose right half is kept where the
// left half's eliminated columns were).  All threads call it.
template <typename C>
__device__ void gj_leaf(C* a, int ld, int n, C* rowj, C* colj) {
  for (int j = 0; j < n; ++j) {
    const C p = crecip(a[j * ld + j]);
    for (int t = threadIdx.x; t < n; t += kThreads) {
      rowj[t] = t == j ? p : cmul(a[j * ld + t], p);
      colj[t] = a[t * ld + j];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n * n; e += kThreads) {
      const int i = e / n, k = e - i * n;
      C v;
      if (i == j) {
        v = rowj[k];
      } else if (k == j) {
        v = cneg(cmul(colj[i], p));
      } else {
        v = a[i * ld + k];
        const C c = colj[i], r = rowj[k];
        v = csub(v, cmul(c, r));
      }
      a[i * ld + k] = v;
    }
    __syncthreads();
  }
}

// out(i, j, sum_k A(i, k) B(k, j)) for i < rows, j < cols; each thread a
// 2 x 2 tile; a barrier at the end.  All threads call it.
template <typename C, typename FA, typename FB, typename FO>
__device__ __forceinline__ void product(int rows, int cols, int kk, FA A, FB B,
                                        FO out) {
  const int tr = (rows + 1) >> 1, tc = (cols + 1) >> 1;
  for (int t = threadIdx.x; t < tr * tc; t += kThreads) {
    const int ti = t / tc;
    const int i0 = ti * 2, j0 = (t - ti * tc) * 2;
    const bool i1ok = i0 + 1 < rows, j1ok = j0 + 1 < cols;
    const int i1 = i1ok ? i0 + 1 : i0, j1 = j1ok ? j0 + 1 : j0;
    C s00 = czero<C>(), s01 = czero<C>(), s10 = czero<C>(), s11 = czero<C>();
#pragma unroll 4
    for (int k = 0; k < kk; ++k) {
      const C a0 = A(i0, k), a1 = A(i1, k), b0 = B(k, j0), b1 = B(k, j1);
      mac(s00, a0, b0);
      mac(s01, a0, b1);
      mac(s10, a1, b0);
      mac(s11, a1, b1);
    }
    out(i0, j0, s00);
    if (j1ok) out(i0, j1, s01);
    if (i1ok) {
      out(i1, j0, s10);
      if (j1ok) out(i1, j1, s11);
    }
  }
  __syncthreads();
}

// In-place inverse of the HPD node of order n at (o, o) of the shared
// matrix a (row stride ld), by JAX's recursion (see the note above).
template <typename C, int D>
__device__ void invert(C* a, int ld, int o, int n, C* rowj, C* colj) {
  if (n <= kLeaf) {
    gj_leaf(a + o * ld + o, ld, n, rowj, colj);
    return;
  }
  if constexpr (D < kMaxDepth) {
    const int m = split_of(n), k = n - m;
    C* P = a + o * ld + o;   // m x m
    C* Q = P + m;            // m x k (upper right)
    C* L = P + m * ld;       // k x m (lower left)
    C* S = L + m;            // k x k
    invert<C, D + 1>(a, ld, o, m, rowj, colj);
    // L = (P^-1 Q)^H = T^H
    product<C>(m, k, m, [=](int i, int q) { return P[i * ld + q]; },
               [=](int q, int j) { return Q[q * ld + j]; },
               [=](int i, int j, const C& v) { L[j * ld + i] = cconj(v); });
    // S -= T^H Q
    product<C>(k, k, m, [=](int i, int q) { return L[i * ld + q]; },
               [=](int q, int j) { return Q[q * ld + j]; },
               [=](int i, int j, const C& v) {
                 S[i * ld + j] = csub(S[i * ld + j], v);
               });
    invert<C, D + 1>(a, ld, o + m, k, rowj, colj);
    // Q = -U = -T Sc^-1, T[i, q] = conj(L[q, i])
    product<C>(m, k, k, [=](int i, int q) { return cconj(L[q * ld + i]); },
               [=](int q, int j) { return S[q * ld + j]; },
               [=](int i, int j, const C& v) { Q[i * ld + j] = cneg(v); });
    // P = P^-1 + U T^H = P^-1 - Q L
    product<C>(m, m, k, [=](int i, int q) { return Q[i * ld + q]; },
               [=](int q, int j) { return L[q * ld + j]; },
               [=](int i, int j, const C& v) {
                 P[i * ld + j] = csub(P[i * ld + j], v);
               });
    // L = Q^H = -U^H
    for (int e = threadIdx.x; e < m * k; e += kThreads) {
      const int i = e / k, j = e - i * k;
      L[j * ld + i] = cconj(Q[i * ld + j]);
    }
    __syncthreads();
  } else {
    __trap();  // unreachable: the launchers take no order above 170
  }
}

// y[i] = sum_k A[i, k] v[k] (minus: y[i] = w[i] - ..., add: y[i] += ...),
// one warp per row, lanes across the row.  A may lie in shared or device
// memory (generic pointers); a barrier at the end.
template <typename C, int kMode>  // 0: y = A v, 1: y = w - A v, 2: y += A v
__device__ void gemv(const C* A, int lda, const C* v, const C* w, C* y,
                     int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += kWarps) {
    const C* row = A + (size_t)i * lda;
    C s = czero<C>();
    for (int k = lane; k < n; k += 32) mac(s, row[k], v[k]);
#pragma unroll
    for (int d = 16; d; d >>= 1) {
      const C o = shfl_xor(s, d);
      s.x += o.x;
      s.y += o.y;
    }
    if (lane == 0) {
      if (kMode == 0) y[i] = s;
      else if (kMode == 1) y[i] = csub(w[i], s);
      else { y[i].x += s.x; y[i].y += s.y; }
    }
  }
  __syncthreads();
}

// Steps 2 and 3 for one system: x = Ri b, two refinements, the gate
// inputs.  Ri (row stride ldr) and x, r (n each) in shared or device
// memory; R [n, n] and b in device memory; red: 2 kWarps T of shared memory.
template <typename T>
__device__ void refine(const typename Cplx<T>::type* Ri, int ldr,
                       const typename Cplx<T>::type* R,
                       const typename Cplx<T>::type* b,
                       typename Cplx<T>::type* x, typename Cplx<T>::type* r,
                       T* red, int n, T gate, T* ratio,
                       unsigned char* finite, unsigned char* ok) {
  using C = typename Cplx<T>::type;
  gemv<C, 0>(Ri, ldr, b, nullptr, x, n);
  for (int it = 0; it < 2; ++it) {
    gemv<C, 1>(R, n, x, b, r, n);
    gemv<C, 2>(Ri, ldr, r, nullptr, x, n);
  }
  gemv<C, 1>(R, n, x, b, r, n);
  T rmax = 0, bmax = 0;
  bool fin = true;
  for (int i = threadIdx.x; i < n; i += kThreads) {
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
    red[kWarps + warp] = bmax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      rmax = nanmax(rmax, red[w]);
      bmax = nanmax(bmax, red[kWarps + w]);
    }
    const T q = rmax == T(0) ? T(0) : rmax / bmax;
    *ratio = q;
    *finite = fin ? 1 : 0;
    if (!(fin && q <= gate)) *ok = 0;
  }
}

// Resident path: the whole solve of one system per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bi_resident_kernel(const typename Cplx<T>::type* R,
                       const typename Cplx<T>::type* rhs,
                       typename Cplx<T>::type* x, T* ratio,
                       unsigned char* finite, unsigned char* ok, int n,
                       T gate) {
  using C = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* a = reinterpret_cast<C*>(smem_raw);
  C* rowj = a + (size_t)n * n;
  C* colj = rowj + kLeaf;
  C* xs = colj + kLeaf;
  C* rs = xs + n;
  T* red = reinterpret_cast<T*>(rs + n);
  const size_t b = blockIdx.x;
  const C* Rb = R + b * n * n;
  for (int e = threadIdx.x; e < n * n; e += kThreads) a[e] = Rb[e];
  __syncthreads();
  invert<C, 0>(a, n, 0, n, rowj, colj);
  refine<T>(a, n, Rb, rhs + b * n, xs, rs, red, n, gate, ratio + b,
            finite + b, ok);
  for (int i = threadIdx.x; i < n; i += kThreads) x[b * n + i] = xs[i];
}

// Hybrid path, one subtree: the n x n block of each system at src (system
// stride bs, row stride ld) inverted into dst (same strides; may be src).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bi_invert_kernel(const typename Cplx<T>::type* src,
                     typename Cplx<T>::type* dst, long long bs, int ld,
                     int n) {
  using C = typename Cplx<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* a = reinterpret_cast<C*>(smem_raw);
  C* rowj = a + (size_t)n * n;
  C* colj = rowj + kLeaf;
  const size_t off = (size_t)blockIdx.x * bs;
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n, j = e - i * n;
    a[e] = src[off + (size_t)i * ld + j];
  }
  __syncthreads();
  invert<C, 0>(a, n, 0, n, rowj, colj);
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n, j = e - i * n;
    dst[off + (size_t)i * ld + j] = a[e];
  }
}

// Hybrid path, steps 2 and 3 from the workspace Ri [B, n, n]; x and r
// [B, n] in device memory (a block reads back only what it wrote, after a
// barrier).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bi_refine_kernel(const typename Cplx<T>::type* Ri,
                     const typename Cplx<T>::type* R,
                     const typename Cplx<T>::type* rhs,
                     typename Cplx<T>::type* x, typename Cplx<T>::type* r,
                     T* ratio, unsigned char* finite, unsigned char* ok,
                     int n, T gate) {
  __shared__ T red[2 * kWarps];
  const size_t b = blockIdx.x;
  refine<T>(Ri + b * n * n, n, R + b * n * n, rhs + b * n, x + b * n,
            r + b * n, red, n, gate, ratio + b, finite + b, ok);
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
  int e = prepare(bi_resident_kernel<float>);
  if (!e) e = prepare(bi_resident_kernel<double>);
  if (!e) e = prepare(bi_invert_kernel<float>);
  if (!e) e = prepare(bi_invert_kernel<double>);
  if (!e) g_prepared[dev].store(1, std::memory_order_release);
  return e;
}

template <typename T>
int path_of(int M) {
  if (M < 1) return -1;
  return smem_bytes<T>(M, true) <= kSmemMax ? 0 : 1;
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
  bi_resident_kernel<T><<<B, kThreads, smem_bytes<T>(M, true),
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
  bi_invert_kernel<T><<<B, kThreads, smem_bytes<T>(n, false),
                        (cudaStream_t)stream>>>((const C*)src, (C*)dst, bs,
                                                ld, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_refine(const void* Ri, const void* R, const void* rhs, void* x,
                  void* r, void* ratio, void* finite, void* ok, int B, int M,
                  double gate, void* stream) {
  using C = typename Cplx<T>::type;
  if (B <= 0) return 0;
  if (M < 1) return (int)cudaErrorInvalidValue;
  bi_refine_kernel<T><<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const C*)Ri, (const C*)R, (const C*)rhs, (C*)x, (C*)r, (T*)ratio,
      (unsigned char*)finite, (unsigned char*)ok, M, (T)gate);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Set the kernels' shared-memory attributes on the current device now.
// Returns the cudaError_t (0 on success).
int bi_prepare() { return prepare_all(); }

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
