// IIR filter along the rows of x: transposed direct-form II, one thread per
// row, samples in order.
//
// Replaces the JAX package's lfilter (eaqhm_tpu/ops/filters.py:59-88, a
// lax.scan over samples; not a Pallas kernel).  The recursion is inherently
// sequential: every output needs the state the previous sample left, so a
// row's work is one dependent chain of about 2*order+1 multiply-adds per
// sample.  The bound of the same work on the card (x read once, y written
// once; a few flops per sample) is microseconds; this kernel is bound by
// the latency of that chain instead (~n x a few tens of cycles per row),
// which for the VAD's 63k-sample signals is a few milliseconds, one launch
// where a per-sample loop would be 63k.  A blocked state-space formulation
// (ops.filters.lfilter_blocked) is parallel but loses all accuracy on the
// VAD's 30 Hz high-pass: its block operators are powers of a companion
// matrix whose entries grow to ~1e10 before they decay.  Here the arithmetic
// is scipy's, in the same order and with every product and sum rounded on
// its own (no fused multiply-add), so the kernel, its plain version and
// scipy agree bit for bit; the 30 Hz filter amplifies any other rounding
// by up to ~1e16 at DC.
//
// Loads and stores go through registers in chunks of kChunk samples, so a
// row's reads are issued together and their latency is paid once a chunk.

#include <cuda_runtime.h>

namespace {

// round-to-nearest products and sums that the compiler may not contract
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

constexpr int kMaxOrder = 8;
constexpr int kChunk = 32;
constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lfilter_kernel(const T* __restrict__ coef, const T* __restrict__ x,
               const T* __restrict__ zi, T* __restrict__ y,
               T* __restrict__ zf, long long rows, long long n, int order) {
  const long long r = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (r >= rows) return;
  // coef: b[0..order] then a[1..order], already divided by a[0]
  T b[kMaxOrder + 1], a[kMaxOrder + 1], z[kMaxOrder + 1];
#pragma unroll
  for (int k = 0; k <= kMaxOrder; ++k) {
    b[k] = k <= order ? coef[k] : T(0);
    a[k] = (k >= 1 && k <= order) ? coef[order + k] : T(0);
    z[k] = k < order ? zi[r * order + k] : T(0);
  }
  const T* xr = x + r * n;
  T* yr = y + r * n;
  T buf[kChunk];
  for (long long t0 = 0; t0 < n; t0 += kChunk) {
    const int m = (int)((n - t0) < kChunk ? (n - t0) : kChunk);
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < m) buf[i] = xr[t0 + i];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < m) {
        const T xt = buf[i];
        const T yt = add(mul(b[0], xt), z[0]);
#pragma unroll
        for (int k = 0; k < kMaxOrder; ++k)
          z[k] = sub(add(mul(b[k + 1], xt), z[k + 1]), mul(a[k + 1], yt));
        buf[i] = yt;
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < m) yr[t0 + i] = buf[i];
  }
  for (int k = 0; k < order; ++k) zf[r * order + k] = z[k];
}

template <typename T>
int launch(const void* coef, const void* x, const void* zi, void* y,
           void* zf, long long rows, long long n, int order, void* stream) {
  if (order < 1 || order > kMaxOrder || n < 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  const long long blocks = (rows + kThreads - 1) / kThreads;
  lfilter_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)coef, (const T*)x, (const T*)zi, (T*)y, (T*)zf, rows, n,
      order);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// coef: [2*order+1] (b[0..order], a[1..order], normalised by a[0]);
// x, y: [rows, n]; zi (initial state), zf (final state): [rows, order].
// All contiguous float64 (lfilter_f64) or float32 (lfilter_f32).  Returns
// the cudaError_t of the launch (0 on success).
int lfilter_f64(const void* coef, const void* x, const void* zi, void* y,
                void* zf, long long rows, long long n, int order,
                void* stream) {
  return launch<double>(coef, x, zi, y, zf, rows, n, order, stream);
}

int lfilter_f32(const void* coef, const void* x, const void* zi, void* y,
                void* zf, long long rows, long long n, int order,
                void* stream) {
  return launch<float>(coef, x, zi, y, zf, rows, n, order, stream);
}

}  // extern "C"
