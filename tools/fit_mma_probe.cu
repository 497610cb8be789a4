// In-register FP64 tensor-core products on one card: the rate of each
// mma.sync .f64 shape, for the choice of fit_gram's complex128 engine
// (eaqhm_torch/kernels/csrc/fit.cu).  Built by tools/bench_fit_phases.py,
// once per shape (-DPROBE_SHAPE=0..3), so that a shape ptxas refuses fails
// alone:
//   0 m8n8k4, 1 m16n8k4, 2 m16n8k8, 3 m16n8k16 (row.col, f64 in and out).
// Each warp runs kChains independent accumulators through `iters` rounds;
// no operand leaves the registers, so the rate is the tensor pipe's.
#include <cuda_runtime.h>

#ifndef PROBE_SHAPE
#define PROBE_SHAPE 0
#endif

namespace {

constexpr int kChains = 8;

#if PROBE_SHAPE == 0
constexpr int kM = 8, kN = 8, kK = 4, kA = 1, kB = 1, kC = 2;
#elif PROBE_SHAPE == 1
constexpr int kM = 16, kN = 8, kK = 4, kA = 2, kB = 1, kC = 4;
#elif PROBE_SHAPE == 2
constexpr int kM = 16, kN = 8, kK = 8, kA = 4, kB = 2, kC = 4;
#else
constexpr int kM = 16, kN = 8, kK = 16, kA = 8, kB = 4, kC = 4;
#endif

__device__ __forceinline__ void mma(double (&d)[kC], const double (&a)[kA],
                                    const double (&b)[kB]) {
#if PROBE_SHAPE == 0
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a[0]), "d"(b[0]));
#elif PROBE_SHAPE == 1
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
#elif PROBE_SHAPE == 2
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
#else
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
#endif
}

__global__ void probe(double* out, int iters) {
  double a[kA], b[kB], d[kChains][kC];
  for (int i = 0; i < kA; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < kB; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int c = 0; c < kChains; ++c)
    for (int i = 0; i < kC; ++i) d[c][i] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) mma(d[c], a, b);
  }
  double s = 0.0;
  for (int c = 0; c < kChains; ++c)
    for (int i = 0; i < kC; ++i) s += d[c][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// Real flops of one warp's mma of this shape.
long long probe_flops_per_mma() { return 2LL * kM * kN * kK; }

int probe_chains() { return kChains; }

// out: blocks * threads doubles.  Returns the cudaError_t of the launch.
int probe_run(double* out, int blocks, int threads, int iters, void* stream) {
  probe<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
