// SWIPE' pitch on the device, for Hopper: the loudness of every frame of a
// window size straight from the signal, and the pick of the 1 ms steps the
// engines' 5 ms f0 grid reads (or of every step).
//
// Replaces what the JAX package computes as one XLA program per plan (not a
// Pallas kernel): eaqhm_tpu/models/swipe.py:203 pitch_strength with
// eaqhm_tpu/ops/stft.py:46 specgram_psd, :230 fine_tune and :258 swipep, and
// eaqhm_tpu/models/engine.py:39 resample_f0_grid.  The candidate-kernel
// product Si = Ln @ kernel^T stays torch.matmul between the two kernels.
//
// swipe_loudness, two launches a call for every window size of the plan:
//   dft_kernel: the DFT of the windowed frames at the bins the ERB lerp
//   reads (the union of erb_lo and erb_lo + 1, "the needed bins"), as a
//   small GEMM: frames [M = B nf, nfft] against a compact table of the
//   needed columns of JAX's own cos | -sin basis, [nfft, nu, 2], each bin's
//   (cos, -sin) side by side.  The frames are formed from the signal [B, L]
//   by hop with the zero padding folded into the index (a row table per
//   tile), staged with cp.async in a four-stage ring of 16 samples a
//   stage, x * w rounded as each product reads it (as the plain version's
//   frames * window, before its product).  A block of 8 warps takes 128
//   frames x 64 bins over a slice of the depth: float64 on the FP64 tensor
//   cores (mma.sync m16n8k4; a warp 32 frames x 32 bins), float32 on FFMA
//   (a thread 8 frames x 4 bins, the frames staged transposed for float4
//   reads; no TF32 in any form).  Where a window's tiles are fewer than the SMs (48 kHz: 4-13
//   frames, 496-722 bins, nfft up to 8192; the SA19 plans' 130-258 frames)
//   its depth is split into ks slices (a power of two, at most 8, chosen by
//   the wrapper), so that the table, which bounds the few-frame windows,
//   streams through every SM.  Every window's blocks are one launch.  A
//   block writes its tile to a scratch: ks == 1 the PSD, |X|^2 times the
//   bin's factor; ks > 1 its slice's re, im.
//   erb_kernel: 128 threads a frame: at each ERB point the PSD of its two
//   bins (the slices summed in slice order), their lerp, sqrt(max(0, .))
//   kept in registers, the frame's squared norm (each thread its points in
//   order, a butterfly over each warp, the frame's 4 warps in order), and
//   Ln [B, nf, nerb] written once.  Every window's frames are one launch.
// swipe_pick: a warp per (1 ms step, utterance).  Lanes take the candidates
//   c, c + 32, ...: each candidate's strength is the time lerp of its
//   window's Si [B, nf, nj] rows between the step's two frames, times mu,
//   added from 0 in window order (as index_add_ adds the windows' rows);
//   the first maximum (NaN the largest, as torch.argmax / jnp.argmax) is a
//   warp reduction on (value, index) that reproduces the sequential rule;
//   the three strengths around it come by shuffle; the parabola
//   vinv[i] @ y, and the 1/768-octave grid of that candidate spread over
//   lanes with the same first-argmax rule.  Edge steps (the argmax at the
//   lowest or highest candidate: pc[0] and the coarse strength) skip the
//   parabola, the grid and pow.  With the f0 grid's tables (pc, nx, g,
//   below per grid point: resample_f0_grid's own ops on the plan's times,
//   once per device plan) a warp per (grid point, utterance) picks the two
//   steps that point reads, together (each phase's loads of both steps in
//   flight at once), and writes the [B, Q, 3] grid with the
//   resample's rounding (rows(pc) (1 - g) + rows(nx) g; below: step 0's
//   row; column 0 the grid's time); without them every step's (t, f0,
//   strength) [B, T, 3].
//
// Every product and sum of the epilogue and of the pick is rounded on its
// own (__dmul_rn / __dadd_rn and their float32 forms), in the order of the
// plain version's torch ops; sqrt, the division and pow are CUDA's (IEEE
// sqrt and division).  So swipe_pick is bit for bit its plain version's
// function on the same Si; swipe_loudness differs from its plain version
// in the DFT's order of summation (and its fused multiply-adds) and the
// norm's.
//
// What bounds them on an H100: swipe_loudness the larger of the DFT's
// 4 frames nfft bins flops (FP64 tensor cores / FP32 at 67 TFLOP/s) and
// the bytes of the table and the signal (the table at few frames: 151 MB
// at 48 kHz in float64); a block's tile sets how often the frames and the
// table are read again from the L2 (128 x 64 halves the 64 x 32 tile's
// traffic).  swipe_pick reads the Si rows of the steps it picks and writes
// its grid, a few microseconds of bytes: its cost is its latency, which a
// warp a step and the grid's steps alone cut.
//
// Every launch is on the caller's stream and does not synchronize; the
// wrapper allocates the outputs and the scratch; each entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxWindows = 16;
// swipe_loudness, first launch (the DFT): a block of 8 warps takes 128
// frames x 64 bins (128 columns) of one depth slice of one window; the
// depth streams through a cp.async ring of 4 stages of 16 samples (on an
// H100 the fastest of 16 or 32 samples a stage in 3 to 6 stages)
constexpr int kRows = 128;
constexpr int kBins = 64;
constexpr int kDftThreads = 256;
constexpr int kMaxSplits = 8;
constexpr int kTLd = 2 * kBins + 4;    // staged twiddles' row stride
constexpr int kDepth = 16;
constexpr int kStages = 4;
// the staged frames: float64 row-major [kRows][kDepth + 4] (the A
// fragments' rows), float32 transposed [kDepth][kRows + 4] (a thread's 8
// rows as two float4)
template <typename T>
constexpr int kXElems = sizeof(T) == 8 ? kRows * (kDepth + 4)
                                       : kDepth * (kRows + 4);
constexpr int kXLd64 = kDepth + 4;
constexpr int kXLd32 = kRows + 4;
// a stage: the frames, the window [kDepth], the twiddles [kDepth][kTLd];
// behind the ring the tile's row table (16 bytes a frame)
template <typename T>
constexpr int kStage = kXElems<T> + kDepth + kDepth * kTLd;
constexpr int kRowTable = kRows * 16;
// second launch (the ERB epilogue): 4 warps a frame, 2 frames a block, a
// thread at most 8 of the frame's ERB points (nerb <= 1024), their loads in
// flight at once
constexpr int kErbThreads = 256;
constexpr int kErbRowThreads = 128;
constexpr int kErbBlockRows = kErbThreads / kErbRowThreads;
constexpr int kErbPoints = 8;
// swipe_pick: 8 warps a block, at most 16 candidates a lane (nc <= 512;
// the kernel is built for 4, 8 and 16 a lane and launched with the fewest
// that hold nc)
constexpr int kPickWarps = 8;
constexpr int kPickWindows = 4;
constexpr int kSlots = 16;
constexpr int kMaxGrid = 32;

template <typename T>
constexpr int dft_smem() {
  return kStages * kStage<T> * (int)sizeof(T) + kRowTable;
}

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <typename T>
struct Vec2;
template <>
struct Vec2<double> { using type = double2; };
template <>
struct Vec2<float> { using type = float2; };

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 8 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0));
}

// d[0..3] += a * b on the FP64 tensor cores (m16n8k4; fragments as in
// fit.cu: A[g][q], A[g + 8][q], B[q][g], C[g][2q + e], C[g + 8][2q + e])
__device__ __forceinline__ void mma_f64(double (&d)[4], double a0, double a1,
                                        double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// One window size of a loudness call.
template <typename T>
struct LoudWindow {
  const T* win;        // [nfft]
  const T* cols;       // [nfft, nu, 2]: (cos, -sin) of each needed bin
  const T* scale;      // [nu] PSD factor of each needed bin
  const int* erb_c;    // [nerb] needed-bin index of erb_lo (erb_lo + 1 next)
  const T* erb_w;      // [nerb]
  T* ln;               // [B, nf, nerb]
  T* scratch;          // ks == 1: P [M, nu]; else (re, im) [ks, M, nu, 2]
  int nf, nfft, hop, pad_pre, nu, nerb, ks, M;
  int tiles_c;            // the DFT's bin tiles
  int dft0, erb0;         // the window's first block in each launch
};

template <typename T>
struct LoudArgs {
  const T* x;          // [B, L]
  int B, L, nwin;
  LoudWindow<T> w[kMaxWindows];
};

// the window of block `bid` of a launch whose windows start at `first`
template <typename T>
__device__ __forceinline__ int window_of(const LoudArgs<T>& a, int bid,
                                         bool erb) {
  int i = 0;
  for (int j = 1; j < a.nwin; ++j)
    if (bid >= (erb ? a.w[j].erb0 : a.w[j].dft0)) i = j;
  return i;
}

// The tile's row table: per frame row lr of the tile, base[lr] such that
// sample k of the frame is x[base[lr] + k], and the k inside the signal,
// [klo[lr], khi[lr]) (empty past the last frame).
template <typename T>
__device__ __forceinline__ void row_table(const LoudArgs<T>& a,
                                          const LoudWindow<T>& w,
                                          unsigned char* tab, int r0) {
  long long* base = reinterpret_cast<long long*>(tab);
  int* klo = reinterpret_cast<int*>(base + kRows);
  int* khi = klo + kRows;
  for (int lr = threadIdx.x; lr < kRows; lr += kDftThreads) {
    const int r = r0 + lr;
    if (r < w.M) {
      const int b = r / w.nf, f = r - b * w.nf;
      const int start = f * w.hop - w.pad_pre;     // sample 0 of the frame
      base[lr] = (long long)b * a.L + start;
      klo[lr] = -start;
      khi[lr] = a.L - start;
    } else {
      base[lr] = 0;
      klo[lr] = 1;
      khi[lr] = 0;
    }
  }
}

// The block's copies of one stage: the frames' samples (zero outside the
// signal: the padding; rows past the last frame are not copied, and their
// results are not written), the window and the tile's twiddles (zero past
// the last needed bin).  A warp copies whole frame rows, its lanes along
// the depth.
template <typename T>
__device__ __forceinline__ void issue_stage(const LoudArgs<T>& a,
                                            const LoudWindow<T>& w, T* st,
                                            const unsigned char* tab,
                                            int rows, int bin0, int k0) {
  constexpr int D = kDepth, per_warp = 32 / D;
  T* xs = st;
  T* ws = xs + kXElems<T>;
  T* ts = ws + D;
  const long long* base = reinterpret_cast<const long long*>(tab);
  const int* klo = reinterpret_cast<const int*>(base + kRows);
  const int* khi = klo + kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kk = lane % D, k = k0 + kk;
#pragma unroll
  for (int i = 0; i < kRows * D / kDftThreads; ++i) {
    const int lr = (warp + i * (kDftThreads / 32)) * per_warp + lane / D;
    if (lr < rows) {
      const bool ok = k >= klo[lr] && k < khi[lr];
      T* dst = sizeof(T) == 8 ? xs + lr * kXLd64 + kk : xs + kk * kXLd32 + lr;
      cp_async(dst, ok ? a.x + base[lr] + k : a.x, (int)sizeof(T), ok);
    }
  }
  if (tid < D) cp_async(ws + tid, w.win + k0 + tid, (int)sizeof(T), true);
#pragma unroll
  for (int i = 0; i < D * kBins / kDftThreads; ++i) {
    const int e = tid + i * kDftThreads;
    const int r = e / kBins, bl = e % kBins;
    const int bin = bin0 + bl;
    const bool ok = bin < w.nu;
    const T* src = ok ? w.cols + ((size_t)(k0 + r) * w.nu + bin) * 2 : w.cols;
    cp_async(ts + r * kTLd + 2 * bl, src, 2 * (int)sizeof(T), ok);
  }
}

// The depth of the block's slice through the cp.async ring: a stage's
// copies issued kStages - 1 stages ahead, then handed to consume (the
// tile's products, which round x * w as the plain version's frames *
// window before its product).
template <typename T, class Consume>
__device__ __forceinline__ void pipeline(const LoudArgs<T>& a,
                                         const LoudWindow<T>& w, T* ring,
                                         const unsigned char* tab, int rows,
                                         int bin0, int kbeg, int nsteps,
                                         Consume&& consume) {
  constexpr int S = kStages, E = kStage<T>, D = kDepth;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nsteps)
      issue_stage(a, w, ring + s * E, tab, rows, bin0, kbeg + s * D);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int step = 0; step < nsteps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2));
    __syncthreads();
    const int nx = step + S - 1;
    if (nx < nsteps)
      issue_stage(a, w, ring + (nx % S) * E, tab, rows, bin0, kbeg + nx * D);
    asm volatile("cp.async.commit_group;\n" ::);
    consume(ring + (step % S) * E);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// One value leaves the DFT: (re, im) of needed bin `bin` of frame row `r`,
// as the PSD (ks == 1) or as the slice's part of the sums.
template <typename T>
__device__ __forceinline__ void put(const LoudWindow<T>& w, int ksl, int r,
                                    int bin, T re, T im) {
  if (r >= w.M || bin >= w.nu) return;
  if (w.ks == 1) {
    w.scratch[(size_t)r * w.nu + bin] =
        mul(add(mul(re, re), mul(im, im)), w.scale[bin]);
  } else {
    using V = typename Vec2<T>::type;
    V v;
    v.x = re;
    v.y = im;
    reinterpret_cast<V*>(w.scratch)[((size_t)ksl * w.M + r) * w.nu + bin] = v;
  }
}

// The DFT at the needed bins: a block per (bin tile, depth slice, frame
// tile) of each window; the frames of every window of the call in one
// launch.
template <typename T>
__global__ void __launch_bounds__(kDftThreads, 1)
dft_kernel(LoudArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  unsigned char* tab = smem_raw + kStages * kStage<T> * sizeof(T);
  const LoudWindow<T> w = a.w[window_of(a, blockIdx.x, false)];
  const int local = blockIdx.x - w.dft0;
  const int bt = local % w.tiles_c, rest = local / w.tiles_c;
  const int ksl = rest % w.ks, rt = rest / w.ks;
  const int r0 = rt * kRows, bin0 = bt * kBins;
  const int klen = w.nfft / w.ks, kbeg = ksl * klen;
  const int nsteps = klen / kDepth;
  const int rows = w.M - r0 < kRows ? w.M - r0 : kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  row_table(a, w, tab, r0);
  __syncthreads();

  if constexpr (sizeof(T) == 8) {
    // a warp 32 frames (2 x m16) x 32 bins (8 x n8 columns)
    const int wr = warp >> 1, wc = warp & 1, g = lane >> 2, q = lane & 3;
    const bool live0 = wr * 32 < rows, live1 = wr * 32 + 16 < rows;
    double acc[2][8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0;
    pipeline(a, w, ring, tab, rows, bin0, kbeg, nsteps, [&](const T* st) {
      const double* xs = st;
      const double* ws = st + kXElems<T>;
      const double* ts = ws + kDepth;
      if (!live0) return;
#pragma unroll
      for (int k4 = 0; k4 < kDepth; k4 += 4) {
        double bf[8];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          bf[n] = ts[(k4 + q) * kTLd + wc * 64 + n * 8 + g];
        const double wk = ws[k4 + q];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m == 1 && !live1) continue;
          const double* xr = xs + (wr * 32 + m * 16 + g) * kXLd64 + k4 + q;
          const double a0 = mul(xr[0], wk), a1 = mul(xr[8 * kXLd64], wk);
#pragma unroll
          for (int n = 0; n < 8; ++n) mma_f64(acc[m][n], a0, a1, bf[n]);
        }
      }
    });
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          put(w, ksl, r0 + wr * 32 + m * 16 + g + 8 * h,
              bin0 + wc * 32 + n * 4 + q, (T)acc[m][n][2 * h],
              (T)acc[m][n][2 * h + 1]);
  } else {
    // a thread 8 frames x 4 bins (8 columns: 4 in each half of the tile,
    // so that a warp's float4 reads of the twiddles meet no bank twice) on
    // FFMA
    const int tr = tid >> 4, tc = tid & 15;
    const bool live = tr * 8 < rows;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    pipeline(a, w, ring, tab, rows, bin0, kbeg, nsteps, [&](const T* st) {
      const float* xs = reinterpret_cast<const float*>(st);
      const float* ws = xs + kXElems<T>;
      const float* ts = ws + kDepth;
      if (!live) return;
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        const float wk = ws[kk];
        float4 a0 =
            *reinterpret_cast<const float4*>(xs + kk * kXLd32 + tr * 8);
        float4 a1 =
            *reinterpret_cast<const float4*>(xs + kk * kXLd32 + tr * 8 + 4);
        a0 = make_float4(mul(a0.x, wk), mul(a0.y, wk), mul(a0.z, wk),
                         mul(a0.w, wk));
        a1 = make_float4(mul(a1.x, wk), mul(a1.y, wk), mul(a1.z, wk),
                         mul(a1.w, wk));
        const float4 b0 =
            *reinterpret_cast<const float4*>(ts + kk * kTLd + tc * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(ts + kk * kTLd + 64 + tc * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    });
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        put(w, ksl, r0 + tr * 8 + i, bin0 + (j >> 1) * 32 + tc * 2 + (j & 1),
            (T)acc[i][2 * j], (T)acc[i][2 * j + 1]);
  }
}

// The ERB epilogue: per frame the ERB lerp of the two bins' PSD,
// sqrt(max(0, .)), the norm and Ln.  A frame's points are spread over 128
// threads (point e on thread e mod 128), the loudness kept in registers;
// the squared norm summed in a fixed order: each thread its points in
// order, a butterfly over each warp, then the frame's 4 warps in order.
template <typename T>
__global__ void __launch_bounds__(kErbThreads) erb_kernel(LoudArgs<T> a) {
  __shared__ T part[kErbThreads / 32];
  const LoudWindow<T> w = a.w[window_of(a, blockIdx.x, true)];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = tid % kErbRowThreads;
  const int r = (blockIdx.x - w.erb0) * kErbBlockRows + tid / kErbRowThreads;
  const bool live = r < w.M;
  T l[kErbPoints];
  T sum = T(0);
#pragma unroll
  for (int j = 0; j < kErbPoints; ++j) {
    const int e = t + j * kErbRowThreads;
    l[j] = T(0);
    if (live && e < w.nerb) {
      const int c = __ldg(w.erb_c + e);
      T p0, p1;
      if (w.ks == 1) {
        const T* p = w.scratch + (size_t)r * w.nu + c;
        p0 = __ldg(p);
        p1 = __ldg(p + 1);
      } else {
        // the slices in slice order, then |X|^2 times the bin's factor
        using V = typename Vec2<T>::type;
        const V* p = reinterpret_cast<const V*>(w.scratch)
                     + (size_t)r * w.nu + c;
        const size_t step = (size_t)w.M * w.nu;
        V s0 = __ldg(p), s1 = __ldg(p + 1);
        for (int k = 1; k < w.ks; ++k) {
          const V v0 = __ldg(p + k * step), v1 = __ldg(p + k * step + 1);
          s0.x = add(s0.x, v0.x);
          s0.y = add(s0.y, v0.y);
          s1.x = add(s1.x, v1.x);
          s1.y = add(s1.y, v1.y);
        }
        p0 = mul(add(mul(s0.x, s0.x), mul(s0.y, s0.y)), __ldg(w.scale + c));
        p1 = mul(add(mul(s1.x, s1.x), mul(s1.y, s1.y)),
                 __ldg(w.scale + c + 1));
      }
      const T we = __ldg(w.erb_w + e);
      const T pe = add(mul(p0, sub(T(1), we)), mul(p1, we));
      l[j] = sqrt(pe < T(0) ? T(0) : pe);            // NaN stays (clamp)
      sum = add(sum, mul(l[j], l[j]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum = add(sum, __shfl_xor_sync(0xffffffffu, sum, off));
  if (lane == 0) part[warp] = sum;
  __syncthreads();
  if (!live) return;
  const int w0 = (tid / kErbRowThreads) * (kErbRowThreads / 32);
  const T norm = sqrt(add(add(add(part[w0], part[w0 + 1]), part[w0 + 2]),
                          part[w0 + 3]));
  const bool pos = norm > T(0);
  T* out = w.ln + (size_t)r * w.nerb;
#pragma unroll
  for (int j = 0; j < kErbPoints; ++j) {
    const int e = t + j * kErbRowThreads;
    if (e < w.nerb) out[e] = pos ? l[j] / norm : T(0);
  }
}

template <typename T>
int launch_loudness(const void* x, int B, int L, int nwin,
                    const void* const* win, const void* const* cols,
                    const void* const* scale, const void* const* erb_c,
                    const void* const* erb_w, void* const* ln,
                    void* const* scratch, const int* nf, const int* nfft,
                    const int* hop, const int* pad_pre, const int* nu,
                    const int* nerb, const int* ks, void* stream) {
  if (nwin < 1 || nwin > kMaxWindows || B < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  LoudArgs<T> a{};
  a.x = (const T*)x;
  a.B = B;
  a.L = L;
  a.nwin = nwin;
  long long dft_blocks = 0, erb_blocks = 0;
  for (int i = 0; i < nwin; ++i) {
    if (nf[i] < 1 || nu[i] < 2 || nerb[i] < 1 || ks[i] < 1 ||
        ks[i] > kMaxSplits || (ks[i] & (ks[i] - 1)) || nfft[i] < 32 ||
        nfft[i] % (ks[i] * 32) || hop[i] < 1 || pad_pre[i] < 0 ||
        nerb[i] > kErbPoints * kErbRowThreads ||
        (long long)B * nf[i] > (1 << 30))
      return (int)cudaErrorInvalidValue;
    LoudWindow<T>& w = a.w[i];
    w.win = (const T*)win[i];
    w.cols = (const T*)cols[i];
    w.scale = (const T*)scale[i];
    w.erb_c = (const int*)erb_c[i];
    w.erb_w = (const T*)erb_w[i];
    w.ln = (T*)ln[i];
    w.scratch = (T*)scratch[i];
    w.nf = nf[i];
    w.nfft = nfft[i];
    w.hop = hop[i];
    w.pad_pre = pad_pre[i];
    w.nu = nu[i];
    w.nerb = nerb[i];
    w.ks = ks[i];
    w.M = B * nf[i];
    w.tiles_c = (nu[i] + kBins - 1) / kBins;
    w.dft0 = (int)dft_blocks;
    w.erb0 = (int)erb_blocks;
    dft_blocks += (long long)w.tiles_c * w.ks * ((w.M + kRows - 1) / kRows);
    erb_blocks += (w.M + kErbBlockRows - 1) / kErbBlockRows;
  }
  if (dft_blocks > (1LL << 31) - 1 || erb_blocks > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  dft_kernel<T><<<(unsigned)dft_blocks, kDftThreads, dft_smem<T>(),
                  (cudaStream_t)stream>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  erb_kernel<T><<<(unsigned)erb_blocks, kErbThreads, 0,
                  (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- swipe_pick ----

template <typename T>
struct PickWindow {
  const T* si;            // [B, nf, nj]
  const long long* tlo;   // [T]
  const T* tw;            // [T]
  const T* mu;            // [nj]
  int j0, nj, nf;
};

template <typename T>
struct PickArgs {
  PickWindow<T> win[kMaxWindows];
  int nwin;
  const T* vinv;          // [nc, 3, 3]
  const T* nftc;          // [nc, gmax]
  const int* nftc_len;    // [nc]
  const T* left;          // [nc]
  const T* tt;            // [items]: the steps' times, or the grid's
  const long long* gpc;   // [Q] (grid) or null
  const long long* gnx;   // [Q]
  const T* gw;            // [Q]
  const unsigned char* gbelow;  // [Q]
  T pc0;
  T* out;                 // [B, items, 3]
  int nc, gmax, items;
};

template <typename T>
__device__ __forceinline__ bool takes(T v, T best) {
  // the first maximum, NaN the largest (torch.argmax / jnp.argmax)
  return v > best || (v != v && best == best);
}

// the warp's first maximum of (v, i) pairs; i == INT_MAX is no candidate
template <typename T>
__device__ __forceinline__ void warp_argmax(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T u = __shfl_xor_sync(0xffffffffu, v, off);
    const int j = __shfl_xor_sync(0xffffffffu, i, off);
    bool w;
    if (j == INT_MAX) w = false;
    else if (i == INT_MAX) w = true;
    else if (u != u || v != v) w = (u != u) && (v == v || j < i);
    else w = u > v || (u == v && j < i);
    if (w) {
      v = u;
      i = j;
    }
  }
}

// (f0, strength) of the NS steps t[u] of utterance b, the same in every
// lane; SL slots a lane (nc <= 32 SL).  The steps go through each phase
// together, so that their loads are in flight at once: the frames and
// weights, the Si rows, then the parabola's tables.
template <typename T, int NS, int SL>
__device__ __forceinline__ void pick_steps(const PickArgs<T>& a, int b,
                                           const long long (&t)[NS],
                                           int lane, T (&p_out)[NS],
                                           T (&s_out)[NS]) {
  const int nslots = (a.nc + 31) >> 5;
  T s[NS][SL];
#pragma unroll
  for (int u = 0; u < NS; ++u)
#pragma unroll
    for (int j = 0; j < SL; ++j) s[u][j] = T(0);
  // each window's frame and weight at the steps, loaded by lane i at once;
  // then the windows in order (their fields read from the parameter bank
  // by index), a lane's candidates unrolled, so its strengths stay in
  // registers
  long long my_lo[NS];
  T my_tw[NS];
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    my_lo[u] = 0;
    my_tw[u] = T(0);
    if (lane < a.nwin) {
      my_lo[u] = a.win[lane].tlo[t[u]];
      my_tw[u] = a.win[lane].tw[t[u]];
    }
  }
  auto window_terms = [&](int i) {
    const PickWindow<T>& w = a.win[i];
#pragma unroll
    for (int u = 0; u < NS; ++u) {
      const long long lo = __shfl_sync(0xffffffffu, my_lo[u], i);
      const T tw = __shfl_sync(0xffffffffu, my_tw[u], i), omt = sub(T(1), tw);
      const T* r0 = w.si + ((size_t)b * w.nf + lo) * w.nj;
      const T* r1 = r0 + w.nj;
#pragma unroll
      for (int j = 0; j < SL; ++j) {
        const int k = lane + 32 * j - w.j0;
        if (j < nslots && k >= 0 && k < w.nj) {
          const T sit = add(mul(r0[k], omt), mul(r1[k], tw));
          s[u][j] = add(s[u][j], mul(w.mu[k], sit));
        }
      }
    }
  };
  // the first kPickWindows windows unrolled (every plan of the paths has 2
  // or 3), so that their Si rows are loaded at once; the rest in a loop
#pragma unroll
  for (int i = 0; i < kPickWindows; ++i)
    if (i < a.nwin) window_terms(i);
  for (int i = kPickWindows; i < a.nwin; ++i) window_terms(i);
  T smax[NS];
  int im[NS];
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    smax[u] = T(0);
    im[u] = INT_MAX;
#pragma unroll
    for (int j = 0; j < SL; ++j) {
      const int c = lane + 32 * j;
      if (j < nslots && c < a.nc &&
          (im[u] == INT_MAX || takes(s[u][j], smax[u]))) {
        smax[u] = s[u][j];
        im[u] = c;
      }
    }
    warp_argmax(smax[u], im[u]);
  }
  // an edge step (the argmax at the lowest or highest candidate) is pc[0]
  // and the coarse maximum; the others' parabola tables are loaded
  // together, then each inner step's parabola, fine grid and pow
  bool edge[NS];
  int il[NS];
  T y[NS][3], v[NS][9], gk[NS], left[NS];
  int n[NS];
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    edge[u] = im[u] == 0 || im[u] == a.nc - 1;
    il[u] = edge[u] ? 1 : im[u];
    // the strengths of candidates im - 1, im, im + 1 from their lanes:
    // each slot shuffled with constant indices (an indexed slot would put
    // the strengths in local memory)
#pragma unroll
    for (int d = 0; d < 3; ++d) y[u][d] = T(0);
#pragma unroll
    for (int j = 0; j < SL; ++j) {
      if (j >= nslots) break;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int c = il[u] - 1 + d;
        const T q = __shfl_sync(0xffffffffu, s[u][j], c & 31);
        if ((c >> 5) == j) y[u][d] = q;
      }
    }
    if (!edge[u]) {
#pragma unroll
      for (int e = 0; e < 9; ++e) v[u][e] = a.vinv[(size_t)il[u] * 9 + e];
      n[u] = a.nftc_len[il[u]];
      gk[u] = lane < a.gmax ? a.nftc[(size_t)il[u] * a.gmax + lane] : T(0);
      left[u] = a.left[il[u]];
    }
  }
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    if (edge[u]) {
      p_out[u] = a.pc0;
      s_out[u] = smax[u];
      continue;
    }
    const T c0 = add(add(mul(v[u][0], y[u][0]), mul(v[u][1], y[u][1])),
                     mul(v[u][2], y[u][2]));
    const T c1 = add(add(mul(v[u][3], y[u][0]), mul(v[u][4], y[u][1])),
                     mul(v[u][5], y[u][2]));
    const T c2 = add(add(mul(v[u][6], y[u][0]), mul(v[u][7], y[u][1])),
                     mul(v[u][8], y[u][2]));
    T val = T(0);
    int kb = INT_MAX;
    if (lane < n[u]) {
      val = add(add(mul(mul(c0, gk[u]), gk[u]), mul(c1, gk[u])), c2);
      kb = lane;
    }
    warp_argmax(val, kb);
    const T step = mul(T(kb - 1), T(1.0 / 768.0));
    p_out[u] = pow(T(2), add(left[u], step));
    s_out[u] = val;
  }
}

// A warp per (item, utterance): with the f0 grid's tables an item is a grid
// point, whose two steps are picked together and resampled; else a step.
template <typename T, int SL, bool kGrid>
__global__ void __launch_bounds__(kPickWarps * 32)
pick_kernel(PickArgs<T> a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = blockIdx.x * kPickWarps + warp, b = blockIdx.y;
  if (item >= a.items) return;
  T f0, st;
  if constexpr (kGrid) {
    const long long steps[2] = {a.gpc[item], a.gnx[item]};
    T p[2], sv[2];
    pick_steps<T, 2, SL>(a, b, steps, lane, p, sv);
    if (a.gbelow[item]) {                 // before the first step: its row
      f0 = p[0];
      st = sv[0];
    } else {
      const T g = a.gw[item], om = sub(T(1), g);
      f0 = add(mul(p[0], om), mul(p[1], g));
      st = add(mul(sv[0], om), mul(sv[1], g));
    }
  } else {
    const long long steps[1] = {(long long)item};
    T p[1], sv[1];
    pick_steps<T, 1, SL>(a, b, steps, lane, p, sv);
    f0 = p[0];
    st = sv[0];
  }
  if (lane == 0) {
    T* o = a.out + ((size_t)b * a.items + item) * 3;
    o[0] = a.tt[item];
    o[1] = f0;
    o[2] = st;
  }
}

// the kernel of SL slots a lane, grid or every step
template <typename T, int SL>
void launch_pick_kernel(const PickArgs<T>& a, dim3 grid, cudaStream_t st) {
  if (a.gpc != nullptr)
    pick_kernel<T, SL, true><<<grid, kPickWarps * 32, 0, st>>>(a);
  else
    pick_kernel<T, SL, false><<<grid, kPickWarps * 32, 0, st>>>(a);
}

template <typename T>
int launch_pick(const void* const* si, const void* const* tlo,
                const void* const* tw, const void* const* mu, const int* j0,
                const int* nj, const int* nf, int nwin, const void* vinv,
                const void* nftc, const void* nftc_len, const void* left,
                const void* tt, double pc0, const void* gpc, const void* gnx,
                const void* gw, const void* gbelow, int Q, void* out, int B,
                int nc, int T_, int gmax, void* stream) {
  if (nwin < 1 || nwin > kMaxWindows || nc < 3 || nc > 32 * kSlots ||
      gmax < 1 || gmax > kMaxGrid || B < 0 || B > 65535 || T_ < 1 || Q < 0 ||
      (Q > 0 && (!gpc || !gnx || !gw || !gbelow)))
    return (int)cudaErrorInvalidValue;
  PickArgs<T> a{};
  a.nwin = nwin;
  for (int i = 0; i < nwin; ++i) {
    if (nf[i] < 2 || nj[i] < 1 || j0[i] < 0 || j0[i] + nj[i] > nc)
      return (int)cudaErrorInvalidValue;
    a.win[i] = PickWindow<T>{(const T*)si[i], (const long long*)tlo[i],
                             (const T*)tw[i], (const T*)mu[i], j0[i], nj[i],
                             nf[i]};
  }
  a.vinv = (const T*)vinv;
  a.nftc = (const T*)nftc;
  a.nftc_len = (const int*)nftc_len;
  a.left = (const T*)left;
  a.tt = (const T*)tt;
  a.gpc = Q > 0 ? (const long long*)gpc : nullptr;
  a.gnx = (const long long*)gnx;
  a.gw = (const T*)gw;
  a.gbelow = (const unsigned char*)gbelow;
  a.pc0 = (T)pc0;
  a.out = (T*)out;
  a.nc = nc;
  a.gmax = gmax;
  a.items = Q > 0 ? Q : T_;
  if (B == 0) return 0;
  const dim3 grid((a.items + kPickWarps - 1) / kPickWarps, B);
  const cudaStream_t st = (cudaStream_t)stream;
  if (nc <= 32 * 4)
    launch_pick_kernel<T, 4>(a, grid, st);
  else if (nc <= 32 * 8)
    launch_pick_kernel<T, 8>(a, grid, st);
  else
    launch_pick_kernel<T, kSlots>(a, grid, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The DFT kernel's dynamic shared memory above 48 KB: once per device.
int swipe_prepare() {
  int e = (int)cudaFuncSetAttribute((const void*)dft_kernel<double>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    dft_smem<double>());
  if (e) return e;
  return (int)cudaFuncSetAttribute((const void*)dft_kernel<float>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   dft_smem<float>());
}

// The loudness of every window size of a call, two launches (the DFT, then
// the ERB epilogue).  x [B, L]; per window i < nwin (host arrays): win[i]
// [nfft[i]], cols[i] [nfft[i], nu[i], 2] ((cos, -sin) of each needed bin),
// scale[i] [nu[i]], erb_c[i] [nerb[i]] int32 (each < nu[i] - 1), erb_w[i]
// [nerb[i]], ln[i] [B, nf[i], nerb[i]], scratch[i]: ks[i] == 1 [B nf[i],
// nu[i]], else [ks[i], B nf[i], nu[i], 2]; frame f of utterance b reads
// x[b, f hop[i] - pad_pre[i] + n] (0 outside x); ks[i] a power of two (at
// most 8), nfft[i] a multiple of 32 ks[i].  float64 (swipe_loudness_f64)
// or float32 (swipe_loudness_f32).  Returns the cudaError_t of the
// launches (0 on success).
int swipe_loudness_f64(const void* x, int B, int L, int nwin,
                       const void* const* win, const void* const* cols,
                       const void* const* scale, const void* const* erb_c,
                       const void* const* erb_w, void* const* ln,
                       void* const* scratch, const int* nf, const int* nfft,
                       const int* hop, const int* pad_pre, const int* nu,
                       const int* nerb, const int* ks, void* stream) {
  return launch_loudness<double>(x, B, L, nwin, win, cols, scale, erb_c,
                                 erb_w, ln, scratch, nf, nfft, hop, pad_pre,
                                 nu, nerb, ks, stream);
}

int swipe_loudness_f32(const void* x, int B, int L, int nwin,
                       const void* const* win, const void* const* cols,
                       const void* const* scale, const void* const* erb_c,
                       const void* const* erb_w, void* const* ln,
                       void* const* scratch, const int* nf, const int* nfft,
                       const int* hop, const int* pad_pre, const int* nu,
                       const int* nerb, const int* ks, void* stream) {
  return launch_loudness<float>(x, B, L, nwin, win, cols, scale, erb_c,
                                erb_w, ln, scratch, nf, nfft, hop, pad_pre,
                                nu, nerb, ks, stream);
}

// Per window i < nwin (host arrays): si[i] [B, nf[i], nj[i]], tlo[i] [T]
// int64 (each < nf[i] - 1), tw[i] [T], mu[i] [nj[i]], its candidates
// j0[i] .. j0[i] + nj[i] - 1.  vinv [nc, 3, 3], nftc [nc, gmax], nftc_len
// [nc] int32 (>= 1 on rows 1 .. nc - 2), left [nc].  Q == 0: tt [T] (the
// steps' times), out [B, T, 3]; Q > 0 (the f0 grid): gpc, gnx [Q] int64
// steps, gw [Q], gbelow [Q] bytes, tt [Q] (the grid's times), out
// [B, Q, 3].
int swipe_pick_f64(const void* const* si, const void* const* tlo,
                   const void* const* tw, const void* const* mu,
                   const int* j0, const int* nj, const int* nf, int nwin,
                   const void* vinv, const void* nftc, const void* nftc_len,
                   const void* left, const void* tt, double pc0,
                   const void* gpc, const void* gnx, const void* gw,
                   const void* gbelow, int Q, void* out, int B, int nc,
                   int T_, int gmax, void* stream) {
  return launch_pick<double>(si, tlo, tw, mu, j0, nj, nf, nwin, vinv, nftc,
                             nftc_len, left, tt, pc0, gpc, gnx, gw, gbelow,
                             Q, out, B, nc, T_, gmax, stream);
}

int swipe_pick_f32(const void* const* si, const void* const* tlo,
                   const void* const* tw, const void* const* mu,
                   const int* j0, const int* nj, const int* nf, int nwin,
                   const void* vinv, const void* nftc, const void* nftc_len,
                   const void* left, const void* tt, double pc0,
                   const void* gpc, const void* gnx, const void* gw,
                   const void* gbelow, int Q, void* out, int B, int nc,
                   int T_, int gmax, void* stream) {
  return launch_pick<float>(si, tlo, tw, mu, j0, nj, nf, nwin, vinv, nftc,
                            nftc_len, left, tt, pc0, gpc, gnx, gw, gbelow, Q,
                            out, B, nc, T_, gmax, stream);
}

}  // extern "C"
