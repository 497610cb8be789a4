// SWIPE' pitch on the device: the loudness of every frame of a window size
// and the pick of each 1 ms step's pitch.
//
// Replaces what the JAX package computes as one XLA program per plan (not a
// Pallas kernel): eaqhm_tpu/models/swipe.py:203 pitch_strength with
// eaqhm_tpu/ops/stft.py:46 specgram_psd, :230 fine_tune and :258 swipep.
// The two plain products of that program stay torch.matmul: the windowed
// frames against the DFT bases cos | -sin, and the candidate kernels
// against the loudness.  Between and after them:
//
// swipe_loudness: a block per (frame, utterance) reads the frame's DFT row
//   re | im [2 nbins] and, at the two bins of every ERB point, forms
//   (re^2 + im^2) times the PSD factor (the one-sided doubling over
//   fs sum w^2), the ERB lerp and sqrt(max(0, .)), kept in shared memory;
//   the frame's squared norm is summed in a fixed order (each thread its
//   points in order, then a tree over the threads), and the normalized
//   loudness is written as Ln [B, nerb, nf], the layout the candidate-kernel
//   product reads.  The PSD [nbins, nf] is never written.
// swipe_pick: a thread per (1 ms step, utterance) computes each candidate's
//   strength from the windows' Si [B, nj, nf]: the time lerp between the
//   step's two frames, times mu, added into 0 in window order (as
//   index_add_ adds the windows' rows), takes the first maximum (NaN counts
//   as the largest, as torch.argmax and jnp.argmax), the parabola
//   vinv[il] @ y over the three candidates around it, the first maximum of
//   the parabola on the 1/768-octave grid of that candidate, and the edge
//   rule (a maximum at the lowest or highest candidate gives pc[0] and the
//   coarse strength).  It writes (t, f0, strength) [B, T, 3]; the strength
//   matrix S [nc, T] is never written.
//
// Every product and sum is rounded on its own (__dmul_rn / __dadd_rn and
// their float32 forms: nothing is contracted into a fused multiply-add), in
// the order of the plain version's torch ops, so the kernels pick the grid
// points the plain version picks; sqrt, the division and pow are CUDA's
// (IEEE sqrt and division, as torch's kernels call them); swipe_pick is bit
// for bit the plain version's function, swipe_loudness differs only in the
// order of the norm's sum.  Bound: both kernels read their inputs once and
// write their outputs once (bytes); the work is a few operations per byte.
// The stage's cost on the card is the launches and the host, which this
// design cuts to a few launches per window size.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxWindows = 16;
constexpr int kLoudThreads = 256;
constexpr int kPickThreads = 128;

// round-to-nearest products and sums that the compiler may not contract
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ bool takes(T v, T best) {
  // the first maximum, NaN the largest (torch.argmax / jnp.argmax)
  return v > best || (v != v && best == best);
}

template <typename T>
__global__ void __launch_bounds__(kLoudThreads)
loudness_kernel(const T* __restrict__ spec, const long long* __restrict__ lo,
                const T* __restrict__ w, const T* __restrict__ scale,
                T* __restrict__ ln, int nf, int nbins, int nerb) {
  extern __shared__ unsigned char smem_raw[];
  T* L = reinterpret_cast<T*>(smem_raw);           // [nerb]
  T* part = L + nerb;                              // [kLoudThreads]
  const int f = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const T* row = spec + ((size_t)b * nf + f) * (2 * (size_t)nbins);
  T sum = T(0);
  for (int e = tid; e < nerb; e += kLoudThreads) {
    const long long i0 = lo[e], i1 = i0 + 1;
    const T re0 = row[i0], im0 = row[nbins + i0];
    const T re1 = row[i1], im1 = row[nbins + i1];
    const T p0 = mul(add(mul(re0, re0), mul(im0, im0)), scale[i0]);
    const T p1 = mul(add(mul(re1, re1), mul(im1, im1)), scale[i1]);
    const T we = w[e];
    const T pe = add(mul(p0, sub(T(1), we)), mul(p1, we));
    const T l = sqrt(pe < T(0) ? T(0) : pe);       // NaN stays NaN (clamp)
    L[e] = l;
    sum = add(sum, mul(l, l));
  }
  part[tid] = sum;
  __syncthreads();
  for (int s = kLoudThreads / 2; s > 0; s >>= 1) {
    if (tid < s) part[tid] = add(part[tid], part[tid + s]);
    __syncthreads();
  }
  const T norm = sqrt(part[0]);
  const bool pos = norm > T(0);
  T* out = ln + (size_t)b * nerb * nf + f;
  for (int e = tid; e < nerb; e += kLoudThreads)
    out[(size_t)e * nf] = pos ? L[e] / norm : T(0);
}

template <typename T>
struct PickWindow {
  const T* si;            // [B, nj, nf]
  const long long* tlo;   // [T]
  const T* tw;            // [T]
  const T* mu;            // [nj]
  int j0, nj, nf;
};

template <typename T>
struct PickArgs {
  PickWindow<T> win[kMaxWindows];
  int nwin;
};

// the blended strength of candidate c at step t of utterance b
template <typename T>
__device__ __forceinline__ T strength(const PickArgs<T>& a, int b, int t,
                                      int c) {
  T s = T(0);
  for (int i = 0; i < a.nwin; ++i) {
    const PickWindow<T>& w = a.win[i];
    const int k = c - w.j0;
    if (k < 0 || k >= w.nj) continue;
    const T* row = w.si + ((size_t)b * w.nj + k) * w.nf;
    const long long lo = w.tlo[t];
    const T tw = w.tw[t];
    const T sit = add(mul(row[lo], sub(T(1), tw)), mul(row[lo + 1], tw));
    s = add(s, mul(w.mu[k], sit));
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kPickThreads)
pick_kernel(PickArgs<T> a, const T* __restrict__ vinv,
            const T* __restrict__ nftc, const int* __restrict__ nftc_len,
            const T* __restrict__ left, const T* __restrict__ tt, T pc0,
            T* __restrict__ out, int nc, int T_, int gmax) {
  const int t = blockIdx.x * kPickThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (t >= T_) return;
  T smax = strength(a, b, t, 0);
  int i = 0;
  for (int c = 1; c < nc; ++c) {
    const T v = strength(a, b, t, c);
    if (takes(v, smax)) {
      smax = v;
      i = c;
    }
  }
  const int il = i < 1 ? 1 : (i > nc - 2 ? nc - 2 : i);
  const T y0 = strength(a, b, t, il - 1);
  const T y1 = strength(a, b, t, il);
  const T y2 = strength(a, b, t, il + 1);
  const T* v = vinv + (size_t)il * 9;
  const T c0 = add(add(mul(v[0], y0), mul(v[1], y1)), mul(v[2], y2));
  const T c1 = add(add(mul(v[3], y0), mul(v[4], y1)), mul(v[5], y2));
  const T c2 = add(add(mul(v[6], y0), mul(v[7], y1)), mul(v[8], y2));
  const T* g = nftc + (size_t)il * gmax;
  const int n = nftc_len[il];
  T sfine = add(add(mul(mul(c0, g[0]), g[0]), mul(c1, g[0])), c2);
  int kbest = 0;
  for (int k = 1; k < n; ++k) {
    const T gk = g[k];
    const T val = add(add(mul(mul(c0, gk), gk), mul(c1, gk)), c2);
    if (takes(val, sfine)) {
      sfine = val;
      kbest = k;
    }
  }
  const bool edge = i == 0 || i == nc - 1;
  const T step = mul(T(kbest - 1), T(1.0 / 768.0));
  const T p = edge ? pc0 : pow(T(2), add(left[il], step));
  T* o = out + ((size_t)b * T_ + t) * 3;
  o[0] = tt[t];
  o[1] = p;
  o[2] = edge ? smax : sfine;
}

template <typename T>
int launch_loudness(const void* spec, const void* lo, const void* w,
                    const void* scale, void* ln, int B, int nf, int nbins,
                    int nerb, void* stream) {
  if (B < 0 || B > 65535 || nf < 0 || nbins < 2 || nerb < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || nf == 0 || nerb == 0) return 0;
  const size_t smem = (size_t)(nerb + kLoudThreads) * sizeof(T);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  loudness_kernel<T><<<dim3(nf, B), kLoudThreads, smem,
                       (cudaStream_t)stream>>>(
      (const T*)spec, (const long long*)lo, (const T*)w, (const T*)scale,
      (T*)ln, nf, nbins, nerb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pick(const void* const* si, const void* const* tlo,
                const void* const* tw, const void* const* mu, const int* j0,
                const int* nj, const int* nf, int nwin, const void* vinv,
                const void* nftc, const void* nftc_len, const void* left,
                const void* tt, double pc0, void* out, int B, int nc, int T_,
                int gmax, void* stream) {
  if (nwin < 1 || nwin > kMaxWindows || nc < 3 || gmax < 1 || B < 0 ||
      T_ < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T_ == 0) return 0;
  PickArgs<T> a{};
  a.nwin = nwin;
  for (int i = 0; i < nwin; ++i) {
    if (nf[i] < 2 || nj[i] < 1 || j0[i] < 0 || j0[i] + nj[i] > nc)
      return (int)cudaErrorInvalidValue;
    a.win[i] = PickWindow<T>{(const T*)si[i], (const long long*)tlo[i],
                             (const T*)tw[i], (const T*)mu[i], j0[i], nj[i],
                             nf[i]};
  }
  const dim3 grid((T_ + kPickThreads - 1) / kPickThreads, B);
  pick_kernel<T><<<grid, kPickThreads, 0, (cudaStream_t)stream>>>(
      a, (const T*)vinv, (const T*)nftc, (const int*)nftc_len,
      (const T*)left, (const T*)tt, (T)pc0, (T*)out, nc, T_, gmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// spec: [B, nf, 2 nbins] (re | im) contiguous; lo: [nerb] int64 bins (each
// < nbins - 1); w: [nerb]; scale: [nbins]; ln: [B, nerb, nf].  float64
// (swipe_loudness_f64) or float32 (swipe_loudness_f32).  Returns the
// cudaError_t of the launch (0 on success).
int swipe_loudness_f64(const void* spec, const void* lo, const void* w,
                       const void* scale, void* ln, int B, int nf, int nbins,
                       int nerb, void* stream) {
  return launch_loudness<double>(spec, lo, w, scale, ln, B, nf, nbins, nerb,
                                 stream);
}

int swipe_loudness_f32(const void* spec, const void* lo, const void* w,
                       const void* scale, void* ln, int B, int nf, int nbins,
                       int nerb, void* stream) {
  return launch_loudness<float>(spec, lo, w, scale, ln, B, nf, nbins, nerb,
                                stream);
}

// Per window i < nwin (host arrays): si[i] [B, nj[i], nf[i]], tlo[i] [T]
// int64 (each < nf[i] - 1), tw[i] [T], mu[i] [nj[i]], its candidates
// j0[i] .. j0[i] + nj[i] - 1.  vinv [nc, 3, 3], nftc [nc, gmax], nftc_len
// [nc] int32 (>= 1 on rows 1 .. nc - 2), left [nc], tt [T]; out [B, T, 3].
int swipe_pick_f64(const void* const* si, const void* const* tlo,
                   const void* const* tw, const void* const* mu,
                   const int* j0, const int* nj, const int* nf, int nwin,
                   const void* vinv, const void* nftc, const void* nftc_len,
                   const void* left, const void* tt, double pc0, void* out,
                   int B, int nc, int T_, int gmax, void* stream) {
  return launch_pick<double>(si, tlo, tw, mu, j0, nj, nf, nwin, vinv, nftc,
                             nftc_len, left, tt, pc0, out, B, nc, T_, gmax,
                             stream);
}

int swipe_pick_f32(const void* const* si, const void* const* tlo,
                   const void* const* tw, const void* const* mu,
                   const int* j0, const int* nj, const int* nf, int nwin,
                   const void* vinv, const void* nftc, const void* nftc_len,
                   const void* left, const void* tt, double pc0, void* out,
                   int B, int nc, int T_, int gmax, void* stream) {
  return launch_pick<float>(si, tlo, tw, mu, j0, nj, nf, nwin, vinv, nftc,
                            nftc_len, left, tt, pc0, out, B, nc, T_, gmax,
                            stream);
}

}  // extern "C"
