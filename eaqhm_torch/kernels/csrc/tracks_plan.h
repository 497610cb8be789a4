// The launch geometry of the tracks kernels (tracks.cu), in one place.
//
// tracks.cu includes this file, and its launchers choose every launch's
// geometry here.  The same file, compiled alone by the host's C++ compiler
// (kernels/build.py ``load_host``), exports the plans to Python
// (``track_spline_plan``, ``track_synth_plan``, ``track_srer_plan``):
// ops/tracks.py sizes the spline's and the SRER's scratch and reports
// blocks a SM from them, and the tests check
// them on a machine without the CUDA toolkit.  Plain C++17; no CUDA.
#ifndef EAQHM_TRACKS_PLAN_H
#define EAQHM_TRACKS_PLAN_H

#include <stddef.h>

#ifdef __CUDACC__
#define TRACKS_HD __host__ __device__ __forceinline__
#else
#define TRACKS_HD inline
#endif

namespace tracks_plan {

constexpr int kSplineWarps = 4;        // tiles of a spline block, a warp each
constexpr int kSplineTargetWarps = 2048;  // warps a spline grid aims for
constexpr int kSynthThreads = 256;     // most threads of a synth block
constexpr int kSynthRows = 16;         // rows of a synth chunk (step + 1 <= 16
                                       // keeps fm between the passes)
constexpr int kPiece = 16;             // columns a thread sums of a row
constexpr int kSynthSlices = 16;       // most segments a synth block holds
constexpr int kSynthMinBlocks = 192;   // ~1.5 blocks on each of 132 SMs
constexpr size_t kSynthSmemAim = 100 * 1024;  // two blocks a SM
constexpr size_t kSynthMaxSmem = 200 * 1024;  // the launch's limit

TRACKS_HD size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Threads of a synth block: S segments of Kl lanes, rounded up to whole
// warps (the threads past them take no segment).
TRACKS_HD int synth_threads(int S, int Kl) { return (S * Kl + 31) / 32 * 32; }

// Shared memory of a synth block of values of isz bytes, in order: the
// per-offset table Bc, Ac, Ac^3 - Ac, Bc^3 - Bc [step + 1] and the bump
// [step] (kept); the row values [rows][threads]; the row sums' pieces (more
// than 16 columns); the masked am, fm, ph of the block's anchors and their
// neighbours [TS + 5][K] and fm of anchors 0 and 1 [2][K]; the DC's anchors
// and M from the block's first anchor [2][TS + 3]; the accepted flags
// [TS + 5][K].  The kernel carves its buffer in this order.
TRACKS_HD size_t synth_smem(int K, int step, int Kl, int S, int J, bool kept,
                            size_t isz) {
  const int rows = kept ? step + 1 : kSynthRows;
  const int pieces = (Kl + kPiece - 1) / kPiece;
  const size_t Kc = K > 0 ? K : 1, TS = (size_t)S * J;
  size_t b = kept ? align16((size_t)(5 * step + 4) * isz) : 0;
  b += align16((size_t)rows * (synth_threads(S, Kl) | 1) * isz);
  if (pieces > 1) b += align16((size_t)rows * S * pieces * isz);
  b += align16((3 * (TS + 5) + 2) * Kc * isz);
  b += align16(2 * (TS + 3) * isz);
  b += align16((TS + 5) * Kc);
  return b;
}

struct SplinePlan {
  int R;        // anchors a tile
  int tiles;    // tiles along the anchor axis
};

// track_spline: tiles of 32 columns x R anchors, a warp each; the longest R
// of 256, 128, 64 or 32 that still gives the grid kSplineTargetWarps warps,
// else 32.
inline SplinePlan spline_plan(int G, int n, int K) {
  const long long col_tiles = ((long long)G * K + G + 31) / 32;
  int R = 256;
  while (R > 32 && col_tiles * ((n + R - 1) / R) < kSplineTargetWarps)
    R /= 2;
  return {R, (n + R - 1) / R};
}

struct SynthPlan {
  int Kl;           // lanes a segment (the columns a thread steps over)
  int S;            // segments side by side in a block
  int J;            // slices of S segments a block takes in turn
  int threads;      // S * Kl rounded up to whole warps
  bool kept;        // fm kept in shared memory between the passes
  size_t smem;      // dynamic shared memory, bytes
  long long blocks;
};

// track_synth: a thread a (segment, column), S = 256 / K segments side by
// side where K <= 128 (at least 4 whole warps at any K); J slices, so a
// block holds up to kSynthSlices segments while its shared memory stays
// within kSynthSmemAim and the grid keeps kSynthMinBlocks blocks; fm kept
// between the passes where a segment's rows fit one chunk and every column
// has its own thread.  L rows of values of isz bytes.
inline SynthPlan synth_plan(int G, int n, int K, int step, long long L,
                            size_t isz) {
  SynthPlan p;
  p.Kl = K < 1 ? 1 : (K > kSynthThreads ? kSynthThreads : K);
  p.S = kSynthThreads / p.Kl;
  p.threads = synth_threads(p.S, p.Kl);
  p.kept = step + 1 <= kSynthRows && K <= p.Kl;
  const long long Lp = (long long)(n - 1) * step + 1;
  const long long n_seg = (long long)(n - 1)
                          + (L > Lp ? (L - Lp + step - 1) / step : 0);
  auto blocks = [&](int J) {
    return (n_seg + (long long)p.S * J - 1) / ((long long)p.S * J) * G;
  };
  int J = (kSynthSlices + p.S - 1) / p.S;
  while (J > 1 && (synth_smem(K, step, p.Kl, p.S, J, p.kept, isz)
                       > kSynthSmemAim || blocks(J) < kSynthMinBlocks))
    --J;
  p.J = J;
  p.smem = synth_smem(K, step, p.Kl, p.S, J, p.kept, isz);
  p.blocks = blocks(J);
  return p;
}

constexpr int kSrerThreads = 256;      // threads of a track_srer block
constexpr long long kSrerChunk = 2048; // samples of a block: 8 a thread
constexpr int kSrerLaunches = 2;       // the sums, then the deviations

// track_srer: the chunks (blocks a group and launch) of L samples a group.
TRACKS_HD int srer_chunks(long long L) {
  return L > kSrerChunk ? (int)((L + kSrerChunk - 1) / kSrerChunk) : 1;
}

}  // namespace tracks_plan

extern "C" {

// The plans as Python reads them (exported by tracks.cu's library too);
// 0, or 1 for a shape no launch takes.
// out[3]: R, tiles, threads of a block.
int track_spline_plan(int G, int n, int K, long long* out) {
  if (G < 1 || K < 0 || n < 2) return 1;
  const tracks_plan::SplinePlan p = tracks_plan::spline_plan(G, n, K);
  out[0] = p.R;
  out[1] = p.tiles;
  out[2] = 32 * tracks_plan::kSplineWarps;
  return 0;
}

// out[2]: track_srer's chunks a group and its launches, for L >= 1
// samples a group.
int track_srer_plan(long long L, long long* out) {
  if (L < 1) return 1;
  out[0] = tracks_plan::srer_chunks(L);
  out[1] = tracks_plan::kSrerLaunches;
  return 0;
}

// out[7]: Kl, S, J, threads, kept, smem, blocks.
int track_synth_plan(int G, int n, int K, int step, long long L, int isz,
                     long long* out) {
  if (G < 1 || K < 0 || n < 2 || step < 1 || L < 1 ||
      (isz != 4 && isz != 8))
    return 1;
  const tracks_plan::SynthPlan p = tracks_plan::synth_plan(G, n, K, step, L,
                                                           (size_t)isz);
  out[0] = p.Kl;
  out[1] = p.S;
  out[2] = p.J;
  out[3] = p.threads;
  out[4] = p.kept;
  out[5] = (long long)p.smem;
  out[6] = p.blocks;
  return 0;
}

}  // extern "C"

#endif  // EAQHM_TRACKS_PLAN_H
