// The Cholesky kernel's tiled schedules (chol_solve.cu), in one place: the
// tiled factor + solve and the tiled substitution with a kept factor, and
// the substitution's route.
//
// chol_solve.cu includes this file, and its launchers (launch_tiled,
// launch_subst) take the sequence of launches of a call from
// tiled_schedule / subst_schedule and the substitution's path from
// subst_route.  The same file, compiled alone by the host's C++ compiler
// (kernels/build.py ``load_host``), exports them to Python
// (``chol_tiled_plan``, ``chol_subst_plan``, ``chol_subst_route``):
// ops/chol.py counts a call's launches, sizes the scratch and routes the
// substitution from them, the phase tool divides its clocks by its block
// counts, and the tests check them on a machine without the CUDA toolkit.
// Plain C++17; no CUDA.
#ifndef EAQHM_CHOL_PLAN_H
#define EAQHM_CHOL_PLAN_H

namespace chol_plan {

constexpr int kTB = 64;             // panel width and tile edge
constexpr int kMaxGridY = 65535;    // systems of one launch (grid y extent)

enum Kind { kDiag0 = 0, kPanel = 1, kUpdate = 2, kBackward = 3,
            kForward = 4 };

// One launch of the sequence, for one group of systems (its grid's y).
struct Launch {
  int kind;
  int blocks;     // grid x
  int p;          // the panel (kPanel, kUpdate) or row block (kBackward)
  int depth;      // kUpdate: columns of panels applied, 64 or 128
  int col_only;   // kUpdate: the first column of tiles right of panel p
};

// Calls f(Launch) for each launch of one group of systems of order M, in
// launch order; stops at the first f that returns nonzero and returns it.
// The first diagonal block; then the panels in pairs (p, p + 1): panel p's
// rows, the update of the first column of tiles right of it with panel p
// alone, panel p + 1's rows, the update of every tile right of both with
// both; a last panel without a partner updates all it has to; then the
// backward substitution, a launch per 64 rows from the last.  3 ceil(M /
// 64) - 1 launches.
template <typename F>
int tiled_schedule(int M, F&& f) {
  const int nbk = (M + kTB - 1) / kTB;
  int e = f(Launch{kDiag0, 1, 0, 0, 0});
  for (int p = 0; !e && p + 1 < nbk;) {
    const int n = nbk - p - 1;        // tiles right of panel p
    e = f(Launch{kPanel, n, p, 0, 0});
    if (!e && p + 2 < nbk) {
      const int m = n - 1;            // tiles right of panels p, p + 1
      e = f(Launch{kUpdate, n, p, kTB, 1});
      if (!e) e = f(Launch{kPanel, m, p + 1, 0, 0});
      if (!e) e = f(Launch{kUpdate, m * (m + 1) / 2, p, 2 * kTB, 0});
      p += 2;
    } else if (!e) {
      e = f(Launch{kUpdate, n * (n + 1) / 2, p, kTB, 0});
      p += 1;
    }
  }
  for (int u = nbk - 1; !e && u >= 0; --u)
    e = f(Launch{kBackward, u + 1, u, 0, 0});
  return e;
}

// The tiled substitution with a kept factor, for one group of systems of
// order M, as tiled_schedule: the forward sweep L y = b, a launch per
// 64-row block u (kForward, p = u): launch 0 a block that solves the first
// diagonal block; launch u >= 1 a block per 64-row tile t >= u (t = u +
// blockIdx.x) that subtracts L[t, u - 1] y_{u - 1} from its rows, and tile
// u then solves its diagonal block; then the backward sweep L^H x = y, the
// tiled path's backward launches (kBackward).  2 ceil(M / 64) launches.
template <typename F>
int subst_schedule(int M, F&& f) {
  const int nbk = (M + kTB - 1) / kTB;
  int e = 0;
  for (int u = 0; !e && u < nbk; ++u)
    e = f(Launch{kForward, u == 0 ? 1 : nbk - u, u, 0, 0});
  for (int u = nbk - 1; !e && u >= 0; --u)
    e = f(Launch{kBackward, u + 1, u, 0, 0});
  return e;
}

// The substitution's route: 1 for the tiled substitution, 0 for the
// one-block kernel (a block of 256 threads a system, one launch), by the
// order M alone, from the cells measured on an NVIDIA H100 80GB HBM3 at
// 700 W (tools/torch_chol_route.py --subst, eager and as CUDA-graph
// replays; the table is in PERF.md).  The one-block kernel keeps one row
// block (M <= 64), where its single launch leads at the large batches and
// the smallest orders; the tiled substitution takes every larger M, in
// both types and at every batch: as graph replays 1.07x (2405 x 130) to
// 67x (2 x 6146) ahead at every main-path order (M >= 126).  Below that it
// loses at large batches (B >= 512 at M = 65-98, up to 2.1x), and eagerly
// by at most 0.03 ms a call at B <= 128, M <= 194: shapes no main path
// launches.
inline int subst_route(int M) { return M <= kTB ? 0 : 1; }

}  // namespace chol_plan

extern "C" {

// The tiled path's plan of one call of B systems of order M, as Python
// reads it (exported by chol_solve.cu's library too): the launches, the
// systems taken in groups of at most kMaxGridY; out[4]: blocks over the
// call of the panel kernels (the first diagonal block's and the panels'),
// of the trailing updates, of the backward substitution, and the scratch's
// columns a system (the tile edge).  -1 for M < 1 or B < 0.
int chol_tiled_plan(int M, int B, long long* out) {
  if (M < 1 || B < 0) return -1;
  long long blocks[4] = {0, 0, 0, 0};
  int launches = 0;
  chol_plan::tiled_schedule(M, [&](const chol_plan::Launch& l) {
    ++launches;
    blocks[l.kind] += l.blocks;
    return 0;
  });
  const int groups = (B + chol_plan::kMaxGridY - 1) / chol_plan::kMaxGridY;
  out[0] = (blocks[chol_plan::kDiag0] + blocks[chol_plan::kPanel]) * B;
  out[1] = blocks[chol_plan::kUpdate] * B;
  out[2] = blocks[chol_plan::kBackward] * B;
  out[3] = chol_plan::kTB;
  return groups * launches;
}

// The tiled substitution's plan of one call of B systems of order M: the
// launches (the systems in groups of at most kMaxGridY); out[2]: the blocks
// over the call of the forward launches and of the backward launches.  -1
// for M < 1 or B < 0.
int chol_subst_plan(int M, int B, long long* out) {
  if (M < 1 || B < 0) return -1;
  long long blocks[2] = {0, 0};
  int launches = 0;
  chol_plan::subst_schedule(M, [&](const chol_plan::Launch& l) {
    ++launches;
    blocks[l.kind == chol_plan::kForward ? 0 : 1] += l.blocks;
    return 0;
  });
  const int groups = (B + chol_plan::kMaxGridY - 1) / chol_plan::kMaxGridY;
  out[0] = blocks[0] * B;
  out[1] = blocks[1] * B;
  return groups * launches;
}

// chol_plan::subst_route: 1 tiled, 0 one block; -1 for M < 1.
int chol_subst_route(int M) {
  if (M < 1) return -1;
  return chol_plan::subst_route(M);
}

}  // extern "C"

#endif  // EAQHM_CHOL_PLAN_H
