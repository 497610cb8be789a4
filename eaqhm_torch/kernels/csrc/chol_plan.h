// The Cholesky kernel's tiled-path schedule (chol_solve.cu), in one place.
//
// chol_solve.cu includes this file, and its launcher (launch_tiled) takes
// the sequence of launches of a call from tiled_schedule.  The same file,
// compiled alone by the host's C++ compiler (kernels/build.py
// ``load_host``), exports the plan to Python (``chol_tiled_plan``):
// ops/chol.py counts a call's launches and sizes the scratch from it, the
// phase tool divides its clocks by its block counts, and the tests check
// it on a machine without the CUDA toolkit.  Plain C++17; no CUDA.
#ifndef EAQHM_CHOL_PLAN_H
#define EAQHM_CHOL_PLAN_H

namespace chol_plan {

constexpr int kTB = 64;             // panel width and tile edge
constexpr int kMaxGridY = 65535;    // systems of one launch (grid y extent)

enum Kind { kDiag0 = 0, kPanel = 1, kUpdate = 2, kBackward = 3 };

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

}  // extern "C"

#endif  // EAQHM_CHOL_PLAN_H
