"""Seeded inputs of the pitch kernels and the comparison of two pitch picks,
shared by the GPU tests and chip_smoke.py's pitch phase (no JAX here)."""
import numpy as np

# |df0| / f0 at or below this is the same 1/768-octave grid point (its
# spacing is 9.0e-4): a last-place difference of pow
SAME_F0 = {"float64": 1e-13, "float32": 1e-5}


def voices(B, L, fs, f0min, f0max, seed):
    """[B, L] float64: per utterance eight harmonics of an f0 gliding inside
    (f0min, f0max), white noise, and a silent first tenth (zero frames)."""
    rng = np.random.default_rng(seed)
    t = np.arange(L) / fs
    out = np.zeros((B, L))
    for b in range(B):
        f0 = np.exp(rng.uniform(np.log(f0min * 1.1), np.log(f0max * 0.9)))
        inst = f0 * (1 + 0.04 * np.sin(2 * np.pi * rng.uniform(0.5, 3) * t))
        ph = 2 * np.pi * np.cumsum(inst) / fs
        amps = rng.uniform(0.2, 1.0, 8) / np.arange(1, 9)
        s = sum(a * np.sin(k * ph) for k, a in enumerate(amps, 1))
        s = s + 0.02 * rng.normal(size=L)
        s[:L // 10] = 0.0
        out[b] = s
    return out


def _host(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def coarse_moves(S_got, S_want, tol):
    """The steps whose coarse pick (the first argmax over the candidates of
    the blended strengths [B, T, nc], numpy or torch) differs between two
    routes, and which of them are proven near ties: in each route the
    strengths at the two argmaxes agree to tol of that route's largest
    |S|.  Returns (moved, tie) [B, T] bool and the largest such gap over
    the moved steps (relative)."""
    S_got, S_want = _host(S_got), _host(S_want)
    a = S_got.argmax(-1)[..., None]
    b = S_want.argmax(-1)[..., None]
    moved = (a != b)[..., 0]

    def gap(S):
        d = np.abs(np.take_along_axis(S, a, -1)
                   - np.take_along_axis(S, b, -1))[..., 0]
        return d / max(float(np.abs(S).max()), np.finfo(np.float64).tiny)

    g = np.maximum(gap(S_got), gap(S_want))
    worst = float(g[moved].max()) if moved.any() else 0.0
    return moved, moved & (g <= tol), worst


def compare_picks(got, want, dtype_name, coarse=None):
    """Two picks (t, f0, strength) [B, T, 3] (numpy): the steps that moved
    (f0 not the same grid point, or with coarse, coarse_moves' result, the
    coarse pick on another candidate), the largest strength error relative
    to the largest strength over every step but the proven near ties of
    the coarse pick (whose fine maximum comes from the other candidate's
    parabola), over those ties and over the moved steps, and whether the
    times are equal."""
    sw = want[..., 2]
    scale = max(float(np.abs(sw).max()), np.finfo(np.float64).tiny)
    ds = np.abs(got[..., 2] - sw) / scale
    f0w = want[..., 1]
    df = np.abs(got[..., 1] - f0w) / np.abs(f0w)
    same = df <= SAME_F0[dtype_name]
    none = np.zeros(sw.shape, bool)
    c_moved, tie, gap = coarse if coarse is not None else (none, none, 0.0)
    moved = ~same | c_moved
    held = ~tie

    def top(a, m):
        return float(a[m].max()) if m.any() else 0.0

    return {"steps": int(sw.size),
            "strength_rel_err": top(ds, held),
            "f0_rel_err_same_point": top(df, same),
            "f0_moved": int(moved.sum()),
            "coarse_moved": int(c_moved.sum()),
            "coarse_ties": int(tie.sum()),
            "coarse_gap": gap,
            "tie_strength_rel_err": top(ds, tie),
            "f0_moved_strength_rel_err": top(ds, moved),
            "t_equal": bool(np.array_equal(got[..., 0], want[..., 0]))}
