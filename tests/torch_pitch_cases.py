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


def compare_picks(got, want, dtype_name):
    """Two picks (t, f0, strength) [B, T, 3] (numpy): the largest strength
    error relative to the largest strength, the steps whose f0 is not the
    same grid point (each a near tie when its strength agrees), and whether
    the times are equal."""
    sw = want[..., 2]
    scale = max(float(np.abs(sw).max()), np.finfo(np.float64).tiny)
    ds = np.abs(got[..., 2] - sw) / scale
    f0w = want[..., 1]
    df = np.abs(got[..., 1] - f0w) / np.abs(f0w)
    moved = df > SAME_F0[dtype_name]
    return {"steps": int(sw.size),
            "strength_rel_err": float(ds.max()) if ds.size else 0.0,
            "f0_rel_err_same_point": float(np.where(moved, 0, df).max())
            if df.size else 0.0,
            "f0_moved": int(moved.sum()),
            "f0_moved_strength_rel_err": float(ds[moved].max())
            if moved.any() else 0.0,
            "t_equal": bool(np.array_equal(got[..., 0], want[..., 0]))}
