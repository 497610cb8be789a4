"""The pitch stage's plain versions (ops.pitch: the loudness and the pick
that the CUDA kernels swipe_loudness and swipe_pick compute), its device
plan and DFT-basis caches, the kernels' launch arguments, and the batch
engine's batched pitch call, against the JAX package in float64 on the
CPU."""
import ctypes
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from eaqhm_torch.kernels import build
from eaqhm_torch.models import engine as te
from eaqhm_torch.models import swipe as tsw
from eaqhm_torch.ops import pitch
from eaqhm_torch.ops import stft as tstft
from eaqhm_torch.parallel import batch_engine as tbe
from eaqhm_torch.config import EaqhmConfig
from eaqhm_tpu.models import engine as je
from eaqhm_tpu.models import swipe as jsw
from eaqhm_tpu.ops import stft as jstft

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "sa19_golden.npz")


def _voice(n, fs, f0, seed):
    """Harmonics of a gliding f0 plus white noise (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    ph = 2 * np.pi * np.cumsum(f0 * (1 + 0.05 * np.sin(2 * np.pi * 2 * t))) / fs
    s = sum(0.3 / k * np.sin(k * ph) for k in range(1, 9))
    return s + 1e-3 * rng.normal(size=n)


# (name, fs, (f0min, f0max), signal): SA19's female plan on the golden
# resynthesis; "other" (four window sizes, 256-2048); 22.05 kHz male
def _case(name):
    if name == "female_sa19":
        s = np.load(GOLDEN)["s_recon"]
        return 16000, (160.0, 300.0), np.pad(s, (0, 65536 - len(s)))
    if name == "other":
        return 16000, (70.0, 500.0), _voice(8192, 16000, 180.0, 1)
    return 22050, (70.0, 180.0), _voice(6144, 22050, 95.0, 2)


CASES = ("female_sa19", "other", "male_22k")


def _jax_stage(plan, s):
    S = jsw.pitch_strength(plan, jnp.asarray(s))
    p, st = jsw.fine_tune(plan, S)
    out = jsw.swipep(plan, jnp.asarray(s))
    return np.asarray(S), np.asarray(p), np.asarray(st), np.asarray(out)


@pytest.mark.parametrize("name", CASES)
def test_plain_versions_composed_match_jax(name):
    """The plain stage (loudness_reference per window size, the kernel
    product, blend_reference) equals JAX's pitch_strength;
    fine_tune_reference on JAX's S equals JAX's fine_tune; pick_reference
    of the same products equals JAX's swipep (rtol 1e-9); swipep of a batch
    of one gives the utterance's result."""
    fs, (lo, hi), s = _case(name)
    jplan = jsw.make_plan(float(fs), lo, hi, len(s))
    tplan = tsw.make_plan(float(fs), lo, hi, len(s))
    if name == "other":
        assert [w.nfft for w in tplan.windows] == [2048, 1024, 512, 256]
    S_j, p_j, s_j, out_j = _jax_stage(jplan, s)
    x = torch.as_tensor(s)[None]
    dp = tsw.device_plan(tplan, torch.float64, x.device)
    Si = []
    for w in dp.windows:
        spec = tstft.spectrum(x, w.nfft, w.hop, w.window, w.pad_pre,
                              w.pad_post)
        ln = pitch.loudness_reference(spec, w)
        assert ln.shape == (1, w.nf, w.erb_lo.shape[0])
        Si.append(torch.matmul(ln, w.kernel.t()))
    S = pitch.blend_reference(Si, dp)[0]
    np.testing.assert_allclose(S.numpy().T, S_j, rtol=1e-9, atol=1e-12)
    p, st = pitch.fine_tune_reference(torch.as_tensor(S_j.T.copy()), dp)
    np.testing.assert_allclose(p.numpy(), p_j, rtol=1e-9)
    np.testing.assert_allclose(st.numpy(), s_j, rtol=1e-9, atol=1e-12)
    out = pitch.pick_reference(Si, dp)[0]
    np.testing.assert_allclose(out.numpy(), out_j, rtol=1e-9, atol=1e-12)
    assert torch.equal(out, tsw.swipep(tplan, x)[0])
    assert torch.equal(out, tsw.swipep(tplan, x[0]))


def test_batched_swipep_matches_jax_per_utterance():
    """Three utterances in one plain swipep call and one f0-grid resample
    equal JAX's swipep and resample_f0_grid of each utterance."""
    fs, L = 16000, 12000
    xs = np.stack([_voice(L, fs, f0, seed) for f0, seed in
                   ((170.0, 3), (230.0, 4), (280.0, 5))])
    tplan = tsw.make_plan(float(fs), 160.0, 300.0, L)
    jplan = jsw.make_plan(float(fs), 160.0, 300.0, L)
    tq = np.arange(0, L - 1, 80) / fs
    pitch.reset_counts()
    x = torch.as_tensor(xs)
    got = te.resample_f0_grid(tsw.swipep(tplan, x),
                              tsw.device_plan(tplan, x.dtype, x.device).t_grid)
    assert pitch.loudness.plain_calls == 1
    assert pitch.pick.plain_calls == 1
    assert got.shape == (3, len(tq), 3)
    for b in range(3):
        want = je.resample_f0_grid(jsw.swipep(jplan, jnp.asarray(xs[b])),
                                   jnp.asarray(tq))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=1e-9, atol=1e-12)
        one = te.resample_f0_grid(tsw.swipep(tplan, x[b]), torch.as_tensor(tq))
        np.testing.assert_array_equal(got[b].numpy(), one.numpy())


def test_prepare_pitch_matches_jax_pitch_all(monkeypatch):
    """The batch engine's _prepare makes one pitch call for its utterances;
    the f0 grids it hands the host prologue equal JAX's pitch_all (the
    vmapped swipep and resample_f0_grid of eaqhm_tpu's analyze_batch)."""
    fs = 16000
    sigs = [_voice(n, fs, f0, seed) for n, f0, seed in
            ((12000, 200.0, 6), (11000, 250.0, 7), (12000, 180.0, 8))]
    cfg = EaqhmConfig(gender="female", max_adaptations=1, dtype="float64")
    sig_np, lens = tbe.pad_batch(sigs)
    geom = tbe.make_batch_geometry(fs, sig_np.shape[1], cfg, None)
    if geom.length > sig_np.shape[1]:
        sig_np = np.pad(sig_np, ((0, 0), (0, geom.length - sig_np.shape[1])))
    L = geom.length
    seen, calls = [], []
    orig_prologue, orig_swipep = tbe._host_prologue, tsw.swipep
    monkeypatch.setattr(tbe, "_host_prologue",
                        lambda *a: seen.append(a[2]) or orig_prologue(*a))
    monkeypatch.setattr(tsw, "swipep",
                        lambda plan, x: calls.append(x.shape)
                        or orig_swipep(plan, x))
    tbe._prepare(sig_np, lens, geom, cfg, fs, None, torch.device("cpu"),
                 torch.float64, range(3))
    assert calls == [(3, L)]
    jplan = jsw.make_plan(float(fs), 160.0, 300.0, L)
    t_grid = np.arange(0, L - 1, 80) / fs

    def one(x):
        return je.resample_f0_grid(jsw.swipep(jplan, x),
                                   jnp.asarray(t_grid))

    want = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(sig_np)))
    np.testing.assert_allclose(seen[0], want, rtol=1e-9, atol=1e-12)


def test_second_call_builds_and_uploads_nothing(monkeypatch):
    """After a plan's first call the stage builds no DFT basis and uploads
    no constant (no torch.as_tensor / from_numpy at all), and returns the
    same result bit for bit."""
    fs, L = 16000, 9000               # a length no other test plans
    plan = tsw.make_plan(float(fs), 160.0, 300.0, L)
    x = torch.as_tensor(_voice(L, fs, 220.0, 9))
    tstft.clear_basis_cache()
    counts = {"bases": 0, "as_tensor": 0, "from_numpy": 0}

    def counting(name, fn):
        def run(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(tstft, "_dft_bases",
                        counting("bases", tstft._dft_bases))
    built = tsw.device_plans_built
    first = tsw.swipep(plan, x)
    assert counts["bases"] == len(plan.windows)
    assert tsw.device_plans_built == built + 1
    monkeypatch.setattr(torch, "as_tensor",
                        counting("as_tensor", torch.as_tensor))
    monkeypatch.setattr(torch, "from_numpy",
                        counting("from_numpy", torch.from_numpy))
    second = tsw.swipep(plan, x)
    assert counts == {"bases": len(plan.windows), "as_tensor": 0,
                      "from_numpy": 0}
    assert tsw.device_plans_built == built + 1
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_basis_cache_equals_jax_bases(dtype):
    """The cached cos | -sin equals the JAX package's _dft_bases bit for
    bit (float64 built, then cast); the cache keeps at most BASIS_CACHE."""
    name = str(dtype)[6:]
    for nfft in (256, 1024):
        cosb, sinb = jstft._dft_bases(nfft, np.dtype(name))
        got = tstft.dft_basis(nfft, dtype, "cpu")
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(),
                                      np.concatenate([cosb, sinb], axis=1))
        assert tstft.dft_basis(nfft, dtype, "cpu") is got
    for nfft in range(8, 8 + 2 * (tstft.BASIS_CACHE + 1), 2):
        tstft.dft_basis(nfft, dtype, "cpu")
    assert len(tstft._bases) == tstft.BASIS_CACHE


def _decl_kinds(args, decl):
    """Each argument fits the ctypes type the library declares for it."""
    assert len(args) + 1 == len(decl)              # + the stream
    for a, t in zip(args, decl):
        kind = {ctypes.c_void_p: (int, ctypes.c_void_p),
                ctypes.c_int: (int,), ctypes.c_double: (float,)}[t]
        assert isinstance(a, kind), (a, t)


def test_kernel_arguments_match_the_library():
    """Each launch's arguments (built here on CPU tensors, no launch) have
    the count and kinds the library's C functions declare: swipe_loudness
    from the signal, swipe_pick writing every step and writing the f0
    grid; the checks refuse what the kernels do not take."""
    fs, L = 16000, 9500
    plan = tsw.make_plan(float(fs), 160.0, 300.0, L)
    x = torch.as_tensor(_voice(L, fs, 220.0, 9))[None]
    for dtype, suffix in ((torch.float64, "f64"), (torch.float32, "f32")):
        dp = tsw.device_plan(plan, dtype, x.device)
        xs = x.to(dtype)
        pitch._check_signal(xs, dp)
        lns, sym, args, keep, splits = pitch.loudness_call(xs, dp, 132)
        assert sym == f"swipe_loudness_{suffix}"
        _decl_kinds(args, build.KERNELS["swipe"][1][sym])
        Si = []
        for w, ln, scratch, ks in zip(dp.windows, lns, keep[1], splits):
            assert ln.shape == (1, w.nf, w.erb_lo.shape[0])
            assert ks == pitch.loudness_splits(w.nf, w.scale_c.shape[0],
                                               w.nfft, 132)
            assert scratch.numel() == (ks * 2 if ks > 1 else 1) * (
                w.nf * w.scale_c.shape[0])
            Si.append(torch.matmul(pitch.loudness_table_reference(xs, w),
                                   w.kernel.t()))
        with pytest.raises(ValueError):
            pitch._check_signal(xs[:, :-1000], dp)
        pitch._check_pick(Si, dp)
        for grid, n in ((False, len(plan.t)), (True, dp.t_grid.shape[0])):
            out, sym, args, host = pitch.pick_call(Si, dp, grid)
            assert sym == f"swipe_pick_{suffix}" and out.shape == (1, n, 3)
            _decl_kinds(args, build.KERNELS["swipe"][1][sym])
        with pytest.raises(ValueError):
            pitch._check_pick(Si[:-1], dp)
        other = torch.float32 if dtype == torch.float64 else torch.float64
        with pytest.raises(TypeError):
            pitch._check_pick([si.to(other) for si in Si], dp)
