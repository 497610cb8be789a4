"""The tracks, synthesis and SRER stage (eaqhm_torch.ops.tracks) on the CPU,
float64: its plain version, as the engines call it, against the JAX
package's eaqhm_tpu/models/engine.py ``_scatter_and_interp`` +
``_masked_srer`` and the batch engine's ``_interp_and_synth`` and masked
SRER, on numpy-seeded anchor grids (tests/torch_track_cases.py: runs of
1-5 anchors and longer, runs touching the first and the last anchor, a
column with no run, values outside the acceptance, L > Lp).  Tolerances:
tracks 1e-10 of their largest entry, s 1e-8, SRER 1e-6 dB.  The launch
arguments of the three kernels against the library's argtypes."""
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from eaqhm_torch.kernels import build
from eaqhm_torch.ops import tracks
from eaqhm_torch.parallel import batch_engine as tb
from eaqhm_tpu.models import engine as je
from eaqhm_tpu.parallel import batch_engine as jb
from torch_track_cases import anchor_case

torch.set_num_threads(1)
_CT = {ctypes.c_void_p: int, ctypes.c_int: int, ctypes.c_longlong: int,
       ctypes.c_double: float}


def _close(a, b, rtol=1e-10):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_plain_matches_jax_scatter_and_interp(seed):
    """One utterance, as engine._Adapter._finish calls the stage: dense am
    and fm_current, the anchor rows of am, fm, the corrected ph and the DC,
    s_rec, and the masked SRER."""
    c = anchor_case(seed)
    am, fm, ph, acc = (c[k][0] for k in ("am", "fm", "ph", "acc"))
    a0, voiced, det = c["a0"][0], c["voiced"][0], c["det"][0]
    L, step, fs, n_valid = c["L"], c["step"], c["fs"], int(c["lens"][0])
    std_det = float(np.std(det[:n_valid]))
    n = am.shape[0]
    tracks.reset_counts()
    st = tracks.stage(_t(am)[None], _t(fm)[None], _t(ph)[None],
                      _t(a0)[None], step, fs, L, acc=_t(acc)[None],
                      voiced=_t(voiced)[None])
    srer = tracks.masked_srer(_t(det), st.s[0],
                              std_det=torch.tensor(std_det),
                              n_valid=n_valid)
    assert tracks.stage.plain_calls == tracks.masked_srer.plain_calls == 1
    jr = je._scatter_and_interp(
        jnp.asarray(a0), jnp.asarray(am), jnp.asarray(fm), jnp.asarray(ph),
        jnp.asarray(acc), None, L, step, fs, jnp.asarray(voiced))
    a0_i, am_f, fm_f, ph_f, fm_cur, s_rec = (np.asarray(x) for x in jr)
    assert L > (n - 1) * step + 1
    _close(st.am[0], am_f)
    _close(st.fm_cur[0], fm_cur)
    rows = np.arange(n) * step
    for got, want in zip(st.anchors[:, 0], (am_f, fm_f, ph_f)):
        _close(got, want[rows])
    _close(st.a0_anchor[0], a0_i[rows])
    np.testing.assert_allclose(st.s[0].numpy(), s_rec, rtol=0, atol=1e-8)
    j_srer = float(je._masked_srer(jnp.asarray(det), jnp.asarray(s_rec),
                                   std_det, jnp.asarray(n_valid)))
    assert abs(float(srer) - j_srer) <= 1e-6
    # the cases the grid holds: runs of each length, touching both ends
    acc_eff = acc & (am != 0)
    runs = set()
    for k in range(am.shape[1]):
        x = np.concatenate([[0], acc_eff[:, k].astype(int), [0]])
        edges = np.flatnonzero(np.diff(x))
        for a, b in zip(edges[::2], edges[1::2]):
            runs.add(b - a)
            if a == 0 or b == n:
                runs.add(("end", b - a))
    assert {1, 2, 3, 4, 5} <= runs and ("end", 2) in runs
    assert any(r[1] >= 4 for r in runs if isinstance(r, tuple))
    assert not acc_eff[:, 0].any()


def test_batch_stage_plain_matches_jax_interp_and_synth():
    """Three utterances' columns side by side, as the batch step calls the
    stage: per utterance the DC track, the harmonic partial sum, dense am
    and fm_current against JAX's per-utterance _interp_and_synth; then the
    per-utterance masked SRER of s = s_partial + a0 against the JAX step's
    formula (eaqhm_tpu/parallel/batch_engine.py:419-433)."""
    c = anchor_case(5, G=3, n=90, K=5)
    L, step, fs = c["L"], c["step"], c["fs"]
    acc = c["acc"]
    tr = np.stack([np.where(acc, c[k], 0.0) for k in ("am", "fm", "ph")])
    a0 = np.where(c["voiced"], c["a0"], 0.0)
    geom = tb.BatchGeometry(fs=fs, length=L, step=step, No=90, W=120, Kc=5)
    a0_i, s_part, am_f, fm_cur = tb._interp_and_synth(_t(a0), _t(tr), geom)
    jgeom = jb.BatchGeometry(fs=fs, length=L, step=step, No=90, W=120,
                             Kc=5)
    for b in range(3):
        jr = jb._interp_and_synth(
            jnp.asarray(a0[b]), jnp.asarray(c["am"][b]),
            jnp.asarray(c["fm"][b]), jnp.asarray(c["ph"][b]),
            jnp.asarray(acc[b]), jgeom)
        ja0, js, jam, _, _, jfmc = (np.asarray(x) for x in jr)
        _close(a0_i[b], ja0)
        np.testing.assert_allclose(s_part[b].numpy(), js, rtol=0, atol=1e-8)
        _close(am_f[b], jam)
        _close(fm_cur[b], jfmc)
    s_rec = s_part + a0_i
    lens = _t(c["lens"])
    srer = tracks.masked_srer(_t(c["det"]), s_rec, lens=lens)
    det, sj = jnp.asarray(c["det"]), jnp.asarray(s_rec.numpy())
    m = (jnp.arange(L)[None, :] < jnp.asarray(c["lens"])[:, None]).astype(
        det.dtype)
    nj = jnp.maximum(jnp.sum(m, axis=1), 1.0)

    def mstd(x):
        mu = jnp.sum(x * m, axis=1) / nj
        return jnp.sqrt(jnp.sum(m * (x - mu[:, None]) ** 2, axis=1) / nj)
    want = np.asarray(20.0 * jnp.log10(mstd(det) / mstd(det - sj)))
    np.testing.assert_allclose(srer.numpy(), want, rtol=0, atol=1e-6)


def test_stage_out_buffers_and_dc_apart():
    """``out`` receives the dense tracks; dc="apart" gives the DC track
    apart and s without it; dense gives fm and ph; the three kernels'
    wrappers raise on CPU tensors (no plain route there)."""
    c = anchor_case(7, n=40, K=3)
    args = [_t(c[k]) for k in ("am", "fm", "ph")] + [_t(c["a0"])]
    L, step, fs = c["L"], c["step"], c["fs"]
    ref = tracks.stage(*args, step, fs, L, acc=_t(c["acc"]))
    buf = (torch.full((1, L, 3), 9.0, dtype=torch.float64),
           torch.full((1, L, 3), 9.0, dtype=torch.float64))
    got = tracks.stage(*args, step, fs, L, acc=_t(c["acc"]), out=buf)
    assert got.am is buf[0] and got.fm_cur is buf[1]
    assert torch.equal(buf[0], ref.am) and torch.equal(buf[1], ref.fm_cur)
    apart = tracks.stage(*args, step, fs, L, acc=_t(c["acc"]), dc="apart",
                         dense=True, anchors=False)
    assert apart.anchors is None and apart.a0_anchor is None
    torch.testing.assert_close(apart.s + apart.a0, ref.s, rtol=0,
                               atol=1e-12)
    rows = torch.arange(40) * step
    assert torch.equal(apart.fm[0][rows], ref.anchors[1, 0])
    assert torch.equal(apart.ph[0][rows], ref.anchors[2, 0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tracks.track_spline(*args[:2], None, args[3], None, step)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tracks.track_synth(*args[:3], None, args[3], None, ref.s, step, fs,
                           L)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tracks.track_srer(ref.s, ref.s, lens=torch.tensor([L]))
    with pytest.raises(ValueError, match="length"):
        tracks.stage(*args, step, fs, 39 * step)


def test_launch_arguments_match_the_library():
    """kernels.build registers tracks.cu (built with -fmad=false); every
    argument the wrappers pass (the stream last) has the Python type of its
    argtype, in number and order; a strided anchor table is passed as it
    lies."""
    src, syms = build.KERNELS["tracks"]
    assert src == "tracks.cu"
    assert build.EXTRA_FLAGS["tracks"] == ("-fmad=false",)
    c = anchor_case(3, G=2, n=30, K=4)
    wide = torch.zeros((3, 2, 30, 6), dtype=torch.float32)
    for i, k in enumerate(("am", "fm", "ph")):
        wide[i, ..., 1:5] = _t(c[k])
    am, fm, ph = (wide[i, ..., 1:5] for i in range(3))
    a0, acc = _t(c["a0"]).float(), _t(c["acc"])
    M, sym1, args1, keep = tracks.spline_call(am, fm, acc, a0, None, 15)
    assert keep[0].data_ptr() == am.data_ptr() and args1[-3:-1] == (180, 6)
    assert tuple(M.shape) == (30, 2 * 4 + 2)
    st, sym2, args2, _ = tracks.synth_call(
        am, fm, ph, acc, a0, None, M, 15, 16000.0, c["L"], dc="sum",
        anchors=True, dense=False)
    assert st.fm is None and tuple(st.anchors.shape) == (3, 2, 30, 4)
    s = torch.zeros((2, c["L"]), dtype=torch.float32)
    _, sym3, args3, _ = tracks.srer_call(s, s, _t(c["lens"]), None, None)
    assert (sym1, sym2, sym3) == ("track_spline_f32", "track_synth_f32",
                                  "track_srer_f32")
    for sym, args in ((sym1, args1), (sym2, args2), (sym3, args3)):
        argtypes = syms[sym]
        assert len(argtypes) == len(args) + 1, sym
        assert argtypes[-1] is ctypes.c_void_p          # the stream
        for a, t in zip(args, argtypes):
            assert type(a) is _CT[t], (sym, a, t)
