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
from torch_spline_tiles import spline_by_tiles
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
    argtype, in number and order; the source description holds a strided
    anchor table as it lies, and a tier source each tier's pointers,
    strides and width."""
    src, syms = build.KERNELS["tracks"]
    assert src == "tracks.cu"
    assert build.EXTRA_FLAGS["tracks"] == ("-fmad=false",)
    c = anchor_case(3, G=2, n=30, K=4)
    wide = torch.zeros((3, 2, 30, 6), dtype=torch.float32)
    for i, k in enumerate(("am", "fm", "ph")):
        wide[i, ..., 1:5] = _t(c[k])
    am, fm, ph = (wide[i, ..., 1:5] for i in range(3))
    a0, acc = _t(c["a0"]).float(), _t(c["acc"])
    keep = []
    desc = tracks._dense_src(am, fm, ph, acc, a0, None, keep)
    head = (ctypes.c_longlong * 10).from_address(desc)
    assert head[0] == head[1] == 0 and head[2] == am.data_ptr()
    assert tuple(head[8:10]) == (180, 6) and head[7] == 0
    M, sym1, args1, _ = tracks.spline_call(desc, 2, 30, 4, 15,
                                           torch.float32, "cpu")
    assert tuple(M.shape) == (30, 2 * 4 + 2)
    assert args1[5] == tracks.spline_plan(2, 30, 4).tiles    # agg's tiles
    st, sym2, args2, _ = tracks.synth_call(
        desc, 2, 30, 4, torch.float32, "cpu", M, 15, 16000.0, c["L"],
        dc="sum", anchors=True, dense=False)
    assert st.fm is None and tuple(st.anchors.shape) == (3, 2, 30, 4)
    assert args2[-2:] == (1, 16000.0)                   # add_dc, fs
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
    parts = [(a0[0, :10], am[0, :10, :3], fm[0, :10, :3], ph[0, :10, :3],
              acc[0, :10, :3]),
             (a0[1], am[1], fm[1], ph[1], acc[1])]
    fmap = tracks.tier_map([torch.arange(10), torch.arange(5, 35)], 30,
                           "cpu")
    desc = tracks._tier_src(tracks.Tiers(fmap, parts, 4), None,
                            torch.float32, keep)
    d = (ctypes.c_longlong * 28).from_address(desc)
    assert d[0] == fmap.data_ptr() and d[1] == 2
    assert tuple(d[10 + 5:10 + 9]) == (6, 4, 1, 3)      # am row stride, acc
    assert tuple(d[19 + 5:19 + 9]) == (6, 4, 1, 4)      # row stride, a0, Kb
    assert d[19] == am[1].data_ptr()


def test_tier_map_places_each_tier_as_the_scatter_does():
    """tier_map: row * 16 + tier where a tier's frame lands, -1 where none
    does, later tiers over earlier ones, an index past the grid dropped
    (the dump row)."""
    fmap = tracks.tier_map([torch.tensor([0, 3, 4]), torch.tensor([4, 1, 6])],
                           6, "cpu")
    assert fmap.dtype == torch.int32
    assert fmap.tolist() == [0, 1 * 16 + 1, -1, 1 * 16 + 0, 0 * 16 + 1, -1]
    with pytest.raises(ValueError, match="tiers"):
        tracks.tier_map([torch.tensor([0])] * 13, 6, "cpu")


def _tier_case(seed):
    """Three tiers (Kb = 3, 5 and 7) of a 60-frame grid as the sequential
    engine hands them to the stage: the tiers' frames drawn at random, one
    frame in no tier, and in the last tier one entry at the dump row past
    the grid (junk values)."""
    c = anchor_case(seed, n=60, K=7)
    rng = np.random.default_rng(seed)
    n = 60
    frames = rng.permutation(n)
    idx = [np.sort(frames[1:21]), np.sort(frames[21:40]),
           np.append(np.sort(frames[40:]), n)]
    parts = []
    for kb, ix in zip((3, 5, 7), idx):
        rows = np.minimum(ix, n - 1)
        part = [c["a0"][0, rows]] + [c[k][0, rows, :kb]
                                     for k in ("am", "fm", "ph", "acc")]
        if ix[-1] == n:
            for x in part:
                x[-1] = rng.uniform(size=x[-1].shape) > 0.5 \
                    if x.dtype == bool else 7.0
        parts.append(part)
    voiced = np.zeros(n, bool)
    voiced[frames[1:]] = True
    return c, idx, parts, voiced


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_tiers_plain_matches_combine_buckets_and_jax(seed):
    """The tier-map input as engine._Adapter._finish gives it (the CPU
    path: the grid gathered through the map, then the plain stage) against
    JAX's _combine_buckets followed by the port's stage, and against JAX's
    _combine_buckets + _scatter_and_interp: three tiers of different Kb, a
    frame in no tier, an index past the grid.  Tolerances as above."""
    c, idx, parts, voiced = _tier_case(seed)
    n, K, L, step, fs = 60, 7, c["L"], c["step"], c["fs"]
    fmap = tracks.tier_map([_t(ix) for ix in idx], n, "cpu")
    tiers = tracks.Tiers(fmap, tuple(tuple(_t(x) for x in p) for p in parts),
                         K)
    tracks.reset_counts()
    got = tracks.stage_tiers(tiers, step, fs, L, voiced=_t(voiced)[None])
    assert tracks.stage_tiers.plain_calls == 1
    jgrid = je._combine_buckets([tuple(jnp.asarray(x) for x in p)
                                 for p in parts],
                                [jnp.asarray(ix) for ix in idx], n, K,
                                jnp.float64)
    for x, y in zip(tracks.gather_tiers_reference(tiers), jgrid):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    a0, am, fm, ph, acc = (_t(np.asarray(x)) for x in jgrid)
    want = tracks.stage(am[None], fm[None], ph[None], a0[None], step, fs, L,
                        acc=acc[None], voiced=_t(voiced)[None])
    for x, y in zip(got, want):
        assert (x is None) == (y is None)
        if x is not None:
            _close(x, y)
    jr = je._scatter_and_interp(*jgrid, None, L, step, fs,
                                jnp.asarray(voiced))
    a0_i, am_f, fm_f, ph_f, fm_cur, s_rec = (np.asarray(x) for x in jr)
    _close(got.am[0], am_f)
    _close(got.fm_cur[0], fm_cur)
    rows = np.arange(n) * step
    for g, w in zip(got.anchors[:, 0], (am_f, fm_f, ph_f)):
        _close(g, w[rows])
    _close(got.a0_anchor[0], a0_i[rows])
    np.testing.assert_allclose(got.s[0].numpy(), s_rec, rtol=0, atol=1e-8)


def test_stage_tiers_refuses_parts_it_cannot_read():
    """stage_tiers checks what the kernels would read through the frame map
    before any launch or plain call: a tier on another device than the map,
    a float32 tier beside float64 ones, a tier wider than K, shapes that
    disagree, a voiced mask of the wrong shape."""
    c, idx, parts, voiced = _tier_case(2)
    n, K, L, step, fs = 60, 7, c["L"], c["step"], c["fs"]
    fmap = tracks.tier_map([_t(ix) for ix in idx], n, "cpu")
    good = [tuple(_t(x) for x in p) for p in parts]

    def call(ps, k=K, v=_t(voiced)[None]):
        return tracks.stage_tiers(tracks.Tiers(fmap, tuple(ps), k), step, fs,
                                  L, voiced=v)
    bad_dev = list(good)
    bad_dev[1] = tuple(x.to("meta") for x in good[1])
    bad_type = list(good)
    bad_type[2] = (good[2][0], good[2][1].float(), good[2][2].float(),
                   *good[2][3:])
    bad_shape = list(good)
    bad_shape[0] = (good[0][0][:-1], *good[0][1:])
    tracks.reset_counts()
    with pytest.raises(ValueError, match="the frame map on cpu"):
        call(bad_dev)
    with pytest.raises(TypeError, match="tier 2"):
        call(bad_type)
    with pytest.raises(ValueError, match="tier 0"):
        call(bad_shape)
    with pytest.raises(ValueError, match="Kb <= K"):
        call(good, k=5)
    with pytest.raises(ValueError, match="voiced"):
        call(good, v=_t(voiced)[None, :-1])
    assert tracks.plain_calls() == 0
    call(good)
    assert tracks.stage_tiers.plain_calls == 1


def test_spline_and_synth_plans():
    """The launch geometry the launchers choose (kernels/csrc/tracks_plan.h,
    read through its host build): track_spline's tiles (32
    anchors at n = 2 and below one tile, more than 132 warps at SA19's
    sizes, thousands at the stress size n = 64171) and track_synth's block
    (4 to 8 whole warps at every K, every segment covered, within
    100 KB of shared memory up to K = 256 and 200 KB beyond, blocks enough
    for the card unless a block takes one slice, fm kept at step 15 up to
    K = 256); the tiled
    spline (tests/torch_spline_tiles.py, the kernels' arithmetic) equals the
    plain spline where runs cross several tiles of the plan's length and of
    5 anchors."""
    assert tracks.spline_plan(1, 2, 48) == (32, 1, 128)
    assert tracks.spline_plan(1, 20, 7) == (32, 1, 128)
    for n, K in ((2185, 32), (2185, 48), (4369, 48)):
        R, tiles, _ = tracks.spline_plan(1, n, K)
        assert R == 32 and tiles * -(-(K + 1) // 32) > 132
    R, tiles, _ = tracks.spline_plan(1, 64171, 128)
    assert (R, tiles) == (128, 502) and tiles * 5 >= 2048
    assert tracks.spline_plan(64, 2134, 59) == (64, 34, 128)
    for K in (0, 1, 7, 32, 48, 59, 128, 129, 300, 487):
        for step, n, L in ((15, 2185, 32768), (15, 64171, 962560),
                           (40, 30, 40 * 29 + 9)):
            p = tracks.synth_plan(2, n, K, step, L, 8)
            assert 128 <= p.threads <= 256 and p.threads % 32 == 0
            assert p.threads - 32 < p.S * p.Kl <= p.threads
            assert p.smem <= (100 if K <= 256 else 200) * 1024
            assert p.blocks >= 192 or p.J == 1      # kSynthMinBlocks
            assert p.kept == (step == 15 and K <= 256)
            n_seg = n - 1 + -(-(L - (n - 1) * step - 1) // step)
            assert p.blocks * p.S * p.J >= 2 * n_seg
    c = anchor_case(11, n=200, K=4, p_acc=0.99)
    for dt in (np.float64, np.float32):
        am, fm, a0 = (c[k].astype(dt) for k in ("am", "fm", "a0"))
        want = tracks.spline_reference(
            torch.as_tensor(am), torch.as_tensor(fm), torch.as_tensor(a0),
            15, acc=_t(c["acc"]), voiced=_t(c["voiced"])).numpy()
        for R in (tracks.spline_plan(1, 200, 4)[0], 5):
            got = spline_by_tiles(am, fm, a0, 15.0, R, acc=c["acc"],
                                  voiced=c["voiced"])
            _close(got, want, rtol=1e-12 if dt == np.float64 else 2e-6)


@pytest.mark.parametrize("L,chunks", [(1, 1), (2048, 1), (2049, 2),
                                      (65537, 33), (962560, 470)])
def test_srer_plan(L, chunks):
    """track_srer's chunks a group (blocks of 2048 samples) and the scratch
    they need; two launches a call at every length."""
    assert tracks.srer_plan(L) == (chunks, 2)
    s = torch.zeros((2, L), dtype=torch.float64)
    _, _, args, keep = tracks.srer_call(s, s, None, None, L)
    assert tuple(keep[5].shape) == (2, chunks, 4)
    assert args[7:9] == (2, chunks)
