"""The port's application surface on the CPU: structs, checkpoints (and
their file format shared with the JAX package), the corpus driver, the CLI,
plots and the MATLAB-compat helpers, mirroring tests/test_aux_subsystems.py
and tests/test_compat.py.  Analyses run at small sizes: 0.5 s tones, eight
partials, at most one adaptation."""
import json
import os

import numpy as np
import pytest
import torch

import eaqhm_torch
from eaqhm_torch import structs
from eaqhm_torch.parallel.corpus import pad_batch, run_corpus
from eaqhm_torch.utils import compat
from eaqhm_torch.utils.checkpoint import (CorpusCheckpoint,
                                          load_adaptation_state,
                                          save_adaptation_state)
from eaqhm_tpu.utils import checkpoint as jckpt

torch.set_num_threads(1)
FS = 16000
CHEAP = dict(gender=(150.0, 250.0), partials=8)
CHEAP_ARGS = ["--gender", "150,250", "--partials", "8", "--device", "cpu"]


def _tone(dur=0.5, f0=200.0):
    t = np.arange(int(FS * dur)) / FS
    return sum(0.3 / k * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 4))


def _tone_wav(path, f0=200.0):
    from scipy.io import wavfile
    s = _tone(f0=f0)
    wavfile.write(path, FS, (s * 32767 / np.max(np.abs(s))).astype(np.int16))
    return path


@pytest.fixture(scope="module")
def result():
    cfg = eaqhm_torch.EaqhmConfig(max_adaptations=0, **CHEAP)
    return eaqhm_torch.analyze(_tone(), FS, cfg, device="cpu")


def test_structs_from_result(result):
    dets = structs.from_result(result)
    assert len(dets) == len(result.det_ti)
    voiced = [d for d in dets if d.isVoiced]
    assert voiced and all(len(d.ak) == len(d.frange) == len(d.pk)
                          for d in voiced)
    assert any(len(d.ak) > 0 for d in voiced)
    i = next(i for i, d in enumerate(dets) if len(d.ak))
    nz = result.det_ak[i] != 0
    np.testing.assert_array_equal(dets[i].ak, result.det_ak[i][nz])
    np.testing.assert_array_equal(dets[i].pk, result.det_pk[i][nz])
    frames = structs.frames_from_result(result)
    assert len(frames) == len(dets)
    assert (frames[0].ti, frames[0].isSpeech) == (dets[0].ti,
                                                  dets[0].isSpeech)
    assert eaqhm_torch.Deterministic is structs.Deterministic
    assert eaqhm_torch.Frame is structs.Frame
    assert eaqhm_torch.gender_pitch_limits("female") == (160.0, 300.0)


def test_corpus_checkpoint_roundtrip(tmp_path):
    ck = CorpusCheckpoint(str(tmp_path / "ck"))
    assert not ck.is_done("u1")
    srer = [17.8, 24.4, 24.6]
    s_rec = np.random.default_rng(1).normal(size=1000)
    ck.save_result("u1", srer, s_rec)
    assert ck.is_done("u1") and ck.completed() == ["u1"]
    got = ck.load_result("u1")
    np.testing.assert_allclose(got["s_recon"], s_rec)
    np.testing.assert_allclose(got["srer"], srer)
    ck.mark_failed("u2", "boom")
    assert not ck.is_done("u2")
    assert ck.manifest()["u2"]["status"] == "failed"
    # the JAX package reads the port's corpus checkpoint
    assert jckpt.CorpusCheckpoint(str(tmp_path / "ck")).completed() == ["u1"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_adaptation_state_is_shared_with_jax(tmp_path, writer):
    """A state written by either package loads in the other, tensors
    included on the port's side."""
    path = str(tmp_path / "state.npz")
    state = {"s_recon": np.arange(10.0), "am": np.ones((10, 3))}
    if writer == "jax":
        jckpt.save_adaptation_state(path, 2, [17.0, 24.0, 24.5], state)
        a, srer, got = load_adaptation_state(path)
    else:
        save_adaptation_state(path, 2, [17.0, 24.0, 24.5],
                              {k: torch.as_tensor(v)
                               for k, v in state.items()})
        a, srer, got = jckpt.load_adaptation_state(path)
    assert a == 2 and srer == [17.0, 24.0, 24.5]
    for k, v in state.items():
        np.testing.assert_array_equal(got[k], v)


def test_run_corpus_isolation_and_resume(tmp_path):
    good = _tone_wav(str(tmp_path / "good.wav"))
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"RIFFnotawav")
    cfg = eaqhm_torch.EaqhmConfig(max_adaptations=0, **CHEAP)
    ckdir = str(tmp_path / "ck")
    res = run_corpus([good, bad], cfg, checkpoint_dir=ckdir, device="cpu")
    assert "good" in res.done and "bad" in res.failed
    assert res.done["good"]["final_srer_db"] > 5.0
    assert res.audio_seconds == 0.5
    res2 = run_corpus([good, bad], cfg, checkpoint_dir=ckdir, device="cpu")
    assert res2.skipped == ["good"] and "good" not in res2.done
    assert "bad" in res2.failed


def test_run_corpus_isolates_a_missing_device(tmp_path):
    """device=None means CUDA: without it each utterance fails alone."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    good = _tone_wav(str(tmp_path / "good.wav"))
    res = run_corpus([good], eaqhm_torch.EaqhmConfig(**CHEAP))
    assert "CUDA" in res.failed["good"] and not res.done


def test_pad_batch():
    b, ls = pad_batch([np.ones(5), np.ones(8)])
    assert b.shape == (2, 8) and list(ls) == [5, 8]
    assert b[0, 5:].sum() == 0
    b, _ = pad_batch([np.ones(5), np.ones(8)], length=6)
    assert b.shape == (2, 6) and b[1].sum() == 6


def test_cli_single_file(tmp_path, capsys):
    from eaqhm_torch import cli
    from eaqhm_torch.utils.io import read_wav
    wav = _tone_wav(str(tmp_path / "tone.wav"))
    out = str(tmp_path / "rec.wav")
    rc = cli.main([wav, *CHEAP_ARGS, "--max-adaptations", "1", "--out", out,
                   "--json", "--quiet"])
    assert rc == 0 and os.path.exists(out)
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    fs, s = read_wav(wav)
    res = eaqhm_torch.analyze(s, fs, eaqhm_torch.EaqhmConfig(
        max_adaptations=1, **CHEAP), device="cpu")
    assert payload["srer_db"] == res.srer
    assert payload["final_srer_db"] == max(res.srer) > 5.0
    assert read_wav(out)[1].shape == res.s_recon.shape


def test_cli_corpus_mode(tmp_path, capsys):
    from eaqhm_torch import cli
    d = tmp_path / "corpus"
    d.mkdir()
    _tone_wav(str(d / "a.wav"))
    _tone_wav(str(d / "b.wav"), f0=180.0)
    rc = cli.main([str(d), "--corpus", *CHEAP_ARGS, "--max-adaptations",
                   "0", "--quiet", "--checkpoint-dir", str(tmp_path / "ck")])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["n_done"] == 2 and payload["n_failed"] == 0
    rc = cli.main([str(d), "--corpus", *CHEAP_ARGS, "--quiet",
                   "--checkpoint-dir", str(tmp_path / "ck")])
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["n_skipped"] == 2 and payload["n_done"] == 0


def test_cli_defaults_to_cuda(tmp_path):
    from eaqhm_torch import cli
    assert cli.build_parser().parse_args(["x.wav"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wav = _tone_wav(str(tmp_path / "tone.wav"))
    with pytest.raises(RuntimeError):
        cli.main([wav, "--quiet", "--max-adaptations", "0"])


def test_plots_write_pngs(tmp_path, result):
    pytest.importorskip("matplotlib")
    from eaqhm_torch.utils.plots import plot_graphs, plot_pitch
    s = _tone()
    paths = plot_graphs(s, result.s_recon, FS, out_dir=str(tmp_path))
    assert len(paths) == 4
    for p in paths:
        assert os.path.getsize(p) > 1000
    out = plot_pitch(result.f0_grid, out=str(tmp_path / "f0.png"))
    assert os.path.getsize(out) > 1000


def test_compat_mirrors_the_reference_helpers():
    """tests/test_compat.py's cases on the port's copy."""
    assert compat.normalize == 32768 and compat.min_interp_size == 4
    assert compat.transpose1d_array([1, 2, 3]).shape == (3, 1)
    assert compat.mytranspose([5]).shape == (1, 1)
    a = np.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(compat.mytranspose(a), a.T)
    assert compat.end(np.asarray([1, 2, 3, 4, 5])) == 5
    assert compat.end([[1, 2, 3], [4, 5, 6]]) == 6 and compat.end(7) == 7
    np.testing.assert_array_equal(
        compat.array_by_index(np.asarray([0, 2, 4, 6]), [1, 2, 3, 4]),
        [1, 0, 2, 0, 3, 0, 4])
    np.testing.assert_array_equal(
        compat.array_by_index(np.asarray([1, 3]), 9), [0, 9, 0, 9])
    assert compat.singlelize([[1]]) == 1 and compat.singlelize(4.5) == 4.5
    np.testing.assert_array_equal(
        compat.apply_fn([[1, 2], [3, 4]], lambda v: v * 2), [[2, 4], [6, 8]])
    with pytest.raises(TypeError):
        compat.apply_fn("nope", lambda v: v)
    assert compat.is_num(np.float32(1)) and compat.is_complex(1 + 2j)
    assert not compat.is_num([1]) and not compat.is_container((1, 2))
    assert compat.is_empty([]) and not compat.is_empty(0)
    assert compat.transpose1dArray is compat.transpose1d_array
    assert compat.arrayByIndex is compat.array_by_index
    assert compat.isNum is compat.is_num
    assert compat.ellipFilter is compat.ellip_filter


def test_compat_medfilt_vs_reference_semantics():
    rng = np.random.default_rng(0)
    x = rng.normal(size=50)
    xp = np.concatenate([x[0] * np.ones(2), x, x[-1] * np.ones(2)])
    expected = np.asarray([np.median(xp[i:i + 5]) for i in range(len(x))])
    np.testing.assert_array_equal(compat.medfilt(x, 5, device="cpu").numpy(), expected)
