"""The port's device DSP on the CPU against scipy and the JAX package:
lfilter (the plain version of the hand kernel), filtfilt, ellip_filter,
lfilter_blocked, medfilt, the reference's flag smoothing and the device VAD
against the host VAD.  float64; inputs from numpy seeds.  The CUDA kernel
against its plain version is in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch
from scipy import signal as ssig

import jax.numpy as jnp
from eaqhm_torch.models import vad as tvad
from eaqhm_torch.ops import filters as tf
from eaqhm_torch.ops import medfilt as tm
from eaqhm_tpu.models import vad as jvad
from eaqhm_tpu.ops import filters as jf
from eaqhm_tpu.ops import medfilt as jm

torch.set_num_threads(1)
FS = 16000


def test_lfilter_matches_scipy_and_jax():
    rng = np.random.default_rng(42)
    b, a = ssig.ellip(6, 0.5, 60, 2 * 1500 / FS, "lowpass")
    x = rng.normal(size=2000)
    zi = ssig.lfilter_zi(b, a) * 0.3
    tf.reset_counts()
    y, zf = tf.lfilter_with_state(b, a, x, zi=zi, device="cpu")
    yr, zr = ssig.lfilter(b, a, x, zi=zi)
    np.testing.assert_allclose(y.numpy(), yr, rtol=0, atol=1e-10)
    np.testing.assert_allclose(zf.numpy(), zr, rtol=0, atol=1e-10)
    yj, zj = jf.lfilter_with_state(b, a, x, zi=zi)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(zf.numpy(), np.asarray(zj), rtol=0, atol=1e-10)
    assert tf.lfilter.plain_calls == 1 and tf.lfilter.launches == 0


def test_lfilter_batched():
    b, a = ssig.butter(3, 0.2)
    x = np.random.default_rng(1).normal(size=(4, 500))
    np.testing.assert_allclose(tf.lfilter(b, a, x, device="cpu").numpy(),
                               ssig.lfilter(b, a, x, axis=-1), atol=1e-12)


@pytest.mark.parametrize("fc,ftype,tol", [
    # tests/test_ops.py's tolerances: the 30 Hz high-pass (poles at radius
    # 0.99939) shapes rounding noise by a DC gain of ~1e16, so any two
    # orders of arithmetic differ at ~1e-2 on white noise
    (30, "highpass", 2e-2), (1500, "lowpass", 1e-8), (1000, "lowpass", 1e-8)])
def test_filtfilt_matches_scipy_and_jax(fc, ftype, tol):
    x = np.random.default_rng(fc).normal(size=5000)
    b, a, zi = tf.design_ellip(FS, fc, ftype)
    ours = tf.filtfilt(b, a, zi, x, device="cpu").numpy()
    np.testing.assert_allclose(ours, ssig.filtfilt(b, a, x), rtol=0, atol=tol)
    np.testing.assert_allclose(ours, np.asarray(jf.filtfilt(b, a, zi, x)),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("fc,ftype,jax_tol", [(30, "highpass", 2e-2),
                                              (1500, "lowpass", 1e-8)])
def test_ellip_filter_matches_scipy_and_jax(fc, ftype, jax_tol):
    """The reference's ellipFilter on a speech-like signal (the 210 Hz
    four-harmonic tone plus noise).  The port runs scipy's recursion in
    scipy's order (1e-10, tests/test_ops.py's lfilter tolerance); JAX's
    scan sums in another order, held to tests/test_ops.py's filtfilt
    tolerances."""
    t = np.arange(FS) / FS
    x = sum(0.3 / k * np.sin(2 * np.pi * k * 210 * t) for k in range(1, 5))
    x = x + 1e-3 * np.random.default_rng(3).normal(size=FS)
    b, a = ssig.ellip(6, 0.5, 60, 2.0 * fc / FS, ftype)
    ours = tf.ellip_filter(x, FS, fc, ftype, device="cpu").numpy()
    np.testing.assert_allclose(ours, ssig.filtfilt(b, a, x), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(
        ours, np.asarray(jf.ellip_filter(x, FS, fc, ftype)), rtol=0,
        atol=jax_tol)


def test_lfilter_blocked_matches():
    """The block-parallel formulation on tests/test_ops.py's moderately
    conditioned filter, against scipy and JAX's version, with an initial
    state and a partial last block."""
    rng = np.random.default_rng(7)
    b, a = ssig.ellip(6, 0.5, 60, 2 * 1000 / FS, "highpass")
    x = rng.normal(size=7777)
    zi = ssig.lfilter_zi(b, a) * x[0]
    ref = ssig.lfilter(b, a, x, zi=zi)[0]
    ours = tf.lfilter_blocked(b, a, x, zi=zi, block=512,
                              dtype=torch.float64, device="cpu").numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-9)
    jax_y = np.asarray(jf.lfilter_blocked(b, a, x, zi=zi, block=512,
                                          dtype=jnp.float64))
    np.testing.assert_allclose(ours, jax_y, rtol=0, atol=1e-9)


@pytest.mark.parametrize("call", [
    lambda x: tf.lfilter(*ssig.butter(2, 0.2), x),
    lambda x: tf.filtfilt(*tf.design_ellip(FS, 1500, "lowpass"), x),
    lambda x: tf.ellip_filter(x, FS, 1500, "lowpass"),
    lambda x: tf.lfilter_blocked(*ssig.butter(2, 0.2), x, block=64),
    lambda x: tm.medfilt(x, 5),
    lambda x: tvad.reference_flag_smooth(x > 0),
    lambda x: tvad.voiced_unvoiced_frames(x, FS, False)[1],
], ids=["lfilter", "filtfilt", "ellip_filter", "lfilter_blocked", "medfilt",
        "flag_smooth", "vad"])
def test_array_inputs_default_to_cuda(call):
    """Given a numpy array and no device, every DSP entry point runs on
    CUDA, as the port's other entry points do: without a card it raises
    rather than run on the CPU."""
    x = np.random.default_rng(2).normal(size=FS // 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            call(x)
    else:
        assert call(x).device.type == "cuda"


@pytest.mark.parametrize("p", [1, 3, 5, 7])
def test_medfilt_matches_jax(p):
    x = np.random.default_rng(p).normal(size=(3, 101))
    np.testing.assert_array_equal(tm.medfilt(x, p, device="cpu").numpy(),
                                  np.asarray(jm.medfilt(x, p)))
    with pytest.raises(ValueError):
        tm.medfilt(x, 4, device="cpu")


def test_reference_flag_smooth_matches_jax():
    flags = np.random.default_rng(5).random(200) < 0.5
    np.testing.assert_array_equal(
        tvad.reference_flag_smooth(torch.as_tensor(flags)).numpy(),
        np.asarray(jvad.reference_flag_smooth(flags)))


@pytest.mark.parametrize("replicate_quirks", [True, False])
def test_device_vad_matches_host_and_jax(replicate_quirks):
    """The gated tone of tests/golden/torch_parity_ref.npz's
    deterministic_part case (voiced run 0.15-0.8 s, faint noise elsewhere):
    the flags of the device VAD equal the host VAD's and JAX's."""
    t = np.arange(FS) / FS
    s = sum(0.3 / k * np.sin(2 * np.pi * k * 210 * t) for k in range(1, 5))
    s = s * ((t > 0.15) & (t < 0.8)) + 1e-4 * np.random.default_rng(
        0).normal(size=FS)
    ti, sp, vo, step = tvad.voiced_unvoiced_frames(
        s, FS, False, replicate_quirks=replicate_quirks, device="cpu")
    hti, hsp, hvo, hstep = tvad.voiced_unvoiced_frames_host(
        s, FS, False, replicate_quirks=replicate_quirks)
    jti, jsp, jvo, jstep = jvad.voiced_unvoiced_frames(
        s, FS, False, replicate_quirks=replicate_quirks)
    assert step == hstep == jstep
    np.testing.assert_array_equal(ti, hti)
    np.testing.assert_array_equal(sp.numpy(), hsp)
    np.testing.assert_array_equal(vo.numpy(), hvo)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    np.testing.assert_array_equal(vo.numpy(), np.asarray(jvo))
    assert 0 < int(vo.sum()) < len(ti)
