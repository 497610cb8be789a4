"""The port's batched engine (eaqhm_torch.parallel.batch_engine) against the
JAX package's (eaqhm_tpu.parallel.batch_engine): the host geometry and tier
plan compared live (pure numpy), and analyze_batch (mesh=None, float64, on
the CPU) held to JAX's result on the inputs of tests/test_batch_engine.py,
recorded by tools/make_torch_parity_ref.py ("batch" group).
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from eaqhm_torch.config import EaqhmConfig as TConfig, config_from_dict
from eaqhm_torch.parallel import batch_engine as tbe
from eaqhm_tpu.config import EaqhmConfig as JConfig
from eaqhm_tpu.parallel import batch_engine as jbe

SRER_TOL_DB = 1e-6       # tests/test_engine_golden.py tolerances
WAVE_TOL = 1e-8
_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                        "torch_parity_ref.npz")


def _mesh(dp, mp):
    """A stand-in with the mesh shape both packages read (JAX's
    mesh.devices.shape, the port's DeviceMesh.shape)."""
    return SimpleNamespace(shape=(dp, mp), devices=np.empty((dp, mp)))


@pytest.mark.parametrize("kw,length,shape", [
    ({"gender": "female"}, 32000, (1, 1)),
    ({"gender": "male"}, 32000, (2, 2)),
    ({"gender": "female", "partials": 10}, 9601, (2, 2)),
    ({"gender": (150.0, 280.0), "step": 12}, 20001, (1, 2)),
])
def test_geometry_and_tier_plan_match_jax(kw, length, shape):
    mesh = None if shape == (1, 1) else _mesh(*shape)
    g_t = tbe.make_batch_geometry(16000, length, TConfig(**kw), mesh)
    g_j = jbe.make_batch_geometry(16000, length, JConfig(**kw), mesh)
    for f in ("fs", "length", "step", "No", "W", "Kc", "chunk", "dp", "mp",
              "tiers", "tier_list", "No_loc", "n_chunks_loc", "Kc_pad",
              "Kc_loc"):
        assert getattr(g_t, f) == getattr(g_j, f), f
    assert tbe._make_tiers(g_t.W, g_t.Kc, 16000.0, 3) == jbe._make_tiers(
        g_j.W, g_j.Kc, 16000.0, 3)
    rng = np.random.default_rng(len(kw) + length)
    voiced = rng.random(g_t.No) < 0.8
    K = rng.integers(1, g_t.Kc + 1, g_t.No)
    wl = np.where(voiced, rng.integers(120, g_t.W + 1, g_t.No), 0)
    for a, b in zip(tbe.make_tier_plan(g_t, voiced, wl, K),
                    jbe.make_tier_plan(g_j, voiced, wl, K)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def batch_run():
    with np.load(_FIXTURE) as d:
        ref = {k[len("batch/"):]: d[k] for k in d.files
               if k.startswith("batch/")}
    cfg = config_from_dict(json.loads(str(ref["config"])))
    out = tbe.analyze_batch(list(ref["signals"]), 16000, cfg, device="cpu")
    return out, ref


def test_analyze_batch_matches_jax(batch_run):
    out, ref = batch_run
    assert out.n_adaptations == int(ref["n_adaptations"])
    np.testing.assert_allclose(out.srer, ref["srer"], rtol=0,
                               atol=SRER_TOL_DB)
    np.testing.assert_allclose(out.final_srer, ref["final_srer"], rtol=0,
                               atol=SRER_TOL_DB)
    assert out.s_recon.shape == ref["s_recon"].shape
    np.testing.assert_allclose(out.s_recon, ref["s_recon"], rtol=0,
                               atol=WAVE_TOL)
    assert (out.final_srer > 15.0).all(), out.final_srer


def test_srer_mean_is_the_mean_of_final_srer(batch_run):
    out, ref = batch_run
    assert abs(out.srer_mean - float(np.mean(out.final_srer))) < 1e-9
    assert abs(out.srer_mean - float(ref["srer_mean"])) < SRER_TOL_DB


def test_analyze_batch_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbe.analyze_batch([np.zeros(4000)], 16000, TConfig())
