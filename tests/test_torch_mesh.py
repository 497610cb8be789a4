"""The port's mesh path over torch.distributed: one spawned gloo world of 4
CPU ranks on a (data=2, model=2) mesh runs the batched engine, the sharded
corpus path and the determinism policy, and ``multihost_init`` follows
the JAX package's failure policy.  The inputs are the two harmonic
utterances of tests/test_batch_engine.py (partials=10, float64), as there.
"""
import datetime
import json
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from eaqhm_torch.parallel import mesh as mesh_mod

WORLD = 4
FS = 16000
SRER_TOL_DB = 1e-8        # tests/test_batch_engine.py:55-58
WAVE_TOL = 1e-9
_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                        "torch_parity_ref.npz")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, port: int, out_dir: str) -> None:
    """One rank: join the world from torchrun's environment, then run every
    check of the world and write what the parent asserts."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(WORLD), RANK=str(rank))
    torch.set_num_threads(1)
    from eaqhm_torch.parallel import determinism
    from eaqhm_torch.parallel.batch_engine import analyze_batch
    from eaqhm_torch.parallel.corpus import run_corpus_sharded
    from eaqhm_torch.utils.io import write_wav
    import torch.distributed as dist

    applied = determinism.apply()
    assert mesh_mod.multihost_init(
        timeout=datetime.timedelta(seconds=120)) is True
    mesh = mesh_mod.make_mesh(WORLD, model_parallel=2)
    sigs, cfg = _inputs()
    runs = [analyze_batch(sigs, FS, cfg, mesh=mesh, device="cpu")
            for _ in range(2)]
    rec = {"applied": applied, "shape": list(mesh.shape)}
    arrays = {f"run{i}/{f}": np.asarray(getattr(r, f))
              for i, r in enumerate(runs)
              for f in ("srer", "final_srer", "s_recon", "srer_mean",
                        "n_adaptations")}

    wav_dir = os.path.join(out_dir, "wavs")
    if rank == 0:
        os.makedirs(wav_dir)
        for i, s in enumerate(sigs):
            write_wav(os.path.join(wav_dir, f"utt{i}.wav"), FS, s)
    dist.barrier()
    paths = sorted(os.path.join(wav_dir, f) for f in os.listdir(wav_dir))
    ckpt = os.path.join(out_dir, "ckpt")
    r1 = run_corpus_sharded(paths, cfg, mesh=mesh, batch_size=2,
                            checkpoint_dir=ckpt, device="cpu")
    dist.barrier()
    r2 = run_corpus_sharded(paths, cfg, mesh=mesh, batch_size=2,
                            checkpoint_dir=ckpt, device="cpu")
    rec["corpus"] = {"done": r1.done, "failed": r1.failed,
                     "skipped": r1.skipped, "resumed_done": r2.done,
                     "resumed_skipped": r2.skipped}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def _inputs():
    from eaqhm_torch.config import config_from_dict
    with np.load(_FIXTURE) as d:
        return (list(d["batch/signals"]),
                config_from_dict(json.loads(str(d["batch/config"]))))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the world; meanwhile this process computes the unsharded
    result (mesh=None) the world is held to."""
    from eaqhm_torch.parallel.batch_engine import analyze_batch
    out = str(tmp_path_factory.mktemp("gloo_world"))
    ctx = mp.start_processes(_rank_main, args=(_free_port(), out),
                             nprocs=WORLD, join=False, start_method="spawn")
    sigs, cfg = _inputs()
    ref = analyze_batch(sigs, FS, cfg, mesh=None, device="cpu")
    deadline = time.time() + 300
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo world did not finish within 300 s")
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            rec = json.load(f)
        with np.load(os.path.join(out, f"rank{r}.npz")) as d:
            rec.update({k: d[k] for k in d.files})
        ranks.append(rec)
    for f in ("srer", "final_srer", "s_recon", "srer_mean"):
        ranks[0][f"none/{f}"] = np.asarray(getattr(ref, f))
    return ranks, out


def test_mesh_batch_equals_unsharded(world):
    ranks, _ = world
    r0 = ranks[0]
    assert r0["shape"] == [2, 2]
    assert int(r0["run0/n_adaptations"]) == r0["none/srer"].shape[1]
    np.testing.assert_allclose(r0["run0/srer"], r0["none/srer"], rtol=0,
                               atol=SRER_TOL_DB)
    np.testing.assert_allclose(r0["run0/s_recon"], r0["none/s_recon"],
                               rtol=0, atol=WAVE_TOL)
    assert (r0["run0/final_srer"] > 15.0).all(), r0["run0/final_srer"]
    # the all-reduced corpus statistic is the mean of the kept SRERs
    assert abs(float(r0["run0/srer_mean"])
               - float(np.mean(r0["run0/final_srer"]))) < 1e-9
    # every rank returns the whole result
    for r in ranks[1:]:
        for f in ("srer", "s_recon", "srer_mean"):
            assert np.array_equal(r[f"run0/{f}"], r0[f"run0/{f}"]), f


def test_mesh_determinism_bitwise(world):
    ranks, _ = world
    for r in ranks:
        assert r["applied"]["deterministic_algorithms"] is True
        assert r["applied"]["cublas_workspace_config"] == ":4096:8"
        for f in ("srer", "s_recon", "srer_mean"):
            assert np.array_equal(r[f"run0/{f}"], r[f"run1/{f}"]), f


def test_run_corpus_sharded_resumes(world):
    ranks, out = world
    for r in ranks:
        c = r["corpus"]
        assert sorted(c["done"]) == ["utt0", "utt1"] and not c["failed"]
        assert not c["skipped"]
        for uid, summ in c["done"].items():
            assert summ["final_srer_db"] > 14.0, (uid, summ)
        # resume: the second run skips everything, on every rank
        assert sorted(c["resumed_skipped"]) == ["utt0", "utt1"]
        assert not c["resumed_done"]
    # the checkpoint holds every utterance, done
    with open(os.path.join(out, "ckpt", "manifest.json")) as f:
        manifest = json.load(f)
    assert sorted(manifest) == ["utt0", "utt1"]
    assert all(v["status"] == "done" for v in manifest.values())


_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def test_multihost_init_benign_single_process(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    assert mesh_mod.multihost_init() is False
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh()


def test_multihost_init_configured_failure_raises(monkeypatch):
    """A configured group whose root is unreachable raises within the
    rendezvous timeout instead of going on as one process."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    t0 = time.time()
    with pytest.raises(RuntimeError, match="multi-host init failed"):
        mesh_mod.multihost_init(timeout=datetime.timedelta(seconds=1))
    assert time.time() - t0 < 30
    assert not torch.distributed.is_initialized()
