"""The corpus paths across cards: run_streams with one worker per card, and
the (data=2, model=2) mesh over four processes (one per card, NCCL), each
held to its one-card counterpart.

1. run_streams(devices=every card) on the corpus of chip_smoke.py
   (parallel.corpus.corpus_signals on the golden SA19 resynthesis, female,
   max_adaptations=6, float64) against the sequential engine on card 0:
   same adaptation counts, final SRER within 1e-9 dB; audio-s/s of both.
2. Four processes join one NCCL group from torchrun's environment
   (multihost_init), make_mesh(4) -> (2, 2); analyze_batch over the mesh on
   utterances 0..B-1 against mesh=None on each rank's card: SRER within
   1e-8 dB, waveform within 1e-9; then run_corpus_sharded with a
   checkpoint (all done, none failed; a second run skips them all).

Prints one JSON line per part; fails on any mismatch.

    python3 tools/multichip_check.py [--out multichip.json]

``--device cpu`` rehearses it on the CPU (gloo, worker processes instead
of cards; use a small --n and --batch there).
"""
import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FS = 16000
WORLD = 4


def _inputs(n):
    from eaqhm_torch import EaqhmConfig
    from eaqhm_torch.parallel.corpus import corpus_signals
    sig = np.load(os.path.join(ROOT, "tests", "golden",
                               "sa19_golden.npz"))["s_recon"]
    return (corpus_signals(sig, n, FS),
            EaqhmConfig(gender="female", max_adaptations=6,
                        dtype="float64"))


def streams_part(device, n):
    import eaqhm_torch
    from eaqhm_torch.parallel.streams import run_streams
    import torch
    sigs, cfg = _inputs(n)
    dev0 = "cpu" if device == "cpu" else "cuda:0"
    devs = ["cpu"] * 2 if device == "cpu" else [
        f"cuda:{i}" for i in range(torch.cuda.device_count())]
    for s in sigs:                                        # warm card 0
        eaqhm_torch.analyze(s, FS, cfg, device=dev0)
    t0 = time.time()
    seq = [eaqhm_torch.analyze(s, FS, cfg, device=dev0) for s in sigs]
    seq_s = time.time() - t0
    run_streams(sigs, FS, cfg, devices=devs)              # warm every card
    out = run_streams(sigs, FS, cfg, devices=devs)
    assert not out.failed, out.failed
    worst = 0.0
    for i, r in enumerate(seq):
        assert out.done[i]["n_adaptations"] == len(r.srer), i
        worst = max(worst, abs(out.done[i]["final_srer_db"] - max(r.srer)))
    assert worst <= 1e-9, worst
    audio = sum(len(s) for s in sigs) / FS
    return {"part": "streams", "devices": devs, "max_dfinal_srer_db": worst,
            "sequential_audio_s_per_s": audio / seq_s,
            "streams_audio_s_per_s": out.audio_seconds_per_second,
            "per_worker": out.per_device}


def _rank(rank, port, device, n, batch, out_dir):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(WORLD), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    import torch
    if device == "cpu":
        torch.set_num_threads(1)
    import torch.distributed as dist
    from eaqhm_torch.parallel import mesh as mesh_mod
    from eaqhm_torch.parallel.batch_engine import analyze_batch
    from eaqhm_torch.parallel.corpus import run_corpus_sharded
    from eaqhm_torch.utils.io import write_wav
    assert mesh_mod.multihost_init(
        timeout=datetime.timedelta(seconds=300)) is True
    mesh = mesh_mod.make_mesh(WORLD, model_parallel=2)
    sigs, cfg = _inputs(n)
    dev = "cpu" if device == "cpu" else f"cuda:{rank}"
    ref = analyze_batch(sigs[:batch], FS, cfg, device=dev)
    analyze_batch(sigs[:batch], FS, cfg, mesh=mesh, device=dev)   # warm
    dist.barrier()
    t0 = time.time()
    got = analyze_batch(sigs[:batch], FS, cfg, mesh=mesh, device=dev)
    mesh_s = time.time() - t0
    rec = {"rank": rank, "mesh_shape": list(mesh.shape),
           "backend": dist.get_backend(), "mesh_s": mesh_s,
           "n_adaptations": [got.n_adaptations, ref.n_adaptations],
           "max_dsrer_db": float(np.max(np.abs(got.srer - ref.srer))),
           "max_dwave": float(np.max(np.abs(got.s_recon - ref.s_recon))),
           "srer_mean": got.srer_mean,
           "mean_final_srer": float(np.mean(got.final_srer))}
    wav_dir = os.path.join(out_dir, "wavs")
    if rank == 0:
        os.makedirs(wav_dir)
        for i, s in enumerate(sigs):
            write_wav(os.path.join(wav_dir, f"utt{i:03d}.wav"), FS, s)
    dist.barrier()
    paths = sorted(os.path.join(wav_dir, f) for f in os.listdir(wav_dir))
    ckpt = os.path.join(out_dir, "ckpt")
    t0 = time.time()
    r1 = run_corpus_sharded(paths, cfg, mesh=mesh, batch_size=batch,
                            checkpoint_dir=ckpt, device=dev)
    rec["corpus_s"] = time.time() - t0
    dist.barrier()
    r2 = run_corpus_sharded(paths, cfg, mesh=mesh, batch_size=batch,
                            checkpoint_dir=ckpt, device=dev)
    rec.update(corpus_done=len(r1.done), corpus_failed=sorted(r1.failed),
               corpus_audio_s_per_s=r1.audio_seconds_per_second,
               resumed_skipped=len(r2.skipped), resumed_done=len(r2.done))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def mesh_part(device, n, batch):
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(port, device, n, batch, d),
                           nprocs=WORLD, join=True, start_method="spawn")
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for r in ranks:
        assert r["n_adaptations"][0] == r["n_adaptations"][1], r
        assert r["max_dsrer_db"] <= 1e-8 and r["max_dwave"] <= 1e-9, r
        assert abs(r["srer_mean"] - r["mean_final_srer"]) <= 1e-9, r
        assert r["corpus_done"] == n and not r["corpus_failed"], r
        assert r["resumed_skipped"] == n and r["resumed_done"] == 0, r
    return {"part": "mesh", "ranks": ranks}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if args.device == "cuda":
        if torch.cuda.device_count() < WORLD:
            raise SystemExit(f"multichip_check: needs {WORLD} CUDA devices")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        print(json.dumps({"cards": smi}), flush=True)
    lines = [streams_part(args.device, args.n),
             mesh_part(args.device, args.n, args.batch)]
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main()
