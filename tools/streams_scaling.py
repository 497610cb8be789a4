"""How the per-utterance engine scales with concurrent workers on one card.

Runs the 16-utterance corpus of chip_smoke.py (eaqhm_torch.parallel.corpus.
corpus_signals on the golden SA19 resynthesis, female, max_adaptations=6,
float64) sequentially, then through parallel.streams.run_streams with k
threads (each on its own CUDA stream), then through k processes that share
the card (each runs its share of the corpus sequentially); and, to separate
the engine from PyTorch's dispatch, a loop of small elementwise ops on k
threads.  Prints one JSON line (and writes it to --out).

    python3 tools/streams_scaling.py --out streams_scaling.json
"""
import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FS = 16000


def _corpus(n):
    from eaqhm_torch.parallel.corpus import corpus_signals
    sig = np.load(os.path.join(ROOT, "tests", "golden",
                               "sa19_golden.npz"))["s_recon"]
    return corpus_signals(sig, n, FS)


def _config():
    import eaqhm_torch
    return eaqhm_torch.EaqhmConfig(gender="female", max_adaptations=6,
                                   dtype="float64")


def _process_worker(idx, n, ready, start, out):
    """One process: warm up on its first utterance, report ready, wait for
    the start signal, run its share sequentially; report (seconds, audio
    s)."""
    import torch
    import eaqhm_torch
    sigs = [_corpus(n)[i] for i in idx]
    cfg = _config()
    eaqhm_torch.analyze(sigs[0], FS, cfg, device="cuda")
    torch.cuda.synchronize()
    ready.put(os.getpid())
    start.wait()
    t0 = time.time()
    for s in sigs:
        eaqhm_torch.analyze(s, FS, cfg, device="cuda")
    out.put((time.time() - t0, sum(len(s) for s in sigs) / FS))


def _processes(k, n):
    ctx = mp.get_context("spawn")
    ready, start, out = ctx.Queue(), ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=_process_worker,
                         args=(list(range(i, n, k)), n, ready, start, out))
             for i in range(k)]
    for p in procs:
        p.start()
    for _ in procs:
        ready.get(timeout=300)
    t0 = time.time()
    start.set()
    res = [out.get(timeout=600) for _ in procs]
    wall = time.time() - t0
    for p in procs:
        p.join(timeout=60)
    audio = sum(a for _, a in res)
    return {"wall_s": wall, "audio_s_per_s": audio / wall,
            "per_process_s": [s for s, _ in res]}


def _dispatch_rate(torch, k, ops=4000):
    """Small elementwise ops per second over k threads, each on its own
    stream (the engine's launches are mostly of this kind)."""
    xs = [torch.ones(4096, device="cuda") for _ in range(k)]

    def run(i):
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            x = xs[i]
            for _ in range(ops):
                x = x * 1.0000001 + 1e-9
        s.synchronize()

    run(0)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(k)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return 2 * ops * k / (time.time() - t0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("streams_scaling: needs a CUDA device")
    import eaqhm_torch
    from eaqhm_torch.parallel.streams import run_streams
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    sigs = _corpus(args.n)
    cfg = _config()
    audio = sum(len(s) for s in sigs) / FS
    for s in sigs:
        eaqhm_torch.analyze(s, FS, cfg, device="cuda")
    t0 = time.time()
    for s in sigs:
        eaqhm_torch.analyze(s, FS, cfg, device="cuda")
    rep = {"card": smi, "torch": torch.__version__, "n": args.n,
           "audio_s": audio, "sequential": audio / (time.time() - t0)}

    def note(key, val):
        rep[key] = val
        print(key, json.dumps(val), flush=True)

    for k in args.workers:
        note(f"dispatch_ops_per_s_threads_{k}", _dispatch_rate(torch, k))
    for k in args.workers:
        run_streams(sigs, FS, cfg, devices=["cuda:0"] * k)     # warm
        r = run_streams(sigs, FS, cfg, devices=["cuda:0"] * k)
        note(f"threads_{k}", {"audio_s_per_s": r.audio_seconds_per_second,
                              "per_worker": r.per_device})
    for k in args.workers[1:]:
        note(f"processes_{k}", _processes(k, args.n))
    line = json.dumps(rep)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
