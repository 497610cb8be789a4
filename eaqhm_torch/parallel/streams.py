"""Utterance streams: several workers, each running the per-utterance engine
on a CUDA stream of its own (eaqhm_tpu/parallel/streams.py).

Each worker thread pulls utterances from one shared queue and runs
``engine.analyze`` on them with its device current and its own stream
(``torch.cuda.stream``), so per-worker work is exactly the sequential
engine's: nothing padded, nobody waiting for a batch's last convergence.
Workers overlap on the card while one of them waits for its SRER on the
host, or its host work (VAD, geometry) runs: the GIL is released in both.

JAX takes a list of devices, one worker each; so does this module, and a
list that names one card k times gives k workers on that card, each on its
own stream: that is how one H100 runs utterances concurrently.  Corpus
statistics are reduced on the host; across processes they go through
``parallel.corpus.run_corpus_sharded``.

Each utterance keeps the reference semantics (functions.py:394-402): the
full keep-previous-on-decline loop, independently, like N sequential runs
side by side; its float64 result is the sequential run's.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from eaqhm_torch.config import EaqhmConfig


@dataclass
class StreamResult:
    """Corpus-level outcome of a multi-stream run."""
    done: Dict[int, dict] = field(default_factory=dict)   # index -> summary
    failed: Dict[int, str] = field(default_factory=dict)  # index -> error
    # worker key -> {"utterances", "busy_seconds"}; keys are "<device>#<n>",
    # the n-th worker of that device (JAX keys by device: there a device has
    # one worker)
    per_device: Dict[str, dict] = field(default_factory=dict)
    elapsed: float = 0.0
    audio_seconds: float = 0.0

    @property
    def audio_seconds_per_second(self) -> float:
        return self.audio_seconds / self.elapsed if self.elapsed else 0.0

    @property
    def srer_mean(self) -> float:
        vals = [v["final_srer_db"] for v in self.done.values()]
        return float(np.mean(vals)) if vals else float("nan")


def _devices(devices) -> List[torch.device]:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "run_streams runs on CUDA by default and no CUDA device is "
                "available; pass devices=['cpu'] to run on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        out.append(d)
    return out


def run_streams(signals: Sequence, fs: int,
                config: EaqhmConfig = EaqhmConfig(),
                devices: Optional[List] = None,
                verbose: bool = False) -> StreamResult:
    """Analyze utterances over workers, one per entry of ``devices``.

    signals: numpy arrays.  devices: None (every visible CUDA device, one
    worker each; raises without CUDA) or a list of devices ("cuda:0",
    torch.device, "cpu"); a device named k times gets k workers, each on
    a CUDA stream of its own.  Utterances are pulled from one shared queue,
    so faster workers take more (dynamic load balance).  Failures are
    isolated per utterance.  ``per_device`` keys each worker separately
    ("cuda:0#0", "cuda:0#1", ...) so that workers sharing a card keep
    their own statistics.
    """
    from eaqhm_torch.models import engine

    devs = _devices(devices)
    work: "queue.Queue" = queue.Queue()
    for i, s in enumerate(signals):
        work.put((i, np.asarray(s, np.float64)))

    res = StreamResult()
    lock = threading.Lock()
    seen: Dict[str, int] = {}
    keys = []
    for d in devs:
        keys.append(f"{d}#{seen.get(str(d), 0)}")
        seen[str(d)] = seen.get(str(d), 0) + 1
    t0 = time.time()

    def worker(dev: torch.device, key: str):
        n_utt = 0
        t_dev = 0.0
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        while True:
            try:
                i, s = work.get_nowait()
            except queue.Empty:
                break
            t_u = time.time()
            try:
                if stream is None:
                    out = engine.analyze(s, fs, config, device=dev)
                else:
                    with torch.cuda.device(dev), torch.cuda.stream(stream):
                        out = engine.analyze(s, fs, config, device=dev)
                summary = {
                    "final_srer_db": float(np.max(out.srer)),
                    "n_adaptations": len(out.srer),
                    "seconds": time.time() - t_u,
                    "device": key,
                }
                with lock:
                    res.done[i] = summary
                    res.audio_seconds += len(s) / fs
            except Exception as e:  # noqa: BLE001 (isolate per utterance)
                with lock:
                    res.failed[i] = f"{type(e).__name__}: {e}"
            n_utt += 1
            t_dev += time.time() - t_u
        with lock:
            res.per_device[key] = {"utterances": n_utt,
                                   "busy_seconds": round(t_dev, 3)}

    threads = [threading.Thread(target=worker, args=(d, k), daemon=True)
               for d, k in zip(devs, keys)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    res.elapsed = time.time() - t0
    if verbose:
        print(f"[streams] {len(res.done)} done / {len(res.failed)} failed "
              f"on {len(devs)} workers in {res.elapsed:.2f}s "
              f"({res.audio_seconds_per_second:.2f} audio-s/s)")
    return res
