"""Corpus driver: many utterances, failure isolation, checkpoint/resume.

The reference processes one file per run (reference main.py:62).  Two modes
(eaqhm_tpu/parallel/corpus.py):

- `run_corpus` analyzes utterances one after another on one device with the
  full convergence loop: a bad file marks its utterance failed and the run
  goes on, and finished utterances are persisted through `CorpusCheckpoint`
  so a restarted run resumes where it stopped.
- `run_corpus_sharded` runs batches of padded utterances through
  `parallel.batch_engine.analyze_batch` over a (data, model) mesh of
  processes (`parallel.mesh`): every rank runs it on the same paths and
  forms the same batches, each batch is split over the mesh, and rank 0
  writes the checkpoint.  A degenerate mesh (none, or one rank) delegates
  to `run_corpus`.
"""
from __future__ import annotations

import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from eaqhm_torch.config import EaqhmConfig
from eaqhm_torch.utils import io as io_mod
from eaqhm_torch.utils.checkpoint import CorpusCheckpoint
from eaqhm_torch.utils.progress import progress_bar

_READ_FAILED = -1


@dataclass
class CorpusResult:
    done: Dict[str, dict] = field(default_factory=dict)     # utt_id -> summary
    failed: Dict[str, str] = field(default_factory=dict)    # utt_id -> error
    skipped: List[str] = field(default_factory=list)        # resumed over
    elapsed: float = 0.0
    audio_seconds: float = 0.0

    @property
    def audio_seconds_per_second(self) -> float:
        return self.audio_seconds / self.elapsed if self.elapsed else 0.0


def _utt_id(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def run_corpus(paths: Sequence[str], config: EaqhmConfig = EaqhmConfig(),
               checkpoint_dir: Optional[str] = None,
               write_wavs: Optional[str] = None, verbose: bool = False,
               device=None) -> CorpusResult:
    """Analyze a corpus of wav files with isolation and resume.

    device: as for `analyze` (None means CUDA, raising when absent).
    """
    from eaqhm_torch.models import engine

    ckpt = CorpusCheckpoint(checkpoint_dir) if checkpoint_dir else None
    res = CorpusResult()
    t0 = time.time()
    bar = progress_bar(total=len(paths), desc="corpus",
                       enabled=config.loading_screen)

    def _tick(outcome):
        # the bar shows completed work: update after each outcome
        if bar is not None:
            bar.set_postfix_str(outcome)
            bar.update(1)

    for path in paths:
        uid = _utt_id(path)
        if ckpt is not None and ckpt.is_done(uid):
            res.skipped.append(uid)
            _tick(f"skipped {uid}")
            continue
        try:
            fs, s = io_mod.read_wav(path)
            out = engine.analyze(s, fs, config, device=device,
                                 verbose=verbose)
            res.audio_seconds += len(s) / fs
            summary = {"final_srer_db": float(np.max(out.srer)),
                       "srer_db": [float(x) for x in out.srer],
                       "n_adaptations": len(out.srer)}
            res.done[uid] = summary
            if ckpt is not None:
                ckpt.save_result(uid, out.srer, out.s_recon)
            if write_wavs:
                os.makedirs(write_wavs, exist_ok=True)
                io_mod.write_wav(
                    os.path.join(write_wavs, f"{uid}_reconstructed.wav"),
                    fs, out.s_recon)
            _tick(f"done {uid} ({summary['final_srer_db']:.2f} dB)")
        except Exception as e:  # noqa: BLE001 (isolation is the point)
            err = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            res.failed[uid] = err
            if ckpt is not None:
                ckpt.mark_failed(uid, err)
            if verbose:
                print(f"[corpus] FAILED {uid}: {type(e).__name__}: {e}")
            _tick(f"FAILED {uid}")
    if bar is not None:
        bar.close()
    res.elapsed = time.time() - t0
    return res


def pad_batch(signals: Sequence[np.ndarray], length: Optional[int] = None):
    """Zero-pad a list of 1-D signals to a common length -> ([B, L], [B])."""
    ls = np.array([len(s) for s in signals])
    L = int(length or ls.max())
    out = np.zeros((len(signals), L), np.float64)
    for i, s in enumerate(signals):
        out[i, :min(len(s), L)] = s[:L]
    return out, ls


def _corpus_plan(paths, ckpt):
    """(uid, fs or _READ_FAILED or None for resumed over, signal, error)
    per path, on this rank."""
    plan = []
    for path in paths:
        uid = _utt_id(path)
        if ckpt is not None and ckpt.is_done(uid):
            plan.append((uid, None, None, None))
            continue
        try:
            fs, s = io_mod.read_wav(path)
            plan.append((uid, int(fs), s, None))
        except Exception as e:  # noqa: BLE001 (isolation is the point)
            plan.append((uid, _READ_FAILED, None, f"{type(e).__name__}: {e}"))
    return plan


def run_corpus_sharded(paths: Sequence[str],
                       config: EaqhmConfig = EaqhmConfig(), mesh=None,
                       batch_size: Optional[int] = None,
                       checkpoint_dir: Optional[str] = None,
                       verbose: bool = False, device=None) -> CorpusResult:
    """Throughput corpus path: the full pipeline (pitch, VAD, adaptation
    0, the eaQHM loop), batched over padded utterances and split over the
    (data, model) mesh (``parallel.batch_engine``).

    Every rank of the mesh calls it with the same paths.  Each rank reads
    the corpus and the checkpoint before any batch runs, and the ranks
    check that they agree on it (the resume decision and which files
    read), so all form the same batches: grouped by sample rate (a batch
    runs at one rate), batch_size utterances each (default the data size;
    analyze_batch pads a batch to a multiple of it).  Each utterance is
    analyzed once across the world, and rank 0 alone writes its
    checkpoint.  Failures are isolated per file read and per batch.
    mesh None builds one over the process group when there is one
    (``make_mesh``); no mesh, or a mesh of one rank, runs ``run_corpus``.
    """
    from eaqhm_torch.parallel.batch_engine import analyze_batch

    if mesh is None:
        try:
            from eaqhm_torch.parallel.mesh import make_mesh
            mesh = make_mesh()
        except RuntimeError:          # no process group
            mesh = None
    if mesh is None or mesh.size() == 1:
        # degenerate mesh: the batch's padding buys nothing, and the
        # per-utterance engine is the single-device corpus path
        return run_corpus(paths, config, checkpoint_dir=checkpoint_dir,
                          verbose=verbose, device=device)
    import torch.distributed as dist

    if batch_size is None:
        batch_size = mesh.shape[0]
    ckpt = CorpusCheckpoint(checkpoint_dir) if checkpoint_dir else None
    writer = dist.get_rank() == 0
    res = CorpusResult()
    t0 = time.time()
    plan = _corpus_plan(paths, ckpt)
    views = [None] * dist.get_world_size()
    dist.all_gather_object(views, [p[:2] for p in plan])
    if any(v != views[0] for v in views):
        raise RuntimeError("run_corpus_sharded: the ranks disagree on the "
                           "corpus (checkpoint or file reads differ)")

    def flush(batch):
        try:
            out = analyze_batch([b[2] for b in batch], batch[0][1], config,
                                mesh=mesh, verbose=verbose, device=device)
        except Exception as e:  # noqa: BLE001 (isolation is the point)
            for uid, _, _ in batch:
                res.failed[uid] = f"{type(e).__name__}: {e}"
                if ckpt is not None and writer:
                    ckpt.mark_failed(uid, str(e))
            return
        for i, (uid, fs_i, s_i) in enumerate(batch):
            res.audio_seconds += len(s_i) / fs_i
            res.done[uid] = {
                "final_srer_db": float(out.final_srer[i]),
                "srer_db": [float(x) for x in out.srer[i]],
                "n_adaptations": int(out.n_adaptations),
            }
            if ckpt is not None and writer:
                ckpt.save_result(uid, list(out.srer[i]),
                                 out.s_recon[i, :len(s_i)])

    pending: dict = {}                      # fs -> [(uid, fs, signal)]
    for uid, fs, s, err in plan:
        if fs is None:
            res.skipped.append(uid)
            continue
        if fs == _READ_FAILED:
            res.failed[uid] = err
            if ckpt is not None and writer:
                ckpt.mark_failed(uid, err)
            continue
        pending.setdefault(fs, []).append((uid, fs, s))
        if len(pending[fs]) >= batch_size:
            flush(pending[fs][:batch_size])
            pending[fs] = pending[fs][batch_size:]
    for fsk in sorted(pending):             # flush the tails
        q = pending[fsk]
        while q:
            flush(q[:batch_size])
            q = q[batch_size:]
    res.elapsed = time.time() - t0
    return res


def corpus_signals(recording, n: int, fs: int = 16000,
                   seconds: float = 2.0):
    """The JAX package's corpus inputs (eaqhm_tpu/benchmarks.py:88-116)
    with ``recording`` in place of SA19: n utterances of ``seconds``; even
    i the slice of the recording at (i//2*9000 + 4000) % (len - length),
    odd i a tapered five-harmonic tone in the female pitch band (numpy
    seed 0, drawn in the JAX order)."""
    length = int(seconds * fs)
    rng = np.random.default_rng(0)
    sigs = []
    for i in range(n):
        if i % 2 == 0:
            off = (i // 2 * 9000 + 4000) % (len(recording) - length)
            sigs.append(np.array(recording[off:off + length], np.float64))
        else:
            f0 = rng.uniform(170.0, 280.0)
            t = np.arange(length) / fs
            ph = 2 * np.pi * f0 * t
            s = sum((0.35 / k) * np.cos(k * ph + rng.uniform(0, 2 * np.pi))
                    for k in range(1, 6))
            fade = 1200
            env = np.ones(length)
            env[:fade] = 0.5 - 0.5 * np.cos(np.pi * np.arange(fade) / fade)
            env[-fade:] = env[:fade][::-1]
            sigs.append(s * env)
    return sigs
