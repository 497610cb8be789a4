"""Corpus driver: many utterances, failure isolation, checkpoint/resume.

The reference processes one file per run (reference main.py:62).
`run_corpus` analyzes utterances one after another on one device with the
full convergence loop: a bad file marks its utterance failed and the run
goes on, and finished utterances are persisted through `CorpusCheckpoint`
so a restarted run resumes where it stopped.  The sharded throughput path
of the JAX package (`run_corpus_sharded`) is not ported yet.
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
