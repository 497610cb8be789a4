"""Checkpoint / resume for long corpus runs.

The reference keeps no state between runs; its only recoverable state is
the in-memory per-adaptation snapshot (`s_recon`, `a0/am/fm/pm_fin`,
reference functions.py:397-402) and the final wav.  For a corpus the unit
of resume is the utterance: each finished utterance's result (SRER
trajectory and reconstructed waveform) is persisted, and a restarted run
skips completed work.  A mid-utterance snapshot of the adaptation state is
supported too (`save_adaptation_state`); `analyze` does not call it.

Storage is plain ``.npz`` plus a JSON manifest, written atomically (temp
file + rename), in the same format as the JAX package's checkpoints, so a
state written by either package loads in the other.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


def _atomic_write(path: str, write_fn):
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@dataclass
class CorpusCheckpoint:
    """Utterance-granularity resume for corpus runs.

    Layout under `root/`:
      manifest.json          {utt_id: {"status": "done"|"failed", ...}}
      utt/<utt_id>.npz       result arrays of finished utterances
    """
    root: str

    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.root, "manifest.json")

    def manifest(self) -> Dict[str, dict]:
        if not os.path.exists(self._manifest_path):
            return {}
        with open(self._manifest_path) as f:
            return json.load(f)

    def _save_manifest(self, m: Dict[str, dict]):
        _atomic_write(self._manifest_path,
                      lambda f: f.write(json.dumps(m, indent=1).encode()))

    def completed(self) -> List[str]:
        return [k for k, v in self.manifest().items()
                if v.get("status") == "done"]

    def is_done(self, utt_id: str) -> bool:
        return self.manifest().get(utt_id, {}).get("status") == "done"

    def save_result(self, utt_id: str, srer: List[float],
                    s_recon: np.ndarray, extra: Optional[dict] = None):
        path = os.path.join(self.root, "utt", f"{utt_id}.npz")
        arrays = {"srer": np.asarray(srer, np.float64),
                  "s_recon": np.asarray(s_recon)}
        if extra:
            arrays.update({k: np.asarray(v) for k, v in extra.items()})
        _atomic_write(path, lambda f: np.savez_compressed(f, **arrays))
        m = self.manifest()
        m[utt_id] = {"status": "done",
                     "final_srer_db": float(np.max(srer)) if len(srer)
                     else None}
        self._save_manifest(m)

    def mark_failed(self, utt_id: str, error: str):
        m = self.manifest()
        m[utt_id] = {"status": "failed", "error": error[:2000]}
        self._save_manifest(m)

    def load_result(self, utt_id: str) -> dict:
        path = os.path.join(self.root, "utt", f"{utt_id}.npz")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def save_adaptation_state(path: str, adaptation: int, srer: List[float],
                          state: Dict[str, np.ndarray]):
    """Mid-utterance snapshot of the per-adaptation best.

    `state` mirrors the reference's kept snapshot (functions.py:397-402):
    s_recon [L], a0 [L], am/fm/ph [L, K], plus fm_current/am_current to
    continue the loop.  Tensors are copied to the host.
    """
    arrays = {k: _host(v) for k, v in state.items()}
    arrays["__adaptation"] = np.asarray(adaptation)
    arrays["__srer"] = np.asarray(srer, np.float64)
    _atomic_write(path, lambda f: np.savez_compressed(f, **arrays))


def load_adaptation_state(path: str):
    """Returns (adaptation, srer_list, state_dict of numpy arrays)."""
    with np.load(path) as z:
        a = int(z["__adaptation"])
        srer = [float(x) for x in z["__srer"]]
        state = {k: z[k] for k in z.files if not k.startswith("__")}
    return a, srer, state


def _host(v) -> np.ndarray:
    if hasattr(v, "detach"):                       # a torch tensor
        return v.detach().cpu().numpy()
    return np.asarray(v)
