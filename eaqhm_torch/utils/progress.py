"""Progress bars: the reference's `loadingScreen` analogue.

The reference shows tqdm bars over its per-frame analysis and per-harmonic
interpolation loops (reference functions.py:173-181,343-381).  Both loops
are batched device work here, so the units of visible progress are
adaptations (engine) and utterances (corpus driver).  tqdm is used when it
can be imported; otherwise a plain-print fallback keeps the same interface.
"""
from __future__ import annotations


class _PrintBar:
    """Minimal tqdm-compatible fallback (no dependency required)."""

    def __init__(self, total=None, desc=""):
        self.total = total
        self.desc = desc
        self.n = 0
        self._postfix = ""

    def update(self, n=1):
        # one line per step, "desc: n/total (postfix)": the stored postfix
        # keeps tqdm's two-call protocol from printing twice
        self.n += n
        tot = f"/{self.total}" if self.total else ""
        post = f" ({self._postfix})" if self._postfix else ""
        print(f"{self.desc}: {self.n}{tot}{post}", flush=True)

    def set_postfix_str(self, s):
        self._postfix = s

    def close(self):
        pass


def progress_bar(total=None, desc="", enabled=True):
    """A tqdm bar when available (and enabled), else a print fallback;
    None when disabled."""
    if not enabled:
        return None
    try:
        from tqdm import tqdm
    except ImportError:
        return _PrintBar(total=total, desc=desc)
    return tqdm(total=total, desc=desc, leave=False)
