"""Non-interactive CLI (replaces the reference's Tk dialog, main.py:44-75).

Usage:
    python -m eaqhm_torch.cli INPUT.wav [--gender female] [--out OUT.wav] ...

Prints the per-adaptation SRER trajectory and writes the reconstructed
waveform as float32 (reference main.py:72).  Runs on CUDA unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from eaqhm_torch.config import EaqhmConfig
from eaqhm_torch.models import engine
from eaqhm_torch.utils import io as io_mod


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eaqhm_torch",
        description="eaQHM speech analysis and synthesis on a CUDA GPU")
    p.add_argument("input", help="mono wav file to analyze")
    p.add_argument("--gender", default="other",
                   help="male|female|child|other or 'min,max' pitch limits")
    p.add_argument("--out", default=None,
                   help="output wav (default <input>_reconstructed.wav)")
    p.add_argument("--step", type=int, default=15)
    p.add_argument("--max-adaptations", type=int, default=10)
    p.add_argument("--pitch-periods", type=int, default=3)
    p.add_argument("--analysis-window", type=int, default=32)
    p.add_argument("--no-full-waveform", action="store_true",
                   help="analyze voiced runs only (reference fullWaveform=False)")
    p.add_argument("--fc", type=float, default=0.0,
                   help="optional pre-analysis high-pass cutoff [Hz]")
    p.add_argument("--partials", type=int, default=0)
    p.add_argument("--dtype", default="auto",
                   choices=["auto", "float32", "float64"])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the kernels' plain versions)")
    p.add_argument("--json", action="store_true",
                   help="print a JSON result summary")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--progress", action="store_true",
                   help="live progress bar over adaptations / corpus files "
                        "(reference loadingScreen, functions.py:173-181)")
    p.add_argument("--plots", default=None, metavar="DIR",
                   help="write before/after spectrogram + time-domain PNGs "
                        "(reference plotGraphs, main.py:18-42)")
    p.add_argument("--corpus", action="store_true",
                   help="treat INPUT as a directory of wavs: per-utterance "
                        "error isolation + checkpoint/resume")
    p.add_argument("--checkpoint-dir", default=None,
                   help="corpus mode: resume state directory")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    gender = args.gender
    if "," in str(gender):
        lo, hi = gender.split(",")
        gender = (float(lo), float(hi))
    cfg = EaqhmConfig(
        gender=gender, step=args.step, max_adaptations=args.max_adaptations,
        pitch_periods=args.pitch_periods, analysis_window=args.analysis_window,
        full_waveform=not args.no_full_waveform, fc=args.fc,
        partials=args.partials, dtype=args.dtype,
        loading_screen=args.progress)

    if args.corpus:
        import glob
        from eaqhm_torch.parallel.corpus import run_corpus
        paths = sorted(glob.glob(os.path.join(args.input, "*.wav"))
                       + glob.glob(os.path.join(args.input, "*.WAV")))
        cres = run_corpus(paths, cfg, checkpoint_dir=args.checkpoint_dir,
                          write_wavs=args.out, verbose=not args.quiet,
                          device=args.device)
        print(json.dumps({
            "n_done": len(cres.done), "n_failed": len(cres.failed),
            "n_skipped": len(cres.skipped), "elapsed_s": cres.elapsed,
            "audio_seconds_per_second": cres.audio_seconds_per_second,
            "failed": sorted(cres.failed),
        }))
        return 1 if cres.failed and not cres.done else 0

    fs, s = io_mod.read_wav(args.input)
    res = engine.analyze(s, fs, cfg, device=args.device,
                         verbose=not args.quiet)

    out = args.out or (args.input.rsplit(".", 1)[0] + "_reconstructed.wav")
    io_mod.write_wav(out, fs, res.s_recon)
    if args.plots:
        from eaqhm_torch.utils.plots import plot_graphs
        os.makedirs(args.plots, exist_ok=True)
        plot_graphs(s, res.s_recon, fs, out_dir=args.plots)

    if args.json:
        print(json.dumps({
            "input": args.input, "output": out,
            "srer_db": [float(x) for x in res.srer],
            "final_srer_db": float(np.max(res.srer)),
            "elapsed_s": res.elapsed,
            "audio_seconds": len(s) / fs,
            "audio_seconds_per_second": (len(s) / fs) / res.elapsed,
        }))
    elif not args.quiet:
        print(f"Signal adapted to {round(float(np.max(res.srer)), 6)} dB SRER")
        print(f"Total Time: {res.elapsed:.2f}s -> wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
