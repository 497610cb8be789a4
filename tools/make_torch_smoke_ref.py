"""Write tests/golden/torch_smoke_ref.npz: float64 results of the JAX
package for chip_smoke.py to hold the PyTorch port against on a machine
without JAX.

Groups:
- analyze: eaqhm_tpu.analyze on `s_recon` of tests/golden/sa19_golden.npz
  (63,488 samples at 16 kHz, the reference's SA19 resynthesis) with the
  female preset: the SRER trajectory, the kept reconstruction, det_ak at
  the kept adaptation and the config (keys at the top level, ~45 s);
- batch: eaqhm_tpu.parallel.batch_engine.analyze_batch (mesh=None) on
  utterances 0-7 of the JAX benchmark corpus built on the resynthesis
  (eaqhm_torch.parallel.corpus.corpus_signals, checked here against
  eaqhm_tpu.benchmarks._corpus_signals), female preset,
  max_adaptations=6: keys batch/* (~12 min on one CPU core).

    JAX_PLATFORMS=cpu python tools/make_torch_smoke_ref.py [--groups ...]

With --groups, only those groups are recomputed; the file's other entries
are kept as they are.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from eaqhm_tpu import benchmarks  # noqa: E402
from eaqhm_tpu.config import EaqhmConfig  # noqa: E402
from eaqhm_tpu.models import engine  # noqa: E402
from eaqhm_tpu.parallel.batch_engine import analyze_batch  # noqa: E402
from eaqhm_torch.parallel.corpus import corpus_signals  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "tests", "golden")
OUT = os.path.join(GOLDEN, "torch_smoke_ref.npz")
FS = 16000
GROUPS = ("analyze", "batch")
BATCH_N = 8


def analyze_group(s, out):
    cfg = EaqhmConfig(gender="female", dtype="float64")
    t0 = time.time()
    res = engine.analyze(s, FS, cfg)
    print(f"analyze: {time.time() - t0:.1f} s, srer {res.srer}")
    out.update(fs=FS, srer=np.asarray(res.srer), s_recon=res.s_recon,
               det_ak=res.det_ak, config=json.dumps(dataclasses.asdict(cfg)))


def batch_group(s, out):
    sigs = corpus_signals(s, BATCH_N, FS)
    benchmarks._sa19 = lambda: (FS, s)
    ref_sigs, _ = benchmarks._corpus_signals(BATCH_N)
    assert all(np.array_equal(a, b) for a, b in zip(sigs, ref_sigs))
    cfg = EaqhmConfig(gender="female", max_adaptations=6, dtype="float64")
    t0 = time.time()
    res = analyze_batch(sigs, FS, cfg, mesh=None)
    print(f"analyze_batch: {time.time() - t0:.1f} s, n_adaptations "
          f"{res.n_adaptations}, final srer {res.final_srer}")
    out.update({"batch/srer": res.srer, "batch/final_srer": res.final_srer,
                "batch/s_recon": res.s_recon,
                "batch/n_adaptations": res.n_adaptations,
                "batch/srer_mean": res.srer_mean,
                "batch/config": json.dumps(dataclasses.asdict(cfg))})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", nargs="+", choices=GROUPS,
                    default=list(GROUPS))
    args = ap.parse_args()
    out = {}
    if set(args.groups) != set(GROUPS) and os.path.exists(OUT):
        with np.load(OUT) as old:
            out = {k: old[k] for k in old.files
                   if ("batch" if k.startswith("batch/") else "analyze")
                   not in args.groups}
    s = np.load(os.path.join(GOLDEN, "sa19_golden.npz"))["s_recon"]
    for g in args.groups:
        {"analyze": analyze_group, "batch": batch_group}[g](s, out)
    np.savez_compressed(OUT, **out)
    print("wrote", OUT, os.path.getsize(OUT) // 1024, "KB")


if __name__ == "__main__":
    main()
