"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface under ``build/`` (listed in .gitignore) and loaded
with ``ctypes``.  The library name carries a hash of the source and flags, so
an edited source is rebuilt at first use and an unchanged one is reused.
Nothing is built or loaded when this module is imported; ``load`` builds a
library at its first use, under a lock of its own.  ``load_host`` builds a
header of plain C++ (a kernel's launch plan, which its source includes) with
the host's C++ compiler, so the plans are read where there is no CUDA
toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# library name -> (source file, {symbol: argtypes})
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_D = ctypes.c_double
KERNELS = {
    "chol_solve": ("chol_solve.cu", {
        "chol_path": [_I, _I],
        "chol_tiled_plan": [_I, _I, _P],
        "chol_prepare": [],
        "chol_phase_clocks": [_P],
        "chol_tiled_clocks": [_P],
        "chol_subst_clocks": [_P],
        "chol_factor_solve_c64": [_P] * 6 + [_I, _I, _I, _I, _P],
        "chol_factor_solve_c128": [_P] * 6 + [_I, _I, _I, _I, _P],
        "chol_subst_plan": [_I, _I, _P],
        "chol_subst_route": [_I],
        "chol_subst_c64": [_P, _P, _P, _P, _I, _I, _I, _P],
        "chol_subst_c128": [_P, _P, _P, _P, _I, _I, _I, _P],
    }),
    "block_inverse": ("block_inverse.cu", {
        "bi_prepare": [],
        "bi_path": [_I, _I],
        "bi_subtree_max": [_I],
        "bi_phase_clocks": [_P],
        "bi_solve_resident_c64": [_P] * 6 + [_I, _I, _D, _P],
        "bi_solve_resident_c128": [_P] * 6 + [_I, _I, _D, _P],
        "bi_invert_c64": [_P, _P, _L, _I, _I, _I, _P],
        "bi_invert_c128": [_P, _P, _L, _I, _I, _I, _P],
        "bi_refine_c64": [_P] * 8 + [_I, _I, _D, _P],
        "bi_refine_c128": [_P] * 8 + [_I, _I, _D, _P],
    }),
    "fit": ("fit.cu", {
        "fit_prepare": [],
        "fit_phase_clocks": [_P],
        "fit_occupancy": [_I, _I],
        "fit_gram_plan": [_I, _P],
        "fit_basis_eaqhm_f32": [_P] * 14 + [_I, _I, _I, _L, _L, _L, _D, _D,
                                            _D, _P],
        "fit_basis_eaqhm_f64": [_P] * 14 + [_I, _I, _I, _L, _L, _L, _D, _D,
                                            _D, _P],
        "fit_basis_iqhm_f32": [_P] * 11 + [_I, _I, _I, _L, _D, _P],
        "fit_basis_iqhm_f64": [_P] * 11 + [_I, _I, _I, _L, _D, _P],
        "fit_gram_c64": [_P] * 4 + [_I, _I, _I, _P],
        "fit_gram_c128": [_P] * 4 + [_I, _I, _I, _P],
    }),
    "tracks": ("tracks.cu", {
        "track_spline_f32": [_P] * 5 + [_I] * 5 + [_P],
        "track_spline_f64": [_P] * 5 + [_I] * 5 + [_P],
        "track_synth_f32": [_P] * 11 + [_I, _I, _I, _I, _L, _I, _D, _P],
        "track_synth_f64": [_P] * 11 + [_I, _I, _I, _I, _L, _I, _D, _P],
        "track_srer_f32": [_P] * 7 + [_I, _I, _L, _L, _L, _P],
        "track_srer_f64": [_P] * 7 + [_I, _I, _L, _L, _L, _P],
        "track_prepare": [],
        "track_occupancy": [_I, _I, _I],
        "track_phase_clocks": [_P],
    }),
    "swipe": ("swipe.cu", {
        "swipe_prepare": [],
        "swipe_loudness_f32": [_P, _I, _I, _I] + [_P] * 14 + [_P],
        "swipe_loudness_f64": [_P, _I, _I, _I] + [_P] * 14 + [_P],
        "swipe_pick_f32": [_P] * 7 + [_I] + [_P] * 5 + [_D] + [_P] * 4
                          + [_I, _P] + [_I] * 4 + [_P],
        "swipe_pick_f64": [_P] * 7 + [_I] + [_P] * 5 + [_D] + [_P] * 4
                          + [_I, _P] + [_I] * 4 + [_P],
    }),
    "lfilter": ("lfilter.cu", {
        "lfilter_f64": [_P, _P, _P, _P, _P, _L, _L, _I, _P],
        "lfilter_f32": [_P, _P, _P, _P, _P, _L, _L, _I, _P],
    }),
}

# host library name -> (header under csrc/, {symbol: argtypes}): built by
# the host's C++ compiler
HOST = {
    "chol_plan": ("chol_plan.h", {
        "chol_tiled_plan": [_I, _I, _P],
        "chol_subst_plan": [_I, _I, _P],
        "chol_subst_route": [_I],
    }),
    "tracks_plan": ("tracks_plan.h", {
        "track_spline_plan": [_I, _I, _I, _P],
        "track_synth_plan": [_I, _I, _I, _I, _L, _I, _P],
        "track_srer_plan": [_L, _P],
    }),
}
CXX_FLAGS = ["-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC"]

# nvcc flags of one library beside NVCC_FLAGS: the tracks stage rounds every
# product and sum on its own, as the torch ops it replaces
EXTRA_FLAGS = {"tracks": ("-fmad=false",)}

_loaded = {}
_locks = {}                    # (name, defines) -> lock of its build
_locks_guard = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _cxx() -> str:
    for name in ("c++", "g++", "clang++"):
        path = shutil.which(name)
        if path is not None:
            return path
    raise RuntimeError("no C++ compiler found for the kernels' launch plans")


def _source_bytes(src: str) -> bytes:
    """A source and the csrc/ headers it includes ("..."), for the hash."""
    with open(os.path.join(CSRC, src), "rb") as f:
        text = f.read()
    for inc in re.findall(rb'#include "([^"]+)"', text):
        with open(os.path.join(CSRC, inc.decode()), "rb") as f:
            text += f.read()
    return text


def _lib_path(name: str, flags: tuple) -> str:
    src = (KERNELS.get(name) or HOST[name])[0]
    digest = hashlib.sha256(_source_bytes(src) + " ".join(flags).encode())
    return os.path.join(BUILD, f"lib{name}_{digest.hexdigest()[:12]}.so")


def _build(name: str, flags: tuple, host: bool = False) -> str:
    """Run nvcc (host: the C++ compiler) for one library unless it is
    built; returns its path."""
    out = _lib_path(name, flags)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    if host:
        cmd = [_cxx(), *flags, "-o", tmp, os.path.join(CSRC, HOST[name][0])]
    else:
        cmd = [_nvcc(), *flags, "-Xptxas", "-v", "-o", tmp,
               os.path.join(CSRC, KERNELS[name][0])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed for {name}:\n{proc.stderr}")
    os.replace(tmp, out)       # atomic: a concurrent build sees all or none
    if not host:
        with open(out + ".ptxas.txt", "w") as f:
            f.write(proc.stderr)
    return out


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library for one kernel, built first if needed.  defines
    (e.g. ("CHOL_PHASE_CLOCKS",)) build a separate variant for a tool; the
    port itself loads the plain build.  Safe from several threads: each
    library has a lock, so one thread builds it while the others wait, and
    two libraries build at once from two threads."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    with _locks_guard:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        if key not in _loaded:
            flags = (tuple(NVCC_FLAGS) + EXTRA_FLAGS.get(name, ())
                     + tuple(f"-D{d}" for d in defines))
            _bind(key, _build(name, flags))
    return _loaded[key]


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library of HOST (a launch plan), built first if
    needed; as ``load``, safe from several threads."""
    key = (name, "host")
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    with _locks_guard:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        if key not in _loaded:
            _bind(key, _build(name, tuple(CXX_FLAGS), host=True),
                  HOST[name][1])
    return _loaded[key]


def read_ptxas(path: str) -> dict:
    """Per kernel of a ptxas -v report: registers, spill bytes and static
    shared memory."""
    out, kernel = {}, None
    with open(path) as f:
        for line in f:
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line)
            if m:
                kernel = m.group(1)
                continue
            if kernel is None:
                continue
            row = out.setdefault(kernel, {})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                row["spill_stores"], row["spill_loads"] = map(int,
                                                              m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                row["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                row["static_smem"] = int(m.group(1))
    return {k: v for k, v in out.items() if "registers" in v}


def ptxas_report(name: str, defines: tuple = ()) -> dict:
    """read_ptxas of a built library (the ``*.ptxas.txt`` beside it)."""
    flags = (tuple(NVCC_FLAGS) + EXTRA_FLAGS.get(name, ())
             + tuple(f"-D{d}" for d in defines))
    return read_ptxas(_lib_path(name, flags) + ".ptxas.txt")


def _bind(key, path: str, syms=None) -> None:
    lib = ctypes.CDLL(path)
    for sym, argtypes in (syms or KERNELS[key[0]][1]).items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _loaded[key] = lib
