"""Batched HPD Cholesky solve: the hand-written CUDA kernel and its plain
PyTorch versions.

The kernel (``kernels/csrc/chol_solve.cu``) replaces the Pallas TPU kernel
``eaqhm_tpu/ops/pallas_chol.py:_chol_solve_kernel``: factor R = L L^H for a
batch of equilibrated complex HPD matrices and solve L L^H x = b for one
right-hand side each.  Two entry points: ``chol_solve`` (factor + solve, and
on request the factor kept for later right-hand sides) and ``chol_subst``
(both substitutions with a kept factor), so a refined solve factors once.

Two pivot rules (``mode``):
  "guard"  the Pallas kernel's ``rsqrt(max(d, 1e-30))`` (solve_method
           "pallas");
  "nan"    a pivot <= 0 or NaN makes that system's x NaN, as
           jnp.linalg.cholesky does (solve_method "cholesky").

The substitution with a kept factor runs on one of two kernels, chosen
from M by measurement on an H100 (``subst_path_for``,
kernels/csrc/chol_plan.h ``subst_route``): "one_block", a block of 256
threads a system in one launch, at one row block (M <= 64), or "tiled",
each system spread over the card by a forward launch per 64 rows (a block
per 64-row tile below the block being solved) and the tiled path's
backward launches (``subst_plan``), at every larger M.

Bound on an H100: M^3/6 complex multiply-adds per system against M(M+1)/2
complex reads (one triangle of R), so at the main path's M (130-194) the
arithmetic sets the floor in both types.  Blocked right-looking updates in
register tiles (see the source note) on one of two paths, chosen from
(type, M) by the kernel (``path_for``; each wins where it serves, by
measurement on an H100):
  "resident"  one launch, the triangle in one block's shared memory
              (complex64 M <= 238, complex128 M <= 167);
  "tiled"     each system spread over the card by ``launches_per_call``
              launches: per 64 columns a panel launch (a block per 64-row
              tile) and a trailing-update launch (a block per 64 x 64
              tile), then a backward-substitution launch per 64 rows
              (every larger M); the schedule is ``kernels/csrc/chol_plan.h``
              (``tiled_plan``).
The kernel takes any M >= 1 and any B as they are; it fails only where the
caller cannot allocate its tensors.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version.  ``chol_solve.launches`` / ``chol_subst.launches``
count kernel launches and ``.shapes`` record each launch: (B, M, path, mode,
keep_factor) and (B, M, path); ``.plain_calls`` counts the calls served by
the plain version.  A launch recorded into a CUDA graph runs at every
replay, not at capture: it goes to the capturing thread's record, and the
graph's owner adds the captured launches to the counts at each replay
(``take_captured``, ``count_replay``; ``.replayed`` counts those).  The
counts are safe to update from several threads.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch

from eaqhm_torch.kernels import build

_SYMBOLS = {torch.complex64: ("chol_factor_solve_c64", "chol_subst_c64"),
            torch.complex128: ("chol_factor_solve_c128", "chol_subst_c128")}
MODES = ("guard", "nan")
PATHS = ("resident", "tiled")
SUBST_PATHS = ("one_block", "tiled")
_GUARD = 1e-30
# The counts below are shared by every thread and updated under _lock; the
# launches recorded during a CUDA graph capture are kept per thread (_tls).
_lock = threading.Lock()
_tls = threading.local()
_prepared = set()          # CUDA device indices whose attributes are set


class Factor(NamedTuple):
    """A kept Cholesky factor.  From the kernel: L row-packed lower triangle
    [B, M(M+1)/2] (row i at i(i+1)/2) and d its real diagonal [B, M]; from
    the plain version: L full lower [B, M, M] and d None."""
    L: torch.Tensor
    d: Optional[torch.Tensor]


def _check(R: torch.Tensor, rhs: torch.Tensor) -> None:
    if R.dtype not in _SYMBOLS:
        raise TypeError(f"chol_solve takes complex64/complex128, got {R.dtype}")
    if rhs.dtype != R.dtype:
        raise TypeError(f"rhs dtype {rhs.dtype} != R dtype {R.dtype}")
    if R.dim() != 3 or R.shape[1] != R.shape[2]:
        raise ValueError(f"R must be [B, M, M], got {tuple(R.shape)}")
    if rhs.dim() != 2 or tuple(rhs.shape) != tuple(R.shape[:2]):
        raise ValueError(f"rhs must be [B, M] = {tuple(R.shape[:2])}, "
                         f"got {tuple(rhs.shape)}")
    if R.device != rhs.device:
        raise ValueError(f"R on {R.device}, rhs on {rhs.device}")
    if not (R.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("chol_solve needs contiguous R and rhs")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chol_solve runs on CUDA or CPU, not {t.device}")
    return t.device.type


def chol_factor_reference(R: torch.Tensor, mode: str = "nan") -> torch.Tensor:
    """Plain factor: the full lower L [B, M, M] of R = L L^H.

    "nan": torch.linalg.cholesky_ex (cuSOLVER on the card), and a system
    whose factorization fails gets an all-NaN L, as jnp.linalg.cholesky.
    "guard": a column loop vectorised over B with the Pallas kernel's pivot
    rule at every column (L[j, j] = d * rd, L[i, j] = A[i, j] * rd,
    rd = rsqrt(max(d, 1e-30))); equal to cholesky_ex to rounding on HPD R.
    """
    _check_mode(mode)
    if mode == "nan":
        L, info = torch.linalg.cholesky_ex(R)
        return torch.where((info != 0)[:, None, None],
                           torch.full_like(L, float("nan")), L)
    A = R.clone()
    L = torch.zeros_like(R)
    for j in range(R.shape[-1]):
        d = A[:, j, j].real
        rd = torch.rsqrt(torch.where(d < _GUARD, torch.full_like(d, _GUARD),
                                     d))
        col = A[:, j:, j] * rd[:, None]
        col[:, 0] = (d * rd).to(R.dtype)
        L[:, j:, j] = col
        c = col[:, 1:]
        A[:, j + 1:, j + 1:] -= c[:, :, None] * c.conj()[:, None, :]
    return L


def chol_subst_reference(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Plain substitution: x = (L L^H)^-1 rhs, two triangular solves."""
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mH, y, upper=True)[..., 0]


def chol_solve_reference(R: torch.Tensor, rhs: torch.Tensor,
                         mode: str = "nan") -> torch.Tensor:
    """Plain factor + solve.  In "nan" mode this is cuSOLVER's Cholesky and
    two triangular solves, the function the JAX float64 branch computes
    (solver.py:356-362)."""
    return chol_subst_reference(chol_factor_reference(R, mode), rhs)


def unpack_factor(f: Factor) -> torch.Tensor:
    """The full lower L [B, M, M] of a kept factor (either form)."""
    if f.d is None:
        return f.L
    B, M = f.d.shape
    rows, cols = torch.tril_indices(M, M, device=f.L.device)
    L = torch.zeros((B, M, M), dtype=f.L.dtype, device=f.L.device)
    L[:, rows, cols] = f.L        # tril_indices run row by row: packed order
    idx = torch.arange(M, device=f.L.device)
    L[:, idx, idx] = f.d.to(f.L.dtype)
    return L


def library(device=None):
    """The kernel library.  With a CUDA device, the kernels' shared-memory
    attributes are set on that device first (once per device, before any
    launch there: a CUDA graph capture then records the launches alone;
    ``cudaFuncSetAttribute`` applies to one device only)."""
    lib = build.load("chol_solve")
    if device is None:
        return lib
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _prepared:
        with _lock, torch.cuda.device(idx):
            err = lib.chol_prepare()
            if err != 0:
                raise RuntimeError(f"chol_solve: setting the kernels' "
                                   f"shared memory on cuda:{idx} failed: "
                                   f"cudaError {err}")
            _prepared.add(idx)
    return lib


def path_for(dtype: torch.dtype, M: int) -> str:
    """The kernel path a system of order M >= 1 takes: one of PATHS (needs
    the built library: call only with CUDA tensors at hand)."""
    if M < 1:
        raise ValueError(f"chol_solve: M={M} is not an order")
    return PATHS[library().chol_path(M, int(dtype == torch.complex128))]


class TiledPlan(NamedTuple):
    """One tiled-path call of B systems as its launcher makes it
    (kernels/csrc/chol_plan.h ``tiled_schedule``): device launches, blocks
    of the panel kernels (the first diagonal block's and the panels'), of
    the trailing updates and of the backward substitution over the call,
    and the scratch's columns a system."""
    launches: int
    panel_blocks: int
    update_blocks: int
    backward_blocks: int
    scratch: int


@functools.lru_cache(maxsize=256)
def tiled_plan(M: int, B: int = 1) -> TiledPlan:
    """The tiled path's plan of a call of B systems of order M >= 1, read
    from the plan's host build (no CUDA toolkit needed)."""
    out = (ctypes.c_longlong * 4)()
    launches = build.load_host("chol_plan").chol_tiled_plan(M, B, out)
    if launches < 0:
        raise ValueError(f"chol_solve: no tiled plan for M={M} B={B}")
    return TiledPlan(launches, *out)


def launches_per_call(M: int, path: str, B: int = 1) -> int:
    """Device launches of one ``chol_solve`` call of B systems of order M
    on a path: one, or on "tiled" ``tiled_plan``'s."""
    return tiled_plan(M, B).launches if path == "tiled" else 1


class SubstPlan(NamedTuple):
    """One tiled ``chol_subst`` call of B systems as its launcher makes it
    (kernels/csrc/chol_plan.h ``subst_schedule``): device launches, and
    blocks of the forward and of the backward launches over the call."""
    launches: int
    forward_blocks: int
    backward_blocks: int


@functools.lru_cache(maxsize=256)
def subst_plan(M: int, B: int = 1) -> SubstPlan:
    """The tiled substitution's plan of a call of B systems of order
    M >= 1, read from the plan's host build (no CUDA toolkit needed)."""
    out = (ctypes.c_longlong * 2)()
    launches = build.load_host("chol_plan").chol_subst_plan(M, B, out)
    if launches < 0:
        raise ValueError(f"chol_subst: no tiled plan for M={M} B={B}")
    return SubstPlan(launches, *out)


@functools.lru_cache(maxsize=1024)
def subst_path_for(M: int) -> str:
    """The substitution path a call of order M >= 1 takes (one of
    SUBST_PATHS): the route of kernels/csrc/chol_plan.h, read from the
    plan's host build (no CUDA toolkit needed)."""
    r = build.load_host("chol_plan").chol_subst_route(M)
    if r < 0:
        raise ValueError(f"chol_subst: no route for M={M}")
    return SUBST_PATHS[r]


def subst_launches_per_call(M: int, path: str, B: int = 1) -> int:
    """Device launches of one ``chol_subst`` call of B systems of order M
    on a substitution path: one, or on "tiled" ``subst_plan``'s."""
    return subst_plan(M, B).launches if path == "tiled" else 1


def _launch(fn_name: str, dev: torch.device, *args) -> None:
    """Call one launcher of the library on the current stream of dev, with
    dev the current device (a stream belongs to one device)."""
    lib = library(dev)
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {err}")


def chol_solve(R: torch.Tensor, rhs: torch.Tensor, mode: str = "nan",
               keep_factor: bool = False, path: Optional[str] = None):
    """Solve R x = rhs for a batch of HPD R: [B, M, M], rhs: [B, M].

    Returns x, or (x, Factor) with keep_factor (for ``chol_subst``).  On a
    CUDA tensor this launches the hand kernel (``launches_per_call`` device
    launches), counts the call once in ``chol_solve.launches`` and records
    (B, M, path, mode, keep_factor) in ``chol_solve.shapes``; on a CPU
    tensor it runs the plain version.  path (one of PATHS) takes another
    path than ``path_for``'s, to measure one against another; the kernel
    refuses a path whose shared memory does not fit M.
    """
    _check(R, rhs)
    _check_mode(mode)
    if _device_of(R) == "cpu":
        with _lock:
            chol_solve.plain_calls += 1
        L = chol_factor_reference(R, mode)
        x = chol_subst_reference(L, rhs)
        return (x, Factor(L, None)) if keep_factor else x
    B, M = rhs.shape
    x = torch.empty_like(rhs)
    if path is None:
        path = path_for(R.dtype, M)
    L = d = wk = None
    if keep_factor or path != "resident":
        L = torch.empty((B, M * (M + 1) // 2), dtype=R.dtype, device=R.device)
    if keep_factor or path == "tiled":
        d = torch.empty((B, M), dtype=R.real.dtype, device=R.device)
    if path == "tiled":           # the current panel's rsqrt pivots
        wk = torch.empty((B, tiled_plan(M).scratch), dtype=R.real.dtype,
                         device=R.device)
    if B:
        _launch(_SYMBOLS[R.dtype][0], R.device, R.data_ptr(), rhs.data_ptr(),
                x.data_ptr(), *(None if t is None else t.data_ptr()
                                for t in (L, d, wk)), B, M,
                int(mode == "nan"), PATHS.index(path))
        _count(chol_solve, (B, M, path, mode, keep_factor))
    return (x, Factor(L, d)) if keep_factor else x


def chol_subst(f: Factor, rhs: torch.Tensor,
               path: Optional[str] = None) -> torch.Tensor:
    """x = (L L^H)^-1 rhs with a factor kept by ``chol_solve``.  On CUDA
    one of two hand kernels, by ``subst_path_for(M)`` (path, one of
    SUBST_PATHS, takes the other, to measure one against the other):
    "one_block", one launch of a block a system (at the resident orders
    the factor staged in shared memory, otherwise read from device memory
    with y in shared memory where it fits), or "tiled", each system spread
    over the card by ``subst_launches_per_call`` launches (a forward and a
    backward launch per 64 rows; nothing allocated but x, so a CUDA graph
    captures the call whole).  The call counts once in
    ``chol_subst.launches``, with (B, M, path) in ``chol_subst.shapes``.
    On the CPU the plain triangular solves."""
    if rhs.dtype != f.L.dtype or rhs.dim() != 2 or rhs.device != f.L.device:
        raise ValueError("chol_subst: rhs must be [B, M] of the factor's "
                         "dtype and device")
    if path is not None and path not in SUBST_PATHS:
        raise ValueError(f"chol_subst: path must be one of {SUBST_PATHS}, "
                         f"got {path!r}")
    if _device_of(rhs) == "cpu":
        with _lock:
            chol_subst.plain_calls += 1
        return chol_subst_reference(unpack_factor(f), rhs)
    B, M = rhs.shape
    if (f.d is None or tuple(f.d.shape) != (B, M)
            or tuple(f.L.shape) != (B, M * (M + 1) // 2)
            or not (f.L.is_contiguous() and f.d.is_contiguous()
                    and rhs.is_contiguous())):
        raise ValueError("chol_subst needs a kernel factor matching rhs "
                         f"[{B}, {M}] and contiguous tensors")
    x = torch.empty_like(rhs)
    if B:
        if path is None:
            path = subst_path_for(M)
        _launch(_SYMBOLS[rhs.dtype][1], rhs.device, f.L.data_ptr(),
                f.d.data_ptr(), rhs.data_ptr(), x.data_ptr(), B, M,
                SUBST_PATHS.index(path))
        _count(chol_subst, (B, M, path))
    return x


def _captured() -> dict:
    """This thread's record of launches made during a capture."""
    rec = getattr(_tls, "captured", None)
    if rec is None:
        rec = _tls.captured = {fn.__name__: [] for fn in (chol_solve,
                                                          chol_subst)}
    return rec


def _count(fn, shape) -> None:
    if torch.cuda.is_current_stream_capturing():
        _captured()[fn.__name__].append(shape)
    else:
        with _lock:
            fn.launches += 1
            fn.shapes.append(shape)


def take_captured() -> dict:
    """The launches this thread recorded into the CUDA graph it just
    captured, per entry point, and a fresh record for its next capture
    (per thread: a capture in one thread leaves another's record alone)."""
    out = _captured()
    _tls.captured = None
    return out


def count_replay(captured: dict) -> None:
    """Count the launches of one replay of a graph (``take_captured``)."""
    with _lock:
        for fn in (chol_solve, chol_subst):
            shapes = captured[fn.__name__]
            fn.launches += len(shapes)
            fn.replayed += len(shapes)
            fn.shapes.extend(shapes)


def reset_counts() -> None:
    """Set every launch and plain-call count of this module to 0, and this
    thread's capture record."""
    with _lock:
        for fn in (chol_solve, chol_subst):
            fn.launches = 0
            fn.shapes = []
            fn.plain_calls = 0
            fn.replayed = 0
    _tls.captured = None


reset_counts()
