"""Batched HPD solve by recursive block inverse: the hand-written CUDA kernel
and its plain PyTorch version.

The float32 default solve of both packages (``solve_gram``'s
``"block_inverse"`` branch, eaqhm_tpu/ops/solver.py:316-352, which XLA fuses
on the TPU): Ri by JAX's recursive Schur-complement inverse with
Gauss-Jordan leaves of order <= 16 (``hpd_block_inverse``, ``gj_inverse``),
x = Ri rhs, two refinements x += Ri (rhs - R x), and the inputs of the
float32 gate per system: the residual ratio ||rhs - R x||inf / ||rhs||inf of
the returned x and whether x is finite.  ``block_inverse_solve`` returns
them with ``ok``, a 0-d bool: every system finite and its ratio <=
RESID_GATE.

The kernel (``kernels/csrc/block_inverse.cu``) takes one of two paths,
chosen from (type, M) by ``path_for``:
  "resident"  one launch: one block per system builds Ri in shared memory
              and runs the refinements and the gate (complex64 M <= 168,
              complex128 M <= 118);
  "hybrid"    beyond: Ri in a device-memory workspace W that is written, never
              copied from R: each subtree of the recursion whose order fits
              one block (complex64 <= 170, complex128 <= 120) is one launch
              of the in-block inversion kernel, reading R down the tree's
              left edge and W where a Schur complement was written; each
              level above is JAX's four products through torch.matmul (as
              JAX leaves them to XLA) and a copy of -U^H (level_cublas);
              then one launch of the refinement kernel.
Both paths compute each of JAX's products in full, Sc = S - Q^H T and
P^-1 + U T^H included: 2M^3/3 complex multiply-adds per inverse.
``launches_per_call`` gives the CUDA launches of one call on each path
(kernels, products, copies and the flag's fill); ``workspace_elems`` the
complex elements per system it allocates besides its inputs and outputs.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version.  ``block_inverse_solve.launches`` counts kernel
launches, ``.shapes`` records (B, M, path, type name) per call,
``.plain_calls`` the calls served by the plain version; launches recorded
into a CUDA graph count at each replay (``take_captured``,
``count_replay``, ``.replayed``), as in ``ops.chol``.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from eaqhm_torch.kernels import build

PATHS = ("resident", "hybrid")
SMEM_MAX = 232448     # shared memory one block of an H100 can use
GJ_BASE = 16          # Gauss-Jordan leaf order of the recursion
REFINE = 2            # residual refinements
# float32: a batch whose returned solution leaves a residual above this
# share of the right-hand side (infinity norms, any system) reruns ridged
# (ops.solver); the readings that place it are in PERF.md.
RESID_GATE = 1e-3
# the kernel's shared-memory layout (smem_bytes): elements past the matrix
# that a tile may read, and the warps its reduction scratch is sized for
_PAD = 8
_RED_WARPS = 16
_SYMBOLS = {torch.complex64: ("bi_solve_resident_c64", "bi_invert_c64",
                              "bi_refine_c64"),
            torch.complex128: ("bi_solve_resident_c128", "bi_invert_c128",
                               "bi_refine_c128")}
_lock = threading.Lock()
_tls = threading.local()
_prepared = set()


class Solved(NamedTuple):
    """x [B, M]; resid_ratio [B] real; finite [B] bool; ok 0-d bool."""
    x: torch.Tensor
    resid_ratio: torch.Tensor
    finite: torch.Tensor
    ok: torch.Tensor


def split(n: int) -> int:
    """JAX's split of an order-n node (eaqhm_tpu/ops/solver.py:114-115)."""
    m = (n // 2 + 7) & ~7 if n >= 32 else n // 2
    return min(m, n - 1)


def _itemsize(dtype: torch.dtype) -> int:
    if dtype not in _SYMBOLS:
        raise TypeError(f"block_inverse takes complex64/complex128, "
                        f"got {dtype}")
    return 8 if dtype == torch.complex64 else 16


def smem_bytes(dtype: torch.dtype, n: int, solve: bool) -> int:
    """Shared memory of one block of the resident kernel (solve) or of the
    subtree kernel at order n (the kernel's smem_bytes): the matrix at an
    even row stride and its padding, the leaves' exchange buffers, x and the
    residual, the reduction scratch."""
    c = _itemsize(dtype)
    ld = n + (n & 1)
    return (n * ld + _PAD + 2 * (GJ_BASE + 1) + (2 * n if solve else 0)) * c \
        + 2 * _RED_WARPS * (c // 2)


def subtree_max(dtype: torch.dtype) -> int:
    """The largest order one subtree launch takes."""
    n = 1
    while smem_bytes(dtype, n + 1, False) <= SMEM_MAX:
        n += 1
    return n


def path_for(dtype: torch.dtype, M: int) -> str:
    """The path a system of order M >= 1 takes: one of PATHS."""
    if M < 1:
        raise ValueError(f"block_inverse: M={M} is not an order")
    return "resident" if smem_bytes(dtype, M, True) <= SMEM_MAX else "hybrid"


def _nodes(dtype: torch.dtype, M: int):
    """(internal nodes, subtrees) of the hybrid recursion at order M: the
    nodes above subtree_max, as (offset, order, split), and the subtree
    launches, as (offset, order), in launch order."""
    nmax = subtree_max(dtype)
    internal, subtrees = [], []

    def walk(o, n):
        if n <= nmax:
            subtrees.append((o, n))
            return
        m = split(n)
        internal.append((o, n, m))
        walk(o, m)
        walk(o + m, n - m)
    walk(0, M)
    return internal, subtrees


def launches_per_call(dtype: torch.dtype, M: int) -> int:
    """CUDA launches of one call on a CUDA tensor: resident, the flag's fill
    and the kernel; hybrid, the fill, one subtree launch each, five per level
    above (T, Sc, -U and P^-1 + U T^H through torch.matmul, the copy of
    -U^H) and a copy of S at each level that reads R (the tree's left
    edge), and the refinement."""
    if path_for(dtype, M) == "resident":
        return 2
    internal, subtrees = _nodes(dtype, M)
    return 2 + len(subtrees) + 5 * len(internal) + sum(
        o == 0 for o, _, _ in internal)


def workspace_elems(dtype: torch.dtype, M: int) -> int:
    """Complex elements per system that a call allocates besides R, rhs
    and its outputs: none on the resident path; the workspace Ri, the
    largest T of a level and the residual on the hybrid path."""
    if path_for(dtype, M) == "resident":
        return 0
    internal, _ = _nodes(dtype, M)
    return M * M + max((m * (n - m) for _, n, m in internal), default=0) + M


def gj_inverse(R):
    """Batched explicit inverse of small HPD blocks by unrolled Gauss-Jordan
    elimination with no pivoting (stable for equilibrated positive-definite
    blocks).  R: [B, m, m]; returns [B, m, m]."""
    B, m, _ = R.shape
    eye = torch.eye(m, dtype=R.dtype, device=R.device).expand(B, m, m)
    A = torch.cat([R, eye], dim=-1)                     # [B, m, 2m]
    for j in range(m):
        row = A[:, j, :] / A[:, j, j:j + 1]
        A = A - A[:, :, j:j + 1] * row[:, None, :]
        A[:, j, :] = row
    return A[:, :, m:]


def hpd_block_inverse(R):
    """Batched inverse of Hermitian-positive-definite matrices by recursive
    Schur-complement block inversion (matrix products only).  For
    [[P, Q], [Q^H, S]] with T = P^-1 Q and Sc = S - Q^H T:

        inv = [[P^-1 + T Sc^-1 T^H,  -T Sc^-1],
               [-Sc^-1 T^H,           Sc^-1]]

    Split at m = (M//2 + 7) & ~7 for M >= 32 (M//2 below), Gauss-Jordan
    leaves of order <= 16, as the JAX package.  R: [B, M, M]."""
    M = R.shape[-1]
    if M <= GJ_BASE:
        return gj_inverse(R)
    m = split(M)
    P = R[..., :m, :m]
    Q = R[..., :m, m:]
    S = R[..., m:, m:]
    Pi = hpd_block_inverse(P)
    T = torch.matmul(Pi, Q)
    Sc = S - torch.matmul(Q.mH, T)
    Si = hpd_block_inverse(Sc)
    U = torch.matmul(T, Si)
    TL = Pi + torch.matmul(U, T.mH)
    top = torch.cat([TL, -U], dim=-1)
    bot = torch.cat([-U.mH, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _mv(R, x):
    return torch.matmul(R, x[..., None])[..., 0]


def gate_inputs(R, rhs, x) -> Solved:
    """The gate of a returned solution x: per system the residual ratio
    ||rhs - R x||inf / ||rhs||inf (0 where the residual is 0, NaN where it
    is NaN) and whether x is finite, and ok: all finite and every ratio
    <= RESID_GATE."""
    rmax = (rhs - _mv(R, x)).abs().amax(-1)
    ratio = torch.where(rmax == 0, torch.zeros_like(rmax),
                        rmax / rhs.abs().amax(-1))
    finite = torch.isfinite(torch.view_as_real(x)).all(-1).all(-1)
    return Solved(x, ratio, finite, (finite & (ratio <= RESID_GATE)).all())


def solve_reference(R, rhs) -> Solved:
    """The plain version: Ri = hpd_block_inverse(R), x = Ri rhs, REFINE
    refinements x += Ri (rhs - R x) (JAX solver.py:316-352), the gate."""
    Ri = hpd_block_inverse(R)
    x = _mv(Ri, rhs)
    for _ in range(REFINE):
        x = x + _mv(Ri, rhs - _mv(R, x))
    return gate_inputs(R, rhs, x)


def hybrid_inverse(R: torch.Tensor, W: torch.Tensor, invert_subtree) -> None:
    """The hybrid path's recursion: W [B, M, M] (any contents on entry) is
    made the inverse of R [B, M, M], which is only read.  A node (o, n)
    reads its blocks from its source: R down the tree's left edge, W where
    its parent wrote a Schur complement.  Each subtree of order <=
    subtree_max is ``invert_subtree(src, W, o, n)`` (W's block at (o, o)
    the inverse of src's); above, for [[P, Q], [Q^H, S]] at (o, n):
    T = P^-1 Q; ``level_cublas(0, src, W, o, n, m, T)`` writes
    Sc = S - Q^H T into W; the right subtree (source W); -U = -T Sc^-1 into
    W's upper right; ``level_cublas(1, src, W, o, n, m, T)`` writes
    P^-1 + U T^H into W's upper left and -U^H into its lower left."""
    _hybrid_node(R, W, 0, W.shape[-1], subtree_max(W.dtype), invert_subtree)


def _hybrid_node(src, W, o, n, nmax, invert_subtree) -> None:
    # a module-level function, not a closure: a recursive closure is a
    # reference cycle that would keep W alive until the garbage collector
    # runs
    if n <= nmax:
        invert_subtree(src, W, o, n)
        return
    m = split(n)
    P = W[:, o:o + m, o:o + m]
    Q = W[:, o:o + m, o + m:o + n]
    S = W[:, o + m:o + n, o + m:o + n]
    _hybrid_node(src, W, o, m, nmax, invert_subtree)
    T = torch.matmul(P, src[:, o:o + m, o + m:o + n])
    level_cublas(0, src, W, o, n, m, T)
    _hybrid_node(W, W, o + m, n - m, nmax, invert_subtree)
    Q.baddbmm_(T, S, beta=0, alpha=-1)
    level_cublas(1, src, W, o, n, m, T)


def level_cublas(mode, src, W, o, n, m, T) -> None:
    """One level of the hybrid path, JAX's products through
    torch.matmul: mode 0 Sc = S - Q^H T into W (S first copied from R
    where the level reads R), mode 1 P^-1 + U T^H = P - (-U) T^H in place
    and -U^H into W's lower left."""
    if mode == 0:
        S = W[:, o + m:o + n, o + m:o + n]
        if src is not W:
            S.copy_(src[:, o + m:o + n, o + m:o + n])
        S.baddbmm_(src[:, o:o + m, o + m:o + n].mH, T, alpha=-1)
    else:
        Q = W[:, o:o + m, o + m:o + n]
        W[:, o:o + m, o:o + m].baddbmm_(Q, T.mH, alpha=-1)
        W[:, o + m:o + n, o:o + m].copy_(Q.mH)


def subtree_reference(src, W, o, n) -> None:
    """The plain version of one subtree launch."""
    W[:, o:o + n, o:o + n] = hpd_block_inverse(
        src[:, o:o + n, o:o + n].clone())


def library(device=None):
    """The kernel library; with a CUDA device, its shared-memory attributes
    are set on that device first (once per device, outside any capture)."""
    lib = build.load("block_inverse")
    if device is None:
        return lib
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _prepared:
        with _lock, torch.cuda.device(idx):
            err = lib.bi_prepare()
            if err != 0:
                raise RuntimeError(f"block_inverse: setting the kernels' "
                                   f"shared memory on cuda:{idx} failed: "
                                   f"cudaError {err}")
            _prepared.add(idx)
    return lib


def _launch(fn_name: str, dev: torch.device, *args) -> None:
    lib = library(dev)
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {err}")
    _count(1)


def _check(R: torch.Tensor, rhs: torch.Tensor) -> None:
    _itemsize(R.dtype)
    if rhs.dtype != R.dtype:
        raise TypeError(f"rhs dtype {rhs.dtype} != R dtype {R.dtype}")
    if R.dim() != 3 or R.shape[1] != R.shape[2]:
        raise ValueError(f"R must be [B, M, M], got {tuple(R.shape)}")
    if rhs.dim() != 2 or tuple(rhs.shape) != tuple(R.shape[:2]):
        raise ValueError(f"rhs must be [B, M] = {tuple(R.shape[:2])}, "
                         f"got {tuple(rhs.shape)}")
    if R.device != rhs.device:
        raise ValueError(f"R on {R.device}, rhs on {rhs.device}")
    if R.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block_inverse runs on CUDA or CPU, not {R.device}")
    if not (R.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("block_inverse needs contiguous R and rhs")


def block_inverse_solve(R: torch.Tensor, rhs: torch.Tensor) -> Solved:
    """Solve R x = rhs for a batch of equilibrated HPD R [B, M, M] by the
    recursive block inverse and two refinements; returns Solved(x,
    resid_ratio, finite, ok).  On a CUDA tensor this launches the kernel
    (``launches_per_call`` launches in all); on a CPU tensor it runs the
    plain version."""
    _check(R, rhs)
    if R.device.type == "cpu":
        with _lock:
            block_inverse_solve.plain_calls += 1
        return solve_reference(R, rhs)
    B, M = rhs.shape
    path = path_for(R.dtype, M)
    fn_res, fn_inv, fn_ref = _SYMBOLS[R.dtype]
    x = torch.empty_like(rhs)
    ratio = torch.empty(B, dtype=R.real.dtype, device=R.device)
    finite = torch.empty(B, dtype=torch.bool, device=R.device)
    ok = torch.ones((), dtype=torch.bool, device=R.device)
    if B == 0:
        return Solved(x, ratio, finite, ok)
    if path == "resident":
        _launch(fn_res, R.device, R.data_ptr(), rhs.data_ptr(), x.data_ptr(),
                ratio.data_ptr(), finite.data_ptr(), ok.data_ptr(), B, M,
                RESID_GATE)
    else:
        W = torch.empty_like(R)
        hybrid_inverse(R, W, _subtree_launcher(fn_inv))
        r = torch.empty_like(rhs)
        _launch(fn_ref, R.device, W.data_ptr(), R.data_ptr(), rhs.data_ptr(),
                x.data_ptr(), r.data_ptr(), ratio.data_ptr(),
                finite.data_ptr(), ok.data_ptr(), B, M, RESID_GATE)
    _record((B, M, path, str(R.dtype).split(".")[-1]))
    return Solved(x, ratio, finite, ok)


def _subtree_launcher(fn_name: str):
    """invert_subtree for hybrid_inverse on CUDA tensors: one launch of the
    subtree kernel from src's block at (o, o) into W's (row stride M)."""
    def invert_subtree(src, W, o, n):
        B, M = W.shape[0], W.shape[-1]
        off = (o * M + o) * W.element_size()
        _launch(fn_name, W.device, src.data_ptr() + off, W.data_ptr() + off,
                M * M, M, B, n)
    return invert_subtree


def _captured() -> dict:
    rec = getattr(_tls, "captured", None)
    if rec is None:
        rec = _tls.captured = {"launches": 0, "shapes": []}
    return rec


def _count(n: int) -> None:
    if torch.cuda.is_current_stream_capturing():
        _captured()["launches"] += n
    else:
        with _lock:
            block_inverse_solve.launches += n


def _record(shape) -> None:
    if torch.cuda.is_current_stream_capturing():
        _captured()["shapes"].append(shape)
    else:
        with _lock:
            block_inverse_solve.shapes.append(shape)


def take_captured() -> dict:
    """The kernel launches and calls this thread recorded into the CUDA
    graph it just captured, and a fresh record for its next capture."""
    out = _captured()
    _tls.captured = None
    return out


def count_replay(captured: dict) -> None:
    """Count the launches of one replay of a graph (``take_captured``)."""
    with _lock:
        block_inverse_solve.launches += captured["launches"]
        block_inverse_solve.replayed += captured["launches"]
        block_inverse_solve.shapes.extend(captured["shapes"])


def reset_counts() -> None:
    """Set every count of this module to 0, and this thread's capture
    record."""
    with _lock:
        block_inverse_solve.launches = 0
        block_inverse_solve.shapes = []
        block_inverse_solve.plain_calls = 0
        block_inverse_solve.replayed = 0
    _tls.captured = None


reset_counts()
