"""The block-inverse solve (eaqhm_torch.ops.block_inverse) on the CPU: its
plain version against the JAX package's recorded results at the orders of
the kernel's paths, the hybrid path's recursion, the wrapper's path and
shared-memory arithmetic, and the gate's inputs.  JAX's results are read
from tests/golden/torch_parity_ref.npz (tools/make_torch_parity_ref.py
--cases block_inverse); at M >= 130 the file holds the seed R and b are
rebuilt from with numpy, JAX's inverse times a seeded 4-column probe and
JAX's solution.  Tolerances: those of tests/test_torch_solver.py (_BI_TOL:
1e-10 relative in float64, the same arithmetic in another order; 1e-4 in
float32, the rounding of a recursion over cond(R) ~ 10 systems)."""
import os

import numpy as np
import pytest
import torch

from eaqhm_torch.models import engine
from eaqhm_torch.ops import block_inverse as bi
from eaqhm_torch.ops import chol
from eaqhm_torch.ops import solver

torch.set_num_threads(1)
REF = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_parity_ref.npz")
_BI_TOL = {"float64": 1e-10, "float32": 1e-4}
_CDT = {"float64": np.complex128, "float32": np.complex64}
_PROBED = ((4, 130), (4, 194), (3, 258), (2, 514))
_PROBES = 4


def _close(a, b, rtol):
    a = np.asarray(a)
    b = np.asarray(b)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


def _hpd(B, M, seed, dtype):
    """Equilibrated HPD systems and right-hand sides, as the fixture's
    tool builds them (tools/make_torch_parity_ref.py hpd_systems)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, M, M)) + 1j * rng.normal(size=(B, M, M))
    R = A @ np.conj(np.swapaxes(A, -1, -2)) / M + np.eye(M)
    d = np.sqrt(np.real(np.einsum("bii->bi", R)))
    R = (R / (d[:, :, None] * d[:, None, :])).astype(dtype)
    b = (rng.normal(size=(B, M)) + 1j * rng.normal(size=(B, M))).astype(dtype)
    return torch.as_tensor(R), torch.as_tensor(b)


def _probe(M, dtype):
    rng = np.random.default_rng(M + 1)
    V = (rng.normal(size=(M, _PROBES)) + 1j * rng.normal(size=(M, _PROBES)))
    return V.astype(dtype)


@pytest.fixture(scope="module")
def ref():
    with np.load(REF) as f:
        return {k: f[k] for k in f.files if k.startswith("block_inverse/")}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,M", _PROBED)
def test_plain_version_matches_jax_at_kernel_orders(ref, dtype, B, M):
    """At the resident (M = 130 in complex64) and hybrid orders (the rest;
    M = 130 too in complex128): the plain inverse and solve_gram's x equal
    JAX's, and on the CPU solve_gram serves the call with the plain
    version (no kernel launch, no ridged rerun)."""
    p = f"block_inverse/{dtype}/{B}x{M}/"
    assert int(ref[p + "seed"]) == M
    R, b = _hpd(B, M, M, _CDT[dtype])
    tol = _BI_TOL[dtype]
    _close(bi.hpd_block_inverse(R).numpy() @ _probe(M, _CDT[dtype]),
           ref[p + "inv_probe"], tol)
    bi.reset_counts()
    chol.reset_counts()
    x = solver.solve_gram(R, b, getattr(torch, dtype), method="block_inverse")
    _close(x, ref[p + "x"], tol)
    f = bi.block_inverse_solve
    assert (f.plain_calls, f.launches) == (1, 0)
    assert chol.chol_solve.plain_calls == 0


def _hybrid(R, sources=None):
    """hybrid_inverse of R with the plain subtree function into a workspace
    filled with NaN (the kernel's starts uninitialized); sources collects
    (reads R, offset, order) of each subtree."""
    W = torch.full_like(R, complex("nan+nanj"))

    def invert(src, W, o, n):
        if sources is not None:
            sources.append((src is R, o, n))
        bi.subtree_reference(src, W, o, n)
    bi.hybrid_inverse(R, W, invert)
    return W


@pytest.mark.parametrize("dtype,M", [(torch.complex128, 300),
                                     (torch.complex64, 258),
                                     (torch.complex128, 514)])
def test_hybrid_recursion_equals_plain_inverse(dtype, M):
    """The hybrid path's recursion on a workspace that starts with anything
    in it (each node reading its blocks from R down the tree's left edge
    and from the workspace below a written Schur complement) with plain
    subtrees gives the
    plain inverse: complex128 to 1e-12 relative (the same products in
    another order), complex64 to 1e-5; R is left as it was; each subtree
    is at most subtree_max, only the first reads R, and the calls are
    those launches_per_call counts."""
    R, _ = _hpd(2, M, 7, np.complex64 if dtype == torch.complex64
                else np.complex128)
    R0 = R.clone()
    sources = []
    W = _hybrid(R, sources)
    _close(W, bi.hpd_block_inverse(R),
           1e-12 if dtype == torch.complex128 else 1e-5)
    assert torch.equal(R, R0)
    m = bi.split(M)                 # -U^H is a copy of -U, bit for bit
    assert torch.equal(W[:, m:, :m], W[:, :m, m:].mH)
    internal, subtrees = bi._nodes(dtype, M)
    assert [(o, n) for _, o, n in sources] == subtrees
    assert [r for r, _, _ in sources] == [True] + [False] * (len(sources) - 1)
    assert max(n for _, n in subtrees) <= bi.subtree_max(dtype) < M
    left_edge = sum(o == 0 for o, _, _ in internal)
    assert bi.launches_per_call(dtype, M) == \
        2 + len(subtrees) + 5 * len(internal) + left_edge


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,M", _PROBED[1:])
def test_hybrid_driver_matches_jax(ref, dtype, B, M):
    """The hybrid driver with the plain subtree function (the CUDA path's
    recursion, on the CPU) equals the plain inverse and JAX's
    recorded inverse at the fixture's hybrid orders, to the tolerances of
    tests/test_torch_solver.py."""
    p = f"block_inverse/{dtype}/{B}x{M}/"
    R, _ = _hpd(B, M, M, _CDT[dtype])
    W = _hybrid(R)
    tol = _BI_TOL[dtype]
    _close(W, bi.hpd_block_inverse(R), tol)
    _close(W.numpy() @ _probe(M, _CDT[dtype]), ref[p + "inv_probe"], tol)


@pytest.mark.parametrize("dtype,M,launches", [
    (torch.complex64, 130, 2), (torch.complex64, 168, 2),
    (torch.complex64, 169, 3), (torch.complex64, 194, 10),
    (torch.complex64, 386, 23), (torch.complex64, 514, 23),
    (torch.complex64, 770, 48), (torch.complex64, 1294, 48),
    (torch.complex128, 118, 2), (torch.complex128, 119, 3),
    (torch.complex128, 162, 10), (torch.complex128, 386, 23),
    (torch.complex128, 514, 48), (torch.complex128, 1294, 97)])
def test_launches_per_call_by_hand(dtype, M, launches):
    """launches_per_call against counts made by hand from the split rule:
    resident, the flag's fill and the kernel; hybrid, the fill, each
    subtree, five per level above and a copy of S at each level on the
    tree's left edge, and the refinement (complex64 M = 514: levels 514,
    264, 250, two at offset 0, subtrees 136, 128, 128, 122: 2 + 4 + 15 +
    2; M = 169: one subtree, no level; complex128 M = 514: seven levels,
    three at offset 0, eight subtrees: 2 + 8 + 35 + 3)."""
    assert bi.launches_per_call(dtype, M) == launches


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_every_order_has_a_path_that_fits(dtype):
    """M = 1-2000: a path; the resident kernel's shared memory, and on the
    hybrid path every subtree's, within one block's 232,448 bytes; at most
    100 launches a call up to M = 1294 and 2 on the resident path."""
    nmax = bi.subtree_max(dtype)
    assert bi.smem_bytes(dtype, nmax, False) <= bi.SMEM_MAX
    assert bi.smem_bytes(dtype, nmax + 1, False) > bi.SMEM_MAX
    for M in range(1, 2001):
        path = bi.path_for(dtype, M)
        assert path in bi.PATHS
        n = bi.launches_per_call(dtype, M)
        if path == "resident":
            assert bi.smem_bytes(dtype, M, True) <= bi.SMEM_MAX
            assert n == 2
        else:
            assert bi.smem_bytes(dtype, M, True) > bi.SMEM_MAX
            _, subtrees = bi._nodes(dtype, M)
            assert all(bi.smem_bytes(dtype, s, False) <= bi.SMEM_MAX
                       for _, s in subtrees)
        if M <= 1294:
            assert n <= 100, (M, n)
    with pytest.raises(ValueError):
        bi.path_for(dtype, 0)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_workspace_fits_the_batch_budget(dtype):
    """The solve's workspace per frame (besides R) stays within the 3 M^2
    complex elements _batch_frames reserves for R and the solver at every
    tier order: batches sized by the engine fit the budget."""
    for Kc in range(1, 500):
        M = 2 * (2 * Kc + 1)
        assert M * M + bi.workspace_elems(dtype, M) <= 3 * M * M, M
    item = torch.empty((), dtype=dtype).element_size()
    N, Kc = 689, 128
    per_frame = item * (4 * N * (2 * Kc + 1) + 3 * (4 * Kc + 2) ** 2)
    assert engine._batch_frames(1, N, Kc, dtype, "cpu") == \
        engine._BATCH_BYTES["cpu"] // per_frame


def _gate_cases(ref):
    R, b = _hpd(5, 40, 3, np.complex64)
    b[2] = 0                                   # a zero right-hand side
    yield R, b
    for case in ("nonpd", "zero_pivot"):
        p = f"block_inverse/nonpd/{case}/"
        yield torch.as_tensor(ref[p + "R"]), torch.as_tensor(ref[p + "b"])


def test_gate_inputs_equal_the_residual_gate(ref):
    """The plain version's (resid_ratio, finite) decide as the residual
    gate (every ||b - R x||inf within RESID_GATE ||b||inf, NaN failing) and
    the finite test do: on a healthy batch with a zero right-hand side, on
    the non-PD batch (finite, residual 1e2 of the right-hand side) and on
    the zero-pivot batch (not finite)."""
    seen = []
    for R, b in _gate_cases(ref):
        sol = bi.solve_reference(R, b)
        finite = bool(torch.isfinite(torch.view_as_real(sol.x)).all())
        r = (b - torch.matmul(R, sol.x[..., None])[..., 0]).abs().amax(-1)
        within = bool((r <= bi.RESID_GATE * b.abs().amax(-1)).all())
        want = within and finite
        got = bool((sol.resid_ratio <= bi.RESID_GATE).all()
                   and sol.finite.all())
        assert got == want == bool(sol.ok)
        assert bool(sol.finite.all()) == finite
        seen.append(want)
    assert seen == [True, False, False]


def test_wrapper_rejects_bad_input():
    R, b = _hpd(2, 6, 1, np.complex64)
    for bad in ((R.real.contiguous(), b.real.contiguous()),
                (R, b.to(torch.complex128)), (R.transpose(1, 2), b),
                (R[0], b), (R, b[:, :5].contiguous())):
        with pytest.raises((TypeError, ValueError)):
            bi.block_inverse_solve(*bad)


def test_hybrid_recursion_frees_the_workspace_at_once():
    """The hybrid recursion holds no reference cycle: the workspace is
    freed when the caller drops it, with the garbage collector off (a
    cycle kept one R-sized workspace per call alive on the card)."""
    import gc
    import weakref
    R, _ = _hpd(2, 300, 9, np.complex128)
    W = torch.empty_like(R)
    ref = weakref.ref(W)
    enabled = gc.isenabled()
    gc.disable()
    try:
        bi.hybrid_inverse(R, W, bi.subtree_reference)
        del W
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
