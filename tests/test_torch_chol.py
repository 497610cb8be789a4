"""Batched HPD Cholesky solve (eaqhm_torch.ops.chol) against the JAX
package's Pallas kernel (interpret mode, recorded) and numpy: both pivot
rules, the fused solve and the kept factor's substitution."""
import os

import numpy as np
import pytest
import torch

from eaqhm_torch.ops import chol

torch.set_num_threads(1)
REF = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_parity_ref.npz")


def _mk(B, M, seed=0, dtype=np.complex64):
    """Equilibrated HPD systems, as tests/test_ops.py builds them."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, M, M)) + 1j * rng.normal(size=(B, M, M))
    R = A @ np.conj(np.swapaxes(A, -1, -2)) / M + np.eye(M)
    d = np.sqrt(np.real(np.einsum("bii->bi", R)))
    R = (R / (d[:, :, None] * d[:, None, :])).astype(dtype)
    b = (rng.normal(size=(B, M)) + 1j * rng.normal(size=(B, M))).astype(dtype)
    return R, b


@pytest.mark.parametrize("B,M", [(5, 50), (3, 32), (9, 37)])
def test_plain_path_matches_pallas_kernel(B, M):
    """Against eaqhm_tpu's chol_solve in interpret mode, recorded in
    tests/golden/torch_parity_ref.npz by tools/make_torch_parity_ref.py
    (~20-30 s of compile per shape).  (9, 37) pads both M (to the 32-wide
    panel) and B (to the 4-matrix grid step) in the Pallas kernel.
    Tolerances of tests/test_ops.py:208-227 (complex64 solves)."""
    ref = np.load(REF)
    R, b = ref[f"chol/{B}x{M}/R"], ref[f"chol/{B}x{M}/b"]
    R_in, b_in = _mk(B, M)                   # the recorded inputs are these
    np.testing.assert_array_equal(R, R_in)
    np.testing.assert_array_equal(b, b_in)
    x = chol.chol_solve(torch.as_tensor(R), torch.as_tensor(b),
                        mode="guard").numpy()
    np.testing.assert_allclose(x, ref[f"chol/{B}x{M}/x"], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("B,M", [(4, 37), (2, 130)])
def test_complex128_matches_numpy_solve(B, M):
    R, b = _mk(B, M, seed=M, dtype=np.complex128)
    launches = chol.chol_solve.launches
    x = chol.chol_solve(torch.as_tensor(R), torch.as_tensor(b)).numpy()
    xref = np.linalg.solve(R, b[..., None])[..., 0]
    assert np.abs(x - xref).max() / np.abs(xref).max() < 1e-10
    assert chol.chol_solve.launches == launches     # CPU: no kernel launch
    assert all(s[:2] != (B, M) for s in chol.chol_solve.shapes)


def test_reference_gives_nan_for_a_failed_factorization():
    R, b = _mk(3, 8, dtype=np.complex128)
    R[1] = -np.eye(8)
    x = chol.chol_solve_reference(torch.as_tensor(R), torch.as_tensor(b))
    assert torch.isnan(x[1]).all()
    assert torch.isfinite(torch.view_as_real(x[[0, 2]])).all()


@pytest.mark.parametrize("case", ["float32", "mixed", "noncontig", "rank",
                                  "rhs_shape", "mode"])
def test_wrapper_rejects_bad_input(case):
    R, b = (torch.as_tensor(a) for a in _mk(2, 6))
    mode = "nan"
    if case == "float32":
        R, b = R.real.contiguous(), b.real.contiguous()
    elif case == "mixed":
        b = b.to(torch.complex128)
    elif case == "noncontig":
        R = R.transpose(1, 2)
    elif case == "rank":
        R = R[0]
    elif case == "rhs_shape":
        b = b[:, :5].contiguous()
    elif case == "mode":
        mode = "pallas"
    with pytest.raises((TypeError, ValueError)):
        chol.chol_solve(R, b, mode=mode)


def _non_pd(B, M, dtype, sys=1, shift=3e-6, seed=3):
    """HPD batch whose system `sys` gets smallest eigenvalue -shift."""
    R, b = _mk(B, M, seed=seed, dtype=np.complex128)
    lam = np.linalg.eigvalsh(R[sys]).min()
    R[sys] = R[sys] - (lam + shift) * np.eye(M)
    return torch.as_tensor(R.astype(dtype)), torch.as_tensor(b.astype(dtype))


@pytest.mark.parametrize("mode", chol.MODES)
@pytest.mark.parametrize("dtype,tol", [(np.complex64, 2e-4),
                                       (np.complex128, 1e-12)])
def test_factor_then_subst_equals_fused_solve(dtype, tol, mode):
    R, b = (torch.as_tensor(a) for a in _mk(3, 37, seed=5, dtype=dtype))
    x = chol.chol_solve(R, b, mode=mode)
    x2, f = chol.chol_solve(R, b, mode=mode, keep_factor=True)
    assert torch.equal(x, x2)
    xs = chol.chol_subst(f, b)
    assert ((xs - x).abs().max() / x.abs().max()).item() < tol
    # a second right-hand side through the kept factor
    b2 = torch.flip(b, dims=[1]).contiguous()
    x3 = chol.chol_subst(f, b2).numpy()
    xr = np.linalg.solve(R.numpy().astype(np.complex128),
                         b2.numpy()[..., None])[..., 0]
    assert np.abs(x3 - xr).max() / np.abs(xr).max() < tol


@pytest.mark.parametrize("dtype,tol", [(np.complex64, 2e-4),
                                       (np.complex128, 1e-12)])
def test_guard_plain_version_matches_reference_on_hpd(dtype, tol):
    R, _ = (torch.as_tensor(a) for a in _mk(4, 50, seed=7, dtype=dtype))
    Lg = chol.chol_factor_reference(R, "guard")
    Ln = chol.chol_factor_reference(R, "nan")
    assert ((Lg - Ln).abs().max()).item() < tol
    assert torch.equal(Lg, torch.tril(Lg))


def test_guard_stays_finite_where_nan_mode_gives_nan():
    """The non-PD system of test_torch_solver (smallest eigenvalue -3e-6):
    the Pallas guard gives a finite vector, the "cholesky" rule NaN."""
    R, b = _non_pd(4, 50, np.complex64)
    xg = chol.chol_solve(R, b, mode="guard")
    xn = chol.chol_solve(R, b, mode="nan")
    assert torch.isfinite(torch.view_as_real(xg)).all()
    assert torch.isnan(xn[1]).all()
    assert torch.isfinite(torch.view_as_real(xn[[0, 2, 3]])).all()
    assert torch.equal(xn[[0, 2, 3]], chol.chol_solve_reference(R, b)[[0, 2, 3]])


def test_unpack_factor_reads_the_packed_layout():
    rng = np.random.default_rng(11)
    B, M = 2, 7
    L = np.tril(rng.normal(size=(B, M, M)) + 1j * rng.normal(size=(B, M, M)))
    d = rng.uniform(0.5, 2.0, size=(B, M))
    L[:, np.arange(M), np.arange(M)] = d
    packed = np.stack([Lb[np.tril_indices(M)] for Lb in L])
    assert packed.shape == (B, M * (M + 1) // 2)
    # row i starts at i(i+1)/2, as the kernel writes it
    np.testing.assert_array_equal(packed[:, 5 * 6 // 2 + 2], L[:, 5, 2])
    full = chol.unpack_factor(chol.Factor(torch.as_tensor(packed),
                                          torch.as_tensor(d)))
    np.testing.assert_array_equal(full.numpy(), L)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", chol.MODES)
@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 2e-4),
                                       (torch.complex128, 1e-10)])
def test_cuda_kernel_matches_plain_version(dtype, tol, mode):
    """Both paths (M = 258 takes the global one in both types, M = 194 in
    complex128), the fused solve and the kept factor's substitution."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for B, M in [(9, 37), (64, 130), (16, 194), (8, 258)]:
        R, b = _mk(B, M, seed=B, dtype=np.complex128)
        R = torch.as_tensor(R, dtype=dtype, device="cuda")
        b = torch.as_tensor(b, dtype=dtype, device="cuda")
        n = chol.chol_solve.launches
        x, f = chol.chol_solve(R, b, mode=mode, keep_factor=True)
        xs = chol.chol_subst(f, b)
        torch.cuda.synchronize()
        assert chol.chol_solve.launches == n + 1
        assert chol.chol_solve.shapes[-1] == (B, M, chol.path_for(dtype, M),
                                              mode, True)
        xr = chol.chol_solve_reference(R, b, mode=mode)
        assert ((x - xr).abs().max() / xr.abs().max()).item() < tol
        assert ((xs - xr).abs().max() / xr.abs().max()).item() < tol
        Lr = chol.chol_factor_reference(R, mode)
        assert (chol.unpack_factor(f) - Lr).abs().max().item() < tol * 10


@pytest.mark.gpu
def test_cuda_nan_mode_marks_exactly_the_failed_systems():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for dtype in (np.complex64, np.complex128):
        for M in (130, 258):
            R, b = _non_pd(6, M, dtype, sys=2, shift=0.05)
            R, b = R.cuda(), b.cuda()
            x = chol.chol_solve(R, b, mode="nan")
            xr = chol.chol_solve_reference(R, b, mode="nan")
            bad = torch.isnan(x).any(dim=1)
            assert torch.equal(bad, torch.isnan(xr).any(dim=1))
            assert bad.tolist() == [False, False, True, False, False, False]


@pytest.mark.gpu
def test_cuda_path_boundaries():
    """The largest resident orders: the triangle, y, rd, 1 / diag and a flag
    in 232,448 bytes of shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    assert chol.path_for(torch.complex64, 238) == "resident"
    assert chol.path_for(torch.complex64, 239) == "global"
    assert chol.path_for(torch.complex128, 167) == "resident"
    assert chol.path_for(torch.complex128, 168) == "global"
