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
    """Both paths (M = 258 takes the tiled one in both types, M = 194 in
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
    """The largest resident orders (the triangle, y, rd, 1 / diag and a
    flag in 232,448 bytes of shared memory), the tiled path above them; a
    path for every order from 1 to 6657 in both types."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for dt, top in ((torch.complex64, 238), (torch.complex128, 167)):
        assert chol.path_for(dt, 1) == "resident"
        assert chol.path_for(dt, top) == "resident"
        assert chol.path_for(dt, top + 1) == "tiled"
        assert all(chol.path_for(dt, M) in chol.PATHS
                   for M in range(1, 6658))
        assert chol.path_for(dt, 1 << 16) == "tiled"
    with pytest.raises(ValueError):
        chol.path_for(torch.complex64, 0)


def _hpd_cuda(B, M, dtype, seed):
    """Equilibrated HPD systems built on the card (A A^H / M + I, unit
    diagonal) from a seeded generator: numpy on the host would take minutes
    at M = 6146."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c128 = torch.complex128
    A = torch.randn((B, M, M), dtype=c128, generator=g, device="cuda")
    b = torch.randn((B, M), dtype=c128, generator=g, device="cuda")
    R = A @ A.mH / M + torch.eye(M, dtype=c128, device="cuda")
    d = torch.diagonal(R, dim1=-2, dim2=-1).real.sqrt()
    R = R / (d[:, :, None] * d[:, None, :]).to(c128)
    return R.to(dtype).contiguous(), b.to(dtype).contiguous()


def _against_plain(R, b, mode, tol, **kw):
    x, f = chol.chol_solve(R, b, mode=mode, keep_factor=True, **kw)
    x2 = chol.chol_solve(R, b, mode=mode, **kw)
    xs = chol.chol_subst(f, b)
    torch.cuda.synchronize()
    xr = chol.chol_solve_reference(R, b, mode=mode)
    for got in (x, x2, xs):
        err = ((got - xr).abs().max() / xr.abs().max()).item()
        assert err <= tol, (tuple(R.shape), mode, kw, err)
    return f


@pytest.mark.gpu
@pytest.mark.parametrize("mode", chol.MODES)
@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 2e-5),
                                       (torch.complex128, 1e-12)])
def test_cuda_wide_orders_match_plain_version(dtype, tol, mode):
    """The orders the tier lattice reaches at 22.05-48 kHz (M = 770, 1026,
    1294, 1950) and M = 6146, on the path the kernel routes them to: the
    fused solve with and without the kept factor, and the substitution."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for B, M in [(8, 770), (4, 1026), (4, 1294), (2, 1950), (2, 6146)]:
        R, b = _hpd_cuda(B, M, dtype, seed=M)
        f = _against_plain(R, b, mode, tol)
        assert chol.chol_solve.shapes[-1][2] == chol.path_for(dtype, M)
        if M == 1950:
            Lr = chol.chol_factor_reference(R, mode)
            assert (chol.unpack_factor(f) - Lr).abs().max().item() < tol * 10


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 2e-5),
                                       (torch.complex128, 1e-12)])
def test_cuda_every_path_at_small_orders(dtype, tol):
    """Each path asked for by name at orders where it fits: ragged last
    panels, fewer rows than a panel, one row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for M in (1, 5, 37, 130, 258):
        R, b = _hpd_cuda(3, M, dtype, seed=100 + M)
        for mode in chol.MODES:
            for path in chol.PATHS:
                if path == "tiled" or M <= 167:
                    _against_plain(R, b, mode, tol, path=path)
    with pytest.raises(RuntimeError):
        R, b = _hpd_cuda(1, 800, dtype, seed=1)
        chol.chol_solve(R, b, path="resident")


@pytest.mark.gpu
def test_cuda_slab_path_past_the_cluster_capacity():
    """M = 6657, the widest order the wide phase holds (past what one
    cluster of blocks could stage), on the tiled path, both rules."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    M = 6657
    R, b = _hpd_cuda(2, M, torch.complex128, seed=M)
    for mode in chol.MODES:
        _against_plain(R, b, mode, 1e-12)
        assert chol.chol_solve.shapes[-1][2] == "tiled"


@pytest.mark.gpu
def test_cuda_nan_mode_marks_exactly_the_failed_systems_at_wide_orders():
    """A negative diagonal entry fails the factorization at that column: in
    the second 16-column step of the first panel and in the last panel;
    the kernel's "nan" rule marks exactly the systems cuSOLVER fails on, on
    the tiled path (also asked for by name below its route)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for dt in (torch.complex64, torch.complex128):
        for M, kw in ((1294, {}), (1950, {}), (700, {}),
                      (150, {"path": "tiled"})):
            R, b = _hpd_cuda(5, M, dt, seed=M + 1)
            R[1, 17, 17] = -1.0
            R[3, M - 5, M - 5] = -1.0
            x, f = chol.chol_solve(R, b, mode="nan", keep_factor=True, **kw)
            xr = chol.chol_solve_reference(R, b, mode="nan")
            bad = torch.isnan(x).any(dim=1)
            assert bad.tolist() == [False, True, False, True, False]
            assert torch.equal(bad, torch.isnan(xr).any(dim=1))
            assert torch.isnan(f.d[[1, 3]]).all()
            assert torch.isfinite(x[[0, 2, 4]]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 2e-5),
                                       (torch.complex128, 1e-12)])
def test_cuda_tiled_path_at_its_boundaries(dtype, tol):
    """The tiled path asked for by name around its 64-column panels and
    16-column steps (one system and several, up to M = 300): the fused
    solve with and without the kept factor, the substitution with the kept
    factor, and the factor itself, in both rules."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for B, M in ((1, 1), (3, 15), (3, 16), (3, 17), (2, 63), (2, 64),
                 (2, 65), (2, 127), (2, 128), (2, 129), (5, 300)):
        R, b = _hpd_cuda(B, M, dtype, seed=200 + M)
        for mode in chol.MODES:
            f = _against_plain(R, b, mode, tol, path="tiled")
            assert chol.chol_solve.shapes[-1][2] == "tiled"
            Lr = chol.chol_factor_reference(R, mode)
            assert (chol.unpack_factor(f) - Lr).abs().max().item() < tol * 10


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_cuda_tiled_path_in_a_cuda_graph(dtype):
    """A tiled call captured into a CUDA graph: 3 ceil(M / 64) - 1 kernel
    nodes (chol.launches_per_call), each replay the eager call's x bit for
    bit, and a replay after R and b change solves the new systems."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from torch_graph_nodes import captured, kernel_nodes
    M = 300
    R, b = _hpd_cuda(4, M, dtype, seed=9)
    x0 = chol.chol_solve(R, b, mode="nan", path="tiled")
    graph, x = captured(lambda: chol.chol_solve(R, b, mode="nan",
                                                path="tiled"))
    chol.take_captured()
    assert kernel_nodes(graph) == chol.launches_per_call(M, "tiled") == 14
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(x, x0)
    R2, b2 = _hpd_cuda(4, M, dtype, seed=10)
    R.copy_(R2)
    b.copy_(b2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(x, chol.chol_solve(R2, b2, mode="nan", path="tiled"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 2e-5),
                                       (torch.complex128, 1e-12)])
def test_cuda_tiled_subst_matches_plain_version(dtype, tol):
    """The substitution with a kept factor on both paths (the tiled one
    around its 64-row blocks and at the wide orders, the one-block kernel
    beside it), factors of both rules: each against the plain version,
    and the two paths against each other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for B, M in ((3, 1), (3, 64), (3, 65), (2, 128), (5, 129), (4, 300),
                 (8, 770), (2, 1950)):
        R, b = _hpd_cuda(B, M, dtype, seed=300 + M)
        b2 = (b * (0.5 - 1j)).contiguous()
        for mode in chol.MODES:
            _, f = chol.chol_solve(R, b, mode=mode, keep_factor=True)
            xr = chol.chol_subst_reference(chol.unpack_factor(f), b2)
            n = chol.chol_subst.launches
            xs = {p: chol.chol_subst(f, b2, path=p)
                  for p in chol.SUBST_PATHS}
            torch.cuda.synchronize()
            assert chol.chol_subst.launches == n + 2
            assert chol.chol_subst.shapes[-1] == (B, M, "tiled")
            for p, x in xs.items():
                err = ((x - xr).abs().max() / xr.abs().max()).item()
                assert err <= tol, (B, M, mode, p, err)
            d = (xs["tiled"] - xs["one_block"]).abs().max()
            assert (d / xr.abs().max()).item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_cuda_tiled_subst_in_a_cuda_graph(dtype):
    """A tiled substitution captured into a CUDA graph: 2 ceil(M / 64)
    kernel nodes (chol.subst_plan), each replay the eager call's x bit for
    bit, and a replay after rhs changes solves the new right-hand side."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from torch_graph_nodes import captured, kernel_nodes
    M = 300
    R, b = _hpd_cuda(4, M, dtype, seed=11)
    _, f = chol.chol_solve(R, b, mode="nan", keep_factor=True)
    x0 = chol.chol_subst(f, b, path="tiled")
    graph, x = captured(lambda: chol.chol_subst(f, b, path="tiled"))
    chol.take_captured()
    assert kernel_nodes(graph) == chol.subst_launches_per_call(
        M, "tiled", 4) == chol.subst_plan(M, 4).launches == 10
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(x, x0)
    b.copy_(b * (0.25 + 2j))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(x, chol.chol_subst(f, b, path="tiled"))
