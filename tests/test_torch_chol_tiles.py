"""The Cholesky kernel's tiled path, modelled on the CPU
(tests/torch_chol_tiles.py: its panel width, steps and order of
accumulation in float64), against ops.chol's plain versions: the factor of
chol_factor_reference and the solve of chol_solve_reference in both pivot
rules, at orders 1-300 (multiples of the 64-column panel and of the
16-column step, and orders between them), and with failed pivots in the
first, a middle and the last panel; and the launcher's plan
(ops.chol.tiled_plan, kernels/csrc/chol_plan.h) against the model's
launches."""
import numpy as np
import pytest
import torch

from eaqhm_torch.ops import chol

import torch_chol_tiles as model

torch.set_num_threads(1)
ORDERS = (1, 2, 15, 16, 17, 63, 64, 65, 100, 128, 129, 191, 257, 300)


def _hpd(B, M, seed):
    """Equilibrated HPD systems, as tests/test_torch_chol.py builds them."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, M, M)) + 1j * rng.normal(size=(B, M, M))
    R = A @ np.conj(np.swapaxes(A, -1, -2)) / M + np.eye(M)
    d = np.sqrt(np.real(np.einsum("bii->bi", R)))
    R = R / (d[:, :, None] * d[:, None, :])
    b = rng.normal(size=(B, M)) + 1j * rng.normal(size=(B, M))
    return torch.as_tensor(R), torch.as_tensor(b)


def _rel(x, xr):
    return ((x - xr).abs().max() / xr.abs().max()).item()


@pytest.mark.parametrize("M", ORDERS)
@pytest.mark.parametrize("mode", chol.MODES)
def test_tiled_schedule_matches_plain_version(M, mode):
    R, b = _hpd(3, M, seed=M)
    x, L, d = model.factor_solve(R, b, mode)
    Lr = chol.chol_factor_reference(R, mode)
    assert _rel(L, Lr) < 1e-12
    assert torch.equal(d, torch.diagonal(L, dim1=-2, dim2=-1).real)
    assert _rel(x, chol.chol_solve_reference(R, b, mode)) < 1e-12
    assert model.launches(M) == chol.launches_per_call(M, "tiled")


@pytest.mark.parametrize("M", ORDERS + (770, 1950, 6657))
@pytest.mark.parametrize("B", (1, 3, 65536))
def test_tiled_plan_matches_the_schedule(M, B):
    """chol.tiled_plan (the launcher's own schedule, kernels/csrc/chol_plan.h
    built for the host) against the model's launches: their number, for
    each group of at most 65535 systems, and the blocks of each kind over
    the call of B systems."""
    seq = model.launch_blocks(M)
    assert len(seq) == model.launches(M)

    def blocks(*kinds):
        return B * sum(n for kind, n in seq if kind in kinds)

    plan = chol.tiled_plan(M, B)
    assert plan == (-(-B // 65535) * len(seq), blocks("diag0", "panel"),
                    blocks("update"), blocks("backward"), model.TILE)
    assert chol.launches_per_call(M, "tiled", B) == plan.launches
    assert chol.launches_per_call(M, "resident", B) == 1


@pytest.mark.parametrize("M", (40, 150, 300))
def test_tiled_nan_rule_marks_exactly_the_failed_systems(M):
    """A negative diagonal entry fails the factorization at that column:
    in the first panel (system 1), a middle one (system 2, where M > 128)
    and the last (system 3)."""
    R, b = _hpd(5, M, seed=M + 1)
    R[1, 5, 5] = -1.0
    if M > 128:
        R[2, 64 + 17, 64 + 17] = -1.0
    R[3, M - 3, M - 3] = -1.0
    x, L, d = model.factor_solve(R, b, "nan")
    xr = chol.chol_solve_reference(R, b, "nan")
    bad = torch.isnan(x).any(dim=1)
    assert torch.equal(bad, torch.isnan(xr).any(dim=1))
    assert bad.tolist() == [False, True, M > 128, True, False]
    assert torch.isnan(d[bad]).all() and torch.isfinite(d[~bad]).all()
    assert _rel(x[~bad], xr[~bad]) < 1e-12


@pytest.mark.parametrize("M", (40, 150))
def test_tiled_guard_rule_on_failed_pivots(M):
    """The guard rule on the same systems: the pivot clamped at 1e-30 at the
    same column as in the plain column loop (a negative L[j, j] = d rd),
    the factor's columns before it equal to rounding, and x finite where
    the plain version's is."""
    R, b = _hpd(4, M, seed=M + 2)
    R[1, 5, 5] = -1.0
    R[2, M - 3, M - 3] = -1.0
    x, L, _ = model.factor_solve(R, b, "guard")
    Lr = chol.chol_factor_reference(R, "guard")
    xr = chol.chol_solve_reference(R, b, "guard")
    for s, col in ((0, M), (1, 5), (2, M - 3), (3, M)):
        dr = torch.diagonal(Lr[s]).real
        assert int((dr[:col] > 0).sum()) == col
        if col < M:
            assert dr[col] < 0 and torch.diagonal(L[s]).real[col] < 0
        assert _rel(L[s, :, :col], Lr[s, :, :col]) < 1e-12, s
    assert torch.equal(torch.isfinite(x), torch.isfinite(xr))
    assert _rel(x[[0, 3]], xr[[0, 3]]) < 1e-12


def _unpacked(L, d):
    """The full lower factor as ``chol.unpack_factor`` reads a kept one: L
    below the diagonal, d on it."""
    L = L.clone()
    idx = torch.arange(L.shape[-1])
    L[:, idx, idx] = d.to(L.dtype)
    return L


@pytest.mark.parametrize("M", ORDERS)
@pytest.mark.parametrize("mode", chol.MODES)
def test_tiled_subst_matches_plain_version(M, mode):
    """The tiled substitution's model with a factor of either rule against
    chol_subst_reference, on a right-hand side other than the factor's."""
    R, b = _hpd(3, M, seed=M + 3)
    L = chol.chol_factor_reference(R, mode)
    d = torch.diagonal(L, dim1=-2, dim2=-1).real
    b2 = torch.flip(b, dims=(1,)) * (1 - 0.5j)
    x = model.subst(L, d, b2)
    assert _rel(x, chol.chol_subst_reference(L, b2)) < 1e-12


def test_tiled_subst_at_the_wide_order():
    """M = 1950 (the 48 kHz tier, 31 row blocks, a ragged last one): a
    kept factor built directly (unit-scale diagonal, small entries below
    it: well conditioned without an M^3 factorization on the CPU)."""
    M = 1950
    g = torch.Generator().manual_seed(1950)
    L = torch.complex(torch.randn(2, M, M, generator=g, dtype=torch.float64),
                      torch.randn(2, M, M, generator=g, dtype=torch.float64))
    d = 1 + torch.rand(2, M, generator=g, dtype=torch.float64)
    L = torch.tril(L, -1) / M
    b = torch.complex(torch.randn(2, M, generator=g, dtype=torch.float64),
                      torch.randn(2, M, generator=g, dtype=torch.float64))
    x = model.subst(L, d, b)
    assert _rel(x, chol.chol_subst_reference(_unpacked(L, d), b)) < 1e-12


@pytest.mark.parametrize("M", (40, 150, 300))
def test_tiled_subst_nan_on_exactly_the_failed_systems(M):
    """Kept factors of the "nan" rule (the tiled factor's model: a failed
    pivot leaves NaN from that column on and a NaN diagonal) with failed
    pivots in the first 64-row block (system 1), a middle one (system 2,
    where M > 128) and the last (system 3): NaN on exactly the systems
    where chol_subst_reference gives it, the rest to rounding; and the
    guard rule's factors of the same systems finite where the plain
    version's are."""
    R, b = _hpd(5, M, seed=M + 4)
    R[1, 5, 5] = -1.0
    if M > 128:
        R[2, 64 + 17, 64 + 17] = -1.0
    R[3, M - 3, M - 3] = -1.0
    b2 = b * (0.5 + 1j)
    _, L, d = model.factor_solve(R, b, "nan")
    x = model.subst(L, d, b2)
    xr = chol.chol_subst_reference(_unpacked(L, d), b2)
    bad = torch.isnan(x).any(dim=1)
    assert torch.equal(bad, torch.isnan(xr).any(dim=1))
    assert bad.tolist() == [False, True, M > 128, True, False]
    assert torch.isnan(x[bad]).all()
    assert _rel(x[~bad], xr[~bad]) < 1e-12
    _, L, d = model.factor_solve(R, b, "guard")
    x = model.subst(L, d, b2)
    xr = chol.chol_subst_reference(_unpacked(L, d), b2)
    assert torch.equal(torch.isfinite(x), torch.isfinite(xr))


@pytest.mark.parametrize("M", ORDERS + (770, 1950, 6657))
@pytest.mark.parametrize("B", (1, 3, 65536))
def test_subst_plan_matches_the_schedule(M, B):
    """chol.subst_plan (the launcher's own schedule, chol_plan.h's
    subst_schedule built for the host) against the model's launches: two
    per 64 rows for each group of at most 65535 systems, and the forward
    and backward blocks over the call of B systems."""
    seq = model.subst_launch_blocks(M)
    assert len(seq) == 2 * -(-M // model.TILE)

    def blocks(kind):
        return B * sum(n for k, n in seq if k == kind)

    plan = chol.subst_plan(M, B)
    assert plan == (-(-B // 65535) * len(seq), blocks("forward"),
                    blocks("backward"))
    assert chol.subst_launches_per_call(M, "tiled", B) == plan.launches
    assert chol.subst_launches_per_call(M, "one_block", B) == 1
    # the backward launches are the tiled factor's own
    assert [n for k, n in seq if k == "backward"] == [
        n for k, n in model.launch_blocks(M) if k == "backward"]


@pytest.mark.parametrize("M", (1, 8, 33, 64, 65, 98, 126, 130, 194, 258,
                               514, 1950, 6146))
def test_subst_route_follows_the_measured_table(M):
    """chol.subst_path_for (chol_plan.h's subst_route through the host
    build), the table PERF.md measured: the one-block kernel at one row
    block (M <= 64), the tiled substitution at every larger M (the orders
    of every main-path shape and of the wide cells among them), whatever
    the type or the batch."""
    assert chol.subst_path_for(M) == ("one_block" if M <= 64 else "tiled")
    with pytest.raises(ValueError):
        chol.subst_path_for(0)