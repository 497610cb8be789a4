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
