"""A float64 PyTorch model of the Cholesky kernel's tiled path
(eaqhm_torch/kernels/csrc/chol_solve.cu, chol_tiled_diag0 /
chol_tiled_panel / chol_tiled_update / chol_tiled_backward), in its panel
width, its steps and its order of accumulation: per panel of 64 columns,
the diagonal block and the rows below it factored in steps of 16 columns
(the sub-block's pivots column by column, each entry's products subtracted
in column order, the panel's columns right of the step updated by a 16-term
sum subtracted at once), y1 solved column by column; the panels in pairs,
the first column of tiles right of panel p updated by a 64-term sum, the
rest right of panels p and p + 1 by one 128-term sum (a last lone panel by
a 64-term sum), each subtracted at once, and y2 -= L21 y1 term by term in
column order; the backward substitution per 64-row block, each chunk's sum
over the next block's rows taken in four row groups (rows j = g mod 4)
subtracted in group order, the diagonal block solved from its last row.
The tile split of the trailing update does not enter: every entry of a
tile is its own sum.  Vectorised over the batch and over the entries of a
step; the CPU tests hold it against ``ops.chol``'s plain versions.

``subst`` models the tiled substitution with a kept factor
(chol_subst_forward, then chol_tiled_backward on the kept factor) the same
way: the forward sweep per 64-row block u, each row of the tiles below it
taking L[t, u - 1] y_{u - 1} as the kernel sums it (lane l's two products,
columns l and l + 32, then the 32 lane sums by a butterfly: halves added
16, 8, 4, 2, 1 apart) subtracted at once, block u's diagonal block solved
column by column with the kept diagonal's reciprocals; then the backward
sweep of ``factor_solve`` with the kept diagonal.
"""
import torch

TILE = 64          # panel width and tile edge
STEP = 16          # the in-panel step
GROUPS = 4         # row groups of a backward chunk's sum
GUARD = 1e-30


def _rd(piv: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "nan":
        return torch.rsqrt(piv)
    return torch.rsqrt(torch.where(piv < GUARD, torch.full_like(piv, GUARD),
                                   piv))


def _panel(W: torch.Tensor, jb: int, mode: str) -> None:
    """Factor the panel W [B, n, jb] (rows j0.., columns j0..j0+jb) in place:
    its first jb rows are the diagonal block (lower triangle read)."""
    for c0 in range(0, jb, STEP):
        sb = min(STEP, jb - c0)
        for c in range(c0, c0 + sb):
            col = W[:, c:, c].clone()
            for k in range(c0, c):          # the step's earlier columns
                col = col - W[:, c:, k] * W[:, c, k].conj()[:, None]
            piv = col[:, 0].real
            rd = _rd(piv, mode)
            col = col * rd[:, None]
            col[:, 0] = (piv * rd).to(W.dtype)
            W[:, c:, c] = col
        right = slice(c0 + sb, jb)
        if c0 + sb < jb:                    # the panel's columns right of it
            acc = torch.zeros_like(W[:, c0 + sb:, right])
            for k in range(c0, c0 + sb):
                acc = acc + (W[:, c0 + sb:, k, None]
                             * W[:, right, k].conj()[:, None, :])
            W[:, c0 + sb:, right] -= acc


def factor_solve(R: torch.Tensor, b: torch.Tensor, mode: str = "nan"):
    """(x [B, M], L full lower [B, M, M], d [B, M]) as the tiled path
    computes them; R [B, M, M] complex128 (lower triangle read)."""
    A = torch.tril(R).clone()
    B, M = b.shape
    y = b.clone()
    nb = -(-M // TILE)

    def panel(j0):
        """Factor the panel at column j0 (its diagonal block and the rows
        below it) and solve y1 = L11^-1 y1, column by column."""
        jb = min(TILE, M - j0)
        W = A[:, j0:, j0:j0 + jb].clone()
        _panel(W, jb, mode)
        W[:, :jb] = torch.tril(W[:, :jb])
        A[:, j0:, j0:j0 + jb] = W
        L11 = W[:, :jb]
        v = y[:, j0:j0 + jb].clone()
        for c in range(jb):
            v[:, c] = v[:, c] * (1.0 / L11[:, c, c].real)
            v[:, c + 1:] = v[:, c + 1:] - L11[:, c + 1:, c] * v[:, c, None]
        y[:, j0:j0 + jb] = v

    def update(j0, depth, c0, c1, r1):
        """The trailing update of rows >= c0, columns c0..c1 - 1 (lower
        part) with the panel columns j0..j0 + depth - 1: a depth-term sum
        subtracted at once; y of rows c0..r1 - 1 term by term."""
        Li = A[:, c0:, j0:j0 + depth]
        Lk = A[:, c0:c1, j0:j0 + depth]
        acc = torch.zeros_like(A[:, c0:, c0:c1])
        for c in range(depth):
            acc = acc + Li[:, :, c, None] * Lk[:, None, :, c].conj()
        A[:, c0:, c0:c1] -= torch.tril(acc)
        r = y[:, c0:r1].clone()
        for c in range(depth):
            r = r - A[:, c0:r1, j0 + c] * y[:, j0 + c, None]
        y[:, c0:r1] = r

    p = 0
    panel(0)
    while p + 1 < nb:
        j0 = TILE * p
        if p + 2 < nb:           # panels p, p + 1 update the rest together
            j1, j2 = j0 + TILE, j0 + 2 * TILE
            update(j0, TILE, j1, j2, j2)
            panel(j1)
            update(j0, 2 * TILE, j2, M, M)
            panel(j2)
            p += 2
        else:
            update(j0, TILE, j0 + TILE, M, M)
            panel(j0 + TILE)
            p += 1
    L = A
    d = torch.diagonal(L, dim1=-2, dim2=-1).real.clone()
    x = _backward(y, L, d)
    if mode == "nan":
        bad = torch.isnan(d).any(dim=1)
        x[bad] = complex(float("nan"), float("nan"))
        d[bad] = float("nan")
    return x, L, d


def _backward(x: torch.Tensor, L: torch.Tensor, d: torch.Tensor):
    """L^H x = y in place in x (y on entry): per 64-row block u from the
    last, each chunk's sum over block u + 1's rows in four row groups
    subtracted in group order, then block u's diagonal block from its last
    row, the reciprocals of d."""
    M = x.shape[1]
    nb = -(-M // TILE)
    for u in range(nb - 1, -1, -1):
        k0 = TILE * u
        if u + 1 < nb:                      # block u + 1's finished rows
            s0 = TILE * (u + 1)
            ns = min(TILE, M - s0)
            blk = L[:, s0:s0 + ns, :k0 + TILE]
            xs = x[:, s0:s0 + ns]
            parts = []
            for g in range(GROUPS):
                acc = torch.zeros_like(x[:, :k0 + TILE])
                for j in range(g, ns, GROUPS):
                    acc = acc + xs[:, j, None] * blk[:, j].conj()
                parts.append(acc)
            r = x[:, :k0 + TILE].clone()
            for g in range(GROUPS):
                r = r - parts[g]
            x[:, :k0 + TILE] = r
        nk = min(TILE, M - k0)
        v = x[:, k0:k0 + nk].clone()
        Ld = L[:, k0:k0 + nk, k0:k0 + nk]
        for r in range(nk - 1, -1, -1):
            v[:, r] = v[:, r] * (1.0 / d[:, k0 + r])
            v[:, :r] = v[:, :r] - v[:, r, None] * Ld[:, r, :r].conj()
        x[:, k0:k0 + nk] = v
    return x


def _lane_sum(p: torch.Tensor) -> torch.Tensor:
    """The kernel's sum of one row's 64 products p [.., 64]: lane l adds
    products l and l + 32, then a butterfly of shuffles adds the lane sums
    16, 8, 4, 2 and 1 lanes apart."""
    p = p[..., :32] + p[..., 32:]
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    return p[..., 0]


def subst(L: torch.Tensor, d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = (L L^H)^-1 b as the tiled substitution computes it, with the kept
    factor: L full lower [B, M, M] (its diagonal not read), d its real
    diagonal [B, M]; complex128."""
    B, M = b.shape
    nb = -(-M // TILE)
    y = b.clone()
    for u in range(nb):
        k0 = TILE * u
        if u > 0:                # every tile t >= u takes block u - 1
            c0 = k0 - TILE
            p = L[:, k0:, c0:k0] * y[:, None, c0:k0]
            y[:, k0:] = y[:, k0:] - _lane_sum(p)
        nk = min(TILE, M - k0)
        v = y[:, k0:k0 + nk].clone()
        for c in range(nk):
            v[:, c] = v[:, c] * (1.0 / d[:, k0 + c])
            v[:, c + 1:] = v[:, c + 1:] - L[:, k0 + c + 1:k0 + nk,
                                            k0 + c] * v[:, c, None]
        y[:, k0:k0 + nk] = v
    return _backward(y, L, d)


def subst_launch_blocks(M: int) -> list:
    """(kind, blocks) of each launch of one tiled substitution of one
    system: per 64-row block u a forward launch (the first block's alone,
    then the tiles t >= u), then per 64-row block from the last a backward
    launch of the chunks it takes."""
    n = -(-M // TILE)
    return ([("forward", 1)] + [("forward", n - u) for u in range(1, n)]
            + [("backward", u + 1) for u in range(n - 1, -1, -1)])


def launches(M: int) -> int:
    """Launches of one call: a panel and an update launch per 64 columns
    (none after the last panel), a backward launch per 64 rows."""
    n = -(-M // TILE)
    return 3 * n - 1


def launch_blocks(M: int) -> list:
    """(kind, blocks) of each launch of one call of one system, in the
    kernel's order, from the ranges ``factor_solve`` works on: the first
    diagonal block; per panel its 64-row tiles below the diagonal block;
    per update the 64 x 64 tiles of the lower triangle it changes; per
    backward launch the 64-column chunks it takes."""
    n = -(-M // TILE)

    def tiles(c0, c1):
        """Tiles of the lower part of rows >= c0, columns c0..c1 - 1."""
        return sum(n - k for k in range(c0 // TILE, -(-c1 // TILE)))

    out = [("diag0", 1)]
    p = 0
    while p + 1 < n:
        j0 = TILE * p
        out.append(("panel", n - p - 1))
        if p + 2 < n:
            out.append(("update", tiles(j0 + TILE, j0 + 2 * TILE)))
            out.append(("panel", n - p - 2))
            out.append(("update", tiles(j0 + 2 * TILE, M)))
            p += 2
        else:
            out.append(("update", tiles(j0 + TILE, M)))
            p += 1
    return out + [("backward", u + 1) for u in range(n - 1, -1, -1)]
