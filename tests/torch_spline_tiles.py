"""A NumPy model of track_spline's tiling (kernels/csrc/tracks.cu
spline_tiles and spline_apply): each column's anchors cut into tiles of R,
each tile walked with the entering value 0 and summarized by its forward
map and its backward map, then each tile's entering dp and the M after it
summed over the neighbouring tiles' maps, nearest first, until the product
of the maps falls below 2^-100, and the runs' ends written by the tile
that holds the values they read.  The CPU tests hold it to the plain spline
(ops.tracks.spline_reference) at tile lengths that cut runs in several
places; it runs the kernels' arithmetic in the kernels' order, one column
at a time, so it is for small grids only."""
import numpy as np

CPLEN, KNOWN, START, END = 48, 60, 61, 62
TINY = 2.0 ** -100          # where a sum over tiles' maps stops


def _tables(h, dt):
    ctab = np.zeros(CPLEN + 1)
    for k in range(1, CPLEN + 1):
        ctab[k] = 1.0 / (4.0 - ctab[k - 1])
    ctab = ctab.astype(dt)
    cp_prev = np.concatenate([ctab[:1], ctab[:-1]])
    g = dt(4) - cp_prev
    return ctab, dt(-1) / g, dt(h) * g


def _codes(acc):
    """The kernel's codes of one column: 1..48 an unknown interior anchor
    (its position, clamped), KNOWN, START, END, 0 elsewhere."""
    n = len(acc)
    w = np.concatenate([[False, False], acc, [False, False]])
    code = np.zeros(n, np.uint8)
    last = -1
    for s in range(n):
        a0, a1, a2, a3, a4 = w[s:s + 5]
        c = 0
        if a2 and a1 and a3:
            c = min(s - last, CPLEN) if (a0 and a4) else KNOWN
        elif a2 and not a1 and a3:
            c = START
        elif a2 and a1 and not a3:
            c = END
        if not 1 <= c <= CPLEN:
            last = s
        code[s] = c
    return code


def spline_column(acc, y, h, R):
    """M of one column (acc: accepted flags, y: values) by tiles of R."""
    dt = y.dtype.type
    n = len(y)
    ctab, tabA, tabHG = _tables(h, dt)
    six_h, known_div = dt(6.0 / h), dt(6.0 * h)
    code = _codes(acc)
    yp = np.concatenate([[dt(0)], y[:-1]])
    yn = np.concatenate([y[1:], [dt(0)]])
    un = (code >= 1) & (code <= CPLEN)
    interior = (code != 0) & (code <= KNOWN)
    T = -(-n // R)
    M = np.zeros(n, y.dtype)
    agg = np.zeros((5, T), y.dtype)
    for t in range(T):                        # spline_tiles
        dp, alpha, A, B0, B1 = dt(0), dt(1), dt(1), dt(0), dt(0)
        for s in range(t * R, min(n, t * R + R)):
            c = code[s]
            am_, b_ = dt(0), dt(0)
            if interior[s]:
                d = six_h * ((yn[s] - dt(2) * y[s]) + yp[s])
                if c == KNOWN:
                    b_ = d / known_div
                else:
                    am_, b_ = tabA[c], d / tabHG[c]
            dp = am_ * dp + b_ if un[s] else b_
            alpha = am_ * alpha if un[s] else dt(0)
            M[s] = dp
            B0 = A * (dp if interior[s] else dt(0)) + B0
            B1 = A * (alpha if interior[s] else dt(0)) + B1
            A = A * (-ctab[c] if un[s] else dt(0))
        agg[:, t] = alpha, dp, A, B0, B1
    Af, Bf, Ab, B0, B1 = agg

    def dp_in_of(u):
        total, P = dt(0), dt(1)
        for w in range(u - 1, -1, -1):
            total = total + P * Bf[w]
            P = P * Af[w]
            if abs(P) < TINY:
                break
        return total
    out = M.copy()
    for t in range(T):                        # spline_apply
        din = dp_in_of(t)
        Min, P = dt(0), dt(1)
        for u in range(t + 1, T):
            cu = B0[u] + B1[u] * dp_in_of(u) if B1[u] != 0 else B0[u]
            Min = Min + P * cu
            P = P * Ab[u]
            if abs(P) < TINY:
                break
        s0, s1 = t * R, min(n, t * R + R)
        dp = M[s0:s1].copy()
        if din != 0:
            al = dt(1)
            for i, s in enumerate(range(s0, s1)):
                if not un[s]:
                    break
                al = tabA[code[s]] * al
                if al == 0:
                    break
                dp[i] = dp[i] + al * din

        def code_at(s):
            return code[s] if s < n else 0
        c1, c2 = code_at(s1), code_at(s1 + 1)
        nxt = Min
        p1 = Min if (c1 != 0 and c1 <= KNOWN) else dt(0)
        p2 = dt(0)
        for s in range(s1 - 1, s0 - 1, -1):
            c = code[s]
            if un[s]:
                v = -ctab[c] * nxt + dp[s - s0]
            elif c == KNOWN:
                v = dp[s - s0]
            else:
                v = dt(0)
            p0 = v if interior[s] else dt(0)
            if c == START:
                if s < s1 - 1:
                    out[s] = dt(2) * p1 - p2
            elif c != END:
                out[s] = v
            if c2 == END:
                out[s + 2] = dt(2) * p1 - p0
            p2, p1, c2, c1, nxt = p1, p0, c1, c, v
        if s0 > 0 and code[s0 - 1] == START:
            out[s0 - 1] = dt(2) * p1 - p2
        if s0 == 0 and c2 == END:
            out[1] = dt(2) * p1 - dt(0)
    return out


def spline_by_tiles(am, fm, a0, h, R, acc=None, voiced=None):
    """M [n, G*K + G] of a dense grid (numpy am, fm [G, n, K], a0 [G, n])
    as the kernels compute it with tiles of R anchors."""
    G, n, K = am.shape
    keep = np.ones_like(am, bool) if acc is None else acc
    amv = np.where(keep, am, 0)
    fmv = np.where(keep, fm, 0)
    a0v = a0 if voiced is None else np.where(voiced, a0, 0)
    cols = [spline_column(amv[g, :, k] != 0, fmv[g, :, k], h, R)
            for g in range(G) for k in range(K)]
    cols += [spline_column(np.ones(n, bool), a0v[g], h, R) for g in range(G)]
    return np.stack(cols, axis=1)
