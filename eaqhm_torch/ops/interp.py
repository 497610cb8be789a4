"""Interpolation ops: linear lerp and not-a-knot cubic splines (batched).

The reference leans on ``scipy.interpolate.interp1d``: linear for AM tracks
(functions.py:364) and ``kind=3`` for FM tracks and the DC track
(functions.py:340,367-371).  ``interp1d(kind=3)`` is the not-a-knot cubic
spline, with ``fill_value='extrapolate'`` evaluating the end polynomials
outside the range; here it is in second-derivative (M) form.
"""
from __future__ import annotations

import torch


def lerp(xp, fp, x):
    """Piecewise-linear interpolation, batched over leading dims of fp.

    xp: [m] sorted anchor positions; fp: [..., m] values; x: [q] queries.
    Out-of-range queries extrapolate with the end segments.
    """
    i = (torch.searchsorted(xp, x, right=True) - 1).clamp(0, xp.shape[0] - 2)
    x0 = xp[i]
    x1 = xp[i + 1]
    g = (x - x0) / (x1 - x0)
    return fp[..., i] * (1.0 - g) + fp[..., i + 1] * g


def notaknot_M(x, y):
    """Second derivatives M of the not-a-knot cubic spline through (x, y).

    x: [m] sorted anchors (m >= 4; m == 4 is the single interpolating
    cubic, as scipy's); y: [..., m] batched values.  Returns M: [..., m].
    The tridiagonal system of the interior M_1..M_{m-2}, with the not-a-knot
    conditions eliminated into its first and last rows, is solved by a
    Thomas sweep over the anchors (vectorized over the batch); M_0 and
    M_{m-1} follow by linear extrapolation.
    """
    h = torch.diff(x)                                    # [m-1]
    dy = torch.diff(y, dim=-1) / h                       # [..., m-1]
    d = 6.0 * (dy[..., 1:] - dy[..., :-1])               # [..., m-2]
    n = x.shape[-1] - 2
    sub = h[:-1].clone()
    diag = 2.0 * (h[:-1] + h[1:])
    sup = h[1:].clone()
    h0, h1, hm2, hm3 = h[0], h[1], h[-1], h[-2]
    diag[0] = h0 * (h0 + h1) / h1 + 2.0 * (h0 + h1)
    sup[0] = h1 - h0 * h0 / h1
    diag[-1] = 2.0 * (hm3 + hm2) + hm2 * (hm3 + hm2) / hm3
    sub[-1] = hm3 - hm2 * hm2 / hm3
    cp, dp = [], []
    cp_prev = torch.zeros((), dtype=d.dtype, device=d.device)
    dp_prev = torch.zeros_like(d[..., 0])
    for i in range(n):
        a_i = sub[i] if i > 0 else torch.zeros_like(cp_prev)
        den = diag[i] - a_i * cp_prev
        cp_prev = sup[i] / den
        dp_prev = (d[..., i] - a_i * dp_prev) / den
        cp.append(cp_prev)
        dp.append(dp_prev)
    v = torch.zeros_like(dp_prev)
    Mint = [None] * n
    for i in reversed(range(n)):
        v = dp[i] - cp[i] * v
        Mint[i] = v
    Mint = torch.stack(Mint, dim=-1)                     # M_1..M_{m-2}
    M0 = ((h0 + h1) * Mint[..., 0] - h0 * Mint[..., 1]) / h1
    Mm1 = ((hm3 + hm2) * Mint[..., -1] - hm2 * Mint[..., -2]) / hm3
    return torch.cat([M0[..., None], Mint, Mm1[..., None]], dim=-1)


def spline_eval(x, y, M, q):
    """Evaluate the M-form cubic spline at queries q (extrapolates ends).

    x: [m]; y, M: [..., m]; q: [qn].  Returns [..., qn].
    """
    i = (torch.searchsorted(x, q, right=True) - 1).clamp(0, x.shape[0] - 2)
    h = x[i + 1] - x[i]
    A = (x[i + 1] - q) / h
    B = (q - x[i]) / h
    return (A * y[..., i] + B * y[..., i + 1]
            + ((A ** 3 - A) * M[..., i] + (B ** 3 - B) * M[..., i + 1])
            * (h * h) / 6.0)


def notaknot_interp(x, y, q):
    """``interp1d(x, y, kind=3, fill_value='extrapolate')(q)``: the
    not-a-knot spline through (x, y) at q.  x: [m]; y: [..., m]; q: [qn]."""
    return spline_eval(x, y, notaknot_M(x, y), q)


def cubic4_eval(x4, y4, q):
    """Exact cubic through 4 points, batched: the synthetic-anchor path for
    runs shorter than 4 anchors (functions.py:366-371, misc.py:14).

    x4: [..., 4]; y4: [..., 4]; q: [..., qn].  Returns [..., qn].  Direct
    Lagrange evaluation on abscissae normalized by the cluster spacing (the
    node sets [0, s, s+1, s+2] are extremely clustered, where a Vandermonde
    solve is ill-conditioned).
    """
    x1 = x4[..., 1:2]
    scale = (x4[..., 3:4] - x4[..., 1:2]).abs().clamp(min=1e-30)
    xn = (x4 - x1) / scale
    qn = (q - x1) / scale
    out = torch.zeros(torch.broadcast_shapes(qn.shape, y4[..., :1].shape),
                      dtype=y4.dtype, device=y4.device)
    for j in range(4):
        num = torch.ones_like(qn)
        den = torch.ones_like(x4[..., 0:1])
        for m in range(4):
            if m == j:
                continue
            num = num * (qn - xn[..., m:m + 1])
            den = den * (xn[..., j:j + 1] - xn[..., m:m + 1])
        out = out + y4[..., j:j + 1] * (num / den)
    return out


def notaknot_interp_uniform(yv, step: int, length: int):
    """Not-a-knot cubic spline through uniformly spaced anchors, evaluated
    at every integer sample 0..length-1 (extrapolating past the last anchor
    with the end cubic): the DC-track interpolation (reference
    functions.py:340, interp1d kind=3 over the analysis grid).

    yv: [n] anchor values at samples 0, step, 2*step, ...; returns
    [length].  yv [n, C] interpolates C independent columns at once and
    returns [length, C].  On a CUDA tensor the tracks kernels
    (``ops.tracks.stage`` with the columns as DC tracks and no harmonic),
    on a CPU tensor the plain version.
    """
    if yv.dim() == 1:
        return notaknot_interp_uniform(yv[:, None], step, length)[:, 0]
    if yv.device.type == "cpu":
        return notaknot_interp_uniform_reference(yv, step, length)
    from eaqhm_torch.ops import tracks
    none = yv.new_zeros((yv.shape[1], yv.shape[0], 0))
    return tracks.stage(none, none, none, yv.T, step, 1.0, length,
                        dc="apart", anchors=False).a0.T


def notaknot_interp_uniform_reference(yv, step: int, length: int):
    """The plain version of ``notaknot_interp_uniform`` (yv [n, C]): the
    segmented not-a-knot solve of models.tracks over one run, then the
    cubic of each segment at its samples."""
    from eaqhm_torch.models.tracks import _segmented_notaknot_M

    dtype = yv.dtype
    dev = yv.device
    n, C = yv.shape
    h = float(step)
    in_run = torch.ones((n, C), dtype=torch.bool, device=dev)
    start = torch.zeros((n, C), dtype=torch.long, device=dev)
    end = torch.full((n, C), n - 1, dtype=torch.long, device=dev)
    M = _segmented_notaknot_M(yv, in_run, start, end, h)

    r = torch.arange(step, dtype=dtype, device=dev)[None, :, None]
    B = r / h                                             # [1, step, 1]
    A = 1.0 - B
    ys = yv[:n - 1][:, None]
    ye = yv[1:][:, None]
    Ms = M[:n - 1][:, None]
    Me = M[1:][:, None]
    seg = (A * ys + B * ye
           + ((A ** 3 - A) * Ms + (B ** 3 - B) * Me) * (h * h) / 6.0)
    main = seg.reshape(-1, C)                             # [(n-1)*step, C]
    ncov = (n - 1) * step
    if length <= ncov:
        return main[:length]
    # tail: continue the last segment's cubic (extrapolation)
    rt = torch.arange(step, step + (length - ncov), dtype=dtype,
                      device=dev)[:, None]
    Bt = rt / h
    At = 1.0 - Bt
    tail = (At * yv[n - 2] + Bt * yv[n - 1]
            + ((At ** 3 - At) * M[n - 2]
               + (Bt ** 3 - Bt) * M[n - 1]) * (h * h) / 6.0)
    return torch.cat([main, tail])
