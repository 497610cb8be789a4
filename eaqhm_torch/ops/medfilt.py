"""Edge-replicated median filter (reference misc.py:184-206 semantics).

The reference materializes an L x p toeplitz matrix and applies Python's
``statistics.median`` row-wise; semantically this is an order-p median
filter with edge replication.  Here: pad-replicate, take p-wide windows
(``unfold``) and the median along the window axis, on the tensor's device.
"""
from __future__ import annotations

import torch

from eaqhm_torch.device import as_tensor


def medfilt(x, p: int, device=None):
    """Median filter of odd order p with edge replication, along the last
    axis.  x: a tensor (kept on its device unless ``device`` is given) or
    array-like (sent to ``device``; None means CUDA)."""
    if p % 2 != 1:
        raise ValueError("order must be odd")
    x = as_tensor(x, device)
    ad = (p - 1) // 2
    if ad == 0:
        return x
    xp = torch.cat([x[..., :1].expand(*x.shape[:-1], ad), x,
                    x[..., -1:].expand(*x.shape[:-1], ad)], dim=-1)
    return xp.unfold(-1, p, 1).median(dim=-1).values
