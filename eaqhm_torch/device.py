"""Where the port runs: CUDA unless the caller asks for the CPU.

Every entry point takes ``device=None``, which means CUDA and raises when
no CUDA device is present (the port never falls back to the CPU on its
own).  A tensor argument keeps its device unless ``device`` is given.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """device=None means CUDA; without CUDA that raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "eaqhm_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return device


def as_tensor(v, device=None) -> torch.Tensor:
    """v as a tensor: a tensor stays on its device unless ``device`` is
    given; numpy arrays (any strides) and sequences go to
    ``resolve_device(device)``, CUDA by default."""
    if isinstance(v, torch.Tensor):
        return v if device is None else v.to(resolve_device(device))
    return torch.as_tensor(np.ascontiguousarray(v),
                           device=resolve_device(device))
