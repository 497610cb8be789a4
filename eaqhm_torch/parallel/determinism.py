"""Deterministic-reduction policy for reproducible corpus statistics
(eaqhm_tpu/parallel/determinism.py).

The reference is single-threaded NumPy, so every SRER sum reproduces
trivially.  The port reduces SRER statistics with collectives over a
process group and runs its sums in CUDA kernels, where reproducibility has
to be a stated policy:

- Within a fixed mesh shape, NCCL and gloo collectives combine in a fixed
  order, and after ``apply()`` every PyTorch op the port runs either has a
  deterministic algorithm or raises (the port avoids the ones that raise:
  ``ops.scan.cumsum`` stands in for the CUDA cumsum).  Two runs of the same
  program on the same mesh then give bit-identical SRER arrays.
- Across mesh shapes the order of float additions differs: no bitwise
  equality is claimed there, only the tolerance of the parity tests.
- cuBLAS picks its reduction split by workspace: ``CUBLAS_WORKSPACE_CONFIG``
  pins it, and TF32 stays off so float32 products keep full precision.
"""
from __future__ import annotations

import os

import torch

CUBLAS_WORKSPACE = ":4096:8"


def apply(matmul_precision: str = "highest") -> dict:
    """Pin the deterministic policy for this process; returns the applied
    settings (for logging).

    Sets ``torch.use_deterministic_algorithms(True)`` (ops without a
    deterministic form raise, none is let through with a warning),
    ``CUBLAS_WORKSPACE_CONFIG``, cuDNN deterministic and not benchmarking,
    TF32 off, and ``torch.set_float32_matmul_precision``.  The cuBLAS
    setting takes effect only for cuBLAS handles created after it: call
    ``apply`` before the process's first CUDA matmul.  The settings are
    process-wide.
    """
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision(matmul_precision)
    return {
        "deterministic_algorithms":
            torch.are_deterministic_algorithms_enabled(),
        "cublas_workspace_config": os.environ["CUBLAS_WORKSPACE_CONFIG"],
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "matmul_precision": torch.get_float32_matmul_precision(),
    }
