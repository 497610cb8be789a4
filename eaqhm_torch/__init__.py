"""eaqhm_torch: eaQHM speech analysis and synthesis in PyTorch for NVIDIA
Hopper GPUs.

A port of the JAX package ``eaqhm_tpu`` (which stays the reference): SWIPE'
pitch, host VAD and frame geometry, per-frame quasi-harmonic least-squares
fits solved by a hand-written CUDA Cholesky kernel, AM/FM/phase track
interpolation, resynthesis, and SRER-driven adaptation until convergence
(reference entry point functions.py:35-418).

Public API
----------
analyze(signal, fs, config, device=None)         one utterance
eaqhm_analysis_and_synthesis(path, gender, ..., device=None)
EaqhmConfig, config_from_dict, gender_pitch_limits
Deterministic, Frame                             reference record types
python -m eaqhm_torch.cli                        command line

``device=None`` means CUDA and raises when no CUDA device is present.
"""
from eaqhm_torch.config import (EaqhmConfig, config_from_dict,
                                gender_pitch_limits)
from eaqhm_torch.models.engine import (EaqhmResult, analyze,
                                       eaqhm_analysis_and_synthesis)
from eaqhm_torch.structs import Deterministic, Frame

__all__ = ["Deterministic", "EaqhmConfig", "EaqhmResult", "Frame",
           "analyze", "config_from_dict", "eaqhm_analysis_and_synthesis",
           "gender_pitch_limits"]
