"""pase_tpu_torch: the PASE / PASE+ encoder in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of ``pase_tpu`` (JAX), which stays the reference it is tested
against. This package imports torch and numpy only, never JAX.
"""

from pase_tpu_torch.frontend import Encoder, WaveFe, wf_builder

__all__ = ["Encoder", "WaveFe", "wf_builder"]
