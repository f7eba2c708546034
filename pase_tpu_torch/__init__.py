"""pase_tpu_torch: the PASE / PASE+ encoder in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of ``pase_tpu`` (JAX), which stays the reference it is tested
against. This package imports torch and numpy only, never JAX.

``Encoder``, ``WaveFe`` and ``wf_builder`` are imported from
``pase_tpu_torch.frontend`` at first use, so that a process can import
``pase_tpu_torch.ops.cuda_qrnn`` (which registers the QRNN operator that
an exported serving program calls) without the model code.
"""

__all__ = ["Encoder", "WaveFe", "wf_builder"]


def __getattr__(name):
    if name in __all__:
        from pase_tpu_torch import frontend
        return getattr(frontend, name)
    raise AttributeError(f"module 'pase_tpu_torch' has no attribute {name!r}")
