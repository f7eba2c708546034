"""Mixed-precision policy.

The port of ``pase_tpu/precision.py``. Under ``compute_dtype(torch.bfloat16)``
every convolution and matmul site of the model runs in bfloat16 with
float32 accumulation; parameters, gradients, the optimizer state,
BatchNorm statistics and every loss reduction stay float32.

The cast points are written out at each site (``nn.conv1d``,
``nn.BatchNorm1d``, ``nn.PReLU``, the QRNN's linear, ``nn.Deconv1D``,
``losses.framed_mse_linear``, the gammatone target and the target cast
of ``data/pipeline.py``), where the JAX package has them. ``torch.autocast``
is not used: its op lists pick other ops and other output types than the
JAX policy does.
"""

from contextlib import contextmanager

import torch

_COMPUTE_DTYPE = None


def full_precision():
    """Float32 at full precision: no TF32 in matmuls, convolutions or
    cuDNN's recurrences (``cudnn.allow_tf32`` covers its LSTM / GRU), as
    the JAX package serves at 'highest'."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def set_compute_dtype(dtype):
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype


def get_compute_dtype():
    return _COMPUTE_DTYPE


@contextmanager
def compute_dtype(dtype):
    global _COMPUTE_DTYPE
    prev = _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        _COMPUTE_DTYPE = prev


def resolve(name):
    """A cfg / CLI name -> None (float32) or ``torch.bfloat16``."""
    if name in (None, "float32", "f32"):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"Unknown compute_dtype {name!r}: "
                     "expected 'float32'/'f32' or 'bfloat16'/'bf16'")
