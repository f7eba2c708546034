"""Time-axis padding helpers for NCT ([batch, channels, time]) tensors.

Same padding rules as ``pase_tpu.ops.pad`` (the reference conv blocks'
asymmetric (k//2-1, k//2) pads whenever stride>1 or kwidth is even); the
pads themselves go through ``F.pad`` on the last axis.
"""

import torch.nn.functional as F

_MODES = {"reflect": "reflect", "constant": "constant",
          "replicate": "replicate", "edge": "replicate"}


def pad_1d(x, pad, mode="reflect"):
    """Pad the time axis (last axis) of a [B, C, T] tensor.

    Args:
      x: [B, C, T] tensor.
      pad: (left, right) tuple of ints.
      mode: 'reflect' | 'constant' | 'replicate' ('edge' is an alias).
    """
    left, right = pad
    if left == 0 and right == 0:
        return x
    return F.pad(x, (left, right), mode=_MODES[mode])


def feblock_pad(kwidth, stride, dilation=1):
    """(left, right) pad of the reference FeBlock conv."""
    if kwidth <= 1:
        return (0, 0)
    if stride > 1 or kwidth % 2 == 0:
        if dilation > 1:
            raise ValueError("Cannot make dilated convolution with stride > 1")
        return (kwidth // 2 - 1, kwidth // 2)
    p = (kwidth // 2) * (dilation - 1) + (kwidth // 2)
    return (p, p)


def sinc_same_pad(kernel_size, stride):
    """(left, right) pad of the reference SincConv_fast SAME padding."""
    if stride > 1:
        return (kernel_size // 2 - 1, kernel_size // 2)
    return (kernel_size // 2, kernel_size // 2)
