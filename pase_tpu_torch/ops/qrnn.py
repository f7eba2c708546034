"""QRNN (quasi-recurrent) pooling, plain PyTorch.

Window-2 QRNN semantics (torchqrnn, as wired by the reference
build_rnn_block):

  source_t = [x_t, x_{t-1}]            (x_{-1} = 0)
  (z, f, o) = split(W @ source_t + b)  (3 * hidden)
  z = tanh(z); f = sigmoid(f)
  c_t = f_t * z_t + (1 - f_t) * c_{t-1}     (ForgetMult)
  h_t = sigmoid(o_t) * c_t

These are the plain versions of the CUDA kernel in ``ops/cuda_qrnn.py``:
the CPU path of the encoder and the reference the kernel is held to on the
card. ``forget_mult`` steps sequentially over T in the JAX package's
algebra (a = 1-f, b = f*z, c0 folded into b_1).
"""

import torch
import torch.nn.functional as F


def forget_mult(f, z, c0=None):
    """ForgetMult: c_t = f_t * z_t + (1 - f_t) * c_{t-1}.

    Args:
      f, z: [B, T, H] gates/candidates.
      c0: optional [B, H] initial state.
    Returns: c [B, T, H].
    """
    a = 1.0 - f
    b = f * z
    if c0 is not None:
        # fold the initial state into the first step: c_1 = a_1*c0 + b_1
        b = torch.cat([(b[:, 0] + a[:, 0] * c0)[:, None], b[:, 1:]], dim=1)
    c = torch.zeros_like(b[:, 0])
    cs = []
    for t in range(b.shape[1]):
        c = a[:, t] * c + b[:, t]
        cs.append(c)
    return torch.stack(cs, dim=1)


def qrnn_pool(y, c0=None):
    """Full window-2 QRNN pooling given pre-activation gates.

    Args:
      y: [B, T, 3H] linear output over [x_t, x_{t-1}].
      c0: optional [B, H] initial state.
    Returns: (h [B, T, H], c_T [B, H]).
    """
    z, f, o = torch.chunk(y, 3, dim=-1)
    c = forget_mult(torch.sigmoid(f), torch.tanh(z), c0=c0)
    h = torch.sigmoid(o) * c
    return h, c[:, -1]


def shift_right(x, dim=1):
    """x_{t-1} with zero at t=0 (torchqrnn window-2 'Xm1') along ``dim``."""
    dim = dim % x.dim()
    pad = [0, 0] * (x.dim() - dim - 1) + [1, 0]
    return F.pad(x, pad).narrow(dim, 0, x.shape[dim])
