"""QRNN (quasi-recurrent) pooling, plain PyTorch.

Window-2 QRNN semantics (torchqrnn, as wired by the reference
build_rnn_block):

  source_t = [x_t, x_{t-1}]            (x_{-1} = 0)
  (z, f, o) = split(W @ source_t + b)  (3 * hidden)
  z = tanh(z); f = sigmoid(f)
  c_t = f_t * z_t + (1 - f_t) * c_{t-1}     (ForgetMult)
  h_t = sigmoid(o_t) * c_t

These are the plain versions of the CUDA kernels in ``ops/cuda_qrnn.py``:
the CPU path of the encoder and the reference the kernels are held to on
the card (``qrnn_pool_chunked_plain`` repeats the chunked kernel's algebra,
for tests). ``forget_mult`` steps sequentially over T in the JAX package's
algebra (a = 1-f, b = f*z, c0 folded into b_1); ``qrnn_pool_bwd`` is the
reverse-time scan of its gradient (the VJP of
``pase_tpu/ops/pallas_qrnn.py``), with the gate derivatives applied.
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


def qrnn_pool_fwd_train(y, c0=None):
    """QRNN pooling that also returns every state: y [B, T, 3H] (+ c0
    [B, H]) -> (h [B, T, H], c [B, T, H]). c is the residual that
    ``qrnn_pool_bwd`` needs."""
    z, f, o = torch.chunk(y, 3, dim=-1)
    c = forget_mult(torch.sigmoid(f), torch.tanh(z), c0=c0)
    return torch.sigmoid(o) * c, c


def qrnn_pool(y, c0=None):
    """Full window-2 QRNN pooling given pre-activation gates.

    Args:
      y: [B, T, 3H] linear output over [x_t, x_{t-1}].
      c0: optional [B, H] initial state.
    Returns: (h [B, T, H], c_T [B, H]).
    """
    h, c = qrnn_pool_fwd_train(y, c0)
    return h, c[:, -1]


def qrnn_pool_chunked_plain(y, c0=None, chunk=8, chunks=64):
    """The chunked serving kernel's algebra (``qrnn_pool_fwd_chunked``),
    for tests: the same function as ``qrnn_pool``. T is walked in segments
    of ``chunks`` chunks of ``chunk`` steps, each seeded with the last
    one's c_T: (1) every chunk's map c -> A c + B from c = 0; (2) the carry
    into each chunk, the segment's carry put through the composed maps of
    the chunks before it; (3) each chunk re-run from its carry.
    Returns (h [B, T, H], c_T [B, H])."""
    yz, yf, yo = torch.chunk(y, 3, dim=-1)
    f = torch.sigmoid(yf)
    a, b = 1.0 - f, f * torch.tanh(yz)
    bsz, t, hid = a.shape
    carry = torch.zeros_like(a[:, 0]) if c0 is None else c0
    seg = chunk * chunks
    parts = []
    for s0 in range(0, t, seg):
        n = min(seg, t - s0)
        nc = -(-n // chunk)
        pad = (0, 0, 0, nc * chunk - n)     # steps past T: the identity
        aa = F.pad(a[:, s0:s0 + n], pad, value=1.0).reshape(
            bsz, nc, chunk, hid)
        bb = F.pad(b[:, s0:s0 + n], pad).reshape(bsz, nc, chunk, hid)
        ma, mb = torch.ones_like(aa[:, :, 0]), torch.zeros_like(aa[:, :, 0])
        for u in range(chunk):
            mb = aa[:, :, u] * mb + bb[:, :, u]
            ma = ma * aa[:, :, u]
        pa, pb = torch.ones_like(carry), torch.zeros_like(carry)
        cin = []
        for k in range(nc):
            cin.append(pa * carry + pb)
            pb = ma[:, k] * pb + mb[:, k]
            pa = pa * ma[:, k]
        c = torch.stack(cin, dim=1)
        cs = []
        for u in range(chunk):
            c = aa[:, :, u] * c + bb[:, :, u]
            cs.append(c)
        c = torch.stack(cs, dim=2).reshape(bsz, nc * chunk, hid)[:, :n]
        parts.append(c)
        carry = c[:, -1]
    c = torch.cat(parts, dim=1)
    return torch.sigmoid(yo) * c, c[:, -1]


def qrnn_pool_bwd(y, c, dh, dc_last=None, c0=None):
    """Gradient of ``qrnn_pool`` by a reverse loop over T.

    With a = 1 - f and s = sigmoid(o):
      g_t  = dh_t s_t + a_{t+1} g_{t+1}      (g_{T-1} also takes dc_T)
      dy_z = g f (1 - z^2);  dy_f = g (z - c_{t-1}) f (1 - f)
      dy_o = dh c s (1 - s); dc0 = a_0 g_0   (c_{-1} = c0 or 0)

    Args:
      y: [B, T, 3H] pre-activation gates; c: [B, T, H] forward states;
      dh: [B, T, H]; dc_last: optional [B, H] gradient of c_T;
      c0: optional [B, H] initial state.
    Returns: (dy [B, T, 3H], dc0 [B, H] or None when c0 is None).
    """
    yz, yf, yo = torch.chunk(y, 3, dim=-1)
    z, f, s = torch.tanh(yz), torch.sigmoid(yf), torch.sigmoid(yo)
    a = 1.0 - f
    first = torch.zeros_like(c[:, 0]) if c0 is None else c0
    c_prev = torch.cat([first[:, None], c[:, :-1]], dim=1)
    g = torch.zeros_like(c[:, 0]) if dc_last is None else dc_last
    a_next = torch.ones_like(a[:, 0])
    gs = []
    for t in range(y.shape[1] - 1, -1, -1):
        g = dh[:, t] * s[:, t] + a_next * g
        gs.append(g)
        a_next = a[:, t]
    g = torch.stack(gs[::-1], dim=1)
    dy = torch.cat([g * f * (1.0 - z * z), g * (z - c_prev) * f * a,
                    dh * c * s * (1.0 - s)], dim=-1)
    return dy, (None if c0 is None else a[:, 0] * g[:, 0])


def shift_right(x, dim=1):
    """x_{t-1} with zero at t=0 (torchqrnn window-2 'Xm1') along ``dim``."""
    dim = dim % x.dim()
    pad = [0, 0] * (x.dim() - dim - 1) + [1, 0]
    return F.pad(x, pad).narrow(dim, 0, x.shape[dim])
