"""Worker losses: elementwise criteria and r-frame contextualized targets.

``contextualize_r`` frames the ground truth into r consecutive frames per
step, so a worker predicts a context window at once (r = 7 in
workers+.cfg), flattened d-major (channel c = d*r + j) like the
reference's ContextualizedLoss. ``framed_mse_linear`` is the r-framed MSE
of a linear head computed without its prediction, which for the PASE+
``lps`` heads would be a [B, T, 21525] tensor. Tensors here are NTC
([B, T, D]), as in ``pase_tpu/losses.py``.
"""

import numpy as np
import torch
import torch.nn.functional as F


def contextualize_r(gtruth, r):
    """[B, T, D] -> [B, T, D*r] framed targets (zero-padded edges)."""
    if r is None or r <= 1:
        return gtruth
    b, t, d = gtruth.shape
    pad = F.pad(gtruth, (0, 0, r // 2, r // 2))
    return pad.unfold(1, r, 1).reshape(b, t, d * r)     # [B, T, D, r]


def _shift_time(h, sh):
    """out[:, tau] = h[:, tau + sh], zero outside [0, T)."""
    if sh == 0:
        return h
    if sh > 0:
        return F.pad(h[:, sh:], (0, 0, 0, sh))
    return F.pad(h[:, :h.shape[1] + sh], (0, 0, -sh, 0))


_COUNTS = {}


def _window_counts(t, r, device):
    """[T] float32: in how many of the r-frame windows each target frame
    appears (zero padding at the edges); uploaded once per (T, r,
    device)."""
    key = (t, r, device)
    if key not in _COUNTS:
        pad_l = r // 2
        cnt = np.zeros(t, np.float32)
        for j in range(r):
            cnt[max(0, j - pad_l):min(t, t + j - pad_l)] += 1.0
        _COUNTS[key] = torch.as_tensor(cnt, device=device)
    return _COUNTS[key]


def framed_mse_linear(weight, bias, h, target, r):
    """r-framed MSE of a linear head WITHOUT materializing the prediction.

    Computes mean((h @ W + b - frame_r(target))^2), the composition of a
    kwidth-1 conv head with ``make_loss('MSELoss', r)``, through
    ||p||^2 - 2 <p, T_f> + ||T_f||^2:
      * ||p||^2 from the [H, H] Gram of h and the Gram of W;
      * <p, T_f> from r time-shifted [H, D] matmuls of [B, T, D] outputs;
      * ||T_f||^2 from per-frame window counts on the raw target.

    Args:
      weight: the head's conv weight [D*r, H, 1] (or a matrix [H, D*r]),
        d-major channel order.
      bias: [D*r] or None.
      h: [B, T, H] head input (the last hidden activation).
      target: [B, T, D] unframed ground truth.

    Under the compute-dtype policy W is cast to h's type (bf16 when h is)
    and every sum, cross term and bias term is float32, as in
    ``pase_tpu/losses.py``: the Grams take float32 copies of the bf16
    values, the r shifted products round to h's type before their sums.
    """
    kernel = weight[:, :, 0].t() if weight.dim() == 3 else weight
    rr = int(r) if r else 1
    b, t, hdim = h.shape
    d = kernel.shape[1] // rr
    pad_l = rr // 2
    w = kernel.reshape(hdim, d, rr)
    wc = w.to(h.dtype)
    hf, wcf, target = h.float(), wc.float(), target.float()
    n_elems = b * t * d * rr

    g = torch.einsum("bth,btk->hk", hf, hf)
    wg = torch.einsum("hdj,kdj->hk", wcf, wcf)
    p2 = torch.sum(g * wg)
    if bias is not None:
        hsum = torch.sum(hf, dim=(0, 1))
        p2 = p2 + 2.0 * torch.dot(hsum @ kernel, bias)
        p2 = p2 + b * t * torch.sum(bias * bias)

    # window t, offset j lands on target frame tau = t + j - pad_l (zero
    # outside [0, T), as contextualize_r pads), so
    # q_j[tau] = h[tau + sh] @ W_j with sh = pad_l - j
    cross = 0.0
    bmat = None if bias is None else bias.reshape(d, rr)
    for j in range(rr):
        qj = (_shift_time(h, pad_l - j) @ wc[:, :, j]).float()  # [B,T,D]
        cross = cross + torch.sum(qj * target)
        if bmat is not None:
            lo, hi = max(0, j - pad_l), min(t, t + j - pad_l)
            cross = cross + torch.dot(target[:, lo:hi].sum(dim=(0, 1)),
                                      bmat[:, j])

    t2 = torch.sum(_window_counts(t, rr, target.device)[None, :, None]
                   * target * target)
    return (p2 - 2.0 * cross + t2) / n_elems


def mse_loss(pred, target):
    return torch.mean(torch.square(pred - target))


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def bce_with_logits(pred, target):
    return torch.mean(torch.clamp(pred, min=0) - pred * target
                      + torch.log1p(torch.exp(-torch.abs(pred))))


_LOSSES = {
    "MSELoss": mse_loss,
    "L1Loss": l1_loss,
    "BCEWithLogitsLoss": bce_with_logits,
}


def make_loss(name, r=None):
    """Loss factory with the ContextualizedLoss wrapping: for r > 1 the
    [B, T, D] target is framed to [B, T, D*r] before the criterion."""
    if name not in _LOSSES:
        raise NotImplementedError(
            f"loss {name!r} is not ported yet: ROADMAP.md, queue 1: "
            "off-path model variants")
    base = _LOSSES[name]

    def loss_fn(pred, target):
        if r is not None and r > 1:
            target = contextualize_r(target, r)
        return base(pred.float(), target.float())

    return loss_fn
