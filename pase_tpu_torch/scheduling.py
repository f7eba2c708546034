"""Multi-task loss weighting: the backprop policies of the training step.

The port of ``pase_tpu/scheduling.py``. Each policy maps the per-worker
loss vector (detached) and a small state to

  * ``weights`` — per-worker multipliers of THIS step's loss sum
                  (select_one / select_half / dropout masks; ones
                  otherwise);
  * ``alpha``   — per-worker encoder-gradient scales of the NEXT step
                  (``minions.scale_grad``);
  * the new state.

base: ones, ones. select_one: the count is incremented, then worker
count mod n is trained alone. select_half: a uniform subset of 3 or 4
workers, of size 3 with probability C(n,3) / (C(n,3) + C(n,4)) (the
reference rejection-samples uniform masks until 3 or 4 are set).
dropout: each worker kept with probability ``dropout_rate``.
hyper_volume: alpha = 1 / (delta max(loss) - loss + 1e-6). softmax:
alpha = softmax(temp loss). adaptive: the reward last_loss - loss feeds
an EMA q (``alpha_ema``), alpha = softmax(temp q). MGD: alpha is the
MGDA-UB min-norm weights of the per-worker gradients of the chunk
representation (``mgda_rep_weights``), which the trainer computes.

The random draws of select_half and dropout come from the generator the
caller passes (the trainer seeds one per step), or from ``weights``
injected by a parity harness.
"""

from math import comb
from typing import NamedTuple

import torch

POLICIES = ("base", "select_one", "select_half", "dropout", "hyper_volume",
            "softmax", "adaptive", "MGD")
# the modes whose weights or alpha are functions of the loss values
VALUE_SENSITIVE = ("softmax", "adaptive", "hyper_volume", "MGD")


class PolicyState(NamedTuple):
    q: torch.Tensor          # adaptive EMA reward
    last_loss: torch.Tensor
    pi: torch.Tensor
    count: torch.Tensor      # select_one cycle counter


def init_policy_state(num_workers, device="cpu"):
    return PolicyState(q=torch.zeros(num_workers, device=device),
                       last_loss=torch.zeros(num_workers, device=device),
                       pi=torch.ones(num_workers, device=device),
                       count=torch.zeros((), dtype=torch.int32,
                                         device=device))


def select_half_weights(n, generator=None, device="cpu"):
    """A 0/1 [n] mask with 3 or 4 ones, P(3) = C(n,3) / (C(n,3) +
    C(n,4)), the subset uniform given its size."""
    c3, c4 = comb(n, 3), (comb(n, 4) if n >= 4 else 0)
    p3 = c3 / max(c3 + c4, 1)
    u = torch.rand((), generator=generator, device=device)
    size = torch.where(u < p3, 3, 4)
    order = torch.randperm(n, generator=generator, device=device)
    ranks = torch.argsort(order)
    return (ranks < size).float()


def dropout_weights(n, rate, generator=None, device="cpu"):
    """A 0/1 [n] mask, each worker kept with probability ``rate``."""
    return (torch.rand(n, generator=generator, device=device)
            < rate).float()


def apply_policy(mode, losses, state, generator=None, *, dropout_rate=0.5,
                 delta=1.5, temp=1.0, alpha_ema=0.5, mgda_alpha=None,
                 weights=None):
    """(weights [n], alpha [n], new state) for the detached loss vector
    [n]. ``weights`` replaces select_half's / dropout's draw."""
    losses = losses.detach()
    n = losses.shape[0]
    ones = torch.ones(n, dtype=losses.dtype, device=losses.device)
    if mode == "base":
        return ones, ones, state
    if mode == "select_one":
        count = state.count + 1
        w = torch.nn.functional.one_hot((count % n).long(), n).to(
            losses.dtype)
        return w, ones, state._replace(count=count)
    if mode in ("select_half", "dropout"):
        if weights is None:
            weights = (select_half_weights(n, generator, losses.device)
                       if mode == "select_half" else
                       dropout_weights(n, dropout_rate, generator,
                                       losses.device))
        return weights.to(losses.device, losses.dtype), ones, state
    if mode == "hyper_volume":
        eta = delta * torch.max(losses)
        return ones, 1.0 / (eta - losses + 1e-6), state
    if mode == "softmax":
        return ones, torch.softmax(temp * losses, dim=0), state
    if mode == "adaptive":
        r_t = state.last_loss - losses
        q_t = alpha_ema * r_t + (1 - alpha_ema) * state.q
        pi = torch.softmax(temp * q_t, dim=0)
        return ones, pi, state._replace(q=q_t, last_loss=losses, pi=pi)
    if mode == "MGD":
        assert mgda_alpha is not None, "MGD mode needs per-worker rep grads"
        return ones, mgda_alpha, state
    raise NotImplementedError(mode)


FW_ITERS = 20                # Frank-Wolfe iterations of MGDA-UB


def min_norm_weights(grads):
    """Frank-Wolfe min-norm point of the convex hull of the rows of
    ``grads`` [n, d], each row normalized by max(|row|, 1e-8): simplex
    weights [n]. Exact line search, gamma clipped to [0, 1] (0 where
    d'Gd <= 1e-12)."""
    norms = torch.linalg.norm(grads, dim=1, keepdim=True)
    g = grads / torch.clamp(norms, min=1e-8)
    return _frank_wolfe(g @ g.t())


def min_norm_weights_gram(raw_gram):
    """``min_norm_weights`` from the Gram matrix grads grads^T of the
    unnormalized rows (data parallelism: the sum over the ranks of each
    rank's Gram matrix of its rows)."""
    norms = torch.sqrt(torch.clamp(torch.diagonal(raw_gram), min=0.0))
    inv = 1.0 / torch.clamp(norms, min=1e-8)
    return _frank_wolfe(raw_gram * inv[:, None] * inv[None, :])


def _frank_wolfe(gram):
    """The Frank-Wolfe iterations of ``min_norm_weights`` on the Gram
    matrix of the normalized rows."""
    n = gram.shape[0]
    w = torch.full((n,), 1.0 / n, dtype=gram.dtype, device=gram.device)
    for _ in range(FW_ITERS):
        v = gram @ w
        e = torch.nn.functional.one_hot(torch.argmin(v), n).to(gram.dtype)
        d = e - w
        gd = gram @ d
        num = -torch.dot(w, gd)
        den = torch.dot(d, gd)
        gamma = torch.where(den > 1e-12, num / den,
                            torch.zeros_like(den)).clamp(0.0, 1.0)
        w = w + gamma * d
    return w


def mgda_rep_weights(per_worker_rep_grads):
    """[n_workers, ...] representation gradients -> MGDA-UB simplex
    weights [n_workers]."""
    n = per_worker_rep_grads.shape[0]
    return min_norm_weights(per_worker_rep_grads.reshape(n, -1))
