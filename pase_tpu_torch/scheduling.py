"""Multi-task loss weighting policy: the 'base' mode.

The port of ``pase_tpu/scheduling.py`` for the base policy, which
back-propagates the plain sum of the worker losses: per-worker weights
and next-step encoder-gradient scales (alpha) are all ones, and the state
is unchanged. The other modes (select_one, select_half, dropout,
hyper_volume, softmax, adaptive, MGD) are later work.
"""

from typing import NamedTuple

import torch


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


def apply_policy(mode, losses, state):
    """(weights [n], alpha [n], new state) for the loss vector [n]."""
    if mode != "base":
        raise NotImplementedError(
            f"backprop mode {mode!r} is not ported yet: ROADMAP.md, queue "
            "1: off-path model variants (non-base policies)")
    ones = torch.ones(losses.shape[0], dtype=losses.dtype,
                      device=losses.device)
    return ones, ones, state
