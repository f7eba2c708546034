"""Optimizer and LR schedules of the training step.

One ``torch.optim.Adam`` over two parameter groups: the encoder
('frontend', at fe_lr) and the worker heads ('minion', at min_lr). Adam
moments are elementwise, so one Adam over the disjoint union equals the
reference's per-component optimizers (``pase_tpu/optim.py`` uses one
optax multi_transform the same way). eps is 1e-8, as in optax.

LR schedules (T = global step, N = epochs * bpe):
  step: lr * gamma^(epoch // lr_step)      (gamma 0.1 unless given)
  poly: lr * (1 - T/N)^0.9
  cos:  0.5 * lr * (1 + cos(pi * T/N))
The lr of step k is sched(k), with sched(0) = base lr: optax evaluates
the schedule at the count before it increments.
"""

import math

import torch


def make_lr_schedule(mode, base_lr, epochs, bpe, lr_step=30,
                     warmup_epochs=0, lr_gamma=0.1):
    n_total = max(epochs * bpe, 1)
    warmup_iters = warmup_epochs * bpe

    def sched(step):
        step = float(step)
        if mode == "cos":
            lr = 0.5 * base_lr * (1 + math.cos(step / n_total * math.pi))
        elif mode == "poly":
            lr = base_lr * max(1 - step / n_total, 0.0) ** 0.9
        elif mode == "step":
            lr = base_lr * lr_gamma ** math.floor(math.floor(step / bpe)
                                                  / lr_step)
        else:
            raise NotImplementedError(mode)
        if warmup_iters > 0 and step < warmup_iters:
            lr = lr * step / warmup_iters
        return lr

    return sched


def build_optimizer(model, fe_opt="Adam", min_opt="Adam", fe_lr=1e-3,
                    min_lr=5e-4, lr_mode="poly", epochs=100, bpe=1000,
                    lr_step=30, lr_gamma=0.1):
    """(Adam over {'frontend', 'minion'} groups, {group: schedule}).
    ``model`` is a ``model.PASE``."""
    for opt in (fe_opt, min_opt):
        if (opt or "Adam").lower() != "adam":
            raise NotImplementedError(
                f"optimizer {opt!r} is not ported yet (Adam only): "
                "ROADMAP.md, queue 1: off-path model variants")
    scheds = {
        "frontend": make_lr_schedule(lr_mode, fe_lr, epochs, bpe, lr_step,
                                     lr_gamma=lr_gamma),
        "minion": make_lr_schedule(lr_mode, min_lr, epochs, bpe, lr_step,
                                   lr_gamma=lr_gamma)}
    groups = [
        {"params": list(model.frontend.parameters()), "name": "frontend",
         "lr": scheds["frontend"](0)},
        {"params": list(model.workers.parameters()), "name": "minion",
         "lr": scheds["minion"](0)}]
    opt = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    return opt, scheds


def set_lr(opt, scheds, step):
    """Give each group its schedule's lr for (0-based) step ``step``."""
    for group in opt.param_groups:
        group["lr"] = scheds[group["name"]](step)
