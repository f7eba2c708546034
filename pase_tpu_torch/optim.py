"""Optimizers and LR schedules of the training step.

Two parameter groups: the encoder ('frontend', at fe_lr) and the rest
('minion', at min_lr: the worker heads and the attention blocks), each
with its own optimizer (``--fe_opt`` / ``--min_opt``), as the JAX
package's optax multi_transform. The moments are elementwise, so one
optimizer over the disjoint union equals the reference's per-component
ones. ``OptaxOptimizer`` takes each group's rule in optax 0.2.6's form
(defaults b1 0.9, b2 0.999, eps 1e-8):

  adam:    u = m^ / (sqrt(v^) + eps)
  adamw:   u = m^ / (sqrt(v^) + eps) + 1e-4 p       (every leaf)
  radam:   ro = ro_inf - 2 t b2^t / (1 - b2^t), ro_inf = 2 / (1 - b2) - 1;
           u = r m^ / (sqrt(v^) + eps) where ro >= 5, r = sqrt((ro - 4)
           (ro - 2) ro_inf / ((ro_inf - 4) (ro_inf - 2) ro)), else m^
           (ro and r in float32, as optax takes them)
  sgd:     u = g                                    (no momentum)
  rmsprop: nu = 0.9 nu + 0.1 g^2 (nu from 0), u = g / sqrt(nu + eps)
           (eps inside the root; no momentum, no bias correction)

and p <- p - lr u (m^, v^ the bias-corrected moments at count t, the
corrections 1 - b^t in float32 as optax takes them). The scalars of a
step (corrections, ro, r) are taken once per group, and the updates are
``torch._foreach_*`` ops over the group's tensors. torch's own RMSprop
(alpha 0.99, eps outside the root), RAdam (another eps placement),
AdamW (decay 1e-2) and Adam (corrections in float64) differ from these.

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


RULES = ("adam", "adamw", "radam", "sgd", "rmsprop")
B1, B2, EPS = 0.9, 0.999, 1e-8
ADAMW_DECAY = 1e-4           # optax.adamw's default weight decay
RMS_DECAY = 0.9              # optax.rmsprop's default decay
RADAM_THRESHOLD = 5.0


def bias_correction(decay, t):
    """1 - decay^t in float32, as optax takes it (at t = 1, float32's
    0.999 makes 1 - b2 1.3e-5 off 0.001)."""
    return float(1 - torch.tensor(decay) ** torch.tensor(float(t)))


def radam_rectifier(t):
    """(ro, r) of RAdam's step t, in float32 as optax's jitted update
    computes them on the CPU (ro is a difference of two numbers near
    2 / (1 - b2): float32 moves it by about 0.02, so the rectification's r
    would differ by about 0.4 % if it were taken in float64)."""
    ro_inf = torch.tensor(2.0 / (1.0 - B2) - 1.0)
    tt = torch.tensor(float(t))
    b2t = torch.tensor(B2) ** tt
    ro = ro_inf - 2 * tt * b2t / (1 - b2t)
    r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                   / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
    return float(ro), float(r)


def rule_of(name):
    """An optimizer name (any case; None is Adam) -> its rule, or
    ValueError as the JAX package's ``_make_opt``."""
    rule = (name or "Adam").lower()
    if rule not in RULES:
        raise ValueError(f"Unknown optimizer {rule}")
    return rule


class OptaxOptimizer(torch.optim.Optimizer):
    """One optimizer over groups that each carry a ``rule`` (``RULES``),
    with optax's updates (see the module's docstring). State per
    parameter: adam / adamw / radam keep 'step' (the count), 'exp_avg'
    (mu) and 'exp_avg_sq' (nu), as ``torch.optim.Adam`` names them;
    rmsprop keeps 'square_avg' (nu); sgd keeps nothing."""

    def __init__(self, groups):
        super().__init__(groups, {"lr": 1e-3, "rule": "adam"})
        self._zeros = {}

    def _grad(self, p):
        """p's gradient; a parameter outside the loss's graph (an
        attention block's scoring MLP) has a zero one in optax: its
        moments advance and AdamW's decay still applies."""
        if p.grad is not None:
            return p.grad
        if p not in self._zeros:
            self._zeros[p] = torch.zeros_like(p)
        return self._zeros[p]

    def _state(self, ps, keys):
        """[[state[p][key] for p in ps] for key in keys], zeros at first."""
        for p in ps:
            st = self.state[p]
            if not st:
                st.update({k: torch.zeros_like(p) for k in keys})
                if "exp_avg" in keys:
                    st["step"] = torch.tensor(0.0)
        return [[self.state[p][k] for p in ps] for k in keys]

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            ps, rule, lr = group["params"], group["rule"], group["lr"]
            if not ps:
                continue
            gs = [self._grad(p) for p in ps]
            if rule == "sgd":
                torch._foreach_add_(ps, gs, alpha=-lr)
            elif rule == "rmsprop":
                nu, = self._state(ps, ("square_avg",))
                torch._foreach_mul_(nu, RMS_DECAY)
                torch._foreach_addcmul_(nu, gs, gs, value=1 - RMS_DECAY)
                den = torch._foreach_add(nu, EPS)
                torch._foreach_rsqrt_(den)
                torch._foreach_addcmul_(ps, gs, den, value=-lr)
            else:
                self._adam_step(rule, lr, ps, gs)

    def _adam_step(self, rule, lr, ps, gs):
        m, v = self._state(ps, ("exp_avg", "exp_avg_sq"))
        steps = [self.state[p]["step"] for p in ps]
        torch._foreach_add_(steps, 1.0)
        t = int(steps[0])
        torch._foreach_lerp_(m, gs, 1 - B1)
        torch._foreach_mul_(v, B2)
        torch._foreach_addcmul_(v, gs, gs, value=1 - B2)
        scale = lr / bias_correction(B1, t)
        if rule == "radam":
            ro, r = radam_rectifier(t)
            if ro < RADAM_THRESHOLD:
                torch._foreach_add_(ps, m, alpha=-scale)
                return
            scale *= r
        if rule == "adamw":
            torch._foreach_mul_(ps, 1 - lr * ADAMW_DECAY)
        den = torch._foreach_div(v, bias_correction(B2, t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_addcdiv_(ps, m, den, value=-scale)


def build_optimizer(model, fe_opt="Adam", min_opt="Adam", fe_lr=1e-3,
                    min_lr=5e-4, lr_mode="poly", epochs=100, bpe=1000,
                    lr_step=30, lr_gamma=0.1):
    """(the optimizer over {'frontend', 'minion'} groups, {group:
    schedule}). ``model`` is a ``model.PASE``: 'frontend' is its
    encoder, 'minion' every other parameter. Each group carries its
    ``rule``."""
    rules = {"frontend": rule_of(fe_opt), "minion": rule_of(min_opt)}
    scheds = {
        "frontend": make_lr_schedule(lr_mode, fe_lr, epochs, bpe, lr_step,
                                     lr_gamma=lr_gamma),
        "minion": make_lr_schedule(lr_mode, min_lr, epochs, bpe, lr_step,
                                   lr_gamma=lr_gamma)}
    rest = [p for n, p in model.named_parameters()
            if not n.startswith("frontend.")]
    groups = [
        {"params": list(model.frontend.parameters()), "name": "frontend",
         "lr": scheds["frontend"](0), "rule": rules["frontend"]},
        {"params": rest, "name": "minion", "lr": scheds["minion"](0),
         "rule": rules["minion"]}]
    return OptaxOptimizer(groups), scheds


def set_lr(opt, scheds, step):
    """Give each group its schedule's lr for (0-based) step ``step``."""
    for group in opt.param_groups:
        group["lr"] = scheds[group["name"]](step)
