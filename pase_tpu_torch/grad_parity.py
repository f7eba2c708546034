"""Where one train step's float32 gradient departs from another's, leaf by
leaf, module by module and op by op.

    python -m pase_tpu_torch.grad_parity [--batch 2] [--chunk 16000] \\
        [--out grads.json]

Builds PASE+ with workers+ (cfg/frontend/PASE+.cfg, cfg/workers/
workers+.cfg, weights seeded) and one synthetic batch, and takes the
gradient of the summed worker losses of one train-mode step in float64 on
the CPU (the reference), in float32 on the CPU (plain path), and in
float32 on the card with cuDNN on and off. It prints:
  * per parameter group and leaf, max|g - g_ref| against the largest
    |g_ref|;
  * the PReLU sign flips: inputs whose sign differs from the reference's.
    PReLU's derivative jumps from 1 to its slope at 0, so one input that
    lies within rounding of 0 and rounds to the other side changes the
    gradient there by (1 - slope) times its output gradient;
  * each module's output and output-gradient error, in backward order:
    the module where the gradient error jumps is where it enters;
  * the same comparisons with every run's PReLUs taking the card's signs
    (``prelu_signs(force=...)``), which leaves float32 rounding alone;
  * each convolution and BatchNorm alone, from the float64 run's input and
    output gradient rounded to float32, against float64.
"""

import argparse
import contextlib
import copy
import json
import os

import torch
import torch.nn.functional as F
from torch import nn

from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
from pase_tpu_torch.data.pipeline import make_prepare_fn
from pase_tpu_torch.model import build_pase, worker_losses
from pase_tpu_torch.nn import SincConv
from pase_tpu_torch.ops.pad import pad_1d, sinc_same_pad

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASEP_CFG = os.path.join(HERE, "cfg", "frontend", "PASE+.cfg")
WORKERSP_CFG = os.path.join(HERE, "cfg", "workers", "workers+.cfg")
# cuDNN settings the card's step is taken under
CUDNN_SETTINGS = {"default": {}, "cudnn_off": {"enabled": False}}


@contextlib.contextmanager
def cudnn_setting(**flags):
    old = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(torch.backends.cudnn, k, v)


def group_of(name):
    return "frontend" if name.startswith("frontend.") else "minion"


@contextlib.contextmanager
def prelu_signs(model, record=None, force=None):
    """Within the block, each PReLU of ``model`` puts its input (detached,
    on the CPU) into ``record`` under its module name; with ``force`` (name
    -> bool mask), it computes where(mask, x, slope * x) instead, so its
    derivative takes the mask's side of the kink rather than its own
    input's sign."""
    def hook(name):
        def fn(mod, inputs, out):
            x = inputs[0]
            if record is not None:
                record[name] = x.detach().cpu()
            if force is not None:
                slope = mod.weight.view(1, -1, *([1] * (x.dim() - 2)))
                return torch.where(force[name].to(x.device), x, slope * x)
        return fn
    hooks = [m.register_forward_hook(hook(n))
             for n, m in model.named_modules() if isinstance(m, nn.PReLU)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def sign_flips(got, want):
    """Per PReLU with a flip: (inputs whose sign differs, the largest
    |input| among them over the module's largest |input|)."""
    out = {}
    for k, w in want.items():
        g = got[k].to(w.dtype)
        flip = (g > 0) != (w > 0)
        n = int(flip.sum())
        if n:
            far = torch.maximum(g.abs(), w.abs())[flip].max()
            out[k] = (n, (far / w.abs().max()).item())
    return out


def _op_of(mod):
    """(function of (x, *params), params) computing ``mod``'s op alone:
    a convolution, a SincConv's conv on its padded input, or a train-mode
    BatchNorm."""
    if isinstance(mod, SincConv):
        pad = sinc_same_pad(mod.kwidth, mod.stride)
        return (lambda x, w: F.conv1d(pad_1d(x, pad, mod.pad_mode), w,
                                      stride=mod.stride),
                [mod.filters().detach()[:, None, :]])
    if isinstance(mod, nn.ConvTranspose1d):
        return (lambda x, w: F.conv_transpose1d(
            x, w, None, mod.stride, mod.padding, mod.output_padding,
            mod.groups, mod.dilation), [mod.weight.detach()])
    if isinstance(mod, nn.Conv1d):
        return (lambda x, w: F.conv1d(x, w, None, mod.stride, mod.padding,
                                      mod.dilation, mod.groups),
                [mod.weight.detach()])
    params = [] if mod.weight is None else [mod.weight.detach(),
                                            mod.bias.detach()]
    return (lambda x, *wb: F.batch_norm(x, None, None, *wb, training=True,
                                        eps=mod.eps)), params


_OPS = (nn.Conv1d, nn.ConvTranspose1d, SincConv, nn.BatchNorm1d)


def _capture(name, store, ops):
    def hook(mod, inputs, out):
        if not torch.is_tensor(out):
            return
        entry = store[name] = {"y": out.detach()}
        if ops and isinstance(mod, _OPS):
            entry["x"] = inputs[0].detach()
            entry["fn"], entry["params"] = _op_of(mod)
        out.register_hook(lambda g: entry.__setitem__("dy", g.detach()))
    return hook


def step_grads(model, meta, raw, device, dtype, capture=None, signs=None,
               force=None):
    """{parameter name: float64 CPU gradient} of the summed worker losses
    of one train-mode step of a copy of ``model`` in ``dtype`` on
    ``device``. With ``capture`` (a dict), each module's output and output
    gradient are kept there, and for each convolution and BatchNorm its
    input and op; ``signs`` and ``force`` go to ``prelu_signs``."""
    model = copy.deepcopy(model).to(device=device, dtype=dtype).train()
    prepare = make_prepare_fn(meta, hop=160)
    batch = prepare({k: torch.as_tensor(v, dtype=dtype, device=device)
                     for k, v in raw.items()})
    hooks = [] if capture is None else [
        m.register_forward_hook(_capture(n, capture, ops=dtype ==
                                         torch.float64))
        for n, m in model.named_modules() if n]
    with prelu_signs(model, record=signs, force=force):
        _, _, preds, labels = model(batch, 1.0)
    losses = worker_losses(meta, preds, labels)
    sum(losses.values()).backward()
    for h in hooks:
        h.remove()
    return {k: (p.grad.detach().double().cpu() if p.grad is not None
                else torch.zeros(p.shape, dtype=torch.float64))
            for k, p in model.named_parameters()}


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()


def trace_errors(got, want):
    """Per captured module, in backward order: (output error, output
    gradient error), each max|a - a_ref| / max|a_ref|."""
    return {k: (_rel(got[k]["y"], w["y"]),
                _rel(got[k]["dy"], w["dy"]) if "dy" in w else None)
            for k, w in reversed(list(want.items()))}


def leaf_errors(got, want):
    """Per leaf (max|got - want|, max|want|), and per group max|want|."""
    leaves = {k: ((got[k] - w).abs().max().item(), w.abs().max().item())
              for k, w in want.items()}
    gmax = {}
    for k, (_, m) in leaves.items():
        gmax[group_of(k)] = max(gmax.get(group_of(k), 0.0), m)
    return leaves, gmax


def group_errors(got, want):
    """Per group: max|got - want| / max|want| over its leaves."""
    leaves, gmax = leaf_errors(got, want)
    err = {}
    for k, (e, _) in leaves.items():
        err[group_of(k)] = max(err.get(group_of(k), 0.0), e)
    return {g: err[g] / gmax[g] for g in gmax}


def worst_leaves(got, want, n=6, floor=1e-3):
    """The ``n`` leaves with the largest max|got - want| / max|want|,
    among leaves whose largest |want| is at least ``floor`` of their
    group's: (name, error / leaf max, error / group max, leaf max)."""
    leaves, gmax = leaf_errors(got, want)
    rows = [(k, e / m, e / gmax[group_of(k)], m)
            for k, (e, m) in leaves.items()
            if m >= floor * gmax[group_of(k)] and m > 0]
    return sorted(rows, key=lambda r: -r[1])[:n]


def _op_grads(entry, device, dtype):
    x = entry["x"].to(device, dtype, copy=True).requires_grad_()
    ps = [p.to(device, dtype, copy=True).requires_grad_()
          for p in entry["params"]]
    y = entry["fn"](x, *ps)
    y.backward(entry["dy"].to(device, dtype))
    return [y.detach(), x.grad] + [p.grad for p in ps]


def op_errors(store, device):
    """Per convolution and BatchNorm: [output, input-gradient, parameter-
    gradient errors], each max|a32 - a64| / max|a64|, of the op alone on
    ``device`` in float32 from the float64 run's input and output gradient
    rounded to float32."""
    out = {}
    for name, entry in store.items():
        if "fn" not in entry:
            continue
        want = _op_grads(entry, "cpu", torch.float64)
        got = _op_grads(entry, device, torch.float32)
        out[name] = [_rel(a, b) for a, b in zip(got, want)]
    return out


def fmt_worst(rows):
    return "; ".join(f"{k} {a:.2e} of leaf max {m:.2e} ({g:.2e} of group)"
                     for k, a, g, m in rows)


def fmt_groups(err):
    return ", ".join(f"{k} {v:.3e}" for k, v in err.items())


def fmt_flips(flips):
    total = sum(n for n, _ in flips.values())
    return f"{total} in {len(flips)} PReLU(s)" + "".join(
        f"; {k} {n} (largest |x| {r:.1e} of max)"
        for k, (n, r) in flips.items())


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m pase_tpu_torch.grad_parity")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--chunk", type=int, default=16000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None,
                   help="write every leaf's, module's and op's errors here "
                        "(JSON)")
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[grad_parity] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; cudnn {torch.backends.cudnn.version()}; "
          f"batch {opts.batch} x {opts.chunk}")
    model, meta = build_pase(PASEP_CFG, WORKERSP_CFG,
                             generator=torch.Generator().manual_seed(
                                 opts.seed))
    raw = next(iter(SyntheticChunkBatcher(opts.batch, opts.chunk,
                                          seed=opts.seed)))
    report = {"groups": {}, "leaves": {}, "flips": {}, "trace": {},
              "ops": {}}
    stores, signs, runs = {}, {}, {}
    for tag, device, dtype, flags in (
            [("float64", "cpu", torch.float64, {}),
             ("cpu", "cpu", torch.float32, {})]
            + [(f"card_{t}", "cuda", torch.float32, f)
               for t, f in CUDNN_SETTINGS.items()]):
        stores[tag], signs[tag] = {}, {}
        with cudnn_setting(**flags):
            runs[tag] = step_grads(model, meta, raw, device, dtype,
                                   capture=stores[tag], signs=signs[tag])
    g64 = runs.pop("float64")
    for tag, g in runs.items():
        vs64, vscpu = group_errors(g, g64), group_errors(g, runs["cpu"])
        report["groups"][tag] = {"vs_float64": vs64, "vs_cpu": vscpu}
        report["leaves"][tag] = leaf_errors(g, g64)[0]
        report["flips"][tag] = sign_flips(signs[tag], signs["float64"])
        report["trace"][tag] = trace_errors(stores[tag], stores["float64"])
        print(f"[grad_parity] {tag}: max|g - g64| / max|g64| per group "
              f"{fmt_groups(vs64)}; vs cpu float32 {fmt_groups(vscpu)}")
        print(f"[grad_parity]   worst leaves: {fmt_worst(worst_leaves(g, g64))}")
        print(f"[grad_parity]   PReLU sign flips against float64: "
              f"{fmt_flips(report['flips'][tag])}")
    print("[grad_parity] card vs cpu PReLU sign flips: " + fmt_flips(
        sign_flips(signs["card_default"], signs["cpu"])))

    tags = list(runs)
    print("[grad_parity] modules in backward order, (output, output "
          "gradient) error vs float64 for " + ", ".join(tags) + ": the "
          "encoder's, and others' where the card's gradient error is over "
          "10x the CPU's and 1e-5")
    for mod, (_, dy_cpu) in report["trace"]["cpu"].items():
        dy_card = report["trace"]["card_default"][mod][1]
        if not mod.startswith("frontend.") and (
                dy_cpu is None or dy_card <= max(10 * dy_cpu, 1e-5)):
            continue
        print(f"[grad_parity]   {mod}: " + "; ".join(
            "{:.2e} {}".format(report["trace"][t][mod][0],
                               "-" if report["trace"][t][mod][1] is None
                               else f"{report['trace'][t][mod][1]:.2e}")
            for t in tags))

    # every run's PReLUs on the card's side of the kink
    masks = {k: x > 0 for k, x in signs["card_default"].items()}
    card = runs["card_default"]
    for tag, dtype in (("float64", torch.float64), ("cpu", torch.float32)):
        ref = step_grads(model, meta, raw, "cpu", dtype, force=masks)
        err = group_errors(card, ref)
        report["groups"][f"card_default vs {tag}, card's PReLU signs"] = err
        report["leaves"][f"card_default vs {tag}, card's PReLU signs"] = \
            leaf_errors(card, ref)[0]
        print(f"[grad_parity] card vs {tag}, both with the card's PReLU "
              f"signs: per group {fmt_groups(err)}; worst leaves: "
              f"{fmt_worst(worst_leaves(card, ref))}")

    for tag, flags in [("cpu", None)] + list(CUDNN_SETTINGS.items()):
        device = "cpu" if flags is None else "cuda"
        key = tag if flags is None else f"card_{tag}"
        with cudnn_setting(**(flags or {})):
            report["ops"][key] = op_errors(stores["float64"], device)
        worst = sorted(report["ops"][key].items(),
                       key=lambda kv: -max(kv[1]))[:6]
        print(f"[grad_parity] ops alone, {key}: (output, input gradient, "
              f"parameter gradients) error vs float64, worst: " + "; ".join(
                  f"{k} " + " ".join(f"{e:.2e}" for e in errs)
                  for k, errs in worst))
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)),
                    exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
