"""Self-supervised PASE / PASE+ pretraining CLI of the PyTorch port.

    python -m pase_tpu_torch.train --synthetic \\
        --net_cfg cfg/workers/workers+.cfg --fe_cfg cfg/frontend/PASE+.cfg \\
        --batch_size 32 --chunk_size 32000 --epoch 1 --save_path ckpt

The flags are those of the JAX CLI (``train.py``) for the synthetic path;
``--device`` picks the card (default ``cuda``) or the CPU. Synthetic data
is drawn on the device (``data/dataset.py``) with 100 steps per epoch and
a 10-batch eval; each epoch writes ``FE_e{epoch}.npz`` and appends to
``metrics.jsonl`` in ``--save_path``. Flags of paths the port does not
build yet raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

import argparse
import json
import os

import torch


def str2bool(v):
    return str(v).lower() in ("true", "1", "yes")


# flag -> (value that means "not used", ROADMAP.md item that ports it)
_UNPORTED = {
    "data_root": ([], "queue 1: disk-fed training"),
    "data_cfg": ([], "queue 1: disk-fed training"),
    "dtrans_cfg": ([], "queue 1: batch prepare (the distortion stack)"),
    "device_corpus": (False, "queue 1: disk-fed training"),
    "cache_feats_dir": (None, "queue 1: disk-fed training"),
    "gan_cfg": (None, "queue 1: off-path model variants (GAN workers)"),
    "compute_dtype": (None, "queue 1: bf16 compute policy"),
    "att_cfg": (None, "queue 1: off-path model variants"),
    "chunking_K": (None, "queue 1: off-path model variants"),
    "zero_speech_p": (0.0, "queue 1: disk-fed training"),
}


def build_argparser():
    p = argparse.ArgumentParser(prog="python -m pase_tpu_torch.train")
    p.add_argument("--data_root", action="append", default=[])
    p.add_argument("--data_cfg", action="append", default=[])
    p.add_argument("--dtrans_cfg", action="append", default=[])
    p.add_argument("--net_cfg", type=str, default=None)
    p.add_argument("--fe_cfg", type=str, default=None)
    p.add_argument("--stats", type=str, default=None)
    p.add_argument("--save_path", type=str, default="ckpt")
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--random_scale", type=str, default="False")
    p.add_argument("--chunk_size", type=int, default=16000)
    p.add_argument("--log_freq", type=int, default=100)
    p.add_argument("--epoch", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--fe_opt", type=str, default="Adam")
    p.add_argument("--min_opt", type=str, default="Adam")
    p.add_argument("--lrdec_step", type=int, default=30)
    p.add_argument("--fe_lr", type=float, default=0.0001)
    p.add_argument("--min_lr", type=float, default=0.0004)
    p.add_argument("--lr_mode", type=str, default="step")
    p.add_argument("--lrdecay", type=float, default=0,
                   help="step-mode LR gamma (0 keeps 0.1)")
    p.add_argument("--backprop_mode", type=str, default="base")
    p.add_argument("--hop", type=int, default=160)
    p.add_argument("--zero_speech_p", type=float, default=0.0)
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="synthetic data drawn on the device")
    p.add_argument("--cache_feats_dir", type=str, default=None)
    p.add_argument("--compute_dtype", type=str, default=None)
    p.add_argument("--device_corpus", action="store_true", default=False)
    p.add_argument("--gan_cfg", type=str, default=None)
    p.add_argument("--att_cfg", type=str, default=None)
    p.add_argument("--chunking_K", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="where the step runs (default: the card)")
    return p


def check_ported(opts):
    """Raise for a flag whose path the port does not build yet."""
    for flag, (unused, item) in _UNPORTED.items():
        value = getattr(opts, flag)
        if flag == "dtrans_cfg":    # "None" disables a corpus's stack
            value = [c for c in value if str(c) not in ("None", "none", "")]
        if value != unused:
            raise NotImplementedError(
                f"--{flag} is not ported yet: ROADMAP.md, {item}")
    if not opts.synthetic:
        raise NotImplementedError(
            "training from a corpus is not ported yet (use --synthetic): "
            "ROADMAP.md, queue 1: disk-fed training")
    if opts.backprop_mode != "base":
        raise NotImplementedError(
            f"--backprop_mode {opts.backprop_mode} is not ported yet: "
            "ROADMAP.md, queue 1: off-path model variants (non-base "
            "policies)")
    if opts.net_cfg is None or opts.fe_cfg is None:
        raise ValueError("--net_cfg and --fe_cfg are required")


def train(opts):
    check_ported(opts)
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.data.pipeline import load_stats_pkl
    from pase_tpu_torch.trainer import Trainer
    if opts.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device "
                           "(torch.cuda.is_available() is False)")
    # full float32 (no TF32 matmuls or convolutions): the JAX CLI's
    # reference precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(opts.fe_cfg) as f:
        fe_cfg = json.load(f)
    with open(opts.net_cfg) as f:
        wk_cfg = json.load(f)
    bpe = 100
    batcher = DeviceSyntheticBatcher(opts.batch_size, opts.chunk_size,
                                     seed=opts.seed, device=opts.device)
    va_batcher = DeviceSyntheticBatcher(opts.batch_size, opts.chunk_size,
                                        seed=opts.seed + 1,
                                        device=opts.device)
    stats = (load_stats_pkl(opts.stats)
             if opts.stats and os.path.exists(opts.stats) else None)
    cfg = vars(opts).copy()
    cfg.update(bpe=bpe, va_bpe=max(bpe // 10, 1),
               random_scale=str2bool(opts.random_scale))
    tr = Trainer(fe_cfg, wk_cfg, cfg, stats=stats, device=opts.device)
    try:
        tr.train_(batcher, va_batcher)
    finally:
        tr.logger.close()
    return tr


def main(argv=None):
    opts = build_argparser().parse_args(argv)
    os.makedirs(opts.save_path, exist_ok=True)
    with open(os.path.join(opts.save_path, "train.opts"), "w") as f:
        f.write(json.dumps(vars(opts), indent=2))
    return train(opts)


if __name__ == "__main__":
    main()
