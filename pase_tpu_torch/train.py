"""Self-supervised PASE / PASE+ pretraining CLI of the PyTorch port.

    python -m pase_tpu_torch.train --synthetic \\
        --net_cfg cfg/workers/workers+.cfg --fe_cfg cfg/frontend/PASE+.cfg \\
        --batch_size 32 --chunk_size 32000 --epoch 1 --save_path ckpt \\
        [--dtrans_cfg dist.cfg] [--stats stats.pkl] \\
        [--compute_dtype bfloat16] [--max_ckpts 5] [--no_continue True] \\
        [--pretrained_ckpt FE_e9.npz]

The flags are those of the JAX CLI (``train.py``) for the synthetic path;
``--device`` picks the card (default ``cuda``) or the CPU. Synthetic data
is drawn on the device (``data/dataset.py``) with 100 steps per epoch and
a 10-batch eval; each epoch writes the full train state
(``weights_PASE-Pase_base-<step>.npz``, at most ``--max_ckpts`` kept, in
the JAX package's layout) and ``FE_e{epoch}.npz`` and appends to
``metrics.jsonl`` in ``--save_path``. A run resumes from the latest train
state in ``--save_path`` unless ``--no_continue True``;
``--pretrained_ckpt`` warm-starts the encoder from an encoder artifact.
``--compute_dtype bfloat16`` runs the JAX package's bf16 compute policy
(``precision.py``). ``--dtrans_cfg`` turns on the
distortion stack with the assets its cfg names (the first cfg that is not
"None" wins). Flags of paths the port does not build yet raise
``NotImplementedError`` naming their ROADMAP.md item.
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
    "device_corpus": (False, "queue 1: disk-fed training"),
    "cache_feats_dir": (None, "queue 1: disk-fed training"),
    "gan_cfg": (None, "queue 1: off-path model variants (GAN workers)"),
    "att_cfg": (None, "queue 1: off-path model variants"),
    "chunking_K": (None, "queue 1: off-path model variants"),
    "zero_speech_p": (0.0, "queue 1: disk-fed training"),
}
ROADMAP_HOST_STAGE = ("ROADMAP.md, queue 1: the host distortion stage "
                      "(codec2, whisperize)")
# steps per epoch of the synthetic path, as in the JAX CLI
SYNTHETIC_BPE = 100


def build_argparser():
    p = argparse.ArgumentParser(prog="python -m pase_tpu_torch.train")
    p.add_argument("--data_root", action="append", default=[])
    p.add_argument("--data_cfg", action="append", default=[])
    p.add_argument("--dtrans_cfg", action="append", default=[])
    p.add_argument("--net_cfg", type=str, default=None)
    p.add_argument("--fe_cfg", type=str, default=None)
    p.add_argument("--stats", type=str, default=None)
    p.add_argument("--save_path", type=str, default="ckpt")
    p.add_argument("--max_ckpts", type=int, default=5)
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
    p.add_argument("--no_continue", type=str, default="False")
    p.add_argument("--zero_speech_p", type=float, default=0.0)
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="synthetic data drawn on the device")
    p.add_argument("--cache_feats_dir", type=str, default=None)
    p.add_argument("--compute_dtype", type=str, default=None)
    p.add_argument("--device_corpus", action="store_true", default=False)
    p.add_argument("--gan_cfg", type=str, default=None)
    p.add_argument("--att_cfg", type=str, default=None)
    p.add_argument("--chunking_K", type=int, default=None)
    p.add_argument("--pretrained_ckpt", type=str, default=None,
                   help="warm-start the encoder from a native .npz or "
                        "torch .ckpt encoder artifact")
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="where the step runs (default: the card)")
    return p


def check_ported(opts):
    """Raise for a flag whose path the port does not build yet."""
    for flag, (unused, item) in _UNPORTED.items():
        if getattr(opts, flag) != unused:
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


def build_distortions(opts, chunk_size):
    """(DistortionConfig, DistortionAssets) of the first ``--dtrans_cfg``
    that is not the sentinel "None" (which disables a corpus's stack), or
    (None, None). The host stage (codec2, whisperize) is not ported and
    raises."""
    from pase_tpu_torch.data.distortions import build_assets, config_from_json
    real = [c for c in (opts.dtrans_cfg or [])
            if str(c) not in ("None", "none", "")]
    if not real:
        return None, None
    with open(real[0]) as f:
        dcfg_json = json.load(f)
    cfg = config_from_json(dcfg_json)
    for key in ("codec2_p", "whisper_p"):
        if float(dcfg_json.get(key, 0) or 0) > 0:
            raise NotImplementedError(
                f"{key} > 0 in {real[0]}: {ROADMAP_HOST_STAGE}")
    return cfg, build_assets(dcfg_json, cfg, chunk_size)


def train(opts):
    check_ported(opts)
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.data.pipeline import load_stats_pkl
    from pase_tpu_torch.trainer import Trainer
    if opts.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device "
                           "(torch.cuda.is_available() is False)")
    # no TF32 matmuls or convolutions: float32 is the JAX CLI's reference
    # precision, and bf16 is chosen explicitly by --compute_dtype
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(opts.fe_cfg) as f:
        fe_cfg = json.load(f)
    with open(opts.net_cfg) as f:
        wk_cfg = json.load(f)
    dist_cfg, dist_assets = build_distortions(opts, opts.chunk_size)
    bpe = SYNTHETIC_BPE
    batcher = DeviceSyntheticBatcher(opts.batch_size, opts.chunk_size,
                                     seed=opts.seed, device=opts.device)
    va_batcher = DeviceSyntheticBatcher(opts.batch_size, opts.chunk_size,
                                        seed=opts.seed + 1,
                                        device=opts.device)
    stats = (load_stats_pkl(opts.stats)
             if opts.stats and os.path.exists(opts.stats) else None)
    cfg = vars(opts).copy()
    cfg.update(bpe=bpe, va_bpe=max(bpe // 10, 1),
               random_scale=str2bool(opts.random_scale),
               ckpt_continue=not str2bool(opts.no_continue))
    tr = Trainer(fe_cfg, wk_cfg, cfg, stats=stats, dist_cfg=dist_cfg,
                 dist_assets=dist_assets, device=opts.device)
    try:
        tr.train_(batcher, va_batcher, resume=cfg["ckpt_continue"])
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
