"""Downstream probe CLI of the PyTorch port (the JAX package's
``run_probe.py``, with the same tasks, options and JSON):

  python -m pase_tpu_torch.run_probe utt --fe_cfg cfg/frontend/PASE+.cfg \\
      --fe_ckpt FE_e199.npz --train_list tr.lst --test_list te.lst \\
      --data_root wavs/           # speaker ID / language ID / emotion

  python -m pase_tpu_torch.run_probe frames --num_classes 48 ...  # FER
  python -m pase_tpu_torch.run_probe knn ...       # KNN on embeddings
  python -m pase_tpu_torch.run_probe kfold --folds 10 ...  # one list
  python -m pase_tpu_torch.run_probe timit-full --mlp_cfg MLP.cfg \\
      --dec_cfg decoder.cfg --out_folder timit_exp ...
      # trains the MLP, writes post.ark and dec_cfg.ini, runs
      # decode_dnn.sh where the Kaldi scripts exist

List format: ``wavpath label`` (utt / knn / kfold) or ``wavpath alifile``
(frames / timit-full). The metrics go to stdout as one JSON line, and to
``--out``. Extraction and training run on ``--device`` (default the
card; ``cuda`` without a CUDA device is an error). The JAX CLI's
``--platform`` is accepted: ``cpu`` means ``--device cpu``, ``auto``
keeps ``--device``, ``tpu`` is an error.
"""

import argparse
import json


def build_argparser():
    p = argparse.ArgumentParser(prog="python -m pase_tpu_torch.run_probe")
    p.add_argument("task", choices=["utt", "frames", "knn", "timit-full",
                                    "kfold"])
    p.add_argument("--folds", type=int, default=10)
    p.add_argument("--valid_p", type=float, default=0.1)
    p.add_argument("--fe_cfg", required=True)
    p.add_argument("--fe_ckpt", default=None)
    p.add_argument("--train_list", required=True)
    p.add_argument("--test_list", required=False, default=None,
                   help="required for all tasks except kfold")
    p.add_argument("--data_root", default="")
    p.add_argument("--mode", default="avg_concat")
    p.add_argument("--feature_type", default="pase",
                   help="pase | mfcc | fbank (classical baseline)")
    p.add_argument("--hidden", type=int, nargs="+", default=None,
                   help="MLP hidden sizes; default 256 for utt/frames, "
                        "linear classifier for kfold (pass sizes to "
                        "request an MLP)")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--num_classes", type=int, default=48)
    p.add_argument("--left", type=int, default=8)
    p.add_argument("--right", type=int, default=8)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_utts", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--mlp_cfg", default=None,
                   help="timit-full: MLP cfg JSON")
    p.add_argument("--dec_cfg", default=None,
                   help="timit-full: decoder cfg JSON")
    p.add_argument("--out_folder", default="timit_full_exp")
    p.add_argument("--platform", default="auto",
                   choices=["auto", "cpu", "tpu"],
                   help="the JAX CLI's backend switch: cpu means --device "
                        "cpu, auto keeps --device, tpu is an error")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where extraction and training run (default: the "
                        "card)")
    return p


def _scalars(metrics):
    return {k: v for k, v in metrics.items()
            if isinstance(v, (int, float, str, type(None)))}


def main(argv=None):
    """Run one probe task; prints its metrics as one JSON line (and writes
    them to --out). Returns the metrics."""
    p = build_argparser()
    opts = p.parse_args(argv)
    if opts.platform == "tpu":
        p.error("--platform tpu: this port runs on CUDA devices or the CPU "
                "(--device cuda | cpu)")
    device = "cpu" if opts.platform == "cpu" else opts.device
    if opts.task != "kfold" and not opts.test_list:
        p.error(f"task {opts.task} requires --test_list")
    if opts.task == "timit-full" and not (opts.mlp_cfg and opts.dec_cfg):
        p.error("timit-full requires --mlp_cfg and --dec_cfg")

    import torch
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device "
                           "(torch.cuda.is_available() is False)")
    from pase_tpu_torch.precision import full_precision
    from pase_tpu_torch.probes import tasks
    full_precision()        # float32 as the JAX CLI's: no TF32

    if opts.task == "timit-full":
        from pase_tpu_torch.probes.timit_decode import run_timit_full_decoding
        metrics = _scalars(run_timit_full_decoding(
            opts.fe_cfg, opts.fe_ckpt, opts.data_root, opts.train_list,
            opts.test_list, opts.out_folder, opts.mlp_cfg, opts.dec_cfg,
            max_utts=opts.max_utts, epochs=opts.epochs, device=device))
    elif opts.task == "kfold":
        # class-stratified k-fold linear classifier (the emotion recipe);
        # --train_list is the one labeled list
        metrics = tasks.run_kfold_classification(
            opts.fe_cfg, opts.fe_ckpt, opts.train_list,
            data_root=opts.data_root, folds=opts.folds,
            valid_p=opts.valid_p, mode=opts.mode,
            hidden=tuple(opts.hidden) if opts.hidden else (),
            epochs=opts.epochs, lr=opts.lr, batch_size=opts.batch_size,
            seed=opts.seed, max_utts=opts.max_utts,
            feature_type=opts.feature_type, device=device)
    elif opts.task == "utt":
        metrics = tasks.run_utt_classification(
            opts.fe_cfg, opts.fe_ckpt, opts.train_list, opts.test_list,
            data_root=opts.data_root, mode=opts.mode,
            hidden=tuple(opts.hidden or [256]), epochs=opts.epochs,
            lr=opts.lr, batch_size=opts.batch_size, seed=opts.seed,
            max_utts=opts.max_utts, feature_type=opts.feature_type,
            device=device)
    elif opts.task == "frames":
        metrics = tasks.run_frame_classification(
            opts.fe_cfg, opts.fe_ckpt, opts.train_list, opts.test_list,
            data_root=opts.data_root, num_classes=opts.num_classes,
            left=opts.left, right=opts.right,
            hidden=tuple(opts.hidden or [256]),
            epochs=opts.epochs, lr=opts.lr, max_utts=opts.max_utts,
            device=device)
    else:
        metrics = tasks.run_knn_probe(
            opts.fe_cfg, opts.fe_ckpt, opts.train_list, opts.test_list,
            data_root=opts.data_root, mode=opts.mode, k=opts.k,
            max_utts=opts.max_utts, device=device)
    print(json.dumps(metrics))
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(metrics, f)
    return metrics


if __name__ == "__main__":
    main()
