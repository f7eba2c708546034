"""Worker-target normalization statistics of a corpus, on the card.

    python -m pase_tpu_torch.make_trainset_statistics \\
        --data_root data/LibriSpeech_50h/wav_sel \\
        --data_cfg data/librispeech_data_50h.cfg \\
        --net_cfg cfg/workers/workers+.cfg --out_file stats.pkl

The flags of the root ``make_trainset_statistics.py``, plus ``--device``
(default ``cuda``). Up to ``--max_batches`` batches of the train split's
``ChunkBatcher`` (or of the numpy ``SyntheticChunkBatcher`` with
``--synthetic``) go through ``compute_stats``; the pickle
({key: {'mean': [D], 'std': [D]}}) is the one ``--stats`` of either
package's training CLI reads.
"""

import argparse

from pase_tpu_torch.train import str2bool


def build_argparser():
    p = argparse.ArgumentParser(
        prog="python -m pase_tpu_torch.make_trainset_statistics")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--data_cfg", type=str, default=None)
    p.add_argument("--net_cfg", type=str, required=True)
    p.add_argument("--out_file", type=str, default="stats.pkl")
    p.add_argument("--max_batches", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--chunk_size", type=int, default=16000)
    p.add_argument("--hop", type=int, default=160)
    p.add_argument("--random_scale", type=str, default="False")
    p.add_argument("--synthetic", action="store_true", default=False)
    p.add_argument("--jax_cache_dir", type=str, default=None,
                   help="accepted so the root script's command lines run; "
                        "the port compiles nothing to cache")
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="where the features are computed (default: the "
                        "card)")
    return p


def main(argv=None):
    opts = build_argparser().parse_args(argv)
    import torch
    from pase_tpu_torch.data.dataset import (ChunkBatcher,
                                             LibriSpeechTupleDataset,
                                             SyntheticChunkBatcher)
    from pase_tpu_torch.data.pipeline import compute_stats, save_stats_pkl
    from pase_tpu_torch.model import parse_workers_cfg
    from pase_tpu_torch.precision import full_precision
    full_precision()        # float32 as the JAX CLI's: no TF32
    if opts.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device "
                           "(torch.cuda.is_available() is False)")
    meta = parse_workers_cfg(opts.net_cfg)
    if opts.synthetic:
        batcher = SyntheticChunkBatcher(opts.batch_size, opts.chunk_size)
    else:
        if not (opts.data_root and opts.data_cfg):
            raise ValueError("--data_root and --data_cfg are required "
                             "without --synthetic")
        ds = LibriSpeechTupleDataset(opts.data_root, opts.data_cfg, "train")
        batcher = ChunkBatcher(ds, opts.batch_size, opts.chunk_size)
    stats = compute_stats(batcher, meta, hop=opts.hop,
                          max_batches=opts.max_batches, device=opts.device,
                          random_scale=str2bool(opts.random_scale))
    save_stats_pkl(stats, opts.out_file)
    print(f"Wrote stats for {list(stats)} to {opts.out_file}")
    return stats


if __name__ == "__main__":
    main()
