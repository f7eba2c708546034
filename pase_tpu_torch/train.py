"""Self-supervised PASE / PASE+ pretraining CLI of the PyTorch port.

    python -m pase_tpu_torch.train --data_root data/LibriSpeech_50h/wav_sel \\
        --data_cfg data/librispeech_data_50h.cfg \\
        --net_cfg cfg/workers/workers+.cfg --fe_cfg cfg/frontend/PASE+.cfg \\
        --stats data/librispeech_50h_stats.pkl \\
        --batch_size 32 --chunk_size 32000 --epoch 400 --save_path ckpt \\
        [--device_corpus | --num_workers 4 [--wire_dtype int16]] \\
        [--dtrans_cfg dist.cfg] [--compute_dtype bfloat16]
    python -m pase_tpu_torch.train --synthetic --net_cfg ... --fe_cfg ...

The flags are those of the JAX CLI (``train.py``); ``--device`` picks the
card (default ``cuda``) or the CPU. From a corpus (``data/dataset.py``):
one epoch is total_wav_dur // chunk_size // batch_size steps, then an
eval pass of a tenth of that over the valid split. The host feed crops
batches in ``--num_workers`` threads (one ``ChunkBatcher`` each; one
batcher's own thread when 1), ``--fast_loader`` in the native decoder;
``--wire_dtype int16`` sends the waveforms to the card as PCM16.
``--device_corpus`` keeps the train and valid splits on the card as int16
(``data/device_corpus.py``). Repeated ``--data_root`` / ``--data_cfg`` /
``--dataset`` concatenate corpora (a ``--dtrans_cfg`` of "None" leaves one
undistorted); ``--dataset GenhancementDataset --clean_root R`` reads a
parallel clean tree, ``PairWavDataset`` has no neighbor context,
``AmiSegTupleWavDataset`` AMI's far-field segments against the headset
tree ``--clean_root`` (or, with ``--ihm2sdm 1,3,5,7``, against the
per-channel keys of a ``data_prep ami-cfg`` cfg), as
``recipes/run_pase_libri_ami.sh`` runs it beside LibriSpeech.
``--zero_speech_p`` injects near-silent rows (``--zerospeech_cfg`` adds
noise to them), ``--cache_feats_dir`` (alias ``--trans_cache``) reads the
worker targets from a feature cache (``data/cache.py``). Synthetic data
is drawn on the device with 100 steps per epoch and a 10-batch eval. A
``--dtrans_cfg`` with ``codec2_p`` / ``whisper_p`` adds the host stage
(``data/host_distortions.py``: the codec2 round trip, whisperization) to
the train feed's numpy batches in the consuming thread, after the
prefetch threads; it needs a host feed (not --synthetic or
--device_corpus), and logs a 'host_stage' line (rows degraded, ms a
batch) after training.

Each epoch writes the full train state
(``weights_PASE-Pase_base-<step>.npz``, at most ``--max_ckpts`` kept, in
the JAX package's layout) and ``FE_e{epoch}.npz`` and appends to
``metrics.jsonl`` in ``--save_path``. A run resumes from the latest train
state in ``--save_path`` unless ``--no_continue True``: the device feeds
replay the uninterrupted run's batches from the resumed step, a host
feed restarts its stream (as in the JAX CLI). ``--pretrained_ckpt``
warm-starts the encoder from an encoder artifact. ``--compute_dtype
bfloat16`` runs the JAX package's bf16 compute policy (``precision.py``).
``--dtrans_cfg`` turns on the distortion stack with the assets its cfg
names (the first cfg that is not "None" wins). ``--gan_cfg '<json>'``
(or the legacy z flags ``--warmup`` < ``--epoch``, ``--zinit_weight``,
``--zinc``, ``--z_lr``, ``--adv_loss``, ``--cchunk_prior``) adds an
adversarial worker (``trainer.py``), as in
``recipes/run_pase_plus_gan.sh``. ``--att_cfg FILE`` (with --att_K,
--att_mode, --avg_factor overriding its keys) trains the attention
variant, as ``recipes/run_pase_attention.sh`` does; ``--chunking_K K``
the chunking variant. ``--backprop_mode`` takes every policy of
``scheduling.py`` (with --alpha, --delta, --temp, --dropout_rate;
--rndmin_train is select_one), ``--fe_opt`` / ``--min_opt`` Adam,
RAdam, AdamW, SGD or RMSprop in optax's form (``optim.py``).

Every option string of the JAX CLI parses, with its type and default.
The reference's dead flags and the compatibility flags print the JAX
CLI's notes; ``--no-cuda`` is a note (``--device`` alone picks the
CPU); the TPU-only ``--jax_cache_dir``, ``--no_fused_feed`` and
``--loss_precision`` are accepted and not used. ``--sup_exec FILE``
launches the downstream probes of FILE's command templates
($model, $cfg, $iteration, $save_path substituted) on each
``FE_e{epoch}.npz`` every ``--sup_freq`` epochs and after the last
(``utils.AuxiliarSuperviser``), without waiting for them.

Several cards: one process per card, each started with
``--coordinator_address HOST:PORT --num_processes N --process_id R``
(``parallel/mesh.py``). ``--batch_size`` is the global batch; each
process feeds its rows of it and the step is the global batch's, as in
the JAX CLI's multi-host run; only process 0 writes the checkpoints,
``FE_e*.npz`` and ``metrics.jsonl``. ``--device_corpus
--shard_device_corpus`` shards the corpus over the processes (the
single-buffer device corpus is single-process only). The process group
runs NCCL on the card and gloo on the CPU; the environment variable
PASE_TORCH_DIST_BACKEND=gloo lets several processes share one card.
``--n_model M`` (the JAX CLI's column-parallel 'model' axis) lays the
processes out as an n_data x M grid (``mesh.set_grid``; the run prints
``mesh: {'data': D, 'model': M}``): the M ranks of a model group load
the same rows (the global batch over the D data ranks, not over every
process as the JAX CLI slices it) and hold their parts of the
parameters and optimizer state (``parallel/tp.py``); M must divide
--num_processes (ValueError otherwise, also for M > 1 in one process).
The checkpoints and ``FE_e*.npz`` are the n_model = 1 layout.
"""

import argparse
import functools
import glob
import json
import os
import time

import torch

from pase_tpu_torch.precision import full_precision


def str2bool(v):
    return str(v).lower() in ("true", "1", "yes")


# the reference's flags that its own trainer never reads (the JAX CLI's
# _DEAD_REFERENCE_FLAGS): accepted, each use noted as a no-op
DEAD_REFERENCE_FLAGS = [
    ("--distortion_p", dict(type=float, default=None)),
    ("--noise_folder", dict(type=str, default=None)),
    ("--whisper_folder", dict(type=str, default=None)),
    ("--net_ckpt", dict(type=str, default=None)),
    ("--log_grad_keys", dict(type=str, nargs="+", default=None)),
    ("--dout", dict(type=float, default=None)),
    ("--nfft", dict(type=int, default=None)),
    ("--fbank_filters", dict(type=int, default=None)),
    ("--gtn_fmin", dict(type=float, default=None)),
    ("--gtn_channels", dict(type=int, default=None)),
    ("--lpc_order", dict(type=int, default=None)),
    ("--hidden_layers", dict(type=int, default=None)),
    ("--hidden_size", dict(type=int, default=None)),
    ("--kaldi_root", dict(type=str, default=None)),
]
# the JAX CLI's compile cache default, which the port never reads
JAX_CACHE_DEFAULT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")
# names the process group's backend (nccl or gloo) over the default, nccl
# on the card and gloo on the CPU: gloo lets several processes share a card
DIST_BACKEND_ENV = "PASE_TORCH_DIST_BACKEND"
# steps per epoch of the synthetic path, as in the JAX CLI
SYNTHETIC_BPE = 100
DEFAULT_DATASET = "LibriSpeechSegTupleWavDataset"
DATASETS = ("LibriSpeechSegTupleWavDataset", "PairWavDataset",
            "GenhancementDataset", "AmiSegTupleWavDataset")


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
    p.add_argument("--num_workers", type=int, default=2,
                   help="host feed threads, each with its own batcher")
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
    p.add_argument("--dropout_rate", type=float, default=0.5)
    p.add_argument("--delta", type=float, default=None)
    p.add_argument("--temp", type=float, default=None)
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--hop", type=int, default=160)
    p.add_argument("--no_continue", type=str, default="False")
    p.add_argument("--zero_speech_p", type=float, default=0.0)
    p.add_argument("--sup_exec", type=str, default=None)
    p.add_argument("--sup_freq", type=int, default=1)
    p.add_argument("--preload_wav", action="store_true", default=False,
                   help="read every wav of the corpus at start")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="synthetic data drawn on the device")
    p.add_argument("--dataset", action="append", default=[],
                   help="LibriSpeechSegTupleWavDataset (default) | "
                        "PairWavDataset | GenhancementDataset | "
                        "AmiSegTupleWavDataset, per --data_root")
    p.add_argument("--clean_root", type=str, default=None,
                   help="the clean tree of GenhancementDataset and of "
                        "AmiSegTupleWavDataset's tree mode (AMI's ihm "
                        "segments)")
    p.add_argument("--ihm2sdm", type=str, default=None,
                   help="AmiSegTupleWavDataset's channel-key mode: the "
                        "distant channels of the cfg entries, e.g. "
                        "1,3,5,7")
    p.add_argument("--cache_feats_dir", type=str, default=None,
                   help="precomputed worker-target cache (data/cache.py)")
    p.add_argument("--trans_cache", type=str, default=None,
                   help="the reference's name of --cache_feats_dir")
    p.add_argument("--zerospeech_cfg", action="append", default=None,
                   help="JSON {noises_dir, noises_snrs}: additive noise "
                        "on the zero-speech rows")
    p.add_argument("--fast_loader", action="store_true", default=False,
                   help="decode and crop in native/libpase_wavio.so")
    p.add_argument("--compute_dtype", type=str, default=None)
    p.add_argument("--loss_precision", type=str, default=None,
                   help="TPU-only (the JAX CLI's fused-loss matmul "
                        "precision): accepted, not used")
    p.add_argument("--n_model", type=int, default=1)
    p.add_argument("--no_fused_feed", action="store_true", default=False,
                   help="TPU-only (the JAX CLI's feed fusion): accepted, "
                        "not used")
    p.add_argument("--jax_cache_dir", type=str, default=JAX_CACHE_DEFAULT,
                   help="TPU-only (the JAX CLI's XLA compile cache): "
                        "accepted, not used")
    p.add_argument("--device_corpus", action="store_true", default=False,
                   help="keep the corpus on the card as int16 and gather "
                        "the crops there")
    p.add_argument("--shard_device_corpus", action="store_true",
                   default=False)
    p.add_argument("--wire_dtype", type=str, default="float32",
                   choices=("float32", "int16"),
                   help="int16 sends host waveform batches as PCM16 "
                        "(lossless for PCM16 corpora)")
    p.add_argument("--gan_cfg", type=str, default=None,
                   help="JSON: {worker, loss, lr, weight} GAN worker; "
                        "type 'z' also takes warmup / zinit_weight / zinc "
                        "and cchunk_prior")
    p.add_argument("--att_cfg", type=str, default=None)
    p.add_argument("--chunking_K", type=int, default=None)
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--pretrained_ckpt", type=str, default=None,
                   help="warm-start the encoder from a native .npz or "
                        "torch .ckpt encoder artifact")
    # the rest of the reference CLI's surface, as the JAX CLI takes it
    g = p.add_argument_group("reference CLI compatibility")
    g.add_argument("--warmup", type=int, default=1000000000,
                   help="epoch to begin the legacy z-adversarial loss; "
                        "< --epoch makes a z gan_cfg (compat_z_gan_cfg)")
    g.add_argument("--zinit_weight", type=float, default=1.0)
    g.add_argument("--zinc", type=float, default=0.0002)
    g.add_argument("--z_lr", type=float, default=0.0004)
    g.add_argument("--adv_loss", type=str, default="BCE",
                   help="BCE or L2")
    g.add_argument("--cchunk_prior", action="store_true", default=False)
    g.add_argument("--rndmin_train", action="store_true", default=False)
    g.add_argument("--att_K", type=int, default=None)
    g.add_argument("--att_mode", type=str, default=None)
    g.add_argument("--avg_factor", type=float, default=None)
    g.add_argument("--do_eval", action="store_true", default=False)
    g.add_argument("--tensorboard", type=str, default=None)
    g.add_argument("--no-cuda", dest="no_cuda", action="store_true",
                   default=False)
    g.add_argument("--cache_on_load", action="store_true", default=False)
    g.add_argument("--vq", action="store_true", default=False)
    g.add_argument("--vq_K", type=int, default=None)
    for flag, kw in DEAD_REFERENCE_FLAGS:
        g.add_argument(flag, **kw)
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="where the step runs (default: the card)")
    return p


def compat_notes(opts):
    """Print the JAX CLI's notes (``apply_reference_compat``) for the
    reference flags that are accepted and do nothing here, and one for the
    TPU-only switches."""
    def note(msg):
        print(f"[compat] {msg}")

    for flag, _ in DEAD_REFERENCE_FLAGS:
        name = flag.lstrip("-")
        if getattr(opts, name) is not None:
            note(f"--{name} accepted but a NO-OP: the reference itself "
                 "never consumes it on the WorkerScheduler path. "
                 "Worker-target parameters come from --net_cfg.")
    if opts.no_cuda:
        note("--no-cuda: accepted, not used; the device is --device's "
             "(default: the card; --device cpu for the CPU)")
    if opts.tensorboard is not None:
        note("--tensorboard: metrics are always JSONL under save_path "
             "(pase_tpu_torch/log.py); no TensorBoard dependency")
    if opts.cache_on_load:
        note("--cache_on_load: lazy wav caching is always on here "
             "(LibriSpeechTupleDataset cache_on_load=True)")
    if opts.do_eval:
        note("--do_eval: the valid split is always evaluated once per "
             "epoch here")
    if opts.vq or opts.vq_K is not None:
        note("--vq/--vq_K: VQ-EMA is configured in --fe_cfg here (e.g. "
             "cfg/frontend/PASE+_resblocks_VQ8192.cfg)")
    tpu_only = [f for f, used in (
        ("--jax_cache_dir", opts.jax_cache_dir != JAX_CACHE_DEFAULT),
        ("--no_fused_feed", opts.no_fused_feed),
        ("--loss_precision", opts.loss_precision is not None)) if used]
    if tpu_only:
        note(f"{' '.join(tpu_only)}: TPU-only switches of the JAX CLI "
             "(XLA compile cache, feed fusion, TPU matmul precision); "
             "accepted, not used")


def resolve_variant_flags(opts):
    """The JAX CLI's handling of the variant flags
    (``apply_reference_compat``): --rndmin_train is --backprop_mode
    select_one (a ValueError with any mode but base / select_one);
    --att_K / --att_mode / --avg_factor override --att_cfg's file, which
    ``opts.att_cfg`` then holds as a dict (a ValueError without
    --att_cfg). Prints the JAX CLI's notes."""
    def note(msg):
        print(f"[compat] {msg}")

    if opts.rndmin_train:
        if opts.backprop_mode not in ("base", "select_one"):
            raise ValueError("--rndmin_train (legacy random-minion "
                             "training = select_one) conflicts with "
                             f"--backprop_mode {opts.backprop_mode}")
        note("--rndmin_train -> --backprop_mode select_one")
        opts.backprop_mode = "select_one"
    if (opts.att_K is not None or opts.att_mode is not None
            or opts.avg_factor is not None):
        if not opts.att_cfg:
            raise ValueError(
                "--att_K/--att_mode/--avg_factor require --att_cfg (the "
                "reference reads them only for the attention variant, "
                "WorkerScheduler/trainer.py:56-62)")
        with open(opts.att_cfg) as f:
            acfg = json.load(f)
        if opts.att_K is not None:
            acfg["K"] = opts.att_K
        if opts.att_mode is not None:
            acfg["att_mode"] = opts.att_mode
        if opts.avg_factor is not None:
            acfg["avg_factor"] = opts.avg_factor
        opts.att_cfg = acfg
        note(f"attention overrides applied: K={acfg.get('K')} "
             f"att_mode={acfg.get('att_mode')} "
             f"avg_factor={acfg.get('avg_factor')}")


def compat_z_gan_cfg(opts, bpe):
    """The legacy z-adversarial flags -> a gan_cfg dict, or None (the JAX
    CLI's ``compat_z_gan_cfg``): the z loss starts at epoch --warmup
    (active when --warmup <= --epoch; the default 1e9 keeps it off), in
    steps max(warmup - 1, 0) * bpe; --adv_loss BCE or L2 (-> LSGAN); not
    together with --gan_cfg."""
    active = opts.warmup <= opts.epoch
    z_flags_given = (opts.zinit_weight != 1.0 or opts.zinc != 0.0002
                     or opts.z_lr != 0.0004 or opts.adv_loss != "BCE"
                     or opts.cchunk_prior)
    if not active:
        if z_flags_given:
            print(f"[compat] z-adversarial flags given but --warmup "
                  f"{opts.warmup} >= --epoch {opts.epoch}: the z loss "
                  "never activates (core.py:302 'epoch to begin' "
                  "semantics)")
        return None
    if opts.gan_cfg:
        raise ValueError("pass either --gan_cfg or the legacy z flags "
                         "(--warmup/--zinit_weight/--zinc/--z_lr/"
                         "--adv_loss/--cchunk_prior), not both")
    loss = {"BCE": "BCE", "L2": "LSGAN"}.get(opts.adv_loss)
    if loss is None:
        raise ValueError(f"--adv_loss {opts.adv_loss}: the reference "
                         "supports BCE or L2 (train.py:406)")
    cfg = {"type": "z",
           "warmup": max(opts.warmup - 1, 0) * bpe,
           "zinit_weight": opts.zinit_weight, "zinc": opts.zinc,
           "lr": opts.z_lr, "loss": loss,
           "cchunk_prior": bool(opts.cchunk_prior)}
    print(f"[compat] legacy z-adversarial flags -> gan_cfg {cfg}")
    return cfg


def check_ported(opts):
    """Raise for a --n_model that does not divide --num_processes, for a
    dataset name the port does not know and for a missing corpus; resolve
    the --trans_cache alias."""
    from pase_tpu_torch.parallel.mesh import grid_shape
    grid_shape(opts.num_processes or 1, opts.n_model)
    if opts.shard_device_corpus and not opts.device_corpus:
        raise ValueError("--shard_device_corpus requires --device_corpus")
    for name in opts.dataset:
        if name not in DATASETS:
            raise ValueError(f"--dataset {name}: one of {DATASETS}")
    if opts.net_cfg is None or opts.fe_cfg is None:
        raise ValueError("--net_cfg and --fe_cfg are required")
    if opts.trans_cache:
        if opts.cache_feats_dir:
            raise ValueError("--trans_cache and --cache_feats_dir are "
                             "the same capability; pass one")
        print(f"[compat] --trans_cache -> --cache_feats_dir "
              f"{opts.trans_cache}")
        opts.cache_feats_dir = opts.trans_cache
    if not opts.synthetic and not (opts.data_root and opts.data_cfg):
        raise ValueError("--data_root and --data_cfg are required "
                         "without --synthetic")


def _nth(lst, i, default=None):
    """The i-th of a repeated flag's values, else its first, else
    ``default``."""
    return lst[i] if i < len(lst) else (lst[0] if lst else default)


def build_datasets(opts):
    """The train and valid tuple datasets of ``--data_root`` /
    ``--data_cfg`` / ``--dataset`` (a ``MetaConcatDataset`` of several,
    with a per-corpus distortion flag from ``--dtrans_cfg``)."""
    from pase_tpu_torch.data import dataset as D
    classes = {"LibriSpeechSegTupleWavDataset": D.LibriSpeechTupleDataset,
               "PairWavDataset": D.PairWavDataset}
    n_ds = len(opts.data_root)

    def make_one(i, split, seed):
        name = _nth(opts.dataset, i, DEFAULT_DATASET)
        if name == "AmiSegTupleWavDataset":
            return D.AmiSegTupleWavDataset(
                opts.data_root[i], opts.clean_root, _nth(opts.data_cfg, i),
                split, ihm2sdm=opts.ihm2sdm, preload_wav=opts.preload_wav,
                seed=seed)
        if name == "GenhancementDataset":
            return D.GenhancementDataset(opts.data_root[i], opts.clean_root,
                                         _nth(opts.data_cfg, i), split,
                                         preload_wav=opts.preload_wav,
                                         seed=seed)
        return classes[name](opts.data_root[i], _nth(opts.data_cfg, i),
                             split, preload_wav=opts.preload_wav,
                             zero_speech_p=opts.zero_speech_p
                             if split == "train" else 0.0, seed=seed)

    def make_ds(split, seed):
        parts = [make_one(i, split, seed + 101 * i) for i in range(n_ds)]
        if len(parts) == 1:
            return parts[0]
        flags = [str(_nth(opts.dtrans_cfg, i, "None")) not in
                 ("None", "none", "") for i in range(n_ds)]
        return D.MetaConcatDataset(parts, dist_flags=flags)

    return make_ds("train", opts.seed), make_ds("valid", opts.seed + 1)


def build_feeds(opts, wk_cfg):
    """(train batcher, valid batcher, steps per epoch, {facts of the feed
    for the log}) of the options: synthetic batches drawn on the device,
    the device corpus (sharded over the processes with
    --shard_device_corpus), or a host feed of ``--num_workers`` threads.
    In a multi-process run each process feeds its ``host_batch_slice`` of
    the global --batch_size, its batchers seeded seed + 1000 x the
    slice's first row (the JAX CLI's per-host seeds); the sharded corpus
    takes the global batch and the base seed."""
    from pase_tpu_torch.data import dataset as D
    from pase_tpu_torch.parallel.mesh import data_world, host_batch_slice
    sl = host_batch_slice(opts.batch_size)
    bs, t = sl.stop - sl.start, opts.chunk_size
    seed0 = opts.seed + 1000 * sl.start
    if opts.synthetic:
        return (D.DeviceSyntheticBatcher(bs, t, seed=seed0,
                                         device=opts.device),
                D.DeviceSyntheticBatcher(bs, t, seed=seed0 + 1,
                                         device=opts.device),
                SYNTHETIC_BPE, {})
    ds, va_ds = build_datasets(opts)
    batcher_cls = D.FastChunkBatcher if opts.fast_loader else D.ChunkBatcher
    if opts.cache_feats_dir:
        if opts.fast_loader or str2bool(opts.random_scale) \
                or opts.zero_speech_p:
            raise ValueError("--cache_feats_dir is incompatible with "
                             "--fast_loader / --random_scale / "
                             "--zero_speech_p")
        from pase_tpu_torch.data.cache import CachedTargetBatcher
        from pase_tpu_torch.model import parse_workers_cfg
        from pase_tpu_torch.ops.features import feature_fn_for_worker
        names = [e["name"] for e in parse_workers_cfg(wk_cfg)["regr"]
                 if feature_fn_for_worker(e["name"], e.get("transform"),
                                          hop=opts.hop) is not None]
        batcher_cls = functools.partial(
            CachedTargetBatcher, cache_dir=opts.cache_feats_dir,
            worker_names=names, hop=opts.hop)
        print(f"Cached targets: {names} from {opts.cache_feats_dir}")
    info = {}
    if opts.device_corpus:
        ds0 = _nth(opts.dataset, 0, DEFAULT_DATASET)
        if len(opts.data_root) != 1 or opts.cache_feats_dir or \
                ds0 not in (DEFAULT_DATASET, "GenhancementDataset",
                            "AmiSegTupleWavDataset") or \
                (opts.ihm2sdm and ds0 == "AmiSegTupleWavDataset"):
            raise ValueError(
                "--device_corpus supports a single corpus: "
                "LibriSpeechSegTupleWavDataset, or a parallel clean/noisy "
                "tree (GenhancementDataset / AMI tree mode — channel-key "
                "--ihm2sdm stays on the host path); no MetaConcat / "
                "--cache_feats_dir")
        if data_world() > 1 and not opts.shard_device_corpus:
            raise ValueError(
                "single-buffer --device_corpus is single-process only; "
                "multi-process runs use --shard_device_corpus (the corpus "
                "sharded over the processes) or --wire_dtype int16")
        from pase_tpu_torch.data.device_corpus import (
            DeviceCorpusBatcher, ShardedDeviceCorpusBatcher)
        t0 = time.perf_counter()
        if opts.shard_device_corpus:
            batcher = ShardedDeviceCorpusBatcher(
                ds, opts.batch_size, t, seed=opts.seed, device=opts.device)
            try:
                va_batcher = ShardedDeviceCorpusBatcher(
                    va_ds, opts.batch_size, t, seed=opts.seed + 1,
                    device=opts.device)
            except ValueError as e:
                # only a valid split with too few prefix groups falls
                # back, and only in a single process
                if "prefix groups" not in str(e) or data_world() > 1:
                    raise
                va_batcher = DeviceCorpusBatcher(va_ds, bs, t,
                                                 seed=seed0 + 1,
                                                 device=opts.device)
            print(f"Sharded device corpus: {batcher.buf_gb:.3f} GB int16 "
                  f"over {batcher.n_shards} shard(s); this rank's shard "
                  f"{batcher.owned_rows}: {batcher.nbytes} bytes on "
                  f"{opts.device}")
        else:
            batcher = DeviceCorpusBatcher(ds, bs, t, seed=seed0,
                                          device=opts.device)
            va_batcher = DeviceCorpusBatcher(va_ds, bs, t, seed=seed0 + 1,
                                             device=opts.device)
        info = {"corpus_bytes": batcher.nbytes,
                "corpus_build_s": time.perf_counter() - t0}
        print(f"Device corpus: {batcher.nbytes / 1e9:.3f} GB int16 on "
              f"{opts.device}, built in {info['corpus_build_s']:.1f} s")
    else:
        batcher = batcher_cls(ds, bs, t, seed=seed0)
        va_batcher = batcher_cls(va_ds, bs, t, seed=seed0 + 1)
    bpe = batcher.bpe
    if not opts.device_corpus and opts.num_workers > 1:
        # N producers, each with its own batcher and seed, into one queue
        batcher = D.ThreadedPrefetcher(
            lambda tid: iter(batcher_cls(ds, bs, t, seed=seed0
                                         + 13 * tid)._make_batch, None),
            n_threads=opts.num_workers, bpe=bpe)
    print(f"Dataset: {ds.total_wav_dur / 16000 / 3600.0:.1f} h train "
          f"audio, bpe={bpe}")
    return batcher, va_batcher, bpe, info


def build_zerospeech(opts, chunk_size):
    """--zerospeech_cfg JSON {noises_dir, noises_snrs} -> (noise bank
    [n, 2 x chunk_size], SNRs), the additive noise of the zero-speech
    rows; (None, (0, 5, 10)) without one or with --zero_speech_p 0."""
    cfgs = [c for c in (opts.zerospeech_cfg or [])
            if str(c) not in ("None", "none", "")]
    if not cfgs:
        return None, (0, 5, 10)
    if opts.zero_speech_p <= 0:
        print("--zerospeech_cfg given but --zero_speech_p is 0: "
              "zero-speech samples never occur")
        return None, (0, 5, 10)
    if opts.device_corpus or opts.synthetic:
        raise ValueError("--zerospeech_cfg needs the host feed (the "
                         "device-corpus / synthetic paths carry no "
                         "zero-speech mask); drop --device_corpus/"
                         "--synthetic")
    if len(set(cfgs)) > 1:
        raise ValueError("one global --zerospeech_cfg is supported "
                         "(repeat the same file per corpus if needed)")
    with open(cfgs[0]) as f:
        z = json.load(f)
    unknown = [k for k in z if k not in ("noises_dir", "noises_snrs")]
    if unknown:
        raise ValueError(f"unknown zerospeech cfg keys {unknown}: "
                         "config_zerospeech takes noises_dir, noises_snrs")
    from pase_tpu_torch.data.distortions import load_wav_bank
    dirs = z.get("noises_dir")
    dirs = dirs if isinstance(dirs, list) else [dirs]
    files = [f for d in dirs for f in glob.glob(os.path.join(d, "*.wav"))]
    if not files:
        raise ValueError(f"no noise wavs under {dirs}")
    bank = load_wav_bank(files, 2 * chunk_size)
    snrs = tuple(z.get("noises_snrs", (0, 5, 10)))
    print(f"Zero-speech additive: {len(files)} noises, snrs {snrs}")
    return bank, snrs


def build_distortions(opts, chunk_size):
    """(DistortionConfig, DistortionAssets, HostDistortionStage) of the
    first ``--dtrans_cfg`` that is not the sentinel "None" (which disables
    a corpus's stack), or (None, None, None). The host stage (codec2_p,
    whisper_p: ``data.host_distortions.build_host_stage``, seeded with
    --seed as in the JAX CLI) is None when the cfg sets neither."""
    from pase_tpu_torch.data.distortions import build_assets, config_from_json
    from pase_tpu_torch.data.host_distortions import build_host_stage
    real = [c for c in (opts.dtrans_cfg or [])
            if str(c) not in ("None", "none", "")]
    if not real:
        return None, None, None
    with open(real[0]) as f:
        dcfg_json = json.load(f)
    cfg = config_from_json(dcfg_json)
    host_stage = build_host_stage(dcfg_json, seed=getattr(opts, "seed", 0))
    return cfg, build_assets(dcfg_json, cfg, chunk_size), host_stage


def check_host_stage(opts, host_stage):
    """The host stage runs on host waveforms: refused with --device_corpus
    (the JAX CLI's ValueError) and with --synthetic (its batches are drawn
    on the device)."""
    if host_stage is None:
        return
    if opts.device_corpus:
        raise ValueError("--device_corpus is incompatible with host-stage "
                         "distortions (codec2/whisperize need host "
                         "waveforms); drop them from --dtrans_cfg")
    if opts.synthetic:
        raise ValueError("--synthetic is incompatible with host-stage "
                         "distortions (codec2/whisperize need host "
                         "waveforms; the synthetic batches are drawn on "
                         "the device); drop them from --dtrans_cfg or "
                         "train from --data_root / --data_cfg")


def train(opts):
    compat_notes(opts)
    resolve_variant_flags(opts)
    check_ported(opts)
    if opts.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device "
                           "(torch.cuda.is_available() is False)")
    from pase_tpu_torch.parallel.mesh import (host_batch_slice,
                                              init_distributed, rank,
                                              rank_device, set_grid, world)
    # one process per card: the process group comes up first; each process
    # then trains on its own card and feeds its rows of the global batch
    multi = init_distributed(opts.coordinator_address, opts.num_processes,
                             opts.process_id, device=opts.device,
                             backend=os.environ.get(DIST_BACKEND_ENV) or None)
    try:
        grid = set_grid(opts.n_model)
        if opts.n_model > 1:
            print(f"mesh: {dict(data=grid.n_data, model=grid.n_model)} "
                  "(data x model)")
        if multi:
            opts.device = str(rank_device(opts.device))
            sl = host_batch_slice(opts.batch_size)
            print(f"multi-process: process {rank()}/{world()} on "
                  f"{opts.device} loads batch rows [{sl.start}:{sl.stop}] "
                  f"of {opts.batch_size}")
        return _train(opts)
    finally:
        if multi:
            torch.distributed.destroy_process_group()


def _train(opts):
    from pase_tpu_torch.data.pipeline import load_stats_pkl
    from pase_tpu_torch.trainer import Trainer
    with open(opts.fe_cfg) as f:
        fe_cfg = json.load(f)
    with open(opts.net_cfg) as f:
        wk_cfg = json.load(f)
    dist_cfg, dist_assets, host_stage = build_distortions(opts,
                                                          opts.chunk_size)
    check_host_stage(opts, host_stage)
    zs_bank, zs_snrs = build_zerospeech(opts, opts.chunk_size)
    batcher, va_batcher, bpe, feed_info = build_feeds(opts, wk_cfg)
    if host_stage is not None:
        from pase_tpu_torch.data.host_distortions import StagedBatcher
        # the train feed only, after its prefetch threads: the stage's
        # draws are made in the consuming thread, in the JAX CLI's order
        print(f"Host distortion stage enabled (probs={host_stage.probs})")
        batcher = StagedBatcher(batcher, host_stage)
    if opts.wire_dtype == "int16" and opts.zero_speech_p > 0:
        print("WARNING: --wire_dtype int16 quantizes zero-speech samples "
              "(~1e-5 amplitude) to silence; prefer float32 here")
    stats = (load_stats_pkl(opts.stats)
             if opts.stats and os.path.exists(opts.stats) else None)
    cfg = vars(opts).copy()
    cfg.update(bpe=bpe, va_bpe=max(bpe // 10, 1),
               random_scale=str2bool(opts.random_scale),
               ckpt_continue=not str2bool(opts.no_continue))
    gan_cfg = json.loads(opts.gan_cfg) if opts.gan_cfg else None
    z_compat = compat_z_gan_cfg(opts, bpe)
    if z_compat is not None:
        gan_cfg = z_compat
    tr = Trainer(fe_cfg, wk_cfg, cfg, stats=stats, dist_cfg=dist_cfg,
                 dist_assets=dist_assets, device=opts.device,
                 zs_bank=zs_bank, zs_snrs=zs_snrs, gan_cfg=gan_cfg)
    try:
        if feed_info:
            tr.logger.log("feed", 0, feed_info)
        tr.train_(batcher, va_batcher, resume=cfg["ckpt_continue"])
        if host_stage is not None:
            tr.logger.log("host_stage", tr.step, host_stage.summary())
    finally:
        tr.logger.close()
    return tr


def main(argv=None):
    opts = build_argparser().parse_args(argv)
    # no TF32 matmuls, convolutions or recurrences: float32 is the JAX
    # CLI's reference precision, and bf16 is chosen explicitly by
    # --compute_dtype
    full_precision()
    os.makedirs(opts.save_path, exist_ok=True)
    with open(os.path.join(opts.save_path, "train.opts"), "w") as f:
        f.write(json.dumps(vars(opts), indent=2))
    return train(opts)


if __name__ == "__main__":
    main()
