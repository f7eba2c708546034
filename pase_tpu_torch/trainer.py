"""Trainer: the PASE+ multi-task training step and epoch loop in PyTorch.

The port of ``pase_tpu/trainer.py``. One step:
  1. prepare the raw batch on the device (targets from the clean chunk,
     ZNorm, the distortion stack on the encoder's chunk when a
     ``DistortionConfig`` and its assets are given; ``data/pipeline.py``);
  2. forward the model in train mode: the three streams through the
     encoder as one batch (BatchNorm statistics over all three, running
     stats updated), then every worker head;
  3. per-worker losses; the backprop policy (``cfg['backprop_mode']``,
     ``scheduling.py``) turns the cls + regr loss vector into this step's
     weights and the next step's per-worker alpha; the total is the
     weighted sum plus the regularizer workers' losses (outside the
     weights), plus the encoder's VQ commitment loss where it has a
     quantizer (reported as 'vq', with 'vq_perplexity', which is not
     summed);
  4. backward (the QRNN layer through its CUDA forward/backward kernels on
     the card) and one optimizer step over the 'frontend' and 'minion'
     groups (``optim.py``: Adam, or ``--fe_opt`` / ``--min_opt``'s rule
     in optax's form), the lr of an update being sched(count), count the
     updates before it (optax's schedule count).
Steps 1-3 (and the eval step) run under ``cfg['compute_dtype']``
(``precision.py``: None / 'float32' or 'bfloat16'), as the JAX step runs
its whole body under the policy. Each worker's parameters get gradients
from its own loss only; the encoder from the sum, scaled per worker by
alpha (``scale_grad``). The five parts run in
``torch.profiler.record_function`` spans named ``pase.prepare``,
``pase.forward``, ``pase.losses``, ``pase.backward`` and
``pase.optimizer``, which ``profiling.py`` reads.

Observability, as the JAX Trainer's cfg keys: ``log_histograms`` adds a
``hist/{worker}`` and a ``hist/gtruth_{worker}`` row per cls / regr
worker to the step's losses ([lo, hi, 24 bin counts] of the materialized
prediction and of the target, ``hist_row``); ``log_grad_norms`` a
``grad_norm/{group}`` per top-level parameter group (the encoder
'frontend', each worker, each 'att_{worker}'), the L2 norm of the
group's gradients after the backward and before the optimizer.
``fused_heads=False`` materializes the wide lps heads' predictions
instead of fusing the head with its loss (``model._fuse_eligible``).

Policies: the loss vector the policy reads is detached; the policy
state (``policy_state``) and alpha live in the train state and its
checkpoint. 'softmax', 'adaptive', 'hyper_volume' and 'MGD' read loss
values: for them the losses are taken without TF32 and, under bf16, the
fused wide heads' products in float32 (the JAX step's HIGH precision).
MGD's alpha is the min-norm (Frank-Wolfe) weights of each worker's
gradient of its loss with respect to the chunk representation (through
``scale_grad`` at the current alpha), taken from the loss forward's own
graph by one ``torch.autograd.grad`` per worker (``retain_graph``): the
JAX step's second forward with the same draws gives the same values, and
here the running statistics move once per step without one. It runs in
the ``pase.mgda`` span.

With a ``gan_cfg`` (``pase_tpu/trainer.py``'s GAN worker) the step also
trains a discriminator D, in the JAX order: (a) inside the main loss, D
in eval mode with its pre-step parameters (detached: D gets no gradient
from it) and u judges the fake (the GAN worker's prediction, type 'wave',
the default; or the chunk embedding, type 'z'), and
``weight * ramp(step) * g_loss`` joins the total (logged as
'<worker>_g' or 'z_g'); ramp is 0 before ``warmup``, then
min(1, zinit_weight + zinc (step - warmup)); (b) after the model's
update, D in train mode on the real (the clean chunk; for 'z' N(0, 1)
draws, or PASE(cchunk) with ``cchunk_prior``) and then on the detached
fake, u advancing at each call, and D's own Adam (b1 0.9, b2 0.999, eps
1e-8, as optax.adam) on 'd_loss', skipped before ``warmup``. A worker
whose cfg loss is LSGAN, GAN or Hinge is routed to the GAN path (its
reconstruction loss zeroed), as in JAX. D's work runs in the
``pase.discriminator`` span.

Randomness: step k's distortion draws come from a generator seeded with
``step_seed(seed + 1, k)`` (``data/dataset.py``), unless the caller hands
the step its draws; the SPC and Gap heads' frame indices from one seeded
with ``step_seed(seed + 2, k)``, unless the batch injects them
(``spc_idx``, ``gap_idx``); the z-GAN's N(0, 1) draws from one seeded
with ``step_seed(seed + 3, k)``, unless the caller hands them
(``z_real``); an encoder's dropout masks (the ASPP blocks of
``encoders.ASPPResEncoder``) from one seeded with ``step_seed(seed + 4,
k)``; the select_half / dropout policies' masks from one seeded with
``step_seed(seed + 5, k)``, unless the caller hands them
(``policy_weights``); the heads' dropin and ``dropout_time`` masks from
one seeded with ``step_seed(seed + 6, k)``; the device batcher's batch k
from ``step_seed(its seed, k)``. A
resumed run therefore replays the uninterrupted run's batches and draws
with no generator state in the checkpoint.

Data parallelism (``parallel/mesh.py``): under a process group of more
than one rank, a rank is fed its ``host_batch_slice`` of the global
``batch_size`` and computes the global batch's step, as the JAX step on
a batch-sharded array does. Every draw above is made for the global
batch from the shared seed and the rank keeps its rows
(``mesh.draw_rows``); BatchNorm and VQ-EMA take their statistics over
the global batch (``nn.py``); the policy reads the ranks' mean loss
vector; MGD's Gram matrix of the per-worker gradients is summed over the
ranks; the gradients (the model's and D's) are averaged by bucketed
all_reduces of the flattened gradients after the backward (the step is
not one wrapped forward: MGD's per-worker gradients and the GAN's two
optimizers run between the forward and the update, so torch's
DistributedDataParallel does not fit it); the returned and logged
losses, the eval means, the ``hist/*`` rows (global lo / hi, summed
counts) and the ``grad_norm/*`` rows (after the all-reduce) are the
global batch's, the same bits on every rank. Only rank 0 writes the
metrics log, checkpoints and ``FE_e*.npz`` and launches the superviser;
every rank resumes from the same files. The attention variant takes its
batch means (the running distribution, 'avg_time_batch''s pooled view)
over the global batch (``mesh.global_mean``).

Column parallelism (``cfg['n_model']``, the JAX CLI's --n_model): the
processes form an n_data x n_model grid (``mesh.set_grid``); "the ranks"
above are the data ranks (the data group), and the n_model ranks of a
model group load the same rows. The model and D are laid out by
``parallel/tp.py`` after their seeded init: each rank holds its part of
every leaf JAX's ``state_shardings`` shards, and the optimizers are built
on those parts (the moments follow, the count stays whole); the layers
compute by output channel or lane and gather where a consumer reads
across channels, so the losses are the same bits on every model rank.
The gradients are averaged over the data group, the whole leaves' made
the first model rank's bits; ``grad_norm/*`` sums the parts' squares
over the model group; ``save`` gathers the state to the n_model = 1
layout (every rank takes part, rank 0 writes), and a resume cuts it to
the parts, so a checkpoint resumes at any n_model.

Feeding: host batches (numpy arrays from a disk batcher) are staged one
step ahead (``stage``): pinned host memory and a non_blocking copy on a
side stream, whose event the step waits on before it reads the batch;
with ``cfg['wire_dtype'] == 'int16'`` the waveforms cross as PCM16 and
the prepare divides them by 32768 on the device. Batches already on the
device (the device corpus, the synthetic batcher) are used in place.

``train_`` resumes from the latest checkpoint in ``save_path`` (unless
``resume=False``), then runs epochs of ``bpe`` steps with a NaN guard at
each logged step, a 'perf' line per epoch (steps/s, audio-s/s), an eval
pass and ``save``: the full train state through the ``Saver``
(``weights_PASE-Pase_base-<step>.npz``, the JAX package's TrainState
layout, readable by either package) and the encoder artifact
``FE_e{epoch}.npz``. ``cfg['pretrained_ckpt']`` warm-starts the encoder.
With ``cfg['sup_exec']`` (a file of command templates) the downstream
probes are launched asynchronously on the epoch's ``FE_e{epoch}.npz``
after its save, every ``cfg['sup_freq']`` epochs and after the last
(``utils.AuxiliarSuperviser``, in ``self.aux_sup``; their $save_path is
``save_path/sup_aux``).
"""

import contextlib
import math
import os
import sys
import time
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from pase_tpu_torch.adversarial import (WaveDiscriminator, ZDiscriminator,
                                        d_loss_fn, g_loss_fn)
from pase_tpu_torch.checkpoint import (Saver, load_frontend_ckpt,
                                       load_model_variables,
                                       restore_train_state,
                                       save_variables_npz,
                                       train_state_to_tree)
from pase_tpu_torch.data.dataset import step_seed
from pase_tpu_torch.data.pipeline import INDEX_KEYS, make_prepare_fn
from pase_tpu_torch.log import MetricLogger
from pase_tpu_torch.model import (FUSED_MIN_CH, build_pase, materialize_pred,
                                  worker_losses)
from pase_tpu_torch.nn import no_tf32
from pase_tpu_torch.optim import OptaxOptimizer, build_optimizer, set_lr
from pase_tpu_torch.parallel import mesh, tp
from pase_tpu_torch.precision import compute_dtype, resolve
from pase_tpu_torch.scheduling import (POLICIES, VALUE_SENSITIVE,
                                       apply_policy, init_policy_state,
                                       mgda_rep_weights,
                                       min_norm_weights_gram)
from pase_tpu_torch.utils import AuxiliarSuperviser

# the run's name in its train-state files, the JAX Trainer's default
NAME = "Pase_base"
# the waveform entries of a batch, which the int16 wire sends as PCM16
WAVE_KEYS = ("chunk", "chunk_ctxt", "chunk_rand", "cchunk")
# worker cfg losses that route a worker to the GAN path (the reference's
# worker_parser), and the GAN loss each names
GAN_WORKER_LOSSES = {"LSGAN": "LSGAN", "GAN": "BCE", "Hinge": "Hinge"}
# the bins of a log_histograms row
HIST_BINS = 24


def hist_row(x, bins=HIST_BINS):
    """[lo, hi, bin counts] (float32, bins + 2) of x's values over bins
    equal bins of [lo, hi + 1e-9): the JAX Trainer's ``_hist``. Under a
    process group, of the global batch: the ranks' lo / hi gathered, the
    counts summed."""
    x = x.detach().reshape(-1).float()
    lo, hi = x.min(), x.max()
    if mesh.data_world() > 1:
        lohi = mesh.gather(torch.stack([lo, hi]))
        lo, hi = lohi[:, 0].min(), lohi[:, 1].max()
    edges = lo + (hi - lo + 1e-9) * torch.arange(
        bins + 1, dtype=torch.float32, device=x.device) / bins
    idx = torch.clamp(torch.searchsorted(edges, x, right=True) - 1,
                      0, bins - 1)
    counts = torch.bincount(idx, minlength=bins).float()
    mesh.all_reduce_([counts])
    return torch.cat([torch.stack([lo, hi]), counts])


def param_group(name):
    """The JAX top-level parameter group of a ``model.PASE`` parameter:
    'frontend', a worker's name or 'att_{worker}'."""
    top, _, rest = name.partition(".")
    return rest.partition(".")[0] if top == "workers" else top


def grad_norms(model):
    """{'grad_norm/{group}': the L2 norm of the group's gradients} (a
    parameter without a gradient counts as zeros, as JAX's are). Under
    --n_model the squares of the leaves held as parts are summed over the
    model group; a leaf every model rank holds whole counts once."""
    groups, parts = {}, {}
    sharded = tp.sharded_params(model)
    for name, p in model.named_parameters():
        key = param_group(name)
        g = groups.setdefault(key, [])
        parts.setdefault(key, [])
        if p.grad is not None:
            (parts[key] if id(p) in sharded else g).append(
                p.grad.detach().reshape(-1).float())

    # sqrt of the sum of squares, as jnp.linalg.norm: torch's CPU
    # vector_norm loses about 1e-4 relative over 10^5-10^6 float32 values
    dev = next(model.parameters()).device

    def sq(v):
        return (torch.sum(torch.cat(v) ** 2) if v
                else torch.zeros((), device=dev))

    sums = {k: sq(v) for k, v in groups.items()}
    if sharded:
        shard_sq = torch.stack([sq(parts[k]) for k in groups])
        mesh.all_reduce_([shard_sq], "sum", mesh.grid().model_group)
        sums = {k: sums[k] + shard_sq[i] for i, k in enumerate(groups)}
    return {f"grad_norm/{k}": torch.sqrt(v) for k, v in sums.items()}


def reduce_grads(module):
    """The gradients of ``module``'s parameters averaged over the data
    ranks (bucketed all_reduces); under --n_model the leaves every model
    rank holds whole take the first model rank's bits."""
    mesh.all_reduce_([p.grad for p in module.parameters()], "mean")
    tp.sync_replicated_grads(module)


def route_gan_workers(meta, gan_cfg, cfg):
    """The gan_cfg of a run: ``gan_cfg`` when given; else a worker whose
    cfg loss is LSGAN, GAN or Hinge becomes the GAN worker (the last one
    found), at D lr ``cfg['z_lr']`` (default 5e-4), and every such
    worker's reconstruction loss is zeroed (L1Loss at weight 0), as the
    JAX Trainer does."""
    if gan_cfg is not None:
        return gan_cfg
    for group in ("regr", "cls"):
        for e in meta[group]:
            if e.get("loss") in GAN_WORKER_LOSSES:
                gan_cfg = {"worker": e["name"],
                           "loss": GAN_WORKER_LOSSES[e["loss"]],
                           "lr": cfg.get("z_lr", 5e-4)}
                e["loss"] = "L1Loss"
                e["loss_weight"] = 0.0
    return gan_cfg


def gan_ramp(gan_cfg, step):
    """The G term's weight factor at ``step``: 0 before ``warmup``, then
    min(1, zinit_weight + zinc (step - warmup)); 1 with the defaults."""
    warmup = int(gan_cfg.get("warmup", 0) or 0)
    if step < warmup:
        return 0.0
    return min(1.0, float(gan_cfg.get("zinit_weight", 1.0))
               + float(gan_cfg.get("zinc", 0.0002)) * (step - warmup))


class Staged(NamedTuple):
    """A batch whose copy to the device was started by ``Trainer.stage``:
    its device tensors and the copy's event (None off the card)."""
    batch: dict
    event: Optional[torch.cuda.Event]


class Trainer:

    def __init__(self, frontend_cfg, workers_cfg, cfg, stats=None,
                 dist_cfg=None, dist_assets=None, device="cuda",
                 zs_bank=None, zs_snrs=(0, 5, 10), gan_cfg=None):
        self.cfg = dict(cfg)
        self.device = torch.device(device)
        # the n_data x n_model grid (--n_model); data parallelism over the
        # data ranks: this rank's rows of the global batch
        self.grid = mesh.set_grid(self.cfg.get("n_model", 1) or 1)
        self.world = self.grid.n_data
        self.rows = None
        if self.world > 1:
            sl = mesh.host_batch_slice(self.cfg.get("batch_size", 32))
            self.rows = mesh.RowShard(sl.start, sl.stop,
                                      self.cfg.get("batch_size", 32))
        self.compute_dtype = resolve(self.cfg.get("compute_dtype"))
        self.mode = self.cfg.get("backprop_mode", "base")
        if self.mode not in POLICIES:
            raise NotImplementedError(self.mode)
        # the JAX Trainer's defaults, with its 'or': 0 means the default
        self.pol_kwargs = dict(
            dropout_rate=self.cfg.get("dropout_rate", 0.5) or 0.5,
            delta=self.cfg.get("delta", 1.5) or 1.5,
            temp=self.cfg.get("temp", 1.0) or 1.0,
            alpha_ema=self.cfg.get("alpha", 0.5) or 0.5)
        self.seed = int(self.cfg.get("seed", 0))
        self.hop = self.cfg.get("hop", 160)
        # the z-GAN's cchunk prior needs PASE(cchunk)
        z_prior = bool(gan_cfg and gan_cfg.get("type") == "z"
                       and gan_cfg.get("cchunk_prior"))
        self.model, self.meta = build_pase(
            frontend_cfg, workers_cfg,
            generator=torch.Generator().manual_seed(self.seed),
            force_cchunk=z_prior, att_cfg=self.cfg.get("att_cfg"),
            chunking_K=self.cfg.get("chunking_K"),
            frames=self.cfg.get("chunk_size", 16000) // self.hop,
            fused_min_ch=(FUSED_MIN_CH if self.cfg.get("fused_heads", True)
                          else 0))
        self.log_hists = bool(self.cfg.get("log_histograms", False))
        self.log_grads = bool(self.cfg.get("log_grad_norms", False))
        if self.cfg.get("pretrained_ckpt"):
            load_frontend_ckpt(self.cfg["pretrained_ckpt"],
                               self.model.frontend)
        self.model.to(self.device)
        mesh.replicate(self.model)
        tp.shard_model(self.model, self.grid)
        # the loss vector (and alpha) is cls + regr; the regularizers'
        # losses join the total outside the policy's weights
        self.ordered_names = [e["name"] for e in self.meta["cls"]
                              + self.meta["regr"]]
        self.regu_names = [e["name"] for e in self.meta["regu"]]
        self.num_workers = len(self.ordered_names)
        self.prepare = make_prepare_fn(
            self.meta, stats=stats, dist_cfg=dist_cfg, assets=dist_assets,
            hop=self.hop,
            random_scale=self.cfg.get("random_scale", False),
            zs_bank=zs_bank, zs_snrs=zs_snrs)
        self.prep_generator = torch.Generator(device=self.device)
        self.sample_generator = torch.Generator(device=self.device)
        self.dropout_generator = None
        if hasattr(self.model.frontend, "dropout_generator"):
            self.dropout_generator = torch.Generator(device=self.device)
            self.model.frontend.dropout_generator = self.dropout_generator
        self.policy_generator = torch.Generator(device=self.device)
        self.head_generator = torch.Generator(device=self.device)
        for m in self.model.workers.modules():
            if hasattr(m, "dropout_generator"):
                m.dropout_generator = self.head_generator
        self.last_weights = None    # the policy's weights of the last step
        wire = str(self.cfg.get("wire_dtype") or "float32")
        if wire not in ("float32", "int16"):
            raise ValueError(f"wire_dtype {wire!r}: float32 or int16")
        self.wire_int16 = wire == "int16"
        self._copy_stream = None
        self.bpe = self.cfg.get("bpe", 100)
        self.epochs = self.cfg.get("epoch", 100)
        self.save_path = self.cfg.get("save_path", "ckpt")
        self.log_freq = self.cfg.get("log_freq", 100)
        self.chunk_size = self.cfg.get("chunk_size", 16000)
        self.batch_size = self.cfg.get("batch_size", 32)
        self.opt, self.scheds = build_optimizer(
            self.model,
            fe_opt=self.cfg.get("fe_opt", "Adam"),
            min_opt=self.cfg.get("min_opt", "Adam"),
            fe_lr=self.cfg.get("fe_lr", 1e-3),
            min_lr=self.cfg.get("min_lr", 5e-4),
            lr_mode=self.cfg.get("lr_mode", "poly"),
            epochs=self.epochs, bpe=self.bpe,
            lr_step=self.cfg.get("lrdec_step", 30),
            lr_gamma=float(self.cfg.get("lrdecay") or 0) or 0.1)
        self.policy_state = init_policy_state(self.num_workers, self.device)
        self.alpha = torch.ones(self.num_workers, device=self.device)
        self.step = 0
        self.opt_count = 0          # optimizer updates: the lr schedule's
        self.gan_cfg = route_gan_workers(self.meta, gan_cfg, self.cfg)
        self.discriminator = self.d_opt = None
        if self.gan_cfg is not None:
            self._build_discriminator()
        self.aux_sup = None         # the sup_exec probes' launcher
        self.logger = MetricLogger(self.save_path, rank=mesh.rank())
        self.saver = Saver(self.save_path,
                           max_ckpts=self.cfg.get("max_ckpts", 5),
                           prefix="PASE-")

    def _build_discriminator(self):
        """D (drawn from a generator seeded with seed + 3) on the device,
        its Adam at gan_cfg's lr (or z_lr), and the z prior's generator."""
        gen = torch.Generator().manual_seed(self.seed + 3)
        if self.gan_cfg.get("type", "wave") == "z":
            d = ZDiscriminator(self.model.frontend.output_dim,
                               generator=gen)
        else:
            d = WaveDiscriminator(generator=gen)
        self.discriminator = mesh.replicate(d.to(self.device))
        tp.shard_model(d, self.grid)
        lr = self.gan_cfg.get("lr", self.gan_cfg.get("z_lr", 5e-4))
        self.d_opt = OptaxOptimizer([{"params": list(d.parameters()),
                                      "lr": lr, "rule": "adam"}])
        self.z_generator = torch.Generator(device=self.device)

    def _gan_fake(self, h, chunk, preds):
        """(fake, the z prior's real or None, the G term's log name)."""
        gan = self.gan_cfg
        if gan.get("type", "wave") == "z":
            prior = h["cchunk"] if gan.get("cchunk_prior") else None
            return chunk, prior, "z_g"
        worker = gan.get("worker", "cchunk")
        # the prediction [B, T, 1] -> the discriminator's [B, 1, T]
        fake = materialize_pred(preds[worker]).transpose(1, 2)
        return fake, None, f"{worker}_g"

    def _gan_generator_loss(self, fake):
        """g_loss of D in eval mode (its current u, not advanced) with its
        parameters detached: the gradient reaches the fake only."""
        d = self.discriminator.eval()
        state = {k: p.detach() for k, p in d.named_parameters()}
        state.update(d.named_buffers())
        d_on_fake = torch.func.functional_call(d, state, (fake,))
        return g_loss_fn(d_on_fake, self.gan_cfg.get("loss", "LSGAN"))

    def _gan_discriminator_step(self, batch, fake, prior, z_real):
        """D's loss on real then the detached fake (train mode, u
        advancing at each call) and, from ``warmup`` on, its Adam step;
        returns the detached d_loss."""
        gan = self.gan_cfg
        if gan.get("type", "wave") == "z":
            if prior is not None:
                real = prior.detach()
            elif z_real is not None:
                real = torch.as_tensor(z_real, device=self.device)
            else:
                self.z_generator.manual_seed(
                    step_seed(self.seed + 3, self.step))
                real = mesh.draw_rows(lambda m: torch.randn(
                    (m,) + fake.shape[1:], generator=self.z_generator,
                    device=self.device), fake.shape[0])
        else:
            real = batch["cchunk"][:, None, :]
        d = self.discriminator.train()
        d_loss = d_loss_fn(d(real), d(fake.detach()),
                           gan.get("loss", "LSGAN"))
        if self.step >= int(gan.get("warmup", 0) or 0):
            self.d_opt.zero_grad(set_to_none=True)
            d_loss.backward()
            reduce_grads(d)
            self.d_opt.step()
        return d_loss.detach()

    def _host_tensor(self, key, v):
        """A host batch entry as the tensor that crosses the wire: int16
        stays int16, waveforms become int16 under the int16 wire, the rest
        float32, injected frame indices int64. A tensor already on the
        device is returned as it is."""
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            return v
        v = torch.as_tensor(v)
        if key in INDEX_KEYS:
            return v.long()
        if v.dtype == torch.int16:
            return v
        if self.wire_int16 and key in WAVE_KEYS:
            # exact for PCM16-sourced audio: read_wav's x is the stored
            # sample / 32768
            return torch.clamp(v * 32768.0, -32768, 32767).to(torch.int16)
        return v.to(torch.float32)

    def stage(self, raw):
        """Start a raw batch's copy to the device: host entries go through
        pinned memory as non_blocking copies on a side stream (on the
        card), entries already on the device stay there. Returns a
        ``Staged``; ``train_step`` waits for its copy before the step
        reads it."""
        host = {k: self._host_tensor(k, v) for k, v in raw.items()}
        if self.device.type != "cuda":
            return Staged({k: v.to(self.device) for k, v in host.items()},
                          None)
        if all(v.device.type != "cpu" for v in host.values()):
            return Staged(host, None)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        out = {}
        with torch.cuda.stream(self._copy_stream):
            for k, v in host.items():
                out[k] = (v if v.device.type != "cpu" else
                          v.pin_memory().to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return Staged(out, event)

    def ready(self, raw_batch):
        """The device batch of a raw or staged batch, safe to read on the
        current stream."""
        staged = (raw_batch if isinstance(raw_batch, Staged)
                  else self.stage(raw_batch))
        if staged.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.event)
            for v in staged.batch.values():
                # freed only once this stream's use of it has completed
                v.record_stream(stream)
        return staged.batch

    def mgda_alpha(self, loss_vec, chunk):
        """MGDA-UB weights [n]: each worker's gradient of its loss with
        respect to the chunk representation, from the loss forward's
        graph (kept for the step's backward), then ``mgda_rep_weights``
        in float32 without TF32. Under a process group the Gram matrix of
        the gradients is summed over the ranks (each holds its rows)
        before the min-norm solve."""
        grads = [torch.autograd.grad(loss_vec[i], chunk, retain_graph=True)[0]
                 for i in range(loss_vec.shape[0])]
        g = torch.stack(grads).float()
        with no_tf32():
            if self.world == 1:
                return mgda_rep_weights(g)
            flat = g.reshape(g.shape[0], -1)
            gram = flat @ flat.t()
            mesh.all_reduce_([gram])
            return min_norm_weights_gram(gram)

    def train_step(self, raw_batch, draws=None, zs_draws=None, z_real=None,
                   policy_weights=None):
        """``_train_step`` with this rank's rows of the global batch (the
        step's draws made for the global batch, ``mesh.draw_rows``)."""
        with mesh.row_shard(self.rows):
            return self._train_step(raw_batch, draws, zs_draws, z_real,
                                    policy_weights)

    def _train_step(self, raw_batch, draws=None, zs_draws=None, z_real=None,
                    policy_weights=None):
        """One optimizer step on a raw batch (host arrays, device tensors,
        or a ``Staged`` from ``stage``); returns the detached per-worker
        losses and 'total' (with a GAN, also the G term and 'd_loss').
        ``draws`` (a ``DistortionDraws``) and ``zs_draws`` (a
        ``ZeroSpeechDraws``) replace the step's own draws, ``z_real``
        ([B, emb, F]) the z-GAN's N(0, 1) draw, ``policy_weights`` ([n])
        select_half's / dropout's mask. The parameters' ``.grad`` keep
        this step's gradients until the next step, ``last_weights`` the
        policy's weights. Under a process group the step is the global
        batch's: the injected draws are this rank's rows, the policy reads
        the ranks' mean loss vector, the gradients are averaged over the
        ranks before the optimizer, and the returned losses are the ranks'
        means (the same bits on every rank)."""
        self.model.train()
        self.prep_generator.manual_seed(step_seed(self.seed + 1, self.step))
        self.sample_generator.manual_seed(
            step_seed(self.seed + 2, self.step))
        if self.dropout_generator is not None:
            self.dropout_generator.manual_seed(
                step_seed(self.seed + 4, self.step))
        self.policy_generator.manual_seed(
            step_seed(self.seed + 5, self.step))
        self.head_generator.manual_seed(step_seed(self.seed + 6, self.step))
        value_sensitive = self.mode in VALUE_SENSITIVE
        if draws is not None:
            draws = draws.to(self.device)
        if zs_draws is not None:
            zs_draws = zs_draws.to(self.device)
        with compute_dtype(self.compute_dtype):
            with record_function("pase.prepare"):
                batch = self.prepare(self.ready(raw_batch),
                                     self.prep_generator, draws, zs_draws)
            set_lr(self.opt, self.scheds, self.opt_count)
            with record_function("pase.forward"):
                h, chunk, preds, labels = self.model(batch, self.alpha,
                                                     self.sample_generator)
            with record_function("pase.losses"), (
                    no_tf32() if value_sensitive
                    else contextlib.nullcontext()):
                losses = worker_losses(self.meta, preds, labels,
                                       float32=value_sensitive)
                loss_vec = torch.stack([losses[n]
                                        for n in self.ordered_names])
                mg_alpha = None
                if self.mode == "MGD":
                    with record_function("pase.mgda"):
                        mg_alpha = self.mgda_alpha(loss_vec, chunk)
                global_vec = loss_vec.detach()
                if self.world > 1:
                    global_vec = global_vec.clone()
                    mesh.all_reduce_([global_vec], "mean")
                weights, alpha_next, self.policy_state = apply_policy(
                    self.mode, global_vec, self.policy_state,
                    self.policy_generator, mgda_alpha=mg_alpha,
                    weights=policy_weights, **self.pol_kwargs)
                self.last_weights = weights
                total = torch.sum(weights * loss_vec)
                for n in self.regu_names:
                    total = total + losses[n]
                fe = self.model.frontend
                if fe.vq_loss is not None:
                    # the commitment loss trains the encoder toward the
                    # codebook; the perplexity is reported only
                    losses["vq"] = fe.vq_loss
                    total = total + fe.vq_loss
                    losses["vq_perplexity"] = fe.vq_perplexity
                if self.log_hists:
                    with torch.no_grad():
                        for n in self.ordered_names:
                            losses[f"hist/{n}"] = hist_row(
                                materialize_pred(preds[n]))
                            losses[f"hist/gtruth_{n}"] = hist_row(labels[n])
                if self.gan_cfg is not None:
                    fake, prior, name_g = self._gan_fake(h, chunk, preds)
                    with record_function("pase.discriminator"):
                        losses[name_g] = self._gan_generator_loss(fake)
                    total = total + (self.gan_cfg.get("weight", 1.0)
                                     * gan_ramp(self.gan_cfg, self.step)
                                     * losses[name_g])
        with record_function("pase.backward"):
            self.opt.zero_grad(set_to_none=True)
            total.backward()
            reduce_grads(self.model)
        if self.log_grads:
            losses.update(grad_norms(self.model))
        with record_function("pase.optimizer"):
            self.opt.step()
        if self.gan_cfg is not None:
            with record_function("pase.discriminator"), \
                    compute_dtype(self.compute_dtype):
                losses["d_loss"] = self._gan_discriminator_step(
                    batch, fake, prior, z_real)
        self.alpha = alpha_next
        self.step += 1
        self.opt_count += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["total"] = total.detach()
        return self._global_means(out)

    def _global_means(self, losses):
        """The ranks' mean of each scalar loss (one all_reduce); the rows
        and norms that are already the global batch's stay as they are."""
        if self.world == 1:
            return losses
        local = {k: v for k, v in losses.items()
                 if v.dim() == 0 and k != "vq_perplexity"
                 and not k.startswith("grad_norm/")}
        return {**losses, **mesh.all_reduce_dict(local, "mean")}

    def eval_step(self, raw_batch):
        """Per-worker losses and their sum in eval mode (running BatchNorm
        statistics, no gradient), under the training compute dtype; under
        a process group the ranks' means."""
        self.model.eval()
        with torch.no_grad(), compute_dtype(self.compute_dtype), \
                mesh.row_shard(self.rows):
            batch = self.prepare(self.ready(raw_batch),
                                 self.prep_generator)
            _, _, preds, labels = self.model(batch, 1.0,
                                             self.sample_generator)
            losses = worker_losses(self.meta, preds, labels)
            losses["total"] = sum(losses.values())
            vq = self.model.frontend.vq_loss
            if vq is not None:
                # the train step's objective: the commitment term too
                losses["vq"] = vq
                losses["total"] = losses["total"] + vq
        return self._global_means(losses)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fetch(self, it, clock):
        """Read the next raw batch of ``it`` and stage it; adds the host's
        wait for the batch and the staging's host time to ``clock``."""
        t0 = time.perf_counter()
        raw = next(it)
        t1 = time.perf_counter()
        staged = self.stage(raw)
        clock["feed"] += t1 - t0
        clock["stage"] += time.perf_counter() - t1
        return staged

    def train_(self, batcher, valid_batcher=None, epochs=None, resume=True):
        """Epochs from the current (or, with ``resume``, the latest saved)
        step on. A batcher with ``batches(step)`` is fed from the resumed
        step, so a resumed run sees the batches the uninterrupted run saw
        there; any other iterable is read from its start. The next batch
        is read and its copy to the device started while the card runs the
        current step; the perf line reports the host's wait for batches
        and the staging's host time per step."""
        if resume:
            self.try_resume()
        epochs = epochs if epochs is not None else self.epochs
        bpe = self.bpe
        it = (batcher.batches(self.step) if hasattr(batcher, "batches")
              else iter(batcher))
        staged = None
        try:
            for e in range(self.step // bpe, epochs):
                self._sync()
                t0 = time.time()
                clock = {"feed": 0.0, "stage": 0.0}
                for bidx in range(1, bpe + 1):
                    batch = (staged if staged is not None
                             else self._fetch(it, clock))
                    losses = self.train_step(batch)
                    staged = (None if e == epochs - 1 and bidx == bpe
                              else self._fetch(it, clock))
                    if bidx % self.log_freq == 0 or bidx >= bpe:
                        host = {k: float(v) if v.dim() == 0 else v.tolist()
                                for k, v in losses.items()}
                        gstep = e * bpe + bidx
                        self.logger.log("train", gstep, host)
                        if not math.isfinite(host["total"]):
                            raise FloatingPointError(
                                f"non-finite total loss at step {gstep}: "
                                f"{host}")
                self._sync()
                sps = bpe / (time.time() - t0)
                self.logger.log("perf", (e + 1) * bpe, {
                    "steps_per_sec": sps,
                    "audio_sec_per_sec": sps * self.batch_size *
                    self.chunk_size / 16000,
                    "feed_wait_ms": 1e3 * clock["feed"] / bpe,
                    "stage_ms": 1e3 * clock["stage"] / bpe})
                if valid_batcher is not None:
                    self.evaluate(valid_batcher, epoch=e)
                self.save(e)
                self._supervise(e, epochs)
        finally:
            _close(it)

    def _supervise(self, epoch, epochs):
        """Launch the ``sup_exec`` probes on this epoch's encoder artifact
        where ``(epoch + 1) % sup_freq == 0`` or it is the last epoch
        (``utils.AuxiliarSuperviser``, its children's handles kept in
        ``self.aux_sup``)."""
        sup_exec = self.cfg.get("sup_exec")
        sup_freq = self.cfg.get("sup_freq", 1)
        if not sup_exec or mesh.rank() != 0 or not (
                (epoch + 1) % sup_freq == 0 or (epoch + 1) >= epochs):
            return
        if self.aux_sup is None:
            aux_path = os.path.join(self.save_path, "sup_aux")
            os.makedirs(aux_path, exist_ok=True)
            self.aux_sup = AuxiliarSuperviser(sup_exec, aux_path)
        self.aux_sup(epoch, os.path.join(self.save_path, f"FE_e{epoch}.npz"),
                     self.cfg.get("fe_cfg") or "")

    def evaluate(self, batcher, epoch=0, n_batches=None):
        n_batches = n_batches or self.cfg.get("va_bpe", 10)
        running = {}
        it = iter(batcher)
        try:
            for _ in range(n_batches):
                for k, v in self.eval_step(next(it)).items():
                    running.setdefault(k, []).append(float(v))
        finally:
            _close(it)
        means = {k: sum(v) / len(v) for k, v in running.items()}
        self.logger.log("eval", epoch, means)
        return means

    def save(self, epoch):
        """The full train state through the Saver (params, BatchNorm
        stats, Adam moments and counts, policy state, alpha, rng, step),
        then the encoder-only artifact ``FE_e{epoch}.npz`` (the JAX
        package's native format, which ``wf_builder(...).load_pretrained``
        reads). Returns the artifact's path. Under a process group only rank
        0 writes (every rank holds the same state)."""
        path = os.path.join(self.save_path, f"FE_e{epoch}.npz")
        if mesh.rank() != 0 and self.grid.n_model == 1:
            return path
        # under --n_model every rank gathers its parts (the n_model = 1
        # layout), rank 0 writes
        tree = train_state_to_tree(self)
        fe = tp.full_state_dict(self.model.frontend)
        if mesh.rank() != 0:
            return path
        self.saver.save(NAME, tree, self.step)
        return save_variables_npz(path, fe, self.step)

    def try_resume(self):
        """Load the Saver's current checkpoint into this trainer; returns
        its step, or None without one. A legacy weights-only checkpoint
        resumes params, BatchNorm stats and the step with fresh Adam
        state (a warning says so); otherwise the restore is strict and
        the index's step must equal the state's."""
        flat, meta = self.saver.load_weights()
        if flat is None:
            return None
        step = int(meta.get("step", 0))
        if not any(k.startswith("opt_state/") for k in flat):
            print("[trainer] WARNING: legacy checkpoint without optimizer "
                  "state; resuming weights only (Adam moments reset)",
                  file=sys.stderr)
            load_model_variables(self.model, {
                k: v for k, v in flat.items()
                if k.startswith(("params/", "batch_stats/"))})
            self.step = step
            return step
        restore_train_state(self, flat)
        if self.step != step:
            raise ValueError(f"checkpoint step mismatch: index says {step}, "
                             f"state holds {self.step}")
        return step


def _close(it):
    """Close a generator (a batcher's prefetch threads stop with it)."""
    close = getattr(it, "close", None)
    if close is not None:
        close()
