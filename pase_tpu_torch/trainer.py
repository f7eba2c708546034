"""Trainer: the PASE+ multi-task training step and epoch loop in PyTorch.

The port of ``pase_tpu/trainer.py`` for the base policy. One step:
  1. prepare the raw batch on the device (targets from the clean chunk,
     ZNorm, the distortion stack on the encoder's chunk when a
     ``DistortionConfig`` and its assets are given; ``data/pipeline.py``);
  2. forward the model in train mode: the three streams through the
     encoder as one batch (BatchNorm statistics over all three, running
     stats updated), then every worker head;
  3. per-worker losses, base policy (weights and alpha all ones), the
     summed total, plus the encoder's VQ commitment loss where it has a
     quantizer (reported as 'vq', with 'vq_perplexity', which is not
     summed);
  4. backward (the QRNN layer through its CUDA forward/backward kernels on
     the card) and one Adam step over the 'frontend' and 'minion' groups,
     the lr of an update being sched(count), count the updates before it
     (optax's schedule count).
Steps 1-3 (and the eval step) run under ``cfg['compute_dtype']``
(``precision.py``: None / 'float32' or 'bfloat16'), as the JAX step runs
its whole body under the policy. Each worker's parameters get gradients
from its own loss only; the encoder from the sum, scaled per worker by
alpha (``scale_grad``). The five parts run in
``torch.profiler.record_function`` spans named ``pase.prepare``,
``pase.forward``, ``pase.losses``, ``pase.backward`` and
``pase.optimizer``, which ``profiling.py`` reads.

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
k)``; the device batcher's batch k from ``step_seed(its seed, k)``. A
resumed run therefore replays the uninterrupted run's batches and draws
with no generator state in the checkpoint.

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
from pase_tpu_torch.model import build_pase, materialize_pred, worker_losses
from pase_tpu_torch.optim import build_optimizer, set_lr
from pase_tpu_torch.precision import compute_dtype, resolve
from pase_tpu_torch.scheduling import apply_policy, init_policy_state
from pase_tpu_torch.utils import AuxiliarSuperviser

# the run's name in its train-state files, the JAX Trainer's default
NAME = "Pase_base"
# the waveform entries of a batch, which the int16 wire sends as PCM16
WAVE_KEYS = ("chunk", "chunk_ctxt", "chunk_rand", "cchunk")
# worker cfg losses that route a worker to the GAN path (the reference's
# worker_parser), and the GAN loss each names
GAN_WORKER_LOSSES = {"LSGAN": "LSGAN", "GAN": "BCE", "Hinge": "Hinge"}


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
        self.compute_dtype = resolve(self.cfg.get("compute_dtype"))
        self.mode = self.cfg.get("backprop_mode", "base")
        if self.mode != "base":
            raise NotImplementedError(
                f"backprop_mode {self.mode!r} is not ported yet: ROADMAP.md,"
                " queue 1: off-path model variants (non-base policies)")
        self.seed = int(self.cfg.get("seed", 0))
        # the z-GAN's cchunk prior needs PASE(cchunk)
        z_prior = bool(gan_cfg and gan_cfg.get("type") == "z"
                       and gan_cfg.get("cchunk_prior"))
        self.model, self.meta = build_pase(
            frontend_cfg, workers_cfg,
            generator=torch.Generator().manual_seed(self.seed),
            force_cchunk=z_prior)
        if self.cfg.get("pretrained_ckpt"):
            load_frontend_ckpt(self.cfg["pretrained_ckpt"],
                               self.model.frontend)
        self.model.to(self.device)
        self.ordered_names = self.model.worker_names
        self.num_workers = len(self.ordered_names)
        self.hop = self.cfg.get("hop", 160)
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
        self.logger = MetricLogger(self.save_path)
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
        self.discriminator = d.to(self.device)
        lr = self.gan_cfg.get("lr", self.gan_cfg.get("z_lr", 5e-4))
        self.d_opt = torch.optim.Adam(d.parameters(), lr=lr,
                                      betas=(0.9, 0.999), eps=1e-8)
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
                real = torch.randn(fake.shape, generator=self.z_generator,
                                   device=self.device)
        else:
            real = batch["cchunk"][:, None, :]
        d = self.discriminator.train()
        d_loss = d_loss_fn(d(real), d(fake.detach()),
                           gan.get("loss", "LSGAN"))
        if self.step >= int(gan.get("warmup", 0) or 0):
            self.d_opt.zero_grad(set_to_none=True)
            d_loss.backward()
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

    def train_step(self, raw_batch, draws=None, zs_draws=None, z_real=None):
        """One optimizer step on a raw batch (host arrays, device tensors,
        or a ``Staged`` from ``stage``); returns the detached per-worker
        losses and 'total' (with a GAN, also the G term and 'd_loss').
        ``draws`` (a ``DistortionDraws``) and ``zs_draws`` (a
        ``ZeroSpeechDraws``) replace the step's own draws, ``z_real``
        ([B, emb, F]) the z-GAN's N(0, 1) draw. The parameters' ``.grad``
        keep this step's gradients until the next step."""
        self.model.train()
        self.prep_generator.manual_seed(step_seed(self.seed + 1, self.step))
        self.sample_generator.manual_seed(
            step_seed(self.seed + 2, self.step))
        if self.dropout_generator is not None:
            self.dropout_generator.manual_seed(
                step_seed(self.seed + 4, self.step))
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
            with record_function("pase.losses"):
                losses = worker_losses(self.meta, preds, labels)
                loss_vec = torch.stack([losses[n]
                                        for n in self.ordered_names])
                weights, alpha_next, self.policy_state = apply_policy(
                    self.mode, loss_vec.detach(), self.policy_state)
                total = torch.sum(weights * loss_vec)
                fe = self.model.frontend
                if fe.vq_loss is not None:
                    # the commitment loss trains the encoder toward the
                    # codebook; the perplexity is reported only
                    losses["vq"] = fe.vq_loss
                    total = total + fe.vq_loss
                    losses["vq_perplexity"] = fe.vq_perplexity
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
        return out

    def eval_step(self, raw_batch):
        """Per-worker losses and their sum in eval mode (running BatchNorm
        statistics, no gradient), under the training compute dtype."""
        self.model.eval()
        with torch.no_grad(), compute_dtype(self.compute_dtype):
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
        return losses

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
                        host = {k: float(v) for k, v in losses.items()}
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
        if not sup_exec or not ((epoch + 1) % sup_freq == 0
                                or (epoch + 1) >= epochs):
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
        reads). Returns the artifact's path."""
        self.saver.save(NAME, train_state_to_tree(self), self.step)
        return save_variables_npz(
            os.path.join(self.save_path, f"FE_e{epoch}.npz"),
            self.model.frontend.state_dict(), self.step)

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
