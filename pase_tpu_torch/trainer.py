"""Trainer: the PASE+ multi-task training step and epoch loop in PyTorch.

The port of ``pase_tpu/trainer.py`` for the base policy. One step:
  1. prepare the raw batch on the device (targets from the clean chunk,
     ZNorm; ``data/pipeline.py``);
  2. forward the model in train mode: the three streams through the
     encoder as one batch (BatchNorm statistics over all three, running
     stats updated), then every worker head;
  3. per-worker losses, base policy (weights and alpha all ones), the
     summed total;
  4. backward (the QRNN layer through its CUDA forward/backward kernels on
     the card) and one Adam step over the 'frontend' and 'minion' groups,
     the lr of step k being sched(k).
Each worker's parameters get gradients from its own loss only; the
encoder from the sum, scaled per worker by alpha (``scale_grad``). The
five parts run in ``torch.profiler.record_function`` spans named
``pase.prepare``, ``pase.forward``, ``pase.losses``, ``pase.backward`` and
``pase.optimizer``, which ``profiling.py`` reads.

``train_`` runs epochs of ``bpe`` steps with a NaN guard at each logged
step, a 'perf' line per epoch (steps/s, audio-s/s), an eval pass and an
``FE_e{epoch}.npz`` encoder checkpoint. Full train-state checkpoints and
resume are later work (ROADMAP.md, queue 1: checkpoint / resume).
"""

import math
import os
import time

import torch
from torch.profiler import record_function

from pase_tpu_torch.checkpoint import save_variables_npz
from pase_tpu_torch.data.pipeline import make_prepare_fn
from pase_tpu_torch.log import MetricLogger
from pase_tpu_torch.model import build_pase, worker_losses
from pase_tpu_torch.optim import build_optimizer, set_lr
from pase_tpu_torch.scheduling import apply_policy, init_policy_state

class Trainer:

    def __init__(self, frontend_cfg, workers_cfg, cfg, stats=None,
                 device="cuda"):
        self.cfg = dict(cfg)
        self.device = torch.device(device)
        self.mode = self.cfg.get("backprop_mode", "base")
        if self.mode != "base":
            raise NotImplementedError(
                f"backprop_mode {self.mode!r} is not ported yet: ROADMAP.md,"
                " queue 1: off-path model variants (non-base policies)")
        seed = int(self.cfg.get("seed", 0))
        self.model, self.meta = build_pase(
            frontend_cfg, workers_cfg,
            generator=torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.ordered_names = self.model.worker_names
        self.num_workers = len(self.ordered_names)
        self.hop = self.cfg.get("hop", 160)
        self.prepare = make_prepare_fn(
            self.meta, stats=stats, hop=self.hop,
            random_scale=self.cfg.get("random_scale", False))
        self.prep_generator = torch.Generator(
            device=self.device).manual_seed(seed + 1)
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
        self.logger = MetricLogger(self.save_path)

    def _to_device(self, raw):
        return {k: torch.as_tensor(v, dtype=torch.float32,
                                   device=self.device)
                for k, v in raw.items()}

    def train_step(self, raw_batch):
        """One optimizer step on a raw batch; returns the detached
        per-worker losses and 'total'. The parameters' ``.grad`` keep
        this step's gradients until the next step."""
        self.model.train()
        with record_function("pase.prepare"):
            batch = self.prepare(self._to_device(raw_batch),
                                 self.prep_generator)
        set_lr(self.opt, self.scheds, self.step)
        with record_function("pase.forward"):
            _, _, preds, labels = self.model(batch, self.alpha)
        with record_function("pase.losses"):
            losses = worker_losses(self.meta, preds, labels)
            loss_vec = torch.stack([losses[n] for n in self.ordered_names])
            weights, alpha_next, self.policy_state = apply_policy(
                self.mode, loss_vec.detach(), self.policy_state)
            total = torch.sum(weights * loss_vec)
        with record_function("pase.backward"):
            self.opt.zero_grad(set_to_none=True)
            total.backward()
        with record_function("pase.optimizer"):
            self.opt.step()
        self.alpha = alpha_next
        self.step += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["total"] = total.detach()
        return out

    def eval_step(self, raw_batch):
        """Per-worker losses and their sum in eval mode (running BatchNorm
        statistics, no gradient)."""
        self.model.eval()
        with torch.no_grad():
            batch = self.prepare(self._to_device(raw_batch),
                                 self.prep_generator)
            _, _, preds, labels = self.model(batch, 1.0)
            losses = worker_losses(self.meta, preds, labels)
            losses["total"] = sum(losses.values())
        return losses

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_(self, batcher, valid_batcher=None, epochs=None):
        epochs = epochs if epochs is not None else self.epochs
        bpe = self.bpe
        it = iter(batcher)
        for e in range(self.step // bpe, epochs):
            self._sync()
            t0 = time.time()
            for bidx in range(1, bpe + 1):
                losses = self.train_step(next(it))
                if bidx % self.log_freq == 0 or bidx >= bpe:
                    host = {k: float(v) for k, v in losses.items()}
                    gstep = e * bpe + bidx
                    self.logger.log("train", gstep, host)
                    if not math.isfinite(host["total"]):
                        raise FloatingPointError(
                            f"non-finite total loss at step {gstep}: {host}")
            self._sync()
            sps = bpe / (time.time() - t0)
            self.logger.log("perf", (e + 1) * bpe, {
                "steps_per_sec": sps,
                "audio_sec_per_sec": sps * self.batch_size *
                self.chunk_size / 16000})
            if valid_batcher is not None:
                self.evaluate(valid_batcher, epoch=e)
            self.save(e)

    def evaluate(self, batcher, epoch=0, n_batches=None):
        n_batches = n_batches or self.cfg.get("va_bpe", 10)
        running = {}
        it = iter(batcher)
        for _ in range(n_batches):
            for k, v in self.eval_step(next(it)).items():
                running.setdefault(k, []).append(float(v))
        means = {k: sum(v) / len(v) for k, v in running.items()}
        self.logger.log("eval", epoch, means)
        return means

    def save(self, epoch):
        """The encoder-only artifact ``FE_e{epoch}.npz`` (the JAX package's
        native format, which ``wf_builder(...).load_pretrained`` reads)."""
        return save_variables_npz(
            os.path.join(self.save_path, f"FE_e{epoch}.npz"),
            self.model.frontend.state_dict(), self.step)
