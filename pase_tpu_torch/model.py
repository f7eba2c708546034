"""PASE multi-task model: the encoder and the worker bank, in PyTorch.

The port of ``pase_tpu/model.py`` for the MLP and decoder heads of the
workers+ bank, the overlap head (an MLP on the chunk stream, BCE on the
overlap distortion's frame label), the SPC and Gap heads of the PASE
v0.1 bank (on the chunk stream; their frame draws come from the
generator the caller passes, or from ``batch['spc_idx']`` /
``batch['gap_idx']``), the GRU head and the WaveRNN vocoder worker
(``wavernn.py``: the chunk stream's frames, edge-padded by ``pad``,
condition it; it is teacher-forced on the clean chunk shifted by one
sample, and its RAW (mu-law cross entropy) or MOL loss reads the clean
chunk). The encoder runs ONCE on the
concatenated {chunk, ctxt, rand} batch, so its BatchNorm statistics span
the three streams together as in the JAX package; every worker reads the
shared hidden, and the LIM / GIM pairs and labels are made in the
forward.

Worker configs are the reference JSON worker cfgs (cfg/workers/*.cfg).
Layout: the encoder returns [B, T, emb] (NTC); the heads run in the
reference torch layout [B, C, T]; predictions, labels and targets handed
to the losses are NTC, as in the JAX package.
"""

import json

import torch
from torch import nn

from pase_tpu_torch.frontend import build_frontend_module, load_cfg
from pase_tpu_torch.losses import framed_mse_linear, make_loss
from pase_tpu_torch.minions import (DecoderMinion, GapMinion, GRUMinion,
                                    MLPMinion, SPCMinion, make_mi_labels,
                                    make_mi_samples, scale_grad)
from pase_tpu_torch.wavernn import (WaveRNNMinion,
                                    discretized_mix_logistic_loss, raw_loss)

ROADMAP_HEADS = "ROADMAP.md, queue 1: off-path model variants"

_MINION_FIELDS = {
    "mlp": ("num_outputs", "hidden_size", "hidden_layers", "context",
            "tie_context_weights", "dropout", "dropout_time", "dropin",
            "dropin_mode", "ratio_fixed", "range_fixed", "drop_channels",
            "r", "skip"),
    "decoder": ("num_outputs", "fmaps", "strides", "kwidths", "hidden_size",
                "hidden_layers", "dropout", "dropout_time", "norm_type",
                "skip"),
    "gru": ("num_outputs", "hidden_size", "hidden_layers", "dropout", "skip"),
    "spc": ("num_outputs", "hidden_size", "hidden_layers", "ctxt_frames",
            "seq_pad", "dropout", "skip"),
    "gap": ("num_outputs", "hidden_size", "hidden_layers", "dropout", "skip"),
    "wavernn": ("num_inputs", "rnn_dims", "fc_dims", "bits", "hop_length",
                "mode", "pad", "upsample_scales", "res_out_dims"),
}
_MINION_CLS = {"mlp": MLPMinion, "decoder": DecoderMinion, "gru": GRUMinion,
               "spc": SPCMinion, "gap": GapMinion, "wavernn": WaveRNNMinion}


def parse_workers_cfg(cfg):
    """Load a reference worker cfg JSON (path or dict) as {'regr': [...],
    'cls': [...], 'regu': [...]}; every entry gets a type (default 'mlp')
    and a loss_weight (default 1)."""
    if isinstance(cfg, str):
        with open(cfg, "r") as f:
            cfg = json.load(f)
    out = {"regr": [], "cls": [], "regu": []}
    for group, entries in cfg.items():
        if group not in out:       # provenance / comment keys
            continue
        for e in entries:
            e = dict(e)
            e.setdefault("type", "mlp")
            e.setdefault("loss_weight", 1.0)
            out[group].append(e)
    return out


def minion_type(cfg):
    """The head kind of a worker entry: SPC and Gap route by name, as in
    the reference (cls_minions.py), the rest by 'type'."""
    if cfg["name"] in ("spc", "gap"):
        return cfg["name"]
    return cfg.get("type", "mlp")


def _build_minion(cfg, in_channels, generator=None):
    mtype = minion_type(cfg)
    if mtype not in _MINION_CLS:
        raise NotImplementedError(
            f"worker {cfg['name']!r} (type {mtype!r}) is not ported yet: "
            f"{ROADMAP_HEADS}")
    kwargs = {k: cfg[k] for k in _MINION_FIELDS[mtype] if k in cfg}
    for seq_key in ("fmaps", "strides", "kwidths", "upsample_scales"):
        if seq_key in kwargs:
            kwargs[seq_key] = tuple(kwargs[seq_key])
    return _MINION_CLS[mtype](in_channels, generator=generator, **kwargs)


# the fused head+loss (losses.framed_mse_linear) for MLP regression heads
# of at least this many output channels: the PASE+ lps / lps_long heads
FUSED_MIN_CH = 4096


def _fuse_eligible(e):
    """A regr worker takes the fused linear-head MSE when its head is a
    plain MLP ending in a kwidth-1 conv, the loss is MSE, and the output
    width clears ``FUSED_MIN_CH``."""
    if e.get("type", "mlp") != "mlp":
        return False
    if e.get("loss") != "MSELoss" or e["name"] in ("chunk", "cchunk"):
        return False
    if int(e.get("context", 1) or 1) != 1 and \
            int(e.get("hidden_layers", 2) or 0) < 1:
        return False
    r = int(e.get("r", 1) or 1)
    return int(e.get("num_outputs", 1)) * max(r, 1) >= FUSED_MIN_CH


class PASE(nn.Module):
    """Encoder + regression / classification worker bank.

    ``forward(batch, alpha)`` takes a prepared batch dict ('chunk',
    'chunk_ctxt', 'chunk_rand' [B, T], 'cchunk' [B, T], '<worker>'
    [B, F, D] targets) and returns (hidden dict [B, emb, F] per stream,
    chunk hidden, preds, labels). ``alpha`` is a float or a
    [num_workers] tensor of per-worker encoder-gradient scales. With
    ``force_cchunk`` the encoder also reads 'cchunk' (a fourth stream of
    its batch, and of its BatchNorm statistics), as the JAX model does
    for the z-GAN's cchunk prior.
    """

    def __init__(self, frontend_cfg, workers_meta, generator=None,
                 force_cchunk=False):
        super().__init__()
        # the z-GAN's cchunk prior reads PASE(cchunk): the clean chunk then
        # joins the encoder's batch as a fourth stream
        self.fwd_cchunk = bool(force_cchunk)
        if workers_meta.get("regu"):
            raise NotImplementedError(
                f"regularizer workers are not ported yet: {ROADMAP_HEADS}")
        self.frontend = build_frontend_module(load_cfg(frontend_cfg),
                                              generator)
        emb = self.frontend.output_dim
        self.cls_meta = list(workers_meta.get("cls", []))
        self.regr_meta = list(workers_meta.get("regr", []))
        self.workers = nn.ModuleDict()
        for e in self.cls_meta:
            # LIM / GIM heads read a pos/neg pair concatenated on channels,
            # Gap a frame pair; SPC a frame and a window of ctxt_frames;
            # the overlap head reads the chunk stream alone
            if e["name"] == "overlap":
                cin = emb
            elif minion_type(e) == "spc":
                cin = emb * (1 + int(e.get("ctxt_frames", 5)))
            else:
                cin = 2 * emb
            self.workers[e["name"]] = _build_minion(e, cin, generator)
        for e in self.regr_meta:
            self.workers[e["name"]] = _build_minion(e, emb, generator)

    @property
    def worker_names(self):
        """Loss order: cls first, then regr."""
        return [e["name"] for e in self.cls_meta + self.regr_meta]

    def forward(self, batch, alpha=1.0, generator=None):
        """``generator`` draws the SPC and Gap frame indices that the batch
        does not inject."""
        keys = ["chunk", "chunk_ctxt", "chunk_rand"]
        if self.fwd_cchunk:
            keys.append("cchunk")
        x = torch.cat([batch[k] for k in keys], dim=0)
        hcat = self.frontend(x).transpose(1, 2)          # [3B, emb, F]
        h = dict(zip(keys, torch.split(hcat, batch["chunk"].shape[0])))
        chunk = h["chunk"]

        def a_of(i):
            if torch.is_tensor(alpha) and alpha.dim() > 0:
                return alpha[i]
            return alpha

        preds, labels = {}, {}
        for i, e in enumerate(self.cls_meta):
            name = e["name"]
            kind = minion_type(e)
            if kind in ("spc", "gap"):
                y = self.workers[name](chunk, a_of(i), generator,
                                       batch.get(f"{name}_idx"))
                if kind == "gap":
                    y, labels[name] = y
                preds[name] = y.transpose(1, 2)
                if kind == "spc":
                    labels[name] = make_mi_labels(preds[name])
                continue
            if name == "overlap":
                # the frame label of the overlap distortion, [B, F, 1]
                preds[name] = self.workers[name](chunk, a_of(i)).transpose(
                    1, 2)
                labels[name] = batch["overlap"][..., None]
                continue
            pos, neg = make_mi_samples(chunk, h["chunk_ctxt"],
                                       h["chunk_rand"],
                                       bool(e.get("augment", False)))
            xin = torch.cat([pos, neg], dim=0)
            if name == "cmi":
                xin = xin.mean(dim=2, keepdim=True)
            y = self.workers[name](xin, a_of(i)).transpose(1, 2)
            preds[name] = y
            labels[name] = make_mi_labels(y)
        for i, e in enumerate(self.regr_meta, start=len(self.cls_meta)):
            name = e["name"]
            worker = self.workers[name]
            if e.get("type") == "wavernn":
                # teacher-forced vocoder: the previous clean samples and
                # the edge-padded frames -> per-sample logits; the target
                # is the clean waveform
                wav = batch.get("cchunk", batch["chunk"])
                wav = wav[..., 0] if wav.dim() == 3 else wav
                pad_f = int(e.get("pad", 2) or 2)
                mels = nn.functional.pad(scale_grad(chunk, a_of(i)),
                                         (pad_f, pad_f), mode="replicate")
                x_prev = nn.functional.pad(wav, (1, 0))[:, :-1]
                preds[name] = worker(x_prev, mels)
                labels[name] = wav.detach()
                continue
            if _fuse_eligible(e):
                tag, hid, w, b = worker(chunk, a_of(i), return_linear=True)
                preds[name] = (tag, hid.transpose(1, 2), w, b)
            else:
                preds[name] = worker(chunk, a_of(i)).transpose(1, 2)
            target = batch[name]
            if name in ("chunk", "cchunk") and target.dim() == 2:
                target = target[..., None]      # the waveform itself
            labels[name] = target.detach()
        return h, chunk, preds, labels


def worker_losses(model_meta, preds, labels):
    """Per-worker losses {name: loss_weight * loss}, cls then regr."""
    losses = {}
    for group in ("cls", "regr"):
        for e in model_meta[group]:
            name = e["name"]
            r = e.get("r") if group == "regr" else None
            pred = preds[name]
            if isinstance(pred, tuple) and pred[0] == "linear":
                _, hid, w, b = pred
                val = framed_mse_linear(w, b, hid, labels[name], r)
            elif e.get("type") == "wavernn":
                logits = pred.float()
                if e.get("mode", "RAW") == "MOL":
                    val = discretized_mix_logistic_loss(logits, labels[name])
                else:
                    val = raw_loss(logits, labels[name],
                                   bits=int(e.get("bits", 9)))
            else:
                val = make_loss(e["loss"], r=r)(pred, labels[name])
            losses[name] = e.get("loss_weight", 1.0) * val
    return losses


def materialize_pred(pred):
    """A fused head's ("linear", hidden, weight, bias) prediction made
    [B, F, out]; any other prediction as it is."""
    if isinstance(pred, tuple) and pred[0] == "linear":
        _, hid, w, b = pred
        return hid @ w[:, :, 0].t().to(hid.dtype) + b.to(hid.dtype)
    return pred


def build_pase(frontend_cfg, workers_cfg, generator=None,
               force_cchunk=False):
    """(model, worker metadata) from JSON cfgs (paths or dicts)."""
    meta = parse_workers_cfg(workers_cfg)
    return PASE(frontend_cfg, meta, generator=generator,
                force_cchunk=force_cchunk), meta
