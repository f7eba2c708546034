"""Downstream probe heads and their training: frozen-encoder features ->
an MLP (or a recurrent head) trained with NLL and plain SGD, lr halving on
the dev error, frame and sentence error rates, and a KNN on embeddings.

The port of ``pase_tpu/probes/classifier.py``. The heads are plain torch
(``nn.Linear``); the MLP's BatchNorm follows flax's ``nn.BatchNorm(
momentum=0.95)``, not torch's: the batch variance is the biased
max(0, E[x^2] - E[x]^2) both in the normalization and in the running
update ``ra = 0.95 ra + 0.05 batch``. ``train_mlp_probe`` is
``build_mlp_probe`` (parameters drawn from a ``torch.Generator`` seeded
with ``seed``) followed by ``fit``; ``mlp_from_jax`` and
``rnn_classifier_from_jax`` load a flax model's variables (numpy) into
these modules, so both packages can start from the same weights.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pase_tpu_torch.nn import FlaxRNN, flax_dense

BN_MOMENTUM = 0.95
BN_EPS = 1e-5
EVAL_BATCH = 8192


def context_window(feats, left, right):
    """[T, D] -> [T, D * (left + 1 + right)] frame stacking, the edge
    frames replicated."""
    t, d = feats.shape
    idx = np.arange(t)[:, None] + np.arange(-left, right + 1)[None, :]
    idx = np.clip(idx, 0, t - 1)
    return feats[idx].reshape(t, d * (left + 1 + right))


class FlaxBatchNorm(nn.Module):
    """BatchNorm over the batch axis of [N, C] with flax's rule: biased
    fast variance, running stats ``m ra + (1 - m) batch``, eps 1e-5."""

    def __init__(self, num_features, momentum=BN_MOMENTUM, eps=BN_EPS):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=0)
            var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (self.weight * torch.rsqrt(var + self.eps)) \
            + self.bias


class MLPClassifier(nn.Module):
    """Hidden layers of Dense -> BatchNorm -> ReLU (-> dropout in train
    mode), then Dense and log-softmax. Dropout masks come from
    ``dropout_generator`` (on the model's device)."""

    def __init__(self, in_dim, num_classes, hidden=(256,), dropout=0.0,
                 batch_norm=True, generator=None):
        super().__init__()
        self.dropout = dropout
        self.dense = nn.ModuleList()
        self.bn = nn.ModuleList()
        d = in_dim
        for h in hidden:
            self.dense.append(flax_dense(d, h, generator))
            if batch_norm:
                self.bn.append(FlaxBatchNorm(h))
            d = h
        self.out = flax_dense(d, num_classes, generator)
        self.dropout_generator = None

    def forward(self, x):
        for i, dense in enumerate(self.dense):
            x = dense(x)
            if len(self.bn):
                x = self.bn[i](x)
            x = F.relu(x)
            if self.dropout > 0 and self.training:
                keep = 1.0 - self.dropout
                mask = torch.rand(x.shape, generator=self.dropout_generator,
                                  device=x.device) < keep
                x = torch.where(mask, x / keep, torch.zeros_like(x))
        return F.log_softmax(self.out(x), dim=-1)


class LiGRUCell(nn.Module):
    """Light GRU cell: z = sigmoid(Wz x + Uz h); hcand = relu(W x + U h);
    h' = z h + (1 - z) hcand."""

    def __init__(self, in_dim, features, generator=None):
        super().__init__()
        self.features = features
        self.wz = flax_dense(in_dim, features, generator)
        self.uz = flax_dense(features, features, generator, bias=False)
        self.wh = flax_dense(in_dim, features, generator)
        self.uh = flax_dense(features, features, generator, bias=False)

    def forward(self, h, x):
        z = torch.sigmoid(self.wz(x) + self.uz(h))
        hcand = F.relu(self.wh(x) + self.uh(h))
        return z * h + (1 - z) * hcand


class LiGRU(nn.Module):
    """A LiGRU cell scanned over the time axis of [B, T, D] from h = 0."""

    def __init__(self, in_dim, features, generator=None):
        super().__init__()
        self.cell = LiGRUCell(in_dim, features, generator)

    def forward(self, x):
        h = x.new_zeros(x.shape[0], self.cell.features)
        out = []
        for t in range(x.shape[1]):
            h = self.cell(h, x[:, t])
            out.append(h)
        return torch.stack(out, dim=1)


def _recurrent(cell_type, in_dim, hidden, generator):
    """A batch-first recurrent layer of flax's cell semantics: a GRU or
    LSTM ``nn.FlaxRNN`` (flax's absent biases fixed at zero), or a
    LiGRU."""
    if cell_type == "ligru":
        return LiGRU(in_dim, hidden, generator)
    return FlaxRNN(in_dim, hidden, cell_type, generator)


class RNNClassifier(nn.Module):
    """Sequence classifier: ``layers`` recurrent layers (gru | lstm |
    ligru) over [B, T, D], then Dense and log-softmax per frame."""

    def __init__(self, in_dim, num_classes, hidden=256, layers=1,
                 cell_type="gru", generator=None):
        super().__init__()
        if cell_type not in ("gru", "lstm", "ligru"):
            raise ValueError(f"cell_type {cell_type!r}: gru, lstm, ligru")
        self.cell_type = cell_type
        self.rnns = nn.ModuleList()
        d = in_dim
        for _ in range(layers):
            self.rnns.append(_recurrent(cell_type, d, hidden, generator))
            d = hidden
        self.out = flax_dense(d, num_classes, generator)

    def forward(self, x):
        for rnn in self.rnns:
            x = rnn(x)
        return F.log_softmax(self.out(x), dim=-1)


# ---------------------------------------------------------------------------
# flax variables -> the port's modules
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    """A nested mapping of arrays -> {'/'-joined key: np.ndarray}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if hasattr(v, "items"):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def _set(param, arr):
    with torch.no_grad():
        param.copy_(torch.tensor(np.asarray(arr)))


def _set_dense(layer, flat, name):
    _set(layer.weight, flat[f"params/{name}/kernel"].T)
    if layer.bias is not None:
        _set(layer.bias, flat[f"params/{name}/bias"])


def mlp_from_jax(variables, model):
    """Load a flax ``MLPClassifier``'s variables (params and batch_stats)
    into ``model``; returns it."""
    flat = _flat(variables)
    for i, dense in enumerate(model.dense):
        _set_dense(dense, flat, f"dense_{i}")
        if len(model.bn):
            bn = model.bn[i]
            _set(bn.weight, flat[f"params/bn_{i}/scale"])
            _set(bn.bias, flat[f"params/bn_{i}/bias"])
            _set(bn.running_mean, flat[f"batch_stats/bn_{i}/mean"])
            _set(bn.running_var, flat[f"batch_stats/bn_{i}/var"])
    _set_dense(model.out, flat, "out")
    return model


def rnn_classifier_from_jax(variables, model):
    """Load a flax ``RNNClassifier``'s params into ``model``; returns it.
    A GRU / LSTM layer takes its cell's tree (``nn.FlaxRNN.load_flax``),
    a LiGRU its four Denses."""
    flat = _flat(variables)
    for i, rnn in enumerate(model.rnns):
        if model.cell_type == "ligru":
            for part in ("wz", "uz", "wh", "uh"):
                _set_dense(getattr(rnn.cell, part), flat,
                           f"ligru_{i}/{part}")
            continue
        rnn.load_flax(variables["params"][f"{model.cell_type}_{i}"])
    _set_dense(model.out, flat, "out")
    return model


# ---------------------------------------------------------------------------
# training and evaluation
# ---------------------------------------------------------------------------


def _device(model):
    return next(model.parameters()).device


def build_mlp_probe(in_dim, num_classes, hidden=(256,), dropout=0.0,
                    seed=0, device="cuda"):
    """An ``MLPClassifier`` drawn from ``torch.Generator().manual_seed(
    seed)``, on ``device``, its dropout masks from a generator there
    seeded with ``seed``."""
    model = MLPClassifier(in_dim, num_classes, hidden=tuple(hidden),
                          dropout=dropout,
                          generator=torch.Generator().manual_seed(seed))
    model.to(device)
    model.dropout_generator = torch.Generator(
        device=device).manual_seed(seed)
    return model


def predict(model, x):
    """Eval-mode log-posteriors of numpy or tensor ``x`` on the model's
    device."""
    model.eval()
    with torch.no_grad():
        return model(torch.as_tensor(x, dtype=torch.float32,
                                     device=_device(model)))


def frame_error_rate(model, x, y, bs=EVAL_BATCH):
    """Frame error of a trained probe on held-out frames (eval mode, in
    batches of ``bs``)."""
    errs = 0
    for i in range(0, len(x), bs):
        pred = predict(model, x[i:i + bs]).argmax(dim=-1)
        errs = errs + (pred != torch.as_tensor(
            y[i:i + bs], device=pred.device)).sum()
    return float(errs) / max(len(x), 1)


class _SGDStep:
    """One SGD step of a probe on rows of (xs, ys): NLL, p -= lr g, the
    NLL added to ``nll_sum``. On the card, without dropout, the step is
    one CUDA graph, captured once (the warm-up's effect on the running
    statistics undone): a step then launches two row gathers and the
    graph, where the eager step launches about 80 kernels, each paying
    the host's launch time. On the CPU, or with dropout (its masks come
    from a generator the graph does not carry), the same ops run
    eagerly."""

    def __init__(self, model, xs, ys, batch_size):
        self.model, self.xs, self.ys = model, xs, ys
        self.params = [p for p in model.parameters() if p.requires_grad]
        dev = xs.device
        self.x = torch.zeros(batch_size, xs.shape[1], device=dev)
        self.y = torch.zeros(batch_size, dtype=torch.int64, device=dev)
        self.lr = torch.zeros((), device=dev)
        self.nll_sum = torch.zeros((), device=dev)
        self.graph = None
        if dev.type == "cuda" and not model.dropout:
            self._capture(dev)

    def _step(self):
        out = self.model(self.x)
        nll = -out.gather(1, self.y[:, None]).mean()
        grads = torch.autograd.grad(nll, self.params)
        with torch.no_grad():
            for p, g in zip(self.params, grads):
                p.sub_(self.lr * g)
            self.nll_sum.add_(nll)

    def _capture(self, dev):
        saved = {k: v.clone() for k, v in self.model.state_dict().items()}
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(3):       # lr 0: the parameters do not move
                self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._step()
        self.model.load_state_dict(saved)        # in place
        self.nll_sum.zero_()

    def __call__(self, rows):
        torch.index_select(self.xs, 0, rows, out=self.x)
        torch.index_select(self.ys, 0, rows, out=self.y)
        if self.graph is None:
            self._step()
        else:
            self.graph.replay()


def fit(model, train_x, train_y, dev_x, dev_y, epochs=20, batch_size=2048,
        lr=0.1, halving_factor=0.5, improvement_threshold=0.001, seed=0,
        log=None):
    """Train a built probe: per epoch a numpy ``RandomState(seed)``
    permutation, batches of ``min(batch_size, N)`` (a last partial batch
    dropped), NLL, plain SGD (p -= lr g); then the dev frame error, and
    the lr times ``halving_factor`` when it improved by less than
    ``improvement_threshold`` of the previous one. Returns the metrics
    {dev_frame_error, best_dev_frame_error}."""
    device = _device(model)
    xs = torch.as_tensor(train_x, dtype=torch.float32, device=device)
    ys = torch.as_tensor(train_y, dtype=torch.int64, device=device)
    nprng = np.random.RandomState(seed)
    best_dev = prev_dev = 1.0
    lr_var = lr
    batch_size = min(batch_size, len(train_x))
    model.train()
    step = _SGDStep(model, xs, ys, batch_size)
    for e in range(epochs):
        order = nprng.permutation(len(train_x))
        n_batches = (len(order) - batch_size) // batch_size + 1
        sel = torch.as_tensor(order[:n_batches * batch_size],
                              device=device).view(n_batches, batch_size)
        model.train()
        step.lr.fill_(lr_var)
        step.nll_sum.zero_()
        for rows in sel:
            step(rows)
        dev_err = frame_error_rate(model, dev_x, dev_y)
        if log:
            log(f"epoch {e}: nll {float(step.nll_sum) / n_batches:.4f} "
                f"dev_err {dev_err:.4f} lr {lr_var:.4f}")
        # lr halving on a stagnating dev error (the pytorch-kaldi recipe)
        if (prev_dev - dev_err) < improvement_threshold * prev_dev:
            lr_var *= halving_factor
        prev_dev = dev_err
        best_dev = min(best_dev, dev_err)
    return {"dev_frame_error": float(prev_dev),
            "best_dev_frame_error": float(best_dev)}


def train_mlp_probe(train_x, train_y, dev_x, dev_y, num_classes,
                    hidden=(256,), epochs=20, batch_size=2048, lr=0.1,
                    halving_factor=0.5, improvement_threshold=0.001,
                    seed=0, dropout=0.0, log=None, device="cuda"):
    """SGD + NLL with dev-error lr halving on ``device`` (the card unless
    'cpu'). Returns (model, metrics)."""
    model = build_mlp_probe(train_x.shape[1], num_classes, hidden, dropout,
                            seed, device)
    metrics = fit(model, train_x, train_y, dev_x, dev_y, epochs=epochs,
                  batch_size=batch_size, lr=lr,
                  halving_factor=halving_factor,
                  improvement_threshold=improvement_threshold, seed=seed,
                  log=log)
    return model, metrics


def sentence_accuracy(model, utt_feats, utt_labels):
    """Sentence decision = argmax of the mean per-frame log-posterior."""
    correct = 0
    for feats, lab in zip(utt_feats, utt_labels):
        pred = int(predict(model, feats).mean(dim=0).argmax())
        correct += int(pred == lab)
    return correct / max(len(utt_labels), 1)


def knn_classify(train_x, train_y, test_x, k=5, num_classes=None,
                 device="cuda"):
    """KNN on ``device``: squared-L2 distances as one matmul, the k
    nearest (the lower train index first among equal distances), one-hot
    votes, argmax (the lower class among equal votes). Returns numpy
    predictions."""
    num_classes = num_classes or int(np.max(train_y)) + 1
    trx = torch.as_tensor(train_x, dtype=torch.float32, device=device)
    tex = torch.as_tensor(test_x, dtype=torch.float32, device=device)
    tr2 = (trx ** 2).sum(dim=1)
    te2 = (tex ** 2).sum(dim=1)
    d = te2[:, None] + tr2[None, :] - 2.0 * tex @ trx.T
    idx = torch.sort(d, dim=1, stable=True).indices[:, :k]
    votes = torch.as_tensor(np.asarray(train_y), dtype=torch.int64,
                            device=device)[idx]                 # [n_test, k]
    onehot = F.one_hot(votes, num_classes).sum(dim=1)
    return onehot.argmax(dim=-1).cpu().numpy()
