"""Checkpoints of the port, in the JAX package's native layout.

* ``save_variables`` / ``load_variables``: one ``.npz`` of flat
  ``/``-joined keys plus a ``__meta__`` entry (uint8 JSON, the step), as
  ``pase_tpu/checkpoint.py`` writes them.
* ``train_state_to_tree`` / ``restore_train_state``: a ``Trainer``'s full
  state as the JAX package's TrainState keys, and back (strict).
* ``Saver``: the rolling checkpoint index with ``max_ckpts`` retention.
* ``load_frontend_ckpt``: an encoder artifact (native .npz or reference
  torch .ckpt) into a module.

The weight bridge between the JAX package's checkpoints and the port:

The port's parameter and buffer names are the reference torch state-dict
keys (the ones ``util_scripts.py export-torch`` writes), so a state dict in
that layout loads with ``load_state_dict(strict=True)``.

* ``load_variables_npz`` reads a native ``FE_e*.npz`` (the flattened
  variable tree under ``/``-joined keys) with ``np.load`` alone.
* ``variables_to_state_dict`` / ``state_dict_to_variables`` map between the
  two layouts: ``blocks_N`` <-> ``blocks.N``, ``layers_N_linear`` <->
  ``layers.N.linear``, a conv kernel [K, Cin, Cout] <-> weight
  [Cout, Cin, K], a Dense kernel [in, out] <-> weight [out, in],
  ``low_hz``/``band_hz`` <-> ``low_hz_``/``band_hz_``, ``mean``/``var`` <->
  ``running_mean``/``running_var``. The VQ quantizer's buffers ``emb``
  [K, D], ``ema_cluster_size`` and ``ema_w`` keep their names and layout
  and live in ``batch_stats`` (``batch_stats/quantizer/emb``): the
  codebook is state, not a kernel, and is never transposed. A weight-norm
  conv's ``v`` [K, Cin, Cout] <-> [Cout, Cin, K] (``g`` and ``bias`` as
  they are); a spectral-norm conv's kernel is a conv's, its ``u`` lives
  in ``batch_stats`` like the codebook.
* ``load_frontend_ckpt`` loads either format into a module, strictly.
* ``model_variables_to_state_dict`` / ``model_state_dict_to_variables``
  do the same for the whole PASE model (``model.PASE``): the JAX
  ``params/frontend/...`` and ``params/<worker>/...`` trees (and their
  ``batch_stats/``) <-> ``frontend.*`` and ``workers.<worker>.*``. A
  transposed-conv kernel [K, Cout, Cin] <-> weight [Cin, Cout, K] is the
  same transpose as a conv's. ``load_model_variables`` loads strictly.
* A BiRNN leaf ``l{k}_{fw,bw}_{w,b}_{ih,hh}`` <-> torch's
  ``{weight,bias}_{ih,hh}_l{k}[_reverse]``, the same array: the JAX
  module keeps torch's layout and gate order. A flax GRU / LSTM cell (its
  Denses ``ir/kernel`` ... ``hn/bias`` under the cell's name: a GRU
  head's ``gru_{i}``, WaveRNN's ``rnn1_cell`` / ``rnn2_cell``) <-> the
  port's ``nn.FlaxRNN`` of that name (``weight_ih``, ``weight_hh``,
  ``bias_ih`` + ``bias_hn`` or ``bias_hh``), kernels transposed and
  stacked in torch's gate order. Adam's moments map the same way.
"""

import json
import os
import re

import numpy as np
import torch

from pase_tpu_torch.nn import flax_cell_to_torch, torch_cell_to_flax

_INDEXED = re.compile(r"^(blocks|denseskips)_(\d+)$")
_QRNN_LAYER = re.compile(r"^layers_(\d+)_linear$")
# a BiRNN leaf: JAX l{k}_{fw,bw}_{w,b}_{ih,hh} <-> torch's nn.LSTM / nn.GRU
# {weight,bias}_{ih,hh}_l{k}[_reverse], the same array (no transpose)
_BIRNN_JAX = re.compile(r"^l(\d+)_(fw|bw)_([wb])_(ih|hh)$")
_BIRNN_TORCH = re.compile(r"^(weight|bias)_(ih|hh)_l(\d+)(_reverse)?$")
# the leaves of a flax GRU / LSTM cell ('ir/kernel', ..., 'hn/bias') and
# of its port, nn.FlaxRNN
_CELL_DENSES = {"ir", "iz", "in", "hr", "hz", "hn",
                "ii", "if", "ig", "io", "hi", "hf", "hg", "ho"}
_CELL_TORCH = ("weight_ih", "weight_hh", "bias_ih", "bias_hn", "bias_hh")
_COLLECTIONS = ("params", "batch_stats")
_LEAF_TO_TORCH = {"low_hz": "low_hz_", "band_hz": "band_hz_",
                  "mean": "running_mean", "var": "running_var"}
_LEAF_TO_JAX = {v: k for k, v in _LEAF_TO_TORCH.items()}
# the leaves of the JAX 'batch_stats' collection: BatchNorm's running
# statistics, the VQ quantizer's codebook and EMA state, and a
# spectral-norm conv's power-iteration vector u
_BATCH_STATS = {"mean", "var", "emb", "ema_cluster_size", "ema_w", "u"}


def _flip_conv(arr):
    """A conv kernel [K, Cin, Cout] <-> weight [Cout, Cin, K] (the same
    transpose both ways), a Dense kernel [in, out] <-> weight [out, in]."""
    return arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T


def save_variables(path, flat, step=0):
    """Write {'/'-joined key: array} as a native .npz with ``__meta__``
    ({"step": step} as uint8 JSON)."""
    flat = {k: np.asarray(v) for k, v in flat.items()}
    meta = {"step": int(step)}
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8).copy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    return path


def load_variables(path):
    """Native .npz -> ({'/'-joined key: np.ndarray}, meta dict)."""
    with np.load(path, allow_pickle=False) as data:
        meta = (json.loads(bytes(data["__meta__"].tobytes()).decode("utf-8"))
                if "__meta__" in data.files else {})
        return {k: data[k] for k in data.files if k != "__meta__"}, meta


def load_variables_npz(path):
    """Native .npz -> {'/'-joined key: np.ndarray}, without ``__meta__``."""
    return load_variables(path)[0]


def _module_path_to_torch(parts):
    out = []
    for p in parts:
        m = _INDEXED.match(p)
        q = _QRNN_LAYER.match(p)
        if m:
            out += [m.group(1), m.group(2)]
        elif q:
            out += ["layers", q.group(1), "linear"]
        else:
            out.append(p)
    return out


def _cells_to_torch(flat):
    """Pull the flax GRU / LSTM cells out of JAX flattened variables:
    (the other leaves, {'<torch module path>.<FlaxRNN leaf>': tensor})."""
    cells, rest = {}, {}
    for key, arr in flat.items():
        parts = key.split("/")
        if len(parts) >= 4 and parts[-2] in _CELL_DENSES:
            cells.setdefault(tuple(parts[1:-2]), {}).setdefault(
                parts[-2], {})[parts[-1]] = arr
        else:
            rest[key] = arr
    sd = {}
    for path, tree in cells.items():
        cell = "gru" if "hn" in tree and "hr" in tree else "lstm"
        pre = ".".join(_module_path_to_torch(list(path)))
        for k, v in flax_cell_to_torch(tree, cell).items():
            sd[f"{pre}.{k}"] = v
    return rest, sd


def _cells_to_jax(state_dict):
    """The inverse: (the other entries, {'params/<JAX path>/<dense>/...':
    array}) of a state dict whose ``FlaxRNN`` modules hold
    ``weight_hh`` (a plain name: BiRNN's carry a layer suffix)."""
    prefixes = {k[:-len(".weight_hh")] for k in state_dict
                if k.endswith(".weight_hh")}
    rest, flat = {}, {}
    for pre in prefixes:
        sd = {leaf: state_dict[f"{pre}.{leaf}"].detach().cpu().numpy()
              for leaf in _CELL_TORCH if f"{pre}.{leaf}" in state_dict}
        path = "/".join(_module_path_to_jax(pre.split(".")))
        for k, v in torch_cell_to_flax(sd).items():
            flat[f"params/{path}/{k}"] = v
    for k, v in state_dict.items():
        pre, _, leaf = k.rpartition(".")
        if not (pre in prefixes and leaf in _CELL_TORCH):
            rest[k] = v
    return rest, flat


def variables_to_state_dict(flat):
    """JAX flattened variables ({'params/blocks_1/conv/kernel': array, ...})
    -> the port's state dict ({'blocks.1.conv.weight': tensor, ...})."""
    flat, sd = _cells_to_torch(flat)
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] not in _COLLECTIONS:
            raise KeyError(f"unexpected collection in {key!r}")
        *path, leaf = parts[1:]
        arr = np.asarray(arr)
        birnn = _BIRNN_JAX.match(leaf)
        if birnn:
            k, d, kind, side = birnn.groups()
            leaf = (f"{'weight' if kind == 'w' else 'bias'}_{side}_l{k}"
                    f"{'_reverse' if d == 'bw' else ''}")
        elif leaf == "kernel":
            arr, leaf = _flip_conv(arr), "weight"
        elif leaf == "v" and arr.ndim == 3:
            arr = _flip_conv(arr)         # a weight-norm conv's direction
        else:
            leaf = _LEAF_TO_TORCH.get(leaf, leaf)
        tkey = ".".join(_module_path_to_torch(path) + [leaf])
        sd[tkey] = torch.tensor(arr)
    return sd


def _module_path_to_jax(parts):
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in ("blocks", "denseskips") and i + 1 < len(parts) \
                and parts[i + 1].isdigit():
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
        elif p == "layers" and i + 2 < len(parts) and parts[i + 1].isdigit() \
                and parts[i + 2] == "linear":
            out.append(f"layers_{parts[i + 1]}_linear")
            i += 3
        else:
            out.append(p)
            i += 1
    return out


def state_dict_to_variables(state_dict):
    """The port's state dict -> JAX flattened variables (numpy), the
    inverse of ``variables_to_state_dict``. ``num_batches_tracked`` has no
    JAX counterpart and is dropped."""
    state_dict, flat = _cells_to_jax(state_dict)
    for tkey, t in state_dict.items():
        *path, leaf = tkey.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().cpu().numpy()
        birnn = _BIRNN_TORCH.match(leaf)
        if birnn:
            kind, side, k, rev = birnn.groups()
            leaf = (f"l{k}_{'bw' if rev else 'fw'}_"
                    f"{'w' if kind == 'weight' else 'b'}_{side}")
        elif leaf in _LEAF_TO_JAX:
            leaf = _LEAF_TO_JAX[leaf]
        elif leaf == "weight" and arr.ndim >= 2:
            arr, leaf = _flip_conv(arr), "kernel"
        elif leaf == "v" and arr.ndim == 3:
            arr = _flip_conv(arr)
        col = "batch_stats" if leaf in _BATCH_STATS else "params"
        flat["/".join([col] + _module_path_to_jax(path) + [leaf])] = \
            np.ascontiguousarray(arr)
    return flat


def save_variables_npz(path, state_dict, step=0):
    """Write a state dict as a native .npz (the JAX package's
    ``checkpoint.save_variables`` layout, ``__meta__`` included)."""
    return save_variables(path, state_dict_to_variables(state_dict), step)


def _load_torch_state_dict(path):
    st = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(st, dict) and "state_dict" in st:
        st = st["state_dict"]
    return dict(st)


def load_frontend_ckpt(path, module, load_last=True):
    """Load a native .npz or a reference torch .ckpt state dict into
    ``module`` with ``load_state_dict(strict=True)``. Only a
    ``num_batches_tracked`` buffer the file lacks (the native format has
    none) keeps the module's value.

    ``load_last=False`` drops the last two entries of a torch .ckpt (the
    reference's ``load_pretrained_ckpt``, as ``pase_tpu/checkpoint.py``
    does); the module keeps its own values there, and every other key
    must still be the module's. A native .npz always loads whole."""
    if path.endswith(".npz"):
        sd = variables_to_state_dict(load_variables_npz(path))
    else:
        sd = _load_torch_state_dict(path)
        if not load_last:
            sd = dict(list(sd.items())[:-2])
    for k, v in module.state_dict().items():
        if k not in sd and (k.endswith("num_batches_tracked")
                            or not load_last):
            sd[k] = v
    module.load_state_dict(sd, strict=True)
    return module


def model_variables_to_state_dict(flat):
    """JAX PASE variables ({'params/frontend/W/kernel': array,
    'params/lps/blocks_0/W/kernel': array, ...}) -> the state dict of
    ``model.PASE`` ({'frontend.W.weight': tensor,
    'workers.lps.blocks.0.W.weight': tensor, ...})."""
    groups = {}
    for key, arr in flat.items():
        col, top, *rest = key.split("/")
        groups.setdefault(top, {})["/".join([col] + rest)] = arr
    sd = {}
    for top, sub in groups.items():
        prefix = "frontend." if top == "frontend" else f"workers.{top}."
        for k, v in variables_to_state_dict(sub).items():
            sd[prefix + k] = v
    return sd


def model_state_dict_to_variables(state_dict):
    """The inverse of ``model_variables_to_state_dict``
    (``num_batches_tracked`` is dropped)."""
    groups = {}
    for tkey, t in state_dict.items():
        top, _, rest = tkey.partition(".")
        if top == "workers":
            top, _, rest = rest.partition(".")
        elif top != "frontend":
            raise KeyError(f"unexpected PASE state-dict key {tkey!r}")
        groups.setdefault(top, {})[rest] = t
    flat = {}
    for top, sub in groups.items():
        for k, v in state_dict_to_variables(sub).items():
            col, _, path = k.partition("/")
            flat[f"{col}/{top}/{path}"] = v
    return flat


def load_model_variables(model, flat):
    """Load JAX PASE variables into ``model`` with
    ``load_state_dict(strict=True)``; only ``num_batches_tracked``
    buffers keep the model's value."""
    sd = model_variables_to_state_dict(flat)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = v
    model.load_state_dict(sd, strict=True)
    return model


# ---------------------------------------------------------------------------
# the full train state in the JAX package's TrainState layout
# ---------------------------------------------------------------------------

GROUPS = ("frontend", "minion")
_POLICY_FIELDS = ("q", "last_loss", "pi", "count")


def _adam_prefix(group):
    """optax ``multi_transform`` -> ``masked`` -> (adam, schedule) keys."""
    return f"opt_state/inner_states/{group}/inner_state"


def _group_params(trainer):
    """{group: {parameter name: parameter}} of the trainer's optimizer."""
    named = {id(p): n for n, p in trainer.model.named_parameters()}
    return {g["name"]: {named[id(p)]: p for p in g["params"]}
            for g in trainer.opt.param_groups}


def rng_key(seed, step):
    """The ``rng`` leaf a port checkpoint carries: the raw JAX key
    [seed, step] (uint32). A JAX resume of a port checkpoint draws its
    distortions and dropout from there; the port itself derives its
    streams from (seed, step) and does not read it."""
    return np.array([int(seed) & 0xFFFFFFFF, int(step) & 0xFFFFFFFF],
                    np.uint32)


def _adam_moments(opt, params, to_variables, head):
    """Adam's exp_avg / exp_avg_sq of ``params`` ({name: parameter}; zeros
    before its first step) as ``{head}{mu|nu}/<JAX path>`` leaves;
    ``to_variables`` maps a state dict to JAX variables."""
    flat = {}
    for leaf, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        sd = {}
        for n, p in params.items():
            st = opt.state.get(p, {})
            sd[n] = st[key] if key in st else torch.zeros_like(p)
        for k, v in to_variables(sd).items():
            flat[f"{head}{leaf}/{k.partition('/')[2]}"] = v
    return flat


def _set_adam(opt, params, flat, head, count, to_state_dict, device):
    """The inverse: Adam's state of ``params`` from the
    ``{head}{mu|nu}/...`` leaves of ``flat``, at step ``count``."""
    moments = {}
    for leaf in ("mu", "nu"):
        pre = f"{head}{leaf}/"
        moments[leaf] = to_state_dict(
            {"params/" + k[len(pre):]: v for k, v in flat.items()
             if k.startswith(pre)})
    for n, p in params.items():
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": moments["mu"][n].to(device).contiguous(),
            "exp_avg_sq": moments["nu"][n].to(device).contiguous()}


def _d_count(trainer):
    """D's Adam updates so far (0 before its first step)."""
    for st in trainer.d_opt.state.values():
        return int(st["step"])
    return 0


def _discriminator_tree(trainer):
    """The GAN discriminator's leaves: ``d_params/``, ``d_batch_stats/``
    (each SN conv's u) and optax.adam's state ``d_opt_state/0/{count, mu,
    nu}`` (its ``d_opt_state/1``, the lr scale, holds no leaf)."""
    d = trainer.discriminator
    flat = {"d_" + k: v
            for k, v in state_dict_to_variables(d.state_dict()).items()}
    flat.update(_adam_moments(trainer.d_opt, dict(d.named_parameters()),
                              state_dict_to_variables, "d_opt_state/0/"))
    flat["d_opt_state/0/count"] = np.asarray(_d_count(trainer), np.int32)
    return flat


def _restore_discriminator(trainer, flat):
    d = trainer.discriminator
    d.load_state_dict(variables_to_state_dict(
        {k[2:]: v for k, v in flat.items()
         if k.startswith(("d_params/", "d_batch_stats/"))}), strict=True)
    _set_adam(trainer.d_opt, dict(d.named_parameters()), flat,
              "d_opt_state/0/", int(flat["d_opt_state/0/count"]),
              variables_to_state_dict, trainer.device)


def train_state_to_tree(trainer):
    """A ``Trainer``'s full state as flat JAX TrainState keys: ``params/``
    and ``batch_stats/`` (the weight bridge), ``opt_state/`` (per group
    Adam's ``count``, ``mu`` = exp_avg and ``nu`` = exp_avg_sq in the
    params' layout, and the schedule's ``count``), ``policy_state/``,
    ``alpha``, ``rng`` (``rng_key``), ``step``, with a GAN the
    discriminator's ``d_params/``, ``d_batch_stats/`` and
    ``d_opt_state/``, and ``torch/seed``, the seed the port's per-step
    streams derive from."""
    flat = model_state_dict_to_variables(trainer.model.state_dict())
    count = np.asarray(trainer.opt_count, np.int32)
    for group, params in _group_params(trainer).items():
        pre = _adam_prefix(group)
        flat.update(_adam_moments(trainer.opt, params,
                                  model_state_dict_to_variables,
                                  f"{pre}/0/"))
        flat[f"{pre}/0/count"] = count
        flat[f"{pre}/1/count"] = count
    for f in _POLICY_FIELDS:
        flat[f"policy_state/{f}"] = getattr(trainer.policy_state,
                                            f).cpu().numpy()
    flat["alpha"] = trainer.alpha.detach().cpu().numpy()
    flat["rng"] = rng_key(trainer.seed, trainer.step)
    flat["step"] = np.asarray(trainer.step, np.int32)
    if trainer.discriminator is not None:
        flat.update(_discriminator_tree(trainer))
    flat["torch/seed"] = np.asarray(trainer.seed, np.int32)
    return flat


def restore_train_state(trainer, flat):
    """Load a flat TrainState tree (``train_state_to_tree``'s keys, from
    either package) into ``trainer``. Strict: every key of the trainer's
    own tree but ``torch/`` ones must be present (a partial optimizer
    state would silently perturb optimization), and a tree with
    discriminator leaves needs a trainer with a GAN; the error names up to
    8 missing keys. Without ``torch/seed`` (a JAX checkpoint) the trainer
    keeps its configured seed."""
    want = [k for k in train_state_to_tree(trainer)
            if not k.startswith("torch/")]
    missing = [k for k in want if k not in flat]
    if missing:
        raise ValueError(
            "checkpoint is missing TrainState leaves (refusing a partial "
            f"resume): {missing[:8]}{'...' if len(missing) > 8 else ''}")
    if trainer.discriminator is None and any(
            k.startswith(("d_params/", "d_opt_state/")) for k in flat):
        raise ValueError("checkpoint holds a GAN discriminator's state; "
                         "the trainer has no gan_cfg")
    load_model_variables(trainer.model, {
        k: v for k, v in flat.items()
        if k.startswith(("params/", "batch_stats/"))})
    dev = trainer.device
    for group, params in _group_params(trainer).items():
        pre = _adam_prefix(group)
        _set_adam(trainer.opt, params, flat, f"{pre}/0/",
                  int(flat[f"{pre}/0/count"]),
                  model_variables_to_state_dict, dev)
    trainer.opt_count = int(flat[f"{_adam_prefix(GROUPS[0])}/0/count"])
    trainer.policy_state = type(trainer.policy_state)(*(
        torch.as_tensor(np.asarray(flat[f"policy_state/{f}"]), device=dev)
        for f in _POLICY_FIELDS))
    trainer.alpha = torch.as_tensor(np.asarray(flat["alpha"]), device=dev)
    trainer.step = int(flat["step"])
    if trainer.discriminator is not None:
        _restore_discriminator(trainer, flat)
    if "torch/seed" in flat:
        trainer.seed = int(flat["torch/seed"])
    return trainer


class Saver:
    """Rolling checkpoint manager with a JSON index (``<prefix>checkpoints``:
    the ``latest`` list and the ``current`` pointer), as the JAX package's
    ``Saver``: files ``weights_<prefix><name>-<step>.npz``, at most
    ``max_ckpts`` kept."""

    def __init__(self, save_path, max_ckpts=5, prefix=""):
        self.save_path = save_path
        self.max_ckpts = max_ckpts
        self.prefix = prefix
        self.index_path = os.path.join(save_path, f"{prefix}checkpoints")

    def _read_index(self):
        if os.path.exists(self.index_path):
            with open(self.index_path) as f:
                return json.load(f)
        return {"latest": [], "current": None}

    def save(self, name, flat, step):
        """Write the new weights first, then the index naming them, then
        evict the oldest: a kill in between never leaves ``current``
        dangling."""
        os.makedirs(self.save_path, exist_ok=True)
        ckpts = self._read_index()
        model_path = f"{self.prefix}{name}-{step}.npz"
        save_variables(os.path.join(self.save_path, "weights_" + model_path),
                       flat, step)
        latest = ckpts["latest"]
        todel = None
        if self.max_ckpts is not None and len(latest) >= self.max_ckpts:
            todel, latest = latest[0], latest[1:]
        latest.append(model_path)
        ckpts["latest"], ckpts["current"] = latest, model_path
        with open(self.index_path, "w") as f:
            f.write(json.dumps(ckpts, indent=2))
        if todel is not None:
            try:
                os.remove(os.path.join(self.save_path, "weights_" + todel))
            except FileNotFoundError:
                pass
        return model_path

    def read_latest_checkpoint(self):
        return self._read_index().get("current")

    def load_weights(self):
        """(flat tree, meta) of the current checkpoint, or (None, None)."""
        cur = self.read_latest_checkpoint()
        if cur is None:
            return None, None
        return load_variables(os.path.join(self.save_path, "weights_" + cur))
