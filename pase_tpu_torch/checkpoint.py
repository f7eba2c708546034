"""Checkpoints of the port, in the JAX package's native layout.

* ``save_variables`` / ``load_variables``: one ``.npz`` of flat
  ``/``-joined keys plus a ``__meta__`` entry (uint8 JSON, the step), as
  ``pase_tpu/checkpoint.py`` writes them.
* ``train_state_to_tree`` / ``restore_train_state``: a ``Trainer``'s full
  state as the JAX package's TrainState keys, and back (strict).
* ``Saver``: the rolling checkpoint index with ``max_ckpts`` retention.
* ``load_frontend_ckpt``: an encoder artifact (native .npz or reference
  torch .ckpt) into a module.
* The reference torch layouts (``pase_tpu/checkpoint.py``'s):
  ``torch_to_variables`` fills JAX-layout variables from a reference
  state dict through ``_map_torch_key`` (weight_norm's weight_g /
  weight_v, spectral_norm's weight_orig / weight_u, the BiRNN's torch
  leaves, the conv / linear / transposed-conv transposes; a partial load
  raises unless ``strict=False``); ``load_reference_pase_ckpt`` imports a
  whole reference ``pase`` model (``rename_reference_pase_keys``: the
  encoder and every worker); ``torch_gru_params`` maps an nn.GRU layer
  onto the GRU head's cell; ``export_torch_state_dict`` is ``util_scripts
  export-torch``'s writer.

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
  head's ``gru_{i}``, WaveRNN's ``rnn1_cell`` / ``rnn2_cell``, the
  spectrum LM's scanned ``step/l{i}`` LSTM / GRU cells) <-> the
  port's ``nn.FlaxRNN`` of that name (``weight_ih``, ``weight_hh``,
  ``bias_ih`` + ``bias_hn`` or ``bias_hh``), kernels transposed and
  stacked in torch's gate order. Adam's moments map the same way.
* The decoders (``decoders.py``) keep the JAX trees' names: a
  ``SpectrogramDecoder``'s ``dec_{i}/conv`` | ``deconv``, ``act``,
  ``norm`` and ``out``, a ``SpectrumLM``'s ``step/l{i}`` cells and
  ``step/out_fc`` Dense load through the rules above.
"""

import json
import os
import re

import numpy as np
import torch

from pase_tpu_torch.nn import flax_cell_to_torch, torch_cell_to_flax
from pase_tpu_torch.parallel import tp

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
_BATCH_STATS = {"mean", "var", "emb", "ema_cluster_size", "ema_w", "u",
                "running_dist"}


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


def jax_leaf_layout(module, leaf, tensor):
    """(JAX shape, torch axis, blocks) of the leaf ``leaf`` of ``module``
    under the bridge above: the leaf's shape in the JAX layout (of one
    gate, for a ``FlaxRNN`` cell's stacked gates), and the torch axis that
    holds JAX's trailing axis, in ``blocks`` equal blocks (the gates). A
    kernel, a Dense or a weight-norm direction is transposed (its JAX
    trailing axis is torch's axis 0: a conv's Cout, a transposed conv's
    Cin); a BiRNN leaf, a codebook, ``low_hz`` [C, 1] and every other leaf
    keep their layout (trailing axis last). A scalar has no axis (None)."""
    shape = tuple(tensor.shape)
    if not shape:
        return shape, None, 1
    if leaf in _CELL_TORCH and isinstance(
            getattr(module, "weight_hh", None), torch.Tensor):
        hidden = module.weight_hh.shape[1]
        jax_shape = (shape[1], hidden) if len(shape) == 2 else (hidden,)
        return jax_shape, 0, shape[0] // hidden
    if (leaf == "weight" and len(shape) >= 2) or (leaf == "v"
                                                   and len(shape) == 3):
        return shape[::-1], 0, 1
    return shape, len(shape) - 1, 1


def save_variables_npz(path, state_dict, step=0):
    """Write a state dict as a native .npz (the JAX package's
    ``checkpoint.save_variables`` layout, ``__meta__`` included)."""
    return save_variables(path, state_dict_to_variables(state_dict), step)


def _load_torch_state_dict(path):
    st = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(st, dict) and "state_dict" in st:
        st = st["state_dict"]
    return dict(st)


def _map_torch_key(tkey):
    """A reference torch state-dict key -> (collection, JAX path tuple,
    transform tag), or None for ``num_batches_tracked`` (the JAX
    package's ``_map_torch_key``): 'blocks.0' -> 'blocks_0',
    'rnn.layers.0.linear' -> ('rnn', 'layers_0_linear'); torch's
    nn.LSTM / nn.GRU leaves -> the BiRNN's; weight_norm's weight_g /
    weight_v -> 'g' (squeezed) / 'v' (conv layout); spectral_norm's
    weight_orig -> 'kernel', weight_u -> batch_stats 'u'; low_hz_ /
    band_hz_, running_mean / running_var -> their JAX names; 'weight'
    -> a kernel or an elementwise weight, by what the destination has."""
    parts = tkey.split(".")
    if parts[-1] == "num_batches_tracked":
        return None
    path = []
    i = 0
    while i < len(parts) - 1:
        p = parts[i]
        if i + 1 < len(parts) - 1 and parts[i + 1].isdigit():
            if p == "layers" and i + 2 < len(parts) \
                    and parts[i + 2] == "linear":
                path.append(f"layers_{parts[i + 1]}_linear")
                i += 3
                continue
            path.append(f"{p}_{parts[i + 1]}")
            i += 2
        else:
            path.append(p)
            i += 1
    path = tuple(path)
    leaf = parts[-1]
    m = _BIRNN_TORCH.match(leaf)
    if m:
        kind, side, lnum, rev = m.groups()
        return ("params", path + (f"l{lnum}_{'bw' if rev else 'fw'}_"
                                  f"{'w' if kind == 'weight' else 'b'}_"
                                  f"{side}",), "id")
    special = {"weight_g": ("params", "g", "squeeze"),
               "weight_v": ("params", "v", "conv_kernel"),
               "weight_u": ("batch_stats", "u", "id"),
               "weight_orig": ("params", "kernel", "conv_kernel"),
               "low_hz_": ("params", "low_hz", "id"),
               "band_hz_": ("params", "band_hz", "id"),
               "running_mean": ("batch_stats", "mean", "id"),
               "running_var": ("batch_stats", "var", "id")}
    if leaf in special:
        col, name, tag = special[leaf]
        return (col, path + (name,), tag)
    if leaf == "weight":
        return ("params", path, "weight")
    return ("params", path + (leaf,), "id")


def torch_to_variables(state_dict, ref, load_last=True, strict=True):
    """Fill a copy of ``ref`` (JAX flattened variables, {'params/...':
    array, 'batch_stats/...': array}: the destination's layout and
    shapes) from a reference torch state dict, key by key through
    ``_map_torch_key`` with the layout transposes (a conv weight [O, I, K]
    -> [K, I, O], a transposed conv's [I, O, K] -> [K, O, I], a linear's
    [O, I] -> [I, O]); keys whose destination is missing or of another
    shape are skipped. The JAX package's ``torch_to_variables``: with
    ``strict`` a skipped key raises, and so (unless ``load_last`` is
    False, which drops the file's last two keys) does a 'params' entry
    left unfilled. One addition: a leaf the map puts under 'params' whose
    destination lives in 'batch_stats' only (the VQ codebook and its EMA
    state, a spectral-norm conv's ``u`` under its own name) goes there."""
    out = {k: np.asarray(v) for k, v in ref.items()}
    keys = list(state_dict)
    if not load_last:
        keys = keys[:-2]
    skipped, filled = [], set()
    for tkey in keys:
        mapped = _map_torch_key(tkey)
        if mapped is None:
            continue
        col, path, tag = mapped
        arr = state_dict[tkey]
        arr = (arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor)
               else np.asarray(arr))
        base = "/".join(path)
        if tag == "weight":
            dest = next((f"{col}/{base}/{leaf}"
                         for leaf in ("kernel", "weight", "scale")
                         if f"{col}/{base}/{leaf}" in out), None)
            if dest is None:
                skipped.append(tkey)
                continue
            if dest.endswith("/kernel"):
                if arr.ndim == 3:
                    a = arr.transpose(2, 1, 0)
                    if a.shape != out[dest].shape and \
                            arr.transpose(2, 0, 1).shape == out[dest].shape:
                        a = arr.transpose(2, 0, 1)
                    arr = a
                elif arr.ndim == 2:
                    arr = arr.T
        else:
            dest = f"{col}/{base}"
            if dest not in out and col == "params" and \
                    f"batch_stats/{base}" in out:
                dest = f"batch_stats/{base}"
            if dest not in out:
                skipped.append(tkey)
                continue
            if tag == "squeeze":
                arr = arr.reshape(-1)
            elif tag == "conv_kernel":
                arr = _flip_conv(arr) if arr.ndim in (2, 3) else arr
            elif arr.ndim == 2 and out[dest].ndim == 2 and \
                    arr.shape == out[dest].shape[::-1] and \
                    arr.shape != out[dest].shape:
                arr = arr.T
        if out[dest].shape != arr.shape:
            skipped.append(tkey)
            continue
        out[dest] = np.ascontiguousarray(arr)
        filled.add(dest)
    if skipped and strict:
        raise ValueError(
            f"torch checkpoint load skipped {len(skipped)} keys "
            f"({skipped[:8]}{'...' if len(skipped) > 8 else ''}); pass "
            "strict=False to allow a partial load")
    if strict and load_last:
        unfilled = [k for k in out
                    if k.startswith("params/") and k not in filled]
        if unfilled:
            raise ValueError(
                f"torch checkpoint covers only {len(filled)} of the "
                f"model's param entries; {len(unfilled)} remain at init "
                f"({unfilled[:8]}{'...' if len(unfilled) > 8 else ''}); "
                "pass strict=False to allow a partial load")
    return out


def load_frontend_ckpt(path, module, load_last=True):
    """Load a native .npz or a reference torch .ckpt state dict into
    ``module`` with ``load_state_dict(strict=True)``. Only a
    ``num_batches_tracked`` buffer the file lacks (the native format has
    none) keeps the module's value.

    A torch .ckpt goes through ``torch_to_variables`` into the module's
    own layout, so the reference's names load (weight-norm / spectral-norm
    leaves, the BiRNN's, the encoders' convs), a partial file raises, and
    ``load_last=False`` drops the file's last two
    entries (the reference's ``load_pretrained_ckpt``, as
    ``pase_tpu/checkpoint.py`` does): the module keeps its own values
    there. A native .npz always loads whole."""
    if path.endswith(".npz"):
        sd = variables_to_state_dict(load_variables_npz(path))
    else:
        ref = state_dict_to_variables(module.state_dict())
        sd = variables_to_state_dict(torch_to_variables(
            _load_torch_state_dict(path), ref, load_last=load_last))
    for k, v in module.state_dict().items():
        if k not in sd and k.endswith("num_batches_tracked"):
            sd[k] = v
    module.load_state_dict(sd, strict=True)
    return module


def export_torch_state_dict(flat):
    """A native encoder artifact's flattened variables -> the reference
    torch state dict that ``util_scripts.py export-torch`` writes: the
    collection dropped, 'blocks_N' / 'denseskips_N' / 'layers_0_linear'
    dotted, kernels transposed to torch's conv [O, I, K] / linear [O, I]
    layout and named 'weight', the BiRNN's leaves as torch's nn.LSTM /
    nn.GRU ones, low_hz_ / band_hz_, running_mean / running_var, and a
    zero ``num_batches_tracked`` per norm (the reference's loader counts
    them)."""
    out = {}
    # in the order of the JAX writer's key walk: its tree's keys sorted
    # at every level
    for k in sorted(flat, key=lambda key: key.split("/")):
        arr = np.asarray(flat[k])
        tk = (k.replace("/", ".").replace("params.", "")
              .replace("batch_stats.", "").replace("blocks_", "blocks.")
              .replace("denseskips_", "denseskips."))
        tk = tk.replace("layers_0_linear", "layers.0.linear")
        m = re.search(r"\.l(\d+)_(fw|bw)_([wb])_(ih|hh)$", tk)
        if m:
            lnum, d, kind, side = m.groups()
            out[tk[:m.start()]
                + f".{'weight' if kind == 'w' else 'bias'}_{side}_l{lnum}"
                + ("_reverse" if d == "bw" else "")] = torch.tensor(arr)
            continue
        for jax_leaf, torch_leaf in (("kernel", "weight"),
                                     ("low_hz", "low_hz_"),
                                     ("band_hz", "band_hz_"),
                                     ("mean", "running_mean"),
                                     ("var", "running_var")):
            if tk.endswith("." + jax_leaf):
                if jax_leaf == "kernel":
                    arr = _flip_conv(arr) if arr.ndim in (2, 3) else arr
                tk = tk[:-len(jax_leaf)] + torch_leaf
                break
        out[tk] = torch.tensor(arr)
    for tk in [k for k in out if k.endswith(".running_mean")]:
        out[tk[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.long)
    return out


def rename_reference_pase_keys(state_dict, regr_names, cls_names):
    """A reference ``pase`` model state dict (``frontend.``,
    ``regression_workers.{i}.``, ``classification_workers.{i}.minion.``)
    -> keys under the workers' names ('frontend.' kept): the JAX
    package's ``rename_reference_pase_keys``."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("frontend."):
            out[k] = v
        elif k.startswith("regression_workers."):
            parts = k.split(".")
            out[regr_names[int(parts[1])] + "." + ".".join(parts[2:])] = v
        elif k.startswith("classification_workers."):
            parts = k.split(".")
            rest = parts[2:]
            if rest and rest[0] == "minion":
                rest = rest[1:]
            out[cls_names[int(parts[1])] + "." + ".".join(rest)] = v
    return out


def load_reference_pase_ckpt(ckpt, model, workers_meta):
    """Load a whole reference ``pase`` checkpoint (a path to a torch state
    dict, or the dict) into ``model`` (a ``model.PASE``): the encoder and
    every worker, through ``rename_reference_pase_keys`` and
    ``torch_to_variables`` (strict: a partial load raises), as the JAX
    package's ``load_reference_pase_ckpt`` fills its variables."""
    sd = _load_torch_state_dict(ckpt) if isinstance(ckpt, str) else ckpt
    sd = rename_reference_pase_keys(
        sd, [e["name"] for e in workers_meta["regr"]],
        [e["name"] for e in workers_meta["cls"]])
    ref = model_state_dict_to_variables(model.state_dict())
    return load_model_variables(model, torch_to_variables(sd, ref))


def torch_gru_params(state_dict, prefix, layer=0):
    """One layer of a torch nn.GRU (``{prefix}.weight_ih_l{layer}`` ...)
    -> the tensors of the GRU head's ``nn.FlaxRNN`` cell: ``weight_ih``
    and ``weight_hh`` as they are ([r|z|n] rows, torch's gate order),
    ``bias_ih`` with torch's hidden r and z biases folded into the input
    ones (flax's 'hr' and 'hz' have none), ``bias_hn`` torch's b_hn. The
    counterpart of the JAX package's ``torch_gru_params`` (which gives
    the same cell as flax Dense kernels)."""
    def get(name):
        v = state_dict.get(f"{prefix}.{name}_l{layer}")
        if v is None:
            return None
        return (v.detach().cpu() if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).float()

    wih, whh = get("weight_ih"), get("weight_hh")
    h = wih.shape[0] // 3
    out = {"weight_ih": wih.clone(), "weight_hh": whh.clone()}
    bih, bhh = get("bias_ih"), get("bias_hh")
    if bih is None:
        bih, bhh = torch.zeros(3 * h), torch.zeros(3 * h)
    out["bias_ih"] = torch.cat([bih[:2 * h] + bhh[:2 * h], bih[2 * h:]])
    out["bias_hn"] = bhh[2 * h:].clone()
    return out


def model_variables_to_state_dict(flat):
    """JAX PASE variables ({'params/frontend/W/kernel': array,
    'params/lps/blocks_0/W/kernel': array, 'params/att_lps/mlp_0/kernel':
    array, ...}) -> the state dict of ``model.PASE``
    ({'frontend.W.weight': tensor, 'workers.lps.blocks.0.W.weight':
    tensor, 'att_lps.mlp_0.weight': tensor, ...})."""
    groups = {}
    for key, arr in flat.items():
        col, top, *rest = key.split("/")
        groups.setdefault(top, {})["/".join([col] + rest)] = arr
    sd = {}
    for top, sub in groups.items():
        if top == "frontend" or top.startswith("att_"):
            prefix = f"{top}."
        else:
            prefix = f"workers.{top}."
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
        elif top != "frontend" and not top.startswith("att_"):
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
    buffers keep the model's value. A model laid out over --n_model's
    model ranks (``parallel/tp.py``) takes its parts of the leaves."""
    sd = tp.local_tensors(model_variables_to_state_dict(flat),
                          tp.leaf_specs(model))
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = v
    model.load_state_dict(sd, strict=True)
    return model


# ---------------------------------------------------------------------------
# the full train state in the JAX package's TrainState layout
# ---------------------------------------------------------------------------

_POLICY_FIELDS = ("q", "last_loss", "pi", "count")


def _adam_prefix(group):
    """optax ``multi_transform`` -> ``masked`` -> (rule, ..., schedule)
    keys."""
    return f"opt_state/inner_states/{group}/inner_state"


# per optimizer rule: {optax leaf of chain element 0: the port's state
# key}, and the index of the lr schedule's element (its 'count') in the
# optax chain (adamw's add_decayed_weights, element 1, holds no leaf)
_RULE_LEAVES = {"adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
                "radam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
                "adamw": {"mu": "exp_avg", "nu": "exp_avg_sq"},
                "rmsprop": {"nu": "square_avg"},
                "sgd": {}}
_SCHED_INDEX = {"adam": 1, "radam": 1, "adamw": 2, "rmsprop": 1, "sgd": 1}


def _group_params(trainer):
    """{group: ({parameter name: parameter}, its optimizer rule)} of the
    trainer's optimizer."""
    named = {id(p): n for n, p in trainer.model.named_parameters()}
    return {g["name"]: ({named[id(p)]: p for p in g["params"]},
                        g.get("rule", "adam"))
            for g in trainer.opt.param_groups}


def rng_key(seed, step):
    """The ``rng`` leaf a port checkpoint carries: the raw JAX key
    [seed, step] (uint32). A JAX resume of a port checkpoint draws its
    distortions and dropout from there; the port itself derives its
    streams from (seed, step) and does not read it."""
    return np.array([int(seed) & 0xFFFFFFFF, int(step) & 0xFFFFFFFF],
                    np.uint32)


def _moments(opt, params, to_variables, head, leaves=None, specs=None):
    """The optimizer's per-parameter state of ``params`` ({name:
    parameter}; zeros before its first step) as ``{head}{leaf}/<JAX
    path>`` leaves, ``leaves`` {optax leaf: state key} (Adam's mu / nu by
    default); ``to_variables`` maps a state dict to JAX variables. The
    state of a parameter held as a part (``specs``: ``tp.leaf_specs``) is
    gathered whole."""
    flat = {}
    leaves = leaves if leaves is not None else _RULE_LEAVES["adam"]
    for leaf, key in leaves.items():
        sd = {}
        for n, p in params.items():
            st = opt.state.get(p, {})
            sd[n] = st[key] if key in st else torch.zeros_like(p)
        sd = tp.full_tensors(sd, specs)
        for k, v in to_variables(sd).items():
            flat[f"{head}{leaf}/{k.partition('/')[2]}"] = v
    return flat


def _set_moments(opt, params, flat, head, count, to_state_dict, device,
                 leaves=None, specs=None):
    """The inverse: the optimizer's state of ``params`` from the
    ``{head}{leaf}/...`` leaves of ``flat`` (cut to the parts of
    ``specs``); with a count (Adam's, AdamW's, RAdam's) at step
    ``count``."""
    leaves = leaves if leaves is not None else _RULE_LEAVES["adam"]
    moments = {}
    for leaf in leaves:
        pre = f"{head}{leaf}/"
        moments[leaf] = tp.local_tensors(to_state_dict(
            {"params/" + k[len(pre):]: v for k, v in flat.items()
             if k.startswith(pre)}), specs)
    for n, p in params.items():
        st = {key: moments[leaf][n].to(device).contiguous()
              for leaf, key in leaves.items()}
        if "exp_avg" in st:
            st["step"] = torch.tensor(float(count), dtype=torch.float32)
        if st:
            opt.state[p] = st
        else:
            opt.state.pop(p, None)


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
    flat = {"d_" + k: v for k, v in
            state_dict_to_variables(tp.full_state_dict(d)).items()}
    flat.update(_moments(trainer.d_opt, dict(d.named_parameters()),
                         state_dict_to_variables, "d_opt_state/0/",
                         specs=tp.leaf_specs(d)))
    flat["d_opt_state/0/count"] = np.asarray(_d_count(trainer), np.int32)
    return flat


def _restore_discriminator(trainer, flat):
    d = trainer.discriminator
    specs = tp.leaf_specs(d)
    d.load_state_dict(tp.local_tensors(variables_to_state_dict(
        {k[2:]: v for k, v in flat.items()
         if k.startswith(("d_params/", "d_batch_stats/"))}), specs),
        strict=True)
    _set_moments(trainer.d_opt, dict(d.named_parameters()), flat,
                 "d_opt_state/0/", int(flat["d_opt_state/0/count"]),
                 variables_to_state_dict, trainer.device, specs=specs)


def train_state_to_tree(trainer):
    """A ``Trainer``'s full state as flat JAX TrainState keys: ``params/``
    and ``batch_stats/`` (the weight bridge), ``opt_state/`` (per group,
    its optax chain's leaves: Adam / RAdam / AdamW ``0/count``, ``0/mu``
    = exp_avg and ``0/nu`` = exp_avg_sq in the params' layout, RMSprop
    ``0/nu`` = square_avg, SGD none; then the schedule's ``count``, at
    ``2/`` for AdamW, ``1/`` for the others), ``policy_state/``,
    ``alpha``, ``rng`` (``rng_key``), ``step``, with a GAN the
    discriminator's ``d_params/``, ``d_batch_stats/`` and
    ``d_opt_state/``, and ``torch/seed``, the seed the port's per-step
    streams derive from. Leaves held as parts over --n_model's model ranks
    are gathered whole (every rank calls it): the tree is the n_model = 1
    layout."""
    flat = model_state_dict_to_variables(
        tp.full_state_dict(trainer.model))
    specs = tp.leaf_specs(trainer.model)
    count = np.asarray(trainer.opt_count, np.int32)
    for group, (params, rule) in _group_params(trainer).items():
        pre = _adam_prefix(group)
        flat.update(_moments(trainer.opt, params,
                             model_state_dict_to_variables, f"{pre}/0/",
                             _RULE_LEAVES[rule], specs))
        if "mu" in _RULE_LEAVES[rule]:            # a count beside mu / nu
            flat[f"{pre}/0/count"] = count
        flat[f"{pre}/{_SCHED_INDEX[rule]}/count"] = count
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
    specs = tp.leaf_specs(trainer.model)
    counts = []
    for group, (params, rule) in _group_params(trainer).items():
        pre = _adam_prefix(group)
        counts.append(int(flat[f"{pre}/{_SCHED_INDEX[rule]}/count"]))
        _set_moments(trainer.opt, params, flat, f"{pre}/0/", counts[-1],
                     model_variables_to_state_dict, dev,
                     _RULE_LEAVES[rule], specs)
    trainer.opt_count = counts[0]
    trainer.policy_state = type(trainer.policy_state)(*(
        torch.as_tensor(np.array(flat[f"policy_state/{f}"]), device=dev)
        for f in _POLICY_FIELDS))
    trainer.alpha = torch.as_tensor(np.array(flat["alpha"]), device=dev)
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
        dangling. The index is written to a temporary file and renamed
        over the old one, so a kill while it is written leaves the old
        index whole (the JAX package's ``Saver`` writes it in place)."""
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
        tmp = self.index_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(ckpts, indent=2))
        os.replace(tmp, self.index_path)
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
