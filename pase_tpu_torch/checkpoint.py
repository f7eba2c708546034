"""The weight bridge between the JAX package's checkpoints and the port.

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
  ``running_mean``/``running_var``.
* ``load_frontend_ckpt`` loads either format into a module, strictly.
* ``model_variables_to_state_dict`` / ``model_state_dict_to_variables``
  do the same for the whole PASE model (``model.PASE``): the JAX
  ``params/frontend/...`` and ``params/<worker>/...`` trees (and their
  ``batch_stats/``) <-> ``frontend.*`` and ``workers.<worker>.*``. A
  transposed-conv kernel [K, Cout, Cin] <-> weight [Cin, Cout, K] is the
  same transpose as a conv's. ``load_model_variables`` loads strictly.
"""

import json
import os
import re

import numpy as np
import torch

_INDEXED = re.compile(r"^(blocks|denseskips)_(\d+)$")
_QRNN_LAYER = re.compile(r"^layers_(\d+)_linear$")
_COLLECTIONS = ("params", "batch_stats")
_LEAF_TO_TORCH = {"low_hz": "low_hz_", "band_hz": "band_hz_",
                  "mean": "running_mean", "var": "running_var"}
_LEAF_TO_JAX = {v: k for k, v in _LEAF_TO_TORCH.items()}


def load_variables_npz(path):
    """Native .npz -> {'/'-joined key: np.ndarray}, without ``__meta__``."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files if k != "__meta__"}


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


def variables_to_state_dict(flat):
    """JAX flattened variables ({'params/blocks_1/conv/kernel': array, ...})
    -> the port's state dict ({'blocks.1.conv.weight': tensor, ...})."""
    sd = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] not in _COLLECTIONS:
            raise KeyError(f"unexpected collection in {key!r}")
        *path, leaf = parts[1:]
        arr = np.asarray(arr)
        if leaf == "kernel":
            # conv [K, Cin, Cout] -> [Cout, Cin, K]; Dense [in, out] -> [out, in]
            arr = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
            leaf = "weight"
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
    flat = {}
    for tkey, t in state_dict.items():
        *path, leaf = tkey.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().cpu().numpy()
        col = "params"
        if leaf in _LEAF_TO_JAX:
            leaf = _LEAF_TO_JAX[leaf]
            col = "batch_stats" if leaf in ("mean", "var") else "params"
        elif leaf == "weight" and arr.ndim >= 2:
            arr = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
            leaf = "kernel"
        flat["/".join([col] + _module_path_to_jax(path) + [leaf])] = \
            np.ascontiguousarray(arr)
    return flat


def save_variables_npz(path, state_dict, step=0):
    """Write a state dict as a native .npz (the JAX package's
    ``checkpoint.save_variables`` layout, ``__meta__`` included)."""
    flat = state_dict_to_variables(state_dict)
    flat["__meta__"] = np.frombuffer(
        json.dumps({"step": int(step)}).encode("utf-8"), dtype=np.uint8).copy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    return path


def _load_torch_state_dict(path):
    st = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(st, dict) and "state_dict" in st:
        st = st["state_dict"]
    return dict(st)


def load_frontend_ckpt(path, module):
    """Load a native .npz or a reference torch .ckpt state dict into
    ``module`` with ``load_state_dict(strict=True)``. Only a
    ``num_batches_tracked`` buffer the file lacks (the native format has
    none) keeps the module's value."""
    if path.endswith(".npz"):
        sd = variables_to_state_dict(load_variables_npz(path))
    else:
        sd = _load_torch_state_dict(path)
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = v
    module.load_state_dict(sd, strict=True)
    return module


def model_variables_to_state_dict(flat):
    """JAX PASE variables ({'params/frontend/W/kernel': array,
    'params/lps/blocks_0/W/kernel': array, ...}) -> the state dict of
    ``model.PASE`` ({'frontend.W.weight': tensor,
    'workers.lps.blocks.0.W.weight': tensor, ...})."""
    sd = {}
    for key, arr in flat.items():
        col, top, *rest = key.split("/")
        prefix = "frontend." if top == "frontend" else f"workers.{top}."
        for k, v in variables_to_state_dict(
                {"/".join([col] + rest): arr}).items():
            sd[prefix + k] = v
    return sd


def model_state_dict_to_variables(state_dict):
    """The inverse of ``model_variables_to_state_dict``
    (``num_batches_tracked`` is dropped)."""
    flat = {}
    for tkey, t in state_dict.items():
        top, _, rest = tkey.partition(".")
        if top == "workers":
            top, _, rest = rest.partition(".")
        elif top != "frontend":
            raise KeyError(f"unexpected PASE state-dict key {tkey!r}")
        for k, v in state_dict_to_variables({rest: t}).items():
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
