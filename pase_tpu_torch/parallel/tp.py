"""Column-parallel compute over the model group (``--n_model``).

The JAX package lays its parameters and optimizer state out by
``state_shardings`` on a ('data', 'model') mesh: the trailing (output
channel / lane) axis of every leaf of at least 64 that ``n_model``
divides is sharded, the rest replicated, and GSPMD computes each sharded
layer by output channel. The port makes that explicit. ``shard_model``
applies the port's copy of the rule (``mesh.shard_rule``) to each leaf in
the JAX layout (``checkpoint.jax_leaf_layout``), keeps only this rank's
part of every sharded leaf (its Adam moments follow, since the optimizer
is built on the parts; the count stays whole), and gives each layer
one of three routes:

1. **column**: the layer holds and computes only its own output
   channels. Its input enters through ``copy_in`` (identity forward, the
   gradient summed over the model group backward); the per-channel work
   after the conv runs on the rank's channels with its part of the
   parameters; the channels are gathered (``gather_out``: all-gather
   forward, the rank's part of the gradient backward) where a consumer
   reads across channels: the next conv, the QRNN, the heads' inputs and
   the loss. The layer kinds:
   * ``FeBlock`` (a ``Conv1D``, ``WNConv1D`` or ``SincConv``, then
     BatchNorm (statistics over the data group), InstanceNorm or none,
     then PReLU or a named activation). The sinc layer's ``low_hz_`` /
     ``band_hz_`` ([C, 1] in JAX: replicated) are held whole and each
     rank synthesizes its own filters from its rows of them;
   * ``MLPBlock`` (the MLP and decoder heads' blocks): its dropout is
     drawn for all channels from the shared generator and sliced, so
     channel c gets the same draw whatever ``n_model`` is; dropin acts
     on the gathered input;
   * ``GDeconv1DBlock`` (the ``cchunk`` decoder), whose transposed-conv
     weight [Cin, Cout, K] is held by Cout (JAX shards Cin, its trailing
     axis: the same bytes per rank);
   * a worker head's final 1x1 ``Conv1D`` (``W``);
   * ``WaveFe``'s output: ``W``, the dense-skip projections (summed on the
     rank's channels) and the affine-free ``norm_out``, gathered before
     the tanh-free output and the quantizer.
2. **lanes**: the ``QRNN``. Its gate projection [3H, 2C] is split by lane:
   rank m holds the z, f and o rows of lanes [m H/n, (m + 1) H/n) (JAX's
   contiguous third would mix gates; the bytes per rank are the same), so
   ``cuda_qrnn.qrnn_pool`` (K2 in training, K1's loop in eval) runs on
   [B, T, H/n] with no gather before it; h is gathered after it. A QRNN
   whose H the model ranks do not divide takes route 3.
3. **gathered**: a sharded leaf whose layer cannot compute by output
   channel is held as its part at rest (with its moments), all-gathered
   whole for its host module's forward (a forward pre-hook; a
   gradient's part is kept backward, a buffer's part written back after
   the forward) and computes replicated. The layer kinds: a glu,
   spectral-norm or LayerNorm ``FeBlock`` / ``GDeconv1DBlock``, the
   residual ``FeResBlock``, ``BiRNN`` (the lstm / gru context), a
   ``FlaxRNN`` cell (the GRU head, WaveRNN), ``VQEMA``'s codebook and EMA
   state, ``SNConv1D`` (its power iteration), the fused lps heads' ``W``
   when a width divides (21525 does not at n_model 2 or 4), the attention
   blocks, WaveRNN, the alternative encoders' layers and the GAN
   discriminators (JAX's ``shard_state`` covers ``d_params``). Their host
   is the nearest enclosing module of ``route3_hosts()``, else the model's
   top-level module the step calls.

A leaf the rule replicates is held whole and computed on every model
rank; its gradient is the same on each (``sync_replicated_grads`` makes
it the same bits). ``leaf_specs``, ``full_tensors`` and
``local_tensors`` map between the parts and the n_model = 1 layout: a
checkpoint holds the whole leaves, so it resumes at any ``n_model``.
"""

from typing import NamedTuple

import torch

from pase_tpu_torch.parallel import mesh


class Spec(NamedTuple):
    """How a leaf is split over the model ranks: along torch axis ``dim``,
    in ``blocks`` equal blocks each split on its own (the QRNN's z, f, o
    gates; 1 for a contiguous split)."""
    dim: int
    blocks: int = 1


def own(full, spec, n, i):
    """Rank i's part of ``full`` (of n parts)."""
    size = full.shape[spec.dim] // (spec.blocks * n)
    if spec.blocks == 1:
        return full.narrow(spec.dim, i * size, size)
    return torch.cat([b.narrow(spec.dim, i * size, size)
                      for b in full.chunk(spec.blocks, spec.dim)], spec.dim)


def assemble(parts, spec):
    """The whole tensor of the model ranks' parts (in rank order)."""
    if spec.blocks == 1:
        return torch.cat(parts, spec.dim)
    per = [p.chunk(spec.blocks, spec.dim) for p in parts]
    return torch.cat([q[b] for b in range(spec.blocks) for q in per],
                     spec.dim)


def _wire(t):
    """t as a sum over the model group takes it: float32 for a 16-bit
    float."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t


@torch.no_grad()
def gather_parts(t, spec, grid):
    """The whole tensor of every model rank's part ``t`` (no gradient)."""
    return assemble(mesh.all_gather(t, grid.model_group), spec)


class _CopyIn(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        gw = _wire(g).contiguous().clone()
        mesh.all_reduce_([gw], "sum", ctx.grid.model_group)
        return gw.to(g.dtype), None


class _GatherOut(torch.autograd.Function):
    """All-gather forward; this rank's part of the gradient backward."""

    @staticmethod
    def forward(ctx, x, spec, grid):
        ctx.spec, ctx.grid = spec, grid
        return gather_parts(x, spec, grid)

    @staticmethod
    def backward(ctx, g):
        grid = ctx.grid
        return (own(g, ctx.spec, grid.n_model, grid.i_model).contiguous(),
                None, None)


def enter(module, x):
    """The input of a column layer (``module.tp_column``, its grid; None
    off the model axis): ``copy_in``."""
    grid = module.tp_column
    return x if grid is None else _CopyIn.apply(x, grid)


def leave(module, y, dim=1, blocks=1):
    """The output of a column layer, its channels (axis ``dim``)
    gathered."""
    grid = module.tp_column
    return y if grid is None else _GatherOut.apply(y, Spec(dim, blocks),
                                                   grid)


def own_part(module, p, dim=0):
    """A whole (replicated) leaf's rows of this rank's channels, its
    gradient summed over the model group (the sinc filters' bands)."""
    grid = module.tp_column
    if grid is None:
        return p
    return own(_CopyIn.apply(p, grid), Spec(dim), grid.n_model, grid.i_model)


def channel_draw(module, draw, x):
    """``draw(c)`` of a random tensor over c channels (axis 1) of x: made
    for every channel and sliced to this rank's on a column layer
    (``module``; None: no layer)."""
    grid = None if module is None else module.tp_column
    if grid is None:
        return draw(x.shape[1])
    full = draw(x.shape[1] * grid.n_model)
    return own(full, Spec(1), grid.n_model, grid.i_model)


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------


def _column_leaves(m, nn_mod):
    """(output channels, {submodule path: {leaf: Spec}}) of a layer that
    can compute column-parallel, or None: the leaves indexed by its output
    channel (the sinc bands, held whole, are not listed)."""
    def per_channel(prefix, mod):
        if mod is None:
            return {}
        if isinstance(mod, nn_mod.PReLU):
            return {prefix: {"weight": Spec(0)}}
        if isinstance(mod, nn_mod.BatchNorm1d):
            leaves = {"running_mean": Spec(0), "running_var": Spec(0)}
            if mod.affine:
                leaves.update(weight=Spec(0), bias=Spec(0))
            return {prefix: leaves}
        if isinstance(mod, nn_mod.InstanceNorm1d):
            return ({prefix: {"weight": Spec(0), "bias": Spec(0)}}
                    if mod.weight is not None else {})
        if isinstance(mod, nn_mod.NamedActivation):
            return {}
        return None

    def conv(prefix, c):
        if type(c) is nn_mod.Conv1D:
            leaves = {"weight": Spec(0)}
            if c.bias is not None:
                leaves["bias"] = Spec(0)
            return c.out_channels, {prefix: leaves}
        if isinstance(c, nn_mod.WNConv1D):
            leaves = {"v": Spec(0), "g": Spec(0)}
            if c.bias is not None:
                leaves["bias"] = Spec(0)
            return c.v.shape[0], {prefix: leaves}
        if isinstance(c, nn_mod.SincConv):
            return c.low_hz_.shape[0], {}
        return None

    def block(conv_part, extra):
        if conv_part is None or any(e is None for e in extra):
            return None
        c, leaves = conv_part
        for e in extra:
            leaves.update(e)
        return c, leaves

    if isinstance(m, nn_mod.FeBlock):
        if m.act is None:           # glu reads across the channels
            return None
        return block(conv("conv", m.conv), [per_channel("norm", m.norm),
                                            per_channel("act", m.act)])
    if isinstance(m, nn_mod.MLPBlock):
        return block(conv("W", m.W), [per_channel("act", m.act)])
    if isinstance(m, nn_mod.GDeconv1DBlock):
        if m.act is None:
            return None
        d = m.deconv
        return block((d.out_channels, {"deconv": {"weight": Spec(1),
                                                  "bias": Spec(0)}}),
                     [per_channel("norm", m.norm), per_channel("act", m.act)])
    return None


def _unit_plans(model, n):
    """{module path: (kind, output channels, {leaf path: Spec})} of every
    layer that computes column-parallel or by lanes where the rule shards
    its channels."""
    from pase_tpu_torch import frontend as fe_mod
    from pase_tpu_torch import minions
    from pase_tpu_torch import model as model_mod
    from pase_tpu_torch import nn as nn_mod
    fused = set()
    if isinstance(model, model_mod.PASE):
        fused = {f"workers.{e['name']}" for e in model.regr_meta
                 if model_mod._fuse_eligible(e, model.fused_min_ch)}
    heads = (minions.MLPMinion, minions.DecoderMinion, minions.SPCMinion,
             minions.GapMinion, minions.GRUMinion)
    plans = {}
    for path, m in model.named_modules():
        plan = _column_leaves(m, nn_mod)
        kind = "column"
        if plan is None and isinstance(m, heads) and path not in fused \
                and type(m.W) is nn_mod.Conv1D and m.W.bias is not None:
            leaves = {"weight": Spec(0), "bias": Spec(0)}
            plans[f"{path}.W"] = ("column", m.W.out_channels,
                                  {f"{path}.W.{k}": v
                                   for k, v in leaves.items()})
            continue
        if plan is None and isinstance(m, fe_mod.WaveFe):
            if m.densemerge != "sum" or type(m.W) is not nn_mod.Conv1D:
                continue
            norm = m.norm_out
            if norm is not None and not isinstance(
                    norm, (nn_mod.BatchNorm1d, nn_mod.InstanceNorm1d)):
                continue
            leaves = {"W": {"weight": Spec(0), "bias": Spec(0)}}
            for k in range(len(m.denseskips)):
                leaves[f"denseskips.{k}"] = {"weight": Spec(0)}
            if isinstance(norm, nn_mod.BatchNorm1d):
                leaves["norm_out"] = {"running_mean": Spec(0),
                                      "running_var": Spec(0)}
                if norm.affine:
                    leaves["norm_out"].update(weight=Spec(0), bias=Spec(0))
            elif norm is not None and norm.weight is not None:
                leaves["norm_out"] = {"weight": Spec(0), "bias": Spec(0)}
            plan = (m.emb_dim, leaves)
        elif plan is None and isinstance(m, nn_mod.QRNN):
            hid = m.layers[0].linear.weight.shape[0] // 3
            if hid % n:
                continue
            kind = "lanes"
            plan = (3 * hid, {f"layers.{k}.linear": {"weight": Spec(0, 3),
                                                     "bias": Spec(0, 3)}
                              for k in range(len(m.layers))})
        if plan is None:
            continue
        c, leaves = plan
        pre = f"{path}." if path else ""
        plans[path] = (kind, c, {
            f"{pre}{sub}.{leaf}" if sub else f"{pre}{leaf}": spec
            for sub, d in leaves.items() for leaf, spec in d.items()})
    return plans


def route3_hosts():
    """The module classes that host route 3's gathers of their own or
    their children's leaves."""
    from pase_tpu_torch import adversarial, attention, encoders, minions
    from pase_tpu_torch import nn as nn_mod
    from pase_tpu_torch import wavernn
    return (nn_mod.BiRNN, nn_mod.FlaxRNN, nn_mod.VQEMA, nn_mod.SNConv1D,
            nn_mod.LayerNorm1d, nn_mod.FeBlock, nn_mod.FeResBlock,
            nn_mod.GDeconv1DBlock, nn_mod.MLPBlock, minions.MLPMinion,
            attention.AttentionBlock, wavernn.WaveRNNMinion,
            adversarial.WaveDiscriminator, adversarial.ZDiscriminator,
            encoders.TDNNFe, encoders.ASPPResEncoder, encoders.ResnetEncoder)


def _refresh(owner):
    """An RNN module's flat weight list after its leaves were rebound."""
    if hasattr(owner, "_init_flat_weights"):
        owner._init_flat_weights()


def _swap_in(host, args):
    grid = host.tp_grid
    host._tp_saved = []
    for owner, name, spec, buf in host.tp_gathered:
        store = owner._buffers if buf else owner._parameters
        part = store[name]
        host._tp_saved.append(part)
        store[name] = (gather_parts(part, spec, grid) if buf
                       else _GatherOut.apply(part, spec, grid))
        _refresh(owner)


def _swap_out(host, args, out):
    grid = host.tp_grid
    for (owner, name, spec, buf), part in zip(host.tp_gathered,
                                              host._tp_saved):
        store = owner._buffers if buf else owner._parameters
        if buf:
            with torch.no_grad():
                part.copy_(own(store[name], spec, grid.n_model,
                               grid.i_model))
        store[name] = part
        _refresh(owner)
    host._tp_saved = []


def _set_part(owner, name, spec, grid):
    """Keep rank i's part of the leaf ``name`` of ``owner``."""
    full = owner._parameters.get(name)
    with torch.no_grad():
        if full is not None:
            owner._parameters[name] = torch.nn.Parameter(
                own(full.data, spec, grid.n_model, grid.i_model).clone(),
                requires_grad=full.requires_grad)
        else:
            owner._buffers[name] = own(owner._buffers[name], spec,
                                       grid.n_model,
                                       grid.i_model).clone()
    if not hasattr(owner, "tp_specs"):
        owner.tp_specs = {}
    owner.tp_specs[name] = spec
    _refresh(owner)


def rule_sharded(model, n):
    """{state-dict key: Spec of JAX's trailing axis} of the leaves that
    ``mesh.shard_rule`` shards over n model ranks."""
    from pase_tpu_torch.checkpoint import jax_leaf_layout
    out = {}
    for path, m in model.named_modules():
        leaves = list(m._parameters.items()) + list(m._buffers.items())
        for name, t in leaves:
            if t is None or name == "num_batches_tracked":
                continue
            shape, dim, blocks = jax_leaf_layout(m, name, t)
            if dim is not None and mesh.shard_rule(shape, n):
                out[f"{path}.{name}" if path else name] = Spec(dim, blocks)
    return out


def shard_model(model, grid):
    """Lay ``model`` (the PASE model, or a GAN discriminator) out over the
    model group of ``grid``: every leaf the rule shards keeps this rank's
    part, and each layer takes its route (module docstring). Returns
    {module path: 'column' | 'lanes' | 'gathered'}, also kept in
    ``model.tp_routes``. Identity at n_model 1."""
    model.tp_routes = {}
    if grid.n_model == 1:
        return model.tp_routes
    from pase_tpu_torch import nn as nn_mod
    n = grid.n_model
    sharded = rule_sharded(model, n)
    modules = dict(model.named_modules())
    claimed = set()
    for path, (kind, c, leaves) in _unit_plans(model, n).items():
        channel_rule = mesh.shard_rule((c,), n) and (kind != "lanes"
                                                     or c % (3 * n) == 0)
        # a column layer holds every parameter of its channels as parts
        # (the sinc bands aside); its leaves must be the ones JAX shards
        unit = modules[path]
        owners = {k.rpartition(".")[0] for k in leaves}
        held = {f"{o}.{k}" if o else k for o in owners
                for k, _ in modules[o].named_parameters(recurse=False)}
        if not channel_rule or any(k not in sharded for k in leaves) \
                or held - set(leaves):
            continue
        for key, spec in leaves.items():
            owner_path, _, leaf = key.rpartition(".")
            _set_part(modules[owner_path], leaf, spec, grid)
            claimed.add(key)
        unit.tp_column = grid
        if isinstance(getattr(unit, "conv", None), nn_mod.SincConv):
            unit.conv.tp_column = grid      # the sinc bands' own rows
        model.tp_routes[path] = kind
    hosts = route3_hosts()
    for key, spec in sharded.items():
        if key in claimed:
            continue
        owner_path, _, leaf = key.rpartition(".")
        owner = modules[owner_path]
        parts = owner_path.split(".") if owner_path else []
        host_path = None
        for k in range(len(parts), -1, -1):
            p = ".".join(parts[:k])
            if isinstance(modules[p], hosts):
                host_path = p
                break
        if host_path is None:
            # the model's top-level module the step calls (a worker
            # head's own module under 'workers', else the first level)
            k = 2 if parts[:1] == ["workers"] else 1
            host_path = ".".join(parts[:k])
        host = modules[host_path]
        _set_part(owner, leaf, spec, grid)
        if not hasattr(host, "tp_gathered"):
            host.tp_gathered = []
            host.tp_grid = grid
            host.register_forward_pre_hook(_swap_in)
            host.register_forward_hook(_swap_out)
        host.tp_gathered.append((owner, leaf, spec, leaf in owner._buffers))
        model.tp_routes[host_path] = "gathered"
    return model.tp_routes


# ---------------------------------------------------------------------------
# the state in the n_model = 1 layout
# ---------------------------------------------------------------------------


def leaf_specs(module):
    """{state-dict key of ``module``: Spec} of its leaves held as parts."""
    out = {}
    for path, m in module.named_modules():
        for name, spec in getattr(m, "tp_specs", {}).items():
            out[f"{path}.{name}" if path else name] = spec
    return out


def full_tensors(tensors, specs):
    """{key: tensor} with every tensor of ``specs`` gathered whole (a
    collective of the model group: every rank calls it)."""
    if not specs:
        return tensors
    grid = mesh.grid()
    return {k: (gather_parts(v.detach(), specs[k], grid) if k in specs
                else v) for k, v in tensors.items()}


def local_tensors(tensors, specs):
    """{key: tensor} with every whole tensor of ``specs`` cut to this
    rank's part."""
    if not specs:
        return tensors
    grid = mesh.grid()
    return {k: (own(torch.as_tensor(v), specs[k], grid.n_model,
                    grid.i_model).contiguous() if k in specs else v)
            for k, v in tensors.items()}


def full_state_dict(module):
    """``module.state_dict()`` in the n_model = 1 layout."""
    return full_tensors(module.state_dict(), leaf_specs(module))


def sharded_params(module):
    """The ids of ``module``'s parameters held as parts."""
    specs = leaf_specs(module)
    return {id(p) for k, p in module.named_parameters() if k in specs}


@torch.no_grad()
def sync_replicated_grads(module):
    """The gradients of the leaves every model rank holds whole, made the
    first model rank's bits (the ranks compute them alike; a card's
    algorithms may round them apart)."""
    grid = mesh.grid()
    if grid.n_model == 1:
        return
    parts = sharded_params(module)
    mesh.broadcast_([p.grad for p in module.parameters()
                     if id(p) not in parts and p.grad is not None],
                    grid.i_data * grid.n_model, grid.model_group)
