"""Process groups, batch slices and collectives of the port's data
parallelism (the multi-process part of ``pase_tpu/parallel/mesh.py``).

The JAX package runs one controller over every local device, and a
jitted step on a batch-sharded array computes the global step: GSPMD puts
the gradient all-reduce and every batch statistic's reduction inside the
program. The port runs as torch does: one process per card, each with its
own device and an explicit rank in a ``torch.distributed`` process group
(NCCL for CUDA tensors, gloo for CPU tensors; gloo also serves two ranks
that share one card, which NCCL refuses). The global step is then made
explicit:

* ``host_batch_slice`` is the rows of the global batch a rank loads;
* ``row_shard`` / ``draw_rows``: a step's random draws are made for the
  global batch from the shared seed and the rank keeps its own rows, so
  row i gets draw i whatever the number of processes;
* the collectives use ``all_reduce`` and ``broadcast`` only (gloo has no
  other collective on CUDA tensors): ``all_reduce_`` sums or averages a
  list of tensors through flat buckets (one call a bucket), ``gather``
  is an all-gather made of one all-reduce of a zero-padded buffer (a
  few scalars), ``all_gather`` one of a broadcast from each rank (the
  column shards of ``parallel/tp.py``);
* ``replicate`` broadcasts a module's parameters and buffers from rank 0;
* ``global_mean`` is a batch mean over the global batch (the attention
  variant's channel statistics).

With no process group (or one rank) every helper is the identity and the
port takes exactly its single-process path.

``--n_model`` (the JAX package's ('data', 'model') mesh: ``get_mesh``,
``state_shardings``) makes the processes a grid of n_data x n_model:
``set_grid`` gives rank r the place (i_data, i_model) = divmod(r,
n_model), ``get_mesh``'s ``reshape(n_data, n_model)`` order, and two
process groups: the **model group** (the ranks that share i_data: they
load the same rows and hold the parameters' column shards,
``parallel/tp.py``) and the **data group** (the ranks that share i_model:
they hold the same shards of different rows). The batch helpers and the
collectives above work over the data group (``data_group``; the world
when n_model is 1, so that path is bit for bit the data-parallel one):
``host_batch_slice`` and ``draw_rows`` key on (i_data, n_data).
``shard_rule`` is the port's copy of ``state_shardings``'s test, applied
to a leaf's shape in the JAX layout.
"""

import contextlib
import contextvars
import datetime
from typing import NamedTuple

import torch
import torch.distributed as dist

# a collective that waits longer than this fails its rank (and the run)
# instead of stalling the card
TIMEOUT_S = 300
# elements per bucket of ``all_reduce_``
BUCKET_ELEMS = 1 << 23


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device="cuda", backend=None,
                     timeout_s=TIMEOUT_S):
    """Join the process group of a multi-process run; returns False (and
    does nothing) with no coordinator and at most one process, as the JAX
    package's ``init_distributed``. The backend is NCCL for a CUDA
    ``device`` and gloo for the CPU unless ``backend`` names one (two
    ranks on one card take gloo). A CUDA rank's card is
    ``rank_device(device)``, made the current device here."""
    if num_processes in (None, 0, 1) and coordinator_address is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs --coordinator_address, "
                         "--num_processes and --process_id")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(rank_device(device, process_id))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank_device(device, process_id=None):
    """The device of a rank (this process's by default): a CUDA device
    without an index becomes cuda:(rank % device_count); any other device
    is returned as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    r = rank() if process_id is None else int(process_id)
    return torch.device("cuda", r % torch.cuda.device_count())


def world():
    """The number of processes of the group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank():
    """This process's rank (0 without a group)."""
    return dist.get_rank() if world() > 1 else 0


class Grid(NamedTuple):
    """The n_data x n_model process grid and this rank's place in it;
    ``data_group`` / ``model_group`` are None where the group is the
    world (n_model 1) or this rank alone (n_model 1 / n_data 1)."""
    n_data: int
    n_model: int
    i_data: int
    i_model: int
    data_group: object
    model_group: object


# the grid of set_grid and the process group it was made in
_GRID = None
_GRID_WORLD = None


def shard_rule(jax_shape, n_model, min_lanes=64):
    """True where the JAX package's ``state_shardings`` shards a leaf of
    ``jax_shape`` (its shape in the JAX layout) over a 'model' axis of
    ``n_model``: the trailing (output-channel / lane) axis of at least
    ``min_lanes`` that ``n_model`` divides."""
    shape = tuple(jax_shape)
    return (n_model > 1 and len(shape) >= 1 and shape[-1] % n_model == 0
            and shape[-1] >= min_lanes)


def grid_shape(processes, n_model):
    """(n_data, n_model) of ``processes`` processes; ValueError unless
    n_model divides them (one process a card, so --n_model 2 needs at
    least two)."""
    n_model = int(n_model or 1)
    processes = int(processes or 1)
    if n_model < 1 or processes % n_model:
        raise ValueError(
            f"--n_model {n_model} must divide the number of processes "
            f"({processes}): the grid is n_data x n_model processes, one "
            "per card")
    return processes // n_model, n_model


def set_grid(n_model=1):
    """Lay the processes out as an n_data x n_model grid (``grid_shape``)
    and make its groups; every rank calls it with the same n_model (each
    rank makes every group, in one order, as torch.distributed requires).
    Returns the ``Grid``; a second call with the same n_model returns the
    first's."""
    global _GRID, _GRID_WORLD
    n_data, n_model = grid_shape(world(), n_model)
    g = grid()
    if (g.n_data, g.n_model) == (n_data, n_model):
        return g
    i_data, i_model = divmod(rank(), n_model)
    data_group = model_group = None
    if n_model > 1:
        for d in range(n_data):
            group = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == i_data:
                model_group = group
        for m in range(n_model):
            group = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == i_model and n_data > 1:
                data_group = group
    _GRID = Grid(n_data, n_model, i_data, i_model, data_group, model_group)
    _GRID_WORLD = dist.group.WORLD
    return _GRID


def grid():
    """The grid of ``set_grid`` in the current process group; without
    one, every process a data rank (n_model 1)."""
    if _GRID is not None and world() > 1 and dist.group.WORLD is _GRID_WORLD:
        return _GRID
    return Grid(world(), 1, rank(), 0, None, None)


def data_world():
    """The number of data ranks (the world when n_model is 1)."""
    return grid().n_data


def data_rank():
    return grid().i_data


def data_group():
    """The data group (None: the world, or this rank alone with n_data
    1: ``group_size`` tells them apart)."""
    return grid().data_group


def group_size(group=None):
    """The ranks of ``group``; None is the data group."""
    if group is None:
        return data_world()
    return dist.get_world_size(group)


def host_batch_slice(global_batch, process_index=None, process_count=None):
    """The contiguous rows of the global batch a process loads: its data
    index's rows over the data ranks (every rank of a model group loads
    the same rows); the global batch must divide evenly."""
    process_index = data_rank() if process_index is None else process_index
    process_count = (data_world() if process_count is None
                     else process_count)
    if global_batch % process_count != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{process_count} processes")
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


def shard_batch(batch, device):
    """A rank's rows of the global batch (host arrays or tensors) on its
    device."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


@torch.no_grad()
def replicate(module, src=0):
    """Broadcast a module's parameters and buffers from rank ``src``, so
    every rank starts from the same state."""
    if world() < 2:
        return module
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)
    return module


def _buckets(tensors):
    bucket, n = [], 0
    for t in tensors:
        if bucket and (n + t.numel() > BUCKET_ELEMS
                       or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, n = [], 0
        bucket.append(t)
        n += t.numel()
    if bucket:
        yield bucket


def _torch_group(group):
    """The torch.distributed group of ``group`` (None: the data group)."""
    return data_group() if group is None else group


@torch.no_grad()
def all_reduce_(tensors, op="sum", group=None):
    """Sum (or with op='mean' average) each tensor of a list over the
    ranks of ``group`` (default: the data group), in place: the tensors
    are flattened into buckets of at most BUCKET_ELEMS elements of one
    dtype, one all_reduce a bucket. Every rank receives the same bits."""
    n = group_size(group)
    if n < 2:
        return tensors
    for bucket in _buckets([t for t in tensors if t is not None]):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=_torch_group(group))
        if op == "mean":
            flat /= n
        for t, v in zip(bucket, torch.split(flat, [t.numel()
                                                   for t in bucket])):
            t.copy_(v.view_as(t))
    return tensors


@torch.no_grad()
def broadcast_(tensors, src, group):
    """Overwrite each tensor of a list with rank ``src``'s (a global rank
    of ``group``), through flat buckets as ``all_reduce_``."""
    if group_size(group) < 2:
        return tensors
    for bucket in _buckets([t for t in tensors if t is not None]):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.broadcast(flat, src, group=group)
        for t, v in zip(bucket, torch.split(flat, [t.numel()
                                                   for t in bucket])):
            t.copy_(v.view_as(t))
    return tensors


def all_reduce_dict(values, op="mean", group=None):
    """{k: scalar tensor} -> the same keys, each summed or averaged over
    the ranks of ``group`` (default: the data group; one all_reduce for
    all)."""
    if group_size(group) < 2 or not values:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().float().reshape(())
                        for k in keys])
    all_reduce_([flat], op, group)
    return dict(zip(keys, flat.unbind()))


@torch.no_grad()
def all_gather(t, group):
    """[every rank of ``group``'s t, in group order]: one broadcast from
    each rank of t's bytes (exact for any dtype; t's size once per rank on
    the wire, where ``gather``'s all_reduce moves the whole buffer)."""
    n = group_size(group)
    if n < 2:
        return [t]
    t = t.contiguous()
    me = dist.get_rank(group)
    parts = [t if m == me else torch.empty_like(t) for m in range(n)]
    for m, part in enumerate(parts):
        dist.broadcast(part.view(-1).view(torch.uint8),
                       dist.get_global_rank(group, m), group=group)
    return parts


@torch.no_grad()
def gather(t, group=None):
    """[ranks of ``group``, *t.shape]: every rank's t (default: over the
    data group), by one all_reduce of a buffer that is zero but for this
    rank's slot (exact: x + 0 = x)."""
    n = group_size(group)
    out = t.new_zeros((n,) + tuple(t.shape))
    out[0 if n < 2 else dist.get_rank(_torch_group(group))] = t
    if n > 1:
        dist.all_reduce(out, group=_torch_group(group))
    return out


class RowShard(NamedTuple):
    """This rank's rows [start, stop) of a global batch of ``total``."""
    start: int
    stop: int
    total: int


# the RowShard of the running step (context-local: a thread started
# elsewhere, as a batcher's, sees None)
_ROWS = contextvars.ContextVar("pase_tpu_torch_rows", default=None)


@contextlib.contextmanager
def row_shard(rows):
    """Within the block, ``draw_rows`` draws for the global batch and keeps
    ``rows`` (a ``RowShard``; None: no sharding)."""
    token = _ROWS.set(rows)
    try:
        yield rows
    finally:
        _ROWS.reset(token)


def _narrow(x, dim, rows, k):
    if x is None:
        return None
    if isinstance(x, tuple):            # a NamedTuple of draws
        return type(x)(*(_narrow(v, dim, rows, k) for v in x))
    b = rows.stop - rows.start
    parts = [x.narrow(dim, s * rows.total + rows.start, b)
             for s in range(k)]
    return (parts[0] if k == 1 else torch.cat(parts, dim)).contiguous()


@torch.no_grad()
def global_mean(x):
    """[1, ...]: the mean of x over its rows (axis 0). Under a
    ``row_shard`` of more than one data rank, the rows are this rank's
    part of the global batch and the mean is the global batch's: one
    all_reduce over the data group of the ranks' row sums and row counts
    (float32), the same bits on every rank. Elsewhere ``x.mean(0,
    keepdim=True)``. Not differentiated: its callers take statistics that
    no gradient flows through."""
    if _ROWS.get() is None or data_world() < 2:
        return x.mean(dim=0, keepdim=True)
    flat = torch.cat([x.float().sum(dim=0).reshape(-1),
                      x.new_full((1,), float(x.shape[0]), dtype=torch.float32)])
    all_reduce_([flat])
    return (flat[:-1] / flat[-1]).view((1,) + tuple(x.shape[1:])).to(x.dtype)


def draw_rows(draw, n, dim=0):
    """``draw(m)`` makes a random draw whose axis ``dim`` has m rows (a
    tensor, or a NamedTuple of tensors). Outside a ``row_shard`` it is
    ``draw(n)``. Inside one, n is k times the rank's rows (k streams of
    the batch side by side, as the encoder's {chunk, ctxt, rand}): the
    draw is made for k times the global batch and each stream's block of
    this rank's rows is kept, so the generator advances as in one process
    and row i of the global batch gets the same numbers."""
    rows = _ROWS.get()
    if rows is None:
        return draw(n)
    b = rows.stop - rows.start
    if n % b:
        raise ValueError(f"a draw of {n} rows is not a whole number of "
                         f"this rank's {b} rows")
    k = n // b
    return _narrow(draw(k * rows.total), dim, rows, k)
