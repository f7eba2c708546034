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
  is an all-gather made of one all-reduce of a zero-padded buffer;
* ``replicate`` broadcasts a module's parameters and buffers from rank 0;
* ``global_mean`` is a batch mean over the global batch (the attention
  variant's channel statistics).

With no process group (or one rank) every helper is the identity and the
port takes exactly its single-process path. ``--n_model`` (the JAX
package's column-parallel 'model' axis: ``get_mesh``, ``state_shardings``,
``shard_state``) is not ported: ROADMAP.md, queue 1, item 10b.
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


def host_batch_slice(global_batch, process_index=None, process_count=None):
    """The contiguous rows of the global batch a process loads; the global
    batch must divide evenly."""
    process_index = rank() if process_index is None else process_index
    process_count = world() if process_count is None else process_count
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


@torch.no_grad()
def all_reduce_(tensors, op="sum"):
    """Sum (or with op='mean' average) each tensor of a list over the
    ranks, in place: the tensors are flattened into buckets of at most
    BUCKET_ELEMS elements of one dtype, one all_reduce a bucket. Every
    rank receives the same bits."""
    if world() < 2:
        return tensors
    for bucket in _buckets([t for t in tensors if t is not None]):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        if op == "mean":
            flat /= world()
        for t, v in zip(bucket, torch.split(flat, [t.numel()
                                                   for t in bucket])):
            t.copy_(v.view_as(t))
    return tensors


def all_reduce_dict(values, op="mean"):
    """{k: scalar tensor} -> the same keys, each summed or averaged over
    the ranks (one all_reduce for all)."""
    if world() < 2 or not values:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().float().reshape(())
                        for k in keys])
    all_reduce_([flat], op)
    return dict(zip(keys, flat.unbind()))


@torch.no_grad()
def gather(t):
    """[world, *t.shape]: every rank's t, by one all_reduce of a buffer
    that is zero but for this rank's slot (exact: x + 0 = x)."""
    out = t.new_zeros((world(),) + tuple(t.shape))
    out[rank()] = t
    if world() > 1:
        dist.all_reduce(out)
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
    ``row_shard`` of a process group, the rows are this rank's part of the
    global batch and the mean is the global batch's: one all_reduce of
    the ranks' row sums and row counts (float32), the same bits on every
    rank. Elsewhere ``x.mean(0, keepdim=True)``. Not differentiated: its
    callers take statistics that no gradient flows through."""
    if _ROWS.get() is None or world() < 2:
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
