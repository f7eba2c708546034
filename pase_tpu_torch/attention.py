"""Per-worker channel selection: the attention and chunking variants.

The port of ``pase_tpu/attention.py``:

* ``AttentionBlock`` — an MLP scores the emb channels from a pooled view
  of the hidden, a running distribution is blended in, and the top-K
  channels form a hard 0/1 mask multiplied onto the hidden. The mask is
  not differentiated (the scoring MLP gets no gradient through it), as
  in the JAX package and the reference.
* ``make_chunk_masks`` — the chunking variant's fixed random masks, K
  channels per worker, drawn once with numpy (the JAX package's masks).

Layout: the hidden is [B, D, F] (the port's [B, C, T]); the JAX module's
is [B, F, D].
"""

import numpy as np
import torch
from torch import nn

from pase_tpu_torch.nn import flax_dense
from pase_tpu_torch.parallel.mesh import global_mean

ATT_MODES = ("concat", "avg_time", "avg_time_batch")


class AttentionBlock(nn.Module):
    """[B, D, F] -> (masked hidden [B, D, F], mask [B, D]).

    ``att_mode``: 'concat' flattens [B, F, D] in the JAX module's order
    (so its ``mlp_0`` kernel bridges), which needs ``frames``;
    'avg_time' takes the mean over time; 'avg_time_batch' also over the
    batch, and the one distribution is broadcast to the B rows. The MLP
    (``mlp_{i}``, relu; ``mlp_out``, a softmax over D) has flax's Dense
    init (lecun normal, zero bias) drawn from ``generator``, and runs in
    float32. The distribution is blended as running * avg_factor + dist
    * (1 - avg_factor); in train mode the buffer ``running_dist``
    (initially 1 / D) becomes the batch mean of the blend. The top-K
    channels are taken by a stable descending sort, so a tie at the K-th
    place keeps the lower index, as ``jax.lax.top_k`` does. Under a
    process group both batch means ('avg_time_batch''s pooled view and
    the running distribution's update) are the global batch's
    (``mesh.global_mean``), as in the JAX data-parallel step."""

    def __init__(self, emb_dim, K=40, avg_factor=0.0, att_mode="avg_time",
                 hidden=(256,), frames=None, generator=None):
        super().__init__()
        if att_mode not in ATT_MODES:
            raise ValueError(att_mode)
        if att_mode == "concat" and frames is None:
            raise ValueError("att_mode 'concat' needs the frame count")
        self.emb_dim = emb_dim
        self.K = K
        self.avg_factor = avg_factor
        self.att_mode = att_mode
        self.hidden = tuple(hidden)
        cin = emb_dim * frames if att_mode == "concat" else emb_dim
        for i, hd in enumerate(self.hidden):
            self.add_module(f"mlp_{i}", flax_dense(cin, hd, generator))
            cin = hd
        self.mlp_out = flax_dense(cin, emb_dim, generator)
        self.register_buffer("running_dist",
                             torch.full((emb_dim,), 1.0 / emb_dim))

    def forward(self, h):
        b, d, f = h.shape
        x = h.float()
        if self.att_mode == "concat":
            x = x.transpose(1, 2).reshape(b, f * d)
        elif self.att_mode == "avg_time":
            x = x.mean(dim=2)
        else:
            x = global_mean(x.mean(dim=2))
        for i in range(len(self.hidden)):
            x = torch.relu(getattr(self, f"mlp_{i}")(x))
        dist = torch.softmax(self.mlp_out(x), dim=-1)
        dist = (self.running_dist[None, :] * self.avg_factor
                + dist * (1.0 - self.avg_factor))
        if self.training:
            with torch.no_grad():
                self.running_dist.copy_(global_mean(dist)[0])
        dist = dist.detach().expand(b, d)
        idx = torch.sort(dist, dim=-1, descending=True,
                         stable=True).indices[:, :self.K]
        mask = torch.zeros_like(dist).scatter_(1, idx, 1.0)
        return h * mask[:, :, None], mask


def make_chunk_masks(worker_names, emb_dim, K):
    """{worker: [emb_dim] float32 0/1 mask with min(K, emb_dim) ones},
    drawn in worker order with ``np.random.RandomState(0)`` (the JAX
    trainer's seed)."""
    rng = np.random.RandomState(0)
    masks = {}
    for name in worker_names:
        sel = rng.choice(emb_dim, size=min(K, emb_dim), replace=False)
        m = np.zeros((emb_dim,), np.float32)
        m[sel] = 1.0
        masks[name] = torch.from_numpy(m)
    return masks
