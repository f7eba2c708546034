"""Multi-GPU: data parallelism across processes (``mesh.py``) and the
time-sharded encoder (``sp.py``)."""

from pase_tpu_torch.parallel.mesh import (host_batch_slice, init_distributed,
                                          replicate, shard_batch)

__all__ = ["init_distributed", "host_batch_slice", "replicate",
           "shard_batch"]
