"""Multi-GPU: data parallelism across processes and the n_data x n_model
grid (``mesh.py``), column-parallel compute over the model group
(``tp.py``) and the time-sharded encoder (``sp.py``)."""

from pase_tpu_torch.parallel.mesh import (host_batch_slice, init_distributed,
                                          replicate, shard_batch)

__all__ = ["init_distributed", "host_batch_slice", "replicate",
           "shard_batch"]
