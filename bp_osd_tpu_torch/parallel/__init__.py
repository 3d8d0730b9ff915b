"""Data-parallel scale-out: batch-sharded decoding over a device mesh and
multi-process runs over ``torch.distributed``.

Port of the data-parallel half of ``bp_osd_tpu/parallel``.
"""

from .distributed import host_batch_slice, initialize, is_multi_host
from .mesh import Mesh, cpu_mesh, make_mesh, pad_batch, sharded_decode_fn
from .shard_pallas import shard_batch_fn, shard_decode_fn

__all__ = [
    "Mesh",
    "make_mesh",
    "cpu_mesh",
    "pad_batch",
    "sharded_decode_fn",
    "shard_batch_fn",
    "shard_decode_fn",
    "initialize",
    "is_multi_host",
    "host_batch_slice",
]
