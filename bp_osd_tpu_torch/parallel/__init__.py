"""Scale-out: batch-sharded decoding over a device mesh, model-sharded BP
over a ``data x model`` mesh (``edge_shard``, ``lifted_shard``,
``large_code``) and multi-process runs over ``torch.distributed``.

Port of ``bp_osd_tpu/parallel``.
"""

from .distributed import host_batch_slice, initialize, is_multi_host
from .edge_shard import ShardedTannerGraph, edge_sharded_bp_fn
from .mesh import (Mesh, Mesh2D, cpu_mesh, cpu_mesh_2d, make_mesh, make_mesh_2d, pad_batch,
                   sharded_decode_fn)
from .shard_pallas import shard_batch_fn, shard_decode_fn

__all__ = [
    "Mesh",
    "Mesh2D",
    "make_mesh",
    "make_mesh_2d",
    "cpu_mesh",
    "cpu_mesh_2d",
    "pad_batch",
    "sharded_decode_fn",
    "shard_batch_fn",
    "shard_decode_fn",
    "ShardedTannerGraph",
    "edge_sharded_bp_fn",
    "initialize",
    "is_multi_host",
    "host_batch_slice",
]
