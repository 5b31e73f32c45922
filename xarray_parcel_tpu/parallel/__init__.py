"""Mesh data-parallelism over grid columns (the cards of a host; the
reference's dask-chunk role) plus multi-host initialisation helpers."""

from .stream import stream_map
from .chunked import chunked, scan_map
from .mesh import (batch_spec, distributed_init, global_stats,
                   pad_batch,
                   make_mesh, replicate, replicated, shard_batch,
                   sharded_jit)

__all__ = ['batch_spec', 'chunked', 'distributed_init', 'global_stats',
           'make_mesh', 'pad_batch', 'replicate', 'replicated', 'scan_map',
           'shard_batch', 'sharded_jit', 'stream_map']
