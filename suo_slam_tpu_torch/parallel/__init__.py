"""Data parallelism across cards: one process a card (`mesh.py`)."""

from .mesh import (  # noqa: F401
    Mesh,
    data_parallel_mesh,
    make_sharded_inference,
    pad_to_multiple,
    shard_batch,
)
