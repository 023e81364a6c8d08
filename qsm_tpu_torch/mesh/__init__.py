"""The mesh: one lane axis under every check plane, split over devices.

The counterpart of the JAX package's ``qsm_tpu/mesh/``.  Plain batches,
per-key sub-lanes, shrink frontiers, monitor window re-checks, the server
and the drain all check through a backend whose lanes may span a mesh.
Construction and the placement contract in :mod:`.topology`; dispatch
policy (divisible bucket ladders, the one-call :func:`sharded_backend`) in
:mod:`.dispatch`; the lane blocks of one device batch, their launches and
their compaction across shards in :mod:`.shards`.

Sharding is only a placement change: verdicts, witnesses and carries are
bit-identical at every width (``tests/test_torch_mesh.py``,
``tests/test_torch_parallel.py``, ``tests/test_torch_distributed.py``).
``qsm_tpu_torch.parallel`` is a deprecated re-export of five of these
names.
"""

from .dispatch import (backend_sharding, mesh_bucket_ladder,
                       mesh_slots_table, sharded_backend)
from .topology import (LANE_AXIS, LaneSharding, Mesh, MeshDevice,
                       batch_sharding, card_shard_mesh,
                       gather_lanes, host_devices, init_distributed,
                       lane_devices, lane_sharding_of, local_devices,
                       make_mesh, make_mesh_2d, mesh_device_count,
                       mesh_from_devices, mesh_shape_key,
                       replicated_sharding)

__all__ = [
    "LANE_AXIS",
    "LaneSharding",
    "Mesh",
    "MeshDevice",
    "backend_sharding",
    "batch_sharding",
    "card_shard_mesh",
    "gather_lanes",
    "host_devices",
    "init_distributed",
    "lane_devices",
    "lane_sharding_of",
    "local_devices",
    "make_mesh",
    "make_mesh_2d",
    "mesh_bucket_ladder",
    "mesh_device_count",
    "mesh_from_devices",
    "mesh_shape_key",
    "mesh_slots_table",
    "replicated_sharding",
    "sharded_backend",
]
