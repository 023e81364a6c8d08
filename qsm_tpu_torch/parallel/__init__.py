"""DEPRECATED: the mesh helpers live in :mod:`qsm_tpu_torch.mesh`.

The counterpart of the JAX package's ``qsm_tpu/parallel/``, which it keeps
as a thin re-export after its mesh helpers moved to ``mesh/``.  These are
the same objects as ``qsm_tpu_torch.mesh``'s, and no mesh logic lives
here; new code imports from ``qsm_tpu_torch.mesh``.  The contract is
``mesh``'s: sharding is only a placement change, and verdicts, witnesses
and carries are bit-identical at every width
(``tests/test_torch_parallel.py`` pins this package as a re-export).
"""

from ..mesh.topology import (batch_sharding, init_distributed, make_mesh,
                             make_mesh_2d, replicated_sharding)

__all__ = [
    "batch_sharding",
    "init_distributed",
    "make_mesh",
    "make_mesh_2d",
    "replicated_sharding",
]
