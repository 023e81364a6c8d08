"""Mesh-sharded dispatch: divisible bucket ladders and the one-call backend.

The counterpart of the JAX package's ``qsm_tpu/mesh/dispatch.py``.  The
chunked device loop (``ops/stepper.py::TorchStepper``) pads every batch
into a bucket ladder, and each bucket has a memo size.  Under a mesh every
bucket must divide by the device count, so that each device holds an
equal block of lanes, and a plan's identity carries the mesh's width
(``@meshN``, :func:`~qsm_tpu_torch.mesh.topology.mesh_shape_key`), so that
a ladder filtered for 8 devices never serves 1.  This module owns both
policies:

* :func:`mesh_bucket_ladder` / :func:`mesh_slots_table` restrict a plan's
  bucket ladder, and its memo slots a bucket, to mesh-divisible widths;
* :func:`sharded_backend` is the one constructor every consumer takes:
  plain check batches, per-key sub-lanes, shrink frontiers, monitor window
  re-checks, the server and the drain all check through the backend it
  returns (a planned checker whose ``sharding`` spans the mesh).

**Soundness contract.**  Sharding is only a placement change: verdicts,
witnesses and carries are bit-identical at every width
(``tests/test_torch_mesh.py`` holds widths 8 and 1 of register, CAS,
queue and kv per key equal, and each lane's iterations and ``chosen``
equal to the JAX package's sharded checker on the same plan;
``tests/test_torch_parallel.py`` holds compactions that move lanes across
shards).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from .topology import (batch_sharding, lane_devices, make_mesh,
                       mesh_device_count)


def mesh_bucket_ladder(buckets: Sequence[int],
                       n_devices: int) -> Tuple[int, ...]:
    """Restrict a batch-bucket ladder to widths divisible by the mesh.

    Keeps the ladder's order and guarantees a non-empty result: when no
    bucket divides, the ladder is ``(n_devices,)``, one lane a device, the
    narrowest batch a mesh holds evenly.  ``n_devices <= 1`` is the
    identity."""
    n = max(1, int(n_devices))
    if n == 1:
        return tuple(buckets)
    kept = tuple(b for b in buckets if b % n == 0)
    return kept or (n,)


def mesh_slots_table(slots_for_batch: Dict[int, int],
                     buckets: Sequence[int]) -> Dict[int, int]:
    """Memo slots a lane for a (possibly filtered) ladder: known buckets
    keep theirs, a new one (the ``(n_devices,)`` case) gets 32, the JAX
    package's default for a bucket its table lacks."""
    return {b: slots_for_batch.get(b, 32) for b in buckets}


def sharded_backend(spec, *, devices: Optional[int] = None, mesh=None,
                    budget: int = 2_000, profile=None, plan=None,
                    device=None, **device_kw):
    """The planned checker whose lane axis spans a mesh.

    Builds (or takes) the mesh, plans with mesh-divisible buckets
    (``plan_search(mesh_devices=...)``: the CUDA plan on cards, the CPU
    plan on logical host devices) and hands the lane sharding to
    ``search.planner.build_backend``, so that the per-key split, the
    quiescent-cut segmentation and the ordering compose with sharding.

    ``devices=None`` with ``mesh=None`` spans every CUDA card, or with
    ``device="cpu"`` one logical host device; ``devices=1`` is a plain
    one-device checker.  ``device_kw`` goes to the engine as
    ``build_backend`` passes it.  The mesh is ``backend_sharding(backend).mesh``."""
    from ..search.planner import build_backend, plan_search

    if mesh is None:
        mesh = make_mesh(devices, device=device)
    n = mesh_device_count(mesh)
    first = lane_devices(batch_sharding(mesh))[0]
    platform = "cpu" if first.device.type == "cpu" else "cuda"
    if plan is None:
        plan = plan_search(spec, profile=profile, platform=platform,
                           mesh_devices=n)
    sharding = batch_sharding(mesh) if n > 1 else None
    return build_backend(spec, plan, budget=budget, sharding=sharding,
                         device=first.device, **device_kw)


def backend_sharding(backend):
    """The lane sharding a (possibly wrapped) backend dispatches under, or
    None.  Unwraps the per-key and segmentation combinators through their
    ``inner``: the innermost engine owns placement."""
    seen = set()
    while backend is not None and id(backend) not in seen:
        seen.add(id(backend))
        sh = getattr(backend, "sharding", None)
        if sh is not None:
            return sh
        backend = getattr(backend, "inner", None)
    return None
