"""Worker for the port's two-process ``torch.distributed`` test
(tests/test_torch_distributed.py).

Spawned twice with a localhost address: ``init_distributed`` joins the
two processes over ``gloo``, each rank owns 4 logical host devices of one
2 x 4 (host, batch) mesh, runs the lane blocks of its own devices through
``build_kernel``'s ``check_one`` (the plain versions) and the verdict
gather at the end of the batch (``mesh.gather_lanes``) hands every rank
all the verdicts.  The histories come from the parent as rows in a JSON
file, so that this process imports the port alone.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

BUDGET = 500_000


def encode(rows_by_history):
    """The kernel's planes of the histories (all pending-free), bucketed
    as the reference's worker buckets them."""
    from qsm_tpu_torch.core.history import bucket_for, encode_batch
    from qsm_tpu_torch.models.cas import CasSpec
    from qsm_tpu_torch.utils.interop import history_from_rows

    spec = CasSpec()
    hs = [history_from_rows(r) for r in rows_by_history]
    n_ops = bucket_for(max(len(h) for h in hs))
    enc = encode_batch(hs, spec.initial_state(), max_ops=n_ops)
    planes = (enc.ops[:, :, 1], enc.ops[:, :, 2], enc.ops[:, :, 3],
              enc.valid, enc.precedes())
    return spec, n_ops, planes, np.asarray(enc.init_state, np.int32)


def main(argv) -> int:
    rank, nproc, port, rows_path, out_path = (int(argv[0]), int(argv[1]),
                                              argv[2], argv[3], argv[4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch.distributed as dist

    from qsm_tpu_torch.mesh import (batch_sharding, gather_lanes,
                                    init_distributed, lane_devices,
                                    lane_sharding_of, make_mesh_2d,
                                    mesh_device_count, mesh_shape_key)
    from qsm_tpu_torch.ops.stepper_kernel import build_kernel

    ok = init_distributed(f"127.0.0.1:{port}", num_processes=nproc,
                          process_id=rank, device="cpu", timeout_s=120.0)
    assert ok, "init_distributed returned False with an explicit address"
    try:
        assert dist.get_world_size() == nproc and dist.get_rank() == rank
        mesh = make_mesh_2d(2, 4, device="cpu")
        # the mesh spans both processes, not 8 devices of this one
        assert {d.process for d in mesh.devices.flat} == {0, 1}
        sharding = batch_sharding(mesh)
        assert mesh_device_count(mesh) == 8
        assert mesh_shape_key(sharding) == (8, "host", "batch")
        assert lane_sharding_of(sharding).spec[0] == ("host", "batch")
        with open(rows_path) as f:
            rows = json.load(f)
        spec, n_ops, planes, init = encode(rows)
        check = build_kernel(spec, n_ops, BUDGET, device="cpu")
        n = len(rows)
        per = n // mesh.size
        local = {}
        for i, d in enumerate(lane_devices(sharding)):
            if d.process == rank:   # this rank's blocks only
                block = slice(i * per, (i + 1) * per)
                status, _ = check(*(p[block] for p in planes), init)
                local[i] = status
        everything = gather_lanes(sharding, n, local)
        with open(out_path, "w") as f:
            json.dump({"rank": rank, "world": dist.get_world_size(),
                       "blocks": sorted(local),
                       "mesh_shape_key": list(mesh_shape_key(sharding)),
                       "status": [int(v) for v in everything]}, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
