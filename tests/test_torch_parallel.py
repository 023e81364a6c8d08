"""Lane sharding over logical host devices: twins of the seven cases of
``tests/test_parallel.py``.  The same stepper, sharded over an 8-wide
mesh, answers as the unsharded one and as the JAX package's sharded
``JaxTPU``; compactions move lanes across shards; the meshes have the
reference's shapes; ``init_distributed`` is a no-op unconfigured; and
``qsm_tpu_torch.parallel`` is a deprecation re-export of
``qsm_tpu_torch.mesh``."""

from __future__ import annotations

import numpy as np
import pytest

from qsm_tpu import generate_program as j_generate_program
from qsm_tpu import run_concurrent as j_run_concurrent
from qsm_tpu.mesh import batch_sharding as j_batch_sharding
from qsm_tpu.mesh import make_mesh as j_make_mesh
from qsm_tpu.models import AtomicCasSUT, CasSpec as JCas, RacyCasSUT
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu_torch.mesh import batch_sharding, make_mesh
from qsm_tpu_torch.models.cas import CasSpec
from qsm_tpu_torch.ops import stepper as stepper_module
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.serve.protocol import history_to_rows
from qsm_tpu_torch.utils.interop import history_from_rows


def _corpus(n):
    """The reference's corpus: 4 pids x 16 ops, atomic and racy CAS in
    turn, in both packages."""
    jspec = JCas()
    jh = []
    for seed in range(n):
        prog = j_generate_program(jspec, seed=seed, n_pids=4, max_ops=16)
        sut = (AtomicCasSUT if seed % 2 == 0 else RacyCasSUT)(jspec)
        jh.append(j_run_concurrent(sut, prog, seed=f"m{seed}"))
    return jspec, jh, CasSpec(), [history_from_rows(history_to_rows(h))
                                  for h in jh]


def _sharded(spec, n=8, **kw):
    return TorchStepper(spec, sharding=batch_sharding(
        make_mesh(n, device="cpu")), **kw)


def test_sharded_backend_matches_unsharded():
    jspec, jh, spec, hs = _corpus(32)
    a = TorchStepper(spec, device="cpu").check_histories(spec, hs)
    b = _sharded(spec).check_histories(spec, hs)
    assert (a == b).all(), list(zip(a.tolist(), b.tolist()))
    want = JaxTPU(jspec, sharding=j_batch_sharding(j_make_mesh(8))
                  ).check_histories(jspec, jh)
    assert (b == np.asarray(want)).all()


def test_sharded_compaction_parity():
    """Compaction under a mesh: a corpus that retires lanes across
    buckets compacts mid-run, the survivors renumbered into the smaller
    bucket move across shards, and the verdicts stay the unsharded
    driver's and the JAX package's sharded ``JaxTPU``'s (the reference's
    class ladder, chunks (16, 64))."""
    jspec, jh, spec, hs = _corpus(80)
    j = JaxTPU(jspec, sharding=j_batch_sharding(j_make_mesh(8)))
    j.CHUNK_SCHEDULE = (16, 64)
    want = np.asarray(j.check_histories(jspec, jh))
    plan = dict(chunk_schedule=(16, 64), batch_buckets=j.BATCH_BUCKETS,
                slots_for_batch={b: j._slots_for(b)
                                 for b in j.BATCH_BUCKETS})
    sharded = _sharded(spec, **plan)
    b = sharded.check_histories(spec, hs)
    assert sharded.compactions > 0, "corpus must exercise compaction"
    assert sharded.lanes_crossed > 0, "no lane changed shard"
    plain = TorchStepper(spec, device="cpu", **plan)
    a = plain.check_histories(spec, hs)
    assert (a == b).all()
    assert (b == want).all()
    assert sharded.compactions == plain.compactions == j.compactions
    assert np.array_equal(sharded.last_iters, plain.last_iters)


def test_sharded_inputs_actually_span_devices(monkeypatch):
    """A bucket of 64 lanes spans all 8 shards: the first round launches
    one ``stepper_chunk`` a shard, each on 8 lanes of its own carry."""
    _, _, spec, hs = _corpus(64)
    seen = []
    real = stepper_module.stepper_chunk

    def spy(tables, carry, **kw):
        seen.append((id(carry), carry.row.shape[0]))
        return real(tables, carry, **kw)

    monkeypatch.setattr(stepper_module, "stepper_chunk", spy)
    t = _sharded(spec, chunk_schedule=(4096,), batch_buckets=(64,),
                 slots_for_batch={64: 64})
    t.check_histories(spec, hs)
    first = seen[:8]
    assert [w for _, w in first] == [8] * 8
    assert len({c for c, _ in first}) == 8


def test_make_mesh_subset():
    mesh = make_mesh(4, device="cpu")
    assert mesh.devices.shape == (4,)
    assert mesh.axis_names == ("batch",)


def test_make_mesh_2d_and_hierarchical_batch_sharding():
    from qsm_tpu_torch.mesh import lane_devices, make_mesh_2d
    from qsm_tpu_torch.mesh.shards import LaneShards

    mesh = make_mesh_2d(2, 4, device="cpu")
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("host", "batch")
    sharding = batch_sharding(mesh)  # dim 0 over BOTH axes
    assert len(sharding.device_set) == 8
    assert lane_devices(sharding) == list(mesh.devices.flat)
    # each device holds a 64/8 block of the batch
    assert LaneShards(sharding).width(64) == 8
    _, _, spec, hs = _corpus(16)
    assert (TorchStepper(spec, sharding=sharding).check_histories(spec, hs)
            == TorchStepper(spec, device="cpu").check_histories(spec, hs)
            ).all()


def test_init_distributed_noop_without_coordinator(monkeypatch):
    from qsm_tpu_torch.mesh import init_distributed

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert init_distributed() is False  # single-host: no-op by design


def test_cpu_mesh_of_unstated_width_is_one_host_device():
    """A CPU mesh of unstated width is one logical host device: a wider
    one is asked for by its width."""
    from qsm_tpu_torch.mesh import mesh_device_count

    assert make_mesh(device="cpu").size == 1
    assert mesh_device_count(device="cpu") == 1
    assert make_mesh(6, device="cpu").size == 6


def test_parallel_package_is_a_deprecation_reexport():
    """``qsm_tpu_torch.parallel`` is only a thin re-export of
    ``qsm_tpu_torch.mesh``: the same objects, a docstring that says it is
    deprecated, and no ``parallel.mesh`` module."""
    import qsm_tpu_torch.mesh as mesh
    import qsm_tpu_torch.parallel as parallel

    for name in ("batch_sharding", "init_distributed", "make_mesh",
                 "make_mesh_2d", "replicated_sharding"):
        assert getattr(parallel, name) is getattr(mesh, name), name
    assert sorted(parallel.__all__) == sorted(
        __import__("qsm_tpu.parallel", fromlist=["x"]).__all__)
    assert "DEPRECATED" in (parallel.__doc__ or "")
    with pytest.raises(ImportError):
        import qsm_tpu_torch.parallel.mesh  # noqa: F401
