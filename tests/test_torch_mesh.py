"""The port's mesh (``qsm_tpu_torch/mesh/``) against the JAX package's:
twins of every case of ``tests/test_mesh.py``.

* The parity lane (``tests/test_mesh.py:47``): the families of
  ``tests/_mesh_worker.py`` (register 16 x 6 x 12, CAS 16 x 6 x 14, queue
  12 x 6 x 12, kv 8 x 8 x 20 split per key through ``PComp``) decided at
  mesh widths 8 and 1 on logical host devices, in this process: verdicts,
  witnesses and minimised shrink rows equal across widths, every
  LINEARIZABLE witness replayed through both packages' ``verify_witness``,
  verdicts equal to the JAX package's ``sharded_backend`` on
  ``make_mesh(8)`` (tests/conftest.py pins 8 XLA CPU devices), and each
  lane's iterations and ``chosen`` equal to the JAX package's sharded
  ``JaxTPU`` on the same plan.
* In-process pins on the mesh's own contracts: mesh-divisible plans and
  ``@meshN`` names, the plan's own sharding in ``build_backend``, the
  stepper's mesh key and ladders, the batcher's flush width, the server's
  exclusive fan-outs and its stats, the topology's identities, the
  monitor's window re-check through a sharded checker, and the drain's
  mesh from its window's devices.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from qsm_tpu.mesh import batch_sharding as j_batch_sharding
from qsm_tpu.mesh import make_mesh as j_make_mesh
from qsm_tpu.mesh import sharded_backend as j_sharded_backend
from qsm_tpu.models.registry import MODELS as JMODELS
from qsm_tpu.ops.backend import verify_witness as j_verify_witness
from qsm_tpu.ops.jax_kernel import JaxTPU
from qsm_tpu.ops.pcomp import split_history as j_split_history
from qsm_tpu.search.planner import plan_search as j_plan_search
from qsm_tpu.search.planner import profile_corpus as j_profile_corpus
from qsm_tpu.utils.corpus import build_corpus as j_build_corpus
from qsm_tpu_torch.mesh import (backend_sharding, batch_sharding,
                                host_devices, lane_sharding_of, make_mesh,
                                make_mesh_2d, mesh_device_count,
                                mesh_from_devices, mesh_shape_key,
                                sharded_backend)
from qsm_tpu_torch.models.registry import MODELS
from qsm_tpu_torch.ops.backend import (BackendUnavailable, Verdict,
                                       verify_witness)
from qsm_tpu_torch.ops.stepper import TorchStepper
from qsm_tpu_torch.search.planner import plan_search, profile_corpus
from qsm_tpu_torch.serve.protocol import history_to_rows
from qsm_tpu_torch.shrink import shrink_history
from qsm_tpu_torch.utils.interop import history_from_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/_mesh_worker.py's corpus: (family, lanes, n_pids, max_ops, seed)
FAMILY_SHAPES = (("register", 16, 6, 12, 11), ("cas", 16, 6, 14, 2026),
                 ("queue", 12, 6, 12, 2026), ("kv", 8, 8, 20, 11))
FAMILIES = [f[0] for f in FAMILY_SHAPES]
WITNESS_LANES = 4
BUDGET = 200_000


def _port(hs):
    return [history_from_rows(history_to_rows(h)) for h in hs]


def _corpus(fam):
    """The worker's seed-derived corpus: the JAX package's histories and
    the same histories in the port."""
    _, lanes, n_pids, max_ops, seed = next(f for f in FAMILY_SHAPES
                                           if f[0] == fam)
    entry = JMODELS[fam]
    jspec = entry.make_spec()
    jh = j_build_corpus(jspec, (entry.impls["atomic"], entry.impls["racy"]),
                        n=lanes, n_pids=n_pids, max_ops=max_ops,
                        seed_base=seed, seed_prefix=f"mesh_{fam}")
    return jspec, jh, MODELS[fam].make_spec(), _port(jh)


@pytest.fixture(scope="module")
def widths():
    """Every family decided at widths 8 and 1: the report the reference's
    worker writes, for each width."""
    out = {}
    for n in (8, 1):
        rep = {"families": {}, "witness_failures": 0, "backends": {}}
        sharding = batch_sharding(make_mesh(n, device="cpu")) \
            if n > 1 else None
        for fam in FAMILIES:
            jspec, jh, spec, hs = _corpus(fam)
            profile = profile_corpus(hs, spec)
            backend = sharded_backend(spec, devices=n, device="cpu",
                                      budget=BUDGET, profile=profile)
            plan = plan_search(spec, profile, platform="cpu",
                               mesh_devices=n)
            kern = TorchStepper(spec, budget=BUDGET, sharding=sharding,
                                device="cpu")
            rows, replays = [], []
            for jhist, h in zip(jh[:WITNESS_LANES], hs[:WITNESS_LANES]):
                v, w = kern.check_witness(spec, h)
                rows.append([int(v), None if w is None else
                             [[int(a), int(b)] for a, b in w]])
                if w is not None:
                    replays.append((verify_witness(spec, h, w),
                                    j_verify_witness(jspec, jhist, w)))
            rep["witness_failures"] += sum(not (a and b)
                                           for a, b in replays)
            rep["backends"][fam] = (spec, hs, backend)
            rep["families"][fam] = {
                "plan": plan.name, "pcomp": bool(plan.decompose_keys),
                "mesh_shape_key": list(mesh_shape_key(
                    backend_sharding(backend))),
                "verdicts": [int(v) for v in
                             backend.check_histories(spec, hs)],
                "witnesses": rows, "replays": len(replays)}
        out[n] = rep
    return out


# ---------------------------------------------------------------------------
# the parity lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", FAMILIES)
def test_forced_device_count_parity_8_vs_1(widths, fam):
    """Twin of ``tests/test_mesh.py:47``, a family at a time: the same
    corpus through the same planned, sharded checker at widths 8 and 1
    answers the same verdicts and witnesses; every LINEARIZABLE witness
    replays in both packages."""
    r8, r1 = (widths[8]["families"][fam], widths[1]["families"][fam])
    assert r8["verdicts"] == r1["verdicts"], fam
    assert r8["witnesses"] == r1["witnesses"], fam
    # the corpus must exercise both verdicts or parity is vacuous
    assert len(set(r8["verdicts"])) >= 2, (fam, r8["verdicts"])
    assert r8["plan"].endswith("@mesh8"), r8["plan"]
    assert "@mesh" not in r1["plan"], r1["plan"]
    assert r8["mesh_shape_key"] == [8, "batch"]
    assert r1["mesh_shape_key"] == [1]
    assert r8["replays"] > 0
    # the per-key plane rode the mesh: kv decomposed, plain cas did not
    assert r8["pcomp"] is (fam == "kv")
    assert widths[8]["witness_failures"] == 0
    assert widths[1]["witness_failures"] == 0


def test_forced_device_count_parity_shrink_rows(widths):
    """The parity lane's shrink plane: the first failing CAS history
    minimised on the mesh-planned checker gives the same 1-minimal rows
    at widths 8 and 1."""
    rows = {}
    for n in (8, 1):
        spec, hs, backend = widths[n]["backends"]["cas"]
        verdicts = widths[n]["families"]["cas"]["verdicts"]
        failing = [i for i, v in enumerate(verdicts)
                   if v == int(Verdict.VIOLATION)]
        assert failing, "the corpus lost its failing cas lanes"
        res = shrink_history(spec, hs[failing[0]], backend=backend,
                             certificate=False)
        assert res.ok
        rows[n] = history_to_rows(res.history)
    assert rows[8] == rows[1]


@pytest.mark.parametrize("fam", FAMILIES)
def test_verdicts_equal_the_reference_sharded_backend(widths, fam):
    """The port's width-8 verdicts are the JAX package's
    ``sharded_backend`` on ``make_mesh(8)``, the same plan family."""
    jspec, jh, _, _ = _corpus(fam)
    jbackend = j_sharded_backend(jspec, devices=8, budget=BUDGET,
                                 profile=j_profile_corpus(jh, jspec))
    want = [int(v) for v in jbackend.check_histories(jspec, jh)]
    assert widths[8]["families"][fam]["verdicts"] == want


def _reference_lanes(j, flat):
    """``JaxTPU._run_device`` on ``flat`` with each lane's final
    iterations: the carry's lane ``i`` is the flat lane ``active[i]``
    from each fresh carry or compaction (``_pad_args``) on, and a decided
    lane's counters freeze, so the last read of a lane is its total."""
    state = {"map": None}
    final = np.zeros(len(flat), np.int64)
    pad, chunk_fn = j._pad_args, j._chunk_fn

    def pad_args(active, bucket, *args):
        state["map"] = np.array(active)
        return pad(active, bucket, *args)

    def chunk(*args, **kw):
        fn = chunk_fn(*args, **kw)

        def run(carry, *a):
            out = fn(carry, *a)
            m = state["map"]
            final[m] = np.asarray(out["iters"])[:len(m)]
            return out
        return run

    j._pad_args, j._chunk_fn = pad_args, chunk
    status, chosen = j._run_device(flat, collect_chosen=True)
    return status, chosen, final


def _lane_corpus(fam):
    """The family's pending-free device lanes in both packages: whole
    histories, or for kv each history's per-key sub-histories (what the
    ``PComp`` plan hands its inner stepper)."""
    jspec, jh, spec, hs = _corpus(fam)
    if fam == "kv":
        subs = [s for h in jh for s in j_split_history(jspec, h).values()]
        jspec, jh = jspec.projected_spec(), subs
        spec, hs = spec.projected_spec(), _port(subs)
    keep = [i for i, h in enumerate(jh) if h.n_pending == 0]
    return (jspec, [jh[i] for i in keep], spec, [hs[i] for i in keep])


@pytest.mark.parametrize("fam", FAMILIES)
def test_lane_iters_and_chosen_equal_the_reference_sharded_jaxtpu(fam):
    """Each lane's iterations and ``chosen`` stack under the port's
    width-8 sharding are those of the JAX package's ``JaxTPU`` sharded
    over ``make_mesh(8)`` on the same mesh-sized plan (its host
    compaction patched in: the device one's collision winner is not
    defined), and those of the port at width 1 on that plan."""
    jspec, jh, spec, hs = _lane_corpus(fam)
    jplan = j_plan_search(jspec, j_profile_corpus(jh, jspec),
                          platform="cpu", mesh_devices=8)
    j = JaxTPU(jspec, budget=BUDGET, plan=jplan,
               sharding=j_batch_sharding(j_make_mesh(8)))
    j._compact_carry = j._compact_carry_host
    j_status, j_chosen, j_iters = _reference_lanes(j, jh)
    kw = dict(budget=BUDGET, chunk_schedule=jplan.chunk_schedule,
              batch_buckets=jplan.batch_buckets,
              slots_for_batch=dict(jplan.slots_for_batch),
              ordering=bool(jplan.ordering))
    got = {}
    for n in (8, 1):
        t = TorchStepper(spec, device="cpu", sharding=batch_sharding(
            make_mesh(n, device="cpu")), **kw)
        status, chosen = t._run_device(hs, collect_chosen=True)
        got[n] = (status, chosen, t.last_iters.copy(), t)
    status, chosen, iters, t8 = got[8]
    assert t8.batch_buckets == tuple(j.BATCH_BUCKETS)
    assert np.array_equal(status, np.asarray(j_status))
    assert np.array_equal(chosen, np.asarray(j_chosen))
    assert np.array_equal(iters, j_iters)
    assert t8.compactions == j.compactions
    for a, b in zip(got[8][:3], got[1][:3]):
        assert np.array_equal(a, b)
    assert (iters > 0).all()


def test_sweep_regime_compaction_moves_lanes_across_shards():
    """The sweep regime's carry (``states`` lane-major, ``[B, N+1, D]``)
    moved across shards: kv of 16 keys, whole (no step table), on a
    fine ladder whose memo size changes, so that compactions renumber
    survivors onto other shards.  Each lane's status, ``chosen`` and
    iterations equal width 1 and the JAX package's sharded ``JaxTPU``."""
    from qsm_tpu.models.kv import KvSpec as JKv
    from qsm_tpu_torch.models.kv import KvSpec

    entry = JMODELS["kv"]
    jspec = JKv(n_keys=16, n_values=4)
    jh = [h for h in j_build_corpus(
        jspec, (entry.impls["atomic"], entry.impls["racy"]), n=64,
        n_pids=8, max_ops=24, seed_base=11, seed_prefix="mesh_kv")
        if h.n_pending == 0]
    spec, hs = KvSpec(n_keys=16, n_values=4), _port(jh)
    buckets = (8, 16, 24, 32, 40, 48, 56, 64)
    plan = dict(chunk_schedule=(2, 4, 8, 16, 64), batch_buckets=buckets,
                slots_for_batch={b: 64 if b > 16 else 128 for b in buckets})
    budgets = dict(budget=400, mid_budget=0, rescue_budget=0)
    j = JaxTPU(jspec, sharding=j_batch_sharding(j_make_mesh(8)), **budgets)
    j.CHUNK_SCHEDULE = plan["chunk_schedule"]
    j.BATCH_BUCKETS = buckets
    j.MAX_SLOTS_FOR_BATCH = plan["slots_for_batch"]
    j._compact_carry = j._compact_carry_host
    j_status, j_chosen, j_iters = _reference_lanes(j, jh)
    got = {}
    for n in (8, 1):
        t = TorchStepper(spec, device="cpu", sharding=batch_sharding(
            make_mesh(n, device="cpu")), **plan, **budgets)
        assert t.regime == "sweep"
        status, chosen = t._run_device(hs, collect_chosen=True)
        got[n] = (status, chosen, t.last_iters.copy(), t)
    status, chosen, iters, t8 = got[8]
    assert t8.compactions > 0 and t8.lanes_crossed > 0
    assert np.array_equal(status, np.asarray(j_status))
    assert np.array_equal(chosen, np.asarray(j_chosen))
    assert np.array_equal(iters, j_iters)
    assert t8.compactions == j.compactions == got[1][3].compactions
    for a, b in zip(got[8][:3], got[1][:3]):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# in-process pins: planner buckets and placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_plan_buckets_are_mesh_divisible_and_identity_is_suffixed(platform):
    spec = MODELS["cas"].make_spec()
    plain = plan_search(spec, platform=platform)
    plan = plan_search(spec, platform=platform, mesh_devices=8)
    assert plan.mesh_devices == 8
    assert plan.name == f"{plain.name}@mesh8"
    assert all(b % 8 == 0 for b in plan.batch_buckets)
    assert set(plan.slots_for_batch) == set(plan.batch_buckets)
    assert any("mesh_devices=8" in w for w in plan.why)
    # mesh_devices=1 is the identity: same name, same ladder
    one = plan_search(spec, platform=platform, mesh_devices=1)
    assert one.name == plain.name
    assert one.batch_buckets == plain.batch_buckets
    # the CPU plan's mesh ladder is the JAX package's
    if platform == "cpu":
        jplan = j_plan_search(JMODELS["cas"].make_spec(), platform="cpu",
                              mesh_devices=8)
        assert (plan.name, plan.batch_buckets, plan.slots_for_batch) == (
            jplan.name, tuple(jplan.batch_buckets),
            dict(jplan.slots_for_batch))


def test_mesh_bucket_ladder_filters_and_falls_back():
    from qsm_tpu.mesh.dispatch import mesh_bucket_ladder as j_ladder
    from qsm_tpu.mesh.dispatch import mesh_slots_table as j_slots
    from qsm_tpu_torch.mesh.dispatch import (mesh_bucket_ladder,
                                             mesh_slots_table)

    assert mesh_bucket_ladder((1, 2, 4, 8, 64), 1) == (1, 2, 4, 8, 64)
    assert mesh_bucket_ladder((1, 2, 4, 8, 64), 8) == (8, 64)
    # nothing divisible: one bucket of exactly one lane per device
    assert mesh_bucket_ladder((3, 5, 7), 8) == (8,)
    for ladder, n in (((1, 2, 4, 8, 64), 8), ((3, 5, 7), 8),
                      ((32, 256, 1024, 4096), 3)):
        assert mesh_bucket_ladder(ladder, n) == j_ladder(ladder, n)
        kept = mesh_bucket_ladder(ladder, n)
        slots = {b: 64 for b in ladder}
        assert mesh_slots_table(slots, kept) == j_slots(slots, kept)


def test_build_backend_applies_plan_mesh_sharding():
    """A ``@mesh8`` plan builds its own lane sharding when the caller
    passes none: plan and placement cannot drift apart."""
    from qsm_tpu_torch.search.planner import build_backend

    spec = MODELS["cas"].make_spec()
    plan = plan_search(spec, platform="cpu", mesh_devices=8)
    backend = build_backend(spec, plan, device="cpu")
    assert mesh_shape_key(backend_sharding(backend)) == (8, "batch")
    # on the card the mesh is of cards: never fewer than the plan's
    card = plan_search(spec, platform="cuda", mesh_devices=8)
    if torch.cuda.device_count() < 8:
        with pytest.raises((ValueError, BackendUnavailable)):
            build_backend(spec, card)


def test_kernel_mesh_key_buckets_and_lane_sharding():
    """The stepper's ladders are filtered to mesh-divisible widths and
    its carry placement is the lane-axis derivation of the sharding."""
    spec = MODELS["cas"].make_spec()
    drv = TorchStepper(spec, sharding=batch_sharding(
        make_mesh(8, device="cpu")))
    assert drv._mesh_key == (8, "batch")
    assert drv.device == torch.device("cpu")
    assert all(b % 8 == 0 for b in drv.batch_buckets)
    assert set(drv.slots_for_batch) == set(drv.batch_buckets)
    assert drv._lane_sharding.spec[0] == "batch"
    plain = TorchStepper(spec, device="cpu")
    assert plain._mesh_key == (1,)
    assert plain._lane_sharding is None


# ---------------------------------------------------------------------------
# in-process pins: the serve plane
# ---------------------------------------------------------------------------

def test_batcher_mesh_ceil_flush_target():
    from qsm_tpu_torch.serve.batcher import MicroBatcher

    sink = lambda *a: None  # noqa: E731 (never flushed here)
    b = MicroBatcher(sink, flush_s=0.01, max_lanes=10, mesh_devices=8)
    # every lanes target rounds UP to a multiple of the mesh width
    assert b.max_lanes == 16
    assert b._mesh_ceil(1) == 8 and b._mesh_ceil(17) == 24
    assert b.snapshot()["mesh_devices"] == 8
    plain = MicroBatcher(sink, flush_s=0.01, max_lanes=10)
    assert plain.max_lanes == 10 and plain._mesh_ceil(7) == 7


def test_server_mesh_devices_and_worker_pool_are_exclusive():
    from qsm_tpu_torch.serve.server import CheckServer

    for device in (None, "cpu"):
        with pytest.raises(ValueError, match="exclusive"):
            CheckServer(workers=2, mesh_devices=8, device=device)


def test_server_stats_report_mesh_devices():
    from qsm_tpu_torch.serve.client import CheckClient
    from qsm_tpu_torch.serve.server import CheckServer

    jspec, _, spec, hs = _corpus("cas")
    server = CheckServer(flush_s=0.005, max_lanes=8, mesh_devices=8,
                         engine="planned", device="cpu").start()
    try:
        assert server.stats()["mesh_devices"] == 8
        assert server.batcher.max_lanes % 8 == 0
        with CheckClient(server.address) as c:
            res = c.check("cas", hs[:8])
        assert res["ok"]
        want = TorchStepper(spec, budget=2_000, device="cpu"
                            ).check_histories(spec, hs[:8])
        assert res["verdicts"] == [Verdict(int(v)).name for v in want]
        entry = next(iter(server._engines.values()))
        assert mesh_shape_key(backend_sharding(entry.engine.device)) == (
            8, "batch")
    finally:
        server.stop()
    if not torch.cuda.is_available():
        # the card's server: no card, no server, never a silent host mesh
        with pytest.raises(BackendUnavailable):
            CheckServer(mesh_devices=8).start()


def test_cli_serve_mesh_devices_banner():
    """``serve --mesh-devices 8 --device cpu`` reports the mesh and a
    flush width the mesh divides; without a card and without ``--device
    cpu`` it raises rather than serve on fewer devices."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "qsm_tpu_torch", "serve", "--port", "0",
         "--mesh-devices", "8", "--max-lanes", "12", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    try:
        banner = json.loads(proc.stdout.readline())
        assert banner["mesh_devices"] == 8
        assert banner["max_lanes"] == 16
    finally:
        proc.kill()
        proc.communicate(timeout=30)
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "-m", "qsm_tpu_torch", "serve", "--port", "0",
             "--mesh-devices", "8"], capture_output=True, text=True,
            env=env, cwd=ROOT, timeout=120)
        assert out.returncode != 0
        assert "BackendUnavailable" in out.stderr + out.stdout


# ---------------------------------------------------------------------------
# in-process pins: topology identity helpers
# ---------------------------------------------------------------------------

def test_topology_identity_helpers():
    from qsm_tpu.mesh import batch_sharding as jb
    from qsm_tpu.mesh import make_mesh_2d as jm2
    from qsm_tpu.mesh import mesh_shape_key as jkey

    mesh = make_mesh(8, device="cpu")
    sharding = batch_sharding(mesh)
    assert mesh_device_count(mesh) == 8
    assert mesh_device_count(sharding) == 8
    assert mesh_shape_key(sharding) == (8, "batch")
    assert mesh_shape_key(None) == (1,)
    assert lane_sharding_of(sharding).spec == ("batch",)
    # hierarchical mesh: the lane derivation keeps dim 0 over BOTH axes
    mesh2 = make_mesh_2d(2, 4, device="cpu")
    s2 = batch_sharding(mesh2)
    assert mesh_shape_key(s2) == (8, "host", "batch")
    assert lane_sharding_of(s2).spec[0] == ("host", "batch")
    # the reference's identities, key for key
    assert mesh_shape_key(s2) == jkey(jb(jm2(2, 4)))
    assert mesh_shape_key(sharding) == jkey(jb(j_make_mesh(8)))


def test_make_mesh_never_hands_back_fewer_cards():
    """Over CUDA ``make_mesh(n)`` spans ``n`` cards or raises with the
    count; without a card it raises ``BackendUnavailable`` (the host's
    logical devices are asked for with ``device="cpu"`` only)."""
    k = torch.cuda.device_count()
    if not torch.cuda.is_available():
        with pytest.raises(BackendUnavailable):
            make_mesh(2)
        with pytest.raises(BackendUnavailable):
            mesh_device_count()
    else:
        with pytest.raises(ValueError,
                           match=f"requested {k + 1} devices, have {k}"):
            make_mesh(k + 1)
    assert make_mesh(3, device="cpu").devices.shape == (3,)


# ---------------------------------------------------------------------------
# in-process pins: the monitor plane on a sharded checker
# ---------------------------------------------------------------------------

def test_monitor_frontier_recheck_through_sharded_oracle():
    """The frontier's window re-check answers the same through a
    width-8 sharded stepper and the unsharded one, and as the JAX
    package's frontier over its own sharded kernel."""
    from qsm_tpu import generate_program, run_concurrent
    from qsm_tpu.models import AtomicCasSUT, CasSpec as JCas
    from qsm_tpu.monitor.frontier import IncrementalFrontier as JFrontier
    from qsm_tpu_torch.monitor.frontier import IncrementalFrontier

    jspec = JCas()
    prog = generate_program(jspec, seed=5, n_pids=4, max_ops=12)
    jhist = run_concurrent(AtomicCasSUT(jspec), prog, seed="mesh-mon")
    jops = sorted(jhist.completed().ops, key=lambda o: o.invoke_time)
    spec = MODELS["cas"].make_spec()
    ops = sorted(_port([jhist.completed()])[0].ops,
                 key=lambda o: o.invoke_time)

    def drive(frontier, seq_ops):
        seq = []
        for op in seq_ops:
            frontier.append_completed(op)
            seq.append(int(frontier.advance()))
        seq.append(int(frontier.check_window()))
        return seq

    sharded = drive(IncrementalFrontier(spec, oracle=TorchStepper(
        spec, budget=200_000, sharding=batch_sharding(
            make_mesh(8, device="cpu")))), ops)
    plain = drive(IncrementalFrontier(spec, oracle=TorchStepper(
        spec, budget=200_000, device="cpu")), ops)
    ref = drive(JFrontier(jspec, oracle=JaxTPU(
        jspec, budget=200_000,
        sharding=j_batch_sharding(j_make_mesh(8)))), jops)
    assert sharded == plain == ref
    assert sharded[-1] is not None


# ---------------------------------------------------------------------------
# in-process pins: the window's mesh comes from its device list
# ---------------------------------------------------------------------------

def test_mesh_from_devices_uses_the_explicit_list():
    """A drain mesh is built from the devices the window was handed:
    order kept, size the list's, never a forced count."""
    window = host_devices(8)[1:4]        # a window that offered 3
    mesh = mesh_from_devices(window)
    assert mesh_device_count(mesh) == 3
    assert list(mesh.devices.flat) == list(window)
    assert mesh.axis_names == ("batch",)


def test_mesh_from_devices_refuses_empty_and_duplicates():
    with pytest.raises(ValueError, match="empty device set"):
        mesh_from_devices([])
    d0 = host_devices(8)[0]
    with pytest.raises(ValueError, match="duplicate devices"):
        mesh_from_devices([d0, d0])
    with pytest.raises(ValueError, match="duplicate devices"):
        mesh_from_devices(["cpu", "cpu"])


def test_drain_scheduler_builds_mesh_from_window_devices():
    """The drain threads its window's devices through
    ``mesh_from_devices``: handed 3 of 8 logical host devices, its mesh
    is exactly 3 wide, and its report names the mesh."""
    from qsm_tpu_torch.devq.drain import DrainScheduler
    from qsm_tpu_torch.devq.queue import DeviceWorkQueue, bank_histories

    q = DeviceWorkQueue()
    _, _, spec, hs = _corpus("register")
    bank_histories(spec, hs[:6], plane="check", queue=q)
    sched = DrainScheduler(q, devices=host_devices(8)[:3], window_s=60.0,
                           cache=None)
    assert sched.n_devices == 3
    rep = sched.drain()
    assert rep["devices"] == 3 and rep["mesh_axes"] == ["batch"]
    assert rep["wrong_verdicts"] == 0
    be = next(iter(sched._backends.values()))
    assert mesh_shape_key(backend_sharding(be)) == (3, "batch")
