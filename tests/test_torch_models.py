"""The nine model families beyond register, CAS and queue (ticket, set,
semaphore, rangeset, stack, KV, multireg / multicas, txn, failover)
against the JAX package, tolerance 0 (all integer):

* ``step_torch == step_py`` exhaustively over the declared domains, with
  responses one beyond each side, and both equal to the reference's
  ``step_jax`` on the same numpy arrays; for the vector families also off
  the domains (args, commands and states outside them, as the sweep
  regime may meet them);
* the same seed gives the same programs through both generators, and the
  same program and schedule seed the same history rows through both
  runners (failover under a seeded crash of the primary);
* ``scalar_shadow`` applies exactly where the reference's does;
* the registry holds the reference's 13 models with its defaults, and
  ``prop_concurrent`` through the port convicts each new racy SUT and
  passes each atomic one, at the reference tests' sizes."""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsm_tpu.core.generator import generate_program as j_generate_program
from qsm_tpu.models import registry as jreg
from qsm_tpu.ops.scalarize import scalar_shadow as j_scalar_shadow
from qsm_tpu.sched.runner import run_concurrent as j_run_concurrent
from qsm_tpu.sched.scheduler import FaultPlan as JFaultPlan
from qsm_tpu_torch.core.generator import generate_program
from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
from qsm_tpu_torch.models import registry
from qsm_tpu_torch.ops.backend import Verdict
from qsm_tpu_torch.ops.scalarize import scalar_shadow
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.sched.runner import run_concurrent
from qsm_tpu_torch.sched.scheduler import FaultPlan
from qsm_tpu_torch.utils.interop import history_to_rows

# the families with a spec of their own (failover runs over the register)
FAMILIES = ["ticket", "set", "semaphore", "rangeset", "stack", "kv",
            "multireg", "multicas", "txn"]
VECTOR = ["stack", "kv", "multireg", "multicas", "txn"]


def _specs(model: str, **kw):
    return (registry.MODELS[model].make_spec(**kw),
            jreg.MODELS[model].make_spec(**kw))


def _states(spec):
    """Every state of the declared domain: ``[M, D]`` int32."""
    if spec.STATE_DIM == 1:
        return np.arange(spec.scalar_state_bound(24), dtype=np.int32)[:, None]
    return np.asarray(list(itertools.product(
        *(range(b) for b in spec.state_elem_bounds()))), np.int32)


def _grid(spec):
    """Every (state, cmd, arg, resp) over the declared domains, responses
    one beyond each side: states ``[M, D]``, ops ``[M]`` each."""
    st = _states(spec)
    ops = np.asarray([(c, a, r) for c, sig in enumerate(spec.CMDS)
                      for a in range(sig.n_args)
                      for r in range(-1, sig.n_resps + 1)], np.int32)
    s = np.repeat(st, len(ops), axis=0)
    o = np.tile(ops, (len(st), 1))
    return s, o[:, 0], o[:, 1], o[:, 2]


def _torch_step(spec, st, cmd, arg, resp):
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (st, cmd, arg, resp)]
    if spec.STATE_DIM == 1:
        nxt, ok = spec.step_torch(t[0][:, 0], *t[1:])
        return nxt.numpy()[:, None], ok.numpy()
    nxt, ok = spec.step_torch(*t)
    return nxt.numpy(), ok.numpy()


def _jax_step(jspec, st, cmd, arg, resp):
    nxt, ok = jax.jit(jax.vmap(jspec.step_jax))(
        *(jnp.asarray(x) for x in (st, cmd, arg, resp)))
    return np.asarray(nxt), np.asarray(ok)


@pytest.mark.parametrize("model", FAMILIES)
def test_step_torch_equals_step_py_and_step_jax(model):
    spec, jspec = _specs(model)
    st, cmd, arg, resp = _grid(spec)
    tn, tok = _torch_step(spec, st, cmd, arg, resp)
    assert tn.dtype == np.int32 and tok.dtype == bool
    for i in range(len(cmd)):
        want, good = spec.step_py(list(st[i]), int(cmd[i]), int(arg[i]),
                                  int(resp[i]))
        assert bool(tok[i]) == bool(good), (st[i], cmd[i], arg[i], resp[i])
        assert tn[i].tolist() == [int(v) for v in want], (st[i], cmd[i],
                                                          arg[i])
    jn, jok = _jax_step(jspec, st, cmd, arg, resp)
    np.testing.assert_array_equal(jn, tn)
    np.testing.assert_array_equal(jok, tok)


@pytest.mark.parametrize("model", VECTOR)
def test_vector_step_torch_equals_step_jax_off_the_domains(model):
    """Args, commands and states outside the declared domains: floor
    division and a dynamic index clamped as jnp indexing clamps it."""
    spec, jspec = _specs(model, **({"capacity": 5} if model == "stack"
                                   else {}))
    g = np.random.default_rng(11)
    m = 4000
    hi = max(spec.state_elem_bounds()) + 3
    st = g.integers(-3, hi, (m, spec.STATE_DIM)).astype(np.int32)
    cmd = g.integers(-1, len(spec.CMDS) + 1, m).astype(np.int32)
    arg = g.integers(-40, 90, m).astype(np.int32)
    resp = g.integers(-2, 6, m).astype(np.int32)
    tn, tok = _torch_step(spec, st, cmd, arg, resp)
    jn, jok = _jax_step(jspec, st, cmd, arg, resp)
    np.testing.assert_array_equal(jn, tn)
    np.testing.assert_array_equal(jok, tok)


@pytest.mark.parametrize("model", FAMILIES + ["failover"])
def test_same_seed_same_programs_and_histories(model):
    entry, jentry = registry.MODELS[model], jreg.MODELS[model]
    spec, jspec = entry.make_spec(), jentry.make_spec()
    assert spec.spec_kwargs() == jspec.spec_kwargs()
    assert [(c.name, c.n_args, c.n_resps) for c in spec.CMDS] == [
        (c.name, c.n_args, c.n_resps) for c in jspec.CMDS]
    for k in range(6):
        prog = generate_program(spec, seed=k, n_pids=entry.default_pids,
                                max_ops=entry.default_ops)
        jprog = j_generate_program(jspec, seed=k,
                                   n_pids=jentry.default_pids,
                                   max_ops=jentry.default_ops)
        assert [(o.pid, o.cmd, o.arg) for o in prog.ops] == [
            (o.pid, o.cmd, o.arg) for o in jprog.ops]
        for impl in sorted(entry.impls):
            faults = jfaults = None
            if model == "failover":
                faults = FaultPlan(crash_at={"primary": 2 + k})
                jfaults = JFaultPlan(crash_at={"primary": 2 + k})
            h = run_concurrent(entry.impls[impl](spec), prog,
                               seed=f"s:{k}", faults=faults)
            jh = j_run_concurrent(jentry.impls[impl](jspec), jprog,
                                  seed=f"s:{k}", faults=jfaults)
            assert history_to_rows(h) == history_to_rows(jh), (impl, k)


@pytest.mark.parametrize("model", FAMILIES)
def test_scalar_shadow_applies_where_the_reference_does(model):
    for kw in ({}, {"n_keys": 16}) if model == "kv" else ({},):
        spec, jspec = _specs(model, **kw)
        got, want = scalar_shadow(spec), j_scalar_shadow(jspec)
        assert (got is None) == (want is None), kw
        if got is not None:
            assert got.n_packed == want.n_packed
            assert got.bounds == list(want.bounds)
    if model == "kv":
        assert scalar_shadow(_specs("kv", n_keys=16)[0]) is None
        assert scalar_shadow(_specs("kv")[0]).n_packed == 256
    if model == "stack":
        assert scalar_shadow(_specs("stack")[0]).n_packed == 1280


def test_registry_holds_the_reference_models():
    assert sorted(registry.MODELS) == sorted(jreg.MODELS)
    assert len(registry.MODELS) == 13
    for name, entry in registry.MODELS.items():
        jentry = jreg.MODELS[name]
        assert (entry.default_pids, entry.default_ops) == (
            jentry.default_pids, jentry.default_ops), name
        assert sorted(entry.impls) == sorted(jentry.impls), name
        assert (type(entry.make_spec()).__name__
                == type(jentry.make_spec()).__name__)
    spec, sut = registry.make("kv", "racy", {"n_keys": 16})
    assert spec.n_keys == 16 and type(sut).__name__ == "StaleCacheKvSUT"


# (model, spec kwargs, config): the reference tests' sizes
PROPERTY = [
    ("ticket", {}, dict(n_trials=60, n_pids=4, max_ops=24, seed=99)),
    ("set", {}, dict(n_trials=80, n_pids=4, max_ops=24, seed=11)),
    ("semaphore", {}, dict(n_trials=80, n_pids=4, max_ops=24, seed=11)),
    ("rangeset", {}, dict(n_trials=120, n_pids=4, max_ops=32, seed=11)),
    ("stack", {}, dict(n_trials=80, n_pids=8, max_ops=32, seed=13)),
    ("kv", {}, dict(n_trials=40, n_pids=16, max_ops=64, seed=13)),
    ("multireg", {"n_cells": 2}, dict(n_trials=40, n_pids=8, max_ops=28,
                                      seed=5)),
    ("multicas", {"n_cells": 2}, dict(n_trials=40, n_pids=8, max_ops=28,
                                      seed=5)),
    ("txn", {"n_cells": 2, "n_values": 3},
     dict(n_trials=60, n_pids=6, max_ops=24, seed=11)),
]


@pytest.mark.parametrize("model,kw,cfg", PROPERTY,
                         ids=[p[0] for p in PROPERTY])
def test_property_convicts_racy_and_passes_atomic(model, kw, cfg):
    for impl, want in (("racy", False), ("atomic", True)):
        spec, sut = registry.make(model, impl, kw)
        res = prop_concurrent(spec, sut, PropertyConfig(**cfg))
        assert res.ok == want and res.undecided == 0, (impl,
                                                       res.counterexample)
        if not want:
            cx = res.counterexample
            assert WingGongCPU().check_histories(
                spec, [cx.history]).tolist() == [int(Verdict.VIOLATION)]


def test_failover_property_under_crash_schedules():
    spec = registry.MODELS["failover"].make_spec()
    for k in (2, 4, 8):
        cfg = PropertyConfig(n_trials=120, n_pids=3, max_ops=10, seed=3,
                             faults=FaultPlan(crash_at={"primary": k}))
        _, sut = registry.make("failover", "atomic")
        assert prop_concurrent(spec, sut, cfg).ok, k
    cfg = PropertyConfig(n_trials=120, n_pids=3, max_ops=10, seed=3,
                         faults=FaultPlan(crash_at={"primary": 4}))
    _, sut = registry.make("failover", "racy")
    res = prop_concurrent(spec, sut, cfg)
    assert not res.ok
    # without a crash both behave like a plain register
    cfg = PropertyConfig(n_trials=60, n_pids=3, max_ops=10, seed=1)
    for impl in ("atomic", "racy"):
        assert prop_concurrent(spec, registry.make("failover", impl)[1],
                               cfg).ok
