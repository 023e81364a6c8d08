"""``utils/fuzz.py`` against the JAX package's: the same seed gives the
same random specs (command signatures and tables) and the same random
histories; the random specs' ``step_torch`` equals ``step_py`` over the
declared domains and the reference ``step_jax`` on and off them; the
random vector spec's kernel model carries its tables.  Tolerance 0."""

from __future__ import annotations

import itertools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsm_tpu.utils import fuzz as jfuzz
from qsm_tpu_torch.utils import fuzz
from qsm_tpu_torch.utils.interop import history_to_rows

SEEDS = [0, 1, 7, 123, 2024]


def _sigs(spec):
    return [(c.name, c.n_args, c.n_resps) for c in spec.CMDS]


@pytest.mark.parametrize("seed", SEEDS)
def test_random_table_spec_equals_the_reference(seed):
    kw = dict(n_states=6, n_cmds=4, max_args=3, max_resps=4, ok_bias=0.6)
    spec = fuzz.RandomTableSpec(seed, **kw)
    jspec = jfuzz.RandomTableSpec(seed, **kw)
    assert _sigs(spec) == _sigs(jspec)
    assert spec.spec_kwargs() == jspec.spec_kwargs()
    assert np.array_equal(spec._trans, jspec._trans)
    assert np.array_equal(spec._ok, jspec._ok)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_vector_spec_equals_the_reference(seed):
    kw = dict(bounds=(3, 4, 2, 5), n_cmds=3, max_args=4, max_resps=3)
    spec = fuzz.RandomVectorSpec(seed, **kw)
    jspec = jfuzz.RandomVectorSpec(seed, **kw)
    assert _sigs(spec) == _sigs(jspec)
    assert spec.spec_kwargs() == jspec.spec_kwargs()
    assert spec.state_elem_bounds() == jspec.state_elem_bounds()
    assert np.array_equal(spec._ok, jspec._ok)
    for a, b in zip(spec._trans, jspec._trans, strict=True):
        assert np.array_equal(a, b)
    kind, (c, a, r), data = spec.sweep_kernel()
    assert kind == 6 and (c, a, r) == spec._ok.shape[1:]
    tables = [spec._ok.astype(np.int32)] + spec._trans
    assert data.tolist() == list(kw["bounds"]) + list(
        np.concatenate([t.reshape(-1) for t in tables]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p_pending", [0.0, 0.2])
def test_random_history_equals_the_reference(seed, p_pending):
    spec = fuzz.RandomVectorSpec(seed, bounds=(4,) * 9)
    jspec = jfuzz.RandomVectorSpec(seed, bounds=(4,) * 9)
    rng, jrng = random.Random(f"f:{seed}"), random.Random(f"f:{seed}")
    for _ in range(5):
        h = fuzz.random_history(spec, rng, 4, 24, p_pending=p_pending)
        jh = jfuzz.random_history(jspec, jrng, 4, 24, p_pending=p_pending)
        assert history_to_rows(h) == history_to_rows(jh)


def _jax(jspec, st, cmd, arg, resp):
    nxt, ok = jax.jit(jax.vmap(jspec.step_jax))(
        *(jnp.asarray(x) for x in (st, cmd, arg, resp)))
    return np.asarray(nxt), np.asarray(ok)


@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_random_step_torch_equals_step_py_and_step_jax(seed, vector):
    if vector:
        spec = fuzz.RandomVectorSpec(seed, bounds=(3, 4, 2))
        jspec = jfuzz.RandomVectorSpec(seed, bounds=(3, 4, 2))
        states = list(itertools.product(range(3), range(4), range(2)))
    else:
        spec, jspec = fuzz.RandomTableSpec(seed), jfuzz.RandomTableSpec(seed)
        states = [(s,) for s in range(spec.n_states)]
    rows = [(s, c, a, r) for s in states for c, sig in enumerate(spec.CMDS)
            for a in range(sig.n_args) for r in range(sig.n_resps)]
    st = np.asarray([r[0] for r in rows], np.int32)
    cmd, arg, resp = (np.asarray([r[k] for r in rows], np.int32)
                      for k in (1, 2, 3))
    t = [torch.from_numpy(x) for x in (st, cmd, arg, resp)]
    if vector:
        tn, tok = spec.step_torch(*t)
    else:
        tn, tok = spec.step_torch(t[0][:, 0], *t[1:])
        tn = tn[:, None]
    for i, (s, c, a, r) in enumerate(rows):
        want, good = spec.step_py(list(s), c, a, r)
        assert tn[i].tolist() == [int(v) for v in want]
        assert bool(tok[i]) == bool(good)
    jn, jok = _jax(jspec, st, cmd, arg, resp)
    np.testing.assert_array_equal(jn, tn.numpy())
    np.testing.assert_array_equal(jok, tok.numpy())
    # off the domains: each index read as jnp indexing reads it
    g = np.random.default_rng(seed)
    m = 2000
    st = g.integers(-4, 7, (m, st.shape[1])).astype(np.int32)
    cmd, arg, resp = (g.integers(-4, 6, m).astype(np.int32)
                      for _ in range(3))
    t = [torch.from_numpy(x) for x in (st, cmd, arg, resp)]
    tn, tok = (spec.step_torch(*t) if vector
               else spec.step_torch(t[0][:, 0], *t[1:]))
    jn, jok = _jax(jspec, st, cmd, arg, resp)
    np.testing.assert_array_equal(jn.reshape(m, -1), tn.reshape(m, -1))
    np.testing.assert_array_equal(jok, tok.numpy())


# ---------------------------------------------------------------------------
# fuzz_parity and FuzzReport (tests/test_fuzz.py)
# ---------------------------------------------------------------------------

def _report_fields(rep):
    return {f: getattr(rep, f) for f in (
        "specs", "histories", "linearizable", "violations",
        "budget_exceeded", "mismatches", "cpp_native_histories",
        "hybrid_tail_histories")} | {"ok": rep.ok}


@pytest.mark.parametrize("seed", [1, 5])
def test_fuzz_report_equals_the_reference_on_host_arms(seed):
    kw = dict(n_specs=12, hists_per_spec=24, seed=seed,
              backends=("memo", "cpp"))
    rep = fuzz.fuzz_parity(**kw)
    assert _report_fields(rep) == _report_fields(jfuzz.fuzz_parity(**kw))
    assert rep.ok and rep.linearizable > 0 and rep.violations > 0
    assert rep.cpp_native_histories == rep.histories


def test_fuzz_report_equals_the_reference_on_device_arms():
    """``device`` (TorchStepper) and ``hybrid`` on the CPU against the
    reference's ``JaxTPU`` / ``HybridDevice``: the same report, the host
    tail deciding the same number of histories."""
    kw = dict(n_specs=3, hists_per_spec=24, seed=6,
              backends=("device", "hybrid"))
    rep = fuzz.fuzz_parity(device="cpu", **kw)
    ref = jfuzz.fuzz_parity(**kw)
    assert _report_fields(rep) == _report_fields(ref)
    assert rep.ok and rep.hybrid_tail_histories > 0
    assert rep.linearizable > 0 and rep.violations > 0


def test_device_arm_verdicts_equal_the_reference_where_both_decide():
    from qsm_tpu.ops.jax_kernel import JaxTPU

    for k in range(2):
        spec = fuzz.RandomTableSpec(2 * 1_000_003 + k)
        jspec = jfuzz.RandomTableSpec(2 * 1_000_003 + k)
        rng, jrng = random.Random(f"d{k}"), random.Random(f"d{k}")
        hs = [fuzz.random_history(spec, rng, 4, 10, 0.1) for _ in range(24)]
        jhs = [jfuzz.random_history(jspec, jrng, 4, 10, 0.1)
               for _ in range(24)]
        got = np.asarray(fuzz.fuzz_arm("device", spec, "cpu")
                         .check_histories(spec, hs))
        want = np.asarray(JaxTPU(jspec).check_histories(jspec, jhs))
        both = (got != 2) & (want != 2)
        assert both.sum() > 0
        np.testing.assert_array_equal(got[both], want[both])


def test_vector_bounds_past_the_cap_send_the_device_arm_to_the_sweep():
    from qsm_tpu.ops.jax_kernel import JaxTPU

    bounds = (7,) * 7  # 7**7 = 823,543 states: no scalar shadow
    assert JaxTPU(jfuzz.RandomVectorSpec(1, bounds=bounds))._shadow is None
    arm = fuzz.fuzz_arm("device", fuzz.RandomVectorSpec(1, bounds=bounds),
                        "cpu")
    assert arm.regime == "sweep"
    small = fuzz.fuzz_arm("device", fuzz.RandomVectorSpec(1), "cpu")
    assert small.regime == "table"
    kw = dict(n_specs=2, hists_per_spec=16, seed=4, n_ops=8,
              vector_bounds=bounds)
    rep = fuzz.fuzz_parity(backends=("memo", "device", "hybrid"),
                           device="cpu", **kw)
    ref = jfuzz.fuzz_parity(backends=("memo",), **kw)
    assert rep.ok and rep.linearizable > 0
    assert (rep.linearizable, rep.violations, rep.budget_exceeded) == \
        (ref.linearizable, ref.violations, ref.budget_exceeded)


@pytest.mark.parametrize("arms,vector", [(("pallas",), None),
                                         (("segdc", "auto"), None),
                                         (("segdc",), (3, 2, 2))])
def test_combinator_and_dfs_arms_agree_with_the_oracle(arms, vector):
    rep = fuzz.fuzz_parity(n_specs=2, hists_per_spec=12, seed=21,
                           backends=arms, device="cpu",
                           vector_bounds=vector)
    assert rep.mismatches == []
    assert rep.linearizable + rep.violations > 0


def test_arm_names_are_the_references_and_unknown_ones_refused():
    from qsm_tpu_torch.native import CppOracle
    from qsm_tpu_torch.ops.gpu_backend import TorchGPU
    from qsm_tpu_torch.ops.hybrid import HybridDevice
    from qsm_tpu_torch.ops.router import AutoDevice
    from qsm_tpu_torch.ops.segdc import SegDC
    from qsm_tpu_torch.ops.stepper import TorchStepper
    from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU

    spec = fuzz.RandomTableSpec(3)
    want = {"memo": WingGongCPU, "cpp": CppOracle, "device": TorchStepper,
            "segdc": SegDC, "auto": AutoDevice, "hybrid": HybridDevice,
            "pallas": TorchGPU}
    for name, ty in want.items():
        arm = fuzz.fuzz_arm(name, spec, "cpu")
        assert isinstance(arm, ty), name
    assert fuzz.fuzz_arm("hybrid", spec, "cpu").device.budget == 12
    assert isinstance(fuzz.fuzz_arm("segdc", spec, "cpu").inner,
                      TorchStepper)
    with pytest.raises(ValueError, match="unknown fuzz backend"):
        fuzz.fuzz_parity(n_specs=1, hists_per_spec=2, backends=("tpu",))


def test_fuzz_parity_times_each_arm():
    t = {}
    fuzz.fuzz_parity(n_specs=2, hists_per_spec=8, backends=("memo", "cpp"),
                     timings=t)
    assert set(t) == {"oracle", "memo", "cpp"}
    assert all(v >= 0 for v in t.values())
