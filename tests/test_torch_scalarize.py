"""Port scalarization against the JAX package's ``ops/scalarize.py``:
packing exhaustive over the queue's domain, ``Scalarized.step_torch``
against the reference ``step_jax`` and ``step_py`` on every packed state ×
command × arg × response, and the same shadow decisions for every spec the
two registries share (tolerance 0: all integer)."""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsm_tpu.core.spec import Spec as JSpec
from qsm_tpu.models.queue import QueueSpec as JQueue
from qsm_tpu.models.registry import MODELS as J_MODELS
from qsm_tpu.ops import scalarize as jsc
from qsm_tpu_torch.core.spec import Spec
from qsm_tpu_torch.models.queue import QueueSpec
from qsm_tpu_torch.models.registry import MODELS
from qsm_tpu_torch.ops import scalarize as tsc


def test_max_packed_states_is_the_reference_constant():
    assert tsc.MAX_PACKED_STATES == jsc.MAX_PACKED_STATES == 65_536


def test_pack_unpack_exhaustive_over_the_queue_domain():
    t = tsc.Scalarized(QueueSpec())
    j = jsc.Scalarized(JQueue())
    assert t.bounds == j.bounds and t.radix == j.radix
    assert t.n_packed == j.n_packed == 1280
    seen = set()
    for vec in itertools.product(*(range(b) for b in t.bounds)):
        p = t.pack(vec)
        assert p == j.pack(vec)
        assert t.unpack(p) == list(vec) == j.unpack(p)
        assert t.in_bounds(vec) and j.in_bounds(vec)
        seen.add(p)
    assert seen == set(range(1280))
    for bad in ([5, 0, 0, 0, 0], [0, 4, 0, 0, 0], [0, 0, 0, 0, -1],
                [0, 0, 0, 0]):
        assert not t.in_bounds(bad) and not j.in_bounds(bad)
        with pytest.raises(ValueError):
            t.pack(bad)
    assert np.array_equal(t.initial_state(), j.initial_state())


def _grid(spec):
    """Every (packed state, cmd, arg, resp), resps one past each side of
    the response domain."""
    rows = [(s, c, a, r)
            for c, sig in enumerate(spec.CMDS)
            for s, a, r in itertools.product(
                range(spec.n_packed), range(sig.n_args),
                range(-1, sig.n_resps + 1))]
    return np.asarray(rows, np.int32).T


@pytest.mark.parametrize("cap,nv", [(4, 4), (2, 3)])
def test_scalarized_step_torch_equals_step_jax_and_step_py(cap, nv):
    t = tsc.Scalarized(QueueSpec(capacity=cap, n_values=nv))
    j = jsc.Scalarized(JQueue(capacity=cap, n_values=nv))
    st, cmd, arg, resp = _grid(t)
    tn, tok = t.step_torch(*(torch.from_numpy(x)
                             for x in (st, cmd, arg, resp)))
    assert tn.dtype == torch.int32 and tok.dtype == torch.bool
    jn, jok = jax.vmap(lambda s, c, a, r: j.step_jax(
        jnp.reshape(s, (1,)), c, a, r))(*(jnp.asarray(x)
                                          for x in (st, cmd, arg, resp)))
    assert np.array_equal(tn.numpy(), np.asarray(jn)[:, 0])
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    for i in range(0, len(st), 7):
        want_s, want_ok = t.step_py([int(st[i])], int(cmd[i]), int(arg[i]),
                                    int(resp[i]))
        assert (int(tn[i]), bool(tok[i])) == (want_s[0], bool(want_ok))


def test_step_torch_broadcasts_as_the_step_tables_use_it():
    """``[1, S, 1]`` states against ``[B, 1, N]`` ops, as
    ``stepper_tables`` calls it."""
    t = tsc.Scalarized(QueueSpec())
    g = np.random.default_rng(0)
    cmd = g.integers(0, 2, (3, 1, 7)).astype(np.int32)
    arg = g.integers(0, 4, (3, 1, 7)).astype(np.int32)
    resp = g.integers(0, 5, (3, 1, 7)).astype(np.int32)
    st = torch.arange(1280, dtype=torch.int32)[None, :, None]
    n, ok = t.step_torch(st, *(torch.from_numpy(x)
                               for x in (cmd, arg, resp)))
    assert n.shape == ok.shape == (3, 1280, 7)
    for b, s, k in itertools.product(range(3), (0, 5, 641, 1279), range(7)):
        want_s, want_ok = t.step_py([s], int(cmd[b, 0, k]), int(arg[b, 0, k]),
                                    int(resp[b, 0, k]))
        assert (int(n[b, s, k]), bool(ok[b, s, k])) == (want_s[0], want_ok)


def _bounded(base, dim, bounds):
    class Bounded(base):
        name = "bounded"
        STATE_DIM = dim

        def state_elem_bounds(self):
            return bounds
    return Bounded()


@pytest.mark.parametrize("bounds", [[2] * 16, [2] * 17, [256, 256],
                                    [256, 257], [3], None])
def test_shadow_decision_equals_the_reference(bounds):
    dim = len(bounds) if bounds else 2
    t = tsc.scalar_shadow(_bounded(Spec, dim, bounds))
    j = jsc.scalar_shadow(_bounded(JSpec, dim, bounds))
    assert (t is None) == (j is None)
    if t is not None:
        assert t.n_packed == j.n_packed


@pytest.mark.parametrize("model", sorted(set(MODELS) & set(J_MODELS)))
def test_shadow_decision_equals_the_reference_for_shared_models(model):
    spec, jspec = MODELS[model].make_spec(), J_MODELS[model].make_spec()
    assert spec.STATE_DIM == jspec.STATE_DIM
    assert spec.state_elem_bounds() == jspec.state_elem_bounds()
    t, j = tsc.scalar_shadow(spec), jsc.scalar_shadow(jspec)
    assert (t is None) == (j is None)
    if t is not None:
        assert t.bounds == j.bounds and t.n_packed == j.n_packed
