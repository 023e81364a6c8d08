"""Port step functions: ``step_torch == step_py`` exhaustively, and equal
to the JAX package's ``step_jax`` on the same numpy arrays (tolerance 0:
all integer)."""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qsm_tpu.models.cas import CasSpec as JCas
from qsm_tpu.models.register import RegisterSpec as JRegister
from qsm_tpu_torch.models.cas import CasSpec
from qsm_tpu_torch.models.register import RegisterSpec

SPECS = [
    pytest.param(CasSpec, JCas, 5, id="cas5"),
    pytest.param(CasSpec, JCas, 3, id="cas3"),
    pytest.param(RegisterSpec, JRegister, 5, id="register5"),
]


def _grid(spec):
    """Every (state, cmd, arg, resp) over the declared domains, with
    resps one beyond each side of the response domain."""
    S = spec.scalar_state_bound(32)
    rows = [(s, c, a, r)
            for c, sig in enumerate(spec.CMDS)
            for s, a, r in itertools.product(range(S), range(sig.n_args),
                                             range(-1, sig.n_resps + 1))]
    return np.asarray(rows, np.int32).T


@pytest.mark.parametrize("tcls,jcls,nv", SPECS)
def test_step_torch_equals_step_py(tcls, jcls, nv):
    spec = tcls(n_values=nv)
    st, cmd, arg, resp = _grid(spec)
    nxt, ok = spec.step_torch(*(torch.from_numpy(x)
                                for x in (st, cmd, arg, resp)))
    assert nxt.dtype == torch.int32 and ok.dtype == torch.bool
    for i in range(len(st)):
        want_s, want_ok = spec.step_py([int(st[i])], int(cmd[i]),
                                       int(arg[i]), int(resp[i]))
        assert bool(ok[i]) == bool(want_ok), (st[i], cmd[i], arg[i], resp[i])
        assert int(nxt[i]) == int(want_s[0]), (st[i], cmd[i], arg[i])


@pytest.mark.parametrize("tcls,jcls,nv", SPECS)
def test_step_torch_equals_reference_step_jax(tcls, jcls, nv):
    spec, jspec = tcls(n_values=nv), jcls(n_values=nv)
    st, cmd, arg, resp = _grid(spec)
    jn, jok = jax.vmap(lambda s, c, a, r: jspec.step_jax(
        jnp.reshape(s, (1,)), c, a, r))(*(jnp.asarray(x)
                                          for x in (st, cmd, arg, resp)))
    tn, tok = spec.step_torch(*(torch.from_numpy(x)
                                for x in (st, cmd, arg, resp)))
    np.testing.assert_array_equal(np.asarray(jn)[:, 0], tn.numpy())
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())


def test_step_torch_broadcasts_to_table_shape():
    """The step-table call of ``lane_tables``: states [1, S, 1] against
    ops [B, 1, N]."""
    spec = CasSpec()
    rng = np.random.default_rng(0)
    B, N, S = 3, 7, spec.scalar_state_bound(7)
    cmd = rng.integers(0, 3, (B, 1, N)).astype(np.int32)
    arg = rng.integers(0, 25, (B, 1, N)).astype(np.int32)
    resp = rng.integers(0, 5, (B, 1, N)).astype(np.int32)
    st = torch.arange(S, dtype=torch.int32)[None, :, None]
    nxt, ok = spec.step_torch(st, *(torch.from_numpy(x)
                                    for x in (cmd, arg, resp)))
    assert tuple(nxt.shape) == (B, S, N)
    for b, s, j in itertools.product(range(B), range(S), range(N)):
        ws, wok = spec.step_py([s], int(cmd[b, 0, j]), int(arg[b, 0, j]),
                               int(resp[b, 0, j]))
        assert (int(nxt[b, s, j]), bool(ok[b, s, j])) == (ws[0], wok)
