"""State-machine specification protocol.

A spec is a small class over integer domains whose one function,
``step(state, cmd, arg, resp) -> (state', ok)``, fuses the model's
transition with its postcondition.  It comes in two forms:

* ``step_py``    — pure-Python ints, used by the host oracle, the
  generator and witness replay.  This is the parity reference.
* ``step_torch`` — the same function on int32 tensors of any (broadcast)
  batch shape, branchless, used to build the per-history step tables the
  device search gathers from.

Model state is a fixed-length int32 vector (``STATE_DIM``).  A scalar spec
(``STATE_DIM == 1``) declares a bound on its reachable states
(``scalar_state_bound``), which is what lets the device tabulate it; a
vector spec declares per-element bounds (``state_elem_bounds``) and the
device tabulates its packed scalar shadow (``ops/scalarize.py``).  For a
vector spec ``step_torch`` takes and returns the state with its elements
on a trailing axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CmdSig:
    """Signature of one command: args drawn from ``[0, n_args)``,
    responses in ``[0, n_resps)``."""

    name: str
    n_args: int
    n_resps: int


class Spec:
    """Base class for state-machine specifications.

    Subclasses define ``CMDS``, ``STATE_DIM``, ``initial_state()``,
    ``step_py`` and ``step_torch``, and optionally ``gen_cmd`` and
    ``scalar_state_bound``.  Preconditions are enforced at generation time
    only.
    """

    name: str = "spec"
    CMDS: Tuple[CmdSig, ...] = ()
    STATE_DIM: int = 1

    # -- model ------------------------------------------------------------
    def initial_state(self) -> np.ndarray:
        raise NotImplementedError

    def step_py(self, state: Sequence[int], cmd: int, arg: int, resp: int
                ) -> Tuple[Sequence[int], bool]:
        raise NotImplementedError

    def step_torch(self, state, cmd, arg, resp):
        """``(next_state, ok)`` for int32 tensors that broadcast together.
        For a scalar spec ``state`` is the state itself and both outputs
        have the broadcast shape; for a vector spec ``state`` is
        ``[..., STATE_DIM]``, ``next_state`` likewise and ``ok`` drops the
        trailing axis.  ``next_state`` is int32, ``ok`` bool."""
        raise NotImplementedError

    # -- generation -------------------------------------------------------
    def precondition(self, state: Sequence[int], cmd: int, arg: int) -> bool:
        return True

    def gen_cmd(self, rng, state: Optional[Sequence[int]] = None
                ) -> Tuple[int, int]:
        """A random (cmd, arg) whose precondition holds in ``state``:
        uniform over the alphabet, rejection-sampled (bounded tries)."""
        cmd = arg = 0
        for _ in range(32):
            cmd = rng.randrange(len(self.CMDS))
            arg = rng.randrange(self.CMDS[cmd].n_args)
            if state is None or self.precondition(state, cmd, arg):
                break
        return cmd, arg

    def shrink_arg(self, cmd: int, arg: int):
        """Candidate smaller args for shrinking (toward 0)."""
        out = []
        if arg > 0:
            out.append(0)
        if arg > 1:
            out.append(arg // 2)
        return out

    # -- device search ----------------------------------------------------
    def scalar_state_bound(self, n_ops: int) -> Optional[int]:
        """Exclusive upper bound on the scalar states reachable through ok
        steps whose ARGS lie in the declared domains (resps arbitrary), or
        None.  The device backend needs one to tabulate the spec."""
        return None

    def state_elem_bounds(self) -> Optional[Sequence[int]]:
        """Per-element exclusive upper bounds on the state vector, or None.

        The contract: the initial state is within bounds, and from any
        state within bounds every ok step whose ARG is in the declared
        command domains (resps arbitrary) yields a state within bounds.
        Declaring it lets the device pack small vector states into one
        scalar (``ops/scalarize.py``) and tabulate the packed spec; the
        packing is a bijection, so verdicts are unchanged."""
        return None

    def resp_domain(self, cmd: int) -> range:
        return range(self.CMDS[cmd].n_resps)

    def sweep_kernel(self):
        """``(kind, params, data)`` selecting the model's step code inside
        the ``stepper_sweep`` kernel (``csrc/stepper_sweep.cu``), or None.
        ``params`` is a tuple of at most three ints, ``data`` None or an
        int32 array the kernel reads from device memory.  A spec without
        one runs the sweep regime only through the plain version, on the
        CPU."""
        return None

    # -- persistence ------------------------------------------------------
    def spec_kwargs(self) -> dict:
        """Constructor kwargs that reproduce this spec exactly."""
        return {}


def broadcast_vector(state, *ops):
    """``state`` ``[..., D]`` and the op tensors broadcast together:
    ``(state [..., D], op [...], ...)``, expanded views."""
    shape = torch.broadcast_shapes(state.shape[:-1], *(o.shape for o in ops))
    return (state.expand(*shape, state.shape[-1]),
            *(o.expand(shape) for o in ops))


def jax_index(idx, n: int):
    """The element a dynamic index reads in an axis of ``n``, as the JAX
    package's array indexing reads it: a negative index counts from the
    end, then the index is clamped into ``[0, n)``."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def take_elem(state, idx):
    """``state[..., idx]`` per batch element, ``idx`` shaped as
    ``state[..., 0]``, read as :func:`jax_index` reads it."""
    i = jax_index(idx, state.shape[-1]).long()
    return torch.gather(state, -1, i[..., None]).squeeze(-1)


def floor_div(x, d: int):
    return torch.div(x, d, rounding_mode="floor")
