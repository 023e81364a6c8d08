"""State-machine specification protocol.

A spec is a small class over integer domains whose one function,
``step(state, cmd, arg, resp) -> (state', ok)``, fuses the model's
transition with its postcondition.  It comes in two forms:

* ``step_py``    — pure-Python ints, used by the host oracle, the
  generator and witness replay.  This is the parity reference.
* ``step_torch`` — the same function on int32 tensors of any (broadcast)
  batch shape, branchless, used to build the per-history step tables the
  device search gathers from.

Model state is a fixed-length int32 vector (``STATE_DIM``); the specs of
this package are scalar (``STATE_DIM == 1``) and declare a bound on their
reachable states (``scalar_state_bound``), which is what lets the device
tabulate them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


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
        """``(next_state, ok)`` for int32 tensors that broadcast together;
        ``state`` is the scalar state itself (``STATE_DIM == 1``).  Returns
        int32 ``next_state`` and bool ``ok`` of the broadcast shape."""
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

    def resp_domain(self, cmd: int) -> range:
        return range(self.CMDS[cmd].n_resps)
