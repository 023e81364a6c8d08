"""Scalarization: pack a small vector state into one scalar.

The device search tabulates a spec's step function per history (an
``[S, N]`` table of next states and postconditions), which needs a scalar
state with a bound ``S``.  A vector spec that declares per-element bounds
(``Spec.state_elem_bounds``) embeds its states injectively into ``[0,
prod(bounds))`` by mixed-radix packing; :class:`Scalarized` is that scalar
spec, ``step`` = unpack → inner step → pack.  The packing is a bijection
between in-bound vector states and their images, so the search tree, the
candidate order and the verdict are those of the inner spec.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.spec import Spec

# The largest packed domain that gets a shadow.  This is not a speed
# constant: it decides which regime a spec takes (table or not) and so the
# memo key width, and it must stay equal to the JAX package's
# ``MAX_PACKED_STATES`` so that the port searches the same tree with the
# same keys (and the same memo collisions) as the reference backend.
MAX_PACKED_STATES = 65_536


class Scalarized(Spec):
    """Scalar shadow of a vector spec with declared element bounds."""

    STATE_DIM = 1

    def __init__(self, inner: Spec):
        bounds = inner.state_elem_bounds()
        if bounds is None or inner.STATE_DIM != len(bounds):
            raise ValueError(
                f"{inner.name}: state_elem_bounds must give one exclusive "
                f"bound per state element to scalarize")
        self.inner = inner
        self.bounds = [int(b) for b in bounds]
        self.CMDS = inner.CMDS
        self.name = f"scalarized({inner.name})"
        # mixed-radix place values: element i contributes state[i]*radix[i]
        self.radix = [1] * len(self.bounds)
        for i in range(1, len(self.bounds)):
            self.radix[i] = self.radix[i - 1] * self.bounds[i - 1]
        self.n_packed = self.radix[-1] * self.bounds[-1]

    # -- packing ----------------------------------------------------------
    def pack(self, state: Sequence[int]) -> int:
        if len(state) != len(self.bounds):
            raise ValueError(
                f"state has {len(state)} elements, spec declares "
                f"{len(self.bounds)}")
        total = 0
        for v, r, b in zip(state, self.radix, self.bounds):
            v = int(v)
            if not 0 <= v < b:
                raise ValueError(
                    f"state element {v} outside declared bound {b}")
            total += v * r
        return total

    def unpack(self, packed: int) -> list:
        out = []
        for b in self.bounds:
            out.append(packed % b)
            packed //= b
        return out

    def in_bounds(self, state: Sequence[int]) -> bool:
        return (len(state) == len(self.bounds)
                and all(0 <= int(v) < b
                        for v, b in zip(state, self.bounds)))

    # -- Spec protocol ----------------------------------------------------
    def initial_state(self) -> np.ndarray:
        return np.asarray([self.pack(self.inner.initial_state())], np.int32)

    def scalar_state_bound(self, n_ops):
        return self.n_packed

    def step_py(self, state, cmd, arg, resp):
        vec, ok = self.inner.step_py(self.unpack(int(state[0])), cmd, arg,
                                     resp)
        return [self.pack(vec)], ok

    def step_torch(self, state, cmd, arg, resp):
        """Packed ``state`` (any shape broadcasting with the command
        tensors) → unpack onto a trailing axis → inner ``step_torch`` →
        pack.  Floor division and remainder, as the reference's ``//`` and
        ``%``, so a negative packed state unpacks as it does there."""
        shape = torch.broadcast_shapes(state.shape, cmd.shape, arg.shape,
                                       resp.shape)
        packed = state.expand(shape)
        vec = []
        for b in self.bounds:
            vec.append(torch.remainder(packed, b))
            packed = torch.div(packed, b, rounding_mode="floor")
        nxt, ok = self.inner.step_torch(
            torch.stack(vec, dim=-1).to(torch.int32), cmd, arg, resp)
        total = torch.zeros(shape, dtype=torch.int32, device=state.device)
        for i, r in enumerate(self.radix):
            total = total + nxt[..., i].to(torch.int32) * r
        return total, ok


def scalar_shadow(spec: Spec, max_states: int = MAX_PACKED_STATES
                  ) -> Optional[Scalarized]:
    """A :class:`Scalarized` shadow of ``spec`` if it declares element
    bounds and the packed domain has at most ``max_states`` states, else
    None (a scalar spec needs no shadow)."""
    if spec.STATE_DIM == 1:
        return None
    bounds = spec.state_elem_bounds()
    if bounds is None:
        return None
    n = 1
    for b in bounds:
        n *= int(b)
        if n > max_states:
            return None
    return Scalarized(spec)
