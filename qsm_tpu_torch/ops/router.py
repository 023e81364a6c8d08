"""Per-history strategy routing: the ``auto-stepper`` backend.

The counterpart of the JAX package's ``qsm_tpu/ops/router.py``.  No
fixed device strategy is right for every history: quiescent-cut
segmentation (``SegDC``) suits histories that shatter into many small
segments (the device then works in a small op bucket and the host
enumeration of each middle segment is trivial), but costs more than the
plain kernel on concurrency-dense histories whose largest segment is
nearly the whole history.

The router reads each history's structure from
``split_at_quiescent_cuts`` and partitions the batch.  The cost of
SegDC's host enumeration grows with a middle segment's **width** (the
most mutually overlapping ops: the branching of the end-state walk), not
its length:

* **plain** (``TorchStepper``): histories with no cut, or with a middle
  segment wider than the cap;
* **segdc** (``SegDC`` over the SAME ``TorchStepper`` instance): cut
  histories whose middle segments are all narrow; the host walks them
  and the device decides only the short final segments from the
  threaded frontier.

A spec that declares a per-key projection is decomposed first through
``PComp``, with a nested router on the projected spec; a refused
declaration (``NotDecomposableError``) falls back to whole-history
routing.

Both routes are exact (BUDGET_EXCEEDED, never a guess), so routing
changes cost only.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from ..core.history import History
from ..core.spec import Spec
from .backend import LineariseBackend
from .segdc import SegDC, split_at_quiescent_cuts


def _width(ops) -> int:
    """The most mutually overlapping ops in a segment (a sweep over the
    invoke and response endpoints)."""
    events = []
    for o in ops:
        events.append((o.invoke_time, 1))
        events.append((o.response_time, -1))
    # a response at t sorts before an invoke at t: they do not overlap
    # (precedes_matrix's strict <)
    events.sort(key=lambda e: (e[0], e[1]))
    width = peak = 0
    for _, d in events:
        width += d
        peak = max(peak, width)
    return peak


class AutoDevice:
    """Backend combinator: route each history to the cheaper device
    strategy by its segment structure (module docstring).  ``inner_kw``
    goes to the default inner, ``TorchStepper(spec, **inner_kw)``
    (``device="cpu"`` runs its plain versions)."""

    # The widest middle segment the host will enumerate: the Python walk
    # (WIDTH_CAP) and the native enumerator (NATIVE_WIDTH_CAP, bounding
    # the 2^width state x mask growth of its memo).  These are the JAX
    # package's values, from its CPU-platform measurements, kept so that
    # both packages route alike; they are not claimed for the card.  A
    # cap changes cost, never a verdict; chip_smoke.py phase 16 (b)
    # prints each route's time by middle width, the numbers a retune on
    # the card would use.
    WIDTH_CAP = 4
    NATIVE_WIDTH_CAP = 12

    def __init__(self, spec: Spec,
                 make_inner: Optional[Callable] = None,
                 width_cap: Optional[int] = None,
                 **inner_kw):
        from .stepper import TorchStepper

        self.spec = spec
        # an explicit cap overrides both class defaults
        self._width_cap_override = width_cap
        make = make_inner or (lambda s: TorchStepper(s, **inner_kw))
        self.pcomp = None
        if hasattr(spec, "projected_spec"):
            # per key first, each sub-history routed by a nested router
            # on the projected spec; a refused declaration falls back to
            # whole-history routing, never an unsound split
            from .pcomp import NotDecomposableError, PComp

            try:
                self.pcomp = PComp(
                    spec, make_inner=lambda s: AutoDevice(
                        s, make_inner=make, width_cap=width_cap))
            except NotDecomposableError:
                self.pcomp = None
            else:
                self.name = f"auto({self.pcomp.name})"
                return
        self.plain: LineariseBackend = make(spec)
        # the same engine serves as SegDC's inner backend; SegDC's
        # default middle enumerator prefers the native checker
        self.segdc = SegDC(spec, make_inner=lambda s: self.plain)
        self._native_mid = hasattr(self.segdc.oracle, "end_states")
        self.name = f"auto({self.plain.name})"
        self.routed_plain = 0
        self.routed_segdc = 0

    def _route_segdc(self, h: History) -> bool:
        segs = split_at_quiescent_cuts(h)
        if len(segs) < 2:
            return False
        cap = self._width_cap_override
        if cap is None:
            cap = (self.NATIVE_WIDTH_CAP if self._native_mid
                   else self.WIDTH_CAP)
        return all(_width(seg) <= cap for seg in segs[:-1])

    def search_stats(self):
        """Both routes' cost under one engine name.  SegDC shares the
        plain route's engine, so its record (which absorbs that engine)
        covers both routes' device work; ``histories`` is the router's own
        routed total (the engine counts lanes after pending expansion,
        and SegDC only its route)."""
        from ..resilience.failover import collect_resilience
        from ..search.stats import SearchStats, collect_search_stats

        if self.pcomp is not None:
            st = collect_search_stats(self.pcomp) or SearchStats()
            st.engine = self.name
            return st
        st = self.segdc.search_stats()
        st.histories = self.routed_plain + self.routed_segdc
        st.engine = self.name
        r = collect_resilience(self.plain)
        st.degradations += r.get("degradations", 0)
        st.retries += r.get("retries", 0)
        if not st.fallback_engine and r.get("fallback_engine"):
            st.fallback_engine = r["fallback_engine"]
        return st

    def resilience(self) -> dict:
        """Counters of whichever engine dispatches."""
        from ..resilience.failover import collect_resilience

        inner = self.pcomp if self.pcomp is not None else self.plain
        return collect_resilience(inner)

    def check_histories(self, spec: Spec, histories: Sequence[History]
                        ) -> np.ndarray:
        assert spec is self.spec, "AutoDevice is bound to one spec"
        if self.pcomp is not None:
            return self.pcomp.check_histories(spec, histories)
        out = np.empty(len(histories), np.int8)
        seg_idx: List[int] = []
        plain_idx: List[int] = []
        for i, h in enumerate(histories):
            (seg_idx if self._route_segdc(h) else plain_idx).append(i)
        self.routed_plain += len(plain_idx)
        self.routed_segdc += len(seg_idx)
        if plain_idx:
            sub = self.plain.check_histories(
                spec, [histories[i] for i in plain_idx])
            for i, v in zip(plain_idx, sub):
                out[i] = v
        if seg_idx:
            sub = self.segdc.check_histories(
                spec, [histories[i] for i in seg_idx])
            for i, v in zip(seg_idx, sub):
                out[i] = v
        return out
