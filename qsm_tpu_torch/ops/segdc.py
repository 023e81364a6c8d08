"""Quiescent cuts of a history.

The counterpart of ``split_at_quiescent_cuts`` in the JAX package's
``qsm_tpu/ops/segdc.py``; the segment-wise checker built on it (``SegDC``)
is not ported yet.  ``search/planner.py::profile_corpus`` counts segments
with it.
"""

from __future__ import annotations

from typing import List

from ..core.history import History, Op


def split_at_quiescent_cuts(history: History) -> List[List[Op]]:
    """Invoke-ordered segments; a cut sits before op i iff every earlier
    op's response_time < op i's invoke_time.  Pending ops (sentinel
    response_time) forbid all later cuts, so they always land in the final
    segment."""
    ops = sorted(history.ops, key=lambda o: o.invoke_time)
    segments: List[List[Op]] = []
    current: List[Op] = []
    max_resp = -1
    for op in ops:
        if current and max_resp < op.invoke_time:
            segments.append(current)
            current = []
        current.append(op)
        max_resp = max(max_resp, op.response_time)
    if current:
        segments.append(current)
    return segments
