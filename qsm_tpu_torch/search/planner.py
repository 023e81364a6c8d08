"""Corpus statistics: ``CorpusProfile`` and ``profile_corpus``.

The counterpart of the JAX package's ``qsm_tpu/search/planner.py``, its
corpus half only: what a planner (and the steering loop's shape score,
``gen/steer.py``) may know about a workload.  The plan itself
(``SearchPlan``, ``plan_search``, ``build_backend``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..core.history import History


@dataclasses.dataclass(frozen=True)
class CorpusProfile:
    """What the planner is allowed to know about the workload."""

    n: int = 0
    max_ops: int = 0
    mean_ops: float = 0.0
    pending_fraction: float = 0.0
    cut_fraction: float = 0.0    # histories with ≥1 quiescent cut
    mean_segments: float = 1.0   # segments per history
    # per-key decomposition shape (only measured when profile_corpus is
    # given a spec whose projection VALIDATES — ops/pcomp.py): the
    # longest per-key sub-history across the corpus, and the mean number
    # of keys a history splits into.  sub_max_ops == 0 means "not
    # measured" — the decompose_keys gate then stays off.
    sub_max_ops: int = 0
    mean_partitions: float = 0.0
    # segment density OF THE SUB-HISTORIES (segments per per-key
    # sub-history): what the inner kernel actually sees when
    # decompose_keys is on — the segdc gate must be judged on this, not
    # on the whole-history density above.
    # 0.0 means "not measured" (no spec / invalid projection).
    sub_mean_segments: float = 0.0


def profile_corpus(histories: Sequence[History],
                   spec=None) -> CorpusProfile:
    """Corpus statistics; pass ``spec`` to also measure the per-key
    decomposition shape (sub-history lengths) when the spec declares a
    valid projection — the planner's ``decompose_keys`` gate needs it."""
    from ..ops.segdc import split_at_quiescent_cuts

    if not histories:
        return CorpusProfile()
    lens = [len(h) for h in histories]
    segs = [len(split_at_quiescent_cuts(h)) for h in histories]
    sub_max = 0
    mean_parts = 0.0
    sub_mean_segs = 0.0
    if spec is not None:
        from ..core.spec import projection_report
        from ..ops.pcomp import split_history

        if not projection_report(spec):
            # ONE split per history yields all three decomposition
            # statistics: the longest sub-history (compile-bucket
            # gate), the key count, and the decomposed corpus's own
            # segment profile — what segdc would see UNDER the per-key
            # split (the decompose gate's input when decompose_keys
            # fires)
            parts = []
            sub_segs = []
            for h in histories:
                subs = split_history(spec, h)
                parts.append(len(subs))
                for s in subs.values():
                    sub_max = max(sub_max, len(s))
                    sub_segs.append(len(split_at_quiescent_cuts(s)))
            mean_parts = sum(parts) / len(histories)
            if sub_segs:
                sub_mean_segs = sum(sub_segs) / len(sub_segs)
    return CorpusProfile(
        n=len(histories),
        max_ops=max(lens),
        mean_ops=sum(lens) / len(histories),
        pending_fraction=(sum(h.n_pending > 0 for h in histories)
                          / len(histories)),
        cut_fraction=sum(s > 1 for s in segs) / len(histories),
        mean_segments=sum(segs) / len(histories),
        sub_max_ops=sub_max,
        mean_partitions=mean_parts,
        sub_mean_segments=sub_mean_segs,
    )
