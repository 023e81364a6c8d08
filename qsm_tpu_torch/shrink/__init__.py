"""``qsm_tpu_torch.shrink``: the batched history shrinker.

The counterpart of the JAX package's ``qsm_tpu/shrink``.  It minimises a
failing history (not the program): the whole shrink frontier, op-subset
shrinks (drop-one, drop-pid, drop-key through the validated ``KeyProj``
projection) and schedule shrinks (commuting adjacent non-overlapping
ops), is built on the host, deduplicated against a fingerprint memo,
decided in one batched dispatch a round (on the card, one
``check_histories`` of a device checker), and the smallest still-failing
candidate is taken greedily.  The result is a 1-minimal history and a
certificate, one ``verify_witness``-replayable linearization a drop-one
neighbour.

Entry points: ``shrink_history`` (in process), ``prop_concurrent``'s
``minimize_history``, ``run --minimize`` and the ``shrink`` subcommand;
the ``shrink_*`` counters of ``SearchStats``.
"""

from .frontier import Candidate, inversions, shrink_frontier
from .shrinker import (ShrinkResult, Shrinker, collect_shrink_stats,
                       minimality_certificate, shrink_history,
                       verify_certificate)

__all__ = [
    "Candidate",
    "ShrinkResult",
    "Shrinker",
    "collect_shrink_stats",
    "inversions",
    "minimality_certificate",
    "shrink_frontier",
    "shrink_history",
    "verify_certificate",
]
