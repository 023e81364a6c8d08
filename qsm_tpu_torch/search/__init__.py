"""qsm_tpu_torch.search: the search-cost plane.

The counterpart of the JAX package's ``qsm_tpu/search``:

* :mod:`.stats`: ``SearchStats``, the cost record every engine exposes
  (``search_stats()``), ``stats_delta`` and ``collect_search_stats``;
* :mod:`.ordering`: postcondition-aware candidate ordering, per-spec
  selectivity ranks that put the most constrained ops first;
* :mod:`.planner`: ``CorpusProfile`` / ``profile_corpus``, and
  ``SearchPlan`` / ``plan_search`` / ``build_backend``: chunk schedule,
  bucket ladder, memo slots, ordering and decomposition picked from
  corpus statistics and platform (the port's own plan on the card), and
  ``build_host_backend``, the same plan's host shape.

Nothing in this package changes a verdict, only iteration and node
counts.
"""

from .ordering import OrderingTable, ordering_table, permute_history
from .planner import (CorpusProfile, SearchPlan, build_backend,
                      build_host_backend, plan_search, profile_corpus)
from .stats import SearchStats, collect_search_stats, stats_delta

__all__ = [
    "CorpusProfile",
    "OrderingTable",
    "SearchPlan",
    "SearchStats",
    "build_backend",
    "build_host_backend",
    "collect_search_stats",
    "ordering_table",
    "permute_history",
    "plan_search",
    "profile_corpus",
    "stats_delta",
]
