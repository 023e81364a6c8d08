"""qsm_tpu_torch.search: the search-cost plane.

The counterpart of the JAX package's ``qsm_tpu/search``, in part:

* :mod:`.stats`: ``SearchStats``, the cost record every engine exposes
  (``search_stats()``), ``stats_delta`` and ``collect_search_stats``;
* :mod:`.planner`: ``CorpusProfile`` and ``profile_corpus``, the corpus
  statistics (the plan itself is not ported yet).

Nothing in this package changes a verdict, only what is counted.
"""

from .planner import CorpusProfile, profile_corpus
from .stats import SearchStats, collect_search_stats, stats_delta

__all__ = ["CorpusProfile", "SearchStats", "collect_search_stats",
           "profile_corpus", "stats_delta"]
