"""``qsm_tpu_torch.fleet``: the multi-node tier's durable half.

The counterpart of the JAX package's ``qsm_tpu/fleet``.  Ported so far:
``replog`` (:class:`SegmentedLog`, :func:`segment_fingerprint`), the
segmented verdict bank that ``serve/cache.py::VerdictCache(store=)`` and
the device-work queue persist into.  The router, membership, lease and
gossip modules wait for the fleet tier (ROADMAP A7).
"""

from .replog import SegmentedLog, segment_fingerprint

__all__ = ["SegmentedLog", "segment_fingerprint"]
