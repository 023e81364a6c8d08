"""``qsm_tpu_torch.serve``: the serving plane's verdict cache.

The counterpart of the part of the JAX package's ``qsm_tpu/serve`` that
the shrinker needs: :func:`fingerprint_key`, :class:`CacheEntry` and
:class:`VerdictCache` (``cache.py``).  The rest of that plane (protocol,
server, batcher, admission, worker pool, client) is not ported yet.
"""

from .cache import CacheEntry, VerdictCache, fingerprint_key

__all__ = ["CacheEntry", "VerdictCache", "fingerprint_key"]
