"""``qsm_tpu_torch.serve``: linearizability checking as a long-lived
service.

The counterpart of the JAX package's ``qsm_tpu/serve``, the serving plane
over the other planes (admission → micro-batch → dispatch → cache):

* ``protocol``  — the JSON-lines wire format (the one external
  history-row encoding) over TCP / UNIX sockets;
* ``server``    — :class:`CheckServer`: one warm engine a spec behind
  ``resilience.FailoverBackend``, on the card unless ``device="cpu"``;
* ``batcher``   — cross-request micro-batching into fixed-width padded
  lanes, with a ``why`` stamp a batch;
* ``cache``     — the fingerprint-keyed verdict / witness LRU with its
  persistent bank (a single file, or ``fleet/replog.py``'s segments);
* ``admission`` — bounded in-flight lanes, per-request deadlines from the
  policy presets, explicit ``SHED``;
* ``pool``      — :class:`WorkerPool`: supervised host worker processes
  (``workers=N``, ``device="cpu"``) with crash / wedge shedding,
  re-dispatch of undecided lanes, bounded respawn and quarantine;
* ``client``    — :class:`CheckClient` and :class:`SessionHandle`.
"""

from .admission import AdmissionController
from .batcher import Lane, MicroBatcher
from .cache import CacheEntry, VerdictCache, fingerprint_key
from .client import CheckClient, SessionHandle
from .pool import (WorkerDead, WorkerFault, WorkerPool, WorkerTimeout)
from .protocol import (VERDICT_NAMES, history_to_rows, parse_address,
                       rows_to_history)
from .server import CheckServer

__all__ = [
    "AdmissionController", "CacheEntry", "CheckClient", "CheckServer",
    "Lane", "MicroBatcher", "VERDICT_NAMES", "VerdictCache",
    "WorkerDead", "WorkerFault", "WorkerPool", "WorkerTimeout",
    "SessionHandle", "fingerprint_key", "history_to_rows",
    "parse_address", "rows_to_history",
]
