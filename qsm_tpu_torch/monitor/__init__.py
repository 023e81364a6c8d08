"""qsm_tpu_torch.monitor — linearizability monitoring as a live service.

The counterpart of the JAX package's ``qsm_tpu/monitor``.

The streaming plane (docs/MONITOR.md): sessions accumulate a running
system's invocation/response events, an incremental frontier
(``frontier.py`` — the forward-running twin of ops/segdc.py's
quiescent-cut algebra) decides each prefix the moment it is decidable,
decided prefixes bank in the serve verdict cache under rolling prefix
fingerprints, and a verdict flip is pushed with a shrink-plane-minimized
repro.  ``session.py`` owns event validation/ordering and the bounded
session registry, ``store.py`` durable sessions.  Each ``decide()``
re-checks every touched window from its frontier states as one batch of
lanes on the card (``TorchStepper`` with ``init_states``); the check
server and the fleet router that serve sessions over the wire are not
ported yet.
"""

from .frontier import (IncrementalFrontier, PrefixHasher,
                       decode_frontier_states, encode_frontier_states)
from .session import (DEFAULT_MAX_EVENTS, DEFAULT_MAX_SESSIONS,
                      MonitorSession, SessionError, SessionLimit,
                      SessionManager)
from .store import SessionStore

__all__ = [
    "IncrementalFrontier", "PrefixHasher", "MonitorSession",
    "SessionManager", "SessionError", "SessionLimit", "SessionStore",
    "encode_frontier_states", "decode_frontier_states",
    "DEFAULT_MAX_EVENTS", "DEFAULT_MAX_SESSIONS",
]
