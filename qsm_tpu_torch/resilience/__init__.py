"""``qsm_tpu_torch.resilience``: keeping runs alive when the hardware is
not.  The counterpart of the JAX package's ``qsm_tpu/resilience``:

* ``policy``: one :class:`RetryPolicy`, the named :data:`PRESETS` and the
  :func:`watchdog` bounded call;
* ``failover``: :class:`FailoverBackend`, the device majority while the
  device lives and the exact host ladder the moment it does not, with the
  card's rule (on CUDA only an injected fault degrades);
* ``faults``: the ``QSM_TPU_FAULTS`` fault plane (hang / raise / wedge at
  named sites), so that every degradation path runs on the CPU;
* ``checkpoint``: :func:`atomic_write_json` and :class:`CellJournal`.
"""

from .checkpoint import CellJournal, atomic_write_json, atomic_write_text
from .failover import FailoverBackend, collect_resilience, host_fallback
from .faults import FaultPlane, InjectedFault, active_plane, inject
from .policy import (PRESETS, RetryPolicy, WatchdogTimeout, preset,
                     watchdog)

__all__ = [
    "RetryPolicy", "PRESETS", "preset", "watchdog", "WatchdogTimeout",
    "FailoverBackend", "collect_resilience",
    "host_fallback", "FaultPlane", "InjectedFault", "active_plane",
    "inject", "CellJournal", "atomic_write_json", "atomic_write_text",
]
