"""``qsm_tpu_torch.devq``: the device-work queue and its drain.

The counterpart of the JAX package's ``qsm_tpu/devq``.  Planes bank work
into a :class:`.queue.DeviceWorkQueue` at their seams (serve admission,
the per-key split, shrink rounds, monitor flips, the planner); a
:class:`.drain.DrainScheduler` spends a device window, a deadline on the
card, on the backlog and banks every oracle-re-proved verdict under the
fingerprint the originating plane will hit next.  The wire ops
``devq.put`` / ``devq.digests`` / ``devq.pull`` / ``devq.drain_report``
are the server's (``serve/server.py``).
"""

from .drain import DEFAULT_WINDOW_S, DrainScheduler
from .queue import (DEFAULT_CAP, PLANES, DeviceWorkQueue, WorkItem,
                    bank_histories, global_devq, item_fingerprint,
                    note_device_plan, set_global_devq)

__all__ = [
    "DEFAULT_CAP",
    "DEFAULT_WINDOW_S",
    "DeviceWorkQueue",
    "DrainScheduler",
    "PLANES",
    "WorkItem",
    "bank_histories",
    "global_devq",
    "item_fingerprint",
    "note_device_plan",
    "set_global_devq",
]
