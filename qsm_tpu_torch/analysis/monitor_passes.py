"""Monitor passes (pass family *k*; the counterpart of
``qsm_tpu/analysis/monitor_passes.py``): session bounds.

A monitor session is a LONG-LIVED accumulator by design — events arrive
for as long as the monitored system runs — so the plane's one structural
promise is that nothing it accumulates is unbounded: event logs are
capped, frontier state sets are capped, and committed-prefix ops are
EVICTED from the windows (qsm_tpu_torch/monitor module docstrings).  A session
buffer grown without a cap or eviction is the failure mode that turns
one quiet production monitor into an OOM of the whole serving plane a
week later.

* ``QSM-MON-UNBOUNDED`` (error) — a class whose instance-attribute
  container GROWS (``self.X.append/extend/add/insert``, or
  ``heapq.heappush(self.X, …)``) while NOTHING in the class either
  compares against a bound wherever that attribute is involved (a cap
  check like ``len(self.X) >= self.max_events``) or evicts from it
  (``self.X.pop/popitem/clear``, ``heappop(self.X)``, ``del
  self.X[…]``, or a pruning reassignment ``self.X = self.X[cut:]`` —
  the decided-prefix eviction shape).  Scope is the CLASS: the grow
  site and its discipline legitimately live in different methods
  (``append`` checks the cap, ``_apply`` grows).

The class scan is ``astutil.scan_class`` (the reference keeps it in
this module as ``_scan_class``): families (m) and (o) ride the same
definition of "bounded".

Scan set: qsm_tpu_torch/monitor/ + qsm_tpu_torch/ingest/.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .astutil import parse_module, relpath_of, scan_class
from .findings import ERROR, Finding


def check_monitor_file(path: str, root: Optional[str] = None
                       ) -> List[Finding]:
    tree = parse_module(path)
    relpath = relpath_of(path, root)
    out: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        scan = scan_class(cls)
        for attr, (fn_name, lineno, how) in sorted(scan.grows.items()):
            if attr in scan.disciplined:
                continue
            out.append(Finding(
                ERROR, "QSM-MON-UNBOUNDED",
                f"{relpath}:{cls.name}.{fn_name}:{lineno}",
                f"session buffer self.{attr} grows ({how}) with no cap "
                "comparison or eviction anywhere in the class — a "
                "long-lived monitor session accumulates it until the "
                "serving plane OOMs",
                "compare its size against an explicit bound before "
                "growing (session.py max_events is the model) or evict "
                "decided-prefix entries (frontier.py's window "
                "reassignment)"))
    return out
