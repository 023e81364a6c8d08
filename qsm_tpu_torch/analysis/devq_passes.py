"""Device-work-queue passes (pass family *o*; the counterpart of
``qsm_tpu/analysis/devq_passes.py``): window-arbitrage discipline.

The devq plane (qsm_tpu_torch/devq) banks device-worthy work into a
persistent queue from every plane, and a window on the card drains it.  Two structural
promises make that safe, and both are statically checkable:

* ``QSM-DEVQ-UNBOUNDED`` (error) — the queue is fed by EVERY plane,
  forever, so a class in the devq scan set whose instance-attribute
  container GROWS (``self.X.append/extend/add/insert``, or
  ``heapq.heappush(self.X, …)``) with no cap comparison or eviction
  anywhere in the class is the one-quiet-week-to-OOM pathology the
  monitor plane's family (k) gates, recurring at the fleet's shared
  choke point.  The structural scan IS family (k)'s
  (``astutil.scan_class`` — one definition of "bounded", several
  planes held to it), with family (m)'s ownership refinement:
  growth is only attributed to attributes the class itself owns as
  raw container literals; ``self.log.append(…)`` where ``log`` is a
  ``SegmentedLog()`` is delegation, gated at the delegate.

* ``QSM-DEVQ-DRAIN`` (error) — a window can close at ANY moment (the
  chip is snatched back), so every ``while`` loop inside a function
  whose name contains ``drain`` must consult the window deadline
  INSIDE the loop — a mention of ``deadline`` / ``remaining`` /
  ``window_end`` / ``time_left`` in the loop test or body.  A drain
  loop without one runs until the queue empties, wedging the process
  on a chip it no longer owns — the exact hang the probe layer exists
  to prevent, reintroduced one layer up.  ``for`` loops are exempt:
  iteration over a materialized collection is bounded by
  construction; the hazard is open-ended re-polling.

Scan set: qsm_tpu_torch/devq/ (queue, drain).
(monitor/session.py also has a ``_drain`` — its reorder buffer flush,
a different plane's discipline — and is deliberately NOT in this scan
set.)
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional

from .astutil import parse_module, scan_class
from .findings import ERROR, Finding
from .gen_passes import _raw_container_attrs

#: Identifier substrings that count as "the loop consulted the window
#: deadline".  Matched against Name ids and Attribute attrs, so both
#: ``remaining = self._remaining_s()`` and ``now() < self.window_end``
#: satisfy the discipline.
_DEADLINE_HINTS = ("deadline", "remaining", "window_end", "time_left")


def _mentions_deadline(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        if name is not None:
            low = name.lower()
            if any(h in low for h in _DEADLINE_HINTS):
                return True
    return False


def check_devq_file(path: str, root: Optional[str] = None
                    ) -> List[Finding]:
    tree = parse_module(path)
    relpath = path
    if root:
        try:
            relpath = os.path.relpath(path, root)
        except ValueError:
            pass
    out: List[Finding] = []
    # --- QSM-DEVQ-UNBOUNDED: family (k)'s class scan, family (m)'s
    # ownership refinement, this plane's rule id -----------------------
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        scan = scan_class(cls)
        owned = _raw_container_attrs(cls)
        for attr, (fn_name, lineno, how) in sorted(scan.grows.items()):
            if attr in scan.disciplined or attr not in owned:
                continue
            out.append(Finding(
                ERROR, "QSM-DEVQ-UNBOUNDED",
                f"{relpath}:{cls.name}.{fn_name}:{lineno}",
                f"device-work accumulator self.{attr} grows ({how}) "
                "with no cap comparison or eviction anywhere in the "
                "class — every plane on every fleet node feeds this "
                "container, so it grows until the node OOMs",
                "compare its size against an explicit bound before "
                "growing or evict past the cap (queue.py "
                "DeviceWorkQueue._evict_over_cap is the model; done "
                "tombstones make eviction safe to re-bank)"))
    # --- QSM-DEVQ-DRAIN: while-loops in drain functions must consult
    # the window deadline ----------------------------------------------
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if "drain" not in fn.name.lower():
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.While):
                continue
            if _mentions_deadline(node):
                continue
            out.append(Finding(
                ERROR, "QSM-DEVQ-DRAIN",
                f"{relpath}:{fn.name}:{node.lineno}",
                f"drain loop in {fn.name}() never consults the window "
                "deadline — a snatched-away chip leaves it running "
                "until the queue empties, wedging the drainer on a "
                "device it no longer owns",
                "consult the remaining window time inside the loop "
                "(drain.py DrainScheduler.drain's `remaining = "
                "self._remaining_s()` break is the model) and degrade "
                "to the host ladder past the deadline"))
    return out
