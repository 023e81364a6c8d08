"""Generation passes (pass family *m*; the counterpart of
``qsm_tpu/analysis/gen_passes.py``): campaign accumulator bounds.

A fuzzing campaign is open-ended BY DESIGN — the steering loop
(qsm_tpu_torch/gen/steer.py) runs for as many rounds as a budget allows, and
a fleet soak (gen/fleet.py) for as long as an operator leaves it
running — so everything the plane retains across rounds must be
bounded: the seed pool is capacity-evicted, kept flip histories are
pruned to a tail window, and audit provenance is capped.  An
accumulator grown once per round without a cap is the failure mode
that turns a week-long soak into an OOM of the machine driving it —
the exact pathology the monitor plane's family (k) gates, recurring
one plane over.

* ``QSM-GEN-UNBOUNDED`` (error) — a class whose instance-attribute
  container GROWS (``self.X.append/extend/add/insert``, or
  ``heapq.heappush(self.X, …)``) while NOTHING in the class either
  compares against a bound wherever that attribute is involved (the
  ``SeedPool.add`` cap shape) or evicts from it (``pop``/``del``/
  ``clear``, or a pruning reassignment ``self.X = self.X[-keep:]`` —
  the kept-flips tail window).  Scope is the CLASS: grow site and
  discipline legitimately live in different methods.

The structural scan is family (k)'s — deliberately: one definition of
"bounded" (``astutil.scan_class``; the reference keeps it in its
monitor family's module), several planes held to it — with one
refinement: growth is only attributed to attributes the
class itself OWNS as raw container literals (``self.X = []`` / ``{}``
/ ``set()`` / ``deque()``).  A ``self.pool.add(…)`` where ``pool`` is
another object (``SeedPool()``) is delegation, and the delegate — in
the scan set itself — is where its bound is gated; double-reporting
it at every call site would punish exactly the encapsulation the
remediation asks for.

Scan set: qsm_tpu_torch/gen/ (core, profile, steer, fleet).
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Set

from .astutil import parse_module, scan_class, self_attr
from .findings import ERROR, Finding

_CONTAINER_CTORS = {"list", "dict", "set", "deque", "defaultdict",
                    "OrderedDict", "Counter"}


def _raw_container_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attributes the class initializes as bare containers — the ones
    whose growth discipline must live in THIS class."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        literal = isinstance(value, (ast.List, ast.Dict, ast.Set,
                                     ast.ListComp, ast.DictComp,
                                     ast.SetComp))
        if isinstance(value, ast.Call):
            fn = value.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            literal = name in _CONTAINER_CTORS
        if not literal:
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Attribute):
                a = self_attr(tgt)
                if a is not None:
                    out.add(a)
    return out


def check_gen_file(path: str, root: Optional[str] = None
                   ) -> List[Finding]:
    tree = parse_module(path)
    relpath = path
    if root:
        try:
            relpath = os.path.relpath(path, root)
        except ValueError:
            pass
    out: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        scan = scan_class(cls)
        owned = _raw_container_attrs(cls)
        for attr, (fn_name, lineno, how) in sorted(scan.grows.items()):
            if attr in scan.disciplined or attr not in owned:
                continue
            out.append(Finding(
                ERROR, "QSM-GEN-UNBOUNDED",
                f"{relpath}:{cls.name}.{fn_name}:{lineno}",
                f"campaign accumulator self.{attr} grows ({how}) with "
                "no cap comparison or eviction anywhere in the class — "
                "an open-ended fuzzing campaign accumulates it once per "
                "round until the driving host OOMs",
                "compare its size against an explicit bound before "
                "growing (steer.py SeedPool.add is the model) or prune "
                "to a tail window by reassignment (the kept-flips "
                "shape)"))
    return out
