"""Obs passes (pass family *i*; the counterpart of
``qsm_tpu/analysis/obs_passes.py``): trace-plane discipline.

The observability plane (qsm_tpu_torch/obs) has two structural promises the
rest of the stack leans on: every span CLOSES (an entered-never-exited
span leaves a hole in the causal tree and, worse, leaks whatever the
span body holds open), and every metric identity is BOUNDED (a metric
or label minted from per-request data — a history fingerprint, a cache
key — grows the registry without bound and turns the ``/metrics``
scrape into an allocation bomb; Prometheus calls this a cardinality
explosion).  The live code keeps both by construction; this family is
the gate that keeps future obs/serve/resilience code on them.

* ``QSM-OBS-SPAN`` (error) — a ``*.span(...)`` call used neither as a
  ``with`` context expression nor immediately returned (a delegating
  wrapper): a span opened by hand has no exception-safe close, so a
  raise between open and close orphans it.  Sanctioned forms: ``with
  tracer.span(...) as sp:`` (the close is the ``__exit__``), or
  ``return tracer.span(...)`` (the caller's ``with`` owns it).
* ``QSM-OBS-CARDINALITY`` (error) — a metric registration
  (``counter``/``gauge``/``histogram``) whose NAME argument, or a
  metric write (``inc``/``set``/``observe``/``event``/``emit``) whose
  label/attr value, is built dynamically from runtime data (f-string,
  string concatenation/``%``, ``.format()``): metric identity must
  come from a bounded vocabulary (worker ids, flush reasons, verdict
  names), never from per-request values.  ``str(wid)``-style casts of
  bounded values are fine — the rule flags string SYNTHESIS, the
  static marker of identity-from-data.

Span-event ATTRS are exempt from the cardinality rule's name check:
attrs ride the trace log (per-request by design), not the metric
registry.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .astutil import (attr_chain, enclosing_function_map, parse_module,
                      relpath_of)
from .findings import ERROR, Finding

_METRIC_REGISTER = {"counter", "gauge", "histogram"}
_METRIC_WRITE = {"inc", "set", "observe"}


def _is_dynamic_str(node: ast.AST) -> bool:
    """String synthesis: f-string, concat/%-format over strings, or a
    ``.format()`` call — the static marker of identity built from
    runtime data."""
    if isinstance(node, ast.JoinedStr):
        return any(isinstance(v, ast.FormattedValue) for v in node.values)
    if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                  (ast.Add, ast.Mod)):
        return (_is_str_like(node.left) or _is_str_like(node.right))
    if isinstance(node, ast.Call):
        chain = attr_chain(node.func)
        return bool(chain) and chain[-1] == "format"
    return False


def _is_str_like(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            ) or isinstance(node, ast.JoinedStr)


def check_obs_file(path: str, root: Optional[str] = None
                   ) -> List[Finding]:
    tree = parse_module(path)
    relpath = relpath_of(path, root)
    owner = enclosing_function_map(tree)

    # every span(...) call sanctioned by position: a `with` item's
    # context expression, or the value of a `return`
    sanctioned_spans = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                sanctioned_spans.add(id(item.context_expr))
        elif isinstance(node, ast.Return) and node.value is not None:
            sanctioned_spans.add(id(node.value))

    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if not chain:
            continue
        tail = chain[-1]
        fn = owner.get(id(node))
        where = f"{relpath}:{fn.name if fn else '<module>'}:{node.lineno}"
        if tail == "span" and len(chain) > 1:
            if id(node) not in sanctioned_spans:
                out.append(Finding(
                    ERROR, "QSM-OBS-SPAN", where,
                    "span opened outside a with-statement (and not "
                    "returned to a caller's with): a raise between "
                    "open and close orphans it — the causal tree "
                    "loses the stage and its duration",
                    "use `with tracer.span(...) as sp:` (exception-"
                    "safe close), or return the span for the caller's "
                    "with to own"))
        if tail in _METRIC_REGISTER and len(chain) > 1 and node.args:
            if _is_dynamic_str(node.args[0]):
                out.append(Finding(
                    ERROR, "QSM-OBS-CARDINALITY", where,
                    f"metric name passed to .{tail}() is synthesized "
                    "from runtime data: every distinct value mints a "
                    "new time series — unbounded registry growth "
                    "(cardinality explosion)",
                    "name metrics from a fixed vocabulary and carry "
                    "variability in BOUNDED labels (wid, flush "
                    "reason, verdict) or in span attrs, never in the "
                    "metric name"))
        if tail in _METRIC_WRITE and len(chain) > 1:
            for kw in node.keywords:
                if kw.arg is not None and _is_dynamic_str(kw.value):
                    out.append(Finding(
                        ERROR, "QSM-OBS-CARDINALITY", where,
                        f"label {kw.arg!r} of .{tail}() is synthesized "
                        "from runtime data: every distinct value mints "
                        "a new time series — unbounded registry growth",
                        "label metrics with bounded values only "
                        "(worker id, flush reason, verdict name); "
                        "per-request identity belongs in span attrs "
                        "on the trace log"))
    return out
