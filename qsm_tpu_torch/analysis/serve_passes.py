"""Serve passes (pass family *e*; the counterpart of
``qsm_tpu/analysis/serve_passes.py``): the serving plane's two
structural hazards.

A long-lived server fails differently from a one-shot tool: nothing
exits, so an unbounded blocking call holds a thread forever and an
unbounded queue converts overload into memory growth and silent latency
collapse.  The serving plane's own disciplines (serve/protocol.py's
deadline-polled reads, serve/admission.py's bounded lanes) exist for
exactly these; this pass family is the gate that keeps future serve
code on them.

AST lints over the serve modules (qsm_tpu_torch/serve/) and the fleet
tier (qsm_tpu_torch/fleet/):

* ``QSM-SERVE-ACCEPT`` (error) — an ``accept()``/``recv*()``/
  ``readline()`` loop with a constant-true test inside a function that
  never calls ``settimeout``: no deadline and no shutdown check, so a
  wedged peer (or a stop request) leaves the thread blocked forever.
  Sanctioned forms: gate the loop on a stop flag (a non-constant test)
  or bound the socket with ``settimeout`` and poll.
* ``QSM-SERVE-UNBOUNDED`` (error) — an unbounded queue construction
  (``queue.Queue()`` / ``LifoQueue()`` / ``PriorityQueue()`` without a
  positive ``maxsize``, ``queue.SimpleQueue()`` which cannot be
  bounded, or ``collections.deque()`` without ``maxlen``) in an
  admission path: load must shed explicitly at a bound
  (serve/admission.py), never accumulate.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional

from .astutil import attr_chain, enclosing_function_map, parse_module
from .findings import ERROR, Finding

_BLOCKING_CALLS = {"accept", "recv", "recvfrom", "recv_into", "readline"}
_QUEUE_CLASSES = {"Queue", "LifoQueue", "PriorityQueue"}


def _is_const_true(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value)


def _has_settimeout(fn: Optional[ast.AST]) -> bool:
    if fn is None:
        return False
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[-1] == "settimeout":
                return True
    return False


def _queue_bound(node: ast.Call) -> Optional[ast.AST]:
    """The maxsize/maxlen argument expression, or None when absent OR a
    constant ≤ 0 — the stdlib spells 'infinite' as ``maxsize=0`` (and
    accepts negatives), so those are exactly the unbounded forms the
    rule exists for, not bounds."""
    bound = None
    if node.args:
        bound = node.args[0]
    else:
        for kw in node.keywords:
            if kw.arg in ("maxsize", "maxlen"):
                bound = kw.value
                break
    if bound is None:
        return None
    v = bound
    neg = False
    if isinstance(v, ast.UnaryOp) and isinstance(v.op, ast.USub):
        v, neg = v.operand, True
    if isinstance(v, ast.Constant) and isinstance(v.value, (int, float)) \
            and not isinstance(v.value, bool) \
            and (neg or v.value <= 0):
        return None  # an explicit 'infinite' spelling
    return bound


def check_serve_file(path: str, root: Optional[str] = None
                     ) -> List[Finding]:
    tree = parse_module(path)
    relpath = path
    if root:
        try:
            relpath = os.path.relpath(path, root)
        except ValueError:
            pass
    owner = enclosing_function_map(tree)
    out: List[Finding] = []

    for node in ast.walk(tree):
        if isinstance(node, ast.While):
            if not _is_const_true(node.test):
                continue  # a stop-flag-gated loop IS the shutdown check
            blocking = None
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    chain = attr_chain(sub.func)
                    if chain and chain[-1] in _BLOCKING_CALLS:
                        blocking = chain[-1]
                        break
            if blocking is None:
                continue
            fn = owner.get(id(node))
            if _has_settimeout(fn):
                continue  # deadline-polled: the sanctioned bounded form
            name = fn.name if fn is not None else "<module>"
            out.append(Finding(
                ERROR, "QSM-SERVE-ACCEPT",
                f"{relpath}:{name}:{node.lineno}",
                f"while-True {blocking}() loop with no deadline or "
                "shutdown check — a wedged peer (or a stop request) "
                "blocks this thread forever",
                "gate the loop on a stop flag, or settimeout the socket "
                "and poll (serve/protocol.py LineChannel is the model)"))
        elif isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if not chain:
                continue
            fn = owner.get(id(node))
            name = fn.name if fn is not None else "<module>"
            loc = f"{relpath}:{name}:{node.lineno}"
            if chain[-1] == "SimpleQueue" and len(chain) <= 2:
                out.append(Finding(
                    ERROR, "QSM-SERVE-UNBOUNDED", loc,
                    "queue.SimpleQueue() cannot be bounded — overload "
                    "accumulates instead of shedding",
                    "use queue.Queue(maxsize=...) behind the admission "
                    "controller (serve/admission.py)"))
            elif chain[-1] in _QUEUE_CLASSES and len(chain) <= 2 \
                    and _queue_bound(node) is None:
                out.append(Finding(
                    ERROR, "QSM-SERVE-UNBOUNDED", loc,
                    f"{'.'.join(chain)}() without maxsize — unbounded "
                    "queue growth in an admission path converts overload "
                    "into memory growth and silent latency collapse",
                    "pass maxsize= (and SHED explicitly when full — "
                    "serve/admission.py)"))
            elif chain[-1] == "deque" and len(chain) <= 2 \
                    and _queue_bound(node) is None:
                out.append(Finding(
                    ERROR, "QSM-SERVE-UNBOUNDED", loc,
                    "collections.deque() without maxlen in the serve "
                    "plane — unbounded buffering",
                    "pass maxlen= or bound via the admission controller"))
    return out
