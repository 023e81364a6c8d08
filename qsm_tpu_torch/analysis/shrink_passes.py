"""Shrink passes (pass family *h*; the counterpart of
``qsm_tpu/analysis/shrink_passes.py``): frontier bounds.

The shrink plane's one structural promise is that every frontier is
FINITE and every greedy loop bounded: candidate generation is a bounded
sweep over one history's ops, the round loop carries an explicit cap
behind its lexicographic termination measure, and a truncated frontier
says so in ``why`` (qsm_tpu_torch/shrink/frontier.py module docstring).  An
unbounded frontier generator is the failure mode that turns one shrink
request into a runaway CPU burn inside the serving plane — the shrink
verb shares the micro-batcher with paying traffic, so the burn starves
every client, not just the requester.

* ``QSM-SHRINK-UNBOUNDED`` (error) — a constant-true ``while`` loop
  that GROWS a frontier (``yield``, ``.append()``, ``.extend()``,
  ``.add()``) with no ``break`` at all, or with no comparison anywhere
  in the loop body (nothing that could be a size/round cap): frontier
  generation with no round or size bound.  Sanctioned forms: iterate
  the ops (a ``for`` over a bounded sequence), or gate the loop /
  ``break`` on an explicit cap comparison.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional

from .astutil import attr_chain, enclosing_function_map, parse_module
from .findings import ERROR, Finding

_GROW_CALLS = {"append", "extend", "add"}


def _is_const_true(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value)


def _grows_frontier(node: ast.While) -> Optional[str]:
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Yield, ast.YieldFrom)):
            return "yield"
        if isinstance(sub, ast.Call):
            chain = attr_chain(sub.func)
            if chain and chain[-1] in _GROW_CALLS:
                return f".{chain[-1]}()"
    return None


def _has_bounded_break(node: ast.While) -> bool:
    has_break = any(isinstance(sub, ast.Break) for sub in ast.walk(node))
    if not has_break:
        return False
    # a break with no comparison anywhere in the loop cannot be a
    # size/round cap (it is some other control flow); require at least
    # one Compare so "while True: ... if len(out) >= cap: break" passes
    # and a compare-free grow loop does not
    return any(isinstance(sub, ast.Compare) for sub in ast.walk(node))


def check_shrink_file(path: str, root: Optional[str] = None
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
        if not isinstance(node, ast.While):
            continue
        if not _is_const_true(node.test):
            continue  # a real test IS the bound (rounds < cap, etc.)
        grow = _grows_frontier(node)
        if grow is None:
            continue
        if _has_bounded_break(node):
            continue
        fn = owner.get(id(node))
        name = fn.name if fn is not None else "<module>"
        out.append(Finding(
            ERROR, "QSM-SHRINK-UNBOUNDED",
            f"{relpath}:{name}:{node.lineno}",
            f"while-True loop grows a frontier ({grow}) with no "
            "round/size cap — one shrink request becomes an unbounded "
            "CPU burn on lanes shared with paying traffic",
            "iterate the history's ops (bounded), or gate the loop/"
            "break on an explicit cap (shrink/frontier.py "
            "shrink_frontier's max_lanes is the model)"))
    return out
