"""Resilience passes (pass family *d*; the counterpart of
``qsm_tpu/analysis/resilience_passes.py``): unbounded device calls.

The first in-process call that initialises a device runtime can block
when the system below it is wedged — not fail, block — and a blocked
call loses whatever the process was about to do on the card.  The
resilience plane (qsm_tpu_torch/resilience) exists so every call that
can touch the device substrate is bounded by a
:func:`~qsm_tpu_torch.resilience.policy.watchdog` or runs in a
subprocess with a timeout; this pass family is the gate that keeps
future code on that discipline.

AST lints over the engine modules (ops/), the device plumbing
(ops/backend.py, ops/kernels.py, utils/cli.py) and the runs on the
card (chip_smoke.py, tools/):

* ``QSM-RES-DEVICES``  (error) — bare CUDA initialisation or
  enumeration, ``torch.cuda.init()`` / ``device_count()`` /
  ``get_device_properties()`` / ``is_available()``, outside a
  ``watchdog(...)``-bounded region (the port's form of the reference's
  bare ``jax.devices()``).  They must run under the watchdog, inside a
  bounded subprocess (a string snippet is invisible to this pass — and
  correctly so), or carry a reviewed ``.qsmlint-torch`` entry pinned to
  the one function, explaining why the site is the entry-point guard
  the rest of the run depends on.
* ``QSM-RES-SUBPROC``  (error) — ``subprocess.run`` /
  ``check_output`` / ``check_call`` without a ``timeout=`` keyword, or
  ``Popen.…communicate()`` without one: an unbounded wait on a child
  that may itself be probing a wedged device.
* ``QSM-RES-TIMEOUT-LITERAL`` (warning) — a numeric timeout literal
  passed to a backend probe (``probe_default_backend`` /
  ``probe_or_force_cpu``, the reference's names, kept as they are):
  per-site constants are exactly what resilience/policy.py's named
  PRESETS replaced; pass a policy (or nothing) so a retune edits one
  file, not six call sites.

(The reference's ``QSM-RES-LEAK`` belongs to its whole-program race
family, g, which the port has not taken yet.)

Bounded regions are computed like the kernel passes' loop discovery:
any node lexically inside an argument of a ``watchdog(...)`` call, plus
the bodies of module-local functions whose NAME is passed to
``watchdog``.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Set

from .astutil import attr_chain, collect_function_defs, parse_module
from .findings import ERROR, WARNING, Finding

# torch.cuda entry points that initialise the CUDA runtime or enumerate
# the cards (each can block on a wedged device)
_DEVICE_CALLS = {"init", "device_count", "get_device_properties",
                 "is_available"}
_SUBPROC_WAITS = {"run", "check_output", "check_call", "call"}
_PROBE_FNS = {"probe_default_backend", "probe_or_force_cpu"}


def _watchdogged_nodes(tree: ast.Module) -> Set[int]:
    """ids of AST nodes inside a watchdog-bounded region."""
    defs = collect_function_defs(tree)
    bounded: Set[int] = set()
    bounded_fn_names: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if not chain or chain[-1] != "watchdog":
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Name) and arg.id in defs:
                bounded_fn_names.add(arg.id)
            for sub in ast.walk(arg):
                bounded.add(id(sub))
    for name in bounded_fn_names:
        for fn in defs.get(name, ()):
            for sub in ast.walk(fn):
                bounded.add(id(sub))
    return bounded


def _is_number(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool)
    # -5 / +5 parse as UnaryOp(Constant)
    return isinstance(node, ast.UnaryOp) and _is_number(node.operand)


def _enclosing_function_map(tree: ast.Module) -> dict:
    """node id -> innermost enclosing function name.  Findings carry
    function-qualified locations (``path:funcname:line``) so a whitelist
    entry pins the ONE reviewed function — a file-wide prefix would
    silently accept future unbounded device calls anywhere in exactly
    the modules most likely to grow them."""
    owner: dict = {}
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(fn):
                owner[id(sub)] = fn.name  # innermost wins (visited last)
    return owner


def check_resilience_file(path: str, root: Optional[str] = None
                          ) -> List[Finding]:
    tree = parse_module(path)
    relpath = path
    if root:
        try:
            relpath = os.path.relpath(path, root)
        except ValueError:
            pass
    bounded = _watchdogged_nodes(tree)
    owner = _enclosing_function_map(tree)
    out: List[Finding] = []

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = owner.get(id(node))
        loc = f"{relpath}:{fn}:{getattr(node, 'lineno', 0)}" if fn \
            else f"{relpath}:{getattr(node, 'lineno', 0)}"
        chain = attr_chain(node.func)
        kwargs = {kw.arg for kw in node.keywords}

        if len(chain) >= 3 and chain[:2] == ["torch", "cuda"] \
                and chain[-1] in _DEVICE_CALLS and id(node) not in bounded:
            out.append(Finding(
                ERROR, "QSM-RES-DEVICES", loc,
                f"unbounded {'.'.join(chain)}() — can block on a wedged "
                "CUDA device",
                "wrap in resilience.policy.watchdog, probe via a bounded "
                "subprocess, or whitelist the one function with a "
                "reviewed why-this-is-the-guard note"))
        elif len(chain) >= 2 and chain[0] == "subprocess" \
                and chain[-1] in _SUBPROC_WAITS \
                and "timeout" not in kwargs:
            out.append(Finding(
                ERROR, "QSM-RES-SUBPROC", loc,
                f"subprocess.{chain[-1]}() without timeout= — an "
                "unbounded wait on a child that may be probing a "
                "wedged device",
                "pass timeout= (a RetryPolicy preset's timeout_s; "
                "resilience/policy.py)"))
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr == "communicate" \
                and "timeout" not in kwargs:
            out.append(Finding(
                ERROR, "QSM-RES-SUBPROC", loc,
                "Popen.communicate() without timeout= — an unbounded "
                "wait on the child",
                "pass timeout= (resilience/policy.py preset bound)"))
        elif chain and chain[-1] in _PROBE_FNS:
            literal = [a for a in node.args if _is_number(a)] + \
                [kw.value for kw in node.keywords
                 if kw.arg in ("timeout_s", "probe_timeout_s")
                 and _is_number(kw.value)]
            if literal:
                out.append(Finding(
                    WARNING, "QSM-RES-TIMEOUT-LITERAL", loc,
                    f"numeric timeout literal passed to {chain[-1]} — "
                    "a scattered constant the named PRESETS table "
                    "replaced",
                    "pass policy=preset(name) (resilience/policy.py) "
                    "or let the callee use its preset default"))
    return out
