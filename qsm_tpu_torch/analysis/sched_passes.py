"""Determinism passes (pass family *c*; the counterpart of
``qsm_tpu/analysis/sched_passes.py``).

The scheduler plane's whole value is the determinism contract:
``(sut, program, seed, faults) -> identical History, bit for bit``
(sched/runner.py) — replay, shrinking, systematic exploration and the
regression corpus all assume it.  Any nondeterminism source OUTSIDE the
scheduler's seeded RNG breaks that silently: a violation found once can
never be reproduced, and the card time spent hunting it is wasted.

AST lints over sched/scheduler.py, sched/pool.py, sched/transport.py,
sched/runner.py (and any file handed to :func:`check_sched_file`):

* ``QSM-DET-RANDOM``   — module-level ``random.*`` / ``np.random.*``
  calls (anything but constructing a seeded ``random.Random``); the
  scheduler's own ``self.rng`` is the only sanctioned RNG.  In the
  port's idiom also torch's global generator: ``torch.rand*`` /
  ``torch.randint`` / ``torch.randperm`` without an explicit
  ``generator=``, and ``torch.manual_seed`` (it seeds the process-wide
  generator every other caller shares).
* ``QSM-DET-SET-ITER`` — iteration over a set literal / ``set()``-built
  value: set order is salted per process, so any delivery choice fed
  from it diverges across runs.
* ``QSM-DET-ID``       — ``id()`` used as a value (sort keys,
  comparisons): CPython address order is allocation order, not logical
  order.
* ``QSM-DET-TIME``     — wall-clock reads (``time.time`` /
  ``perf_counter`` / ``monotonic``); warning severity — timing *stats*
  are legitimate, timing-fed *decisions* are not, and the whitelist
  records the reviewed-legitimate sites.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .astutil import (attr_chain, enclosing_function_map, parse_module,
                      relpath_of)
from .findings import ERROR, WARNING, Finding

_TIME_FNS = {"time", "time_ns", "perf_counter", "perf_counter_ns",
             "monotonic", "monotonic_ns", "process_time"}
# torch's global-generator seeding: never takes a generator
_TORCH_SEEDING = {"manual_seed", "manual_seed_all", "seed", "seed_all"}


def _torch_global_draw(chain, node: ast.Call) -> bool:
    """``torch.rand*`` (rand, randn, randint, randperm, the ``_like``
    forms) drawing from the global generator: no ``generator=``, or a
    ``_like`` form, which takes none; ``torch.manual_seed`` and kin."""
    if len(chain) < 2 or chain[0] != "torch":
        return False
    if chain[-1] in _TORCH_SEEDING:
        return True
    if len(chain) != 2 or not chain[1].startswith("rand"):
        return False
    return chain[1].endswith("_like") or not any(
        kw.arg == "generator" for kw in node.keywords)
_SET_BUILDERS = {"set", "frozenset"}


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Set):
        return True
    if isinstance(node, ast.SetComp):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in _SET_BUILDERS:
        return True
    return False


def _scope_nodes(scope: ast.AST):
    """Walk one lexical scope WITHOUT descending into nested function
    defs (each nested def is its own scope)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))


def _set_bound_names(scope: ast.AST) -> set:
    """Names assigned a set expression within ONE scope — a one-level
    dataflow approximation, enough to catch
    ``pending = set(...) ... for x in pending``.  Scope-local so a
    set-typed name in one function cannot flag a same-named list in
    another."""
    names = set()
    for node in _scope_nodes(scope):
        if isinstance(node, ast.Assign) and _is_set_expr(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    names.add(tgt.id)
    return names


def check_sched_file(path: str, root: Optional[str] = None
                     ) -> List[Finding]:
    tree = parse_module(path)
    relpath = relpath_of(path, root)
    # function-qualified locations (``path:funcname:line``), as the other
    # families give, so a whitelist entry pins the one reviewed function
    owner = enclosing_function_map(tree)
    out: List[Finding] = []

    # per-scope set-name map: node id -> set names of its enclosing
    # scope (module scope counts as one)
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
    scope_of = {}
    for scope in scopes:
        local = _set_bound_names(scope)
        for node in _scope_nodes(scope):
            scope_of[id(node)] = local

    for node in ast.walk(tree):
        set_names = scope_of.get(id(node), set())
        fn = owner.get(id(node))
        line = getattr(node, "lineno", 0)
        loc = (f"{relpath}:{fn.name}:{line}" if fn is not None
               else f"{relpath}:{line}")

        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if len(chain) >= 2 and chain[0] == "random" \
                    and chain[-1] != "Random":
                out.append(Finding(
                    ERROR, "QSM-DET-RANDOM", loc,
                    f"module-level random.{'.'.join(chain[1:])}() in the "
                    "scheduler plane",
                    "all nondeterminism must flow from the scheduler's "
                    "seeded rng (Scheduler.rng) or the run stays "
                    "unreplayable"))
            elif len(chain) >= 2 and chain[0] == "random" \
                    and chain[-1] == "Random" \
                    and not node.args and not node.keywords:
                # the constructor exemption is for SEEDED construction
                # only: Random() with no seed draws from OS entropy —
                # the same unreplayable nondeterminism, one step removed
                out.append(Finding(
                    ERROR, "QSM-DET-RANDOM", loc,
                    "UNSEEDED random.Random() construction in the "
                    "scheduler plane",
                    "pass an explicit seed; an entropy-seeded rng makes "
                    "every run unreplayable"))
            elif len(chain) >= 3 and chain[0] in ("np", "numpy") \
                    and chain[1] == "random":
                out.append(Finding(
                    ERROR, "QSM-DET-RANDOM", loc,
                    f"{'.'.join(chain)}() in the scheduler plane",
                    "np.random global state is process-wide and "
                    "unseeded here; use the scheduler's seeded rng"))
            elif _torch_global_draw(chain, node):
                out.append(Finding(
                    ERROR, "QSM-DET-RANDOM", loc,
                    f"{'.'.join(chain)}() on torch's global generator in "
                    "the scheduler plane",
                    "pass generator= (a torch.Generator seeded from the "
                    "run's seed); the global generator is process-wide "
                    "and unseeded here"))
            elif len(chain) == 2 and chain[0] == "time" \
                    and chain[1] in _TIME_FNS:
                out.append(Finding(
                    WARNING, "QSM-DET-TIME", loc,
                    f"wall-clock read time.{chain[1]}() in the "
                    "scheduler plane",
                    "fine for timing stats; a delivery/ordering "
                    "decision fed from it breaks replay — whitelist "
                    "reviewed-legitimate sites in .qsmlint-torch"))
            elif isinstance(node.func, ast.Name) and node.func.id == "id":
                out.append(Finding(
                    ERROR, "QSM-DET-ID", loc,
                    "id() used as a value in the scheduler plane",
                    "CPython addresses are allocation-ordered; any "
                    "comparison/sort over them is run-dependent"))
            # sorted(..., key=id) / min/max(..., key=id)
            for kw in node.keywords:
                if kw.arg == "key" and isinstance(kw.value, ast.Name) \
                        and kw.value.id == "id":
                    out.append(Finding(
                        ERROR, "QSM-DET-ID", loc,
                        "sort/selection keyed on id() in the scheduler "
                        "plane",
                        "address order is not deterministic across "
                        "runs"))

        if isinstance(node, (ast.For, ast.AsyncFor)):
            it = node.iter
            if _is_set_expr(it) or (isinstance(it, ast.Name)
                                    and it.id in set_names):
                out.append(Finding(
                    ERROR, "QSM-DET-SET-ITER", loc,
                    "iteration over an unordered set in the scheduler "
                    "plane",
                    "set order is hash-salted per process; sort the "
                    "elements (or keep a list) before any choice is "
                    "fed from the iteration"))
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            for comp in node.generators:
                it = comp.iter
                if _is_set_expr(it) or (isinstance(it, ast.Name)
                                        and it.id in set_names):
                    out.append(Finding(
                        ERROR, "QSM-DET-SET-ITER",
                        loc,
                        "comprehension over an unordered set in the "
                        "scheduler plane",
                        "set order is hash-salted per process; sort "
                        "before deriving any ordered value"))
    return out
