"""Pool passes (pass family *f*; the counterpart of
``qsm_tpu/analysis/pool_passes.py``): worker-process lifecycle hazards.

The worker-pool serving plane (serve/pool.py, serve/worker.py) spawns
and supervises CHILD PROCESSES, which fail in two ways a long-lived
in-process plane cannot: a child that is never reaped with a bound
(a ``wait()``/``join()`` that can block forever, or no reap at all —
zombies and leaked workers accumulate across a server's lifetime, and
tier-1 test runs leak processes), and a respawn loop without backoff
or an attempt bound (a crash-looping worker converts one bad spec into
an infinite spawn storm that starves the machine the service runs on).
The pool's own disciplines — ``terminate → wait(timeout) → kill``
escalation, exponential-backoff respawns with a per-slot lifetime
bound, per-spec quarantine — exist for exactly these; this pass family
is the gate that keeps future pool code on them.

AST lints over the pool modules (serve/pool.py, serve/worker.py):

* ``QSM-POOL-REAP`` (error) — a ``subprocess.Popen(...)`` /
  ``multiprocessing.Process(...)`` spawn inside a scope (the enclosing
  class, else the module) with NO bounded reap anywhere in that scope:
  no ``.wait(timeout=...)``/``.wait(N)`` and no ``.join(N)`` carrying
  a bound.  An unreaped worker is a leak; an unbounded ``wait()`` on a
  wedged worker is the QSM-RES-SUBPROC hazard at the pool level.
  Sanctioned form: spawn and reap in the same class, every
  wait/join bounded, kill escalation after the bound.
* ``QSM-POOL-RESPAWN`` (error) — a constant-``True`` ``while`` loop
  that spawns a worker with no ``sleep``-based backoff inside the
  loop: a worker that dies instantly makes this a spawn storm.
  Sanctioned forms: gate the loop on a stop flag with backoff sleeps
  (serve/pool.py ``_supervise`` is the model), or bound attempts with
  a ``for``/counter instead of ``while True``.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional

from .astutil import attr_chain, parse_module
from .findings import ERROR, Finding

_SPAWN_CALLS = {"Popen", "Process"}
_REAP_CALLS = {"wait", "join"}


def _is_const_true(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value)


def _is_spawn(node: ast.Call) -> bool:
    chain = attr_chain(node.func)
    # Popen / subprocess.Popen / mp.Process — one attribute of module
    # depth at most, so e.g. obj.factory.Process(...) stays out
    return bool(chain) and chain[-1] in _SPAWN_CALLS and len(chain) <= 2


def _is_bounded_reap(node: ast.Call) -> bool:
    """``x.wait(5)`` / ``x.wait(timeout=...)`` / ``t.join(2.0)`` — a
    reap (or join) call that carries ANY bound expression.  A bare
    ``wait()``/``join()`` is unbounded and does not count."""
    chain = attr_chain(node.func)
    if not chain or chain[-1] not in _REAP_CALLS:
        return False
    if len(chain) < 2:  # plain wait()/join() builtins are not reaps
        return False
    if any(kw.arg == "timeout" for kw in node.keywords):
        return True
    return bool(node.args)


def _scope_map(tree: ast.Module) -> dict:
    """node id -> innermost enclosing ClassDef (or None for module
    scope).  The REAP rule is scoped per class: a pool class owns its
    workers' whole lifecycle, so the spawn and the bounded reap must
    live together — while a *different* class' reap says nothing about
    this one's spawns."""
    owner: dict = {}
    for cls in ast.walk(tree):
        if isinstance(cls, ast.ClassDef):
            for sub in ast.walk(cls):
                owner[id(sub)] = cls  # innermost wins (visited last)
    return owner


def _function_map(tree: ast.Module) -> dict:
    owner: dict = {}
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(fn):
                owner[id(sub)] = fn.name  # innermost wins
    return owner


def check_pool_file(path: str, root: Optional[str] = None
                    ) -> List[Finding]:
    tree = parse_module(path)
    relpath = path
    if root:
        try:
            relpath = os.path.relpath(path, root)
        except ValueError:
            pass
    scope_of = _scope_map(tree)
    fn_of = _function_map(tree)
    out: List[Finding] = []

    # collect spawns and bounded reaps per scope (class or module)
    spawns: dict = {}
    reaped: set = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        scope = scope_of.get(id(node))
        scope_key = id(scope) if scope is not None else None
        if _is_spawn(node):
            spawns.setdefault(scope_key, []).append(node)
        elif _is_bounded_reap(node):
            reaped.add(scope_key)

    for scope_key, nodes in spawns.items():
        if scope_key in reaped:
            continue
        for node in nodes:
            name = fn_of.get(id(node), "<module>")
            out.append(Finding(
                ERROR, "QSM-POOL-REAP",
                f"{relpath}:{name}:{node.lineno}",
                "worker spawned with no bounded reap path in its scope "
                "— no wait(timeout=)/join(N) anywhere in the owning "
                "class: leaked or zombie workers accumulate for the "
                "server's whole lifetime",
                "reap where you spawn: terminate() -> wait(timeout=...) "
                "-> kill() escalation (serve/pool.py stop/_shed is the "
                "model)"))

    # respawn storms: while-True loops that spawn without backoff
    for node in ast.walk(tree):
        if not isinstance(node, ast.While) or not _is_const_true(node.test):
            continue
        spawn = None
        has_sleep = False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                if _is_spawn(sub):
                    spawn = spawn or sub
                chain = attr_chain(sub.func)
                if chain and chain[-1] == "sleep":
                    has_sleep = True
        if spawn is None or has_sleep:
            continue
        name = fn_of.get(id(node), "<module>")
        out.append(Finding(
            ERROR, "QSM-POOL-RESPAWN",
            f"{relpath}:{name}:{node.lineno}",
            "while-True respawn loop with no backoff sleep — a worker "
            "that dies instantly turns this into a spawn storm that "
            "starves the host",
            "gate the loop on a stop flag with exponential-backoff "
            "sleeps and a lifetime attempt bound per slot "
            "(serve/pool.py _supervise), or bound attempts with a for "
            "loop"))
    return out
