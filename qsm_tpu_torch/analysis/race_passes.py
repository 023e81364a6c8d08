"""Race passes (pass family *g*; the counterpart of
``qsm_tpu/analysis/race_passes.py``): interprocedural lock/thread
hazards across the port's serving stack.

The port is a long-lived threaded service: CheckServer connection
threads, the batcher's dispatcher threads, the pool supervisor's
heartbeat/respawn machinery, the shared verdict bank, the per-entry
dispatch locks, the one watchdog worker a process and the ``nvcc``
build locks (taken by whichever thread first launches a kernel) all
coordinate through locks.  A wedge or a torn verdict in that world
comes from a lock-order cycle or an unguarded shared write — defects
no single-module pattern matcher can see, because the two halves of
the hazard live in different functions (often different files).  This
family runs on the whole-program :class:`~.callgraph.Project` (symbol
table + call graph + propagated lock summaries) over the serve,
resilience, kernel-build and run-script planes:

* ``QSM-RACE-ORDER`` (error) — a cycle in the lock-order graph: lock
  ``B`` acquired while holding ``A`` on one path and ``A`` while
  holding ``B`` on another (directly or through calls).  Two threads
  interleaving those paths deadlock; on this stack that is a wedged
  server, not a crash.  Sanctioned form: one global acquisition order
  (document it on the lock's docstring), or never hold two locks.
* ``QSM-RACE-UNGUARDED`` (error) — an attribute that has lock-guarded
  writes elsewhere is written with NO lock held on a path reachable
  from a thread target or escaped callback.  A mixed discipline means
  the guard is load-bearing on some paths and absent on others — the
  torn-counter/torn-state shape.  ``__init__`` writes are exempt
  (pre-publication).
* ``QSM-THREAD-LIFECYCLE`` (error) — a thread started whose target
  contains a loop that never consults a stop signal (no ``Event.
  is_set()/wait()``, no stop-flag read, no deadline in the loop test),
  or a *retained* thread (stored on an attribute or container) whose
  owning scope has no bounded ``join(N)``.  Either way teardown can't
  complete deterministically — the hang shows up in tier-1 test
  teardown and every server restart.  Un-retained daemon threads with
  stop-gated loops (the connection-handler idiom) are sanctioned.
* ``QSM-RES-LEAK`` (error) — an fd/pipe/socket acquired (``os.pipe``/
  ``os.dup``/``os.open``/``os.fdopen``/``socket.socket``/bare
  ``open``) outside a ``with``, never closed in the acquiring
  function and never handed off (returned, stored, passed along).  A
  long-lived server leaks these until accept() fails with EMFILE.

The family's scan set is wider than any other (serve + resilience +
kernel builds + the run scripts) because the hazards cross module boundaries; the engine's
declarative family registry (engine.py) carries that without
special-casing.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .astutil import attr_chain
from .callgraph import (FunctionInfo, Project, _walk_no_defs,
                        is_bounded_join)
from .findings import ERROR, Finding

# fd/socket acquisition calls the leak pass tracks: chains joined with
# '.'; single-component entries are builtins
_FD_ACQUIRE = {"os.pipe", "os.dup", "os.open", "os.fdopen",
               "socket.socket", "open"}
_TIME_CALLS = {"monotonic", "perf_counter", "time"}


def check_race_project(paths: Sequence[str],
                       root: Optional[str] = None) -> List[Finding]:
    """Run the whole family over one closed file set."""
    project = Project(paths, root=root)
    out: List[Finding] = []
    out += check_lock_order(project)
    out += check_unguarded_writes(project)
    out += check_thread_lifecycle(project)
    out += check_resource_leaks(project)
    return out


# ---------------------------------------------------------------------------
# QSM-RACE-ORDER
# ---------------------------------------------------------------------------

def check_lock_order(project: Project) -> List[Finding]:
    edges = project.lock_order_edges()
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    out: List[Finding] = []
    for scc in _lock_sccs(graph):
        # walk REAL edges through the SCC for the reported path: a
        # sorted node list is not a cycle, and indexing `edges` with a
        # synthesized pair would crash exactly when a 3+-lock deadlock
        # is found
        cycle = _cycle_path(graph, set(scc))
        pairs = list(zip(cycle, cycle[1:] + cycle[:1]))
        sites = [f"{a} -> {b} at "
                 f"{project.rel_loc(*edges[(a, b)][0])}"
                 for a, b in pairs]
        first_qual, first_ln = edges[pairs[0]][0]
        out.append(Finding(
            ERROR, "QSM-RACE-ORDER",
            project.rel_loc(first_qual, first_ln),
            "lock-order cycle " + " -> ".join(cycle + [cycle[0]])
            + ": two threads interleaving these paths deadlock "
            "(" + "; ".join(sites) + ")",
            "pick ONE acquisition order for these locks and apply it "
            "on every path (or restructure so no path holds both)"))
    return out


def _cycle_path(graph: Dict[str, Set[str]], scc: Set[str]) -> List[str]:
    """One concrete cycle inside an SCC, following actual edges (every
    SCC node has an intra-SCC successor by definition)."""
    start = sorted(scc)[0]
    path = [start]
    seen = {start}
    node = start
    while True:
        nxts = [w for w in sorted(graph.get(node, ())) if w in scc]
        if start in nxts and len(path) > 1:
            return path
        unvisited = [w for w in nxts if w not in seen]
        node = unvisited[0] if unvisited else nxts[0]
        if node in seen:
            return path[path.index(node):]  # the loop we walked into
        path.append(node)
        seen.add(node)


def _lock_sccs(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Strongly connected components with |SCC| > 1 — one finding per
    deadlock-capable lock group (self-edges are excluded upstream:
    re-entrant patterns are a different defect class)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in sorted(graph.get(v, ())):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1:
                sccs.append(sorted(comp))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sccs


# ---------------------------------------------------------------------------
# QSM-RACE-UNGUARDED
# ---------------------------------------------------------------------------

def check_unguarded_writes(project: Project) -> List[Finding]:
    # attr id -> [(fn, line, effective_held)]
    sites: Dict[str, List[Tuple[FunctionInfo, int, frozenset]]] = {}
    for fn in project.functions.values():
        if fn.name == "__init__":
            continue  # pre-publication writes are the sanctioned form
        for attr, ln, held in fn.writes:
            sites.setdefault(attr, []).append(
                (fn, ln, project.effective_held(fn, held)))
    out: List[Finding] = []
    for attr in sorted(sites):
        rows = sites[attr]
        guarded = [r for r in rows if r[2]]
        if not guarded:
            continue  # no lock discipline to be inconsistent with
        # the guard is the lock most guarded writes agree on
        counts: Dict[str, int] = {}
        for _fn, _ln, held in guarded:
            for lock in held:
                counts[lock] = counts.get(lock, 0) + 1
        guard = sorted(counts, key=lambda k: (-counts[k], k))[0]
        guard_eg = next(project.rel_loc(fn.qual, ln)
                        for fn, ln, held in guarded if guard in held)
        for fn, ln, held in rows:
            if held or not fn.thread_reachable:
                continue
            out.append(Finding(
                ERROR, "QSM-RACE-UNGUARDED",
                project.rel_loc(fn.qual, ln),
                f"write to shared attribute {attr} with no lock held, "
                f"on a thread-reachable path — its other writes hold "
                f"{guard} (e.g. {guard_eg}); concurrent writers can "
                "tear or lose this update",
                f"hold {guard} here too (or move the write inside an "
                "existing guarded region)"))
    return out


# ---------------------------------------------------------------------------
# QSM-THREAD-LIFECYCLE
# ---------------------------------------------------------------------------

def _consults_stop(node: ast.AST, project: Project,
                   fn: FunctionInfo) -> bool:
    ci = project.classes.get(fn.cls) if fn.cls else None
    for sub in _walk_no_defs(node):
        if isinstance(sub, ast.Call):
            chain = attr_chain(sub.func)
            if chain and chain[-1] in ("is_set", "wait"):
                return True
        name = None
        if isinstance(sub, ast.Attribute):
            name = sub.attr
        elif isinstance(sub, ast.Name):
            name = sub.id
        if name is not None:
            low = name.lower()
            if "stop" in low or "shutdown" in low:
                return True
            if ci and name in ci.event_attrs:
                return True
    return False


def _time_bounded(test: ast.AST) -> bool:
    for sub in _walk_no_defs(test):
        if isinstance(sub, ast.Call):
            chain = attr_chain(sub.func)
            if chain and chain[-1] in _TIME_CALLS:
                return True
    return False


def _unstoppable_loop(target: FunctionInfo,
                      project: Project) -> Optional[int]:
    """Line of a ``while`` in the target that no stop signal (its own
    or an enclosing loop's) can exit, or None."""

    def visit(node: ast.AST, ancestor_ok: bool) -> Optional[int]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(child, ast.While):
                ok = (ancestor_ok
                      or _consults_stop(child, project, target)
                      or _time_bounded(child.test))
                if not ok:
                    return child.lineno
                hit = visit(child, True)
            else:
                hit = visit(child, ancestor_ok)
            if hit is not None:
                return hit
        return None

    return visit(target.node, False)


def _module_has_bounded_join(project: Project, path: str) -> bool:
    tree = project.modules.get(path)
    if tree is None:
        return False
    return any(isinstance(sub, ast.Call) and is_bounded_join(sub)
               for sub in ast.walk(tree))


def check_thread_lifecycle(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for fn in project.functions.values():
        for ts in fn.thread_starts:
            problems: List[str] = []
            target = (project.functions.get(ts.target_qual)
                      if ts.target_qual else None)
            if target is not None:
                ln = _unstoppable_loop(target, project)
                if ln is not None:
                    problems.append(
                        f"target {target.name}'s loop (line {ln}) never "
                        "consults a stop flag or deadline — the thread "
                        "cannot be told to exit")
            if ts.retained:
                scope_ok = (project.classes[fn.cls].has_bounded_join
                            if fn.cls and fn.cls in project.classes
                            else _module_has_bounded_join(project,
                                                          fn.path))
                if not scope_ok:
                    problems.append(
                        "the Thread object is retained but its owning "
                        "scope has no bounded join(N) — teardown cannot "
                        "complete deterministically")
            if problems:
                out.append(Finding(
                    ERROR, "QSM-THREAD-LIFECYCLE",
                    project.rel_loc(ts.site_qual, ts.lineno),
                    "thread started without a teardown path: "
                    + "; ".join(problems),
                    "gate the target loop on a threading.Event (stop "
                    "flag or deadline) and join retained threads with "
                    "a bound on the stop path (serve/batcher.py "
                    "start/stop is the model)"))
    return out


# ---------------------------------------------------------------------------
# QSM-RES-LEAK
# ---------------------------------------------------------------------------

def _is_fd_acquire(call: ast.Call) -> bool:
    chain = attr_chain(call.func)
    return bool(chain) and ".".join(chain) in _FD_ACQUIRE


def _class_closes_attr(project: Project, cls: Optional[str],
                       attr: str) -> bool:
    if not cls:
        return False
    for other in project.functions.values():
        if other.cls != cls:
            continue
        for sub in _walk_no_defs(other.node):
            if isinstance(sub, ast.Call):
                chain = attr_chain(sub.func)
                if chain and chain[-1] == "close" and attr in chain:
                    return True
                # handed to a helper (``self._close_pipes(proc)``)
                for arg in sub.args:
                    achain = attr_chain(arg)
                    if achain and attr in achain:
                        return True
    return False


def check_resource_leaks(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for fn in project.functions.values():
        out += _leaks_in(fn, project)
    return out


def _leaks_in(fn: FunctionInfo, project: Project) -> List[Finding]:
    node = fn.node
    with_items: Set[int] = set()
    consumed: Set[int] = set()
    for sub in _walk_no_defs(node):
        if isinstance(sub, (ast.With, ast.AsyncWith)):
            for item in sub.items:
                for c in ast.walk(item.context_expr):
                    with_items.add(id(c))
        if isinstance(sub, ast.Call):
            # an acquisition nested inside another expression is
            # consumed by it (``os.fdopen(os.dup(0))``)
            for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                for c in ast.walk(arg):
                    consumed.add(id(c))

    # name -> closed/escaped facts, gathered once over the function
    closes: Set[str] = set()
    escapes: Set[str] = set()
    for sub in _walk_no_defs(node):
        if isinstance(sub, ast.Call):
            chain = attr_chain(sub.func)
            if chain and chain[-1] == "close":
                closes.update(chain[:-1])
            for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                for c in ast.walk(arg):
                    nchain = attr_chain(c)
                    if nchain:
                        escapes.add(nchain[0])
        elif isinstance(sub, ast.Return) and sub.value is not None:
            for c in ast.walk(sub.value):
                nchain = attr_chain(c)
                if nchain:
                    escapes.add(nchain[0])
        elif isinstance(sub, ast.Assign):
            stores = any(isinstance(t, (ast.Attribute, ast.Subscript))
                         for t in sub.targets)
            if stores:
                for c in ast.walk(sub.value):
                    nchain = attr_chain(c)
                    if nchain:
                        escapes.add(nchain[0])

    out: List[Finding] = []
    for sub in _walk_no_defs(node):
        if not (isinstance(sub, ast.Call) and _is_fd_acquire(sub)):
            continue
        if id(sub) in with_items or id(sub) in consumed:
            continue
        stmt = _enclosing_assign(node, sub)
        if stmt is None:
            # acquired and dropped on the floor (bare expression)
            out.append(_leak_finding(fn, project, sub.lineno))
            continue
        names: List[str] = []
        attr_target: Optional[str] = None
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                names.append(tgt.id)
            elif isinstance(tgt, ast.Tuple):
                names += [e.id for e in tgt.elts
                          if isinstance(e, ast.Name)]
            elif isinstance(tgt, ast.Attribute):
                chain = attr_chain(tgt)
                if len(chain) == 2 and chain[0] == "self":
                    attr_target = chain[1]
        if attr_target is not None:
            if not _class_closes_attr(project, fn.cls, attr_target):
                out.append(_leak_finding(fn, project, sub.lineno))
            continue
        if not names:
            continue
        if any(n in closes or n in escapes for n in names):
            continue
        out.append(_leak_finding(fn, project, sub.lineno))
    return out


def _enclosing_assign(fn_node: ast.AST, call: ast.Call):
    """The Assign/AnnAssign statement whose value is this acquisition
    (an annotated ``s: socket.socket = socket.socket()`` binds a name
    just like a plain assign)."""
    for sub in _walk_no_defs(fn_node):
        if isinstance(sub, ast.Assign) and sub.value is call:
            return sub
        if isinstance(sub, ast.AnnAssign) and sub.value is call:
            return sub
    return None


def _leak_finding(fn: FunctionInfo, project: Project,
                  lineno: int) -> Finding:
    return Finding(
        ERROR, "QSM-RES-LEAK",
        project.rel_loc(fn.qual, lineno),
        "fd/socket acquired here is never closed in this function and "
        "never handed off (not returned, stored, or passed along) — a "
        "long-lived server leaks descriptors until accept() fails "
        "with EMFILE",
        "close on every exit (with-statement or try/finally), or hand "
        "the resource to an owner that closes it")
