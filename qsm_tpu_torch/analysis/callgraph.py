"""Whole-program symbol table, call graph and lock summaries — the
interprocedural substrate of pass family (g) (``race_passes.py``); the
counterpart of ``qsm_tpu/analysis/callgraph.py``, pure AST like it.

The single-module AST passes (families c–f) cannot see the hazards the
threaded serving stack actually has: a lock-order cycle needs *both*
acquisition paths, an unguarded shared write needs to know which lock
guards the attribute's *other* writes (possibly in a different method,
behind a call), and "is this function running on a thread?" is a
property of the call graph, not of any one function.  This module
builds, over a closed set of project files (the port's serving stack,
its resilience plane, its kernel builds and the scripts that drive
them on the card):

* a **symbol table** — every class (with its lock/event attributes,
  ``__init__``-assigned attributes and best-effort attribute types)
  and every function/method, nested defs included, keyed by a
  qualified name ``relpath:Class.method``;
* a **call graph** — calls resolved by a conservative ladder
  (``self.m`` → own class; annotated parameters and constructed
  locals; unique name in the same module, then project-wide;
  ambiguity drops the edge rather than guessing);
* **per-function lock summaries** — for every lock acquisition,
  attribute write and call site, the set of locks held *at that
  point*, inferred from ``with lock:`` blocks and
  ``acquire()``/``release()`` pairs, then propagated along the call
  graph both ways: ``entry_held`` (locks guaranteed held on entry —
  the intersection over all known call sites) and
  ``trans_acquires`` (locks a call may take downstream);
* **thread roots** — functions passed as ``threading.Thread``
  targets, functions that escape as callbacks (passed as a call
  argument), and everything call-reachable from them.

Everything is a deliberate approximation tuned for a lint: a dropped
ambiguous edge can only *miss* a hazard (the single-module families
still cover their ground), never invent one, and the seeded fixtures
in ``fixtures.py`` pin the true positives that must keep firing.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .astutil import attr_chain, parse_module

# threading constructors that create a mutual-exclusion object: an
# attribute/local assigned one of these becomes a trackable lock id
LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
              "BoundedSemaphore"}
EVENT_CTORS = {"Event"}
THREAD_CTORS = {"Thread"}

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


@dataclasses.dataclass
class ClassInfo:
    name: str
    path: str                      # repo-relative module path
    lineno: int
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)
    event_attrs: Set[str] = dataclasses.field(default_factory=set)
    init_attrs: Set[str] = dataclasses.field(default_factory=set)
    # best-effort attr -> class-name (``self.pool = WorkerPool(...)``,
    # ``self.handle: Optional[WorkerHandle] = None``)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    # attr -> element class for list-of-instances attributes
    # (``self._slots = [_Slot(i) for i in ...]``)
    attr_elem_types: Dict[str, str] = dataclasses.field(
        default_factory=dict)
    has_bounded_join: bool = False


@dataclasses.dataclass
class ThreadStart:
    """One ``threading.Thread(target=...)`` creation site."""

    site_qual: str
    lineno: int
    target_qual: Optional[str]     # resolved target function, if any
    retained: bool                 # stored on an attribute / container


@dataclasses.dataclass
class FunctionInfo:
    qual: str                      # "relpath:Class.method" / "relpath:fn"
    name: str
    cls: Optional[str]
    path: str
    node: ast.AST
    # summaries (Project._summarize):
    acquires: List[Tuple[str, int, frozenset]] = \
        dataclasses.field(default_factory=list)
    writes: List[Tuple[str, int, frozenset]] = \
        dataclasses.field(default_factory=list)
    calls: List[Tuple[str, int, frozenset]] = \
        dataclasses.field(default_factory=list)  # (callee qual, ln, held)
    thread_starts: List[ThreadStart] = \
        dataclasses.field(default_factory=list)
    # interprocedural results (Project._propagate):
    entry_held: frozenset = frozenset()
    trans_acquires: frozenset = frozenset()
    thread_reachable: bool = False
    escapes: bool = False          # handed off as a callback


def _ann_class(ann: Optional[ast.AST]) -> Optional[str]:
    """Class name out of an annotation: ``X``, ``Optional[X]``,
    ``"X"`` — best effort, None otherwise."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split("[")[-1].rstrip("]").split(".")[-1] or None
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Subscript):
        return _ann_class(ann.slice)
    if isinstance(ann, ast.Attribute):
        return ann.attr
    return None


def _ctor_name(expr: ast.AST, among: Set[str]) -> Optional[str]:
    """``Cls(...)`` / ``mod.Cls(...)`` when ``Cls`` is in ``among``."""
    if isinstance(expr, ast.Call):
        chain = attr_chain(expr.func)
        if chain and chain[-1] in among and len(chain) <= 2:
            return chain[-1]
    return None


def _contains_ctor(expr: ast.AST, among: Set[str]) -> bool:
    """True when any Call inside ``expr`` constructs one of ``among``
    (covers ``setdefault(k, threading.Lock())``)."""
    return any(isinstance(n, ast.Call) and _ctor_name(n, among)
               for n in ast.walk(expr))


def _elem_ctor(expr: ast.AST, classes: Set[str]) -> Optional[str]:
    """Element class of ``[Cls(...) for ...]`` / ``[Cls(a), Cls(b)]``."""
    elts: List[ast.AST] = []
    if isinstance(expr, ast.ListComp):
        elts = [expr.elt]
    elif isinstance(expr, (ast.List, ast.Tuple)):
        elts = list(expr.elts)
    for e in elts:
        name = _ctor_name(e, classes)
        if name:
            return name
    return None


def is_bounded_join(call: ast.Call) -> bool:
    """``x.join(2.0)`` / ``x.join(timeout=...)`` — a join carrying any
    bound.  A bare ``join()`` can block forever and does not count.
    One predicate for both scopes of the lifecycle rule (class-level
    in :class:`Project`, module-level in ``race_passes``)."""
    chain = attr_chain(call.func)
    return (bool(chain) and chain[-1] == "join" and len(chain) >= 2
            and (bool(call.args)
                 or any(kw.arg == "timeout" for kw in call.keywords)))


def _walk_no_defs(node: ast.AST):
    """Walk ``node`` (inclusive) without descending into nested
    function/class definitions or lambdas — those are separate scopes
    summarized on their own."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, _DEFS + (ast.Lambda,)):
                continue
            stack.append(child)


class Project:
    """Symbol table + call graph + lock summaries over a file set."""

    def __init__(self, paths: Sequence[str], root: Optional[str] = None):
        self.root = root
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self._methods: Dict[str, Dict[str, str]] = {}   # cls -> name->qual
        self._by_name: Dict[str, List[str]] = {}        # name -> [qual]
        self.modules: Dict[str, ast.Module] = {}
        for path in paths:
            rel = path
            if root:
                try:
                    rel = os.path.relpath(path, root)
                except ValueError:
                    pass
            try:
                tree = parse_module(path)
            except (OSError, SyntaxError):
                continue  # absent/unparsable: other layers report that
            self.modules[rel] = tree
            self._collect(tree, rel)
        # __init__ bodies first: they teach element types
        # (``self._slots = [_Slot(i) ...]``) the other summaries consume
        fns = sorted(self.functions.values(),
                     key=lambda f: f.name != "__init__")
        for fn in fns:
            self._summarize(fn)
        self._propagate()

    # -- symbol table ---------------------------------------------------
    def _collect(self, tree: ast.Module, rel: str) -> None:
        def add_fn(node, cls: Optional[str], prefix: str) -> None:
            qual = f"{rel}:{prefix}{node.name}"
            self.functions[qual] = FunctionInfo(
                qual=qual, name=node.name, cls=cls, path=rel, node=node)
            self._by_name.setdefault(node.name, []).append(qual)
            if cls:
                self._methods.setdefault(cls, {}).setdefault(
                    node.name, qual)
            for sub in ast.iter_child_nodes(node):
                walk_defs(sub, cls, f"{prefix}{node.name}.")

        def walk_defs(node, cls: Optional[str], prefix: str) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add_fn(node, cls, prefix)
            elif isinstance(node, ast.ClassDef):
                self._collect_class(node, rel)
                for sub in ast.iter_child_nodes(node):
                    walk_defs(sub, node.name, f"{node.name}.")
            else:
                for sub in ast.iter_child_nodes(node):
                    walk_defs(sub, cls, prefix)

        for node in tree.body:
            walk_defs(node, None, "")

    def _collect_class(self, node: ast.ClassDef, rel: str) -> None:
        # same-name classes across modules merge (over-approximation;
        # none exist in the gated tree today)
        ci = self.classes.setdefault(
            node.name, ClassInfo(node.name, rel, node.lineno))
        init_ids = self._init_node_ids(node)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and is_bounded_join(sub):
                ci.has_bounded_join = True
            if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (sub.targets if isinstance(sub, ast.Assign)
                       else [sub.target])
            value = sub.value
            in_init = id(sub) in init_ids
            for tgt in targets:
                chain = attr_chain(tgt)
                if len(chain) != 2 or chain[0] != "self":
                    continue
                attr = chain[1]
                if value is not None:
                    if _ctor_name(value, LOCK_CTORS):
                        ci.lock_attrs.add(attr)
                    if _ctor_name(value, EVENT_CTORS):
                        ci.event_attrs.add(attr)
                    if isinstance(value, ast.Call):
                        c = attr_chain(value.func)
                        if c and (c[-1][:1].isupper()
                                  or c[-1][:1] == "_"):
                            ci.attr_types.setdefault(attr, c[-1])
                if in_init:
                    ci.init_attrs.add(attr)
                if isinstance(sub, ast.AnnAssign):
                    t = _ann_class(sub.annotation)
                    if t and (t[:1].isupper() or t[:1] == "_"):
                        ci.attr_types.setdefault(attr, t)

    @staticmethod
    def _init_node_ids(cls_node: ast.ClassDef) -> Set[int]:
        """Node ids inside the class's ``__init__`` bodies — one walk
        per class, not one per assignment (the old per-statement
        enclosing-def scan was quadratic in class size)."""
        ids: Set[int] = set()
        for fn in cls_node.body:
            if (isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and fn.name == "__init__"):
                ids.update(id(sub) for sub in ast.walk(fn))
        return ids

    # -- id resolution --------------------------------------------------
    def _attr_owner(self, attr: str, module: str, *,
                    locks_only: bool = False) -> Optional[str]:
        """Class owning ``attr``: unique in ``module`` first, then
        unique project-wide; None on ambiguity (drop, don't guess)."""
        pool = [(n, c) for n, c in self.classes.items()
                if attr in (c.lock_attrs if locks_only else c.init_attrs)]
        same = [n for n, c in pool if c.path == module]
        if len(same) == 1:
            return same[0]
        if len(pool) == 1:
            return pool[0][0]
        return None

    def _expr_class(self, expr: ast.AST, fn: FunctionInfo,
                    local_types: Dict[str, str]) -> Optional[str]:
        """Best-effort class of an expression (``self``, typed locals,
        attr chains walked through recorded attribute types)."""
        chain = attr_chain(expr)
        if not chain:
            return None
        if chain[0] == "self" and fn.cls:
            base: Optional[str] = fn.cls
        else:
            base = local_types.get(chain[0])
        for attr in chain[1:]:
            if base is None or base not in self.classes:
                return None
            base = self.classes[base].attr_types.get(attr)
        return base if base in self.classes else None

    def lock_id(self, expr: ast.AST, fn: FunctionInfo,
                local_locks: Set[str],
                local_types: Dict[str, str]) -> Optional[str]:
        """Canonical lock identity of an acquired expression, or None
        when it is not a recognizable lock."""
        chain = attr_chain(expr)
        if not chain:
            return None
        if len(chain) == 1:
            if chain[0] in local_locks:
                return f"{fn.qual}.{chain[0]}"
            return None
        attr = chain[-1]
        base_cls = (self._expr_class(expr.value, fn, local_types)
                    if isinstance(expr, ast.Attribute) else None)
        if base_cls and attr in self.classes[base_cls].lock_attrs:
            return f"{base_cls}.{attr}"
        owner = self._attr_owner(attr, fn.path, locks_only=True)
        return f"{owner}.{attr}" if owner else None

    def attr_id(self, target: ast.AST, fn: FunctionInfo,
                local_types: Dict[str, str]) -> Optional[str]:
        """Canonical shared-attribute identity of a write target
        (``<Class>.<attr>`` for attributes assigned in that class'
        ``__init__``); None for locals, subscripts, ambiguity."""
        if not isinstance(target, ast.Attribute):
            return None
        chain = attr_chain(target)
        if not chain:
            return None
        attr = chain[-1]
        base_cls = self._expr_class(target.value, fn, local_types)
        if base_cls:
            if attr in self.classes[base_cls].init_attrs:
                return f"{base_cls}.{attr}"
            return None  # known class, attr not shared via __init__
        owner = self._attr_owner(attr, fn.path)
        return f"{owner}.{attr}" if owner else None

    def resolve_call(self, call: ast.Call, fn: FunctionInfo,
                     local_types: Dict[str, str]) -> Optional[str]:
        """Callee qual for a call, or None when ambiguous/external."""
        chain = attr_chain(call.func)
        if not chain:
            return None
        name = chain[-1]
        if len(chain) == 1:
            if name in self.classes:   # Cls(...) -> Cls.__init__
                return self._methods.get(name, {}).get("__init__")
            return self._unique(name, fn.path)
        base_cls = (self._expr_class(call.func.value, fn, local_types)
                    if isinstance(call.func, ast.Attribute) else None)
        if base_cls:
            return self._methods.get(base_cls, {}).get(name)
        return self._unique(name, fn.path, methods_only=True)

    def _unique(self, name: str, module: str,
                methods_only: bool = False) -> Optional[str]:
        quals = [q for q in self._by_name.get(name, ())
                 if not methods_only or self.functions[q].cls]
        same = [q for q in quals if self.functions[q].path == module]
        if len(same) == 1:
            return same[0]
        if len(quals) == 1:
            return quals[0]
        return None

    def resolve_callable_ref(self, expr: ast.AST, fn: FunctionInfo
                             ) -> Optional[str]:
        """A *reference* to a function (Thread ``target=``, callback)."""
        chain = attr_chain(expr)
        if not chain:
            return None
        name = chain[-1]
        if chain[0] == "self" and fn.cls and len(chain) == 2:
            return self._methods.get(fn.cls, {}).get(name)
        if len(chain) == 1:
            return self._unique(name, fn.path)
        return None

    # -- per-function summaries ----------------------------------------
    def _summarize(self, fn: FunctionInfo) -> None:
        local_locks: Set[str] = set()
        local_types: Dict[str, str] = {}
        node = fn.node
        args = getattr(node, "args", None)
        if args is not None:
            for a in list(args.args) + list(args.kwonlyargs):
                t = _ann_class(a.annotation)
                if t and t in self.classes:
                    local_types[a.arg] = t

        def scan_node(expr: ast.AST, held: frozenset,
                      stmt: ast.AST) -> None:
            """Record calls / acquire events / thread starts / callback
            escapes inside one header or simple statement."""
            for sub in _walk_no_defs(expr):
                if not isinstance(sub, ast.Call):
                    continue
                chain = attr_chain(sub.func)
                if chain and chain[-1] in THREAD_CTORS and len(chain) <= 2:
                    self._record_thread(fn, stmt, sub)
                    continue
                callee = self.resolve_call(sub, fn, local_types)
                if callee:
                    fn.calls.append((callee, sub.lineno, held))
                if chain and len(chain) >= 2 and chain[-1] == "acquire":
                    lid = self.lock_id(sub.func.value, fn, local_locks,
                                       local_types)
                    if lid:
                        fn.acquires.append((lid, sub.lineno, held))
                for arg in list(sub.args) + [kw.value
                                             for kw in sub.keywords]:
                    ref = self.resolve_callable_ref(arg, fn)
                    if ref and ref in self.functions:
                        self.functions[ref].escapes = True

        def lock_delta(scope: ast.AST) -> Tuple[Set[str], Set[str]]:
            acq: Set[str] = set()
            rel: Set[str] = set()
            for sub in _walk_no_defs(scope):
                if not isinstance(sub, ast.Call):
                    continue
                chain = attr_chain(sub.func)
                if chain and len(chain) >= 2 and \
                        chain[-1] in ("acquire", "release"):
                    lid = self.lock_id(sub.func.value, fn, local_locks,
                                       local_types)
                    if lid:
                        (acq if chain[-1] == "acquire" else rel).add(lid)
            return acq, rel

        def learn_locals(stmt: ast.AST) -> None:
            if isinstance(stmt, ast.Assign) and stmt.value is not None:
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        if _contains_ctor(stmt.value, LOCK_CTORS):
                            local_locks.add(tgt.id)
                        cls = (_ctor_name(stmt.value, set(self.classes))
                               or self._expr_class(stmt.value, fn,
                                                   local_types))
                        if cls:
                            local_types[tgt.id] = cls
                    elif isinstance(tgt, ast.Tuple) and \
                            isinstance(stmt.value, ast.Tuple):
                        for el, val in zip(tgt.elts, stmt.value.elts):
                            if isinstance(el, ast.Name):
                                cls = self._expr_class(val, fn,
                                                       local_types)
                                if cls:
                                    local_types[el.id] = cls
            if isinstance(stmt, ast.For) and isinstance(stmt.target,
                                                        ast.Name):
                chain = attr_chain(stmt.iter)
                if chain and chain[0] == "self" and fn.cls \
                        and len(chain) == 2:
                    ci = self.classes.get(fn.cls)
                    elem = ci.attr_elem_types.get(chain[1]) if ci else None
                    if elem:
                        local_types[stmt.target.id] = elem

        def record_writes(stmt: ast.AST, held: frozenset) -> None:
            targets: List[ast.AST] = []
            if isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    targets += (list(tgt.elts)
                                if isinstance(tgt, ast.Tuple) else [tgt])
            elif isinstance(stmt, ast.AugAssign):
                targets = [stmt.target]
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                # a bare annotation (``self.x: int``) writes nothing
                targets = [stmt.target]
            for tgt in targets:
                aid = self.attr_id(tgt, fn, local_types)
                if aid:
                    fn.writes.append((aid, tgt.lineno, held))
            # list-of-instances element types out of __init__ bodies
            if (fn.name == "__init__" and fn.cls
                    and isinstance(stmt, ast.Assign)):
                for tgt in stmt.targets:
                    chain = attr_chain(tgt)
                    if len(chain) == 2 and chain[0] == "self":
                        elem = _elem_ctor(stmt.value, set(self.classes))
                        if elem:
                            self.classes[fn.cls].attr_elem_types[
                                chain[1]] = elem

        def walk_body(stmts: Sequence[ast.AST], held: frozenset) -> None:
            cur = set(held)
            for stmt in stmts:
                learn_locals(stmt)
                snap = frozenset(cur)
                if isinstance(stmt, _DEFS):
                    continue
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    added: Set[str] = set()
                    for item in stmt.items:
                        scan_node(item.context_expr, snap, stmt)
                        lid = self.lock_id(item.context_expr, fn,
                                           local_locks, local_types)
                        if lid:
                            fn.acquires.append(
                                (lid, item.context_expr.lineno,
                                 frozenset(cur | added)))
                            added.add(lid)
                    walk_body(stmt.body, frozenset(cur | added))
                elif isinstance(stmt, (ast.If, ast.While)):
                    scan_node(stmt.test, snap, stmt)
                    acq, rel = lock_delta(stmt.test)
                    inner = frozenset(cur | acq)
                    walk_body(stmt.body, inner)
                    walk_body(stmt.orelse, inner)
                    cur |= acq
                    cur -= rel
                elif isinstance(stmt, ast.For):
                    scan_node(stmt.iter, snap, stmt)
                    walk_body(stmt.body, snap)
                    walk_body(stmt.orelse, snap)
                elif isinstance(stmt, ast.Try):
                    walk_body(stmt.body, snap)
                    for h in stmt.handlers:
                        walk_body(h.body, snap)
                    walk_body(stmt.orelse, snap)
                    walk_body(stmt.finalbody, snap)
                    # the acquire -> try/finally: release() idiom: the
                    # finally's release applies to everything after
                    acq, rel = lock_delta(ast.Module(
                        body=list(stmt.finalbody), type_ignores=[]))
                    cur |= acq
                    cur -= rel
                else:
                    record_writes(stmt, snap)
                    scan_node(stmt, snap, stmt)
                    acq, rel = lock_delta(stmt)
                    cur |= acq
                    cur -= rel

        walk_body(getattr(node, "body", []), frozenset())

    def _record_thread(self, fn: FunctionInfo, stmt: ast.AST,
                       call: ast.Call) -> None:
        target_qual = None
        for kw in call.keywords:
            if kw.arg == "target":
                target_qual = self.resolve_callable_ref(kw.value, fn)
        retained = False
        assigned: Optional[str] = None
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                    retained = True
                elif isinstance(tgt, ast.Name):
                    assigned = tgt.id
        if assigned:
            # a local Thread var later stored on an attribute or
            # appended to a container is retained too
            for sub in _walk_no_defs(fn.node):
                if isinstance(sub, ast.Assign) and \
                        isinstance(sub.value, ast.Name) and \
                        sub.value.id == assigned and any(
                            isinstance(t, (ast.Attribute, ast.Subscript))
                            for t in sub.targets):
                    retained = True
                if isinstance(sub, ast.Call):
                    chain = attr_chain(sub.func)
                    if chain and chain[-1] in ("append", "add") and any(
                            isinstance(a, ast.Name) and a.id == assigned
                            for a in sub.args):
                        retained = True
        fn.thread_starts.append(ThreadStart(
            site_qual=fn.qual, lineno=call.lineno,
            target_qual=target_qual, retained=retained))

    # -- interprocedural propagation ------------------------------------
    def _propagate(self) -> None:
        callers: Dict[str, List[Tuple[str, frozenset]]] = {}
        for fn in self.functions.values():
            for callee, _ln, held in fn.calls:
                callers.setdefault(callee, []).append((fn.qual, held))

        # transitive acquires: fixpoint union along call edges
        for fn in self.functions.values():
            fn.trans_acquires = frozenset(l for l, _, _ in fn.acquires)
        changed, guard = True, 0
        while changed and guard < len(self.functions) + 8:
            changed, guard = False, guard + 1
            for fn in self.functions.values():
                acc = set(fn.trans_acquires)
                for callee, _ln, _h in fn.calls:
                    cf = self.functions.get(callee)
                    if cf:
                        acc |= cf.trans_acquires
                if frozenset(acc) != fn.trans_acquires:
                    fn.trans_acquires = frozenset(acc)
                    changed = True

        # entry_held: intersection over known call sites; thread and
        # callback roots (and caller-less functions) enter with nothing
        roots = {ts.target_qual
                 for f in self.functions.values()
                 for ts in f.thread_starts if ts.target_qual}
        roots |= {f.qual for f in self.functions.values() if f.escapes}
        entry: Dict[str, Optional[frozenset]] = {
            q: (frozenset() if q in roots or q not in callers else None)
            for q in self.functions}
        changed, guard = True, 0
        while changed and guard < len(self.functions) + 8:
            changed, guard = False, guard + 1
            for q in self.functions:
                if q in roots or q not in callers:
                    continue
                metas = [entry[cq] | held
                         for cq, held in callers[q]
                         if entry.get(cq) is not None]
                if not metas:
                    continue
                new = frozenset.intersection(*metas)
                if entry[q] is None or new != entry[q]:
                    entry[q] = new
                    changed = True
        for q, fn in self.functions.items():
            fn.entry_held = entry[q] or frozenset()

        # thread reachability: BFS from thread targets + callbacks
        work = list(roots)
        seen: Set[str] = set()
        while work:
            q = work.pop()
            if q in seen or q not in self.functions:
                continue
            seen.add(q)
            self.functions[q].thread_reachable = True
            work.extend(callee for callee, _ln, _h
                        in self.functions[q].calls if callee not in seen)

    # -- derived views the passes consume -------------------------------
    def effective_held(self, fn: FunctionInfo,
                       held: frozenset) -> frozenset:
        return held | fn.entry_held

    def lock_order_edges(self) -> Dict[Tuple[str, str],
                                       List[Tuple[str, int]]]:
        """(held, acquired) -> [(qual, line)] — direct acquisitions plus
        call sites whose callee transitively acquires."""
        edges: Dict[Tuple[str, str], List[Tuple[str, int]]] = {}
        for fn in self.functions.values():
            for lock, ln, held in fn.acquires:
                for l in self.effective_held(fn, held):
                    if l != lock:
                        edges.setdefault((l, lock), []).append(
                            (fn.qual, ln))
            for callee, ln, held in fn.calls:
                cf = self.functions.get(callee)
                if cf is None:
                    continue
                for l in self.effective_held(fn, held):
                    for m in cf.trans_acquires:
                        if m != l:
                            edges.setdefault((l, m), []).append(
                                (fn.qual, ln))
        return edges

    def rel_loc(self, qual: str, lineno: int) -> str:
        """``relpath:Class.method:line`` — the finding location form."""
        path, _, name = qual.partition(":")
        return f"{path}:{name}:{lineno}"
