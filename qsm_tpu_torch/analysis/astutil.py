"""Shared AST plumbing for the lint passes (the counterpart of
``qsm_tpu/analysis/astutil.py``).

Every per-file pass family is a source-level lint: parse the module,
find the functions or classes of interest, walk their bodies.  The
helpers here keep the families on one parser so location formatting
(``relpath:line``) and the discovery protocols cannot drift apart.

Where the reference finds traced device code (the bodies handed to
``while_loop`` / ``fori_loop`` / ``scan`` / ``pallas_call``), the port has
no tracing: its device code is the hand-written kernels, and the host
code that must stay off the host-device link is the LOOP that launches
them chunk after chunk (:func:`launch_loop_function_names`).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Set, Tuple

# The port's kernel wrappers (``ops/*_kernel.py``, ``ops/sweep_generic.py``
# and its launch on arguments already checked): a loop that reaches one of
# these names launches a kernel every trip.
LAUNCH_WRAPPERS = frozenset(("dfs_chunk", "stepper_chunk", "stepper_sweep",
                             "compact_carry", "threefry_draws",
                             "sweep_advance", "advance_unchecked"))


def parse_module(path: str) -> ast.Module:
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def rel_location(path: str, lineno: int, root: Optional[str] = None) -> str:
    """``relpath:line`` — repo-relative when ``root`` contains ``path``."""
    return f"{relpath_of(path, root)}:{lineno}"


def relpath_of(path: str, root: Optional[str] = None) -> str:
    """``path`` relative to ``root`` when one is given."""
    if root:
        try:
            return os.path.relpath(path, root)
        except ValueError:
            pass
    return path


def attr_chain(node: ast.AST) -> List[str]:
    """``torch.cuda.synchronize`` -> ["torch", "cuda", "synchronize"]; []
    when the expression is not a plain name/attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def call_name(call: ast.Call) -> Optional[str]:
    """Last component of the called name (``kernels.build`` ->
    ``build``), or None for computed callees."""
    chain = attr_chain(call.func)
    return chain[-1] if chain else None


def collect_function_defs(tree: ast.Module) -> Dict[str, List[ast.AST]]:
    """name -> FunctionDef nodes anywhere in the module (nested included).
    Same-name collisions across scopes over-approximate — acceptable for
    a lint (a false transitive edge can only widen the flagged set)."""
    defs: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    return defs


def enclosing_function_map(tree: ast.AST) -> dict:
    """node id -> innermost enclosing FunctionDef node."""
    owner: dict = {}
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(fn):
                owner[id(sub)] = fn  # innermost wins (visited last)
    return owner


def _scope_walk(node: ast.AST) -> Iterator[ast.AST]:
    """``node``'s subtree without descending into nested defs or
    lambdas (their bodies run when called, not on this trip)."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                stack.append(child)


def _names_a_wrapper(node: ast.AST) -> bool:
    return ((isinstance(node, ast.Name) and node.id in LAUNCH_WRAPPERS)
            or (isinstance(node, ast.Attribute)
                and node.attr in LAUNCH_WRAPPERS))


def launch_loops(fn: ast.AST) -> List[ast.AST]:
    """The outermost ``for``/``while`` loops of ``fn``'s own body whose
    trip reaches a kernel wrapper: a call of one, or the wrapper handed on
    by name (``shards.compact(compact_carry, ...)``)."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)) and any(
                _names_a_wrapper(sub) for sub in _scope_walk(node)):
            out.append(node)
            continue  # its inner loops are part of the same trip
        stack.extend(ast.iter_child_nodes(node))
    return out


def launch_loop_function_names(tree: ast.Module) -> Set[str]:
    """Names of the functions whose loop launches a kernel wrapper (the
    backends' loops: ``TorchGPU._run_device``, ``TorchStepper._run_device``,
    ...)."""
    return {fn.name for fn in ast.walk(tree)
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            and launch_loops(fn)}


def iter_launch_loop_bodies(tree: ast.Module
                            ) -> Iterator[Tuple[str, ast.AST]]:
    """Yield ``(function_name, node)`` for every node a launch loop runs
    each trip: the loops' own nodes, and the whole bodies of the
    module-local functions they call, transitively (each under its own
    name)."""
    defs = collect_function_defs(tree)
    helpers: Set[str] = set()
    pending: List[Tuple[str, ast.AST]] = []
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            pending += [(fn.name, loop) for loop in launch_loops(fn)]
    while pending:
        name, root = pending.pop()
        for node in _scope_walk(root):
            if node is not root or not isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield name, node
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id in defs and node.func.id not in helpers):
                helpers.add(node.func.id)
                for sub in defs[node.func.id]:
                    pending.append((node.func.id, sub))


# -- the class scan families (k), (m) and (o) share ---------------------------
#
# One definition of "bounded", held by every plane whose objects live as
# long as the process: a class whose instance-attribute container GROWS
# must compare its size against a bound or evict from it somewhere in the
# class.  The reference keeps it in its monitor family's module
# (``monitor_passes.py _scan_class``); the port keeps it here, beside the
# other shared walkers, for the families that use it.

_GROW_CALLS = {"append", "extend", "add", "insert"}
_EVICT_CALLS = {"pop", "popitem", "clear", "popleft"}
_HEAP_GROW = {"heappush"}
_HEAP_EVICT = {"heappop"}


def self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` (or deeper ``self.X.y`` → ``X``) attribute name."""
    chain = attr_chain(node)
    if chain and len(chain) >= 2 and chain[0] == "self":
        return chain[1]
    return None


def _mentions_attr(node: ast.AST, attr: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and self_attr(sub) == attr:
            return True
    return False


class ClassScan:
    __slots__ = ("grows", "disciplined")

    def __init__(self):
        # attr -> (method name, lineno, how) of the first grow site
        self.grows: Dict[str, tuple] = {}
        self.disciplined: Set[str] = set()


def scan_class(cls: ast.ClassDef) -> ClassScan:
    """Grow sites and disciplined (capped or evicted) attributes of one
    class."""
    out = ClassScan()
    owner = enclosing_function_map(cls)
    for node in ast.walk(cls):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if not chain:
                continue
            tail = chain[-1]
            # self.X.append(...) / self.X.pop(...)
            if isinstance(node.func, ast.Attribute):
                attr = self_attr(node.func.value)
                if attr is not None:
                    if tail in _GROW_CALLS and attr not in out.grows:
                        fn = owner.get(id(node))
                        out.grows[attr] = (
                            fn.name if fn else "<class>", node.lineno,
                            f".{tail}()")
                    if tail in _EVICT_CALLS:
                        out.disciplined.add(attr)
            # heapq.heappush(self.X, ...) / heappop(self.X)
            if tail in _HEAP_GROW | _HEAP_EVICT and node.args:
                attr = self_attr(node.args[0])
                if attr is not None:
                    if tail in _HEAP_GROW and attr not in out.grows:
                        fn = owner.get(id(node))
                        out.grows[attr] = (
                            fn.name if fn else "<class>", node.lineno,
                            f"{tail}()")
                    if tail in _HEAP_EVICT:
                        out.disciplined.add(attr)
        elif isinstance(node, ast.Compare):
            # a cap check anywhere in the class that INVOLVES the attr
            # (len(self.X) >= cap, len(self.X) + n > self.max_events)
            for sub in ast.walk(node):
                a = (self_attr(sub)
                     if isinstance(sub, ast.Attribute) else None)
                if a is not None:
                    out.disciplined.add(a)
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript):
                    a = self_attr(tgt.value)
                    if a is not None:
                        out.disciplined.add(a)
        elif isinstance(node, ast.Assign):
            # pruning reassignment: self.X = <expr mentioning self.X>
            for tgt in node.targets:
                a = (self_attr(tgt)
                     if isinstance(tgt, ast.Attribute) else None)
                if a is not None and _mentions_attr(node.value, a):
                    out.disciplined.add(a)
    return out
