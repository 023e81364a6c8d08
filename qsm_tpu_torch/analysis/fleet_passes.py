"""Fleet passes (pass family *j*; the counterpart of
``qsm_tpu/analysis/fleet_passes.py``): re-dispatch discipline for the
multi-node tier.

The fleet router's defining move is RE-DISPATCH: a node that crashes,
wedges or partitions mid-request loses its sub-request, and the lanes
go to another node.  Done wrong, that move converts one dead node into
a fleet-wide outage: an unbounded retry loop spins the router forever
on a deterministic failure, and a loop that never EXCLUDES the node it
just watched fail hands the same lanes back to the same corpse (the
consistent-hash ring, by design, keeps answering the same node for the
same key).  The router's own disciplines — bounded attempts from the
``fleet-route`` preset, the ``tried`` exclusion set fed into the ring
walk (fleet/router.py ``_dispatch_group``) — exist for exactly this;
this pass family is the gate that keeps future fleet code on them.

AST lint over the fleet modules and the chaos soak (gen/soak.py):

* ``QSM-FLEET-REDISPATCH`` (error) — a loop with the re-dispatch shape
  (a ``.request(...)``/``.dispatch(...)`` call whose exception handler
  ``continue``s the loop) that is either:

  - a constant-``True`` ``while`` — no bounded attempt budget: a
    deterministic failure (every node partitioned) spins forever; or
  - bounded, but with NO failed-target exclusion inside the loop — no
    ``X.add(...)`` on a tried/excluded set and no ``exclude=`` keyword
    on the target-picking call: the ring hands the same dead node
    back every attempt, so the budget buys nothing.

  Sanctioned form: ``for _ in range(policy.attempts)`` +
  ``tried.add(target)`` before the request + ``node_for(key,
  exclude=tried)`` on failure (fleet/router.py is the model).

* ``QSM-FLEET-LEASE`` (error) — the router-HA promotion discipline
  (fleet/lease.py).  A promotion is a call through a
  lease-named handle (``lease.acquire(...)`` / ``self.lease.promote``
  etc.) and must be:

  - **bounded** — a constant-``True`` ``while`` wrapping the acquire
    is an unbounded standby-promote loop: with the lease held by a
    live active, the standby spins forever instead of standing by on
    its beat cadence; and
  - **term/expiry-gated** — a function that promotes without ever
    consulting the lease's term or expiry (no ``term``/``expir``
    token anywhere in it) can grab the lease while the record it
    never read is still live, which is exactly the split-brain the
    lease exists to exclude.

  Sanctioned form: one beat-driven attempt per observation —
  ``rec = lease.read(); if lease.expired(rec, grace): ...
  lease.acquire()`` with the term riding the response
  (fleet/router.py ``ha_beat`` is the model).

* ``QSM-FLEET-HANDOFF`` (error) — the elastic-membership discipline
  (fleet/membership.py).  A ring mutation is a call through
  a handle (``membership.add_node(...)`` / ``self.membership.
  remove_node(...)``), and the mutating function must carry the
  matching handoff discipline:

  - a JOIN with no replog handoff anywhere in the function (no
    ``handoff``/``anti_entropy``/``sweep`` token) leaves the newcomer
    owning key ranges whose banked verdict rows it does not hold —
    every key routed there re-folds from scratch and a flip banked on
    the previous owner is invisible until some later sweep; and
  - a LEAVE with no session migration (no ``migrat`` token) leaves
    every routed session naming the retiree as owner — each next verb
    re-dispatches into the void instead of replaying the journal onto
    the new ring owner.

  Sanctioned form: ``add_node`` reporting a join triggers an
  ``anti_entropy_sweep()`` on the spot (gossip-driven,
  subsumption-bounded — nodes already holding the rows ship nothing);
  ``remove_node`` reporting a leave invalidates the retiree's routed
  sessions (``sess.node = None``, counted as migrated) so each
  journal replays onto the new owner on its next verb, exactly-once
  by seq (fleet/router.py ``_handle_membership`` is the model).
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .astutil import attr_chain, parse_module, relpath_of
from .findings import ERROR, Finding

_DISPATCH_CALLS = {"request", "dispatch"}
# promotion verbs reached through a lease-named handle (the handle
# requirement keeps ordinary Lock/Semaphore .acquire() out of scope)
_PROMOTE_CALLS = {"acquire", "promote", "takeover", "take_over"}
_CONSULT_TOKENS = ("term", "expir")
_RING_JOIN_CALLS = {"add_node"}
_RING_LEAVE_CALLS = {"remove_node"}
_HANDOFF_TOKENS = ("handoff", "anti_entropy", "sweep")
_MIGRATE_TOKENS = ("migrat",)


def _is_const_true(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value)


def _function_map(tree: ast.Module) -> dict:
    owner: dict = {}
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(fn):
                owner[id(sub)] = fn.name  # innermost wins
    return owner


def _loop_redispatches(loop: ast.AST) -> bool:
    """The re-dispatch shape: a try whose body carries a dispatch-like
    attribute call and whose handler ``continue``s the loop (failure →
    try elsewhere), both inside this loop."""
    for node in ast.walk(loop):
        if not isinstance(node, ast.Try):
            continue
        has_dispatch = any(
            isinstance(sub, ast.Call)
            and (chain := attr_chain(sub.func))
            and chain[-1] in _DISPATCH_CALLS and len(chain) >= 2
            for stmt in node.body for sub in ast.walk(stmt))
        if not has_dispatch:
            continue
        for handler in node.handlers:
            if any(isinstance(sub, ast.Continue)
                   for stmt in handler.body for sub in ast.walk(stmt)):
                return True
    return False


def _loop_excludes_failed(loop: ast.AST) -> bool:
    """An exclusion discipline inside the loop: a ``X.add(...)`` call
    (the tried/excluded set) or an ``exclude=`` keyword on any call
    (the ring-walk form)."""
    for node in ast.walk(loop):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if chain and chain[-1] == "add" and len(chain) >= 2:
            return True
        if any(kw.arg == "exclude" for kw in node.keywords):
            return True
    return False


def _is_lease_promote(call: ast.Call) -> bool:
    """``<...lease...>.acquire(...)`` — a promotion through a
    lease-named handle (``lease.acquire``, ``self._lease.promote``)."""
    chain = attr_chain(call.func)
    if not chain or len(chain) < 2:
        return False
    if chain[-1] not in _PROMOTE_CALLS:
        return False
    return any("lease" in part.lower() for part in chain[:-1])


def _mentions(fn: ast.AST, tokens) -> bool:
    """Does this function ever touch a thing named for one of
    ``tokens`` — a name, an attribute, or a ``rec["term"]``-style
    string key?"""
    for node in ast.walk(fn):
        text = None
        if isinstance(node, ast.Name):
            text = node.id
        elif isinstance(node, ast.Attribute):
            text = node.attr
        elif isinstance(node, ast.Constant) and isinstance(node.value,
                                                          str):
            text = node.value
        if text is not None and any(tok in text.lower()
                                    for tok in tokens):
            return True
    return False


def _consults_lease_state(fn: ast.AST) -> bool:
    """Does this function ever read a term/expiry-named thing?"""
    return _mentions(fn, _CONSULT_TOKENS)


def _ring_mutation(call: ast.Call, verbs) -> bool:
    """``<...>.add_node(...)`` / ``<...>.remove_node(...)`` — a ring
    mutation through a handle (the handle requirement keeps the
    Membership method DEFINITIONS, which are bare names, out of
    scope)."""
    chain = attr_chain(call.func)
    return bool(chain) and len(chain) >= 2 and chain[-1] in verbs


def _check_handoff_discipline(tree: ast.Module, relpath: str
                              ) -> List[Finding]:
    """QSM-FLEET-HANDOFF (module docstring): per function, at most one
    finding per broken direction — a join with no handoff, a leave
    with no migration."""
    out: List[Finding] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        joins = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and _ring_mutation(n, _RING_JOIN_CALLS)]
        leaves = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                  and _ring_mutation(n, _RING_LEAVE_CALLS)]
        if joins and not _mentions(fn, _HANDOFF_TOKENS):
            out.append(Finding(
                ERROR, "QSM-FLEET-HANDOFF",
                f"{relpath}:{fn.name}:{joins[0].lineno}",
                "ring join without replog handoff — the newcomer owns "
                "key ranges whose banked verdict rows it does not "
                "hold, so every key routed there re-folds from "
                "scratch and a flip banked on the previous owner is "
                "invisible until some later sweep",
                "seed the newcomer on the spot: run "
                "anti_entropy_sweep() (gossip-driven, "
                "subsumption-bounded — nodes already holding the rows "
                "ship nothing) when add_node reports a join "
                "(fleet/router.py _handle_membership is the model)"))
        if leaves and not _mentions(fn, _MIGRATE_TOKENS):
            out.append(Finding(
                ERROR, "QSM-FLEET-HANDOFF",
                f"{relpath}:{fn.name}:{leaves[0].lineno}",
                "ring leave without session migration — every routed "
                "session still naming the retired node as owner "
                "re-dispatches into the void on its next verb instead "
                "of replaying its journal onto the new ring owner",
                "invalidate the retiree's sessions under each session "
                "lock (sess.node = None, counted as migrated) so each "
                "journal replays onto the new owner on the next verb, "
                "exactly-once by seq (fleet/router.py "
                "_handle_membership is the model)"))
    return out


def _check_lease_discipline(tree: ast.Module, relpath: str
                            ) -> List[Finding]:
    """QSM-FLEET-LEASE (module docstring): per function, an unbounded
    promote loop outranks (and subsumes) the termless finding — one
    finding per broken promotion path, not two."""
    out: List[Finding] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        promotes = [n for n in ast.walk(fn)
                    if isinstance(n, ast.Call) and _is_lease_promote(n)]
        if not promotes:
            continue
        unbounded = None
        for loop in ast.walk(fn):
            if isinstance(loop, ast.While) \
                    and _is_const_true(loop.test) \
                    and any(isinstance(n, ast.Call)
                            and _is_lease_promote(n)
                            for n in ast.walk(loop)):
                unbounded = loop
                break
        if unbounded is not None:
            out.append(Finding(
                ERROR, "QSM-FLEET-LEASE",
                f"{relpath}:{fn.name}:{unbounded.lineno}",
                "unbounded standby-promote loop — a while-True around "
                "lease acquisition spins against a live active "
                "forever; promotion belongs on the beat cadence, one "
                "gated attempt per observation",
                "drive promotion from the lease beat: read the "
                "record, consult lease.expired(rec, grace), and "
                "attempt acquire at most once per beat "
                "(fleet/router.py ha_beat is the model)"))
        elif not _consults_lease_state(fn):
            out.append(Finding(
                ERROR, "QSM-FLEET-LEASE",
                f"{relpath}:{fn.name}:{promotes[0].lineno}",
                "promotion path that never consults lease term/expiry "
                "— acquiring without reading the record can take the "
                "lease while the incumbent's term is still live: the "
                "split-brain the lease exists to exclude",
                "gate the acquire on the observed record "
                "(lease.read() + lease.expired(rec, grace)) and carry "
                "the returned term onto every response"))
    return out


def check_fleet_file(path: str, root: Optional[str] = None
                     ) -> List[Finding]:
    tree = parse_module(path)
    relpath = relpath_of(path, root)
    fn_of = _function_map(tree)
    out: List[Finding] = _check_lease_discipline(tree, relpath)
    out += _check_handoff_discipline(tree, relpath)
    for node in ast.walk(tree):
        if not isinstance(node, (ast.While, ast.For)):
            continue
        if not _loop_redispatches(node):
            continue
        name = fn_of.get(id(node), "<module>")
        unbounded = (isinstance(node, ast.While)
                     and _is_const_true(node.test))
        if unbounded:
            out.append(Finding(
                ERROR, "QSM-FLEET-REDISPATCH",
                f"{relpath}:{name}:{node.lineno}",
                "re-dispatch loop with no bounded attempt budget — a "
                "deterministic failure (every node down or "
                "partitioned) spins this while-True forever instead "
                "of degrading to the ladder or shedding",
                "bound attempts with `for _ in range(policy.attempts)` "
                "(the fleet-route preset) and fall through to the "
                "in-process ladder (fleet/router.py _dispatch_group "
                "is the model)"))
        elif not _loop_excludes_failed(node):
            out.append(Finding(
                ERROR, "QSM-FLEET-REDISPATCH",
                f"{relpath}:{name}:{node.lineno}",
                "re-dispatch loop that never excludes the failed node "
                "— the consistent-hash ring answers the same target "
                "for the same key, so every attempt returns to the "
                "corpse and the budget buys nothing",
                "track a `tried` set (tried.add(target) before the "
                "request) and pick the next target with "
                "node_for(key, exclude=tried)"))
    return out
