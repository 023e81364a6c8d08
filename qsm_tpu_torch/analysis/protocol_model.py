"""Protocol IR extraction — the port's wire contract as a checked
artifact (the counterpart of ``qsm_tpu/analysis/protocol_model.py``).

The serve protocol is hand-synced across six layers (paths under
``qsm_tpu_torch/``): ops are declared in ``serve/protocol.py``,
dispatched in ``serve/server.py``, forwarded and re-dispatched in
``fleet/router.py``, called from ``serve/client.py``/
``fleet/gossip.py``/``utils/cli.py`` — and the invariants that keep
the fleet honest (one ``_send`` egress stamps ``node``/``term``; every
retried op is idempotent; SHED is never a verdict) would live only in
prose.  This module extracts the whole-program
protocol IR statically, on top of the :mod:`callgraph` symbol table:

* every op name, with the contract declared in ``serve/protocol.py``
  (``OPS`` / ``IDEMPOTENT_OPS`` / ``*_ENVELOPE`` — parsed from the
  AST, never imported);
* every SEND SITE: a dict literal carrying a constant ``"op"`` key,
  its request keys (literal keys, resolved ``**`` splats, later
  ``req["k"] = ...`` writes in the same function), and whether the
  doc flows into a RETRYING call path (``CheckClient._round_trip``
  failover, ``NodeLink.request`` fresh-socket retry, router
  re-dispatch loops);
* every HANDLER: classes defining both ``_send`` and ``_handle`` are
  egress classes; ``_handle``'s dispatch chain is walked branch-aware
  (``op == "x"`` / ``op in (...) + self._SESSION_OPS``), helper calls
  that receive the request dict propagate the op set, and every doc
  reaching the class egress (directly or through send-forwarding
  wrappers like ``_respond``) contributes its resolved response keys;
* every CONSUMER READ at an op-knowable site (``doc = client.check(
  ...)``; ``resp = link.request({"op": ...})``) — deliberately
  under-approximated: reads through the generic transport are not
  attributed to an op.

The IR is emitted deterministically (sorted keys, repo-relative
paths, no timestamps) as the port's own committed
``PROTOCOL_TORCH.json`` plus a rendered ``PROTOCOL_TORCH.md``, both at
the repo root (``python -m qsm_tpu_torch.analysis.protocol_model``
regenerates them; the reference's ``PROTOCOL.json`` and
``docs/PROTOCOL.md`` are the reference's and are never written here).
Lint family (l) (:mod:`protocol_passes`) checks conformance and gates
drift.  The port's contract is the reference's op for op; its
responses add the port's own keys (``device_error`` on a request the
card failed).

Known IR limits: dynamically computed op names are invisible; a
``{**req, ...}`` splat without a constant ``"op"`` key is recorded as a
request *forward*, not a send site; response docs built from
unresolvable calls mark the op ``dynamic_response`` and the field pass
stands down for that direction.  Pure AST, run on the host: the files
are parsed as text, never imported.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .astutil import attr_chain
from .callgraph import (FunctionInfo, Project, _ann_class, _ctor_name,
                        _walk_no_defs)

PROTOCOL_SOURCE = "qsm_tpu_torch/serve/protocol.py"
PROTOCOL_ARTIFACT = "PROTOCOL_TORCH.json"
PROTOCOL_RENDERING = "PROTOCOL_TORCH.md"
REGENERATE = "python -m qsm_tpu_torch.analysis.protocol_model"

# Envelope fallbacks for sub-programs (fixtures) that carry no
# declarations of their own: the envelope is part of the wire grammar,
# not of any one op.
_DEFAULT_REQUEST_ENVELOPE = ("op", "id", "trace", "parent",
                             "deadline_s")
_DEFAULT_RESPONSE_ENVELOPE = ("ok", "id", "error", "node", "term",
                              "trace", "flight", "shed", "reason",
                              "router")

_CONTRACT_NAMES = ("OPS", "IDEMPOTENT_OPS", "REQUEST_ENVELOPE",
                   "RESPONSE_ENVELOPE")

# resolution bounds: alternatives per doc expression before collapse,
# call-resolution depth guard (cycles collapse to dynamic)
_MAX_ALTS = 6


def _const_strings(expr: ast.AST,
                   env: Dict[str, List[str]]) -> Optional[List[str]]:
    """Evaluate a literal string-collection expression: tuples/lists/
    sets of constants, ``Name``/``self.ATTR`` lookups into ``env``,
    ``tuple()/frozenset()/set()/sorted()`` wrapping, ``+`` concat and
    ``-`` difference.  None when not statically evaluable."""
    if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
        out: List[str] = []
        for e in expr.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return out
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return [expr.value]
    if isinstance(expr, ast.Name):
        return env.get(expr.id)
    if isinstance(expr, ast.Attribute):        # self._SESSION_OPS
        return env.get(expr.attr)
    if isinstance(expr, ast.Call):
        chain = attr_chain(expr.func)
        if (chain and len(expr.args) == 1
                and chain[-1] in ("tuple", "frozenset", "set",
                                  "sorted", "list")):
            return _const_strings(expr.args[0], env)
        return None
    if isinstance(expr, ast.BinOp):
        left = _const_strings(expr.left, env)
        right = _const_strings(expr.right, env)
        if left is None or right is None:
            return None
        if isinstance(expr.op, ast.Add):
            return left + right
        if isinstance(expr.op, ast.Sub):
            return [x for x in left if x not in right]
        return None
    return None


class Contract:
    """The declared contract: module-level tuples in
    ``serve/protocol.py`` plus class-level ``OPS``/``IDEMPOTENT_OPS``
    declarations (fixture sub-programs declare their vocabulary on the
    stub classes themselves)."""

    def __init__(self) -> None:
        self.ops: Set[str] = set()
        self.idempotent: Set[str] = set()
        self.request_envelope: Set[str] = set(_DEFAULT_REQUEST_ENVELOPE)
        self.response_envelope: Set[str] = set(
            _DEFAULT_RESPONSE_ENVELOPE)
        self.source: Optional[str] = None    # module declaring OPS
        self.declared = False

    @staticmethod
    def _scan_body(body: Sequence[ast.stmt],
                   env: Dict[str, List[str]]) -> Dict[str, List[str]]:
        found: Dict[str, List[str]] = {}
        for stmt in body:
            if not (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                continue
            name = stmt.targets[0].id
            vals = _const_strings(stmt.value, env)
            if vals is not None:
                env[name] = vals
                if name in _CONTRACT_NAMES:
                    found[name] = vals
        return found

    def absorb(self, found: Dict[str, List[str]], rel: str,
               module_level: bool) -> None:
        if "OPS" in found:
            self.ops.update(found["OPS"])
            self.declared = True
            if module_level and self.source is None:
                self.source = rel
        if "IDEMPOTENT_OPS" in found:
            self.idempotent.update(found["IDEMPOTENT_OPS"])
            self.declared = True
        if module_level and "REQUEST_ENVELOPE" in found:
            self.request_envelope.update(found["REQUEST_ENVELOPE"])
        if module_level and "RESPONSE_ENVELOPE" in found:
            self.response_envelope.update(found["RESPONSE_ENVELOPE"])


class SendSite:
    def __init__(self, op: str, qual: str, line: int, path_kind: str):
        self.op = op
        self.qual = qual
        self.line = line
        self.path_kind = path_kind
        self.request_keys: Set[str] = set()
        self.dynamic_request = False
        self.retried = False
        self.retry_via: Set[str] = set()
        self.forwards_request = False   # {**req, ...} re-dispatch


class Handler:
    def __init__(self, cls: str, role: str, path: str):
        self.cls = cls
        self.role = role
        self.path = path
        self.request_keys_read: Set[str] = set()
        self.response_keys_written: Set[str] = set()
        self.response_alts: List[Tuple[Set[str], bool, bool]] = []
        self.dynamic_response = False
        self.ha_gated = False
        self.forwards_request = False


def _path_kind(rel: str) -> str:
    base = os.path.basename(rel)
    if base == "client.py":
        return "client"
    if base == "router.py":
        return "router"
    if base == "cli.py":
        return "cli"
    if base == "fixtures.py":
        return "fixture"
    if base in ("gossip.py", "membership.py"):
        return "fleet"
    return os.path.splitext(base)[0]


class ProtocolModel:
    """The extracted whole-program protocol IR over one file set."""

    def __init__(self, files: Sequence[str],
                 root: Optional[str] = None):
        self.project = Project(
            [f for f in files if f.endswith(".py")], root=root)
        self.contract = Contract()
        self.send_sites: List[SendSite] = []
        # (op, class) -> Handler
        self.handlers: Dict[Tuple[str, str], Handler] = {}
        # op -> [(key, qual, line)]
        self.consumer_reads: Dict[str, List[Tuple[str, str, int]]] = {}
        self.egress: Dict[str, dict] = {}        # class -> egress info
        self.egress_violations: List[Tuple[str, int, str]] = []
        # op -> ops it was co-attributed with (multi-op dispatch
        # branches and shared helper tails): the field pass checks
        # request keys against the GROUP's sender union, since
        # whole-helper aggregation cannot split reads per op
        self.co_dispatched: Dict[str, Set[str]] = {}
        self._module_env: Dict[str, Dict[str, List[str]]] = {}
        self._class_env: Dict[str, Dict[str, List[str]]] = {}
        self._fn_assigns: Dict[str, Dict[str, list]] = {}
        self._fn_subwrites: Dict[str, Dict[str, List[Optional[str]]]] = {}
        self._fn_types: Dict[str, Dict[str, str]] = {}
        self._ret_cache: Dict[str, List[Tuple[Set[str], bool, bool]]] = {}
        # hot-path memos — the forwarding/retrying fixpoints revisit
        # every function per round, so call lists, resent-name sets
        # and call resolutions are computed once per function/node
        self._fn_calls: Dict[str, List[ast.Call]] = {}
        self._fn_resent: Dict[str, Set[str]] = {}
        self._resolve_memo: Dict[int, Optional[str]] = {}
        self._extract()

    # -- contract -----------------------------------------------------
    def _read_contract(self) -> None:
        for rel in sorted(self.project.modules):
            tree = self.project.modules[rel]
            env: Dict[str, List[str]] = {}
            found = Contract._scan_body(tree.body, env)
            self._module_env[rel] = env
            self.contract.absorb(found, rel, module_level=True)
            for stmt in tree.body:
                if not isinstance(stmt, ast.ClassDef):
                    continue
                cls_env = dict(env)
                cls_found = Contract._scan_body(stmt.body, cls_env)
                self._class_env[stmt.name] = cls_env
                self.contract.absorb(cls_found, rel,
                                     module_level=False)

    # -- per-function facts -------------------------------------------
    def _assigns(self, fn: FunctionInfo) -> Dict[str, list]:
        got = self._fn_assigns.get(fn.qual)
        if got is None:
            got = {}
            subs: Dict[str, List[Optional[str]]] = {}
            for n in _walk_no_defs(fn.node):
                if (isinstance(n, ast.Assign) and len(n.targets) == 1):
                    t = n.targets[0]
                    if isinstance(t, ast.Name):
                        got.setdefault(t.id, []).append(n.value)
                    elif (isinstance(t, ast.Subscript)
                          and isinstance(t.value, ast.Name)):
                        key = (t.slice.value
                               if isinstance(t.slice, ast.Constant)
                               and isinstance(t.slice.value, str)
                               else None)
                        subs.setdefault(t.value.id, []).append(key)
            self._fn_assigns[fn.qual] = got
            self._fn_subwrites[fn.qual] = subs
        return got

    def _subwrites(self, fn: FunctionInfo
                   ) -> Dict[str, List[Optional[str]]]:
        self._assigns(fn)
        return self._fn_subwrites[fn.qual]

    def _local_types(self, fn: FunctionInfo) -> Dict[str, str]:
        got = self._fn_types.get(fn.qual)
        if got is not None:
            return got
        types: Dict[str, str] = {}
        classes = set(self.project.classes)
        node = fn.node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            for arg in (list(a.posonlyargs) + list(a.args)
                        + list(a.kwonlyargs)):
                cls = _ann_class(arg.annotation)
                if cls in classes:
                    types[arg.arg] = cls
        for n in _walk_no_defs(fn.node):
            if (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)):
                name = _ctor_name(n.value, classes)
                if name:
                    types[n.targets[0].id] = name
            elif isinstance(n, ast.With):
                for item in n.items:
                    if (item.optional_vars is not None
                            and isinstance(item.optional_vars,
                                           ast.Name)):
                        name = _ctor_name(item.context_expr, classes)
                        if name:
                            types[item.optional_vars.id] = name
        self._fn_types[fn.qual] = types
        return types

    def _resolve(self, call: ast.Call,
                 fn: FunctionInfo) -> Optional[str]:
        """``Project.resolve_call`` plus a method-name fallback for
        chains ``attr_chain`` cannot root (``self.links[nid].request``
        — Subscript bases).  Memoised by call-node identity: the same
        AST nodes are revisited every fixpoint round."""
        key = id(call)
        if key in self._resolve_memo:
            return self._resolve_memo[key]
        got = self.project.resolve_call(call, fn,
                                        self._local_types(fn))
        if got is None and isinstance(call.func, ast.Attribute):
            got = self.project._unique(call.func.attr, fn.path,
                                       methods_only=True)
        self._resolve_memo[key] = got
        return got

    # -- doc resolution -----------------------------------------------
    def _resolve_doc(self, expr: ast.AST, fn: FunctionInfo,
                     visiting: Set[str]
                     ) -> List[Tuple[Set[str], bool, bool]]:
        """Alternatives for a response/request doc expression:
        ``(keys, dynamic, merged)`` triples.  ``dynamic`` = some key
        source could not be resolved; ``merged`` = alternatives were
        collapsed (the SHED pass must not trust the combination)."""
        if isinstance(expr, ast.Dict):
            alts: List[Tuple[Set[str], bool, bool]] = [(set(), False,
                                                        False)]
            for key, value in zip(expr.keys, expr.values):
                if key is None:                       # ** splat
                    subs = self._resolve_doc(value, fn, visiting)
                    alts = self._cross(alts, subs)
                elif (isinstance(key, ast.Constant)
                        and isinstance(key.value, str)):
                    for keys, _dyn, _m in alts:
                        keys.add(key.value)
                else:                                 # computed key
                    alts = [(k, True, m) for k, _d, m in alts]
            return alts
        if isinstance(expr, ast.Name):
            values = self._assigns(fn).get(expr.id)
            if not values:
                return [(set(), True, False)]
            alts = []
            for v in values:
                alts.extend(self._resolve_doc(v, fn, visiting))
            alts = self._cap(alts)
            for key in self._subwrites(fn).get(expr.id, ()):
                if key is None:
                    alts = [(k, True, m) for k, _d, m in alts]
                else:
                    for keys, _d, _m in alts:
                        keys.add(key)
            return alts
        if isinstance(expr, ast.Call):
            callee = self._resolve(expr, fn)
            if callee is None or callee in visiting:
                return [(set(), True, False)]
            return self._returns_of(callee, visiting)
        if isinstance(expr, ast.IfExp):
            return self._cap(
                self._resolve_doc(expr.body, fn, visiting)
                + self._resolve_doc(expr.orelse, fn, visiting))
        return [(set(), True, False)]

    @staticmethod
    def _cap(alts: List[Tuple[Set[str], bool, bool]]
             ) -> List[Tuple[Set[str], bool, bool]]:
        if len(alts) <= _MAX_ALTS:
            return alts
        union: Set[str] = set()
        dyn = False
        for keys, d, _m in alts:
            union |= keys
            dyn = dyn or d
        return [(union, dyn, True)]

    @classmethod
    def _cross(cls, alts, subs):
        out = []
        for keys, dyn, m in alts:
            for skeys, sdyn, sm in subs:
                out.append((set(keys) | skeys, dyn or sdyn, m or sm))
        return cls._cap(out)

    def _returns_of(self, qual: str, visiting: Set[str]
                    ) -> List[Tuple[Set[str], bool, bool]]:
        got = self._ret_cache.get(qual)
        if got is not None:
            return got
        fn = self.project.functions.get(qual)
        if fn is None:
            return [(set(), True, False)]
        visiting = visiting | {qual}
        alts: List[Tuple[Set[str], bool, bool]] = []
        for n in _walk_no_defs(fn.node):
            if isinstance(n, ast.Return) and n.value is not None:
                if (isinstance(n.value, ast.Constant)
                        and n.value.value is None):
                    continue
                alts.extend(self._resolve_doc(n.value, fn, visiting))
        if not alts:
            alts = [(set(), True, False)]
        alts = self._cap(alts)
        self._ret_cache[qual] = alts
        return alts

    # -- egress classes and send-forwarding ---------------------------
    def _find_egress(self) -> None:
        methods = self.project._methods
        for cls, named in methods.items():
            if "_send" not in named or "_handle" not in named:
                continue
            send_fn = self.project.functions[named["_send"]]
            stamps: Set[str] = set()
            for n in _walk_no_defs(send_fn.node):
                if isinstance(n, ast.Dict) and None in n.keys:
                    for key in n.keys:
                        if (isinstance(key, ast.Constant)
                                and isinstance(key.value, str)):
                            stamps.add(key.value)
                elif (isinstance(n, ast.Assign) and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Subscript)):
                    s = n.targets[0].slice
                    if (isinstance(s, ast.Constant)
                            and isinstance(s.value, str)):
                        stamps.add(s.value)
            info = self.project.classes.get(cls)
            role = ("router" if "_active_now" in named else "node")
            self.egress[cls] = {
                "path": info.path if info else send_fn.path,
                "method": "_send", "role": role,
                "stamps": sorted(stamps),
            }

    def _forwarding_params(self) -> Dict[str, Set[int]]:
        """Fixpoint: qual -> parameter positions (0-based, ``self``
        included) whose value reaches an egress (``_send``/
        ``send_doc``).  Seeds: every egress class ``_send`` doc param;
        ``send_doc``'s own doc param."""
        fwd: Dict[str, Set[int]] = {}
        for cls in self.egress:
            qual = self.project._methods[cls]["_send"]
            fn = self.project.functions[qual]
            n = len(self._param_names(fn))
            fwd[qual] = {i for i in range(2, n)} or {n - 1}
        for qual, fn in self.project.functions.items():
            if fn.name == "send_doc" and fn.cls is None:
                fwd[qual] = {1}
        changed = True
        while changed:
            changed = False
            for qual, fn in self.project.functions.items():
                params = self._param_names(fn)
                if not params:
                    continue
                mine = fwd.setdefault(qual, set())
                for call in self._calls_in(fn):
                    for pos in self._sent_positions(call, fn, fwd):
                        arg = self._arg_at(call, fn, pos)
                        if (isinstance(arg, ast.Name)
                                and arg.id in params):
                            idx = params.index(arg.id)
                            if idx not in mine:
                                mine.add(idx)
                                changed = True
        return fwd

    @staticmethod
    def _param_names(fn: FunctionInfo) -> List[str]:
        node = fn.node
        if not isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
            return []
        a = node.args
        return [x.arg for x in
                list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]

    def _calls_in(self, fn: FunctionInfo) -> List[ast.Call]:
        got = self._fn_calls.get(fn.qual)
        if got is None:
            got = [n for n in _walk_no_defs(fn.node)
                   if isinstance(n, ast.Call)]
            self._fn_calls[fn.qual] = got
        return got

    def _sent_positions(self, call: ast.Call, fn: FunctionInfo,
                        fwd: Dict[str, Set[int]]) -> Set[int]:
        """Positions (in the CALLEE's parameter list) of this call's
        doc-forwarding parameters."""
        chain = attr_chain(call.func)
        name = chain[-1] if chain else (
            call.func.attr if isinstance(call.func, ast.Attribute)
            else None)
        if name == "send_doc":
            return {1}
        callee = self._resolve(call, fn)
        if callee is None:
            return set()
        return fwd.get(callee, set())

    def _arg_at(self, call: ast.Call, fn: FunctionInfo,
                pos: int) -> Optional[ast.AST]:
        """The argument expression landing in callee parameter
        ``pos``.  Bound-method calls (``self.m(...)``, ``obj.m(...)``)
        shift positional args by one for the bound ``self``; calls to
        plain functions (``send_doc(sock, doc)``) do not."""
        offset = 1 if isinstance(call.func, ast.Attribute) else 0
        idx = pos - offset
        if 0 <= idx < len(call.args):
            return call.args[idx]
        return None

    # -- send sites ---------------------------------------------------
    def _op_dicts(self, fn: FunctionInfo
                  ) -> List[Tuple[str, ast.Dict]]:
        out = []
        for n in _walk_no_defs(fn.node):
            if not isinstance(n, ast.Dict):
                continue
            for key, value in zip(n.keys, n.values):
                if (isinstance(key, ast.Constant) and key.value == "op"
                        and isinstance(value, ast.Constant)
                        and isinstance(value.value, str)):
                    out.append((value.value, n))
                    break
        return out

    def _collect_send_sites(self) -> None:
        for qual in sorted(self.project.functions):
            fn = self.project.functions[qual]
            resent = self._resent_names(fn)
            assigns = self._assigns(fn)
            for op, node in self._op_dicts(fn):
                site = SendSite(op, qual, node.lineno,
                                _path_kind(fn.path))
                for keys, dyn, _m in self._cap(
                        self._resolve_doc(node, fn, set())):
                    site.request_keys |= keys
                    site.dynamic_request |= dyn
                var = None
                for name, values in assigns.items():
                    if node in values:
                        var = name
                        break
                if var is not None:
                    for key in self._subwrites(fn).get(var, ()):
                        if key is None:
                            site.dynamic_request = True
                        else:
                            site.request_keys.add(key)
                self._mark_retries(site, node, var, fn, resent)
                self.send_sites.append(site)

    # -- retry analysis -----------------------------------------------
    def _resent_names(self, fn: FunctionInfo) -> Set[str]:
        """Names re-sent across attempts inside ``fn``: call args in a
        try body whose except continues a surrounding loop, and call
        args of an except-handler call that re-invokes the try body's
        callee (the NodeLink fresh-socket shape)."""
        cached = self._fn_resent.get(fn.qual)
        if cached is not None:
            return cached
        resent: Set[str] = set()
        for loop in _walk_no_defs(fn.node):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for t in ast.walk(loop):
                if not isinstance(t, ast.Try):
                    continue
                retries = any(
                    isinstance(x, ast.Continue)
                    for h in t.handlers for x in ast.walk(h))
                if not retries:
                    continue
                for n in t.body:
                    for c in ast.walk(n):
                        if isinstance(c, ast.Call):
                            resent.update(
                                a.id for a in c.args
                                if isinstance(a, ast.Name))
        for t in _walk_no_defs(fn.node):
            if not isinstance(t, ast.Try):
                continue
            tried = {attr_chain(c.func)[-1]
                     for n in t.body for c in ast.walk(n)
                     if isinstance(c, ast.Call)
                     and attr_chain(c.func)}
            for h in t.handlers:
                for c in ast.walk(h):
                    if (isinstance(c, ast.Call) and attr_chain(c.func)
                            and attr_chain(c.func)[-1] in tried):
                        resent.update(a.id for a in c.args
                                      if isinstance(a, ast.Name))
        self._fn_resent[fn.qual] = resent
        return resent

    def _retrying_params(self) -> Dict[str, Set[str]]:
        """qual -> request-doc parameter names that end up re-sent,
        transitively (``CheckClient.check`` passes ``req`` into
        ``_round_trip`` whose ``req`` retries)."""
        direct: Dict[str, Set[str]] = {}
        for qual, fn in self.project.functions.items():
            params = set(self._param_names(fn))
            hits = self._resent_names(fn) & params
            if hits:
                direct[qual] = hits
        changed = True
        while changed:
            changed = False
            for qual, fn in self.project.functions.items():
                params = self._param_names(fn)
                if not params:
                    continue
                mine = direct.setdefault(qual, set())
                for call in self._calls_in(fn):
                    callee = self._resolve(call, fn)
                    if callee is None or callee not in direct:
                        continue
                    cps = self._param_names(
                        self.project.functions[callee])
                    for pname in direct[callee]:
                        if pname not in cps:
                            continue
                        arg = self._arg_at(call, fn,
                                           cps.index(pname))
                        if (isinstance(arg, ast.Name)
                                and arg.id in params
                                and arg.id not in mine):
                            mine.add(arg.id)
                            changed = True
        return {q: s for q, s in direct.items() if s}

    def _mark_retries(self, site: SendSite, node: ast.Dict,
                      var: Optional[str], fn: FunctionInfo,
                      resent: Set[str]) -> None:
        if var is not None and var in resent:
            site.retried = True
            site.retry_via.add(fn.qual)
        retrying = self._retrying
        for call in self._calls_in(fn):
            carries = (node in call.args
                       or (var is not None
                           and any(isinstance(a, ast.Name)
                                   and a.id == var
                                   for a in call.args)))
            if not carries:
                continue
            callee = self._resolve(call, fn)
            if callee is None or callee not in retrying:
                continue
            cps = self._param_names(self.project.functions[callee])
            for pname in retrying[callee]:
                if pname not in cps:
                    continue
                arg = self._arg_at(call, fn, cps.index(pname))
                hit = (arg is node
                       or (isinstance(arg, ast.Name)
                           and var is not None and arg.id == var))
                if hit:
                    site.retried = True
                    site.retry_via.add(callee)

    # -- handler extraction -------------------------------------------
    def _handler(self, cls: str, op: str) -> Handler:
        h = self.handlers.get((op, cls))
        if h is None:
            info = self.egress[cls]
            h = Handler(cls, info["role"], info["path"])
            self.handlers[(op, cls)] = h
        return h

    def _branch_ops(self, test: ast.AST, op_var: str,
                    env: Dict[str, List[str]]
                    ) -> Tuple[Optional[List[str]], bool]:
        """Op set named by a dispatch test, plus whether the branch is
        the router HA gate (an ``_active_now`` clause rides along)."""
        if isinstance(test, ast.BoolOp) and isinstance(test.op,
                                                      ast.And):
            ops = None
            ha = False
            for clause in test.values:
                got, _ = self._branch_ops(clause, op_var, env)
                if got is not None and ops is None:
                    ops = got
                if any(isinstance(n, ast.Call)
                       and attr_chain(n.func)
                       and attr_chain(n.func)[-1] == "_active_now"
                       for n in ast.walk(clause)):
                    ha = True
            return ops, ha
        if isinstance(test, ast.Compare) and len(test.ops) == 1:
            left, cmp = test.left, test.ops[0]
            if not (isinstance(left, ast.Name) and left.id == op_var):
                return None, False
            target = test.comparators[0]
            if isinstance(cmp, ast.Eq):
                if (isinstance(target, ast.Constant)
                        and isinstance(target.value, str)):
                    return [target.value], False
            elif isinstance(cmp, ast.In):
                vals = _const_strings(target, env)
                if vals is not None:
                    return vals, False
        return None, False

    def _extract_handlers(self) -> None:
        for cls in sorted(self.egress):
            named = self.project._methods[cls]
            handle_fn = self.project.functions[named["_handle"]]
            env = self._class_env.get(cls, {})
            op_var, req_var = self._dispatch_vars(handle_fn)
            if req_var is None:
                continue
            self._pending: List[Tuple[str, List[str], str]] = []
            served: Set[str] = set()
            self._walk_dispatch(handle_fn, handle_fn.node.body,
                                op_var, req_var, env, cls, served)
            # root-level request reads (before/outside the chain)
            # apply to every op this class serves
            if served:
                root_reads = self._request_reads(
                    handle_fn, req_var, outside_dispatch=True,
                    op_var=op_var, env=env)
                for op in served:
                    self._handler(cls, op).request_keys_read |= \
                        root_reads
            # propagate into helpers that received the request dict
            seen: Dict[str, Set[str]] = {}
            while self._pending:
                qual, ops, param = self._pending.pop()
                done = seen.setdefault(f"{qual}:{param}", set())
                new = [o for o in ops if o not in done]
                if not new:
                    continue
                done.update(new)
                self._absorb_helper(cls, qual, new, param)

    def _dispatch_vars(self, fn: FunctionInfo
                       ) -> Tuple[Optional[str], Optional[str]]:
        """(op variable, request variable) of a ``_handle``: the
        ``op = req.get("op", ...)`` assignment, or an ``op``/``req``
        parameter pair."""
        params = self._param_names(fn)
        op_var = "op" if "op" in params else None
        req_var = None
        for cand in ("req", "request", "doc", "msg"):
            if cand in params:
                req_var = cand
                break
        for n in _walk_no_defs(fn.node):
            if (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and isinstance(n.value, ast.Call)
                    and isinstance(n.value.func, ast.Attribute)
                    and n.value.func.attr == "get"
                    and isinstance(n.value.func.value, ast.Name)
                    and n.value.args
                    and isinstance(n.value.args[0], ast.Constant)
                    and n.value.args[0].value == "op"):
                op_var = n.targets[0].id
                req_var = n.value.func.value.id
        return op_var, req_var

    def _walk_dispatch(self, fn: FunctionInfo, stmts, op_var, req_var,
                       env, cls: str, served: Set[str],
                       ops_ctx: Optional[List[str]] = None,
                       restrict: Optional[Set[str]] = None) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.If) and op_var is not None:
                ops, ha = self._branch_ops(stmt.test, op_var, env)
                if ops is not None and restrict is not None:
                    ops = [o for o in ops if o in restrict]
                if ops is not None:
                    served.update(ops)
                    for op in ops:
                        h = self._handler(cls, op)
                        if ha:
                            h.ha_gated = True
                    self._walk_dispatch(fn, stmt.body, op_var,
                                        req_var, env, cls, served,
                                        ops, restrict)
                else:
                    if ops_ctx:
                        self._absorb_stmt(fn, stmt.test, ops_ctx,
                                          req_var, cls)
                    self._walk_dispatch(fn, stmt.body, op_var,
                                        req_var, env, cls, served,
                                        ops_ctx, restrict)
                self._walk_dispatch(fn, stmt.orelse, op_var, req_var,
                                    env, cls, served, ops_ctx,
                                    restrict)
                continue
            if isinstance(stmt, (ast.Try,)):
                for blk in (stmt.body, stmt.orelse, stmt.finalbody):
                    self._walk_dispatch(fn, blk, op_var, req_var, env,
                                        cls, served, ops_ctx, restrict)
                for h in stmt.handlers:
                    self._walk_dispatch(fn, h.body, op_var, req_var,
                                        env, cls, served, ops_ctx,
                                        restrict)
                continue
            if isinstance(stmt, (ast.With, ast.For, ast.While)):
                if ops_ctx:
                    for sub in (getattr(stmt, "test", None),
                                getattr(stmt, "iter", None)):
                        if sub is not None:
                            self._absorb_stmt(fn, sub, ops_ctx,
                                              req_var, cls)
                self._walk_dispatch(fn, stmt.body, op_var, req_var,
                                    env, cls, served, ops_ctx,
                                    restrict)
                if hasattr(stmt, "orelse"):
                    self._walk_dispatch(fn, stmt.orelse, op_var,
                                        req_var, env, cls, served,
                                        ops_ctx, restrict)
                continue
            if ops_ctx:
                self._absorb_stmt(fn, stmt, ops_ctx, req_var, cls)

    def _absorb_stmt(self, fn: FunctionInfo, stmt: ast.AST,
                     ops: List[str], req_var: str, cls: str) -> None:
        """One statement inside an op-attributed dispatch branch:
        request reads, egress docs, helper propagation."""
        if len(ops) > 1:
            for op in ops:
                self.co_dispatched.setdefault(op, set()).update(ops)
        reads, forwards = self._reads_in(stmt, req_var)
        for op in ops:
            h = self._handler(cls, op)
            h.request_keys_read |= reads
            h.forwards_request |= forwards
        for call in (n for n in ast.walk(stmt)
                     if isinstance(n, ast.Call)):
            if any(isinstance(a, ast.Name) and a.id == req_var
                   for a in call.args):
                callee = self._resolve(call, fn)
                if callee is not None:
                    cps = self._param_names(
                        self.project.functions[callee])
                    for i, a in enumerate(call.args):
                        if (isinstance(a, ast.Name)
                                and a.id == req_var):
                            offset = (1 if isinstance(call.func,
                                                      ast.Attribute)
                                      else 0)
                            if i + offset < len(cps):
                                self._pending.append(
                                    (callee, list(ops),
                                     cps[i + offset]))
        self._absorb_egress(fn, stmt, ops, cls)

    def _absorb_egress(self, fn: FunctionInfo, stmt: ast.AST,
                       ops: List[str], cls: str) -> None:
        fwd = self._fwd
        for call in (n for n in ast.walk(stmt)
                     if isinstance(n, ast.Call)):
            for pos in self._sent_positions(call, fn, fwd):
                arg = self._arg_at(call, fn, pos)
                if arg is None:
                    continue
                alts = self._cap(self._resolve_doc(arg, fn, set()))
                for op in ops:
                    h = self._handler(cls, op)
                    h.response_alts.extend(alts)
                    for keys, dyn, _m in alts:
                        h.response_keys_written |= keys
                        h.dynamic_response |= dyn

    def _absorb_helper(self, cls: str, qual: str, ops: List[str],
                       param: str) -> None:
        """Attribution for a helper that received the request dict
        (``_handle_check(conn, req)``, ``_handle_obs(conn, op, req)``
        …).  A helper that also receives the ``op`` variable gets the
        same branch-aware walk as the dispatch root — its internal
        ``if op == ...`` chain refines which of ``ops`` each read and
        response belongs to; statements outside any op test (shared
        preambles and tails) attribute to the whole passed set.
        Helpers without an ``op`` parameter aggregate whole-function.

        A helper may also RETURN the response doc to a caller that
        sends it; that flow is covered by the caller's own egress-site
        resolution (``doc = self._route_session(...)`` then
        ``self._respond(conn, doc)``), not here."""
        fn = self.project.functions.get(qual)
        if fn is None:
            return
        env = self._class_env.get(fn.cls or "",
                                  self._class_env.get(cls, {}))
        op_var = "op" if "op" in self._param_names(fn) else None
        self._walk_dispatch(fn, fn.node.body, op_var, param, env,
                            cls, set(), ops_ctx=list(ops),
                            restrict=set(ops))

    def _reads_in(self, stmt: ast.AST,
                  req_var: str) -> Tuple[Set[str], bool]:
        reads: Set[str] = set()
        forwards = False
        for n in ast.walk(stmt):
            if (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "get"
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == req_var
                    and n.args
                    and isinstance(n.args[0], ast.Constant)
                    and isinstance(n.args[0].value, str)):
                reads.add(n.args[0].value)
            elif (isinstance(n, ast.Subscript)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == req_var
                    and isinstance(n.slice, ast.Constant)
                    and isinstance(n.slice.value, str)
                    and isinstance(getattr(n, "ctx", None), ast.Load)):
                reads.add(n.slice.value)
            elif (isinstance(n, ast.Compare) and len(n.ops) == 1
                    and isinstance(n.ops[0], (ast.In, ast.NotIn))
                    and isinstance(n.left, ast.Constant)
                    and isinstance(n.left.value, str)
                    and isinstance(n.comparators[0], ast.Name)
                    and n.comparators[0].id == req_var):
                reads.add(n.left.value)
            elif isinstance(n, ast.Dict):
                for key, value in zip(n.keys, n.values):
                    if (key is None and isinstance(value, ast.Name)
                            and value.id == req_var):
                        forwards = True
        return reads, forwards

    def _request_reads(self, fn: FunctionInfo, req_var: str, *,
                       outside_dispatch: bool, op_var: Optional[str],
                       env: Dict[str, List[str]]) -> Set[str]:
        """Request reads at the dispatch root outside any op branch
        (the ``op = req.get("op")`` preamble)."""
        reads: Set[str] = set()
        for stmt in fn.node.body:
            if isinstance(stmt, ast.If) and op_var is not None:
                ops, _ = self._branch_ops(stmt.test, op_var, env)
                if ops is not None:
                    continue
            got, _ = self._reads_in(stmt, req_var)
            reads |= got
        return reads

    # -- egress discipline --------------------------------------------
    def _collect_egress_violations(self) -> None:
        """Raw ``send_doc``/``sendall`` calls inside an egress class
        but outside its ``_send`` — responses that would skip the
        node/term stamping."""
        for qual in sorted(self.project.functions):
            fn = self.project.functions[qual]
            if fn.cls not in self.egress or fn.name == "_send":
                continue
            for call in self._calls_in(fn):
                chain = attr_chain(call.func)
                name = chain[-1] if chain else (
                    call.func.attr
                    if isinstance(call.func, ast.Attribute) else None)
                if name in ("send_doc", "sendall"):
                    self.egress_violations.append(
                        (qual, call.lineno, name))

    # -- consumer reads -----------------------------------------------
    def _op_of_function(self) -> Dict[str, Set[str]]:
        # fn qual -> ops whose *transport response* the function hands
        # back.  Qualifies only when some ``return`` value is a call
        # carrying the op doc (inline dict, or a local bound to one):
        # ``return self._round_trip(req)`` counts; a helper that sends
        # an op but returns a value derived *from* the response (e.g.
        # one element of ``resp["covers"]``) does not.
        ops: Dict[str, Set[str]] = {}
        by_qual: Dict[str, Set[str]] = {}
        for site in self.send_sites:
            by_qual.setdefault(site.qual, set()).add(site.op)
        for qual, sent in by_qual.items():
            fn = self.project.functions.get(qual)
            if fn is None:
                continue
            assigns = self._assigns(fn)
            op_dict_ids = {id(node)
                           for _op, node in self._op_dicts(fn)}

            def _carries(call: ast.Call) -> bool:
                vals = list(call.args)
                vals += [kw.value for kw in call.keywords
                         if kw.arg is not None]
                for a in vals:
                    if id(a) in op_dict_ids:
                        return True
                    if (isinstance(a, ast.Name) and a.id in assigns
                            and any(id(x) in op_dict_ids
                                    for x in assigns[a.id])):
                        return True
                return False

            for n in _walk_no_defs(fn.node):
                if (isinstance(n, ast.Return)
                        and isinstance(n.value, ast.Call)
                        and _carries(n.value)):
                    ops[qual] = set(sent)
                    break
        return ops

    def _collect_consumer_reads(self) -> None:
        op_of = self._op_of_function()
        for qual in sorted(self.project.functions):
            fn = self.project.functions[qual]
            assigns = self._assigns(fn)
            op_dicts = {id(node): op
                        for op, node in self._op_dicts(fn)}
            # var -> ops it answers for
            resp_vars: Dict[str, Set[str]] = {}
            for name, values in assigns.items():
                for v in values:
                    if not isinstance(v, ast.Call):
                        continue
                    callee = self._resolve(v, fn)
                    if callee in op_of and len(op_of[callee]) == 1:
                        resp_vars.setdefault(name, set()).update(
                            op_of[callee])
                        continue
                    for a in v.args:
                        if id(a) in op_dicts:
                            resp_vars.setdefault(name, set()).add(
                                op_dicts[id(a)])
                        elif (isinstance(a, ast.Name)
                                and a.id in assigns
                                and any(id(x) in op_dicts
                                        for x in assigns[a.id])):
                            for x in assigns[a.id]:
                                if id(x) in op_dicts:
                                    resp_vars.setdefault(
                                        name, set()).add(
                                        op_dicts[id(x)])
            if not resp_vars:
                continue
            for var, ops in resp_vars.items():
                for n in _walk_no_defs(fn.node):
                    key = None
                    line = getattr(n, "lineno", 0)
                    if (isinstance(n, ast.Call)
                            and isinstance(n.func, ast.Attribute)
                            and n.func.attr == "get"
                            and isinstance(n.func.value, ast.Name)
                            and n.func.value.id == var
                            and n.args
                            and isinstance(n.args[0], ast.Constant)
                            and isinstance(n.args[0].value, str)):
                        key = n.args[0].value
                    elif (isinstance(n, ast.Subscript)
                            and isinstance(n.value, ast.Name)
                            and n.value.id == var
                            and isinstance(n.slice, ast.Constant)
                            and isinstance(n.slice.value, str)):
                        key = n.slice.value
                    elif (isinstance(n, ast.Compare)
                            and len(n.ops) == 1
                            and isinstance(n.ops[0],
                                           (ast.In, ast.NotIn))
                            and isinstance(n.left, ast.Constant)
                            and isinstance(n.left.value, str)
                            and isinstance(n.comparators[0], ast.Name)
                            and n.comparators[0].id == var):
                        key = n.left.value
                    if key is None:
                        continue
                    for op in ops:
                        self.consumer_reads.setdefault(op, []).append(
                            (key, qual, line))

    # -- driver -------------------------------------------------------
    def _extract(self) -> None:
        self._read_contract()
        self._find_egress()
        self._fwd = self._forwarding_params()
        self._retrying = self._retrying_params()
        self._collect_send_sites()
        self._extract_handlers()
        self._collect_egress_violations()
        self._collect_consumer_reads()

    # -- rendering ----------------------------------------------------
    def ops_seen(self) -> List[str]:
        seen = set(self.contract.ops)
        seen.update(s.op for s in self.send_sites)
        seen.update(op for op, _cls in self.handlers)
        return sorted(seen)

    def to_doc(self) -> dict:
        ops_doc: Dict[str, dict] = {}
        for op in self.ops_seen():
            handlers = []
            for (hop, cls), h in sorted(self.handlers.items()):
                if hop != op:
                    continue
                handlers.append({
                    "class": cls, "role": h.role, "path": h.path,
                    "ha_gated": h.ha_gated,
                    "forwards_request": h.forwards_request,
                    "dynamic_response": h.dynamic_response,
                    "request_keys_read": sorted(h.request_keys_read),
                    "response_keys_written": sorted(
                        h.response_keys_written),
                })
            callers = []
            for s in sorted((s for s in self.send_sites
                             if s.op == op),
                            key=lambda s: (s.qual, s.line)):
                callers.append({
                    "qual": s.qual, "line": s.line,
                    "path_kind": s.path_kind,
                    "request_keys": sorted(s.request_keys),
                    "dynamic_request": s.dynamic_request,
                    "retried": s.retried,
                    "retry_via": sorted(s.retry_via),
                })
            reads = sorted(set(self.consumer_reads.get(op, ())))
            ops_doc[op] = {
                "declared": op in self.contract.ops,
                "idempotent": op in self.contract.idempotent,
                "handlers": handlers,
                "callers": callers,
                "consumer_reads": [
                    {"key": k, "qual": q, "line": ln}
                    for k, q, ln in reads],
            }
        return {
            "artifact": "PROTOCOL_TORCH",
            "version": 1,
            "contract": {
                "source": self.contract.source,
                "ops": sorted(self.contract.ops),
                "idempotent_ops": sorted(self.contract.idempotent),
                "request_envelope": sorted(
                    self.contract.request_envelope),
                "response_envelope": sorted(
                    self.contract.response_envelope),
            },
            "egress": {cls: dict(info, stamps=sorted(info["stamps"]))
                       for cls, info in sorted(self.egress.items())},
            "ops": ops_doc,
            "summary": self.summary(),
        }

    def summary(self) -> dict:
        ops = self.ops_seen()
        handled = sorted({op for op, _cls in self.handlers})
        called = sorted({s.op for s in self.send_sites})
        retried = sorted({s.op for s in self.send_sites if s.retried})
        dynamic = sorted({op for (op, _c), h in self.handlers.items()
                          if h.dynamic_response})
        return {
            "ops": len(ops),
            "handled_ops": len([o for o in ops if o in handled]),
            "called_ops": len([o for o in ops if o in called]),
            "idempotent_ops": len(self.contract.idempotent),
            "retried_ops": retried,
            "dynamic_response_ops": dynamic,
            "handlers": len(self.handlers),
            "send_sites": len(self.send_sites),
        }


def render_protocol_json(model: ProtocolModel) -> str:
    return json.dumps(model.to_doc(), indent=2, sort_keys=True) + "\n"


def render_protocol_md(model: ProtocolModel) -> str:
    doc = model.to_doc()
    lines = [
        "# The port's wire contract",
        "",
        f"Generated by static extraction (`{REGENERATE}`) — do not "
        "edit by hand; the port's lint family (l) fails the gate when "
        f"`{PROTOCOL_ARTIFACT}` drifts from the tree "
        "(QSM-PROTO-DRIFT).  Source of truth for the op vocabulary: "
        f"`{doc['contract']['source']}`.",
        "",
        "| Op | Idempotent | Handlers | Callers | Retried via |",
        "|---|---|---|---|---|",
    ]
    for op, entry in sorted(doc["ops"].items()):
        handlers = ", ".join(
            "{}[{}{}]".format(h["class"], h["role"],
                              ", ha-gated" if h["ha_gated"] else "")
            for h in entry["handlers"]) or "—"
        kinds: Dict[str, int] = {}
        vias: Set[str] = set()
        for c in entry["callers"]:
            kinds[c["path_kind"]] = kinds.get(c["path_kind"], 0) + 1
            if c["retried"]:
                vias.update(v.split(":")[-1] for v in c["retry_via"])
        callers = ", ".join(f"{k}×{n}" if n > 1 else k
                            for k, n in sorted(kinds.items())) or "—"
        idem = "yes" if entry["idempotent"] else "**no**"
        lines.append("| `{}` | {} | {} | {} | {} |".format(
            op, idem, handlers, callers,
            ", ".join(f"`{v}`" for v in sorted(vias)) or "—"))
    lines += [
        "",
        "## Invariants the lint family (l) enforces",
        "",
        "* **One egress** — every handler response leaves through its "
        "class's single `_send`, which stamps "
        + "; ".join(
            "`{}` → {}".format(
                cls, ", ".join(f"`{s}`" for s in info["stamps"]))
            for cls, info in sorted(doc["egress"].items()))
        + " (QSM-PROTO-EGRESS).",
        "* **Retry ⇒ idempotent** — every op reachable from a "
        "retrying call path (`CheckClient._round_trip` failover, "
        "`NodeLink.request` fresh-socket retry, router re-dispatch) "
        "must be in `IDEMPOTENT_OPS` in "
        f"`{PROTOCOL_SOURCE}`; "
        "`shutdown` is deliberately absent and rides a single "
        "non-retrying attempt (QSM-PROTO-RETRY-IDEMPOTENT).",
        "* **SHED is never a verdict** — an admission/HA shed doc "
        "(`shed: true`) never carries verdict/witness keys "
        "(QSM-PROTO-SHED).",
        "* **Fields are load-bearing** — a response key some consumer "
        "reads must be written by a handler of that op; a request key "
        "a handler reads must be set by some sender "
        "(QSM-PROTO-FIELDS).",
        "",
    ]
    return "\n".join(lines)


def default_files(root: str) -> List[str]:
    from .engine import DEFAULT_PROTOCOL_FILES
    return [os.path.join(root, rel) for rel in DEFAULT_PROTOCOL_FILES]


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(
        description="extract the port's wire-contract IR -> "
                    f"{PROTOCOL_ARTIFACT} + {PROTOCOL_RENDERING}")
    ap.add_argument("--root", default=repo)
    ap.add_argument("--json-out", default=None,
                    help=f"default: <root>/{PROTOCOL_ARTIFACT}")
    ap.add_argument("--md-out", default=None,
                    help=f"default: <root>/{PROTOCOL_RENDERING}")
    args = ap.parse_args(argv)
    model = ProtocolModel(default_files(args.root), root=args.root)
    json_out = args.json_out or os.path.join(args.root,
                                             PROTOCOL_ARTIFACT)
    md_out = args.md_out or os.path.join(args.root, PROTOCOL_RENDERING)
    with open(json_out, "w") as f:
        f.write(render_protocol_json(model))
    with open(md_out, "w") as f:
        f.write(render_protocol_md(model))
    s = model.summary()
    print(f"{s['ops']} op(s), {s['handlers']} handler(s), "
          f"{s['send_sites']} send site(s) -> {json_out} + {md_out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
