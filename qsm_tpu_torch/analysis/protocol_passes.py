"""Protocol-conformance passes — lint family (l); the counterpart of
``qsm_tpu/analysis/protocol_passes.py``.

Checks the extracted protocol IR (:mod:`protocol_model`) against the
contract declared in ``qsm_tpu_torch/serve/protocol.py``:

* **QSM-PROTO-UNHANDLED** — an op some path sends with no handler
  anywhere; a declared op nobody handles or nobody calls; an op on
  the wire that the contract does not declare.
* **QSM-PROTO-FIELDS** — a response key a consumer reads that no
  handler of that op ever writes; a request key a handler reads that
  no sender ever sets.  Envelope keys are exempt; ops whose response
  is built dynamically (unresolvable call) stand down in that
  direction.
* **QSM-PROTO-EGRESS** — a raw ``send_doc``/``sendall`` inside an
  egress class (one that defines ``_send`` + ``_handle``) but outside
  its ``_send``: the response would skip node/term stamping.
* **QSM-PROTO-RETRY-IDEMPOTENT** — an op reachable from a retrying
  call path (client failover, ``NodeLink`` fresh-socket retry, router
  re-dispatch) that the contract does not declare idempotent.
* **QSM-PROTO-SHED** — a single response doc carrying ``shed`` along
  with verdict/witness keys: SHED must never be a verdict.
* **QSM-PROTO-DRIFT** — the port's committed ``PROTOCOL_TORCH.json``
  no longer matches a fresh extraction (``python -m
  qsm_tpu_torch.analysis.protocol_model`` regenerates it and
  ``PROTOCOL_TORCH.md``).

Coverage and drift checks only run when the scanned file set carries
the contract source (``serve/protocol.py``) — fixture sub-programs
exercise the per-site rules without inheriting the live vocabulary.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Set

from .findings import ERROR, Finding
from .protocol_model import (PROTOCOL_ARTIFACT, PROTOCOL_SOURCE,
                             REGENERATE, ProtocolModel,
                             render_protocol_json)

# keys that mean "this doc carries a verdict/witness" — a shed doc
# carrying any of them violates the SHED-is-never-a-verdict contract
_VERDICT_KEYS = frozenset((
    "verdict", "verdicts", "witness", "witnesses", "violations",
    "flip", "history", "histories",
))


def check_protocol_project(paths: Sequence[str],
                           root: Optional[str] = None,
                           protocol_path: Optional[str] = None,
                           ) -> List[Finding]:
    model = ProtocolModel([p for p in paths if p.endswith(".py")],
                          root=root)
    return check_model(model, root=root, protocol_path=protocol_path)


def check_model(model: ProtocolModel,
                root: Optional[str] = None,
                protocol_path: Optional[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    findings += _check_unhandled(model)
    findings += _check_fields(model)
    findings += _check_egress(model)
    findings += _check_retry_idempotent(model)
    findings += _check_shed(model)
    if model.contract.source is not None:
        findings += _check_drift(model, root, protocol_path)
    return findings


def _loc(model: ProtocolModel, qual: str, line: int) -> str:
    return model.project.rel_loc(qual, line)


def _check_unhandled(model: ProtocolModel) -> List[Finding]:
    out: List[Finding] = []
    handled = {op for op, _cls in model.handlers}
    called = {s.op for s in model.send_sites}
    for site in model.send_sites:
        if site.op not in handled:
            out.append(Finding(
                ERROR, "QSM-PROTO-UNHANDLED",
                _loc(model, site.qual, site.line),
                f"op {site.op!r} is sent here but no handler "
                f"dispatches it (no egress class `_handle` branch "
                f"names it)",
                "add a dispatch branch, or drop the dead request"))
    if not model.contract.declared:
        return out
    declared = model.contract.ops
    src = model.contract.source or "<class declarations>"
    for op in sorted(declared - handled):
        out.append(Finding(
            ERROR, "QSM-PROTO-UNHANDLED", f"{src}:OPS",
            f"declared op {op!r} has no handler in the scanned tree",
            "implement the handler or retire the op from OPS"))
    for op in sorted((declared & handled) - called):
        out.append(Finding(
            ERROR, "QSM-PROTO-UNHANDLED", f"{src}:OPS",
            f"declared op {op!r} is handled but no caller path "
            f"sends it",
            "wire a client path or retire the dead op"))
    for op in sorted((called | handled) - declared):
        where = next((_loc(model, s.qual, s.line)
                      for s in model.send_sites if s.op == op),
                     f"{src}:OPS")
        out.append(Finding(
            ERROR, "QSM-PROTO-UNHANDLED", where,
            f"op {op!r} is on the wire but not declared in OPS "
            f"({src})",
            "add it to OPS (and IDEMPOTENT_OPS if retry-safe)"))
    return out


def _check_fields(model: ProtocolModel) -> List[Finding]:
    out: List[Finding] = []
    resp_env = model.contract.response_envelope
    req_env = model.contract.request_envelope
    egress_stamps: Set[str] = set()
    for info in model.egress.values():
        egress_stamps.update(info["stamps"])
    for op in model.ops_seen():
        handlers = [h for (hop, _c), h in sorted(model.handlers.items())
                    if hop == op]
        senders = [s for s in model.send_sites if s.op == op]
        # response direction: every consumer-read key must be written
        # by some handler of the op (skip when any handler's response
        # is dynamic — we cannot enumerate what it writes)
        if handlers and not any(h.dynamic_response for h in handlers):
            written: Set[str] = set()
            for h in handlers:
                written |= h.response_keys_written
            written |= resp_env | egress_stamps
            for key, qual, line in sorted(
                    set(model.consumer_reads.get(op, ()))):
                if key not in written:
                    out.append(Finding(
                        ERROR, "QSM-PROTO-FIELDS",
                        _loc(model, qual, line),
                        f"response key {key!r} of op {op!r} is read "
                        f"here but no handler of that op writes it",
                        "write the key in the handler or drop the "
                        "dead read"))
        # request direction: every key a handler reads must be set by
        # some sender (skip when any sender's request is dynamic, or
        # when a forwarding path re-sends an unknowable superset).
        # Reads at a shared-helper root are attributed to every
        # co-dispatched op, so the settable set unions the senders of
        # the whole co-dispatch group — per-branch reads stay precise.
        group = model.co_dispatched.get(op, set()) | {op}
        g_senders = [s for s in model.send_sites if s.op in group]
        if senders and not any(s.dynamic_request for s in g_senders):
            settable: Set[str] = set(req_env)
            for s in g_senders:
                settable |= s.request_keys
            forwarded = any(h.forwards_request for h in handlers)
            for h in handlers:
                for key in sorted(h.request_keys_read - settable):
                    if forwarded:
                        continue
                    out.append(Finding(
                        ERROR, "QSM-PROTO-FIELDS",
                        f"{h.path}:{h.cls}._handle",
                        f"handler {h.cls} reads request key {key!r} "
                        f"of op {op!r} but no sender sets it",
                        "set the key at a call site or drop the "
                        "dead read"))
    return out


def _check_egress(model: ProtocolModel) -> List[Finding]:
    out: List[Finding] = []
    for qual, line, name in model.egress_violations:
        fn = model.project.functions[qual]
        out.append(Finding(
            ERROR, "QSM-PROTO-EGRESS", _loc(model, qual, line),
            f"raw {name}() inside egress class {fn.cls} bypasses its "
            f"one `_send` (responses would skip node/term stamping)",
            "route the response through self._send"))
    return out


def _check_retry_idempotent(model: ProtocolModel) -> List[Finding]:
    out: List[Finding] = []
    idempotent = model.contract.idempotent
    for site in model.send_sites:
        if not site.retried or site.op in idempotent:
            continue
        via = ", ".join(v.split(":")[-1]
                        for v in sorted(site.retry_via)) or "?"
        out.append(Finding(
            ERROR, "QSM-PROTO-RETRY-IDEMPOTENT",
            _loc(model, site.qual, site.line),
            f"op {site.op!r} rides a retrying call path (via {via}) "
            f"but is not in the declared idempotent set",
            "make the op replay-safe and add it to IDEMPOTENT_OPS "
            f"in {PROTOCOL_SOURCE}, or move it off the retry path"))
    return out


def _check_shed(model: ProtocolModel) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[str] = set()
    for (op, cls), h in sorted(model.handlers.items()):
        for keys, _dyn, merged in h.response_alts:
            if merged or "shed" not in keys:
                continue
            bad = sorted(keys & _VERDICT_KEYS)
            if not bad:
                continue
            loc = f"{h.path}:{cls}.{op}"
            if loc in seen:
                continue
            seen.add(loc)
            out.append(Finding(
                ERROR, "QSM-PROTO-SHED", loc,
                f"a shed response of op {op!r} also carries verdict/"
                f"witness key(s) {', '.join(repr(b) for b in bad)} — "
                f"SHED must never read as a verdict",
                "strip verdict keys from the shed doc"))
    return out


def _check_drift(model: ProtocolModel, root: Optional[str],
                 protocol_path: Optional[str]) -> List[Finding]:
    root = root or os.getcwd()
    path = protocol_path or os.path.join(root, PROTOCOL_ARTIFACT)
    fresh = render_protocol_json(model)
    try:
        with open(path) as f:
            committed = f.read()
    except OSError:
        return [Finding(
            ERROR, "QSM-PROTO-DRIFT", PROTOCOL_ARTIFACT,
            f"committed {PROTOCOL_ARTIFACT} is missing",
            f"run `{REGENERATE}` and commit the artifact")]
    if committed != fresh:
        return [Finding(
            ERROR, "QSM-PROTO-DRIFT", PROTOCOL_ARTIFACT,
            f"committed {PROTOCOL_ARTIFACT} does not match a fresh "
            "extraction from this tree",
            f"run `{REGENERATE}` and commit the regenerated "
            "artifact")]
    return []
