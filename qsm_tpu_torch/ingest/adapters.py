"""Format adapters — foreign event logs as first-class History corpora.

Two externally-common layouts (the OmniLink premise, PAPERS.md: traces
of UNMODIFIED systems become checkable without touching the system):

* **jepsen** — Jepsen/Knossos-style EDN maps, one event per line::

      {:process 0, :type :invoke, :f :write, :value 1}
      {:process 1, :type :invoke, :f :read, :value nil}
      {:process 0, :type :ok, :f :write, :value 1}
      {:process 1, :type :ok, :f :read, :value 1}

  Keyed specs (kv) pack ``:value [key payload]``.  ``:fail`` completes
  an op with its failure response (cas), ``:info`` leaves it pending
  forever (unknown outcome — exactly the checker's pending semantics).

* **porcupine** — the same event grammar with an explicit ``:key``
  field (porcupine's kv test-data shape)::

      {:process 0, :type :invoke, :f :get, :key 2, :value nil}
      {:process 0, :type :ok, :f :get, :key 2, :value 1}

Timestamps are LINE ORDER (invoke at its line index, response at its)
— the real-time precedence a line-ordered log actually attests.  The
decoded rows ride ``utils/report.py history_from_rows`` (the ONE
decoder: canonical op order, loud refusal of mis-paired events), so an
ingested trace is indistinguishable from a native corpus to ``check``,
``submit``, ``shrink``, bench and the monitor plane.

``emit_*`` regenerate the canonical text: ``emit(parse(text)) == text``
for canonical files (the golden round-trip pin).
Pending ops re-emit their invoke only (an ``:info`` line's position is
not part of the history's identity).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core.history import History
from ..sched.runner import PENDING_T
from .edn import EdnError, parse_lines, render_map_line
from .specmap import IngestError, spec_map_for

_INVOKE_TYPES = (":invoke", ":call")
_OK_TYPES = (":ok", ":return")
_FAIL = ":fail"
_INFO = ":info"


def decode_event(doc: dict, smap, keyed_field: Optional[str],
                 open_ops: Dict[int, Tuple[int, int]]):
    """THE per-line event decode — the batch adapters and the live
    tailer (ingest/tail.py) both ride exactly this, so the two paths
    can never disagree on the same log.  One parsed EDN map →

    * ``("invoke", pid, (cmd, arg))`` — ``open_ops`` gains the pid;
    * ``("ok", pid, resp)`` — ``:ok``/``:return``/``:fail`` complete
      the pid's outstanding op (popped from ``open_ops``);
    * ``("info", pid, None)`` — unknown outcome, op stays pending;
    * ``None`` — a non-op line to skip: an ``:info`` whose ``:process``
      is not an integer (real Jepsen logs carry ``:process :nemesis``
      lifecycle lines; they are not history operations).

    Anything else — non-integer process on a real op, unknown type,
    mis-paired completion, out-of-domain value — raises
    :class:`IngestError`."""
    typ = doc.get("type")
    if isinstance(typ, str) and not typ.startswith(":"):
        typ = ":" + typ
    pid = doc.get("process")
    if not isinstance(pid, int):
        if typ == _INFO:
            return None  # nemesis/system lifecycle line: not an op
        raise IngestError(f":process must be an integer, got {pid!r}")
    f = doc.get("f")
    f = f[1:] if isinstance(f, str) and f.startswith(":") else f
    value = doc.get("value")
    if keyed_field is not None:
        key = doc.get(keyed_field)
    elif smap.keyed:
        # jepsen keyed layout: :value [key payload]
        if not isinstance(value, (list, tuple)) or len(value) != 2:
            raise IngestError(f"keyed spec needs :value "
                              f"[key payload], got {value!r}")
        key, value = value[0], value[1]
    else:
        key = None
    if typ in _INVOKE_TYPES:
        if pid in open_ops:
            raise IngestError(f"process {pid} invokes with an "
                              "outstanding op")
        cmd, arg = smap.invoke_op(f, key, value)
        open_ops[pid] = (cmd, arg)
        return ("invoke", pid, (cmd, arg))
    if typ in _OK_TYPES or typ == _FAIL:
        op = open_ops.pop(pid, None)
        if op is None:
            raise IngestError(f"process {pid} completes with no "
                              "outstanding invocation")
        return ("ok", pid, smap.resp_of(op[0], op[1], value,
                                        typ == _FAIL))
    if typ == _INFO:
        if open_ops.pop(pid, None) is None:
            raise IngestError(f":info for process {pid} with no "
                              "outstanding invocation")
        return ("info", pid, None)
    raise IngestError(f"unknown :type {typ!r}")


def _parse(text: str, smap, keyed_field: Optional[str]) -> List[list]:
    rows: List[list] = []
    open_ops: Dict[int, Tuple[int, int]] = {}   # decode pairing state
    row_of: Dict[int, int] = {}                 # pid -> open row index
    for line_no, doc in parse_lines(text):
        try:
            ev = decode_event(doc, smap, keyed_field, open_ops)
        except IngestError as e:
            raise IngestError(f"line {line_no}: {e}") from None
        if ev is None:
            continue
        kind, pid, payload = ev
        if kind == "invoke":
            row_of[pid] = len(rows)
            rows.append([pid, payload[0], payload[1], -1, line_no,
                         PENDING_T])
        elif kind == "ok":
            i = row_of.pop(pid)
            rows[i][3] = payload
            rows[i][5] = line_no
        else:  # info: unknown outcome — the op stays pending
            row_of.pop(pid, None)
    return rows


def _emit(history: History, smap, keyed_field: Optional[str]) -> str:
    stream = []  # (t, order, pairs)
    for op in history.ops:
        f, key, value = smap.render_invoke(op.cmd, op.arg)
        stream.append((op.invoke_time, 0,
                       _pairs(op.pid, ":invoke", f, key, value,
                              keyed_field, smap)))
        if op.is_pending:
            continue
        f, key, value, failed = smap.render_resp(op.cmd, op.arg, op.resp)
        typ = _FAIL if failed else ":ok"
        stream.append((op.response_time, 1,
                       _pairs(op.pid, typ, f, key, value, keyed_field,
                              smap)))
    stream.sort(key=lambda e: (e[0], e[1]))
    return "".join(render_map_line(p) + "\n" for _, _, p in stream)


def _pairs(pid: int, typ: str, f: str, key, value,
           keyed_field: Optional[str], smap) -> List[tuple]:
    pairs = [("process", pid), ("type", typ), ("f", ":" + f)]
    if keyed_field is not None:
        pairs.append((keyed_field, 0 if key is None else key))
        pairs.append(("value", value))
    elif smap.keyed:
        pairs.append(("value", [key, value]))
    else:
        pairs.append(("value", value))
    return pairs


# ---------------------------------------------------------------------------
# the two public formats
# ---------------------------------------------------------------------------

def parse_jepsen(text: str, model: str, spec) -> List[list]:
    """Jepsen/Knossos EDN lines → canonical history rows."""
    return _parse(text, spec_map_for(model, spec), keyed_field=None)


def emit_jepsen(history: History, model: str, spec) -> str:
    return _emit(history, spec_map_for(model, spec), keyed_field=None)


def parse_porcupine(text: str, model: str, spec) -> List[list]:
    """porcupine-style (explicit ``:key``) EDN lines → history rows."""
    return _parse(text, spec_map_for(model, spec), keyed_field="key")


def emit_porcupine(history: History, model: str, spec) -> str:
    return _emit(history, spec_map_for(model, spec), keyed_field="key")


FORMATS = {
    "jepsen": (parse_jepsen, emit_jepsen),
    "porcupine": (parse_porcupine, emit_porcupine),
}


def parse_trace(fmt: str, text: str, model: str, spec) -> List[list]:
    if fmt not in FORMATS:
        raise IngestError(f"unknown ingest format {fmt!r}; one of "
                          f"{sorted(FORMATS)}")
    return FORMATS[fmt][0](text, model, spec)


def emit_trace(fmt: str, history: History, model: str, spec) -> str:
    if fmt not in FORMATS:
        raise IngestError(f"unknown ingest format {fmt!r}; one of "
                          f"{sorted(FORMATS)}")
    return FORMATS[fmt][1](history, model, spec)
