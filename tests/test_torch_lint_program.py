"""The port's whole-program lint families held against the reference's:
family g (``callgraph`` + ``race_passes``: lock order, unguarded shared
writes, thread lifecycles, leaked descriptors) and family l
(``protocol_model`` + ``protocol_passes``: the wire contract as the
port's own committed artifact, ``PROTOCOL_TORCH.json``).

* twins of tests/test_lint.py's ``test_race_*`` and ``test_protocol_*``
  cases, on the port's fixtures and the port's live tree;
* race parity — the reference's ``check_race_project`` and the port's
  give the same findings on the reference's fixture sub-programs and on
  the inline stubs (the same file in, so the locations are the same);
* contract parity — the port's extraction agrees with the reference's
  committed ``PROTOCOL.json`` in ops, idempotent ops, envelopes and the
  request keys of every op; its responses differ only by the port's
  additions, each named here.

CPU only, pure AST: nothing here touches a device.
"""

from __future__ import annotations

import json
import os

import pytest

import qsm_tpu.analysis.fixtures as ref_fixtures
import qsm_tpu_torch.analysis.fixtures as fixtures
from qsm_tpu.analysis.engine import \
    DEFAULT_PROTOCOL_FILES as REF_PROTOCOL_FILES
from qsm_tpu.analysis.engine import DEFAULT_RACE_FILES as REF_RACE_FILES
from qsm_tpu.analysis.protocol_passes import \
    check_protocol_project as ref_check_protocol_project
from qsm_tpu.analysis.race_passes import \
    check_race_project as ref_check_race_project
from qsm_tpu_torch.analysis import (DEFAULT_PROTOCOL_FILES,
                                    DEFAULT_RACE_FILES, ERROR, FAMILIES,
                                    Whitelist, run_lint)
from qsm_tpu_torch.analysis.engine import REPO_ROOT, default_whitelist_path
from qsm_tpu_torch.analysis.protocol_model import (PROTOCOL_ARTIFACT,
                                                   PROTOCOL_RENDERING,
                                                   ProtocolModel,
                                                   render_protocol_json)
from qsm_tpu_torch.analysis.protocol_passes import check_protocol_project
from qsm_tpu_torch.analysis.race_passes import check_race_project


def _full(findings):
    return sorted((f.rule_id, f.location, f.severity, f.message)
                  for f in findings)


def _by_rule(findings):
    out = {}
    for f in findings:
        out.setdefault(f.rule_id, []).append(f)
    return out


# --- family g: the seeded stubs -------------------------------------------

@pytest.fixture(scope="module")
def race_findings():
    return check_race_project([fixtures.__file__])


def test_race_fixture_matrix(race_findings):
    """Each seeded stub — AB/BA lock cycle, unguarded counter, unjoined
    thread, leaked pipe — fires its rule exactly once on the port's
    fixtures, and the sanctioned twins stay clean."""
    by = _by_rule(race_findings)
    order = by.pop("QSM-RACE-ORDER")
    assert len(order) == 1 and order[0].severity == ERROR
    assert "DeadlockingLockPairStub" in order[0].location
    assert "lock_a" in order[0].message and "lock_b" in order[0].message
    unguarded = by.pop("QSM-RACE-UNGUARDED")
    assert len(unguarded) == 1 and unguarded[0].severity == ERROR
    assert "UnguardedCounterStub._drain" in unguarded[0].location
    assert "_lock" in unguarded[0].message
    life = by.pop("QSM-THREAD-LIFECYCLE")
    assert len(life) == 1 and life[0].severity == ERROR
    assert "UnjoinedThreadStub.start" in life[0].location
    leak = by.pop("QSM-RES-LEAK")
    assert len(leak) == 1 and leak[0].severity == ERROR
    assert "LeakedPipeStub.open_unclosed" in leak[0].location
    assert not by


_RACE_INTERPROCEDURAL = """\
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.n = 0
    def start(self):
        threading.Thread(target=self._loop).start()
    def _loop(self):
        while not self._stop.is_set():
            with self._lock:
                self._bump()
    def _bump(self):
        self.n += 1      # guarded via the caller's lock
    def other(self):
        with self._lock:
            self.n -= 1
class D:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()
    def one(self):
        with self.a:
            self._takeb()   # cycle half via a call
    def _takeb(self):
        with self.b:
            pass
    def two(self):
        with self.b:
            with self.a:
                pass
class E:
    def __init__(self):
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.v = 0
    def start(self):
        threading.Thread(target=self._go).start()
    def _go(self):
        while not self._stop.is_set():
            self._lock.acquire()
            try:
                self.v += 1   # inside the pair: guarded
            finally:
                self._lock.release()
            self.v = 0        # past the release: unguarded
"""

_RACE_THREE_LOCKS = """\
import threading
class T:
    def __init__(self):
        self.la = threading.Lock()
        self.lb = threading.Lock()
        self.lc = threading.Lock()
    def p1(self):
        with self.la:
            with self.lc:
                pass
    def p2(self):
        with self.lc:
            with self.lb:
                pass
    def p3(self):
        with self.lb:
            with self.la:
                pass
"""

_RACE_BARE_ANNOTATION = """\
import threading
from typing import Optional
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.n = 0
    def start(self):
        threading.Thread(target=self._loop).start()
    def _loop(self):
        self.n: int            # annotation, not a write
        while not self._stop.is_set():
            with self._lock:
                self.n += 1
"""

_RACE_ANNOTATED_ACQUISITION = """\
import socket
def fine():
    s: socket.socket = socket.socket()
    s.close()
def leaky():
    s: socket.socket = socket.socket()
    return 'nope'
"""

# a worker that ends on a queue's stop mark, and one that never can
_RACE_STOP_MARK = """\
import queue, threading
_STOP = None
def _serve(jobs):
    while True:
        job = jobs.get()
        if job is _STOP:
            return
        job()
def _spin(jobs):
    while True:
        jobs.get()()
def start(jobs):
    threading.Thread(target=_serve, args=(jobs,), daemon=True).start()
    threading.Thread(target=_spin, args=(jobs,), daemon=True).start()
"""

_RACE_STUBS = {
    "interprocedural": _RACE_INTERPROCEDURAL,
    "three_locks": _RACE_THREE_LOCKS,
    "bare_annotation": _RACE_BARE_ANNOTATION,
    "annotated_acquisition": _RACE_ANNOTATED_ACQUISITION,
    "stop_mark": _RACE_STOP_MARK,
}


def _stub(tmp_path, name):
    p = tmp_path / f"{name}.py"
    p.write_text(_RACE_STUBS[name])
    return str(p)


def test_race_interprocedural_discipline(tmp_path):
    """A write guarded only via its caller's lock is clean (entry_held
    propagation), an AB/BA cycle assembled across two functions fires
    (transitive acquires), and an acquire()/release() pair bounds the
    guarded region exactly."""
    findings = check_race_project([_stub(tmp_path, "interprocedural")])
    assert sorted(f.rule_id for f in findings) == [
        "QSM-RACE-ORDER", "QSM-RACE-UNGUARDED"]
    unguarded = next(f for f in findings
                     if f.rule_id == "QSM-RACE-UNGUARDED")
    assert "E._go" in unguarded.location


def test_race_three_lock_cycle_reports_real_edges(tmp_path):
    """A 3-lock cycle whose alphabetical order is not an edge path gives
    one ORDER finding whose path follows real acquisition sites."""
    findings = check_race_project([_stub(tmp_path, "three_locks")])
    assert [f.rule_id for f in findings] == ["QSM-RACE-ORDER"]
    msg = findings[0].message
    assert "T.la" in msg and "T.lb" in msg and "T.lc" in msg
    assert "T.la -> T.lb at" not in msg


def test_race_bare_annotation_is_not_a_write(tmp_path):
    assert check_race_project([_stub(tmp_path, "bare_annotation")]) == []


def test_race_annotated_acquisition_close_is_clean(tmp_path):
    findings = check_race_project([_stub(tmp_path, "annotated_acquisition")])
    assert [f.rule_id for f in findings] == ["QSM-RES-LEAK"]
    assert "leaky" in findings[0].location


def test_race_stop_mark_is_a_teardown_path(tmp_path):
    """The port's watchdog worker shape: a queue worker that ends on its
    named stop mark has a teardown path; one that cannot end has not."""
    findings = check_race_project([_stub(tmp_path, "stop_mark")])
    assert [f.rule_id for f in findings] == ["QSM-THREAD-LIFECYCLE"]
    assert "_spin" in findings[0].message and "_serve" not in \
        findings[0].message


# --- family g: parity with the reference ----------------------------------

@pytest.mark.parametrize("source", ["reference fixtures", "port fixtures",
                                    *sorted(_RACE_STUBS)])
def test_race_family_matches_the_reference(source, tmp_path):
    """The same closed program in, the same findings out — rule,
    location, severity and message."""
    if source == "reference fixtures":
        paths = [ref_fixtures.__file__]
    elif source == "port fixtures":
        paths = [fixtures.__file__]
    else:
        paths = [_stub(tmp_path, source)]
    ref = ref_check_race_project(paths, root=str(tmp_path))
    port = check_race_project(paths, root=str(tmp_path))
    assert ref or source in ("bare_annotation",)
    assert _full(port) == _full(ref)


def test_race_scan_set_mirrors_the_reference():
    """Every module of the reference's race scan set has its counterpart
    in the port's; the reference's tools/ are the port's run scripts,
    and the nvcc build locks (no reference counterpart) are in."""
    port = set(DEFAULT_RACE_FILES)
    for rel in REF_RACE_FILES:
        if rel.startswith("qsm_tpu/"):
            assert "qsm_tpu_torch/" + rel[len("qsm_tpu/"):] in port, rel
    assert {"chip_smoke.py", "tools/torch_property_turns.py",
            "qsm_tpu_torch/ops/kernels.py"} <= port
    for rel in port:
        assert os.path.exists(os.path.join(REPO_ROOT, rel)), rel


def test_race_live_tree_is_clean():
    """The race family over the port's live tree: no finding outside the
    whitelist (the watchdog worker ends on its named stop mark, the
    window re-check settles its sessions' verdicts outside the engines'
    lock, and chip_smoke's node starter is named apart from the callback
    names the call graph follows)."""
    paths = [os.path.join(REPO_ROOT, rel) for rel in DEFAULT_RACE_FILES]
    findings = check_race_project(paths, root=REPO_ROOT)
    wl = Whitelist.load(default_whitelist_path())
    real = [f for f in findings if not wl.allows(f)]
    assert real == [], "\n".join(
        f"{f.rule_id} {f.location}: {f.message}" for f in real)


def test_race_family_is_registered():
    rep = run_lint(models=["cas"], retrace=False, families=["g"],
                   cache=False, device="cpu")
    assert rep.families == ["g"] and list(rep.passes) == ["race"]
    assert FAMILIES["g"].whole is not None
    assert rep.ok


# --- family l: the seeded stubs -------------------------------------------

def test_protocol_fixture_matrix():
    """The miswired pair fires QSM-PROTO-UNHANDLED (at the send site and
    as a declared-but-handlerless op) and QSM-PROTO-FIELDS; the
    send_doc-bypassing handler QSM-PROTO-EGRESS; the except-continue
    loop re-sending the mutating op QSM-PROTO-RETRY-IDEMPOTENT.  The
    sanctioned twins stay clean."""
    findings = check_protocol_project([fixtures.__file__])
    by = _by_rule(findings)
    unhandled = by.pop("QSM-PROTO-UNHANDLED")
    assert len(unhandled) == 2 and {f.severity for f in unhandled} == {
        ERROR}
    assert any("MiswiredProtocolClientStub.ghost" in f.location
               for f in unhandled)
    assert all("mis.ghost" in f.message for f in unhandled)
    fields = by.pop("QSM-PROTO-FIELDS")
    assert len(fields) == 1 and "echo_payload" in fields[0].message
    assert "MiswiredProtocolClientStub.ping" in fields[0].location
    egress = by.pop("QSM-PROTO-EGRESS")
    assert len(egress) == 1
    assert "UnstampedEgressStub._handle" in egress[0].location
    retry = by.pop("QSM-PROTO-RETRY-IDEMPOTENT")
    assert len(retry) == 1 and "retry.reset" in retry[0].message
    assert "RetriedMutationClientStub.reset" in retry[0].location
    assert not by
    clean = ("WiredProtocol", "StampedEgress", "IdempotentRetry")
    assert not any(c in f.location for c in clean for f in findings)


@pytest.mark.parametrize("which", ["reference fixtures", "port fixtures"])
def test_protocol_family_matches_the_reference(which):
    path = ref_fixtures.__file__ if which == "reference fixtures" \
        else fixtures.__file__
    ref = ref_check_protocol_project([path])
    assert ref
    assert _full(check_protocol_project([path])) == _full(ref)


# --- family l: the live tree and the port's own artifact -------------------

def _live_paths():
    return [os.path.join(REPO_ROOT, rel) for rel in DEFAULT_PROTOCOL_FILES]


def test_protocol_live_tree_is_clean():
    """Every op dispatched and called, responses through the one _send,
    retried ops all declared idempotent, PROTOCOL_TORCH.json current."""
    assert check_protocol_project(_live_paths(), root=REPO_ROOT) == []


def test_protocol_json_is_deterministic_and_covering():
    """Byte-stable (two extractions, one over the reversed file list,
    render alike) and total: every op declared in the port's
    serve/protocol.py has a handler and a caller."""
    from qsm_tpu_torch.serve.protocol import OPS

    paths = [p for p in _live_paths() if p.endswith(".py")]
    one = render_protocol_json(ProtocolModel(paths, root=REPO_ROOT))
    two = render_protocol_json(ProtocolModel(list(reversed(paths)),
                                             root=REPO_ROOT))
    assert one == two
    doc = json.loads(one)
    assert doc["artifact"] == "PROTOCOL_TORCH"
    assert doc["contract"]["source"] == "qsm_tpu_torch/serve/protocol.py"
    assert sorted(doc["ops"]) == sorted(OPS)
    for op in OPS:
        assert doc["ops"][op]["handlers"], f"{op}: no handler"
        assert doc["ops"][op]["callers"], f"{op}: no caller"


def test_protocol_drift_gate(tmp_path):
    """A contract edit that does not regenerate PROTOCOL_TORCH.json fails
    QSM-PROTO-DRIFT, naming the port's regeneration command; the
    committed artifact matches a fresh extraction."""
    committed = os.path.join(REPO_ROOT, PROTOCOL_ARTIFACT)
    stale = tmp_path / PROTOCOL_ARTIFACT
    with open(committed) as f:
        stale.write_text(f.read().replace('"artifact": "PROTOCOL_TORCH"',
                                          '"artifact": "STALE"'))
    findings = check_protocol_project(_live_paths(), root=REPO_ROOT,
                                      protocol_path=str(stale))
    assert [f.rule_id for f in findings] == ["QSM-PROTO-DRIFT"]
    assert findings[0].severity == ERROR
    assert "python -m qsm_tpu_torch.analysis.protocol_model" in \
        findings[0].fix_hint
    assert check_protocol_project(_live_paths(), root=REPO_ROOT,
                                  protocol_path=committed) == []


def test_regeneration_writes_the_committed_artifacts(tmp_path):
    """``python -m qsm_tpu_torch.analysis.protocol_model`` writes the
    port's two files, byte for byte the committed ones, and neither of
    the reference's."""
    from qsm_tpu_torch.analysis import protocol_model

    out_json, out_md = tmp_path / "p.json", tmp_path / "p.md"
    assert protocol_model.main(["--json-out", str(out_json),
                                "--md-out", str(out_md)]) == 0
    for fresh, name in ((out_json, PROTOCOL_ARTIFACT),
                        (out_md, PROTOCOL_RENDERING)):
        with open(os.path.join(REPO_ROOT, name)) as f:
            assert fresh.read_text() == f.read(), name
    assert (PROTOCOL_ARTIFACT, PROTOCOL_RENDERING) == (
        "PROTOCOL_TORCH.json", "PROTOCOL_TORCH.md")


def test_lint_report_carries_protocol_summary():
    rep = run_lint(models=["cas"], retrace=False, families=["l"],
                   cache=False, device="cpu")
    assert rep.ok and list(rep.passes) == ["protocol"]
    assert rep.protocol["ops"] == 27
    assert rep.protocol["handled_ops"] == rep.protocol["ops"]
    assert rep.protocol["called_ops"] == rep.protocol["ops"]
    assert rep.protocol["idempotent_ops"] == 26
    assert "shutdown" not in rep.protocol["retried_ops"]
    assert json.loads(rep.to_json())["protocol"] == rep.protocol


# --- family l: the port's contract against the reference's -----------------

# The response keys the port adds to the reference's, by op: a request the
# card failed is answered ``ok: false`` with the error's text
# (serve/server.py, fleet/router.py).
PORT_RESPONSE_ADDITIONS = {
    "check": {"device_error"},
    "session.append": {"device_error"},
    "session.close": {"device_error"},
    "session.open": {"device_error"},
    "shrink": {"device_error"},
}


def _union(entries, key):
    return set().union(*(set(e[key]) for e in entries))


@pytest.fixture(scope="module")
def contracts():
    with open(os.path.join(REPO_ROOT, "PROTOCOL.json")) as f:
        ref = json.load(f)
    paths = [p for p in _live_paths() if p.endswith(".py")]
    return ref, ProtocolModel(paths, root=REPO_ROOT).to_doc()


def test_contract_matches_the_reference(contracts):
    ref, port = contracts
    rc, pc = ref["contract"], port["contract"]
    for key in ("ops", "idempotent_ops", "request_envelope",
                "response_envelope"):
        assert pc[key] == rc[key], key
    assert sorted(port["ops"]) == sorted(ref["ops"])
    assert {c: e["stamps"] for c, e in port["egress"].items()} == \
        {c: e["stamps"] for c, e in ref["egress"].items()}
    for op, r in ref["ops"].items():
        p = port["ops"][op]
        assert (p["declared"], p["idempotent"]) == (r["declared"],
                                                    r["idempotent"]), op
        assert _union(p["callers"], "request_keys") == \
            _union(r["callers"], "request_keys"), op
        assert _union(p["handlers"], "request_keys_read") == \
            _union(r["handlers"], "request_keys_read"), op


def test_response_keys_differ_only_by_the_ports_additions(contracts):
    ref, port = contracts
    for op, r in ref["ops"].items():
        written = _union(port["ops"][op]["handlers"],
                         "response_keys_written")
        assert written - PORT_RESPONSE_ADDITIONS.get(op, set()) == \
            _union(r["handlers"], "response_keys_written"), op
        assert PORT_RESPONSE_ADDITIONS.get(op, set()) <= written, op


def test_port_artifacts_never_name_the_references_files():
    assert "PROTOCOL_TORCH.json" in DEFAULT_PROTOCOL_FILES
    assert "PROTOCOL.json" not in DEFAULT_PROTOCOL_FILES
    assert [r for r in REF_PROTOCOL_FILES if r.startswith("qsm_tpu/")] == [
        "qsm_tpu/" + r[len("qsm_tpu_torch/"):]
        for r in DEFAULT_PROTOCOL_FILES if r.startswith("qsm_tpu_torch/")]
    with open(os.path.join(REPO_ROOT, PROTOCOL_RENDERING)) as f:
        md = f.read()
    assert "python -m qsm_tpu_torch.analysis.protocol_model" in md
    assert md.startswith("# The port's wire contract")
