"""The port's trace ingest against the JAX package's (twins of
``tests/test_ingest.py:46-254``).

The golden Jepsen and porcupine logs of ``tests/data/`` go through both
packages' adapters: rows, byte-stable re-emission, verdicts and refusals
must be the reference's.  The CLI cases run with ``--device cpu`` (the
JAX package's host ladder); without it ``ingest --check`` runs on the
card, and here raises ``BackendUnavailable``."""

from __future__ import annotations

import itertools
import json
import os

import pytest

from qsm_tpu.ingest import emit_trace as j_emit_trace
from qsm_tpu.ingest import parse_trace as j_parse_trace
from qsm_tpu.models.registry import MODELS as JMODELS
from qsm_tpu.ops.wing_gong_cpu import WingGongCPU as JWingGong
from qsm_tpu.utils.report import history_from_rows as j_history_from_rows
from qsm_tpu_torch.ingest import (EdnError, EventTailer, IngestError,
                                  emit_trace, parse_trace)
from qsm_tpu_torch.models.registry import MODELS
from qsm_tpu_torch.ops.backend import BackendUnavailable
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.utils.report import history_from_rows

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_JEPSEN = os.path.join(DATA, "golden_jepsen_register.edn")
GOLDEN_PORCUPINE = os.path.join(DATA, "golden_porcupine_kv.edn")
GOLDEN_RANGESET = os.path.join(DATA, "golden_jepsen_rangeset.edn")
GOLDEN_SEMAPHORE = os.path.join(DATA, "golden_jepsen_semaphore.edn")
GOLDEN_TXN = os.path.join(DATA, "golden_porcupine_txn.edn")


def _golden(path):
    with open(path) as f:
        return f.read()


def _round_trip(path, fmt, model):
    """Both packages on one golden: the port's rows, History, re-emitted
    text and memo-oracle verdict, each equal to the reference's."""
    text = _golden(path)
    spec = MODELS[model].make_spec()
    jspec = JMODELS[model].make_spec()
    rows = parse_trace(fmt, text, model, spec)
    assert rows == j_parse_trace(fmt, text, model, jspec)
    h = history_from_rows(rows)
    jh = j_history_from_rows(rows)
    assert h.fingerprint() == jh.fingerprint()
    assert emit_trace(fmt, h, model, spec) == text
    assert j_emit_trace(fmt, jh, model, jspec) == text
    v = int(WingGongCPU(memo=True).check_histories(spec, [h])[0])
    assert v == int(JWingGong(memo=True).check_histories(jspec, [jh])[0])
    return h, v


# --- golden round trips ----------------------------------------------------

def test_golden_jepsen_round_trip_byte_stable():
    h, v = _round_trip(GOLDEN_JEPSEN, "jepsen", "register")
    assert h.n_pending == 1
    assert v == 1


def test_golden_porcupine_round_trip_byte_stable():
    _h, v = _round_trip(GOLDEN_PORCUPINE, "porcupine", "kv")
    assert v == 0


def test_golden_rangeset_round_trip_byte_stable():
    h, v = _round_trip(GOLDEN_RANGESET, "jepsen", "rangeset")
    assert h.n_pending == 1
    assert v == 0


def test_golden_semaphore_round_trip_byte_stable():
    _h, v = _round_trip(GOLDEN_SEMAPHORE, "jepsen", "semaphore")
    assert v == 1


def test_golden_txn_round_trip_byte_stable():
    _h, v = _round_trip(GOLDEN_TXN, "porcupine", "txn")
    assert v == 0


def test_txn_map_refuses_diagonal_copy_and_rangeset_domain():
    spec = MODELS["txn"].make_spec()
    with pytest.raises(IngestError, match="must differ"):
        parse_trace("porcupine",
                    "{:process 0, :type :invoke, :f :copy, :key 1, "
                    ":value 1}\n", "txn", spec)
    rs = MODELS["rangeset"].make_spec()
    with pytest.raises(IngestError, match="outside spec domain"):
        parse_trace("jepsen",
                    "{:process 0, :type :invoke, :f :add, "
                    f":value [{rs.n_keys} nil]}}\n", "rangeset", rs)
    line = ("{:process 0, :type :invoke, :f :count-below, "
            f":value [{rs.n_keys} nil]}}\n")
    rows = parse_trace("jepsen", line, "rangeset", rs)
    assert rows[0][2] == rs.n_keys
    assert rows == j_parse_trace("jepsen", line, "rangeset",
                                 JMODELS["rangeset"].make_spec())


def test_jepsen_cas_fail_completes_with_failure_response():
    spec = MODELS["cas"].make_spec()
    text = ("{:process 0, :type :invoke, :f :cas, :value [1 2]}\n"
            "{:process 0, :type :fail, :f :cas, :value [1 2]}\n")
    rows = parse_trace("jepsen", text, "cas", spec)
    assert rows[0][3] == 0
    assert rows == j_parse_trace("jepsen", text, "cas",
                                 JMODELS["cas"].make_spec())
    h = history_from_rows(rows)
    assert emit_trace("jepsen", h, "cas", spec) == text
    assert int(WingGongCPU().check_histories(spec, [h])[0]) == 1


def test_info_leaves_op_pending():
    spec = MODELS["register"].make_spec()
    text = ("{:process 0, :type :invoke, :f :write, :value 1}\n"
            "{:process 0, :type :info, :f :write, :value 1}\n")
    rows = parse_trace("jepsen", text, "register", spec)
    assert history_from_rows(rows).n_pending == 1
    assert rows == j_parse_trace("jepsen", text, "register",
                                 JMODELS["register"].make_spec())


# --- refusal paths ---------------------------------------------------------

def test_adapter_refuses_unknown_op_and_out_of_domain():
    spec = MODELS["register"].make_spec()
    with pytest.raises(IngestError, match="unknown op"):
        parse_trace("jepsen",
                    "{:process 0, :type :invoke, :f :append, "
                    ":value 1}\n", "register", spec)
    nv = spec.CMDS[0].n_resps
    with pytest.raises(IngestError, match="outside spec domain"):
        parse_trace("jepsen",
                    "{:process 0, :type :invoke, :f :write, "
                    f":value {nv + 3}}}\n", "register", spec)


def test_nemesis_info_lines_are_skipped_in_both_paths():
    from qsm_tpu.ingest import EventTailer as JEventTailer

    spec = MODELS["register"].make_spec()
    text = ("{:process :nemesis, :type :info, :f :start, :value nil}\n"
            "{:process 0, :type :invoke, :f :write, :value 1}\n"
            "{:process :nemesis, :type :info, :f :stop, :value nil}\n"
            "{:process 0, :type :ok, :f :write, :value 1}\n")
    rows = parse_trace("jepsen", text, "register", spec)
    assert len(rows) == 1 and rows[0][:4] == [0, 1, 1, 0]
    tailer = EventTailer("jepsen", "register", spec)
    jtailer = JEventTailer("jepsen", "register",
                           JMODELS["register"].make_spec())
    events, jevents = [], []
    for ln in text.splitlines():
        events.extend(tailer.events_for_line(ln))
        jevents.extend(jtailer.events_for_line(ln))
    assert [e["type"] for e in events] == ["invoke", "respond"]
    assert events == jevents
    with pytest.raises(IngestError, match="must be an integer"):
        parse_trace("jepsen",
                    "{:process :nemesis, :type :invoke, :f :write, "
                    ":value 1}\n", "register", spec)


def test_adapter_refuses_mispaired_events_with_line_context():
    spec = MODELS["register"].make_spec()
    with pytest.raises(IngestError, match="line 1"):
        parse_trace("jepsen",
                    "{:process 0, :type :ok, :f :read, :value 0}\n",
                    "register", spec)
    with pytest.raises(EdnError, match="line 1"):
        parse_trace("jepsen", "{:process oops}\n", "register", spec)


# --- the history_from_rows decoder -------------------------------------------

def test_history_from_rows_is_permutation_invariant():
    rows = [[0, 1, 1, 0, 0, 3],
            [1, 0, 0, 1, 1, 2],
            [2, 1, 2, 0, 4, 5],
            [1, 0, 0, 2, 4, 6]]
    base = history_from_rows(rows).fingerprint()
    assert base == j_history_from_rows(rows).fingerprint()
    for perm in itertools.permutations(rows):
        assert history_from_rows(list(perm)).fingerprint() == base


def test_history_from_rows_refuses_response_before_invocation():
    with pytest.raises(ValueError, match="precedes invoke_time"):
        history_from_rows([[0, 1, 1, 0, 5, 3]])
    h = history_from_rows([[0, 1, 1, -1, 5, 0]])
    assert h.n_pending == 1


# --- CLI exit codes --------------------------------------------------------

def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_ingest_check_exit_codes(capsys):
    from qsm_tpu.utils.cli import main as jmain
    from qsm_tpu_torch.utils.cli import main

    for path, fmt, model, want_rc, want in (
            (GOLDEN_JEPSEN, "jepsen", "register", 0, "LINEARIZABLE"),
            (GOLDEN_PORCUPINE, "porcupine", "kv", 1, "VIOLATION")):
        argv = ["ingest", path, "--format", fmt, "--spec", model,
                "--check"]
        rc = main(argv + ["--device", "cpu"])
        out = _last_json(capsys)
        assert rc == want_rc and out["verdict"] == want
        assert jmain(argv) == rc
        assert _last_json(capsys) == out     # the reference's JSON line


def test_cli_ingest_check_runs_on_the_card_unless_device_cpu(capsys):
    from qsm_tpu_torch.utils.cli import main

    with pytest.raises(BackendUnavailable):
        main(["ingest", GOLDEN_JEPSEN, "--format", "jepsen",
              "--spec", "register", "--check"])
    # --submit goes to a server (the served twin is
    # test_ingest_submit_to_a_served_port); none listens here
    with pytest.raises(ConnectionError):
        main(["ingest", GOLDEN_JEPSEN, "--format", "jepsen",
              "--spec", "register", "--submit", "127.0.0.1:1"])
    capsys.readouterr()


def test_cli_ingest_emit_is_byte_stable(capsys):
    from qsm_tpu_torch.utils.cli import main

    rc = main(["ingest", GOLDEN_PORCUPINE, "--format", "porcupine",
               "--spec", "kv", "--emit"])
    assert rc == 0
    assert capsys.readouterr().out == _golden(GOLDEN_PORCUPINE)


def test_cli_ingest_parse_error_exits_2(tmp_path, capsys):
    from qsm_tpu_torch.utils.cli import main

    bad = tmp_path / "bad.edn"
    bad.write_text("{:process 0, :type :invoke, :f :append, "
                   ":value 1}\n")
    rc = main(["ingest", str(bad), "--format", "jepsen",
               "--spec", "register", "--check", "--device", "cpu"])
    assert rc == 2
    capsys.readouterr()


def test_cli_ingest_out_feeds_check_and_shrink(tmp_path, capsys):
    """An ingested trace document is an ordinary corpus: the port's
    ``check`` decides it and its in-process ``shrink`` minimises it, and
    the document equals the reference's."""
    from qsm_tpu.utils.cli import main as jmain
    from qsm_tpu_torch.utils.cli import main

    out_path = tmp_path / "trace.json"
    rc = main(["ingest", GOLDEN_PORCUPINE, "--format", "porcupine",
               "--spec", "kv", "--out", str(out_path)])
    assert rc == 0
    capsys.readouterr()
    ref_path = tmp_path / "ref.json"
    assert jmain(["ingest", GOLDEN_PORCUPINE, "--format", "porcupine",
                  "--spec", "kv", "--out", str(ref_path)]) == 0
    capsys.readouterr()
    assert json.loads(out_path.read_text()) == \
        json.loads(ref_path.read_text())
    rc = main(["check", "--trace", str(out_path), "--device", "cpu"])
    assert rc == 1
    capsys.readouterr()
    rc = main(["shrink", "--trace", str(out_path), "--device", "cpu"])
    doc = _last_json(capsys)
    assert rc == 0 and doc["verdict"] == "VIOLATION"
    assert doc["final_ops"] <= doc["initial_ops"]


def test_ingested_trace_accepted_by_submit_and_serve_shrink():
    """The served twin of ``tests/test_ingest.py:273``: an ingested
    corpus goes to the port's server unchanged; ``check`` banks the
    verdict and the ``shrink`` verb minimises the same rows, to the
    reference server's answers."""
    from qsm_tpu.serve import CheckClient as JClient
    from qsm_tpu.serve import CheckServer as JServer
    from qsm_tpu_torch.ingest import parse_trace
    from qsm_tpu_torch.serve import CheckClient, CheckServer

    with open(GOLDEN_PORCUPINE) as f:
        text = f.read()
    rows = parse_trace("porcupine", text, "kv", MODELS["kv"].make_spec())
    assert rows == j_parse_trace("porcupine", text, "kv",
                                 JMODELS["kv"].make_spec())
    answers = []
    for server, client in ((JServer(flush_s=0.005, max_lanes=16), JClient),
                           (CheckServer(flush_s=0.005, max_lanes=16,
                                        device="cpu"), CheckClient)):
        srv = server.start()
        try:
            c = client(srv.address)
            res = c.check("kv", [rows])
            assert res["ok"] and res["verdicts"] == ["VIOLATION"]
            sh = c.shrink("kv", rows)
            assert sh["ok"] and sh["verdict"] == "VIOLATION"
            assert sh["final_ops"] <= sh["initial_ops"]
            c.close()
            answers.append((res["verdicts"], sh["history"],
                            sh["one_minimal"], sh["rounds"]))
        finally:
            srv.stop()
    assert answers[1] == answers[0]


def test_ingest_submit_to_a_served_port(capsys):
    """``ingest --submit ADDR``: the decoded trace goes to a running
    server; the exit code is ``submit``'s (1: a violation)."""
    from qsm_tpu_torch.serve import CheckServer
    from qsm_tpu_torch.utils.cli import main

    srv = CheckServer(flush_s=0.005, device="cpu").start()
    try:
        rc = main(["ingest", GOLDEN_PORCUPINE, "--format", "porcupine",
                   "--spec", "kv", "--submit", srv.address])
    finally:
        srv.stop()
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and doc["ok"] and doc["verdicts"] == ["VIOLATION"]
