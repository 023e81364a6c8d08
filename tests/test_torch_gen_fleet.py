"""The port's closed loop (``gen/fleet.py::fuzz_fleet``, ``fuzz --addr``)
against the JAX package's: the same seed and models, each package's loop
against its own package's CPU server.  The steered corpora are the same,
so every count of the two reports must be equal, and every served answer
survives the fresh-oracle audit (``wrong_verdicts_total`` 0)."""

from __future__ import annotations

import json

from _torch_serve_pkgs import PORT, REF, strip

_MODELS = ("register", "cas")


def _fuzz(pkg, **kw):
    import importlib

    fleet = importlib.import_module(f"{pkg.root}.gen.fleet")
    srv = pkg.server(flush_s=0.005, max_lanes=16).start()
    try:
        if pkg.port:
            kw["device"] = "cpu"
        return fleet.fuzz_fleet(srv.address, _MODELS, rounds=2, batch=8,
                                seed=3, pool_cap=4, session_every=1,
                                deadline_s=30.0, timeout_s=60.0, **kw)
    finally:
        srv.stop()


def _counts(rep):
    out = {k: rep[k] for k in ("wrong_verdicts_total", "flips_total",
                               "seqs_total", "rounds", "batch",
                               "health_status", "exit_code")}
    for model, m in rep["models"].items():
        out[model] = strip({k: v for k, v in m.items()
                            if k not in ("rounds", "best_profile")})
        out[model]["rounds"] = [strip(r, drop=("seconds",))
                                for r in m["rounds"]]
    return out


def test_fuzz_fleet_report_counts_equal_the_references():
    ref = _fuzz(REF)
    got = _fuzz(PORT)
    assert got["wrong_verdicts_total"] == 0
    assert ref["wrong_verdicts_total"] == 0
    assert got["exit_code"] == 0 and got["health_status"] == "ok"
    assert json.dumps(_counts(got), sort_keys=True) == \
        json.dumps(_counts(ref), sort_keys=True)
    for model in _MODELS:
        assert got["models"][model]["witnesses_verified"] > 0


def test_fuzz_addr_cli_exit_code(capsys):
    srv = PORT.server(flush_s=0.005, max_lanes=16).start()
    try:
        rc = PORT.main(["fuzz", "--addr", srv.address, "--models", "cas",
                        "--rounds", "1", "--histories", "4", "--seed", "1",
                        "--session-every", "0", "--device", "cpu"])
    finally:
        srv.stop()
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rep["wrong_verdicts_total"] == 0
    assert rep["exit_code"] == 0
