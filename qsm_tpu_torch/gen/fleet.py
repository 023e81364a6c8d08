"""The closed loop — ``fuzz --addr``: soak a live server (or a failover
set of them) with generated work, trusting nothing it answers.

The counterpart of the JAX package's ``qsm_tpu/gen/fleet.py``.  The
corpora are generated on ``device`` (the threefry draw table on the card
unless ``device="cpu"``); the audit is the host's.

The steering loop runs client-side against a serve-plane shim: every
round's corpus goes up as an ordinary ``check`` request (witnesses
requested), and every returned verdict is **re-proved locally** before
it counts —

* a fresh memo oracle (``WingGongCPU(memo=True)``, built per batch so no
  cache state survives between rounds) re-checks every history; a
  decided fleet verdict that contradicts a decided oracle verdict is a
  ``wrong_verdict`` — the closed loop's only failure currency;
* every ``LINEARIZABLE`` with a witness is replayed search-free through
  ``verify_witness`` (ops/backend.py) — the fleet's proof obligation,
  not its word;
* a slice of generated histories is also STREAMED through monitor
  sessions (``session.open/append/close``) so the soak exercises the
  incremental frontier plane, not just the batch path.

The oracle re-check is not only audit: the shim absorbs the local
oracle's ``SearchStats``, so the steering loop's nodes-per-history
signal measures real search hardness even though the fleet's own
counters stay server-side.  The SLO/health plane is the judge — the
report carries the server's ``health`` answer and the run maps it to the
same exit codes the ``health`` subcommand uses (obs/slo.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ..obs.slo import HEALTH_EXIT_CODES, HEALTH_EXIT_UNREACHABLE
from ..ops.backend import Verdict, verify_witness
from ..ops.wing_gong_cpu import WingGongCPU
from ..search.stats import SearchStats, collect_search_stats
from ..serve.client import CheckClient, SessionHandle
from ..serve.protocol import VERDICT_NAMES, history_to_rows
from .steer import SteeringLoop

_NAME_TO_VERDICT = {n: i for i, n in enumerate(VERDICT_NAMES)}
# kept wrongness provenance: the COUNT is exact forever, the detail
# rows are capped (QSM-GEN-UNBOUNDED discipline — one wrong verdict is
# an incident, ten thousand identical ones are a counter)
_WRONG_KEEP = 32


class _FleetBackend:
    """``check_histories`` over a :class:`CheckClient`, oracle-audited.

    Looks like any other backend to the steering loop; every answer is
    cross-examined (module docstring) and the audit oracle's search
    counters become this backend's ``search_stats()``."""

    def __init__(self, client: CheckClient, model: str,
                 spec_kwargs: Optional[dict] = None,
                 deadline_s: Optional[float] = None):
        self.client = client
        self.model = model
        self.spec_kwargs = spec_kwargs
        self.deadline_s = deadline_s
        self.stats = SearchStats(engine="fleet-fuzz")
        self.wrong_verdicts = 0
        self.wrong: List[dict] = []       # provenance of each wrongness
        self.witnesses_verified = 0
        self.sheds = 0

    def check_histories(self, spec, histories):
        doc = self.client.check(self.model, list(histories),
                                spec_kwargs=self.spec_kwargs,
                                witness=True,
                                deadline_s=self.deadline_s)
        if not doc.get("ok"):
            # an honest shed/refusal is back-pressure, not wrongness:
            # surface it as undecided and let the loop keep breathing
            self.sheds += 1
            return [int(Verdict.BUDGET_EXCEEDED)] * len(histories)
        verdicts = [_NAME_TO_VERDICT[v] for v in doc["verdicts"]]
        witnesses = doc.get("witnesses") or [None] * len(verdicts)
        oracle = WingGongCPU(memo=True)  # fresh: no banked state
        truth = oracle.check_histories(spec, list(histories))
        self.stats.absorb(collect_search_stats(oracle))
        undecided = int(Verdict.BUDGET_EXCEEDED)
        for i, (h, v, w) in enumerate(zip(histories, verdicts,
                                          witnesses)):
            t = int(truth[i])
            if v != undecided and t != undecided and v != t:
                self._record_wrong({"index": i,
                                    "fleet": VERDICT_NAMES[v],
                                    "oracle": VERDICT_NAMES[t],
                                    "seed": h.seed,
                                    "program_id": h.program_id})
            if v == int(Verdict.LINEARIZABLE) and w is not None:
                if verify_witness(spec, h, [tuple(p) for p in w]):
                    self.witnesses_verified += 1
                else:
                    self._record_wrong({"index": i, "fleet": "witness",
                                        "oracle": "replay-failed",
                                        "seed": h.seed,
                                        "program_id": h.program_id})
        return verdicts

    def _record_wrong(self, row: dict) -> None:
        self.wrong_verdicts += 1
        if len(self.wrong) < _WRONG_KEEP:  # count exact, detail capped
            self.wrong.append(row)

    def search_stats(self) -> SearchStats:
        return dataclasses.replace(self.stats)


def _stream_session(client: CheckClient, model: str, history, *,
                    spec_kwargs: Optional[dict] = None,
                    deadline_s: Optional[float] = None,
                    chunk: int = 8) -> dict:
    """One generated history through the monitor plane, in invoke-order
    chunks (the live-wire-tap shape)."""
    handle = SessionHandle(client, model, spec_kwargs=spec_kwargs,
                           deadline_s=deadline_s)
    rows = history_to_rows(history)
    for i in range(0, len(rows), chunk):
        handle.append(rows[i:i + chunk])
    handle.close()
    return {"verdict": handle.verdict, "flips": len(handle.flips)}


def fuzz_fleet(address: str, models: Sequence[str], *, rounds: int = 4,
               batch: int = 16, seed: int = 0, pool_cap: int = 16,
               path: str = "auto", session_every: int = 2,
               deadline_s: Optional[float] = 30.0,
               timeout_s: float = 60.0,
               checkpoint_dir: Optional[str] = None,
               log=None, device=None) -> dict:
    """Soak the fleet at ``address`` (comma list = failover set) with
    steered generated work across ``models``; returns the report the
    acceptance gate reads: per-model round reports, the audit ledger
    (``wrong_verdicts_total`` — must be 0 against a healthy fleet), and
    the fleet's own health answer mapped to the ``health`` subcommand's
    exit codes.  ``device`` is where the corpora are generated."""
    from ..models.registry import MODELS

    report: Dict = {"address": address, "models": {}, "rounds": rounds,
                    "batch": batch, "wrong_verdicts_total": 0,
                    "flips_total": 0, "seqs_total": 0}
    with CheckClient(address, timeout_s=timeout_s) as client:
        for model in models:
            spec = MODELS[model].make_spec()
            backend = _FleetBackend(client, model,
                                    deadline_s=deadline_s)
            loop = SteeringLoop(spec, backend, batch=batch, seed=seed,
                                pool_cap=pool_cap, path=path,
                                device=device)
            if checkpoint_dir:
                import os

                ck = os.path.join(checkpoint_dir, f"fuzz_{model}.json")
                loop.load(ck)
            sessions = []
            round_reports = []
            for r in range(rounds):
                rr = loop.round()
                round_reports.append(rr)
                if log:
                    log(f"fuzz {model} round {r}: flips={rr['flips']} "
                        f"score={rr['score']}")
                if session_every and r % session_every == 0:
                    # stream the round's last flip (or any history) live
                    src = (loop.flip_histories[-1][0]
                           if loop.flip_histories else None)
                    if src is None:
                        from .core import generate_batch

                        src = generate_batch(spec, loop.pool.best().profile,
                                             seed * 7919 + r, 1,
                                             path=path,
                                             device=device)[0]
                    sessions.append(_stream_session(
                        client, model, src, deadline_s=deadline_s))
            if checkpoint_dir:
                loop.save(ck)
            st = loop.stats
            best = loop.pool.best()
            report["models"][model] = {
                "rounds": round_reports,
                "gen_seqs": st.gen_seqs,
                "gen_mutations": st.gen_mutations,
                "gen_flips": st.gen_flips,
                "gen_feedback_rounds": st.gen_feedback_rounds,
                "wrong_verdicts": backend.wrong_verdicts,
                "wrong": backend.wrong,
                "witnesses_verified": backend.witnesses_verified,
                "sheds": backend.sheds,
                "sessions": sessions,
                "session_flips": sum(s["flips"] for s in sessions),
                "best_profile": best.profile.to_dict() if best else None,
            }
            report["wrong_verdicts_total"] += backend.wrong_verdicts
            report["flips_total"] += st.gen_flips
            report["seqs_total"] += st.gen_seqs
        # the judge: the fleet's own SLO/health answer, mapped to the
        # same exit codes the `health` subcommand gives operators
        try:
            health = client.health()
        except (ConnectionError, OSError) as e:
            health = {"ok": False, "status": "unreachable",
                      "error": f"{type(e).__name__}: {e}"}
        report["health"] = health
        report["health_status"] = str(health.get("status",
                                                 "unreachable"))
        report["exit_code"] = (
            HEALTH_EXIT_CODES.get(report["health_status"],
                                  HEALTH_EXIT_UNREACHABLE)
            if health.get("ok") else HEALTH_EXIT_UNREACHABLE)
    return report
