"""SLO / health plane — declarative objectives over the live metrics.

The shed-storm flight trigger (obs/flight.py) was the plane's one
built-in opinion about "unhealthy".  This module replaces opinions
with CONFIGURED objectives: ``--slo "check=250ms:p99,shed_rate<0.01"``
declares what the operator means by healthy, the evaluator measures it
over a sliding window FROM THE SAME histograms ``/metrics`` exposes
(one set of books — no second latency accounting that drifts), and
three surfaces consume one evaluation:

* **burn-rate gauges** — ``qsm_slo_burn_rate{objective=...}`` on the
  metrics registry (burn = measured/target; >1 means the objective is
  breached NOW over the window);
* **the ``health`` protocol op** — ``{"op": "health"}`` answers the
  per-objective table and an overall status (``ok`` / ``degraded`` /
  ``breach``), which the ``health`` command maps to pinned exit codes
  (0 / 1 / 2; 3 = unreachable);
* **the ``slo.breach`` flight trigger** — the transition into breach
  emits one event, which the flight recorder dumps on (the shed-storm
  heuristic, promoted to a configured objective).

Grammar (comma-separated objectives)::

    <verb>=<duration>:<quantile>     e.g.  check=250ms:p99
    shed_rate<<fraction>             e.g.  shed_rate<0.01

``verb`` is a request-latency histogram label (``check`` / ``shrink``
/ ``session``); ``duration`` is ``<n>ms`` or ``<n>s``; ``quantile`` is
``p50``/``p95``/``p99``/``p999``-style.  Parse errors raise loudly at
configuration time — a typo'd objective must never silently evaluate
to "always healthy".

Window mechanics: the evaluator keeps a bounded ring of periodic
histogram/counter snapshots (taken lazily on evaluation, spaced by
``min_tick_s``); the windowed value is computed from the DELTA between
the freshest snapshot and the oldest one inside ``window_s``.  With
fewer than two snapshots (or an empty window) an objective reports
zero samples and burns 0 — absence of traffic is not a breach.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# severity order the health op and the CLI exit codes share
STATUS_ORDER = ("ok", "degraded", "breach")
# the health command's pinned exit codes (docs/OBSERVABILITY.md "Fleet")
HEALTH_EXIT_CODES = {"ok": 0, "degraded": 1, "breach": 2}
HEALTH_EXIT_UNREACHABLE = 3

_LATENCY_RE = re.compile(
    r"^(?P<verb>[a-z_]+)=(?P<num>\d+(?:\.\d+)?)(?P<unit>ms|s)"
    r":p(?P<q>\d{1,3})$")
_SHED_RE = re.compile(r"^shed_rate<(?P<limit>\d*\.?\d+)$")

GRAMMAR = ("objective grammar: '<verb>=<n>ms:p<QQ>' (e.g. "
           "check=250ms:p99) or 'shed_rate<FRAC' (e.g. "
           "shed_rate<0.01), comma-separated")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declared objective (name is the bounded metric-label
    identity: ``check_p99_ms`` / ``shed_rate``)."""

    name: str
    kind: str               # "latency" | "shed_rate"
    verb: str = ""          # latency only: the histogram label
    quantile: float = 0.0   # latency only: 0..1
    target: float = 0.0     # seconds (latency) or fraction (shed_rate)

    def target_repr(self) -> str:
        if self.kind == "latency":
            return f"{self.target * 1000.0:g}ms:p{self.quantile:g}"
        return f"<{self.target:g}"


def parse_slo(spec: str,
              verbs: Sequence[str] = ("check", "shrink", "session")
              ) -> List[Objective]:
    """Parse one ``--slo`` string into objectives; raises ValueError
    with the grammar on anything malformed or an unknown verb."""
    out: List[Objective] = []
    for raw in str(spec).split(","):
        item = raw.strip()
        if not item:
            continue
        m = _SHED_RE.match(item)
        if m:
            limit = float(m.group("limit"))
            if not 0.0 < limit <= 1.0:
                raise ValueError(
                    f"slo objective {item!r}: shed_rate limit must be "
                    f"in (0, 1]; {GRAMMAR}")
            out.append(Objective(name="shed_rate", kind="shed_rate",
                                 target=limit))
            continue
        m = _LATENCY_RE.match(item)
        if m:
            verb = m.group("verb")
            if verb not in verbs:
                raise ValueError(
                    f"slo objective {item!r}: unknown verb {verb!r}; "
                    f"one of {sorted(verbs)}")
            digits = m.group("q")
            q = int(digits) / (10 ** len(digits))
            if not 0.0 < q < 1.0:
                raise ValueError(
                    f"slo objective {item!r}: quantile p{digits} is "
                    f"out of (0, 1); {GRAMMAR}")
            seconds = float(m.group("num")) * (
                0.001 if m.group("unit") == "ms" else 1.0)
            out.append(Objective(
                name=f"{verb}_p{digits}_ms", kind="latency", verb=verb,
                quantile=q, target=seconds))
            continue
        raise ValueError(f"cannot parse slo objective {item!r}; "
                         f"{GRAMMAR}")
    if not out:
        raise ValueError(f"empty slo spec {spec!r}; {GRAMMAR}")
    names = [o.name for o in out]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise ValueError(f"duplicate slo objectives {dupes}")
    return out


def quantile_from_counts(bounds: Tuple[float, ...],
                         counts: Sequence[int], q: float) -> float:
    """The windowed twin of ``Histogram.quantile``: the estimated
    q-quantile from a DELTA count vector (linear interpolation inside
    the winning bucket).  0.0 with no observations."""
    total = sum(counts)
    if not total:
        return 0.0
    target = q * total
    seen = 0.0
    for i, c in enumerate(counts):
        if not c:
            continue
        if seen + c >= target:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            frac = (target - seen) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        seen += c
    return bounds[-1]


class SloEvaluator:
    """See module docstring.  One instance per server/router;
    thread-safe (the health op, the metrics scrape and the breach
    trigger all evaluate from different threads)."""

    def __init__(self, objectives: Sequence[Objective], *,
                 latency_hist,
                 requests_fn: Callable[[], float],
                 sheds_fn: Callable[[], float],
                 window_s: float = 60.0,
                 min_tick_s: Optional[float] = None,
                 warn_frac: float = 0.8,
                 on_breach: Optional[Callable[[dict], None]] = None):
        self.objectives = list(objectives)
        self.hist = latency_hist
        self.requests_fn = requests_fn
        self.sheds_fn = sheds_fn
        self.window_s = max(0.5, float(window_s))
        self.min_tick_s = (min_tick_s if min_tick_s is not None
                           else min(1.0, self.window_s / 10.0))
        self.min_tick_s = max(0.01, self.min_tick_s)
        self.warn_frac = warn_frac
        self.on_breach = on_breach
        self._lock = threading.Lock()
        # bounded by construction: window/tick snapshots plus slack —
        # the evaluator is O(window/tick) memory however long it runs
        cap = int(self.window_s / self.min_tick_s) + 4
        self._snaps: deque = deque(maxlen=cap)
        self._breached: set = set()
        self.breaches = 0    # ok->breach transitions (monotonic)
        self.evaluations = 0

    # ------------------------------------------------------------------
    def _verbs(self) -> List[str]:
        return sorted({o.verb for o in self.objectives
                       if o.kind == "latency"})

    def _take_snapshot(self, now: float) -> dict:
        return {
            "t": now,
            "hist": {v: self.hist.counts(verb=v) for v in self._verbs()},
            "requests": float(self.requests_fn()),
            "sheds": float(self.sheds_fn()),
        }

    def _window_pair(self, now: float):
        """(freshest snapshot, baseline snapshot) for the sliding
        window — baseline is the newest snapshot at least ``window_s``
        old, else the oldest held (a young evaluator reports the
        window it actually has)."""
        snap = self._take_snapshot(now)
        if (not self._snaps
                or now - self._snaps[-1]["t"] >= self.min_tick_s):
            self._snaps.append(snap)
        base = None
        for s in self._snaps:
            if now - s["t"] >= self.window_s:
                base = s
            else:
                break
        if base is None:
            base = self._snaps[0]
        return snap, base

    # ------------------------------------------------------------------
    def evaluate(self) -> dict:
        """One evaluation: the per-objective table and the overall
        status; fires ``on_breach`` once per ok→breach transition."""
        now = time.monotonic()
        fired: List[dict] = []
        with self._lock:
            self.evaluations += 1
            cur, base = self._window_pair(now)
            window_actual = max(0.0, cur["t"] - base["t"])
            rows: List[dict] = []
            worst = "ok"
            for obj in self.objectives:
                row = self._evaluate_one(obj, cur, base)
                rows.append(row)
                if row["status"] == "breach":
                    worst = "breach"
                    if obj.name not in self._breached:
                        self._breached.add(obj.name)
                        self.breaches += 1
                        fired.append(row)
                else:
                    self._breached.discard(obj.name)
                    if row["status"] == "degraded" and worst == "ok":
                        worst = "degraded"
            doc = {"status": worst,
                   "window_s": self.window_s,
                   "window_actual_s": round(window_actual, 2),
                   "objectives": rows}
        if self.on_breach is not None:
            for row in fired:
                try:
                    self.on_breach(row)
                except Exception:  # noqa: BLE001 — a broken trigger
                    pass           # must never take evaluation down
        return doc

    def _evaluate_one(self, obj: Objective, cur: dict,
                      base: dict) -> dict:
        if obj.kind == "latency":
            c0 = base["hist"].get(obj.verb) or []
            c1 = cur["hist"].get(obj.verb) or []
            delta = [max(0, a - b) for a, b in
                     zip(c1, c0 or [0] * len(c1))]
            samples = sum(delta)
            value = quantile_from_counts(self.hist.bounds, delta,
                                         obj.quantile)
            burn = (value / obj.target) if samples else 0.0
            row_value = round(value * 1000.0, 3)   # ms, human-facing
            target_repr = round(obj.target * 1000.0, 3)
        else:
            reqs = cur["requests"] - base["requests"]
            sheds = cur["sheds"] - base["sheds"]
            samples = int(max(0, reqs))
            value = (sheds / reqs) if reqs > 0 else 0.0
            burn = (value / obj.target) if samples else 0.0
            row_value = round(value, 5)
            target_repr = obj.target
        if samples and burn > 1.0:
            status = "breach"
        elif samples and burn >= self.warn_frac:
            status = "degraded"
        else:
            status = "ok"
        return {"objective": obj.name, "kind": obj.kind,
                "target": target_repr, "value": row_value,
                "burn_rate": round(burn, 4), "samples": int(samples),
                "status": status}

    # ------------------------------------------------------------------
    def metric_samples(self):
        """Scrape-time collector samples: burn-rate / breached gauges
        per objective (bounded label set — objective names come from
        the configuration string, never from request data)."""
        doc = self.evaluate()
        out = []
        for row in doc["objectives"]:
            labels = {"objective": row["objective"]}
            out.append(("qsm_slo_burn_rate", "gauge",
                        "windowed measured/target ratio (>1 = breach)",
                        labels, float(row["burn_rate"])))
            out.append(("qsm_slo_breached", "gauge",
                        "1 while the objective is breached over the "
                        "window", labels,
                        1.0 if row["status"] == "breach" else 0.0))
            out.append(("qsm_slo_samples", "gauge",
                        "observations inside the objective's window",
                        labels, float(row["samples"])))
        out.append(("qsm_slo_breach_transitions_total", "counter",
                    "ok->breach transitions observed", {},
                    float(self.breaches)))
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {"objectives": [
                        {"name": o.name, "kind": o.kind,
                         "target": o.target_repr()}
                        for o in self.objectives],
                    "window_s": self.window_s,
                    "breaches": self.breaches,
                    "evaluations": self.evaluations}


#: The window-utilization target: a drained device-work window should
#: spend at least this fraction of its wall clock in engine dispatch.
WINDOW_UTILIZATION_TARGET = 0.8


def utilization_objective(value,
                          target: float = WINDOW_UTILIZATION_TARGET
                          ) -> dict:
    """``window_utilization`` as one more objective row (the device-work
    queue's windows).

    Shaped exactly like :meth:`SloEvaluator._evaluate_one`'s rows so
    the ``health`` verb can append it to a configured objective table
    (or report it alone).  This is a LOWER-bound objective — burn is
    target/measured, >1 means the last window wasted device time — and
    ``value=None`` (no window drained yet) reports zero samples and
    burns 0: rare windows are the subsystem's premise, their absence
    is never an incident."""
    if value is None:
        burn, samples, status, row_value = 0.0, 0, "ok", None
    else:
        v = float(value)
        burn = (target / v) if v > 0 else float("inf")
        samples = 1
        if burn > 1.25:
            status = "breach"
        elif burn > 1.0:
            status = "degraded"
        else:
            status = "ok"
        row_value = round(v, 4)
        burn = round(burn, 4) if burn != float("inf") else burn
    return {"objective": f"window_utilization>={target}",
            "kind": "utilization", "target": target,
            "value": row_value, "burn_rate": burn,
            "samples": samples, "status": status}


def worst_status(statuses) -> str:
    """The fleet-health fold: the most severe of a set of statuses
    (unknown strings read as ``degraded`` — an unreachable node is a
    health problem, not a breach proof)."""
    worst = 0
    for s in statuses:
        try:
            worst = max(worst, STATUS_ORDER.index(s))
        except ValueError:
            worst = max(worst, STATUS_ORDER.index("degraded"))
    return STATUS_ORDER[worst]
