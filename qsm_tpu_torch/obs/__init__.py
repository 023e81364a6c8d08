"""``qsm_tpu_torch.obs``: the trace, metrics and flight-recorder plane.

The counterpart of the JAX package's ``qsm_tpu/obs`` (standard library
only; docs/OBSERVABILITY.md describes both):

* ``trace``: request-scoped :class:`~qsm_tpu_torch.obs.trace.Span` /
  :class:`~qsm_tpu_torch.obs.trace.Tracer`, trace ids, a JSONL span log
  with bounded rotation, and the offline causal-tree reconstruction
  behind ``python -m qsm_tpu_torch trace <trace_id>``;
* ``metrics``: a counter / gauge / histogram registry with scrape-time
  collectors, rendered in Prometheus exposition format
  (:class:`~qsm_tpu_torch.obs.metrics.MetricsServer`);
* ``flight``: the flight recorder, a fixed-size in-memory ring of recent
  span events per component, dumped atomically to ``FLIGHT_<ts>.json``
  on crashes, SHED storms and fault-plane hits;
* ``slo``: service-level objectives over the metrics and the health exit
  codes;
* ``collect``: cursor-paged span collection over a fetch callable.

:class:`Observability` bundles the first three; the module-level
:func:`set_global` / :func:`emit_global` hooks let deep engine layers
(``resilience/failover.py``, ``ops/hybrid.py``,
``resilience/faults.py``) report degradations and fault hits without
carrying an obs handle through every constructor.  The modules here use
the standard library only.
"""

from __future__ import annotations

import threading
from typing import Optional

from .collect import SpanCollector, read_span_page
from .flight import FlightRecorder, load_dump, recent_events
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      MetricsServer, parse_exposition)
from .slo import (HEALTH_EXIT_CODES, HEALTH_EXIT_UNREACHABLE,
                  Objective, SloEvaluator, parse_slo, worst_status)
from .trace import (NULL_SPAN, Span, Tracer, build_tree, load_events,
                    new_span_id, new_trace_id, render_tree,
                    trace_closure)

# events that flip the flight recorder's dump trigger the moment they
# are emitted (beyond the shed-storm window the server drives itself).
# The fleet tier's node-loss events (fleet/router.py, fleet/
# membership.py) ride the same rule: a dead/partitioned/quarantined
# NODE leaves an artifact naming the doomed dispatches' trace ids,
# exactly like a SIGKILLed pool worker one level down.
_DUMP_TRIGGERS = {"worker.shed": "worker_crash",
                  "pool.quarantine": "quarantine",
                  "fault.hit": "fault_plane",
                  "node.shed": "node_death",
                  "node.partition": "partition",
                  "fleet.quarantine": "node_quarantine",
                  # a router-HA takeover is a fleet-level incident by
                  # definition (the old brain is dead, wedged or
                  # partitioned): the new active's first act leaves an
                  # artifact recording what it observed when it took
                  # the term (fleet/router.py _promote)
                  "router.takeover": "router_takeover",
                  # a monitor session deciding a VIOLATION is the
                  # production incident the whole plane exists for:
                  # the dump names the session's trace id even when no
                  # client ever reads the flip response
                  "session.flip": "session_flip",
                  # a configured SLO objective crossing into breach is
                  # the operator's OWN definition of an incident — the
                  # shed-storm heuristic promoted to a declared
                  # objective (obs/slo.py; the evaluator emits the
                  # event once per ok->breach transition)
                  "slo.breach": "slo_breach"}


class Observability:
    """One server's trace + metrics + flight bundle.

    ``metrics`` is ALWAYS live (a registry write is a lock around a
    float add — cheap enough for the default path); span emission and
    the flight ring are opt-in via ``trace_log`` / ``flight_dir``, and
    every emit site in the serving stack guards on the single ``on``
    attribute so the tracing-off path costs next to nothing."""

    def __init__(self, trace_log: Optional[str] = None,
                 flight_dir: Optional[str] = None, *,
                 trace_max_bytes: Optional[int] = None,
                 flight_events: int = 256,
                 shed_storm: int = 32):
        kw = {}
        if trace_max_bytes is not None:
            kw["max_bytes"] = trace_max_bytes
        self.tracer = Tracer(path=trace_log, **kw)
        self.metrics = MetricsRegistry()
        self.flight: Optional[FlightRecorder] = None
        if flight_dir is not None:
            self.flight = FlightRecorder(flight_dir,
                                         max_events=flight_events,
                                         storm_threshold=shed_storm)
            self.tracer.add_hook(self._on_event)
        # ONE attribute read at every emit site
        self.on = self.tracer.enabled

    # ------------------------------------------------------------------
    def _on_event(self, doc: dict) -> None:
        self.flight.record(doc)
        reason = _DUMP_TRIGGERS.get(doc.get("name"))
        if reason is not None:
            self.flight.dump(reason, extra={"event": doc})

    # -- emission (thin delegates, all guarded by ``on``) --------------
    def span(self, name: str, trace: str, parent: str = "", **attrs):
        if not self.on:
            return NULL_SPAN
        return self.tracer.span(name, trace, parent, **attrs)

    def event(self, name: str, trace: str = "", parent: str = "",
              ms: Optional[float] = None, **attrs) -> str:
        if not self.on:
            return ""
        return self.tracer.event(name, trace=trace, parent=parent,
                                 ms=ms, **attrs)

    # -- flight conveniences -------------------------------------------
    def note_shed(self) -> Optional[str]:
        if self.flight is None:
            return None
        return self.flight.note_shed()

    def flight_path(self) -> Optional[str]:
        """The most recent flight dump, if one fired (SHED responses
        carry it so a shed client can hand the operator an artifact)."""
        if self.flight is None:
            return None
        return self.flight.last_dump_path

    def dump_flight(self, reason: str, force: bool = False
                    ) -> Optional[str]:
        if self.flight is None:
            return None
        return self.flight.dump(reason, force=force)

    def close(self) -> None:
        self.tracer.close()

    def snapshot(self) -> dict:
        return {
            "tracing": self.tracer.snapshot(),
            "flight": (self.flight.snapshot()
                       if self.flight is not None else None),
        }


# ---------------------------------------------------------------------------
# the global hook deep layers report through (failover/hybrid/faults)
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_global_obs: Optional[Observability] = None


def set_global(obs: Optional[Observability]) -> None:
    """Install (or clear) the process-global observability sink.  The
    check server installs itself on ``start()`` — last server wins,
    which matches the one-server-per-process deployment shape."""
    global _global_obs
    with _global_lock:
        _global_obs = obs


def global_obs() -> Optional[Observability]:
    with _global_lock:
        return _global_obs


def emit_global(name: str, trace: str = "", **attrs) -> None:
    """Emit one event into the global sink, if any — the zero-plumbing
    path for layers (failover degradation, fault-plane hits) that must
    stay constructible without an obs handle.  No sink, or a sink with
    tracing off, costs one lock + one attribute read."""
    obs = global_obs()
    if obs is None or not obs.on:
        return
    obs.event(name, trace=trace, **attrs)


__all__ = [
    "Counter", "FlightRecorder", "Gauge", "HEALTH_EXIT_CODES",
    "HEALTH_EXIT_UNREACHABLE", "Histogram", "MetricsRegistry",
    "MetricsServer", "NULL_SPAN", "Objective", "Observability",
    "SloEvaluator", "Span", "SpanCollector", "Tracer", "build_tree",
    "emit_global", "global_obs", "load_dump", "load_events",
    "new_span_id", "new_trace_id", "parse_exposition", "parse_slo",
    "read_span_page", "recent_events", "render_tree", "set_global",
    "trace_closure", "worst_status",
]
