"""Live metrics — a lock-cheap counter/gauge/histogram registry.

The serve plane already keeps every number a capacity decision needs
(admission/batcher/cache/pool snapshots, SearchStats) — but only as a
pull-the-whole-JSON ``stats`` verb.  This registry gives those numbers
a live, scrapeable surface with two deliberate properties:

* **Lock-cheap writes.**  A counter increment or histogram observation
  is one small-critical-section lock around a float add — safe from
  any thread, never on a path that holds a serving-plane lock.
* **Collectors, not copies.**  Most serve metrics are *derived* from
  counters the plane already maintains; re-counting them here would
  create a second set of books that drifts.  A registered collector is
  called at scrape time and yields samples straight from the one
  authoritative snapshot, so the ``/metrics`` endpoint and the stats
  documents reconcile by construction.

Rendering is the Prometheus plaintext exposition format (version
0.0.4): :class:`MetricsServer` serves it on ``GET /metrics``, and
:func:`parse_exposition` reads it back.

Cardinality contract: metric NAMES and label VALUES come from bounded
sets (worker ids, flush reasons, verdict names) — never from
per-request data like history fingerprints.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# (name, type, help, labels, value) — what collectors yield and the
# renderer consumes; ONE shape for owned metrics and collected ones
Sample = Tuple[str, str, str, Dict[str, str], float]

# dispatch/request latency buckets (seconds): sub-ms cache hits up to
# the wedge-detection region; fixed and few — the histogram is O(1)
# memory however many observations arrive
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter, optionally labeled (bounded label values
    only — see the module cardinality contract)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._vals: Dict[tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._vals[key] = self._vals.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._vals.get(_label_key(labels), 0.0)

    def samples(self) -> Iterable[Sample]:
        with self._lock:
            vals = dict(self._vals)
        for key, v in sorted(vals.items()):
            yield (self.name, "counter", self.help, dict(key), v)


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._vals: Dict[tuple, float] = {}

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._vals[_label_key(labels)] = float(v)

    def value(self, **labels) -> float:
        with self._lock:
            return self._vals.get(_label_key(labels), 0.0)

    def samples(self) -> Iterable[Sample]:
        with self._lock:
            vals = dict(self._vals)
        for key, v in sorted(vals.items()):
            yield (self.name, "gauge", self.help, dict(key), v)


class Histogram:
    """Fixed-bucket latency histogram with quantile estimation.

    Buckets are cumulative (Prometheus ``le`` semantics); quantiles
    are estimated by linear interpolation inside the winning bucket —
    exact enough for p50/p99 dashboards at O(len(buckets)) memory,
    which is the point (a reservoir would be per-request state)."""

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.bounds = tuple(sorted(buckets))
        self._lock = threading.Lock()
        # per-label-set: [bucket counts..., +Inf count], sum
        self._counts: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = {}

    def observe(self, v: float, **labels) -> None:
        key = _label_key(labels)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.bounds) + 1)
                self._sums[key] = 0.0
            counts[i] += 1
            self._sums[key] += v

    def quantile(self, q: float, **labels) -> float:
        """Estimated q-quantile (0..1) for one label set; 0.0 with no
        observations."""
        key = _label_key(labels)
        with self._lock:
            counts = list(self._counts.get(key, ()))
        total = sum(counts)
        if not total:
            return 0.0
        target = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if not c:
                continue
            if seen + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.bounds[-1])
                frac = (target - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.bounds[-1]

    def count(self, **labels) -> int:
        with self._lock:
            return sum(self._counts.get(_label_key(labels), ()))

    def counts(self, **labels) -> List[int]:
        """One label set's raw bucket-count vector (bucket order =
        ``self.bounds`` + the +Inf overflow) — what the SLO plane
        snapshots so sliding windows read the SAME books as
        ``/metrics`` (obs/slo.py)."""
        with self._lock:
            return list(self._counts.get(
                _label_key(labels), [0] * (len(self.bounds) + 1)))

    def samples(self) -> Iterable[Sample]:
        with self._lock:
            counts = {k: list(v) for k, v in self._counts.items()}
            sums = dict(self._sums)
        for key, cs in sorted(counts.items()):
            labels = dict(key)
            cum = 0
            for bound, c in zip(self.bounds, cs):
                cum += c
                yield (f"{self.name}_bucket", "histogram", self.help,
                       {**labels, "le": repr(float(bound))}, float(cum))
            cum += cs[-1]
            yield (f"{self.name}_bucket", "histogram", self.help,
                   {**labels, "le": "+Inf"}, float(cum))
            yield (f"{self.name}_count", "histogram", self.help,
                   labels, float(cum))
            yield (f"{self.name}_sum", "histogram", self.help,
                   labels, round(sums[key], 6))


class MetricsRegistry:
    """Named metrics plus scrape-time collectors (module docstring).
    One instance per server — tests get isolation for free."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[str, object]" = {}
        self._collectors: List[Callable[[], Iterable[Sample]]] = []

    # -- owned metrics -------------------------------------------------
    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help), Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help), Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get(name, lambda: Histogram(name, help, buckets),
                         Histogram)

    def _get(self, name, make, want):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = make()
            elif not isinstance(m, want):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}")
            return m

    # -- collectors ----------------------------------------------------
    def register_collector(
            self, fn: Callable[[], Iterable[Sample]]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def unregister_collector(
            self, fn: Callable[[], Iterable[Sample]]) -> None:
        """Remove a collector (a stopped server must not keep feeding
        — and being pinned by — a registry that outlives it); unknown
        collectors are ignored."""
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    # -- rendering -----------------------------------------------------
    def collect(self) -> List[Sample]:
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        out: List[Sample] = []
        for m in metrics:
            out.extend(m.samples())
        for fn in collectors:
            try:
                out.extend(fn())
            except Exception:  # noqa: BLE001 — one broken collector
                continue       # must not take the scrape down
        return out

    def render(self) -> str:
        """Prometheus plaintext exposition (0.0.4)."""
        lines: List[str] = []
        seen_meta = set()
        for name, mtype, help_, labels, value in self.collect():
            base = name
            for suffix in ("_bucket", "_count", "_sum"):
                if mtype == "histogram" and name.endswith(suffix):
                    base = name[: -len(suffix)]
                    break
            if base not in seen_meta:
                seen_meta.add(base)
                if help_:
                    lines.append(f"# HELP {base} {help_}")
                lines.append(f"# TYPE {base} {mtype}")
            if labels:
                lbl = ",".join(
                    f'{k}="{v}"' for k, v in sorted(labels.items()))
                lines.append(f"{name}{{{lbl}}} {_fmt(value)}")
            else:
                lines.append(f"{name} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def values(self) -> Dict[str, float]:
        """Flat ``name{labels}`` → value map (the reconciliation tests'
        view; label-free names map bare)."""
        out: Dict[str, float] = {}
        for name, _t, _h, labels, value in self.collect():
            if labels:
                lbl = ",".join(
                    f'{k}="{v}"' for k, v in sorted(labels.items()))
                out[f"{name}{{{lbl}}}"] = value
            else:
                out[name] = value
        return out


def _fmt(v: float) -> str:
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def parse_exposition(text: str) -> Dict[str, float]:
    """Inverse of :meth:`MetricsRegistry.render` for tests and the
    stats-reconciliation check: ``name{labels}`` → value."""
    out: Dict[str, float] = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        name, _, val = ln.rpartition(" ")
        try:
            out[name] = float(val)
        except ValueError:
            continue
    return out


class MetricsServer:
    """Tiny plaintext ``GET /metrics`` endpoint on a daemon thread.

    Deliberately not a framework: one ``ThreadingHTTPServer`` whose
    only routes are ``/metrics`` (the registry exposition) and
    ``/healthz``; everything else is 404.  Bound to loopback by
    default, ephemeral port supported (``port=0`` → ``self.port``)."""

    def __init__(self, registry: MetricsRegistry,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        self.host = host
        self.port = port
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        registry = self.registry

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server's contract
                if self.path.split("?")[0] == "/metrics":
                    body = registry.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                elif self.path == "/healthz":
                    body = b"ok\n"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *_args) -> None:
                return  # scrapes must not spam the server's stderr

        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.2},
                                        daemon=True, name="qsm-metrics")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(2.0)
