"""Graceful degradation: any device engine, backed by the host checker.

The counterpart of the JAX package's ``qsm_tpu/resilience/failover.py``.
:class:`FailoverBackend` wraps a device checker (``TorchStepper``,
``TorchGPU``, ``HybridDevice``, a combinator: anything with
``check_histories``) so that a property run survives a lost dispatch:

* **Undecided lanes only.**  Histories go to the device in slices of
  ``dispatch_lanes`` (1024, the reference's constant); the verdicts of
  completed slices are kept and only the remainder goes to the fallback.
* **One-way degradation.**  A lost device stays lost for the instance:
  later batches go straight to the fallback.
* **Exact fallbacks only.**  The fallback is the property layer's own
  resolving oracle (:func:`host_fallback`: the native C++ checker when it
  builds, else the memoised Python oracle), so degraded verdicts and
  witnesses are those of a clean host run.

Every dispatch runs under the ``dispatch`` preset's retry ladder, each
attempt bounded by the process' dispatch :class:`~.policy.Watchdog` (one
long-lived worker thread for every wrapper, ``resilience/policy.py``),
from the caller's CUDA stream when the engine runs on the card.

**The card's rule.**  What degrades depends on where the engine runs
(:func:`host_only`):

* an engine shown to run on the host (``CppOracle``, ``WingGongCPU``, or
  an engine whose torch device is the CPU, as ``device="cpu"`` makes it)
  follows the reference: every error of ``ops.backend.
  device_error_types`` is retried by the policy and then degrades;
* any other engine, on CUDA or of a device that cannot be found, degrades
  only on what the fault plane injected: an ``InjectedFault``, or a
  watchdog timeout of a dispatch during which a ``hang`` rule of
  ``dispatch`` fired.  A real CUDA error, a real timeout, a
  ``KernelBuildError`` or a ``BackendUnavailable`` raises out of the
  wrapper (and out of ``prop_concurrent``), and no degrade is recorded,
  so that the wrap never becomes the fallback that hides a broken card.

:func:`degradable_errors` states the rule once; ``ops/hybrid.py``'s plan
applies it too.

A degrade is reported as a ``failover.degrade`` event through the
observability plane's global sink (``obs/__init__.py::emit_global``), as
in the reference, and recorded in the counters.  Counters
(``degradations``, ``retries``, ``fallback_engine``,
``device_histories``, ``fallback_histories``) ride ``search_stats()``
and :func:`collect_resilience`.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.history import History
from ..core.spec import Spec
from ..ops.backend import Verdict, device_error_types
from .faults import InjectedFault, acted
from .policy import RetryPolicy, Watchdog, WatchdogTimeout, preset


def host_fallback(spec: Spec):
    """The host checker ladder: the native C++ oracle when the toolchain
    builds it (itself falling back to the Python oracle for anything
    outside its coverage), else the memoised Python oracle.  The property
    layer's resolving oracle and the hybrid plan's tail are this one
    ladder."""
    from ..native import CppOracle, native_available
    from ..ops.wing_gong_cpu import WingGongCPU

    if native_available():
        return CppOracle(spec)
    return WingGongCPU(memo=True)


def budget_resolver(spec: Spec):
    """The exact host checker that resolves a device engine's
    BUDGET_EXCEEDED lanes: the host ladder, per key (``PComp`` over it)
    when the spec's projection validates.  The reference resolves with
    the memo oracle; the verdicts are the same, and a device engine's
    undecided lanes are the hard ones (whole KV histories of 16 keys take
    the memo oracle minutes)."""
    from ..core.spec import projection_report

    if projection_report(spec):
        return host_fallback(spec)
    from ..ops.pcomp import PComp

    return PComp(spec, make_inner=host_fallback)


def resolve_budget_lanes(resolver, spec: Spec, hists, verdicts) -> int:
    """Decide again on ``resolver`` every lane of ``verdicts`` (a list,
    changed in place) that is BUDGET_EXCEEDED; returns how many."""
    todo = [i for i, v in enumerate(verdicts)
            if int(v) == int(Verdict.BUDGET_EXCEEDED)]
    if todo:
        sub = resolver.check_histories(spec, [hists[i] for i in todo])
        for i, v in zip(todo, sub):
            verdicts[i] = int(v)
    return len(todo)


# the attributes a combinator keeps its engines under: the per-key split,
# segmentation and root splitting (inner), the hybrid plan and this
# wrapper (device), the router (plain, pcomp)
_ENGINE_ATTRS = ("device", "inner", "plain", "pcomp")


def _engine_leaves(engine, seen=None):
    """The torch devices and host checkers an engine's search reaches,
    through its wrappers; an object with neither and no wrapped engine is
    a leaf of its own (unknown)."""
    from ..native import CppOracle
    from ..ops.wing_gong_cpu import WingGongCPU

    seen = set() if seen is None else seen
    if id(engine) in seen:
        return []
    seen.add(id(engine))
    if isinstance(engine, (torch.device, CppOracle, WingGongCPU)):
        return [engine]
    subs = [getattr(engine, a) for a in _ENGINE_ATTRS
            if getattr(engine, a, None) is not None]
    if not subs:
        return [engine]
    return [leaf for s in subs for leaf in _engine_leaves(s, seen)]


def host_only(engine) -> bool:
    """True iff every search under ``engine`` is shown to run on the
    host: a host checker, or a torch device that is the CPU."""
    from ..native import CppOracle
    from ..ops.wing_gong_cpu import WingGongCPU

    return all(isinstance(x, (CppOracle, WingGongCPU))
               or (isinstance(x, torch.device) and x.type == "cpu")
               for x in _engine_leaves(engine))


def cuda_device(engine) -> Optional[torch.device]:
    """The CUDA device an engine's search runs on, or None."""
    return next((x for x in _engine_leaves(engine)
                 if isinstance(x, torch.device) and x.type == "cuda"), None)


_prebuilt = threading.Event()


def _prebuild() -> None:
    """Every kernel built, once a process, before the first guarded
    dispatch (outside any watchdog's clock)."""
    if not _prebuilt.is_set():
        from ..ops.kernels import build_all

        build_all()
        _prebuilt.set()


_DISPATCH_WATCHDOG = Watchdog("failover.dispatch")


class InjectedHang(WatchdogTimeout):
    """A watchdog timeout of a dispatch during which the fault plane's
    ``hang`` rule of ``dispatch`` fired: an injected fault, so the card's
    rule degrades on it."""


def degradable_errors(on_card: bool) -> tuple:
    """The errors that degrade an engine to the host (and that a retry
    policy retries): on the card (an engine not :func:`host_only`) only
    what the fault plane injected, else ``device_error_types`` as in the
    JAX package."""
    if on_card:
        return (InjectedFault, InjectedHang)
    return device_error_types()


def watched_call(fn, timeout_s, cuda: Optional[torch.device],
                 on_card: bool, watchdog: Optional[Watchdog] = None,
                 hang_sites: Sequence[str] = ("dispatch",)):
    """``fn()`` on the process' dispatch watchdog (``watchdog``, by
    default the one :class:`FailoverBackend` uses), bounded by
    ``timeout_s``.  With a CUDA device the kernels are built first,
    outside the watchdog's clock (an abandoned build must never be what a
    timeout measures), and ``fn`` runs on the caller's current stream,
    which the watchdog's thread would not otherwise share (the worker
    keeps the last one it was given).  On the card, a timeout during
    which a ``hang`` rule of one of ``hang_sites`` fired becomes
    :class:`InjectedHang`."""
    call = fn
    if cuda is not None:
        _prebuild()
        stream = torch.cuda.current_stream(cuda)

        def call():
            if torch.cuda.current_stream(cuda) != stream:
                torch.cuda.set_stream(stream)
            return fn()
    hangs = [acted(site, "hang") for site in hang_sites]
    try:
        return (watchdog or _DISPATCH_WATCHDOG)(call, timeout_s)
    except WatchdogTimeout as e:
        if on_card and any(acted(site, "hang") > n
                           for site, n in zip(hang_sites, hangs)):
            raise InjectedHang(str(e)) from e
        raise


class FailoverBackend:
    """Device majority while the device lives; the host ladder the moment
    it does not.  See the module docstring for the guarantees and for
    the card's rule."""

    # Lanes a guarded dispatch: the unit of bankable progress (the JAX
    # package's constant).
    DISPATCH_LANES = 1024

    def __init__(self, spec: Spec, device, fallback=None,
                 policy: Optional[RetryPolicy] = None,
                 dispatch_lanes: Optional[int] = None):
        self.spec = spec
        self.device = device
        self.fallback = fallback if fallback is not None \
            else host_fallback(spec)
        self.policy = policy or preset("dispatch")
        self.dispatch_lanes = dispatch_lanes or self.DISPATCH_LANES
        self.name = f"failover({getattr(device, 'name', type(device).__name__)})"
        # the card's rule (module docstring) unless the engine is shown
        # to run on the host
        self.on_card = not host_only(device)
        self._cuda = cuda_device(device)
        if self._cuda is not None and not torch.cuda.is_available():
            self._cuda = None   # the calls below raise on their own
        # one worker for every wrapper of the process: a property run's
        # new wrapper pays no thread start and no thread's first CUDA work
        self.watchdog = _DISPATCH_WATCHDOG
        self.degraded = False
        self.degradations = 0       # device-loss events (0 or 1)
        self.retries = 0            # extra dispatch attempts before degrading
        self.fallback_engine = ""   # set on the first degradation
        self.last_error = ""
        self.device_histories = 0   # lanes the device decided
        self.fallback_histories = 0  # lanes the host ladder decided
        # of the last check_histories call: the lanes the fallback decided
        self.last_fallback = np.zeros(0, bool)

    @property
    def _degradable(self) -> tuple:
        return degradable_errors(self.on_card)

    # ------------------------------------------------------------------
    def check_histories(self, spec: Spec,
                        histories: Sequence[History]) -> np.ndarray:
        out = np.full(len(histories), int(Verdict.BUDGET_EXCEEDED), np.int8)
        pending = list(range(len(histories)))
        while pending and not self.degraded:
            idx = pending[:self.dispatch_lanes]
            try:
                sub = self._guarded_dispatch(spec,
                                             [histories[i] for i in idx])
            except self._degradable as e:
                self._degrade(e)
                break  # the in-flight slice stays pending
            out[np.asarray(idx)] = np.asarray(sub, np.int8)
            self.device_histories += len(idx)
            pending = pending[self.dispatch_lanes:]
        self.last_fallback = np.zeros(len(histories), bool)
        if pending:
            self.last_fallback[np.asarray(pending)] = True
            # the undecided lanes only: the verdicts above are kept
            sub = self.fallback.check_histories(
                spec, [histories[i] for i in pending])
            out[np.asarray(pending)] = np.asarray(sub, np.int8)
            self.fallback_histories += len(pending)
        return out

    def check_witness(self, spec: Spec, history: History):
        """The witness of whichever side is alive; the fallback's are the
        host oracle's own."""
        if not self.degraded and hasattr(self.device, "check_witness"):
            try:
                return self._watched(
                    lambda: self.device.check_witness(spec, history))
            except self._degradable as e:
                self._degrade(e)
        return self.fallback.check_witness(spec, history)

    # ------------------------------------------------------------------
    def _watched(self, fn):
        """``fn()`` under the watchdog (:func:`watched_call`)."""
        return watched_call(fn, self.policy.timeout_s, self._cuda,
                            self.on_card, self.watchdog)

    def _guarded_dispatch(self, spec, hists):
        """One slice through the policy: each attempt bounded by the
        watchdog, retries spaced and bounded by the policy's ladder.
        Raises once the ladder is exhausted."""
        state = {"attempt": 0}

        def attempt():
            state["attempt"] += 1
            if state["attempt"] > 1:
                self.retries += 1
            return self._watched(
                lambda: self.device.check_histories(spec, hists))

        return self.policy.run(attempt, retriable=self._degradable)

    def _degrade(self, err: BaseException) -> None:
        self.degraded = True
        self.degradations += 1
        self.fallback_engine = getattr(self.fallback, "name",
                                       type(self.fallback).__name__)
        self.last_error = f"{type(err).__name__}: {err}"[:200]
        # a degradation is an event of the global observability sink
        # (obs/__init__.py), if one is installed: one read without it
        from ..obs import emit_global

        emit_global("failover.degrade", engine=self.name,
                    fallback=self.fallback_engine,
                    error=self.last_error)

    # ------------------------------------------------------------------
    def resilience(self) -> dict:
        """The counter block records embed (:func:`collect_resilience`
        finds it by convention)."""
        return {
            "degradations": self.degradations,
            "retries": self.retries,
            "fallback_engine": self.fallback_engine or None,
            "device_histories": self.device_histories,
            "fallback_histories": self.fallback_histories,
            "policy": self.policy.name,
            **({"last_error": self.last_error} if self.last_error else {}),
        }

    def search_stats(self):
        """The wrapped engine's cost record with the resilience counters
        folded in, and the fallback's nodes beside the device's
        iterations (work moved to the host counts as a saving only with
        the host's nodes shown too)."""
        from ..search.stats import SearchStats, collect_search_stats

        st = collect_search_stats(self.device) or SearchStats()
        st.engine = self.name
        st.degradations += self.degradations
        st.retries += self.retries
        if self.fallback_engine:
            st.fallback_engine = self.fallback_engine
        if self.fallback_histories:
            st.tail_histories += self.fallback_histories
            st.absorb(collect_search_stats(self.fallback))
        return st


def collect_resilience(backend) -> dict:
    """Resilience counters of any backend, zeros when it exposes none, so
    that every record can carry the block (``degradations: 0`` is a
    claim; a missing key is not).  Probes the conventional wrapper
    attributes as ``search/stats.py::collect_search_stats`` does."""
    for obj in (backend, getattr(backend, "device", None),
                getattr(backend, "plain", None),
                getattr(backend, "inner", None)):
        fn = getattr(obj, "resilience", None)
        if callable(fn):
            return fn()
    return {"degradations": 0, "retries": 0, "fallback_engine": None}
