"""``qsmlint`` orchestration for the port — declarative pass families
over the port's own files (the counterpart of
``qsm_tpu/analysis/engine.py``).

One entry point, :func:`run_lint`, drives the :data:`FAMILIES`
registry: each family declares its id (the ``--family`` letter, the
reference's), its scan set and how it runs — ``per_file`` (independent
single-module checks, cacheable per file) or ``whole`` (semantic runs:
the spec and kernel families, which execute code).  Nothing
special-cases the engine.  The families the port has are a–f, h, m and
o; the reference's whole-program race (g) and protocol (l) families and
its obs (i), fleet (j), monitor (k) and mesh (n) families are not
registered here yet, and selecting one is a usage error.

The semantic families run on the lint's device — the card unless the
caller asks for the CPU (``device="cpu"``); without a card and without
that request :func:`run_lint` raises ``BackendUnavailable`` and runs
nothing.  On the card family (a)'s parity evaluates ``step_torch`` there,
family (b)'s rebuild guard warms the real backends (``TorchGPU``,
``TorchStepper`` in both regimes) and each kernel is launched once at
its largest admitted plan.

Incrementality (``analysis/incremental.py``): per-file findings are
cached on disk keyed by content digest + analyzer fingerprint, in the
port's own ``.qsmlint-torch-cache.json``; ``changed=REF`` narrows the
scan itself to git-touched modules.  Both stamp the ``--json`` report
(``cache``, ``changed``) so an archived lint says what it actually
looked at.

Consumed by ``python -m qsm_tpu_torch lint`` (exit 1 on non-whitelisted
error findings), tests/test_torch_lint.py and ``chip_smoke.py``'s
phase 23.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import (Callable, Dict, List, Optional, Sequence, Set,
                    Tuple, Union)

from .findings import ERROR, Finding, Whitelist, render_json, \
    split_whitelisted

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(_PKG_DIR)

# The scan sets mirror the reference's DEFAULT_*_FILES module for module,
# each reference module replaced by its counterpart in the port.

# the device engines the kernel passes cover: the backends (the
# reference's jax_kernel.py and pallas_kernel.py), the kernel wrappers
# and the combinators
DEFAULT_OPS_FILES = ("ops/stepper.py", "ops/gpu_backend.py",
                     "ops/dfs_kernel.py", "ops/stepper_kernel.py",
                     "ops/sweep_kernel.py", "ops/draws_kernel.py",
                     "ops/segdc.py", "ops/rootsplit.py", "ops/pcomp.py")
# the scheduler plane the determinism passes cover
DEFAULT_SCHED_FILES = ("sched/scheduler.py", "sched/pool.py",
                       "sched/transport.py", "sched/runner.py")
# every module that touches the device substrate or spawns bounded
# children — the resilience passes' beat (repo-root-relative: the
# scripts of a run live outside the package).  ops/backend.py holds the
# port's device resolution (the reference's utils/device.py), ops/
# kernels.py the nvcc builds, chip_smoke.py and tools/ the runs on the
# card (the reference's bench.py and tools/)
DEFAULT_RESILIENCE_FILES = (
    "qsm_tpu_torch/ops/stepper.py", "qsm_tpu_torch/ops/gpu_backend.py",
    "qsm_tpu_torch/ops/stepper_kernel.py",
    "qsm_tpu_torch/ops/segdc.py", "qsm_tpu_torch/ops/rootsplit.py",
    "qsm_tpu_torch/ops/pcomp.py", "qsm_tpu_torch/ops/backend.py",
    "qsm_tpu_torch/ops/kernels.py", "qsm_tpu_torch/utils/cli.py",
    "qsm_tpu_torch/native/__init__.py", "chip_smoke.py",
    "tools/torch_property_turns.py",
    "qsm_tpu_torch/serve/pool.py", "qsm_tpu_torch/serve/worker.py")
# the serving plane the serve passes cover: every module that accepts
# connections, buffers lanes, or drives the server — the pool supervisor
# and the worker's own recv loops, and the fleet tier, which accepts
# connections and loops over node links
DEFAULT_SERVE_FILES = (
    "qsm_tpu_torch/serve/server.py", "qsm_tpu_torch/serve/batcher.py",
    "qsm_tpu_torch/serve/admission.py", "qsm_tpu_torch/serve/cache.py",
    "qsm_tpu_torch/serve/client.py", "qsm_tpu_torch/serve/protocol.py",
    "qsm_tpu_torch/serve/pool.py", "qsm_tpu_torch/serve/worker.py",
    "qsm_tpu_torch/serve/frames.py",
    "qsm_tpu_torch/fleet/router.py", "qsm_tpu_torch/fleet/membership.py",
    "qsm_tpu_torch/fleet/replog.py", "qsm_tpu_torch/fleet/lease.py",
    "qsm_tpu_torch/fleet/gossip.py")
# the worker-lifecycle modules the pool passes cover: everything that
# spawns or supervises worker processes
DEFAULT_POOL_FILES = (
    "qsm_tpu_torch/serve/pool.py", "qsm_tpu_torch/serve/worker.py")
# the shrink-plane modules the frontier-bound pass covers (family h)
DEFAULT_SHRINK_FILES = (
    "qsm_tpu_torch/shrink/frontier.py", "qsm_tpu_torch/shrink/shrinker.py")
# the generation-plane modules the campaign-bound pass covers (family
# m): the fuzzer core + steering loop + fleet shim
DEFAULT_GEN_FILES = (
    "qsm_tpu_torch/gen/core.py", "qsm_tpu_torch/gen/profile.py",
    "qsm_tpu_torch/gen/steer.py", "qsm_tpu_torch/gen/fleet.py")
# the device-work-queue scan set (family o): the queue + drain plane.
# monitor/session.py has a ``_drain`` of its own (the reorder-buffer
# flush) and is deliberately NOT here.
DEFAULT_DEVQ_FILES = (
    "qsm_tpu_torch/devq/queue.py", "qsm_tpu_torch/devq/drain.py")


def default_whitelist_path() -> str:
    return os.path.join(REPO_ROOT, ".qsmlint-torch")


# ---------------------------------------------------------------------------
# the declarative family registry
# ---------------------------------------------------------------------------

class _LintRun:
    """Per-run context the family runners share: validated model
    names, lazily-built specs, knobs, the device, and what the semantic
    families measured (stamped into the report)."""

    def __init__(self, names: List[str], retrace: bool, seed: int,
                 device="cpu"):
        self.names = names
        self.retrace = retrace
        self.seed = seed
        self.device = device
        self._specs: Optional[List[tuple]] = None
        self.parity: Dict[str, dict] = {}
        self.rebuild: Dict[str, dict] = {}
        self.kernels: List[dict] = []
        self.edges: List[dict] = []

    @property
    def specs(self) -> List[tuple]:
        if self._specs is None:
            from ..models.registry import MODELS

            self._specs = [(n, MODELS[n].make_spec(), f"model:{n}")
                           for n in self.names]
        return self._specs


@dataclasses.dataclass(frozen=True)
class Family:
    """One registered pass family.

    ``per_file`` families run an independent check over each file of
    their scan set (cacheable per file, subsettable by ``--changed``);
    ``whole`` families run once over the full set — the semantic passes
    (spec/kernel), which execute code.  ``triggers`` are the extra path
    prefixes that force a family to run under ``--changed`` even when no
    scan-set file itself changed (spec soundness depends on the model
    sources, not on any linted file)."""

    fid: str                       # the --family id (the reference's)
    key: str                       # passes-timing / report key
    title: str
    files: Tuple[str, ...] = ()
    base: str = "repo"             # scan-set paths relative to: repo|pkg
    per_file: Optional[Callable[[str, str], List[Finding]]] = None
    whole: Optional[Callable[["_LintRun", List[str]],
                             List[Finding]]] = None
    triggers: Tuple[str, ...] = ()
    cacheable: bool = True

    def resolve(self, rel: str) -> str:
        if os.path.isabs(rel):
            return rel
        root = _PKG_DIR if self.base == "pkg" else REPO_ROOT
        return os.path.join(root, rel)

    def repo_rel(self, rel: str) -> str:
        """Scan-set entry as a repo-relative path (the --changed and
        cache-key form)."""
        try:
            return os.path.relpath(self.resolve(rel), REPO_ROOT)
        except ValueError:
            return rel


def _run_spec(ctx: _LintRun, _files: List[str]) -> List[Finding]:
    from .kernel_passes import check_step_dtypes
    from .spec_passes import check_spec

    out: List[Finding] = []
    for name, spec, loc in ctx.specs:
        stats: dict = {"device": str(ctx.device)}
        out += check_spec(spec, loc, seed=ctx.seed, device=ctx.device,
                          stats=stats)
        out += check_step_dtypes(spec, loc, device=ctx.device)
        ctx.parity[name] = stats
    return out


def _rebuild_corpora(entry, spec):
    """Two same-bucket corpora for the rebuild guard (the second call
    must find everything built); falls back to re-running the first
    corpus when generation buckets them differently (the reference's
    ``_retrace_corpora``)."""
    from ..core.history import bucket_for
    from ..utils.corpus import build_corpus

    impls = (entry.impls["atomic"], entry.impls["racy"]) \
        if {"atomic", "racy"} <= set(entry.impls) \
        else tuple(entry.impls.values())[:2]
    a = build_corpus(spec, impls, n=6, n_pids=4, max_ops=10,
                     seed_base=0, seed_prefix="lint_a")
    b = build_corpus(spec, impls, n=6, n_pids=4, max_ops=10,
                     seed_base=100, seed_prefix="lint_b")
    bucket = bucket_for(max(len(h) for h in a) or 1)
    if bucket_for(max(len(h) for h in b) or 1) != bucket:
        b = a  # identical re-check is still a valid rebuild probe
    return [a, b]


# The rebuild guard's backends: their build discipline is
# spec-independent, so one representative spec a kernel path is enough —
# the CAS register through TorchGPU (dfs_chunk) and TorchStepper's table
# regime (stepper_chunk, compact_carry), a KV map of 16 keys through its
# sweep regime (stepper_sweep), as chip_smoke.py's paths run them.
REBUILD_KV_KEYS = 16


def rebuild_backends(device) -> List[tuple]:
    """``(label, spec, backend, corpora, location)`` for the rebuild
    guard, every backend on ``device``."""
    from ..models.kv import KvSpec
    from ..models.registry import MODELS
    from ..ops.gpu_backend import TorchGPU
    from ..ops.stepper import TorchStepper

    knobs = dict(budget=2_000, mid_budget=0, rescue_budget=0,
                 device=device)
    cas = MODELS["cas"].make_spec()
    kv16 = KvSpec(n_keys=REBUILD_KV_KEYS)
    cas_corpora = _rebuild_corpora(MODELS["cas"], cas)
    # one chunk shape: any build or cache growth is a real rebuild
    return [
        ("TorchGPU cas", cas, TorchGPU(cas, **knobs), cas_corpora,
         "qsm_tpu_torch/ops/gpu_backend.py"),
        ("TorchStepper cas (table)", cas,
         TorchStepper(cas, chunk_schedule=(512,), **knobs), cas_corpora,
         "qsm_tpu_torch/ops/stepper.py"),
        ("TorchStepper kv16 (sweep)", kv16,
         TorchStepper(kv16, chunk_schedule=(512,), **knobs),
         _rebuild_corpora(MODELS["kv"], kv16),
         "qsm_tpu_torch/ops/stepper.py"),
    ]


def _run_kernel(ctx: _LintRun, files: List[str]) -> List[Finding]:
    from .kernel_passes import (check_host_transfers,
                                check_kernel_envelope, check_rebuild,
                                launch_edge_plans)

    out: List[Finding] = []
    for path in files:
        out += check_host_transfers(path, root=REPO_ROOT)
    on_card = getattr(ctx.device, "type", str(ctx.device)) == "cuda"
    sms = None
    if on_card:
        from ..ops.stepper_kernel import device_sms

        sms = device_sms(ctx.device)
    found, ctx.kernels = check_kernel_envelope(ctx.specs, sms=sms)
    out += found
    if on_card:
        found, ctx.edges = launch_edge_plans(ctx.specs, ctx.device)
        out += found
    if ctx.retrace:
        for label, spec, backend, corpora, loc in rebuild_backends(
                ctx.device):
            rec: dict = {}
            out += check_rebuild(spec, backend, corpora, loc, record=rec)
            ctx.rebuild[label] = rec
    return out


def _per_file_sched(path: str, root: str) -> List[Finding]:
    from .sched_passes import check_sched_file

    return check_sched_file(path, root=root)


def _per_file_resilience(path: str, root: str) -> List[Finding]:
    from .resilience_passes import check_resilience_file

    return check_resilience_file(path, root=root)


def _per_file_serve(path: str, root: str) -> List[Finding]:
    from .serve_passes import check_serve_file

    return check_serve_file(path, root=root)


def _per_file_pool(path: str, root: str) -> List[Finding]:
    from .pool_passes import check_pool_file

    return check_pool_file(path, root=root)


def _per_file_shrink(path: str, root: str) -> List[Finding]:
    from .shrink_passes import check_shrink_file

    return check_shrink_file(path, root=root)


def _per_file_gen(path: str, root: str) -> List[Finding]:
    from .gen_passes import check_gen_file

    return check_gen_file(path, root=root)


def _per_file_devq(path: str, root: str) -> List[Finding]:
    from .devq_passes import check_devq_file

    return check_devq_file(path, root=root)


_AN = "qsm_tpu_torch/analysis/"

FAMILIES: Dict[str, Family] = {f.fid: f for f in (
    Family(fid="a", key="spec",
           title="spec soundness (parity, domains, bounds, dtypes, "
                 "projections)",
           whole=_run_spec, cacheable=False,
           triggers=("qsm_tpu_torch/models/", "qsm_tpu_torch/core/",
                     # projection consumers: a pcomp/planner change can
                     # shift what QSM-SPEC-PCOMP must hold, and the
                     # shrink plane's drop-key axis trusts the same
                     # validated projection
                     "qsm_tpu_torch/ops/pcomp.py",
                     "qsm_tpu_torch/search/planner.py",
                     "qsm_tpu_torch/shrink/",
                     _AN + "spec_passes.py", _AN + "kernel_passes.py")),
    Family(fid="b", key="kernel",
           title="kernel hazards (host xfer, shared memory and "
                 "registers, rebuild)",
           files=DEFAULT_OPS_FILES, base="pkg",
           whole=_run_kernel, cacheable=False,
           triggers=("qsm_tpu_torch/ops/", "qsm_tpu_torch/csrc/",
                     "qsm_tpu_torch/models/", "qsm_tpu_torch/core/",
                     _AN + "kernel_passes.py", _AN + "astutil.py")),
    Family(fid="c", key="sched",
           title="scheduler determinism",
           files=DEFAULT_SCHED_FILES, base="pkg",
           per_file=_per_file_sched,
           triggers=(_AN + "sched_passes.py", _AN + "astutil.py")),
    Family(fid="d", key="resilience",
           title="unbounded device/subprocess calls",
           files=DEFAULT_RESILIENCE_FILES,
           per_file=_per_file_resilience,
           triggers=(_AN + "resilience_passes.py", _AN + "astutil.py")),
    Family(fid="e", key="serve",
           title="serving-plane loops and queues",
           files=DEFAULT_SERVE_FILES, per_file=_per_file_serve,
           triggers=(_AN + "serve_passes.py", _AN + "astutil.py")),
    Family(fid="f", key="pool",
           title="worker-process lifecycle",
           files=DEFAULT_POOL_FILES, per_file=_per_file_pool,
           triggers=(_AN + "pool_passes.py", _AN + "astutil.py")),
    Family(fid="h", key="shrink",
           title="shrink-plane frontier bounds",
           files=DEFAULT_SHRINK_FILES, per_file=_per_file_shrink,
           triggers=(_AN + "shrink_passes.py", _AN + "astutil.py")),
    Family(fid="m", key="gen",
           title="generation-campaign bounds (capacity-evicted seed "
                 "pools, tail-windowed flip logs)",
           files=DEFAULT_GEN_FILES, per_file=_per_file_gen,
           triggers=(_AN + "gen_passes.py", _AN + "astutil.py")),
    Family(fid="o", key="devq",
           title="device-work-queue discipline (bounded banked work, "
                 "deadline-consulting drain loops)",
           files=DEFAULT_DEVQ_FILES, per_file=_per_file_devq,
           triggers=(_AN + "devq_passes.py",
                     # family o's scan shares family m's ownership
                     # refinement and the class scan in astutil
                     _AN + "gen_passes.py", _AN + "astutil.py")),
)}


@dataclasses.dataclass
class LintReport:
    findings: List[Finding]          # non-whitelisted
    whitelisted: List[Finding]
    passes: Dict[str, float]         # family key -> seconds
    seconds: float
    models: List[str]
    whitelist_path: Optional[str] = None  # the file actually loaded
    families: List[str] = dataclasses.field(default_factory=list)
    cache: Optional[dict] = None     # {path, hits, misses}
    changed: Optional[dict] = None   # {ref, files} when --changed ran
    device: Optional[str] = None     # where the semantic passes ran
    parity: Optional[dict] = None    # family (a): model -> grid size
    rebuild: Optional[dict] = None   # family (b): backend -> states
    kernels: Optional[list] = None   # family (b): a row a kernel
    edges: Optional[list] = None     # family (b): the edge launches

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def ok(self) -> bool:
        """True when no non-whitelisted error-severity findings."""
        return not self.errors

    def _meta(self) -> dict:
        meta = {"ok": self.ok,
                "seconds": round(self.seconds, 3),
                "passes": {k: round(v, 3)
                           for k, v in self.passes.items()},
                "models": self.models,
                "families": self.families,
                "device": self.device}
        for key in ("cache", "changed", "parity", "rebuild", "kernels",
                    "edges"):
            val = getattr(self, key)
            if val:
                meta[key] = val
        return meta

    def to_json(self) -> str:
        return render_json(self.findings, self.whitelisted,
                           meta=self._meta())

    def to_sarif(self) -> str:
        from .findings import render_sarif

        return render_sarif(self.findings, self.whitelisted,
                            meta=self._meta())


def _resolve_whitelist(whitelist: Union[None, str, Whitelist]
                       ) -> Optional[Whitelist]:
    if isinstance(whitelist, Whitelist):
        return whitelist
    if isinstance(whitelist, str):
        return Whitelist.load(whitelist)
    path = default_whitelist_path()
    if os.path.exists(path):
        return Whitelist.load(path)
    return None


def _resolve_families(families: Optional[Sequence[str]]
                      ) -> List[Family]:
    if families is None:
        return list(FAMILIES.values())
    unknown = [f for f in families if f not in FAMILIES]
    if unknown:
        raise ValueError(f"unknown pass families {unknown}; "
                         f"one of {sorted(FAMILIES)}")
    # dedupe, order-preserving: "--family e,e" must not double every
    # finding in the archived report
    return [FAMILIES[f] for f in dict.fromkeys(families)]


def run_lint(models: Optional[Sequence[str]] = None,
             retrace: bool = True,
             whitelist: Union[None, str, Whitelist] = None,
             families: Optional[Sequence[str]] = None,
             changed: Optional[str] = None,
             cache: Union[bool, str] = True,
             file_overrides: Optional[Dict[str, Sequence[str]]] = None,
             seed: int = 0, device=None) -> LintReport:
    """Run the registered pass families.

    ``families`` — family ids to run (None = all registered).
    ``changed`` — a git ref: narrow per-file families to modules
    touched since it (whole families run iff their scan set or
    triggers were touched); git trouble falls back to the full tree.
    ``cache`` — True (default cache path), a path, or False: reuse
    per-file findings whose content digest is unchanged.
    ``file_overrides`` — family id -> replacement scan set (tests).
    ``retrace`` — run the rebuild guard (the reference's knob name).
    ``device`` — where the semantic passes run: CUDA unless the caller
    asks for the CPU; without a card that raises ``BackendUnavailable``
    before any pass runs."""
    from ..models.registry import MODELS
    from ..ops.backend import resolve_device
    from . import incremental

    t_start = time.perf_counter()
    names = list(models) if models else sorted(MODELS)
    unknown = [n for n in names if n not in MODELS]
    if unknown:
        raise ValueError(f"unknown model families {unknown}; "
                         f"one of {sorted(MODELS)}")
    fams = _resolve_families(families)
    dev = resolve_device(device)
    ctx = _LintRun(names, retrace, seed, dev)

    changed_set: Optional[Set[str]] = None
    changed_meta: Optional[dict] = None
    if changed is not None:
        changed_set = incremental.changed_files(REPO_ROOT, changed)
        changed_meta = {"ref": changed,
                        "files": (sorted(changed_set)
                                  if changed_set is not None else None),
                        "git_ok": changed_set is not None}

    lint_cache: Optional[incremental.LintCache] = None
    if cache:
        cache_path = (cache if isinstance(cache, str)
                      else incremental.default_cache_path(REPO_ROOT))
        lint_cache = incremental.LintCache(cache_path)

    findings: List[Finding] = []
    passes: Dict[str, float] = {}
    for fam in fams:
        t0 = time.perf_counter()
        findings += _run_family(fam, ctx, changed_set, lint_cache,
                                file_overrides or {})
        passes[fam.key] = time.perf_counter() - t0
    if lint_cache is not None:
        lint_cache.save()

    wl = _resolve_whitelist(whitelist)
    kept, allowed = split_whitelisted(findings, wl)
    return LintReport(findings=kept, whitelisted=allowed, passes=passes,
                      seconds=time.perf_counter() - t_start,
                      models=names,
                      whitelist_path=wl.path if wl else None,
                      families=[f.fid for f in fams],
                      cache=(lint_cache.stats() if lint_cache else None),
                      changed=changed_meta, device=str(dev),
                      parity=ctx.parity, rebuild=ctx.rebuild,
                      kernels=ctx.kernels, edges=ctx.edges)


def _run_family(fam: Family, ctx: _LintRun,
                changed_set: Optional[Set[str]],
                cache, file_overrides: Dict[str, Sequence[str]]
                ) -> List[Finding]:
    from . import incremental

    file_set = list(file_overrides.get(fam.fid, fam.files))
    rel_paths = [fam.repo_rel(r) for r in file_set]
    abs_paths = [fam.resolve(r) for r in file_set]

    # a touched trigger (the family's own pass source) re-lints the
    # whole scan set even when no scanned file changed: a rule edit
    # must be exercised, not skipped, under --changed
    trigger_hit = (changed_set is not None and fam.triggers
                   and any(p.startswith(fam.triggers)
                           for p in changed_set))

    if fam.per_file is not None:
        out: List[Finding] = []
        for rel, path in zip(rel_paths, abs_paths):
            if (changed_set is not None and rel not in changed_set
                    and not trigger_hit):
                continue
            if cache is not None and fam.cacheable:
                key = f"{fam.fid}:{rel}:{incremental.file_digest(path)}"
                hit = cache.get(key)
                if hit is not None:
                    out += hit
                    continue
                found = fam.per_file(path, REPO_ROOT)
                cache.put(key, found)
            else:  # --no-cache: don't hash files for a discarded key
                found = fam.per_file(path, REPO_ROOT)
            out += found
        return out

    # whole-set family: under --changed it runs iff its scan set or
    # trigger prefixes were touched; cacheable ones key on the set
    if changed_set is not None:
        if not trigger_hit and not any(rel in changed_set
                                       for rel in rel_paths):
            return []
    if cache is not None and fam.cacheable:
        key = f"{fam.fid}:<set>:{incremental.combined_digest(abs_paths)}"
        hit = cache.get(key)
        if hit is not None:
            return hit
        found = fam.whole(ctx, abs_paths)
        cache.put(key, found)
        return found
    return fam.whole(ctx, abs_paths)
