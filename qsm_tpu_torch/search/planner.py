"""The search planner: corpus statistics in, ``SearchPlan`` out.

The counterpart of the JAX package's ``qsm_tpu/search/planner.py``.  The
chunked device loop (``ops/stepper.py::TorchStepper``) runs on a chunk
schedule, a bucket ladder and a memo size per bucket; ``plan_search``
picks them, and the two search modes, from what is known:

* **platform**: ``"cpu"`` gives the JAX package's CPU plan
  (``cpu-fine-v1``) exactly as it builds it, so that a test can hand the
  same plan to both packages; ``"cuda"`` (and ``None``: the port's entry
  points run on the card) gives the port's own plan, ``cuda-h100-v1``,
  from ``ops/stepper.py``'s defaults (``CHUNK_SCHEDULE``,
  ``BATCH_BUCKETS``, ``default_slots``).  No constant measured on or for
  a TPU carries over: ``"tpu"`` is refused;
* **mesh width** (``mesh_devices``): a plan for ``n > 1`` devices keeps
  the buckets ``n`` divides (``mesh/dispatch.py``), and its name gains
  ``@mesh{n}``, so that a ladder filtered for one width never serves
  another;
* **corpus statistics** (``profile_corpus``): the mean quiescent-cut
  density decides decomposition (wrap the kernel in ``SegDC``:
  exhaustion cost is exponential in segment length), the per-key shape
  decides ``decompose_keys`` (``PComp`` outermost), and history length
  sets the first chunk (a first chunk shorter than the depth of a
  success path decides nothing);
* **spec**: ordering is on exactly when the spec has a scalar domain to
  rank against (``search/ordering.py``).

Verdict contract: a plan changes iteration counts only.  Budgets are not
part of it, and BUDGET_EXCEEDED stays an honest deferral.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from ..core.history import History
from .ordering import ordering_table

# The CPU plan, as the JAX package builds it: fine buckets down to a
# single lane and the full memo everywhere; a x2 ladder of chunks from
# just past the 32-op success-path depth.
_CPU_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                16384, 65536, 262144)
_CPU_SLOTS = 4096
_CPU_SCHEDULE = (48, 96, 192, 384, 768, 1536, 3072, 6144, 12288, 24576,
                 49152)
CPU_PLAN = "cpu-fine-v1"
# The port's plan for the card: ops/stepper.py's defaults, chosen for one
# H100 (its module comment gives the reasons).
CUDA_PLAN = "cuda-h100-v1"

# Decomposition gates, as in the JAX package: below this mean of
# segments a history the cut scan is overhead on a corpus that mostly
# cannot cut (1.15: about one history in 7 cuts once) ...
_DECOMPOSE_MEAN_SEGMENTS = 1.15
# ... and, with the per-key split on, the gate judged on the
# sub-histories' own density, set higher because a cut on an
# already-short sub-history buys less (1.35: about one sub-history in 3
# cuts once).
_DECOMPOSE_MEAN_SEGMENTS_SUB = 1.35


@dataclasses.dataclass(frozen=True)
class CorpusProfile:
    """What the planner is allowed to know about the workload."""

    n: int = 0
    max_ops: int = 0
    mean_ops: float = 0.0
    pending_fraction: float = 0.0
    cut_fraction: float = 0.0    # histories with ≥1 quiescent cut
    mean_segments: float = 1.0   # segments per history
    # per-key decomposition shape (only measured when profile_corpus is
    # given a spec whose projection VALIDATES — ops/pcomp.py): the
    # longest per-key sub-history across the corpus, and the mean number
    # of keys a history splits into.  sub_max_ops == 0 means "not
    # measured" — the decompose_keys gate then stays off.
    sub_max_ops: int = 0
    mean_partitions: float = 0.0
    # segment density OF THE SUB-HISTORIES (segments per per-key
    # sub-history): what the inner kernel actually sees when
    # decompose_keys is on — the segdc gate must be judged on this, not
    # on the whole-history density above.
    # 0.0 means "not measured" (no spec / invalid projection).
    sub_mean_segments: float = 0.0


def profile_corpus(histories: Sequence[History],
                   spec=None) -> CorpusProfile:
    """Corpus statistics; pass ``spec`` to also measure the per-key
    decomposition shape (sub-history lengths) when the spec declares a
    valid projection — the planner's ``decompose_keys`` gate needs it."""
    from ..ops.segdc import split_at_quiescent_cuts

    if not histories:
        return CorpusProfile()
    lens = [len(h) for h in histories]
    segs = [len(split_at_quiescent_cuts(h)) for h in histories]
    sub_max = 0
    mean_parts = 0.0
    sub_mean_segs = 0.0
    if spec is not None:
        from ..core.spec import projection_report
        from ..ops.pcomp import split_history

        if not projection_report(spec):
            # ONE split per history yields all three decomposition
            # statistics: the longest sub-history (compile-bucket
            # gate), the key count, and the decomposed corpus's own
            # segment profile — what segdc would see UNDER the per-key
            # split (the decompose gate's input when decompose_keys
            # fires)
            parts = []
            sub_segs = []
            for h in histories:
                subs = split_history(spec, h)
                parts.append(len(subs))
                for s in subs.values():
                    sub_max = max(sub_max, len(s))
                    sub_segs.append(len(split_at_quiescent_cuts(s)))
            mean_parts = sum(parts) / len(histories)
            if sub_segs:
                sub_mean_segs = sum(sub_segs) / len(sub_segs)
    return CorpusProfile(
        n=len(histories),
        max_ops=max(lens),
        mean_ops=sum(lens) / len(histories),
        pending_fraction=(sum(h.n_pending > 0 for h in histories)
                          / len(histories)),
        cut_fraction=sum(s > 1 for s in segs) / len(histories),
        mean_segments=sum(segs) / len(histories),
        sub_max_ops=sub_max,
        mean_partitions=mean_parts,
        sub_mean_segments=sub_mean_segs,
    )


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    """What the device loop would otherwise hard-code, plus the two search
    modes, with provenance.  Consumed by ``TorchStepper(plan=...)`` and
    :func:`build_backend`."""

    name: str
    chunk_schedule: Tuple[int, ...]
    batch_buckets: Tuple[int, ...]
    slots_for_batch: Dict[int, int]
    ordering: bool          # host-side selectivity permutation
    decompose: bool         # wrap the kernel in quiescent-cut SegDC
    unroll: Optional[int]   # None on every plan of the port
    # per-key decomposition as the first stage (ops/pcomp.py): on iff the
    # spec's projection validates and the profiled sub-histories land in
    # smaller op buckets than the whole histories
    decompose_keys: bool = False
    mesh_devices: int = 1   # lane-axis mesh width the ladder divides
    why: Tuple[str, ...] = ()

    def describe(self) -> Dict:
        return {
            "name": self.name,
            "chunk_schedule": list(self.chunk_schedule),
            "buckets": len(self.batch_buckets),
            "max_slots": max(self.slots_for_batch.values(), default=0),
            "ordering": self.ordering,
            "decompose": self.decompose,
            "decompose_keys": self.decompose_keys,
            "unroll": self.unroll,
            "mesh_devices": self.mesh_devices,
            "why": list(self.why),
        }


def _plan_decompose_keys(spec, profile: Optional[CorpusProfile]
                         ) -> Tuple[bool, str]:
    """The per-key decomposition gate with its ``why`` line: on iff the
    declared projection validates (a refused one says why here, never a
    silent unsound split) and the profiled sub-histories land in strictly
    smaller op buckets than the whole histories."""
    from ..core.spec import projection_report
    from ..ops.pcomp import bucket_or_none

    problems = projection_report(spec)
    if problems:
        return False, ("decompose_keys=off (refused: "
                       f"{problems[0]})")
    if profile is None or not profile.n or not profile.sub_max_ops:
        return False, ("decompose_keys=off (projection valid but no "
                       "sub-history profile for this corpus)")
    whole = bucket_or_none(profile.max_ops)
    sub = bucket_or_none(profile.sub_max_ops)
    if sub is None:
        return False, (f"decompose_keys=off (sub-histories up to "
                       f"{profile.sub_max_ops} ops fit no op bucket)")
    if whole is not None and sub >= whole:
        return False, (f"decompose_keys=off (sub bucket {sub} >= whole "
                       f"bucket {whole}: the split only adds lanes)")
    return True, (
        f"decompose_keys=on (sub-histories <= {profile.sub_max_ops} ops "
        f"fit bucket {sub} vs whole "
        + (f"bucket {whole}" if whole is not None
           else f"max {profile.max_ops} ops past every bucket")
        + f"; mean {profile.mean_partitions:.1f} keys/history)")


def plan_search(spec, profile: Optional[CorpusProfile] = None,
                platform: Optional[str] = None,
                mesh_devices: int = 1) -> SearchPlan:
    """The search plan for ``spec`` on ``platform`` (``"cuda"``, or
    ``"cpu"`` for the JAX package's CPU plan; None means ``"cuda"``)
    given optional corpus statistics.  Pure policy: builds no backend and
    touches no device.  ``"tpu"`` raises ``ValueError``.
    ``mesh_devices > 1`` sizes the plan for a mesh of that many devices:
    the bucket ladder keeps the widths it divides and the name gains an
    ``@meshN`` suffix; ``mesh_devices=1`` is the identity."""
    platform = "cuda" if platform is None else platform
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"no search plan for platform {platform!r}: the "
                         f"port plans for 'cuda' (its own defaults) and "
                         f"'cpu' (the JAX package's CPU plan)")
    mesh_devices = max(1, int(mesh_devices))
    why = []

    orderable = ordering_table(spec) is not None
    why.append(f"ordering={'on' if orderable else 'off'} "
               f"({spec.name} {'has' if orderable else 'lacks'} a scalar "
               f"selectivity domain)")

    decompose_keys, dk_why = _plan_decompose_keys(spec, profile)

    decompose = False
    if profile is not None and profile.n:
        if decompose_keys and profile.sub_mean_segments:
            # under the per-key split the inner kernel sees sub-histories
            # only: the gate reads their segment density
            decompose = (profile.sub_mean_segments
                         >= _DECOMPOSE_MEAN_SEGMENTS_SUB)
            why.append(
                f"decompose={'on' if decompose else 'off'} "
                f"(mean {profile.sub_mean_segments:.2f} segments/"
                f"sub-history under the per-key split over {profile.n} "
                f"histories; decomposed-corpus gate "
                f"{_DECOMPOSE_MEAN_SEGMENTS_SUB})")
        else:
            decompose = profile.mean_segments >= _DECOMPOSE_MEAN_SEGMENTS
            why.append(f"decompose={'on' if decompose else 'off'} "
                       f"(mean {profile.mean_segments:.2f} segments/history "
                       f"over {profile.n} histories)")
    else:
        why.append("decompose=off (no corpus profile)")
    why.append(dk_why)

    # with per-key decomposition on, the inner kernel sees sub-histories
    # only: sizing the first chunk to the whole corpus would re-coarsen
    # what the split just bought
    eff_max = (profile.sub_max_ops if profile is not None and decompose_keys
               else profile.max_ops if profile is not None else 0)
    from ..ops.scalarize import scalar_shadow
    from ..ops.stepper import BATCH_BUCKETS, CHUNK_SCHEDULE, default_slots

    base = CHUNK_SCHEDULE if platform == "cuda" else _CPU_SCHEDULE
    # a first chunk below the success-path depth decides nothing: scale
    # the whole ladder by the power of two that covers the longest lane
    scale = 1
    while base[0] * scale < eff_max:
        scale *= 2
    sched = tuple(c * scale for c in base)
    if scale > 1:
        why.append(f"first chunk {sched[0]} covers "
                   f"{'sub-history' if decompose_keys else ''} max_ops "
                   f"{eff_max}")
    if platform == "cuda":
        shadow = scalar_shadow(spec)
        state_dim = (shadow if shadow is not None else spec).STATE_DIM
        why.append("cuda platform: the port's own defaults (ops/stepper.py "
                   "CHUNK_SCHEDULE, BATCH_BUCKETS, default_slots at "
                   f"state_dim {state_dim})")
        name, buckets = CUDA_PLAN, tuple(BATCH_BUCKETS)
        slots = {b: default_slots(b, state_dim) for b in BATCH_BUCKETS}
    else:
        why.append("cpu platform: no crash region — full-size memo tables, "
                   "fine buckets to single-lane")
        name, buckets = CPU_PLAN, _CPU_BUCKETS
        slots = {b: _CPU_SLOTS for b in _CPU_BUCKETS}
    if mesh_devices > 1:
        # mesh-shape the plan: divisible buckets, their slot table, the
        # @meshN name (plan identity = ladder identity)
        from ..mesh.dispatch import mesh_bucket_ladder, mesh_slots_table

        kept = mesh_bucket_ladder(buckets, mesh_devices)
        why.append(f"mesh_devices={mesh_devices}: bucket ladder filtered "
                   f"to mesh-divisible widths ({len(buckets)} -> "
                   f"{len(kept)} buckets)")
        name, buckets = f"{name}@mesh{mesh_devices}", kept
        slots = mesh_slots_table(slots, kept)
    return SearchPlan(
        name=name,
        chunk_schedule=sched,
        batch_buckets=tuple(buckets),
        slots_for_batch=dict(slots),
        ordering=orderable,
        decompose=decompose,
        decompose_keys=decompose_keys,
        unroll=None,
        mesh_devices=mesh_devices,
        why=tuple(why),
    )


def build_backend(spec, plan: SearchPlan, budget: int = 2_000,
                  **device_kw):
    """The planned checker: a ``TorchStepper`` honouring ``plan``, wrapped
    in the quiescent-cut combinator (``SegDC``) when the plan decomposes,
    and the whole wrapped in the per-key combinator (``PComp``) when the
    plan splits per key: outermost, because per-key sub-histories are
    sparser and cut more often.  ``device_kw`` goes to ``TorchStepper``
    (``device="cpu"`` runs its plain versions).

    A mesh-sized plan (``plan.mesh_devices > 1``) implies a sharded
    engine: without an explicit ``sharding=``, the lane sharding comes
    from a mesh of exactly that many devices of ``device``'s kind (cards,
    or logical host devices for ``device="cpu"``), so plan and placement
    cannot disagree; too few cards raise ``ValueError``."""
    from ..ops.stepper import TorchStepper

    if plan.mesh_devices > 1 and device_kw.get("sharding") is None:
        from ..mesh.topology import batch_sharding, make_mesh

        device_kw["sharding"] = batch_sharding(make_mesh(
            plan.mesh_devices, device=device_kw.get("device")))
    # the planner seam (devq/): a card plan or a mesh-sized one says the
    # device pays, so the next drain warms this plan on a smoke corpus.
    # One global read without a queue.
    from ..devq.queue import note_device_plan

    note_device_plan(spec, plan)

    def make_core(s):
        if not plan.decompose:
            return TorchStepper(s, budget=budget, plan=plan, **device_kw)
        from ..ops.segdc import SegDC

        return SegDC(s, make_inner=lambda q: TorchStepper(
            q, budget=budget, plan=plan, **device_kw))

    if plan.decompose_keys:
        from ..ops.pcomp import PComp

        return PComp(spec, make_inner=make_core)
    return make_core(spec)


def build_host_backend(spec, plan: SearchPlan):
    """The planned checker's host shape: ``PComp`` outermost over the
    exact host ladder (``resilience.failover.host_fallback``) when the
    plan splits per key, else that ladder wrapped in ``FailoverBackend``.
    It touches no device; its verdicts are the device path's by the
    resolution contract.  The shrinker's default backend
    (``shrink/shrinker.py``)."""
    from ..resilience.failover import FailoverBackend, host_fallback

    if plan.decompose_keys:
        from ..ops.pcomp import PComp

        return PComp(spec, make_inner=host_fallback)
    return FailoverBackend(spec, host_fallback(spec))
