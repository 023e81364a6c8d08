"""``SearchStats``: search cost as one record type.

The counterpart of the JAX package's ``qsm_tpu/search/stats.py``, with
every field of it, including those whose engines are not ported yet
(shrink, obs, sessions, resilience), so that ``to_compact()`` has the
same key set in both packages.  Every checker engine keeps counters (the
oracle's ``nodes_explored``, the device driver's ``lockstep_cost`` /
``compactions`` / ``rescued``, the per-key split's tallies); this module
gives them one record type and one collection entry point, so the
property layer and the steering loop read the same fields.

The two headline fields:

* ``lockstep_iters``: the sum over device chunk calls of (trips x padded
  batch width), what every lane pays under lockstep, not what it needed.
  Host engines report 0.
* ``nodes_explored``: host search nodes.  Device engines report 0 here; a
  hybrid composition reports both side by side (device iterations saved
  by moving work to the host are only savings when the host nodes are
  shown too).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class SearchStats:
    """Cumulative search-cost counters of one engine (or composition)."""

    engine: str = ""
    histories: int = 0          # histories this engine decided work for
    lockstep_iters: int = 0     # device lockstep cost (trips × width)
    nodes_explored: int = 0     # host search nodes (oracle + middles)
    memo_prunes: int = 0        # memo hits: subtrees skipped
    memo_inserts: int = 0       # configurations proven non-linearizable
    compactions: int = 0        # batch-shrink / cache-growth events
    chunk_rounds: int = 0       # device chunk calls
    rescued: int = 0            # lanes decided past the base budget
    deferred: int = 0           # histories deferred to the oracle
    tail_histories: int = 0     # hybrid: lanes the host tail decided
    segments_split: int = 0     # segdc: histories that actually cut
    segments_total: int = 0     # segdc: segments across them
    # P-compositionality (ops/pcomp.py): the per-key decomposition's own
    # cost/shape record — how many histories split, into how many per-key
    # sub-histories, how long the worst sub-history stayed (the number
    # that decides whether the split bought smaller compile buckets), and
    # what recombining verdicts + stitching witnesses cost host-side
    pcomp_split: int = 0        # histories decomposed per key
    pcomp_subs: int = 0         # per-key sub-histories produced
    pcomp_max_sub: int = 0      # longest sub-history (ops) — max-merged
    pcomp_recombine_ms: int = 0  # verdict recombine + witness stitch
    # Shrink plane (qsm_tpu/shrink): frontier-at-once counterexample
    # minimization — how many greedy rounds ran, how many candidate
    # lanes the frontier dispatches carried, how many candidates the
    # fingerprint memo answered without re-checking, and how small the
    # minimized history ended up relative to the input (percent of the
    # initial op count; min-merged — the record's best shrink).  A
    # shrink run's cost record must say it shrank, and to what.
    shrink_rounds: int = 0      # greedy frontier rounds
    shrink_lanes: int = 0       # candidate lanes dispatched
    shrink_memo_hits: int = 0   # candidates answered from the memo
    shrink_ratio_pct: int = 0   # 100 * final_ops / initial_ops (0 = none)
    ordering: bool = False      # postcondition-aware ordering active
    plan: str = ""              # planner provenance ("" = hand-tuned)
    # resilience plane (qsm_tpu/resilience): device-loss accounting —
    # cost records from a degraded run must SAY they degraded, or a
    # host-fallback rate silently masquerades as a device rate
    degradations: int = 0       # device-loss events absorbed
    retries: int = 0            # extra dispatch attempts before degrading
    fallback_engine: str = ""   # host engine degraded onto ("" = none)
    worker_faults: int = 0      # pool workers shed (crash/wedge/kill)
    # while deciding these lanes — serve/pool.py stamps it so a batch
    # that survived a worker loss says so in its own cost record
    node_faults: int = 0        # fleet nodes lost (death/wedge/partition)
    # while deciding these lanes — fleet/router.py stamps it so a batch
    # that survived a node loss (re-dispatched to a surviving node or
    # the router's own ladder) says so in its own cost record
    lease_faults: int = 0       # lease-store beats lost (fault/transport)
    # while this work ran — the HA plane's cost record: a soak that
    # rode out lease-store partitions must say how many beats the
    # arbitration lost (fleet/lease.py `lease` fault site)
    # span<->stats bridge (qsm_tpu/obs): trace events emitted while
    # deciding these lanes.  The serve dispatch path stamps it into the
    # batch's compact record and the batch's `serve.dispatch` span
    # event carries the compact record back — observability cost is
    # accounted like any other search cost, in both directions.
    obs_events: int = 0
    # Monitor plane (qsm_tpu/monitor): the streaming-session cost/shape
    # record — events streamed through sessions, quiescent cuts the
    # frontiers committed, cuts resumed from the prefix bank with ZERO
    # engine work, and verdict flips pushed to clients.  A monitoring
    # run's record must say how much of its deciding was incremental.
    session_events: int = 0      # events applied to live sessions
    frontier_advances: int = 0   # quiescent cuts committed
    flips_pushed: int = 0        # violation flips handed to clients
    prefix_hits: int = 0         # cuts resumed from the decided-prefix bank
    # Generation plane (qsm_tpu/gen): the workload-fuzzer's cost/shape
    # record — command sequences generated, profile/seed mutations the
    # steering loop applied, verdict flips (violations) its corpora
    # induced, and feedback rounds scored.  A fuzz campaign's record
    # must say how much adversarial workload it manufactured — and the
    # oracle's own counters above stay untouched: generation never
    # contributes to a verdict (docs/GENERATION.md soundness note).
    gen_seqs: int = 0            # command sequences (histories) generated
    gen_mutations: int = 0       # profile/seed mutations applied
    gen_flips: int = 0           # violations induced by generated corpora
    gen_feedback_rounds: int = 0  # steering rounds scored

    # -- derived -----------------------------------------------------------
    @property
    def iters_per_history(self) -> float:
        return self.lockstep_iters / self.histories if self.histories else 0.0

    @property
    def nodes_per_history(self) -> float:
        return self.nodes_explored / self.histories if self.histories else 0.0

    # -- composition -------------------------------------------------------
    def absorb(self, other: Optional["SearchStats"],
               count_histories: bool = False) -> "SearchStats":
        """Fold a sub-engine's counters into this record (hybrid tails,
        segdc inners).  ``count_histories`` is off by default: a wrapper
        usually counts each input history once itself, and the inner's
        per-lane count (expansions, frontier states) would double-book."""
        if other is None:
            return self
        for f in ("lockstep_iters", "nodes_explored", "memo_prunes",
                  "memo_inserts", "compactions", "chunk_rounds", "rescued",
                  "deferred", "tail_histories", "segments_split",
                  "segments_total", "degradations", "retries",
                  "worker_faults", "node_faults", "lease_faults",
                  "pcomp_split",
                  "pcomp_subs", "pcomp_recombine_ms", "shrink_rounds",
                  "shrink_lanes", "shrink_memo_hits", "obs_events",
                  "session_events", "frontier_advances", "flips_pushed",
                  "prefix_hits", "gen_seqs", "gen_mutations", "gen_flips",
                  "gen_feedback_rounds"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        # a maximum, not a tally: the composed record's worst sub-history
        # is the worst either side saw
        self.pcomp_max_sub = max(self.pcomp_max_sub, other.pcomp_max_sub)
        # a ratio, not a tally: the composed record keeps the BEST
        # (smallest) shrink either side achieved; 0 means "never shrank"
        if other.shrink_ratio_pct:
            self.shrink_ratio_pct = (
                other.shrink_ratio_pct if not self.shrink_ratio_pct
                else min(self.shrink_ratio_pct, other.shrink_ratio_pct))
        if count_histories:
            self.histories += other.histories
        self.ordering = self.ordering or other.ordering
        if not self.plan:
            self.plan = other.plan
        if not self.fallback_engine:
            self.fallback_engine = other.fallback_engine
        return self

    # -- rendering ---------------------------------------------------------
    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["iters_per_history"] = round(self.iters_per_history, 1)
        d["nodes_per_history"] = round(self.nodes_per_history, 1)
        return d

    def to_compact(self) -> Dict:
        """The small form bench lines embed (MAX_LINE discipline): the
        two per-history headline numbers plus the counters that explain
        them; everything else stays in the full ``stats`` CLI output."""
        return {
            "iph": round(self.iters_per_history, 1),
            "nph": round(self.nodes_per_history, 1),
            "prunes": self.memo_prunes,
            "rescued": self.rescued,
            "segs": self.segments_split,
            "ord": int(self.ordering),
            "plan": self.plan,
            # resilience counters ride every compact record so bench
            # rows are self-describing about fault handling (a degraded
            # rate must never read as a clean device rate)
            "deg": self.degradations,
            "fb": self.fallback_engine,
            "wf": self.worker_faults,
            "ndf": self.node_faults,
            "lsf": self.lease_faults,
            # P-compositionality counters ride every compact record too:
            # a bench row from a decomposed run must say it decomposed
            # (and into what) or its rate reads as a whole-history rate
            "pcs": self.pcomp_split,
            "pcn": self.pcomp_subs,
            "pcm": self.pcomp_max_sub,
            # shrink counters ride every compact record the same way: a
            # bench row produced during minimization must say how many
            # rounds/lanes the shrink plane spent and what it bought
            "shr": self.shrink_rounds,
            "shl": self.shrink_lanes,
            "shm": self.shrink_memo_hits,
            "sho": self.shrink_ratio_pct,
            # span<->stats bridge: trace events this record's work
            # emitted (qsm_tpu/obs) — a traced batch's cost record
            # says what the tracing itself cost
            "obe": self.obs_events,
            # monitor-session counters (qsm_tpu/monitor): a monitoring
            # bench row must say how many events streamed, how many
            # cuts committed, how many resumed from the bank for free,
            # and how many flips the run pushed
            "sev": self.session_events,
            "fad": self.frontier_advances,
            "flp": self.flips_pushed,
            "pfh": self.prefix_hits,
            # generation-plane counters (qsm_tpu/gen): a bench row from
            # a fuzz campaign must say how many sequences it generated,
            # how many mutations steering applied, how many verdict
            # flips the corpora induced, and how many feedback rounds
            # were scored
            "gsq": self.gen_seqs,
            "gmu": self.gen_mutations,
            "gfl": self.gen_flips,
            "gfr": self.gen_feedback_rounds,
        }

    def to_timings(self) -> Dict[str, float]:
        """Numeric projection for ``PropertyResult.timings`` (a flat
        str → float mapping by contract).  Resilience counters appear
        only when nonzero: the property layer keeps its OWN
        ``resilience_*`` entries for degradations it performed itself
        (core/property.py), and the two sources merge additively there —
        emitting zeros here would clobber that accounting."""
        out = {
            "search_iters_per_history": round(self.iters_per_history, 1),
            "search_nodes_per_history": round(self.nodes_per_history, 1),
            "search_memo_prunes": float(self.memo_prunes),
            "search_rescued": float(self.rescued),
            "search_histories": float(self.histories),
        }
        if self.degradations:
            out["resilience_degradations"] = float(self.degradations)
        if self.retries:
            out["resilience_retries"] = float(self.retries)
        if self.worker_faults:
            out["resilience_worker_faults"] = float(self.worker_faults)
        if self.node_faults:
            out["resilience_node_faults"] = float(self.node_faults)
        if self.lease_faults:
            out["resilience_lease_faults"] = float(self.lease_faults)
        # pcomp accounting only when decomposition actually happened —
        # zeros would claim "pcomp ran, split nothing" on every
        # whole-history run
        if self.pcomp_subs:
            out["pcomp_split"] = float(self.pcomp_split)
            out["pcomp_subs"] = float(self.pcomp_subs)
            out["pcomp_max_sub"] = float(self.pcomp_max_sub)
            out["pcomp_recombine_ms"] = float(self.pcomp_recombine_ms)
        # shrink accounting only when minimization actually ran — zeros
        # would claim "shrank to nothing" on every plain check run
        if self.shrink_rounds:
            out["shrink_rounds"] = float(self.shrink_rounds)
            out["shrink_lanes"] = float(self.shrink_lanes)
            out["shrink_memo_hits"] = float(self.shrink_memo_hits)
            out["shrink_ratio"] = round(self.shrink_ratio_pct / 100.0, 3)
        # span-bridge accounting only when tracing actually emitted —
        # zeros would claim "traced, emitted nothing" on every
        # tracing-off run
        if self.obs_events:
            out["obs_events"] = float(self.obs_events)
        # session accounting only when events actually streamed — zeros
        # would claim "monitored, saw nothing" on every batch-check run
        if self.session_events:
            out["session_events"] = float(self.session_events)
            out["frontier_advances"] = float(self.frontier_advances)
            out["flips_pushed"] = float(self.flips_pushed)
            out["prefix_hits"] = float(self.prefix_hits)
        # generation accounting only when the fuzzer actually generated
        # — zeros would claim "fuzzed, produced nothing" on every plain
        # check run
        if self.gen_seqs:
            out["gen_seqs"] = float(self.gen_seqs)
            out["gen_mutations"] = float(self.gen_mutations)
            out["gen_flips"] = float(self.gen_flips)
            out["gen_feedback_rounds"] = float(self.gen_feedback_rounds)
        return out


_COUNTER_FIELDS = ("histories", "lockstep_iters", "nodes_explored",
                   "memo_prunes", "memo_inserts", "compactions",
                   "chunk_rounds", "rescued", "deferred", "tail_histories",
                   "segments_split", "segments_total", "degradations",
                   "retries", "worker_faults", "node_faults",
                   "lease_faults",
                   "pcomp_split", "pcomp_subs", "pcomp_recombine_ms",
                   "shrink_rounds", "shrink_lanes", "shrink_memo_hits",
                   "obs_events", "session_events", "frontier_advances",
                   "flips_pushed", "prefix_hits", "gen_seqs",
                   "gen_mutations", "gen_flips", "gen_feedback_rounds")
# pcomp_max_sub and shrink_ratio_pct are deliberately NOT delta fields:
# a maximum/ratio has no meaningful "per-run difference", so stats_delta
# keeps `after`'s value.


def stats_delta(after: Optional[SearchStats],
                before: Optional[SearchStats]) -> Optional[SearchStats]:
    """``after - before`` over the counter fields: the cost of ONE run on
    an engine whose instance counters are lifetime-cumulative.  The
    property layer uses this so ``PropertyResult.timings`` stays per-run
    like every other entry in that dict, even when the caller reuses a
    backend object across property runs."""
    if after is None:
        return None
    if before is None:
        return after
    d = dataclasses.replace(after)
    for f in _COUNTER_FIELDS:
        setattr(d, f, getattr(after, f) - getattr(before, f))
    return d


def collect_search_stats(backend) -> Optional[SearchStats]:
    """``SearchStats`` for any backend, or None when it exposes none.

    Engines own their accounting (``search_stats()``); this helper only
    adds the generic fallback so callers (property layer, bench, CLI)
    never need per-engine knowledge.  Unknown combinators are probed for
    the conventional wrapper attributes (``inner`` / ``device`` /
    ``plain``) so e.g. the per-history router still reports its kernels'
    counters.
    """
    fn = getattr(backend, "search_stats", None)
    if callable(fn):
        return fn()
    for attr in ("inner", "device", "plain"):
        sub = getattr(backend, attr, None)
        if sub is not None and callable(getattr(sub, "search_stats", None)):
            st = sub.search_stats()
            st.engine = f"{type(backend).__name__.lower()}({st.engine})"
            return st
    return None
