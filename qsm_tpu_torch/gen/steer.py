"""The steering loop: mutation-driven profile search, scored by the check
plane's own feedback.

The counterpart of the JAX package's ``qsm_tpu/gen/steer.py``.  The
signals are counters the framework keeps for other reasons:

* **search nodes per history** (``SearchStats`` deltas around the check
  call, ``search/stats.py``): corpora that make the checker explore sit
  near the boundary of the real-time order's freedom;
* **verdict flips** (VIOLATION verdicts): with model-consistent
  generation (``gen/core.py``'s ``p_adverse``) a violation is the rare,
  interesting event;
* **corpus shape** (``profile_corpus``, ``search/planner.py``):
  histories that refuse to cut deny the checker its decomposition; the
  per-spec selectivity table (``compile_selectivity_table``) seeds the
  initial op mix toward commands whose postconditions prune hardest.

The pool is bounded (``SeedPool``) and the loop state checkpoints through
``atomic_write_json``.  The loop scores verdicts, it never issues them:
every verdict comes from a real backend, and its ``gen_*`` counters are
bookkeeping only.  ``device`` goes to ``generate_batch``: the ``"jax"``
and ``"auto"`` tables run on CUDA unless it is ``"cpu"``, and on CUDA
the loop pins the host block of its first table's copy when it is built
(``reserve_host_table``), so that no round pays for pinning it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Callable, List, Optional

from ..ops.backend import Verdict, resolve_device
from ..ops.draws_kernel import reserve_host_table
from ..resilience.checkpoint import atomic_write_json
from ..search.planner import profile_corpus
from ..search.stats import SearchStats, collect_search_stats, stats_delta
from .core import PATHS, _n_draws, generate_batch
from .profile import GenProfile

# a flip is worth this many search-nodes-per-history in the score: a
# violation is the event the whole plane exists to find, so one flip
# outranks any plausible nodes/history delta on these corpus sizes
_FLIP_WEIGHT = 10_000.0
# refusing-to-cut bonus: (2 - mean_segments) scaled — corpora the
# decomposition gates cannot split keep the search honest
_SHAPE_WEIGHT = 50.0
# kept violating histories: a tail window, not a campaign-length log
# (consumers want the recent flips to replay; an unbounded keep is a
# slow OOM on long soaks)
_FLIP_KEEP = 64


@dataclasses.dataclass
class PoolSeed:
    """One scored profile.  ``seed`` is the draw-table seed the score
    was earned with — keeping it makes every pool entry replayable."""

    profile: GenProfile
    seed: int
    score: float = 0.0
    flips: int = 0
    nodes_per_hist: float = 0.0
    rounds: int = 0  # times this entry was selected as a parent

    def to_dict(self) -> dict:
        return {"profile": self.profile.to_dict(), "seed": self.seed,
                "score": self.score, "flips": self.flips,
                "nodes_per_hist": self.nodes_per_hist,
                "rounds": self.rounds}

    @classmethod
    def from_dict(cls, d: dict) -> "PoolSeed":
        return cls(profile=GenProfile.from_dict(d["profile"]),
                   seed=int(d["seed"]), score=float(d["score"]),
                   flips=int(d["flips"]),
                   nodes_per_hist=float(d["nodes_per_hist"]),
                   rounds=int(d["rounds"]))


class SeedPool:
    """Bounded, score-ordered corpus of profiles.

    Capacity discipline: every ``add`` compares against ``cap`` and
    evicts the worst entry — the pool can never grow past its bound no
    matter how long a campaign runs."""

    def __init__(self, cap: int = 16):
        if cap < 1:
            raise ValueError(f"pool cap must be >= 1, got {cap}")
        self.cap = cap
        self._seeds: List[PoolSeed] = []

    def __len__(self) -> int:
        return len(self._seeds)

    def add(self, entry: PoolSeed) -> None:
        self._seeds.append(entry)
        self._seeds.sort(key=lambda s: -s.score)
        while len(self._seeds) > self.cap:
            self._seeds.pop()  # worst-scored out; the bound holds

    def pick(self, rng: random.Random) -> Optional[PoolSeed]:
        """Rank-weighted parent selection: the best entry is the likely
        parent but the tail keeps breathing (pure greed converges on
        one local shape and stops covering)."""
        if not self._seeds:
            return None
        n = len(self._seeds)
        weights = [n - i for i in range(n)]  # rank-linear
        total = sum(weights)
        u = rng.random() * total
        acc = 0
        for s, w in zip(self._seeds, weights):
            acc += w
            if u < acc:
                return s
        return self._seeds[-1]

    def best(self) -> Optional[PoolSeed]:
        return self._seeds[0] if self._seeds else None

    def to_dict(self) -> dict:
        return {"cap": self.cap,
                "seeds": [s.to_dict() for s in self._seeds]}

    @classmethod
    def from_dict(cls, d: dict) -> "SeedPool":
        pool = cls(cap=int(d.get("cap", 16)))
        for row in d.get("seeds", ()):
            pool.add(PoolSeed.from_dict(row))
        return pool


class SteeringLoop:
    """Mutate → generate → check → score → keep (module docstring).

    ``backend`` is anything with ``check_histories(spec, histories)``
    returning verdict ints — the property plane's oracles, a device
    backend or the hybrid plan (``ops/hybrid.py``).  ``rounds()``
    of work happen one :meth:`round` at a time so callers own pacing,
    checkpoint cadence and budget accounting."""

    def __init__(self, spec, backend, *, profile: Optional[GenProfile]
                 = None, pool_cap: int = 16, batch: int = 32,
                 seed: int = 0, path: str = "auto",
                 on_flip: Optional[Callable] = None, device=None):
        if path not in PATHS:
            raise ValueError(f"path must be one of {PATHS}, got {path!r}")
        self.spec = spec
        self.backend = backend
        self.batch = batch
        self.path = path
        # the device table's device, resolved now: without CUDA the loop
        # raises here rather than in its first round
        self.device = None if path == "py" else resolve_device(device)
        self.on_flip = on_flip
        self.rng = random.Random(f"steer:{spec.name}:{seed}")
        self._next_seed = seed * 1_000_003 + 1
        self.pool = SeedPool(cap=pool_cap)
        self.stats = SearchStats(engine="gen")
        self.flip_histories: List = []  # (history, verdict) of violations
        base = profile if profile is not None else self.seed_profile()
        self.pool.add(PoolSeed(profile=base, seed=seed))
        if self.device is not None:
            reserve_host_table(batch, _n_draws(base.n_ops), self.device)

    # -- initial profile ----------------------------------------------
    def seed_profile(self) -> GenProfile:
        """The selectivity-informed starting point: commands whose
        postconditions accept in FEWER states get more weight — they
        are the mutators/guards whose interleavings carry the near-miss
        structure (a command accepted everywhere constrains nothing).
        Specs without a scalar domain start uniform."""
        mix = ()
        bound = self.spec.scalar_state_bound(32)  # nominal op count
        if self.spec.STATE_DIM == 1 and bound:
            from ..core.spec import compile_selectivity_table

            sel = compile_selectivity_table(self.spec, bound)
            # per-cmd mean acceptance fraction -> weight 1.5 - fraction
            per_cmd = sel.reshape(self.spec.n_cmds, -1).mean(axis=1)
            mix = tuple(float(max(0.1, 1.5 - f)) for f in per_cmd)
        return GenProfile(op_mix=mix)

    # -- one feedback round -------------------------------------------
    def round(self) -> dict:
        """Mutate a parent, generate a batch, check it, score it, and
        keep it iff it earns a pool slot.  Returns the round report."""
        parent = self.pool.pick(self.rng)
        parent.rounds += 1
        profile = parent.profile.mutate(self.rng)
        seed = self._next_seed
        self._next_seed += 1
        hists = generate_batch(self.spec, profile, seed, self.batch,
                               path=self.path, device=self.device)
        before = collect_search_stats(self.backend)
        verdicts = self.backend.check_histories(self.spec, hists)
        delta = stats_delta(collect_search_stats(self.backend), before)
        nodes = float(getattr(delta, "nodes_explored", 0) or 0)
        nodes_per_hist = nodes / max(1, len(hists))
        flips = 0
        for h, v in zip(hists, verdicts):
            if int(v) == int(Verdict.VIOLATION):
                flips += 1
                self.flip_histories.append((h, int(v)))
                if self.on_flip is not None:
                    self.on_flip(self.spec, profile, h)
        if len(self.flip_histories) > _FLIP_KEEP:
            self.flip_histories = self.flip_histories[-_FLIP_KEEP:]
        shape = profile_corpus(hists)
        score = (nodes_per_hist + _FLIP_WEIGHT * flips
                 + _SHAPE_WEIGHT * max(0.0, 2.0 - shape.mean_segments))
        self.pool.add(PoolSeed(profile=profile, seed=seed, score=score,
                               flips=flips,
                               nodes_per_hist=nodes_per_hist))
        self.stats.gen_seqs += len(hists)
        self.stats.gen_mutations += 1
        self.stats.gen_flips += flips
        self.stats.gen_feedback_rounds += 1
        return {"profile": profile.to_dict(), "seed": seed,
                "score": round(score, 2), "flips": flips,
                "nodes_per_hist": round(nodes_per_hist, 2),
                "mean_segments": round(shape.mean_segments, 3),
                "pool": len(self.pool)}

    def run(self, rounds: int) -> List[dict]:
        return [self.round() for _ in range(rounds)]

    # -- stats plumbing (collect_search_stats walks this) -------------
    def search_stats(self) -> SearchStats:
        st = dataclasses.replace(self.stats)
        st.absorb(collect_search_stats(self.backend))
        return st

    # -- checkpointing (resilience/checkpoint.py rails) ---------------
    def save(self, path: str) -> None:
        atomic_write_json(path, {
            "spec": self.spec.name,
            "next_seed": self._next_seed,
            "pool": self.pool.to_dict(),
            "stats": self.stats.to_compact(),
            "gen": {"seqs": self.stats.gen_seqs,
                    "mutations": self.stats.gen_mutations,
                    "flips": self.stats.gen_flips,
                    "rounds": self.stats.gen_feedback_rounds},
        })

    def load(self, path: str) -> bool:
        """Adopt a checkpoint's pool and counters; False if absent.
        The rng re-seeds from the restored round count so a resumed
        campaign diverges from a fresh one only by the banked work."""
        if not os.path.exists(path):
            return False
        with open(path) as f:
            doc = json.load(f)
        if doc.get("spec") != self.spec.name:
            raise ValueError(
                f"checkpoint is for spec {doc.get('spec')!r}, "
                f"not {self.spec.name!r}")
        self.pool = SeedPool.from_dict(doc["pool"])
        self._next_seed = int(doc["next_seed"])
        g = doc.get("gen", {})
        self.stats.gen_seqs = int(g.get("seqs", 0))
        self.stats.gen_mutations = int(g.get("mutations", 0))
        self.stats.gen_flips = int(g.get("flips", 0))
        self.stats.gen_feedback_rounds = int(g.get("rounds", 0))
        self.rng = random.Random(
            f"steer:{self.spec.name}:resume:{self.stats.gen_feedback_rounds}")
        return True
