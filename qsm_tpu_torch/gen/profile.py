"""``GenProfile``: the generation plane's workload grammar.

The counterpart of the JAX package's ``qsm_tpu/gen/profile.py``,
unchanged.  A profile is the complete description of a workload shape:
with a seed and a table path it reproduces a corpus bit for bit.  The
steering loop (``gen/steer.py``) mutates profiles, never histories,
because a profile checkpoints as a few JSON scalars.

The knobs map onto what the check plane is sensitive to:

* ``op_mix``: per-command weights (mutators against readers);
* ``key_skew``: argument bias toward low values (0 = uniform);
* ``overlap``: probability an idle pid invokes while others are
  outstanding (0 is a sequential history);
* ``p_pending``: crash/drop rate (ops that never respond);
* ``p_adverse``: the near-miss dial: completions respond
  model-consistently (the corpus is linearizable by construction) except
  with this probability, where the response is drawn uniformly;
* ``n_pids`` / ``n_ops``: the batch geometry.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# mutation bounds: a mutated profile must stay inside the domain every
# consumer accepts (bucket_for caps n_ops; the scheduler plane's pid
# range; probabilities in [0, 1])
_MAX_PIDS = 16
_MAX_OPS = 128
_MAX_SKEW = 4.0


@dataclasses.dataclass(frozen=True)
class GenProfile:
    """One workload shape (module docstring).  Frozen: the steering
    loop's mutate() returns a NEW profile, so seed-pool entries never
    alias — a scored profile is exactly the one that earned the score."""

    op_mix: Tuple[float, ...] = ()   # per-cmd weights; () = uniform
    key_skew: float = 0.0            # arg bias toward 0 (0 = uniform)
    n_pids: int = 4
    n_ops: int = 24
    overlap: float = 0.5             # invoke-vs-complete tick bias
    p_pending: float = 0.0           # ops that never respond
    p_adverse: float = 0.01          # off-model response rate

    def to_dict(self) -> dict:
        return {"op_mix": list(self.op_mix), "key_skew": self.key_skew,
                "n_pids": self.n_pids, "n_ops": self.n_ops,
                "overlap": self.overlap, "p_pending": self.p_pending,
                "p_adverse": self.p_adverse}

    @classmethod
    def from_dict(cls, d: dict) -> "GenProfile":
        return cls(op_mix=tuple(float(w) for w in d.get("op_mix", ())),
                   key_skew=float(d.get("key_skew", 0.0)),
                   n_pids=int(d.get("n_pids", 4)),
                   n_ops=int(d.get("n_ops", 24)),
                   overlap=float(d.get("overlap", 0.5)),
                   p_pending=float(d.get("p_pending", 0.0)),
                   p_adverse=float(d.get("p_adverse", 0.01)))

    def weights(self, n_cmds: int) -> Tuple[float, ...]:
        """The op mix normalized against a spec's alphabet: padded/cut
        to ``n_cmds`` and floored at a small epsilon so no command is
        ever starved to exactly zero (a mix that can never emit a
        mutator generates corpora no mutation can rescue)."""
        mix = list(self.op_mix[:n_cmds])
        mix += [1.0] * (n_cmds - len(mix))
        mix = [max(0.05, float(w)) for w in mix]
        total = sum(mix)
        return tuple(w / total for w in mix)

    def mutate(self, rng) -> "GenProfile":
        """One seeded perturbation — exactly one knob moves per call, so
        a score delta is attributable to it (the steering loop's credit
        assignment stays legible).  ``rng`` is a ``random.Random``."""
        knob = rng.randrange(6)
        if knob == 0:   # re-weight one command
            mix = list(self.op_mix) or [1.0]
            i = rng.randrange(len(mix) + 1)
            if i == len(mix):
                mix.append(1.0)  # widen the mix to cover one more cmd
            else:
                mix[i] = max(0.05, mix[i] * rng.choice((0.5, 2.0)))
            return dataclasses.replace(self, op_mix=tuple(mix))
        if knob == 1:   # key skew
            skew = min(_MAX_SKEW, max(
                0.0, self.key_skew + rng.choice((-0.5, 0.5))))
            return dataclasses.replace(self, key_skew=skew)
        if knob == 2:   # overlap density
            ov = min(0.95, max(0.05,
                               self.overlap + rng.choice((-0.15, 0.15))))
            return dataclasses.replace(self, overlap=ov)
        if knob == 3:   # pending rate
            pp = min(0.3, max(0.0,
                              self.p_pending + rng.choice((-0.05, 0.05))))
            return dataclasses.replace(self, p_pending=pp)
        if knob == 4:   # near-miss rate
            pa = min(0.5, max(0.0,
                              self.p_adverse + rng.choice((-0.05, 0.05))))
            return dataclasses.replace(self, p_adverse=pa)
        # geometry: nudge pids or ops (ops by a bucket-friendly step)
        if rng.random() < 0.5:
            pids = min(_MAX_PIDS, max(2, self.n_pids
                                      + rng.choice((-1, 1))))
            return dataclasses.replace(self, n_pids=pids)
        ops = min(_MAX_OPS, max(4, self.n_ops + rng.choice((-8, 8))))
        return dataclasses.replace(self, n_ops=ops)
