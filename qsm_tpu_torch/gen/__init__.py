"""The coverage-guided workload generation plane.

The counterpart of the JAX package's ``qsm_tpu/gen``; everything upstream
answers "is this history linearizable?", this package manufactures the
histories worth asking about:

* :mod:`.core`: a seeded raw-draw table (a pure-Python stream, or the
  threefry table of ``csrc/threefry_draws.cu`` on the card) assembled on
  the host into well-formed concurrent histories under a
  :class:`.GenProfile`;
* :mod:`.steer`: the feedback loop, a bounded seed pool of profiles
  mutated and scored by what the check plane already measures (search
  nodes per history, verdict flips, corpus shape), with
  ``atomic_write_json`` checkpoints.

* :mod:`.fleet`: the closed loop, ``fuzz --addr``: steered corpora sent
  to a live server as check requests and monitor sessions, every answer
  re-proved by a fresh host oracle;
* :mod:`.soak`: the chaos soak, ``soak``: durable monitor sessions held
  open through a spawned fleet's rolling restarts, a router takeover and
  a node leave/join, every verdict re-proved by a fresh memo oracle.

Generation steers, it never
judges: no counter or score here contributes to a verdict.
"""

from .core import generate_batch, generate_history
from .profile import GenProfile
from .steer import SeedPool, SteeringLoop

__all__ = ["GenProfile", "SeedPool", "SteeringLoop", "generate_batch",
           "generate_history"]
