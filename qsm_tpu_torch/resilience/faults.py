"""The fault plane: faults injected at named sites, from the environment.

The counterpart of the JAX package's ``qsm_tpu/resilience/faults.py``,
with the same environment variables and the same grammar, so that a
fault string means the same in both packages (each package parses its
own plane and keeps its own hit counts)::

    QSM_TPU_FAULTS="hang:dispatch:0.3,raise:seize,wedge:probe"
    QSM_TPU_FAULTS="raise:dispatch@2"        # fire on the 2nd hit and on

    rule    := action ":" site [":" probability] ["@" nth]
    action  := "hang"      sleep QSM_TPU_FAULT_HANG_S (default 3600 s),
                           then raise
             | "raise"     raise InjectedFault at the site
             | "wedge"     returned to the site (its own unavailability)
             | "kill"      SIGKILL the current process at the site
             | "partition" returned to the site (its link is down)
    nth     := fire on the nth hit of the site and on every later one

Probability draws come from one ``random.Random`` seeded by
``QSM_TPU_FAULTS_SEED`` (default 0), so a schedule replays.  This plane
perturbs the checker's own machinery (device dispatch) and never changes
a verdict, only where it is computed; the scheduler's ``FaultPlan``
perturbs the system under test.

Sites in this package: ``dispatch``, at the top of every device entry
point (``ops/host_contracts.py::DeviceChecker.check_histories`` and
``check_witness``, so ``TorchStepper`` and ``TorchGPU``), as the JAX
package's ``JaxTPU`` has it.  A fired rule is counted in
:func:`fired_snapshot` and reported as a ``fault.hit`` event through the
observability plane's global sink (``obs/__init__.py::emit_global``), a
flight-recorder dump trigger.

Beside the reference's per-site counts, the plane counts what each site
did (:func:`acted`): the failover wrapper on a CUDA device degrades on a
watchdog timeout only when a ``hang`` rule of ``dispatch`` fired during
that dispatch (``resilience/failover.py``).
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import List, Optional

ENV_VAR = "QSM_TPU_FAULTS"
SEED_VAR = "QSM_TPU_FAULTS_SEED"
HANG_VAR = "QSM_TPU_FAULT_HANG_S"

ACTIONS = ("hang", "raise", "wedge", "kill", "partition")


class InjectedFault(RuntimeError):
    """A failure the fault plane injected (never raised unless
    ``QSM_TPU_FAULTS`` is set)."""

    def __init__(self, site: str, action: str):
        super().__init__(f"injected {action} at fault site {site!r} "
                         f"({ENV_VAR}={os.environ.get(ENV_VAR, '')!r})")
        self.site = site
        self.action = action


@dataclasses.dataclass(frozen=True)
class FaultRule:
    action: str
    site: str
    p: float = 1.0
    nth: Optional[int] = None  # fire on the nth hit and every later one


class FaultPlane:
    """Parsed rules, and per site the hits, the fired rules and (per
    action) what fired."""

    def __init__(self, rules: List[FaultRule], seed: str = "0",
                 spec_str: str = ""):
        self.rules = rules
        self.spec_str = spec_str
        self.seed_str = seed
        self.rng = random.Random(f"qsm_tpu_faults:{seed}")
        self.hits: dict = {}
        self.fired: dict = {}
        self.acted: dict = {}   # (site, action) -> times fired

    @classmethod
    def parse(cls, spec_str: str, seed: str = "0") -> "FaultPlane":
        rules: List[FaultRule] = []
        for part in spec_str.split(","):
            part = part.strip()
            if not part:
                continue
            nth = None
            if "@" in part:
                part, n = part.rsplit("@", 1)
                if not n.isdigit() or int(n) < 1:
                    raise ValueError(
                        f"bad fault rule {part!r}@{n!r}: @nth wants a "
                        "positive integer")
                nth = int(n)
            fields = part.split(":")
            if len(fields) not in (2, 3):
                raise ValueError(
                    f"bad fault rule {part!r}: want action:site[:p][@n]")
            action, site = fields[0], fields[1]
            if action not in ACTIONS:
                raise ValueError(f"bad fault action {action!r}: "
                                 f"one of {ACTIONS}")
            if not site:
                raise ValueError(f"bad fault rule {part!r}: empty site")
            p = float(fields[2]) if len(fields) == 3 else 1.0
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"bad fault probability {p!r} "
                                 f"in {part!r}")
            rules.append(FaultRule(action, site, p, nth))
        return cls(rules, seed=seed, spec_str=spec_str)

    def action_for(self, site: str) -> Optional[str]:
        """The action at this hit of ``site`` (None: none).  Counts the
        hit either way; the first matching rule wins."""
        n = self.hits[site] = self.hits.get(site, 0) + 1
        for r in self.rules:
            if r.site != site:
                continue
            if r.nth is not None and n < r.nth:
                continue
            if r.p < 1.0 and self.rng.random() >= r.p:
                continue
            self.fired[site] = self.fired.get(site, 0) + 1
            key = (site, r.action)
            self.acted[key] = self.acted.get(key, 0) + 1
            return r.action
        return None


_plane: Optional[FaultPlane] = None


def active_plane() -> FaultPlane:
    """The process-wide plane, parsed again whenever the environment
    changes (tests switch ``QSM_TPU_FAULTS`` between cases)."""
    global _plane
    spec = os.environ.get(ENV_VAR, "")
    seed = os.environ.get(SEED_VAR, "0")
    if (_plane is None or _plane.spec_str != spec
            or _plane.seed_str != seed):
        _plane = FaultPlane.parse(spec, seed=seed)
    return _plane


def inject(site: str) -> Optional[str]:
    """The fault hook; one environment read when the plane is off.  With
    a matching rule: ``raise`` raises :class:`InjectedFault`; ``hang``
    sleeps ``QSM_TPU_FAULT_HANG_S`` (default 3600 s, so that any watchdog
    fires first), then raises; ``kill`` SIGKILLs the current process;
    ``wedge`` and ``partition`` are returned for the site to apply."""
    if not os.environ.get(ENV_VAR):
        return None
    act = active_plane().action_for(site)
    if act is not None:
        # before acting: a hang or kill would otherwise erase the
        # evidence; a no-op without a global sink
        from ..obs import emit_global

        emit_global("fault.hit", site=site, action=act)
    if act == "raise":
        raise InjectedFault(site, act)
    if act == "hang":
        time.sleep(float(os.environ.get(HANG_VAR, "3600")))
        raise InjectedFault(site, act)
    if act == "kill":
        import signal

        os.kill(os.getpid(), signal.SIGKILL)
    return act


def fired_snapshot() -> dict:
    """Fired rules by site in this process' plane (``{}`` when the plane
    is off)."""
    if not os.environ.get(ENV_VAR):
        return {}
    return dict(active_plane().fired)


def acted(site: str, action: str) -> int:
    """How often ``action`` fired at ``site`` in this process' plane (0
    when the plane is off)."""
    if not os.environ.get(ENV_VAR):
        return 0
    return active_plane().acted.get((site, action), 0)
