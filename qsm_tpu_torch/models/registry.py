"""Model registry: names → (spec factory, SUT implementations).  The CLI
refers to specs and SUTs by name, so a run is reproduced from (model,
impl, seed, config)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from .cas import AtomicCasSUT, CasSpec, RacyCasSUT
from .queue import AtomicQueueSUT, QueueSpec, RacyTwoPhaseQueueSUT
from .register import (AtomicRegisterSUT, RacyCachedRegisterSUT,
                       RegisterSpec, ReplicatedRegisterSUT)


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    make_spec: Callable[[], object]
    impls: Dict[str, Callable]  # impl name -> SUT factory (takes spec)
    default_pids: int
    default_ops: int


def _no_spec(cls):
    return lambda spec: cls()


MODELS: Dict[str, ModelEntry] = {
    "register": ModelEntry(
        make_spec=RegisterSpec,
        impls={"atomic": _no_spec(AtomicRegisterSUT),
               "racy": _no_spec(RacyCachedRegisterSUT),
               "replicated": _no_spec(ReplicatedRegisterSUT)},
        default_pids=2, default_ops=12),
    "cas": ModelEntry(
        make_spec=CasSpec,
        impls={"atomic": AtomicCasSUT, "racy": RacyCasSUT},
        default_pids=8, default_ops=32),
    "queue": ModelEntry(
        make_spec=QueueSpec,
        impls={"atomic": AtomicQueueSUT, "racy": RacyTwoPhaseQueueSUT},
        default_pids=8, default_ops=48),
}


def make(model: str, impl: str):
    """(spec, sut) for a registry entry."""
    entry = MODELS[model]
    spec = entry.make_spec()
    return spec, entry.impls[impl](spec)
