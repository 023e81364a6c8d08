"""Model registry: names → (spec factory, SUT implementations).  The CLI
refers to specs and SUTs by name, so a run is reproduced from (model,
impl, seed, config)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from .cas import AtomicCasSUT, CasSpec, RacyCasSUT
from .counter import AtomicTicketSUT, RacyTicketSUT, TicketSpec
from .failover import AsyncReplFailoverSUT, SyncReplFailoverSUT
from .kv import AtomicKvSUT, KvSpec, StaleCacheKvSUT
from .lock import (AtomicSemaphoreSUT, RacyCheckThenActSemaphoreSUT,
                   SemaphoreSpec)
from .multi import (AtomicMultiCasSUT, AtomicMultiRegisterSUT,
                    MultiCasSpec, MultiRegisterSpec, RacyMultiCasSUT,
                    ShardedStaleMultiRegisterSUT)
from .queue import AtomicQueueSUT, QueueSpec, RacyTwoPhaseQueueSUT
from .rangeset import AtomicRangeSetSUT, RangeSetSpec, ScanningRangeSetSUT
from .register import (AtomicRegisterSUT, RacyCachedRegisterSUT,
                       RegisterSpec, ReplicatedRegisterSUT)
from .set import AtomicSetSUT, RacyCheckThenActSetSUT, SetSpec
from .stack import AtomicStackSUT, RacyTwoPhaseStackSUT, StackSpec
from .txn import AtomicTxnSUT, TornCopyTxnSUT, TxnRegisterSpec


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
    "ticket": ModelEntry(
        make_spec=TicketSpec,
        impls={"atomic": _no_spec(AtomicTicketSUT),
               "racy": _no_spec(RacyTicketSUT)},
        default_pids=4, default_ops=24),
    "cas": ModelEntry(
        make_spec=CasSpec,
        impls={"atomic": AtomicCasSUT, "racy": RacyCasSUT},
        default_pids=8, default_ops=32),
    "queue": ModelEntry(
        make_spec=QueueSpec,
        impls={"atomic": AtomicQueueSUT, "racy": RacyTwoPhaseQueueSUT},
        default_pids=8, default_ops=48),
    "kv": ModelEntry(
        make_spec=KvSpec,
        impls={"atomic": AtomicKvSUT, "racy": StaleCacheKvSUT},
        default_pids=16, default_ops=64),
    "multireg": ModelEntry(
        make_spec=MultiRegisterSpec,
        impls={"atomic": AtomicMultiRegisterSUT,
               "racy": ShardedStaleMultiRegisterSUT},
        default_pids=16, default_ops=64),
    "multicas": ModelEntry(
        make_spec=MultiCasSpec,
        impls={"atomic": AtomicMultiCasSUT, "racy": RacyMultiCasSUT},
        default_pids=16, default_ops=64),
    "set": ModelEntry(
        make_spec=SetSpec,
        impls={"atomic": AtomicSetSUT, "racy": RacyCheckThenActSetSUT},
        default_pids=4, default_ops=24),
    "stack": ModelEntry(
        make_spec=StackSpec,
        impls={"atomic": AtomicStackSUT, "racy": RacyTwoPhaseStackSUT},
        default_pids=8, default_ops=32),
    "rangeset": ModelEntry(
        make_spec=RangeSetSpec,
        impls={"atomic": AtomicRangeSetSUT, "racy": ScanningRangeSetSUT},
        default_pids=4, default_ops=24),
    "semaphore": ModelEntry(
        make_spec=SemaphoreSpec,
        impls={"atomic": AtomicSemaphoreSUT,
               "racy": RacyCheckThenActSemaphoreSUT},
        default_pids=4, default_ops=24),
    "txn": ModelEntry(
        make_spec=TxnRegisterSpec,
        impls={"atomic": AtomicTxnSUT, "racy": TornCopyTxnSUT},
        default_pids=8, default_ops=32),
    # failover register: atomic = synchronous replication, racy = async
    # (the lost-acked-write bug); they differ only under a crash schedule
    # (``FaultPlan(crash_at={"primary": k})``), without one both behave
    # like a plain register
    "failover": ModelEntry(
        make_spec=RegisterSpec,
        impls={"atomic": SyncReplFailoverSUT,
               "racy": AsyncReplFailoverSUT},
        default_pids=3, default_ops=10),
}


def make(model: str, impl: str, spec_kwargs: dict = None):
    """(spec, sut) for a registry entry; ``spec_kwargs`` builds a spec
    other than the entry's default."""
    entry = MODELS[model]
    spec = entry.make_spec(**(spec_kwargs or {}))
    return spec, entry.impls[impl](spec)


class SutFactory:
    """Picklable zero-argument SUT constructor for the worker pools
    (``sched/pool.py``): spawned workers rebuild the SUT from registry
    names, where a lambda or a closure would not pickle."""

    def __init__(self, model: str, impl: str, spec_kwargs: dict = None):
        self.model = model
        self.impl = impl
        self.spec_kwargs = spec_kwargs

    def __call__(self):
        return make(self.model, self.impl, self.spec_kwargs)[1]
