"""qsm_tpu_torch — state-machine property testing and linearizability
checking on PyTorch and CUDA.

The device search runs in hand-written CUDA kernels: ``csrc/dfs_chunk.cu``
driven by :class:`TorchGPU` (scalar specs, up to 32 ops), and
``csrc/stepper_chunk.cu`` with ``csrc/compact_carry.cu`` driven by the
chunked, lane-compacting :class:`TorchStepper` (scalar and scalarizable
vector specs such as the FIFO queue, up to 128 ops), and
``csrc/stepper_sweep.cu`` for its sweep regime (vector specs too large
for a table, such as a KV map of 16 keys).  Every entry point
runs on CUDA unless the caller passes ``device="cpu"``, which runs the
kernels' plain PyTorch versions.

Around the device search: :class:`PComp` splits a history of a product
spec (a KV map, an array of registers or CAS cells) per key, as each
command's :class:`KeyProj` declares, and decides the short sub-histories
with any inner backend (a refused declaration raises
:class:`NotDecomposableError`); :class:`CppOracle` is the native C++ host
checker (``native/wg.cpp``, built with ``g++`` at first use), the
property layer's resolving oracle when it builds; :class:`HybridDevice`
lets ``TorchStepper`` decide the easy majority under a tight budget and
the host checker the rest.

The search plane (``search/``): selectivity ordering of each history's
ops, and ``plan_search`` / ``build_backend``, the planned checker (the
port's own plan on the card).  Combinators that decide a history by its
structure: :class:`SegDC` (quiescent cuts, the final segments batched on
the device from every frontier state), :class:`RootSplit` (the first
choice point spread over lanes) and :class:`AutoDevice` (per-history
routing between the plain stepper and ``SegDC``, per key first).

The generation plane (``gen/``) manufactures the histories worth
checking: ``generate_batch`` draws a seeded table (on the card,
``csrc/threefry_draws.cu``) and assembles histories on the host, and
``SteeringLoop`` mutates workload profiles scored by the checkers'
search-cost records (``search/stats.py``).

The entry points (``utils/cli.py``): ``run`` (the concurrent property,
with fault plans, the TCP transport and worker processes), ``replay``,
``check`` (external trace files), ``list``, ``coverage``, ``explore``
(``sched/systematic.py``: every interleaving of small programs, the union
of their histories decided in one device batch) and ``fuzz``
(``utils/fuzz.py::fuzz_parity``: every checker against the exact oracle
on random specs).  ``core/sequential.py`` is the sequential property.

Resilience (``resilience/``): :class:`FailoverBackend` keeps a property
run alive through a lost dispatch (on the card only a fault the
``QSM_TPU_FAULTS`` plane injected degrades; a real device error raises),
under one :class:`RetryPolicy` and a watchdog, and :class:`CellJournal`
banks a scan's cells.  The history shrinker (``shrink/``):
:func:`shrink_history` minimises a failing history to a 1-minimal one
with a certificate, each frontier decided in one batch, its memo keyed
as the :class:`VerdictCache` (``serve/cache.py``) keys verdicts.

The mesh (``mesh/``): ``sharded_backend`` and ``TorchStepper(sharding=)``
split each batch's lanes over CUDA cards (or logical host devices with
``device="cpu"``) with bit-identical verdicts, witnesses and carries at
every width; ``parallel/`` is its deprecated re-export.
"""

from .core.generator import Program, ProgOp, generate_program
from .core.history import (History, Op, encode_batch, overlapping_history,
                           sequential_history)
from .core.property import (Counterexample, PropertyConfig, PropertyResult,
                            prop_concurrent, replay, trial_seed)
from .core.sequential import ModelSUT, prop_sequential, run_sequential
from .core.spec import CmdSig, KeyProj, Spec
from .models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from .models.queue import AtomicQueueSUT, QueueSpec, RacyTwoPhaseQueueSUT
from .models.register import (AtomicRegisterSUT, RacyCachedRegisterSUT,
                              RegisterSpec)
from .ops.backend import (BackendUnavailable, LineariseBackend, Verdict,
                          check_one, verify_witness)
from .native import CppOracle
from .ops.gpu_backend import TorchGPU
from .ops.hybrid import HybridDevice
from .ops.pcomp import NotDecomposableError, PComp
from .ops.rootsplit import RootSplit
from .ops.router import AutoDevice
from .ops.segdc import SegDC
from .ops.stepper import TorchStepper
from .ops.wing_gong_cpu import WingGongCPU
from .resilience import CellJournal, FailoverBackend, RetryPolicy
from .sched.runner import ConcurrentSUT, run_concurrent
from .sched.scheduler import FaultPlan, Monitor, Recv, Scheduler, Send
from .search import (CorpusProfile, OrderingTable, SearchPlan, SearchStats,
                     build_backend, collect_search_stats, ordering_table,
                     permute_history, plan_search, profile_corpus)
from .serve import VerdictCache
from .shrink import ShrinkResult, shrink_history

__all__ = [
    "AtomicCasSUT", "AtomicQueueSUT", "AtomicRegisterSUT", "AutoDevice",
    "BackendUnavailable", "CasSpec", "CellJournal", "CmdSig",
    "ConcurrentSUT", "CorpusProfile", "Counterexample", "CppOracle",
    "FailoverBackend", "FaultPlan", "History",
    "HybridDevice", "KeyProj", "LineariseBackend", "ModelSUT", "Monitor",
    "NotDecomposableError", "Op", "OrderingTable", "PComp", "Program",
    "ProgOp", "PropertyConfig", "PropertyResult", "QueueSpec",
    "RacyCachedRegisterSUT", "RacyCasSUT", "RacyTwoPhaseQueueSUT", "Recv",
    "RegisterSpec", "RetryPolicy", "RootSplit", "Scheduler", "SearchPlan",
    "SearchStats", "SegDC", "Send", "ShrinkResult", "Spec", "TorchGPU",
    "TorchStepper", "Verdict", "VerdictCache", "WingGongCPU",
    "build_backend", "check_one", "collect_search_stats",
    "encode_batch", "generate_program", "ordering_table",
    "overlapping_history", "permute_history", "plan_search",
    "profile_corpus", "prop_concurrent", "prop_sequential", "replay",
    "run_concurrent", "run_sequential", "sequential_history",
    "shrink_history", "trial_seed", "verify_witness",
]
