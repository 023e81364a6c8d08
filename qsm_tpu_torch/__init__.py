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
"""

from .core.generator import Program, ProgOp, generate_program
from .core.history import History, Op, encode_batch, overlapping_history
from .core.property import PropertyConfig, prop_concurrent, replay
from .core.spec import CmdSig, Spec
from .models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from .models.queue import AtomicQueueSUT, QueueSpec, RacyTwoPhaseQueueSUT
from .models.register import (AtomicRegisterSUT, RacyCachedRegisterSUT,
                              RegisterSpec)
from .ops.backend import (BackendUnavailable, Verdict, check_one,
                          verify_witness)
from .ops.gpu_backend import TorchGPU
from .ops.stepper import TorchStepper
from .ops.wing_gong_cpu import WingGongCPU

__all__ = [
    "AtomicCasSUT", "AtomicQueueSUT", "AtomicRegisterSUT",
    "BackendUnavailable", "CasSpec", "CmdSig", "History", "Op", "Program",
    "ProgOp", "PropertyConfig", "QueueSpec", "RacyCachedRegisterSUT",
    "RacyCasSUT", "RacyTwoPhaseQueueSUT", "RegisterSpec", "Spec",
    "TorchGPU", "TorchStepper", "Verdict", "WingGongCPU", "check_one",
    "encode_batch", "generate_program", "overlapping_history",
    "prop_concurrent", "replay", "verify_witness",
]
