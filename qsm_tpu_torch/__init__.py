"""qsm_tpu_torch — state-machine property testing and linearizability
checking on PyTorch and CUDA.

The device search is a hand-written CUDA kernel
(``qsm_tpu_torch/csrc/dfs_chunk.cu``) driven by :class:`TorchGPU`; every
entry point runs on CUDA unless the caller passes ``device="cpu"``, which
runs the kernels' plain PyTorch versions.
"""

from .core.generator import Program, ProgOp, generate_program
from .core.history import History, Op, encode_batch, overlapping_history
from .core.property import PropertyConfig, prop_concurrent, replay
from .core.spec import CmdSig, Spec
from .models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from .models.register import (AtomicRegisterSUT, RacyCachedRegisterSUT,
                              RegisterSpec)
from .ops.backend import (BackendUnavailable, Verdict, check_one,
                          verify_witness)
from .ops.gpu_backend import TorchGPU
from .ops.wing_gong_cpu import WingGongCPU

__all__ = [
    "AtomicCasSUT", "AtomicRegisterSUT", "BackendUnavailable", "CasSpec",
    "CmdSig", "History", "Op", "Program", "ProgOp", "PropertyConfig",
    "RacyCachedRegisterSUT", "RacyCasSUT", "RegisterSpec", "Spec",
    "TorchGPU", "Verdict", "WingGongCPU", "check_one", "encode_batch",
    "generate_program", "overlapping_history", "prop_concurrent", "replay",
    "verify_witness",
]
