"""Graceful degradation: the host checker every degradation lands on.

The counterpart of ``host_fallback`` in the JAX package's
``qsm_tpu/resilience/failover.py``; the rest of that module (the
``FailoverBackend`` wrapper of a device engine) is not ported yet.
"""

from __future__ import annotations

from ..core.spec import Spec


def host_fallback(spec: Spec):
    """The host checker ladder: the native C++ oracle when the toolchain
    builds it (itself falling back to the Python oracle for anything
    outside its coverage), else the memoised Python oracle.  The property
    layer's resolving oracle and the hybrid plan's tail are this one
    ladder."""
    from ..native import CppOracle, native_available
    from ..ops.wing_gong_cpu import WingGongCPU

    if native_available():
        return CppOracle(spec)
    return WingGongCPU(memo=True)
