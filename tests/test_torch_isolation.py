"""The port stands alone: importing it (and its CLI) loads neither JAX nor
any module of the JAX package, and no file of the port or
``chip_smoke.py`` imports one."""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "qsm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "qsm_tpu"


def test_import_loads_no_jax_and_no_reference_module():
    code = ("import json, sys, qsm_tpu_torch, qsm_tpu_torch.utils.cli, "
            "qsm_tpu_torch.ops.kernels, qsm_tpu_torch.ops.stepper, "
            "qsm_tpu_torch.ops.sweep_kernel, qsm_tpu_torch.utils.fuzz, "
            "qsm_tpu_torch.models.registry, qsm_tpu_torch.models.failover, "
            "qsm_tpu_torch.ops.pcomp, qsm_tpu_torch.ops.hybrid, "
            "qsm_tpu_torch.native, qsm_tpu_torch.resilience.failover, "
            "qsm_tpu_torch.search.ordering, qsm_tpu_torch.search.planner, "
            "qsm_tpu_torch.ops.segdc, qsm_tpu_torch.ops.rootsplit, "
            "qsm_tpu_torch.ops.router, qsm_tpu_torch.sched.systematic, "
            "qsm_tpu_torch.sched.transport, qsm_tpu_torch.sched.pool, "
            "qsm_tpu_torch.core.sequential, qsm_tpu_torch.utils.report, "
            "qsm_tpu_torch.utils.stats, qsm_tpu_torch.obs, "
            "qsm_tpu_torch.monitor, qsm_tpu_torch.ingest, "
            "qsm_tpu_torch.serve, qsm_tpu_torch.serve.worker, "
            "qsm_tpu_torch.fleet, qsm_tpu_torch.devq, "
            "qsm_tpu_torch.gen.fleet, qsm_tpu_torch.fleet.router, "
            "qsm_tpu_torch.fleet.gossip, qsm_tpu_torch.fleet.lease, "
            "qsm_tpu_torch.fleet.membership, qsm_tpu_torch.gen.soak, "
            "qsm_tpu_torch.mesh, qsm_tpu_torch.mesh.topology, "
            "qsm_tpu_torch.mesh.dispatch, qsm_tpu_torch.mesh.shards, "
            "qsm_tpu_torch.parallel, qsm_tpu_torch.analysis, "
            "qsm_tpu_torch.analysis.engine, "
            "qsm_tpu_torch.analysis.kernel_passes, "
            "qsm_tpu_torch.analysis.spec_passes, "
            "qsm_tpu_torch.analysis.fixtures\n"
            "print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    bad = [m for m in json.loads(out) if _forbidden(m)]
    assert bad == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_file_imports_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert bad == []
