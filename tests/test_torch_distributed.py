"""Real ``torch.distributed`` execution: the twin of
``tests/test_distributed.py``.  Two OS processes join over ``gloo`` on a
free localhost port (``init_distributed``), one 2 x 4 mesh spans them
(``host`` = rank, ``batch`` = 4 logical host devices a rank), each rank
decides the lane blocks of its own devices and the verdict gather at the
end of the batch gives both ranks every verdict: equal to a
single-process run of the port and of the JAX package's kernel."""

from __future__ import annotations

import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_torch_distributed_worker.py")
REF_WORKER = os.path.join(HERE, "_distributed_worker.py")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reference_corpus():
    """The reference worker's 32 pending-free CAS histories and their
    statuses from one process (``jax.vmap`` of ``build_kernel``)."""
    import jax

    from qsm_tpu.core.history import encode_batch
    from qsm_tpu.models import AtomicCasSUT, CasSpec, RacyCasSUT
    from qsm_tpu.ops.jax_kernel import build_kernel
    from qsm_tpu.serve.protocol import history_to_rows
    from qsm_tpu.utils.corpus import build_corpus

    ref = _load(REF_WORKER, "_distributed_worker")
    spec, n_ops, args = ref.build_inputs()
    corpus = build_corpus(CasSpec(), (AtomicCasSUT, RacyCasSUT), n=64,
                          n_pids=ref.N_PIDS, max_ops=ref.N_OPS, seed_base=42,
                          seed_prefix="dist")
    corpus = [h for h in corpus if h.n_pending == 0][:ref.N_HIST]
    enc = encode_batch(corpus, spec.initial_state(), max_ops=n_ops)
    assert np.array_equal(enc.ops[:, :, 1], args[0])
    status, _ = jax.jit(jax.vmap(build_kernel(spec, n_ops, ref.BUDGET)))(
        *args)
    return [history_to_rows(h) for h in corpus], np.asarray(status)


def test_two_process_torch_distributed_sharded_kernel_parity(tmp_path):
    rows, want = _reference_corpus()
    rows_path = str(tmp_path / "rows.json")
    with open(rows_path, "w") as f:
        json.dump(rows, f)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    outs = [str(tmp_path / f"worker{i}.json") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(i), "2", str(port), rows_path, outs[i]],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)

    reports = [json.load(open(o)) for o in outs]
    assert {r["rank"] for r in reports} == {0, 1}
    assert all(r["world"] == 2 for r in reports)
    # each rank decided its own half of the mesh: host row = rank
    assert sorted(r["blocks"] for r in reports) == [[0, 1, 2, 3],
                                                     [4, 5, 6, 7]]
    assert all(r["mesh_shape_key"] == [8, "host", "batch"] for r in reports)
    # after the gather both ranks hold every verdict
    got = np.asarray(reports[0]["status"])
    assert np.array_equal(got, np.asarray(reports[1]["status"]))
    assert np.array_equal(got, want)
    # a single process of the port agrees too
    ref = _load(WORKER, "_torch_distributed_worker")
    from qsm_tpu_torch.ops.stepper_kernel import build_kernel

    spec, n_ops, planes, init = ref.encode(rows)
    one, _ = build_kernel(spec, n_ops, ref.BUDGET, device="cpu")(*planes,
                                                                 init)
    assert np.array_equal(got, one)
    # the corpus must exercise both verdicts, or parity proves nothing
    assert (want == 1).any() and (want == 2).any()


def test_explicit_process_id_wins_over_the_environment(monkeypatch):
    """Explicit arguments win over ``WORLD_SIZE`` / ``RANK`` even when
    falsy (``process_id=0``): a one-process group joins at once where the
    environment's rank 1 of 2 would wait for a peer."""
    import torch.distributed as dist

    from qsm_tpu_torch.mesh import init_distributed

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert init_distributed(f"127.0.0.1:{_free_port()}", num_processes=1,
                            process_id=0, device="cpu", timeout_s=30.0)
    try:
        assert dist.get_rank() == 0 and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_init_distributed_reads_torchs_environment(monkeypatch):
    """With no arguments, PyTorch's own ``MASTER_ADDR`` / ``MASTER_PORT``
    / ``WORLD_SIZE`` / ``RANK`` configure the group."""
    import torch.distributed as dist

    from qsm_tpu_torch.mesh import init_distributed

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert init_distributed(device="cpu", timeout_s=30.0)
    try:
        assert dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
