"""Kernel hazard passes (pass family *b*; the counterpart of
``qsm_tpu/analysis/kernel_passes.py``).

The device engines (``ops/stepper.py``, ``ops/gpu_backend.py``, the kernel
wrappers of ``ops/*_kernel.py`` and the combinators ``ops/segdc.py``,
``ops/rootsplit.py``, ``ops/pcomp.py``) lose time on the card in ways the
test suite's tiny CPU corpora never exercise: a backend that rebuilds a
kernel library per batch pays ``nvcc`` inside the run, a promoted
``step_torch`` doubles the step tables' bytes, a host read inside the
launch loop stalls the card every trip, and a launch plan past the card's
shared memory or registers is refused only when it is launched.  Each
rule is the reference's, in the port's form:

* ``QSM-KERN-DTYPE``     — ``step_torch`` evaluated on int32 inputs (one
  state and scalar ops, and a batch of them): the new state must be an
  int32 tensor of the state's shape and ``ok`` a bool tensor; an int64 or
  float result is flagged.
* ``QSM-KERN-HOST-XFER`` — AST lint: no ``.item()`` / ``.tolist()`` /
  ``.cpu()`` / ``.numpy()`` / ``.synchronize()``, and no ``bool()`` /
  ``int()`` / ``float()`` of a computed value (a warning: the AST cannot
  tell a tensor from a host number), inside a loop that launches a kernel
  wrapper (``astutil.iter_launch_loop_bodies``).  The reference flags the
  same calls inside traced bodies.
* ``QSM-KERN-REBUILD``   — replaces ``QSM-KERN-RETRACE``: a warmed backend
  re-checking same-bucket corpora must not compile (``kernels.build``),
  load a library (the ``*_lib`` caches' misses) or grow a per-shape cache
  of its own.
* ``QSM-KERN-SMEM`` / ``QSM-KERN-REGS`` — replace ``QSM-KERN-VMEM``:
  every launch plan the kernels would be given for a registry spec at
  their op ceiling must fit one block's shared memory (dynamic plus the
  kernel's static bytes) and one SM's registers (the ptxas report's
  registers a thread × the plan's threads a block), and no kernel may
  spill or keep a stack frame.  On the card the largest plan of each
  kernel is launched once and held bit for bit against its plain
  version (:func:`launch_edge_plans`): the card's proof that "fits" is
  true.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..core.spec import Spec
from ..ops.dfs_kernel import LANES_PER_BLOCK
from ..ops.stepper_kernel import MAX_WARPS_PER_BLOCK
from .astutil import (attr_chain, iter_launch_loop_bodies, parse_module,
                      relpath_of)
from .findings import ERROR, INFO, WARNING, Finding

_HOST_READS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_HOST_CASTS = {"float", "int", "bool"}


# -- QSM-KERN-DTYPE ---------------------------------------------------------

def _dtype_inputs(spec: Spec, device, batch: int):
    """The kernels' input forms: one state vector with scalar ops
    (``batch == 0``), or ``batch`` states with an op each."""
    import torch

    init = torch.from_numpy(np.asarray(spec.initial_state(), np.int32)
                            .reshape(spec.STATE_DIM)).to(device)
    if not batch:
        op = torch.zeros((), dtype=torch.int32, device=device)
        return init, op, (spec.STATE_DIM,)
    op = torch.zeros(batch, dtype=torch.int32, device=device)
    if spec.STATE_DIM == 1:
        return init.expand(batch).contiguous(), op, (batch,)
    return (init.expand(batch, spec.STATE_DIM).contiguous(), op,
            (batch, spec.STATE_DIM))


def check_step_dtypes(spec: Spec, location: str, device="cpu"
                      ) -> List[Finding]:
    """Evaluate ``step_torch`` with the kernels' input types (int32 state,
    int32 ops) on ``device`` and flag promotions and shape drift."""
    import torch

    out: List[Finding] = []
    for batch in (0, 7):
        form = "a batch of states" if batch else "one state"
        try:
            state, op, want = _dtype_inputs(spec, device, batch)
            ns, ok = spec.step_torch(state, op, op, op)
        except Exception as e:  # noqa: BLE001 — a step_torch that cannot
            return [Finding(                 # even run is the finding
                ERROR, "QSM-KERN-DTYPE", location,
                f"step_torch fails on int32 inputs ({form}): "
                f"{type(e).__name__}: {e}"[:300],
                "the step tables come from step_torch over int32 "
                "tensors; it must run under exactly these types")]
        if ns.dtype != torch.int32:
            out.append(Finding(
                ERROR, "QSM-KERN-DTYPE", location,
                f"step_torch returns state dtype {ns.dtype} on {form} "
                f"(want torch.int32)",
                "the kernels read int32 step tables; a promoted state "
                "doubles the tables' bytes and needs a cast on every "
                "build (torch.tensor(...) without a dtype and int64 "
                "constants are the usual source)"))
        if tuple(ns.shape) != want:
            out.append(Finding(
                ERROR, "QSM-KERN-DTYPE", location,
                f"step_torch returns state shape {tuple(ns.shape)} on "
                f"{form} (want {want})",
                "the step tables stack states at STATE_DIM width on a "
                "trailing axis"))
        if ok.dtype != torch.bool:
            out.append(Finding(
                ERROR, "QSM-KERN-DTYPE", location,
                f"step_torch returns ok dtype {ok.dtype} on {form} "
                f"(want torch.bool)",
                "the ok words are packed from a bool tensor; a non-bool "
                "ok packs garbage bits"))
        if out:
            return out
    return out


# -- QSM-KERN-HOST-XFER -----------------------------------------------------

def check_host_transfers(path: str, root: Optional[str] = None
                         ) -> List[Finding]:
    """AST lint over one engine module: host reads inside a loop that
    launches a kernel wrapper.

    Locations are function-qualified (``path:funcname:line``) so a
    whitelist entry can pin the one reviewed function (a backend's one
    status read a round) instead of the whole file — a file-wide prefix
    would silently accept FUTURE transfers anywhere in the module the
    gate most exists to protect."""
    tree = parse_module(path)
    relpath = relpath_of(path, root)
    out: List[Finding] = []
    seen = set()
    for fn_name, node in iter_launch_loop_bodies(tree):
        if not isinstance(node, ast.Call) or id(node) in seen:
            continue
        seen.add(id(node))
        loc = f"{relpath}:{fn_name}:{getattr(node, 'lineno', 0)}"
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _HOST_READS:
            what = ".".join(attr_chain(node.func)) or f".{node.func.attr}"
            out.append(Finding(
                ERROR, "QSM-KERN-HOST-XFER", loc,
                f"{what}() inside the launch loop of {fn_name!r}",
                "a host read inside the loop waits for the card on every "
                "trip: read the status once a round, in the one "
                "reviewed place"))
        elif (isinstance(node.func, ast.Name)
              and node.func.id in _HOST_CASTS
              and node.args
              and not isinstance(node.args[0], ast.Constant)):
            out.append(Finding(
                WARNING, "QSM-KERN-HOST-XFER", loc,
                f"python {node.func.id}() cast inside the launch loop of "
                f"{fn_name!r}",
                "casting a CUDA tensor reads it to the host and waits "
                "for the card; keep the decision on the device or read "
                "once a round"))
    return out


# -- QSM-KERN-REBUILD -------------------------------------------------------

_BACKEND_CACHES = ("_compiled", "_fns", "_plans", "_libs")


def build_state(backend) -> Dict[str, int]:
    """What a warmed backend must not grow: compiles by ``kernels.build``,
    library loads (misses of the ``*_lib`` caches), and its own
    per-shape caches (dict attributes named like a cache)."""
    from ..ops import kernels
    from ..ops.stepper_kernel import device_sms

    caches = device_sms.cache_info().currsize
    for name, val in vars(backend).items():
        if isinstance(val, dict) and ("cache" in name
                                      or name in _BACKEND_CACHES):
            caches += len(val)
    return {"compiles": kernels.build.compiles,
            "library_loads": sum(f.cache_info().misses
                                 for f in kernels.KERNEL_LIBS),
            "backend_caches": caches}


def check_rebuild(spec: Spec, backend, corpora: Sequence,
                  location: str, record: Optional[dict] = None
                  ) -> List[Finding]:
    """Warm ``backend`` on ``corpora[0]`` then re-check same-bucket
    corpora; any growth of :func:`build_state` after the warm call is a
    rebuild.  ``corpora`` must all bucket to the same op count — the
    caller guarantees it (engine.py builds them).  ``record`` (optional)
    receives the state after the warm call and after the last."""
    backend.check_histories(spec, corpora[0])  # warm: builds are legal
    warm = build_state(backend)
    now = warm
    for i, corpus in enumerate(corpora):
        backend.check_histories(spec, corpus)
        now = build_state(backend)
        grew = {k: (warm[k], now[k]) for k in warm if now[k] > warm[k]}
        if grew:
            if record is not None:
                record.update(warm=warm, after=now)
            return [Finding(
                ERROR, "QSM-KERN-REBUILD", location,
                f"warmed same-bucket call #{i + 1} grew "
                + ", ".join(f"{k} {a} -> {b}" for k, (a, b)
                            in sorted(grew.items()))
                + f" (backend {type(backend).__name__})",
                "a per-call nvcc build costs seconds to a minute on the "
                "card; key built libraries on the source and flags only, "
                "never on per-call state")]
    if record is not None:
        record.update(warm=warm, after=now)
    return []


# -- QSM-KERN-SMEM / QSM-KERN-REGS ------------------------------------------

REGS_SM = 65_536        # 32-bit registers of one SM
REG_ALLOC_UNIT = 256    # a warp's registers are allocated in these units
# The launch shapes the CUDA sources fix themselves (no Python plan):
COMPACT_THREADS = 256   # csrc/compact_carry.cu THREADS
DRAWS_MAX_THREADS = 1024  # csrc/threefry_draws.cu 32 * SM_WARPS
DRAWS_SM_WARPS = 32       # csrc/threefry_draws.cu SM_WARPS
EDGE_CHUNK = 64         # iterations of an edge launch's one chunk
# the most threads a block each kernel is ever launched with (its
# __launch_bounds__): the register check's bound where no plan applies
LAUNCH_BOUND_THREADS = {"dfs_chunk": LANES_PER_BLOCK,
                        "stepper_chunk": 32 * MAX_WARPS_PER_BLOCK,
                        "compact_carry": COMPACT_THREADS,
                        "stepper_sweep": 32 * MAX_WARPS_PER_BLOCK,
                        "threefry_draws": DRAWS_MAX_THREADS}


class PtxasEntry(NamedTuple):
    """One entry function of a ``-Xptxas -v`` report."""
    name: str
    registers: int
    smem: int          # static shared bytes
    stack: int
    spill_stores: int
    spill_loads: int


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(text: str) -> List[PtxasEntry]:
    """The entry functions of a ``-Xptxas -v`` report, in order."""
    out: List[PtxasEntry] = []
    cur: Optional[dict] = None

    def close():
        if cur is not None:
            out.append(PtxasEntry(**cur))
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            close()
            cur = dict(name=m.group(1), registers=0, smem=0, stack=0,
                       spill_stores=0, spill_loads=0)
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["smem"] = int(s.group(1)) if s else 0
    close()
    return out


def block_registers(registers: int, threads: int) -> int:
    """Registers one block of ``threads`` threads holds on an SM: each
    warp's ``32 * registers`` rounded up to the allocation unit."""
    per_warp = -(-registers * 32 // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
    return -(-threads // 32) * per_warp


class KernelPlan(NamedTuple):
    """A launch plan one kernel would be given for one spec (or its own
    ceiling): where it comes from, its threads and dynamic shared bytes
    a block, its blocks an SM by shared memory and warps, and what an
    edge launch needs to rebuild it."""
    kernel: str
    location: str
    model: Optional[str]
    plan: tuple
    threads: int
    smem: int
    blocks_per_sm: int
    params: dict


def _domain_ops(spec: Spec) -> List[Tuple[int, int, int]]:
    return [(c, a, r) for c, sig in enumerate(spec.CMDS)
            for a in range(sig.n_args) for r in range(sig.n_resps)]


def kernel_plans(specs: Sequence[Tuple[str, Spec, str]], sms: int
                 ) -> Dict[str, List[KernelPlan]]:
    """Every plan the five kernels would be given for the registry specs
    ``(name, spec, location)`` at the kernels' op ceiling on a card of
    ``sms`` SMs, each kernel's own ceiling included."""
    from ..ops import dfs_kernel as dk
    from ..ops import stepper_kernel as sk
    from ..ops import sweep_kernel as wk
    from ..ops.gpu_backend import TorchGPU
    from ..ops.scalarize import scalar_shadow
    from ..ops.stepper import BATCH_BUCKETS, TorchStepper, default_slots

    out: Dict[str, List[KernelPlan]] = {k: [] for k in (
        "dfs_chunk", "stepper_chunk", "compact_carry", "stepper_sweep",
        "threefry_draws")}
    cs = TorchGPU.CACHE_SLOTS

    def dfs(loc, name, S):
        plan = dk.launch_plan(TorchGPU.LANES, dk.MAX_OPS, S, cs)
        out["dfs_chunk"].append(KernelPlan(
            "dfs_chunk", loc, name, tuple(plan), plan.lanes_per_block,
            plan.smem_bytes, dk.blocks_per_sm(plan),
            dict(S=S, N=dk.MAX_OPS, cache_slots=cs)))
    dfs("qsm_tpu_torch/ops/dfs_kernel.py:MAX_STATES", None, dk.MAX_STATES)
    N, B = sk.MAX_OPS, TorchStepper.MAX_BATCH
    for name, spec, loc in specs:
        if spec.STATE_DIM == 1:
            S = spec.scalar_state_bound(dk.MAX_OPS)
            if S is not None and S <= dk.MAX_STATES:
                dfs(loc, name, S)
        kspec = scalar_shadow(spec) or spec
        if kspec.STATE_DIM == 1 and kspec.scalar_state_bound(1) is not None:
            S = kspec.scalar_state_bound(N)
            V = len(_domain_ops(spec))
            plan = sk.stepper_launch_plan(B, N, S, V, sms)
            out["stepper_chunk"].append(KernelPlan(
                "stepper_chunk", loc, name, tuple(plan),
                32 * plan.warps_per_block, plan.smem_bytes,
                sk.stepper_blocks_per_sm(plan), dict(S=S, V=V, N=N)))
        if spec.sweep_kernel() is not None:
            D = spec.STATE_DIM
            for L in BATCH_BUCKETS:
                slots = default_slots(L, D)
                plan = wk.sweep_launch_plan(L, N, D, slots, sms)
                out["stepper_sweep"].append(KernelPlan(
                    "stepper_sweep", loc, name, tuple(plan),
                    32 * plan.warps_per_block, plan.smem_bytes,
                    _sweep_blocks_per_sm(plan),
                    dict(L=L, N=N, D=D, slots=slots)))
    out["compact_carry"].append(KernelPlan(
        "compact_carry", "qsm_tpu_torch/csrc/compact_carry.cu:THREADS",
        None, (COMPACT_THREADS,), COMPACT_THREADS, 0,
        min(dk.BLOCKS_SM_MAX, sk.WARPS_SM_MAX // (COMPACT_THREADS // 32)),
        {}))
    out["threefry_draws"].append(KernelPlan(
        "threefry_draws", "qsm_tpu_torch/csrc/threefry_draws.cu:SM_WARPS",
        None, (DRAWS_MAX_THREADS,), DRAWS_MAX_THREADS, 0, 1,
        dict(lanes=32 * DRAWS_SM_WARPS * sms, draws=16)))
    return out


def _sweep_blocks_per_sm(plan) -> int:
    from ..ops import dfs_kernel as dk
    from ..ops import stepper_kernel as sk

    return min(dk.BLOCKS_SM_MAX, sk.WARPS_SM_MAX // plan.warps_per_block,
               dk.SMEM_SM // (plan.smem_bytes + dk.SMEM_BLOCK_RESERVED))


def edge_plan(plans: Sequence[KernelPlan]) -> KernelPlan:
    """The plan of most shared bytes (then most threads) a kernel is
    given for a registry spec (its own ceiling only where no spec
    reaches it): the one whose launch proves the estimator's "fits"."""
    specs = [p for p in plans if p.model is not None] or list(plans)
    return max(specs, key=lambda p: (p.smem, p.threads))


def ptxas_entries(kernel: str) -> Optional[List[PtxasEntry]]:
    """The ptxas report of ``kernel``'s built library, or None when it is
    not built here (no ``nvcc``)."""
    from ..ops import kernels

    text = kernels.ptxas_report(kernel)
    return parse_ptxas(text) if text else None


def check_kernel_envelope(specs: Sequence[Tuple[str, Spec, str]],
                          sms: Optional[int] = None,
                          reports: Optional[Dict[str, Optional[
                              List[PtxasEntry]]]] = None
                          ) -> Tuple[List[Finding], List[dict]]:
    """QSM-KERN-SMEM / QSM-KERN-REGS over every plan of
    :func:`kernel_plans`, with each kernel's ptxas report (``reports``:
    kernel -> entries or None; default: the built libraries' reports).
    Returns ``(findings, rows)``, a row a kernel: its registers, stack,
    spills, edge plan and the estimator's blocks an SM."""
    from ..ops import dfs_kernel as dk

    sms = sms or dk.H100_SMS
    plans = kernel_plans(specs, sms)
    out: List[Finding] = []
    rows: List[dict] = []
    for kernel, ps in plans.items():
        entries = (reports[kernel] if reports is not None
                   else ptxas_entries(kernel))
        src = f"qsm_tpu_torch/csrc/{kernel}.cu"
        static = max((e.smem for e in entries), default=0) if entries \
            else 0
        for p in ps:
            total = p.smem + static
            if total > dk.SMEM_BLOCK_MAX or p.blocks_per_sm < 1:
                out.append(Finding(
                    ERROR, "QSM-KERN-SMEM", p.location,
                    f"{kernel} plan {p.plan} needs {total} shared bytes a "
                    f"block ({p.smem} dynamic + {static} static; limit "
                    f"{dk.SMEM_BLOCK_MAX}), {p.blocks_per_sm} blocks an "
                    "SM",
                    "the launch is refused on the card only: shrink the "
                    "plan or what it stages in shared memory"))
        # no plan (no spec of the run reaches the kernel): the registers
        # are held against the kernel's launch bound instead
        edge = edge_plan(ps) if ps else None
        threads = max((p.threads for p in ps),
                      default=LAUNCH_BOUND_THREADS[kernel])
        row = dict(kernel=kernel, plans=len(ps),
                   edge=edge.location if edge else None,
                   edge_model=edge.model if edge else None,
                   edge_plan=list(edge.plan) if edge else None,
                   threads=edge.threads if edge else threads,
                   smem=(edge.smem if edge else 0) + static,
                   blocks_per_sm=edge.blocks_per_sm if edge else None,
                   registers=None, stack=None, spills=None, entries=0)
        if not entries:
            out.append(Finding(
                INFO, "QSM-KERN-REGS", src,
                f"no build of {kernel} here: its registers, stack and "
                "spills are not checked (the shared-memory half ran)", ""))
            rows.append(row)
            continue
        regs = max(e.registers for e in entries)
        stack = max(e.stack for e in entries)
        spills = max(e.spill_stores + e.spill_loads for e in entries)
        need = block_registers(regs, threads)
        row.update(registers=regs, stack=stack, spills=spills,
                   entries=len(entries))
        if edge is not None:
            row["blocks_per_sm"] = min(edge.blocks_per_sm, REGS_SM // max(
                block_registers(regs, edge.threads), 1))
        if need > REGS_SM:
            out.append(Finding(
                ERROR, "QSM-KERN-REGS", src,
                f"{kernel}: {regs} registers a thread x {threads} threads "
                f"a block need {need} registers, past one SM's {REGS_SM}",
                "cap the registers (__launch_bounds__) or the plan's "
                "warps a block"))
        for e in entries:
            if e.stack or e.spill_stores or e.spill_loads:
                out.append(Finding(
                    ERROR, "QSM-KERN-REGS", src,
                    f"{kernel}: entry {e.name} keeps a {e.stack}-byte "
                    f"stack frame and spills {e.spill_stores} / "
                    f"{e.spill_loads} bytes (stores / loads)",
                    "a spill or a local array goes to device memory on "
                    "every access: keep the state in registers or shared "
                    "memory"))
        rows.append(row)
    return out, rows


# -- the edge launches (the card's proof of "fits") --------------------------

def _prec(rng, R: int, N: int) -> np.ndarray:
    """A sparse random real-time order: ``prec[r, i, j]`` for some
    ``i < j``."""
    p = rng.random((R, N, N)) < 0.02
    return np.triu(p, 1)


def _max_err(got, want) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(got, want))


def _edge_dfs(p: KernelPlan, spec: Spec, dev) -> int:
    import torch

    from ..ops.dfs_kernel import Carry, dfs_chunk, dfs_chunk_plain
    from ..ops.gpu_backend import fresh_carry
    from ..utils.corpus import random_lane_tables

    tabs = random_lane_tables(p.params["N"], p.params["S"], 32, seed=17,
                              device=dev)
    init = np.zeros(32, np.int32)
    carry = fresh_carry(tabs.nreq, init, p.params["N"],
                        p.params["cache_slots"])
    kw = dict(chunk=EDGE_CHUNK, budget=10 ** 6,
              cache_slots=p.params["cache_slots"])
    got = dfs_chunk(tabs, Carry(*(t.clone() for t in carry)), **kw)
    want = dfs_chunk_plain(tabs, Carry(*(t.clone() for t in carry)), **kw)
    torch.cuda.synchronize(dev)
    return _max_err(got, want)


def _edge_stepper(p: KernelPlan, spec: Spec, dev, sms: int):
    """The stepper edge launch; returns (error, carry after the chunk)."""
    import torch

    from ..ops.scalarize import scalar_shadow
    from ..ops.stepper_kernel import (StepperCarry, fresh_stepper_carry,
                                      stepper_chunk, stepper_chunk_plain,
                                      stepper_tables)

    kspec = scalar_shadow(spec) or spec
    N, V = p.params["N"], p.params["V"]
    ops = np.asarray(_domain_ops(spec), np.int32)
    R = -(-V // N)
    idx = np.arange(R * N) % V
    cmd, arg, resp = (ops[idx, k].reshape(R, N) for k in range(3))
    valid = np.ones((R, N), bool)
    tabs = stepper_tables(kspec, cmd, arg, resp, valid,
                          _prec(np.random.default_rng(17), R, N), dev)
    if tuple(tabs.vnxt.shape) != (p.params["S"], V):
        raise ValueError(f"stepper edge tables {tuple(tabs.vnxt.shape)}, "
                         f"plan {p.params}")
    B = 16 * sms   # lanes enough for the plan's 16 warps a block
    rows = np.arange(B) % R
    init = int(np.asarray(kspec.initial_state()).reshape(-1)[0])
    carry = fresh_stepper_carry(tabs.nreq, rows, np.full(B, init, np.int32),
                                B, N, 64)
    got = stepper_chunk(tabs, StepperCarry(*(t.clone() for t in carry)),
                        chunk=EDGE_CHUNK, budget=10 ** 6)
    want = stepper_chunk_plain(tabs,
                               StepperCarry(*(t.clone() for t in carry)),
                               chunk=EDGE_CHUNK, budget=10 ** 6)
    torch.cuda.synchronize(dev)
    return _max_err(got, want), got


def _edge_compact(carry, dev) -> int:
    import torch

    from ..ops.stepper_kernel import (RUNNING, STATUS, compact_carry,
                                      compact_carry_plain)

    running = torch.nonzero(carry.dsi[STATUS] == RUNNING).flatten()
    lanes = running[:256].cpu().numpy()
    got = compact_carry(carry, lanes, 256, 128)   # 64 -> 128: re-hash
    want = compact_carry_plain(carry, torch.from_numpy(
        lanes.astype(np.int32)).to(dev), 256, 128)
    torch.cuda.synchronize(dev)
    return _max_err(got, want)


def _edge_sweep(p: KernelPlan, spec: Spec, dev) -> int:
    import torch

    from ..ops.stepper_kernel import StepperCarry
    from ..ops.sweep_kernel import (fresh_sweep_carry, stepper_sweep,
                                    stepper_sweep_plain, sweep_model,
                                    sweep_tables)

    L, N, D = p.params["L"], p.params["N"], p.params["D"]
    rng = np.random.default_rng(17)
    ops = np.asarray(_domain_ops(spec), np.int32)
    pick = ops[rng.integers(0, len(ops), (L, N))]
    tabs = sweep_tables(pick[..., 0], pick[..., 1], pick[..., 2],
                        np.ones((L, N), bool), _prec(rng, L, N), dev)
    init = np.tile(np.asarray(spec.initial_state(), np.int32), (L, 1))
    carry = fresh_sweep_carry(tabs.nreq, np.arange(L), init, L, N,
                              p.params["slots"])
    got = stepper_sweep(sweep_model(spec, dev), tabs,
                        StepperCarry(*(t.clone() for t in carry)),
                        chunk=EDGE_CHUNK, budget=10 ** 6)
    want = stepper_sweep_plain(spec, tabs,
                               StepperCarry(*(t.clone() for t in carry)),
                               chunk=EDGE_CHUNK, budget=10 ** 6)
    torch.cuda.synchronize(dev)
    return _max_err(got, want)


def _edge_draws(p: KernelPlan, dev) -> Tuple[int, tuple]:
    import torch

    from ..ops.draws_kernel import (draws_plan, threefry_draws,
                                    threefry_draws_plain)

    out = torch.empty((p.params["lanes"], p.params["draws"]),
                      dtype=torch.int32, device=dev)
    plan = draws_plan(out)
    got = threefry_draws(out, 17)
    want = threefry_draws_plain(torch.empty_like(out), 17)
    torch.cuda.synchronize(dev)
    return _max_err((got,), (want,)), tuple(plan)


def launch_edge_plans(specs: Sequence[Tuple[str, Spec, str]], device
                      ) -> Tuple[List[Finding], List[dict]]:
    """Launch each kernel once at its edge plan (:func:`edge_plan`) on
    the CUDA ``device`` and hold it bit for bit against its plain
    version: the dfs table at the largest admitted state bound, the
    stepper's largest staged table (every op of the spec's domain in its
    vocabulary, 16 warps a block), the sweep's largest memo, a compaction
    of the stepper's lanes with a memo re-hash, and a draw table whose
    plan takes a whole SM's warps a block.  Returns ``(findings, rows)``:
    a failed or disagreeing launch is a QSM-KERN-SMEM error."""
    import torch

    from ..ops.stepper_kernel import device_sms

    dev = torch.device(device)
    sms = device_sms(dev)
    plans = kernel_plans(specs, sms)
    by_name = {name: spec for name, spec, _ in specs}
    out: List[Finding] = []
    rows: List[dict] = []
    stepper_carry = None
    for kernel in ("dfs_chunk", "stepper_chunk", "compact_carry",
                   "stepper_sweep", "threefry_draws"):
        if not plans[kernel] or (kernel == "compact_carry"
                                 and stepper_carry is None):
            continue  # no spec of the run reaches it
        edge = edge_plan(plans[kernel])
        spec = by_name.get(edge.model)
        row = dict(kernel=kernel, edge=edge.location, plan=list(edge.plan),
                   smem=edge.smem, threads=edge.threads)
        try:
            if kernel == "dfs_chunk":
                err = _edge_dfs(edge, spec, dev)
            elif kernel == "stepper_chunk":
                err, stepper_carry = _edge_stepper(edge, spec, dev, sms)
            elif kernel == "compact_carry":
                err = _edge_compact(stepper_carry, dev)
            elif kernel == "stepper_sweep":
                err = _edge_sweep(edge, spec, dev)
            else:
                err, plan = _edge_draws(edge, dev)
                row["plan"] = list(plan)
        except Exception as e:  # noqa: BLE001 — a refused launch IS the
            err = None                       # finding this pass exists for
            out.append(Finding(
                ERROR, "QSM-KERN-SMEM", f"qsm_tpu_torch/csrc/{kernel}.cu",
                f"{kernel} edge launch at {edge.location} plan "
                f"{edge.plan} failed: {type(e).__name__}: {e}"[:400],
                "the estimator admitted a plan the card refuses: fix the "
                "plan or the estimator"))
        if err:
            out.append(Finding(
                ERROR, "QSM-KERN-SMEM", f"qsm_tpu_torch/csrc/{kernel}.cu",
                f"{kernel} edge launch at {edge.location} differs from its "
                f"plain version (max abs err {err})",
                "a launch at the largest admitted plan must be exact"))
        row["max_abs_err"] = err
        rows.append(row)
    return out, rows
