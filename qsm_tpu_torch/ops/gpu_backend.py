"""``TorchGPU``: the batched device checker for scalar-table specs.

Host side (as the JAX package's device checker does it):

* scope: scalar-state specs with a declared state bound <= 64, histories
  of <= 32 ops (one-word bitmasks); other specs are refused;
* histories whose args fall outside the declared command domains are
  deferred to the oracle (BUDGET_EXCEEDED), since the state bound only
  holds for in-domain args;
* pending ops are expanded host-side into every complete/prune variant
  (at most ``max_expansions``, else deferred); a history is linearizable
  iff some variant is;
* every lane gets its ``[S, N]`` step table from one vectorised
  ``spec.step_torch`` over ``[B, S, N]`` on the device, built from the
  history's actual resps.

Device side: lanes padded to ``LANES``, then one ``dfs_chunk`` launch of
``CHUNK`` iterations after another until no lane is RUNNING, reading the
status plane back after each launch.  A lane still undecided after the
total budget is BUDGET_EXCEEDED, never a guess.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.history import History, bucket_for, encode_batch
from ..core.spec import Spec
from .backend import Verdict, resolve_device
from .dfs_kernel import (BUDGET, FAILURE, MAX_OPS, MAX_STATES, RUNNING,
                         SUCCESS, Carry, Tables, dfs_chunk)


def lane_tables(spec: Spec, histories: Sequence[History], n_ops: int,
                lanes: int, device) -> Tables:
    """The kernel's read-only inputs for ``histories`` padded to
    ``lanes`` lanes (padding lanes have ``nreq == 0``)."""
    S = spec.scalar_state_bound(n_ops)
    N, B, b = n_ops, lanes, len(histories)
    enc = encode_batch(histories, spec.initial_state(), max_ops=n_ops)
    cmd, arg, resp = (torch.from_numpy(enc.ops[:, None, :, k]).to(device)
                      for k in (1, 2, 3))                    # [b, 1, N]
    st = torch.arange(S, dtype=torch.int32, device=device)[None, :, None]
    nxt_t, ok_t = spec.step_torch(st, cmd, arg, resp)        # [b, S, N]
    nxt = torch.zeros((S, N, B), dtype=torch.int32, device=device)
    ok = torch.zeros((S, N, B), dtype=torch.int32, device=device)
    nxt[:, :, :b] = nxt_t.permute(1, 2, 0)
    ok[:, :, :b] = ok_t.to(torch.int32).permute(1, 2, 0)
    # prec word of op j: bit i set iff op i must precede op j
    pw = (enc.precedes().astype(np.uint64)
          << np.arange(N, dtype=np.uint64)[None, :, None]).sum(axis=1)
    prec = np.zeros((N, B), np.int32)
    prec[:, :b] = pw.astype(np.uint32).view(np.int32).T
    valid = np.zeros((N, B), np.int32)
    valid[:, :b] = enc.valid.T
    nreq = np.zeros((1, B), np.int32)
    nreq[0, :b] = enc.valid.sum(axis=1)
    return Tables(nxt, ok, *(torch.from_numpy(a).to(device)
                             for a in (prec, valid, nreq)))


def fresh_carry(nreq: torch.Tensor, init_states: np.ndarray, n_ops: int,
                cache_slots: int) -> Carry:
    """The carry of a search not yet begun: depth 0 in each lane's initial
    state, padding lanes (``nreq == 0``) already SUCCESS."""
    N, B, dev = n_ops, nreq.shape[1], nreq.device
    cs = max(cache_slots, 1)
    states = torch.zeros((N + 1, B), dtype=torch.int32, device=dev)
    states[0, :len(init_states)] = torch.from_numpy(
        np.asarray(init_states, np.int32)).to(dev)
    dsi = torch.zeros((3, B), dtype=torch.int32, device=dev)
    dsi[1] = torch.where(nreq[0] == 0, SUCCESS, RUNNING)
    return Carry(
        torch.zeros((N, B), dtype=torch.int32, device=dev),
        torch.full((N + 1, B), -1, dtype=torch.int32, device=dev),
        states, dsi,
        *(torch.zeros((cs, B), dtype=torch.int32, device=dev)
          for _ in range(3)))


class TorchGPU:
    """Batched device backend implementing ``LineariseBackend``.

    ``device`` defaults to CUDA; without a CUDA device construction raises
    unless ``device="cpu"`` is asked for, which runs the kernel's plain
    version (the tests do)."""

    name = "torch_gpu"

    LANES = 256          # lane padding
    CHUNK = 1024         # DFS iterations per kernel launch
    CACHE_SLOTS = 64     # per-lane memo slots (power of two; 0 disables)
    MAX_BATCH = 4096     # larger batches run as consecutive device batches

    def __init__(self, spec: Spec, budget: int = 2_000,
                 max_expansions: int = 128, rescue_budget: int = 500_000,
                 mid_budget: int = 50_000, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        bound = (spec.scalar_state_bound(MAX_OPS)
                 if spec.STATE_DIM == 1 else None)
        if bound is None:
            raise ValueError(
                f"TorchGPU covers scalar-table specs only (scalar state "
                f"with a state bound); {spec.name} has none")
        if bound > MAX_STATES:
            raise ValueError(
                f"TorchGPU covers scalar-table specs with state bound "
                f"<= {MAX_STATES} (got {bound})")
        self.budget = budget
        self.max_expansions = max_expansions
        # per-lane iteration cap, the sum of the three budget knobs
        self.total_budget = budget + mid_budget + rescue_budget
        self.deferred_out_of_domain = 0
        self.device_histories = 0
        self.chunk_launches = 0
        self.rounds_run = 0
        # sum over chunk calls of CHUNK x padded lanes: what every lane
        # pays in lockstep, not what it needed
        self.lockstep_cost = 0

    # -- host contracts ------------------------------------------------
    def _args_in_domain(self, h: History) -> bool:
        cmds = self.spec.CMDS
        return all(0 <= o.cmd < len(cmds)
                   and 0 <= o.arg < cmds[o.cmd].n_args for o in h.ops)

    def _expand(self, h: History) -> Optional[List[History]]:
        """All complete/prune variants of a history's pending ops, or
        None past ``max_expansions``."""
        if h.n_pending == 0:
            return [h]
        pend = [i for i, o in enumerate(h.ops) if o.is_pending]
        n = 1
        choices = []
        for i in pend:
            opts = [None] + list(self.spec.resp_domain(h.ops[i].cmd))
            n *= len(opts)
            if n > self.max_expansions:
                return None
            choices.append(opts)
        pend_pos = {i: k for k, i in enumerate(pend)}
        out = []
        for combo in itertools.product(*choices):
            ops = []
            for i, o in enumerate(h.ops):
                if i in pend_pos:
                    c = combo[pend_pos[i]]
                    if c is None:
                        continue  # pruned: never took effect
                    # completed: its response time stays the pending
                    # sentinel (unconstrained on the right)
                    ops.append(dataclasses.replace(o, resp=int(c)))
                else:
                    ops.append(o)
            out.append(History(ops, seed=h.seed, program_id=h.program_id))
        return out

    def check_histories(self, spec: Spec, histories: Sequence[History],
                        init_states: Optional[Sequence] = None
                        ) -> np.ndarray:
        if spec is not self.spec:
            raise ValueError("TorchGPU is built per spec; construct one "
                             "per spec")
        if not histories:
            return np.empty(0, np.int8)
        if init_states is not None and len(init_states) != len(histories):
            raise ValueError(
                f"init_states has {len(init_states)} entries for "
                f"{len(histories)} histories")
        groups: List[Tuple[int, int]] = []  # (start, count) per input
        flat: List[History] = []
        flat_inits: List = []
        for idx, h in enumerate(histories):
            if not self._args_in_domain(h):
                self.deferred_out_of_domain += 1
                groups.append((len(flat), 0))
                continue
            exp = self._expand(h)
            if exp is None:
                groups.append((len(flat), 0))
                continue
            groups.append((len(flat), len(exp)))
            flat.extend(exp)
            if init_states is not None:
                flat_inits.extend([init_states[idx]] * len(exp))
        out = np.full(len(histories), int(Verdict.BUDGET_EXCEEDED), np.int8)
        if flat:
            statuses = self._run_device(
                flat, flat_inits if init_states is not None else None)
            for idx, (start, count) in enumerate(groups):
                if count == 0:
                    continue
                sub = statuses[start:start + count]
                if (sub == SUCCESS).any():
                    out[idx] = int(Verdict.LINEARIZABLE)
                elif (sub == BUDGET).any():
                    out[idx] = int(Verdict.BUDGET_EXCEEDED)
                else:
                    out[idx] = int(Verdict.VIOLATION)
        return out

    def check_from(self, spec: Spec, history: History, init_state
                   ) -> Verdict:
        """Linearizability from an explicit model state."""
        v = self.check_histories(spec, [history], init_states=[init_state])
        return Verdict(int(v[0]))

    def check_witness(self, spec: Spec, history: History):
        """(verdict, witness): the kernel's ``chosen`` stack read back on
        success, as ``(op_index, resp)`` pairs.  Pending-free, in-domain
        histories only; others get (verdict, None)."""
        if history.n_pending or not self._args_in_domain(history):
            return Verdict(
                int(self.check_histories(spec, [history])[0])), None
        if not history.ops:
            return Verdict.LINEARIZABLE, []
        statuses, chosen = self._run_device([history], collect_chosen=True)
        v = {SUCCESS: Verdict.LINEARIZABLE, FAILURE: Verdict.VIOLATION,
             BUDGET: Verdict.BUDGET_EXCEEDED}[int(statuses[0])]
        if v != Verdict.LINEARIZABLE:
            return v, None
        order = [int(j) for j in chosen[0][:len(history.ops)]]
        return v, [(j, history.ops[j].resp) for j in order]

    # -- device loop ---------------------------------------------------
    def _run_device(self, flat: Sequence[History],
                    flat_inits: Optional[List] = None,
                    collect_chosen: bool = False):
        """Statuses for a flat batch of pending-free histories; with
        ``collect_chosen`` (one device batch at most) also each lane's
        final ``chosen`` stack."""
        top = self.MAX_BATCH
        if len(flat) > top and not collect_chosen:
            return np.concatenate([
                self._run_device(
                    flat[i:i + top],
                    flat_inits[i:i + top] if flat_inits else None)
                for i in range(0, len(flat), top)])

        n_ops = bucket_for(max(len(h) for h in flat) or 1)
        if n_ops > MAX_OPS:
            raise ValueError(
                f"TorchGPU covers <= {MAX_OPS} ops (one-word bitmasks); "
                f"got bucket {n_ops}")
        b = len(flat)
        B = -(-b // self.LANES) * self.LANES
        inits = np.full(b, int(self.spec.initial_state()[0]), np.int32)
        if flat_inits is not None:
            inits[:] = [int(np.asarray(s).reshape(-1)[0])
                        for s in flat_inits]
        tables = lane_tables(self.spec, flat, n_ops, B, self.device)
        carry = fresh_carry(tables.nreq, inits, n_ops, self.CACHE_SLOTS)
        for _ in range(-(-self.total_budget // self.CHUNK)):
            carry = dfs_chunk(tables, carry, chunk=self.CHUNK,
                              budget=self.total_budget,
                              cache_slots=self.CACHE_SLOTS)
            self.chunk_launches += 1
            self.rounds_run += 1
            self.lockstep_cost += self.CHUNK * B
            # the host sync of the loop: one status read per launch
            if not bool((carry.dsi[1] == RUNNING).any()):
                break
        status = carry.dsi[1, :b].cpu().numpy()
        # still RUNNING after the budget's worth of chunks: undecided
        status = np.where(status == RUNNING, BUDGET, status)
        self.device_histories += b
        if collect_chosen:
            return status, carry.chosen.T[:b].cpu().numpy()
        return status
