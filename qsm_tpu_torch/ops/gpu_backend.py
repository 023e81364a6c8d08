"""``TorchGPU``: the batched device checker for scalar-table specs.

Host side (as the JAX package's device checker does it):

* scope: scalar-state specs with a declared state bound <= 64, histories
  of <= 32 ops (one-word bitmasks); other specs are refused;
* the entry points, out-of-domain deferral and pending expansion:
  ``ops/host_contracts.py``;
* every lane gets its ``[S, N]`` step table from one vectorised
  ``spec.step_torch`` over ``[B, S, N]`` on the device, built from the
  history's actual resps.

Device side: lanes padded to ``LANES``, then one ``dfs_chunk`` launch of
``CHUNK`` iterations after another until no lane is RUNNING, reading the
status plane back after each launch.  A lane still undecided after the
total budget is BUDGET_EXCEEDED, never a guess.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.history import History, bucket_for, encode_batch
from ..core.spec import Spec
from .backend import resolve_device
from .dfs_kernel import (BUDGET, MAX_OPS, MAX_STATES, RUNNING, SUCCESS, Carry,
                         Tables, dfs_chunk)
from .host_contracts import DeviceChecker, map_chosen_back


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


class TorchGPU(DeviceChecker):
    """Batched device backend implementing ``LineariseBackend``.

    ``device`` defaults to CUDA; without a CUDA device construction raises
    unless ``device="cpu"`` is asked for, which runs the kernel's plain
    version (the tests do).  ``ordering=True`` permutes each history's
    ops by selectivity before its step tables are built
    (``search/ordering.py``), as the JAX package's ``PallasTPU`` does;
    witnesses map back to the original indices."""

    name = "torch_gpu"

    LANES = 256          # lane padding
    CHUNK = 1024         # DFS iterations per kernel launch
    CACHE_SLOTS = 64     # per-lane memo slots (power of two; 0 disables)
    MAX_BATCH = 4096     # larger batches run as consecutive device batches

    def __init__(self, spec: Spec, budget: int = 2_000,
                 max_expansions: int = 128, rescue_budget: int = 500_000,
                 mid_budget: int = 50_000, device=None,
                 ordering: bool = False):
        self.spec = spec
        self.device = resolve_device(device)
        self._ordering_table = None
        if ordering:
            from ..search.ordering import ordering_table

            self._ordering_table = ordering_table(spec)
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

        # the selectivity try order: the kernel's lowest-index pick then
        # tries the most constrained ops first; chosen is mapped back below
        perms = None
        if self._ordering_table is not None:
            from ..search.ordering import permute_history

            perms = [self._ordering_table.permutation(h) for h in flat]
            flat = [permute_history(h, p) for h, p in zip(flat, perms)]

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
            chosen = carry.chosen.T[:b].cpu().numpy()
            if perms is not None:
                map_chosen_back(chosen, perms)
            return status, chosen
        return status
