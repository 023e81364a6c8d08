"""``TorchStepper``: the chunked, lane-compacting device checker.

The counterpart of the JAX package's ``JaxTPU`` (``qsm_tpu/ops/
jax_kernel.py``), histories of up to 128 ops, in its two regimes, chosen
as ``JaxTPU`` chooses them (``jax_kernel.py:596-611``):

* the table regime: a scalar spec with a state bound, or a vector spec
  with a scalarized shadow (``ops/scalarize.py``), searched by
  ``stepper_chunk`` over a step table;
* the sweep regime: any other spec (a vector spec whose packed domain is
  too large for a table, such as a KV map of 16 keys), searched by
  ``stepper_sweep`` (``ops/sweep_kernel.py``), which steps the model
  itself every iteration: by the model's code in the kernel for a spec
  with a kernel model (``Spec.sweep_kernel``) of at most 28 state words,
  else by the generic route (``ops/sweep_generic.py``: the spec's own
  ``step_torch`` and the ``sweep_advance`` kernel), so that any spec the
  reference's ``JaxTPU`` accepts runs on the card (``sweep_route``).

Under a lane sharding (``sharding=``, ``qsm_tpu_torch/mesh/``) the
bucket ladder keeps the widths the mesh divides and each device holds an
equal block of a bucket's lanes (``mesh/shards.py``); the bucket sequence,
and so each lane's search, is the unsharded one on that ladder.

Host side: ``ops/host_contracts.py`` (the entry points; out-of-domain
histories deferred to the oracle in the table regime, out-of-bounds start
states of a shadow deferred, pending ops expanded), split at
``MAX_BATCH``, then per device batch:

1. the batch's tables are built once: in the table regime the step table
   on the device over the batch's vocabulary of distinct ``(cmd, arg,
   resp)`` ops, beside each history's predecessor words and vocabulary
   indices at its own row (``stepper_tables``); in the sweep regime each
   history's ops and predecessor words (``sweep_tables``);
2. ``stepper_chunk`` (or ``stepper_sweep``) runs a chunk of the schedule
   on every lane, and one status read per chunk tells the host which
   lanes decided; the sweep regime's lane list is checked on the device
   and read with that status.  Once the schedule settles, the
   double-buffered tail (``double_buffer``) enqueues the next chunk, on
   a spare of the carry, before the status is read;
3. decided lanes leave; when the survivors fit a smaller bucket of the
   ladder, or the bucket's memo size differs, ``compact_carry`` moves them
   into the new width and re-hashes their memo entries into the new table;
4. a lane whose cumulative iterations reach the total budget is
   BUDGET_EXCEEDED, never a guess.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.history import History, bucket_for, encode_batch
from ..core.spec import Spec
from .backend import resolve_device
from .host_contracts import DeviceChecker, map_chosen_back
from .scalarize import scalar_shadow
from .stepper_kernel import (BUDGET, INSERTS, ITERS, MAX_OPS, PRUNES,
                             RUNNING, STATUS, compact_carry,
                             fresh_stepper_carry, key_words, stepper_chunk,
                             stepper_tables)
from .sweep_kernel import (fresh_sweep_carry, lanes_left_out, stepper_sweep,
                           sweep_model, sweep_tables)

# The port's defaults, chosen for one H100 (80 GB).
#
# Chunk schedule: a first chunk of 1024 iterations decides the easy
# majority in one launch (a launch and its status read cost the host about
# a tenth of a millisecond, an iteration of the table-regime kernel about a
# microsecond of one lane's chain); later chunks grow 8x so that a lane
# that needs the whole 552,000-iteration budget costs 11 status reads.
CHUNK_SCHEDULE = (1024, 8192, 65536)
# Bucket ladder: warp multiples (one warp a block), 4096 the widest batch.
BATCH_BUCKETS = (32, 256, 1024, 4096)
# Memo size per bucket, from device memory: a slot is its key of kw words
# and its occupancy word, 4 * (kw + 1) bytes, with kw = W + D (W taken
# words, D state words: 1 in the table regime).  A batch's memo may take
# MEMO_BYTES = 1 GiB (1.25 % of the card) at the widest key the spec can
# have (N = 128, W = 4), so a bucket of B lanes gets the largest power of
# two <= 2**30 / (4 * (5 + D) * B) slots a lane, at most 2**16:
#   D = 1 (24 B a slot):  4096 lanes -> 8192, 1024 -> 32768, 256 and 32
#                         -> 65536;
#   D = 16 (84 B, a KV map of 16 keys):  4096 -> 2048, 1024 -> 8192,
#                         256 -> 32768, 32 -> 65536.
# The memo grows as the bucket shrinks, so each compaction re-hashes.
MEMO_BYTES = 1 << 30
MAX_SLOTS_PER_LANE = 1 << 16


def default_slots(bucket: int, state_dim: int = 1) -> int:
    """Memo slots a lane for a bucket of ``bucket`` lanes whose keys carry
    ``state_dim`` state words (module comment)."""
    slot_bytes = 4 * (key_words(MAX_OPS, state_dim) + 1)
    slots = MAX_SLOTS_PER_LANE
    while slots > 1 and bucket * slots * slot_bytes > MEMO_BYTES:
        slots //= 2
    return slots


def batch_bucket(b: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding ``b`` lanes (the largest for more)."""
    for s in buckets:
        if b <= s:
            return s
    return buckets[-1]


class TorchStepper(DeviceChecker):
    """Batched device backend implementing ``LineariseBackend``.

    ``device`` defaults to CUDA; without a CUDA device construction raises
    unless ``device="cpu"`` is asked for, which runs the kernels' plain
    versions (the tests do).  ``chunk_schedule``, ``batch_buckets`` and
    ``slots_for_batch`` (bucket -> memo slots a lane) replace the port's
    defaults, so that a test can hand it the JAX package's plan; a
    ``plan`` (``search/planner.py::SearchPlan``) replaces all three at
    once and may not be combined with them.  ``ordering`` permutes each
    history's ops by selectivity before encoding (``search/ordering.py``;
    None: the plan's setting, off without a plan); witnesses map back.
    ``regime`` says which search a spec takes: "table" or "sweep";
    ``sweep_route`` which route of the sweep regime: "kernel" (the
    model's code in ``stepper_sweep``) or "generic" (its ``step_torch``
    and ``sweep_advance``), None in the table regime.

    ``sharding`` (a ``mesh.LaneSharding``, the counterpart of
    ``JaxTPU(sharding=)``) spreads each device batch's lanes over the
    mesh's devices, CUDA cards, logical shards of one card or logical
    host devices; the ladder is filtered to widths the mesh divides
    (``mesh_bucket_ladder`` / ``mesh_slots_table``) and ``device``
    defaults to the mesh's first device.  Verdicts, witnesses and each
    lane's iterations are those of the unsharded stepper on the filtered
    ladder.  ``lanes_crossed`` counts the lanes compactions moved to
    another shard.

    ``double_buffer`` (the reference's ``DOUBLE_BUFFER``; None: on for a
    CUDA device, off on the CPU) runs the double-buffered tail: once the
    chunk schedule settles, each round copies the carry into a spare and
    enqueues the next chunk on it before reading its own status, so that
    the card computes while the host reads and decides.  It changes no
    verdict, witness, iteration or counter of the search;
    ``speculated_chunks`` counts those chunks, ``wasted_chunks`` the ones
    a compaction or the batch's end dropped, and ``host_sync_s`` the
    seconds the host waited for round status."""

    name = "torch_stepper"

    MAX_BATCH = 4096     # larger batches run as consecutive device batches

    @property
    def regime(self) -> str:
        return "table" if self._uses_table else "sweep"

    @property
    def sweep_route(self) -> Optional[str]:
        return None if self._sweep is None else self._sweep.route

    def __init__(self, spec: Spec, budget: int = 2_000,
                 max_expansions: int = 128, rescue_budget: int = 500_000,
                 mid_budget: int = 50_000, device=None,
                 chunk_schedule: Optional[Sequence[int]] = None,
                 batch_buckets: Optional[Sequence[int]] = None,
                 slots_for_batch: Optional[Dict[int, int]] = None,
                 plan=None, ordering: Optional[bool] = None,
                 sharding=None, double_buffer: Optional[bool] = None):
        if plan is not None:
            if (chunk_schedule is not None or batch_buckets is not None
                    or slots_for_batch is not None):
                raise ValueError("pass a plan or chunk_schedule / "
                                 "batch_buckets / slots_for_batch, not both")
            # the port's kernels have no unroll knob (plan.unroll): it
            # changes no verdict and no iteration count
            chunk_schedule = plan.chunk_schedule
            batch_buckets = plan.batch_buckets
            slots_for_batch = plan.slots_for_batch
        self.plan = plan
        self.spec = spec
        # the lane placement, resolved once (mesh/ owns the policy): the
        # mesh-shape key, the lane sharding and the devices of its blocks
        from ..mesh.shards import LaneShards
        from ..mesh.topology import (lane_devices, lane_sharding_of,
                                     mesh_shape_key)

        self.sharding = sharding
        self._mesh_key = mesh_shape_key(sharding)
        self._lane_sharding = None
        if sharding is not None:
            self._lane_sharding = lane_sharding_of(sharding)
            first = lane_devices(self._lane_sharding)[0].device
            if device is not None and resolve_device(device).type \
                    != first.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"({first})")
            device = first
        self.device = resolve_device(device)
        self._shards = (LaneShards(self._lane_sharding) if sharding is not None
                        else LaneShards.single(self.device))
        if ordering is None:
            ordering = bool(plan.ordering) if plan is not None else False
        self._ordering_table = None
        if ordering:
            from ..search.ordering import ordering_table

            self._ordering_table = ordering_table(spec)
        self._shadow = scalar_shadow(spec)
        self.kspec = self._shadow if self._shadow is not None else spec
        if self._shadow is not None:
            # a vector start state outside its element bounds would pack
            # onto another, valid state: defer it to the oracle
            self._start_in_bounds = self._shadow.in_bounds
        self._uses_table = (self.kspec.STATE_DIM == 1
                            and self.kspec.scalar_state_bound(1) is not None)
        # the sweep regime's model: its kernel's, or the generic route's
        self._sweep = (None if self._uses_table
                       else sweep_model(spec, self.device))
        self.chunk_schedule = tuple(chunk_schedule or CHUNK_SCHEDULE)
        self.batch_buckets = tuple(batch_buckets or BATCH_BUCKETS)
        self.slots_for_batch = dict(
            slots_for_batch if slots_for_batch is not None
            else {b: default_slots(b, self.kspec.STATE_DIM)
                  for b in self.batch_buckets})
        if self._shards.n > 1:
            from ..mesh.dispatch import mesh_bucket_ladder, mesh_slots_table

            self.batch_buckets = mesh_bucket_ladder(self.batch_buckets,
                                                    self._shards.n)
            self.slots_for_batch = mesh_slots_table(self.slots_for_batch,
                                                    self.batch_buckets)
        for b in self.batch_buckets:
            s = self.slots_for_batch[b]
            if s < 0 or s & (s - 1):
                raise ValueError(f"memo slots must be 0 or a power of two, "
                                 f"got {s} for bucket {b}")
        self.budget = budget
        self.max_expansions = max_expansions
        # per-lane iteration cap, the sum of the three budget knobs
        self.total_budget = budget + mid_budget + rescue_budget
        self.deferred_out_of_domain = 0
        self.device_histories = 0
        self.device_batches = 0  # each its own encoding and tables
        self.rescued = 0       # decided after more than ``budget`` iters
        self.rounds_run = 0    # chunk calls
        self.compactions = 0   # bucket or memo-size changes
        self.lanes_crossed = 0  # lanes a compaction moved to another shard
        self.memo_prunes = 0   # memo hits (subtrees skipped)
        self.memo_inserts = 0  # configurations proven non-linearizable
        # sum over chunk calls of (largest iterations any lane ran) x
        # bucket: what every lane pays in lockstep, not what it needed
        self.lockstep_cost = 0
        # each lane's cumulative iterations in the last device batch, in
        # the batch's flat order (the counterpart of the carry's ``iters``)
        self.last_iters = np.zeros(0, np.int64)
        # the double-buffered tail: None = auto (on for a CUDA device, off
        # on the CPU, where a wasted chunk costs the cores the next one
        # needs); True / False force it (the reference's DOUBLE_BUFFER)
        self.double_buffer = double_buffer
        self.speculated_chunks = 0
        self.wasted_chunks = 0
        self.host_sync_s = 0.0  # seconds the host waited for round status

    def search_stats(self):
        """Cumulative :class:`~qsm_tpu_torch.search.stats.SearchStats`:
        ``histories`` counts device lanes (after pending expansion),
        ``lockstep_iters`` the trips x padded width every lane pays,
        ``ordering`` whether ops are tried in selectivity order and
        ``plan`` the search plan's name ("" without one)."""
        from ..search.stats import SearchStats

        return SearchStats(
            engine=self.name,
            histories=self.device_histories,
            lockstep_iters=self.lockstep_cost,
            memo_prunes=self.memo_prunes,
            memo_inserts=self.memo_inserts,
            compactions=self.compactions,
            chunk_rounds=self.rounds_run,
            rescued=self.rescued,
            deferred=self.deferred_out_of_domain,
            ordering=self._ordering_table is not None,
            plan=self.plan.name if self.plan is not None else "",
        )

    def _double_buffer_on(self) -> bool:
        if self.double_buffer is not None:
            return self.double_buffer
        return self.device.type == "cuda"

    # -- the chunked, lane-compacting driver ---------------------------
    def _run_device(self, flat: Sequence[History],
                    flat_inits: Optional[List] = None,
                    collect_chosen: bool = False):
        """Statuses for a flat batch of pending-free histories; with
        ``collect_chosen`` also each lane's final ``chosen`` stack."""
        top = min(self.MAX_BATCH, self.batch_buckets[-1])
        if len(flat) > top:
            parts = [self._run_device(
                flat[i:i + top],
                flat_inits[i:i + top] if flat_inits else None,
                collect_chosen=collect_chosen)
                for i in range(0, len(flat), top)]
            if not collect_chosen:
                return np.concatenate(parts)
            # parts bucket their op counts apart: pad chosen to the widest
            # (-1 beyond depth) before joining them
            width = max(p[1].shape[1] for p in parts)
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([np.pad(
                        p[1], ((0, 0), (0, width - p[1].shape[1])),
                        constant_values=-1) for p in parts]))

        # selectivity try order: each history's ops permuted before
        # encoding (pending variants are expanded already, as the JAX
        # package orders them), so the kernel's lowest-index pick tries
        # the most constrained candidates first; chosen is mapped back
        # below
        perms = None
        if self._ordering_table is not None:
            from ..search.ordering import permute_history

            perms = [self._ordering_table.permutation(h) for h in flat]
            flat = [permute_history(h, p) for h, p in zip(flat, perms)]

        n_ops = bucket_for(max(len(h) for h in flat) or 1)
        if n_ops > MAX_OPS:
            raise ValueError(f"TorchStepper covers <= {MAX_OPS} ops")
        b = len(flat)
        enc = encode_batch(flat, self.kspec.initial_state(), max_ops=n_ops)
        ops = (enc.ops[:, :, 1], enc.ops[:, :, 2], enc.ops[:, :, 3],
               enc.valid, enc.precedes())
        if self._uses_table:
            inits = np.full(b, int(enc.init_state[0]), np.int32)
            if flat_inits is not None:
                # caller states are in the spec's representation; the
                # kernel runs the shadow's (validated by
                # host_contracts.flatten)
                inits[:] = [self._shadow.pack(s) if self._shadow is not None
                            else int(np.asarray(s).reshape(-1)[0])
                            for s in flat_inits]
            tables = stepper_tables(self.kspec, *ops, self.device)
            fresh, step = fresh_stepper_carry, stepper_chunk
        else:
            D = self.spec.STATE_DIM
            inits = np.tile(np.asarray(enc.init_state, np.int32), (b, 1))
            if flat_inits is not None:
                inits[:] = [np.asarray(s, np.int32).reshape(D)
                            for s in flat_inits]
            tables = sweep_tables(*ops, self.device)
            fresh = fresh_sweep_carry
            step = functools.partial(stepper_sweep, self._sweep)

        out_status = np.full(b, BUDGET, np.int32)
        out_chosen = (np.full((b, n_ops + 1), -1, np.int32)
                      if collect_chosen else None)
        active = np.arange(b)          # indices into the flat batch
        lanes = np.arange(b)           # carry lane of each active element
        prev_iters = np.zeros(b, np.int64)
        # the tables on every device of the mesh; the carry is one
        # StepperCarry a shard (mesh/shards.py)
        shards = self._shards
        tables = shards.replicate(tables)
        no_rows = np.zeros(0, np.int64)

        def pad(t, width, slots):
            return fresh(tables[t].nreq, no_rows, inits[no_rows], width,
                         n_ops, slots)
        # the double-buffered tail (the reference's jax_kernel.py:1036-
        # 1060): once the schedule settles, the next round's chunk is
        # enqueued, on a spare of the carry, before this round's status
        # is read, so that the card is not idle while the host reads it
        # and decides.  Decided lanes are frozen in the kernels, so the
        # speculative chunk IS the next round unless that round compacts
        # (then the compaction starts from the untouched carry) or the
        # batch ends; either way it is wasted.
        speculate = self._double_buffer_on()
        # the sweep launches' lane checks, counted on the stream and read
        # with the round's status
        flags = None if self._uses_table else shards.lane_flags()
        carry = spare = pending = None
        cur: Tuple[int, int] = (0, 0)  # (bucket, slots) of the carry
        last = len(self.chunk_schedule) - 1
        round_i = 0
        while active.size:
            bucket = batch_bucket(active.size, self.batch_buckets)
            slots = self.slots_for_batch[bucket]
            sched_i = min(round_i, last)
            if carry is None:
                carry = shards.fresh(fresh, tables, active, inits, bucket,
                                     n_ops, slots)
            elif (bucket, slots) != cur:
                if pending is not None:
                    pending = None
                    self.wasted_chunks += 1
                spare = None  # the old width's
                carry, crossed = shards.compact(
                    compact_carry, pad, carry, lanes, bucket, slots)
                self.lanes_crossed += crossed
                lanes = np.arange(active.size)
                self.compactions += 1
            cur = (bucket, slots)
            # every shard's launch enqueued before any status is read (the
            # sweep kernel runs each shard's active lanes alone, spread
            # evenly over the SMs); then the one host sync of the round
            launch = functools.partial(
                shards.step, step, tables,
                chunk=self.chunk_schedule[sched_i], budget=self.total_budget,
                sweep=not self._uses_table, missing=flags)
            if pending is not None:
                # the speculative chunk is this round's; the carry it
                # started from is the next spare
                carry, spare, pending = pending, carry, None
            else:
                carry = launch(carry, lanes)
            read = shards.read_status(carry, flags)
            if speculate and sched_i == last:
                # this round's lane list holds every lane still RUNNING
                # after it: the next round's may only be shorter
                spare = shards.snapshot(carry, spare, lanes)
                pending = launch(spare, lanes)
                self.speculated_chunks += 1
            t_sync = time.perf_counter()
            dsi, left_out = read.wait()
            self.host_sync_s += time.perf_counter() - t_sync
            if left_out:
                raise lanes_left_out(left_out)
            status = dsi[STATUS][lanes]
            iters = dsi[ITERS][lanes].astype(np.int64)
            self.rounds_run += 1
            delta = iters - prev_iters[active]
            self.lockstep_cost += int(delta.max(initial=0)) * bucket
            prev_iters[active] = iters
            done = status != RUNNING
            if done.any():
                out_status[active[done]] = status[done]
                if collect_chosen:
                    out_chosen[active[done]] = shards.chosen(
                        carry, lanes[done], after=read)
                decided = status[done] != BUDGET
                self.rescued += int(np.sum(decided
                                           & (iters[done] > self.budget)))
                # counters are cumulative per lane: harvest them once, the
                # round the lane decides
                self.memo_prunes += int(dsi[PRUNES][lanes[done]].sum())
                self.memo_inserts += int(dsi[INSERTS][lanes[done]].sum())
            active = active[~done]
            lanes = lanes[~done]
            round_i += 1
        if pending is not None:
            self.wasted_chunks += 1  # the batch ended under the gamble
        self.last_iters = prev_iters
        self.device_histories += b
        self.device_batches += 1
        if collect_chosen:
            if perms is not None:
                map_chosen_back(out_chosen, perms)
            return out_status, out_chosen
        return out_status
