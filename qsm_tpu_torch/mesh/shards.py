"""The lane blocks of one device batch over a mesh (B2).

The counterpart of the JAX package's ``JaxTPU._shard_carry`` and
``_arg_shardings`` (``qsm_tpu/ops/jax_kernel.py:1191``, ``:1238``): there
a dim-0 ``NamedSharding`` places every lane-leading array and XLA moves
lanes in the compaction's gather.  Here :class:`LaneShards` does it by
hand for ``ops/stepper.py::TorchStepper``:

* **placement**: a global bucket of ``B`` lanes is ``n`` blocks of ``B /
  n``, block ``i`` on the ``i``-th device of the lane sharding; global
  lane ``g`` is local lane ``g % (B / n)`` of shard ``g // (B / n)``.  The
  carry of each shard is its own ``StepperCarry`` (lane-last planes);
* **tables**: the batch's read-only tables are replicated on every device
  of the mesh (one copy a torch device: logical shards of one card or of
  the host share it), so a lane's ``row`` stays valid on any shard;
* **launches**: every shard's kernel is enqueued, each on its own stream,
  before any status is read; then every shard's ``dsi`` is copied into one
  buffer and read in one host transfer, into pinned memory behind an
  event, so that a speculative chunk enqueued after it (the driver's
  double-buffered tail) runs while the host waits for that event alone;
  the tail's chunk runs on a spare of each shard's carry
  (:meth:`LaneShards.snapshot`), which leaves the round's own carry as
  it was for a compaction or a ``chosen`` read;
* **compaction**: the survivors are renumbered 0..m-1 into the new global
  bucket, so a lane may move to another shard.  Each destination shard
  gathers its survivors' planes from their source shards (a plain copy on
  one device, ``.to()`` across cards) and runs ``compact_carry`` on them
  into the new width and memo size, which re-hashes each lane's memo on
  its own: the result is lane for lane the unsharded compaction's.

A failure on any shard raises; no shard is re-run on the host.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence

import numpy as np
import torch

from .topology import (LANE_AXIS, LaneSharding, Mesh, MeshDevice, _rank,
                       batch_sharding, lane_devices)


class LaneShards:
    """The shards of a lane sharding, as one device batch uses them; an
    unsharded batch is one shard on the device's current stream."""

    def __init__(self, sharding: LaneSharding):
        devs = lane_devices(sharding)
        here = _rank()
        if any(d.process != here for d in devs):
            raise ValueError(
                "TorchStepper runs the lanes of this process' devices: a "
                "mesh across processes is driven a block per rank, its "
                "verdicts joined by mesh.gather_lanes")
        self.n = len(devs)
        self.torch_devices = [d.device for d in devs]
        self.primary = self.torch_devices[0]
        # one shard launches on the device's current stream; logical
        # shards of a card bring their own streams, and a whole card of a
        # wider mesh launches on a stream of its own, made here
        self.streams = [
            None if self.n == 1 or d.device.type != "cuda" else
            (d.stream if d.stream is not None else torch.cuda.Stream(d.device))
            for d in devs]
        self._side = {}  # str(device) -> the stream chosen is read on

    @classmethod
    def single(cls, device: torch.device) -> "LaneShards":
        """The one shard of an unsharded batch on ``device``."""
        return cls(batch_sharding(Mesh([MeshDevice(device, process=_rank())],
                                       (LANE_AXIS,))))

    # -- streams -------------------------------------------------------
    @contextlib.contextmanager
    def on(self, i: int):
        """Run the body on shard ``i``'s device and stream, ordered after
        everything enqueued before on the device's current stream, which
        in turn waits for the body's work when it ends."""
        s = self.streams[i]
        if s is None:
            yield
            return
        dev = self.torch_devices[i]
        with torch.cuda.device(dev):
            main = torch.cuda.current_stream(dev)
            s.wait_stream(main)
            with torch.cuda.stream(s):
                yield
            main.wait_stream(s)

    # -- placement -----------------------------------------------------
    def replicate(self, tables):
        """One copy of the batch's tables a torch device of the mesh (the
        input's own on its device), indexed by shard."""
        copies = {}
        out = []
        for dev in self.torch_devices:
            key = str(dev)
            if key not in copies:
                copies[key] = (tables if tables[0].device == dev else
                               type(tables)(*(t.to(dev) for t in tables)))
            out.append(copies[key])
        return out

    def width(self, bucket: int) -> int:
        if bucket % self.n:
            raise ValueError(f"a bucket of {bucket} lanes does not split "
                             f"over {self.n} shards")
        return bucket // self.n

    def fresh(self, fresh: Callable, tables: Sequence, rows: np.ndarray,
              inits: np.ndarray, bucket: int, n_ops: int,
              slots: int) -> list:
        """Each shard's fresh carry: global lane ``i < len(rows)`` reads
        table row ``rows[i]`` from ``inits[rows[i]]``."""
        L = self.width(bucket)
        out = []
        for t in range(self.n):
            r = rows[t * L:(t + 1) * L]
            with self.on(t):
                out.append(fresh(tables[t].nreq, r, inits[r], L, n_ops,
                                 slots))
        return out

    # -- launches ------------------------------------------------------
    def step(self, step: Callable, tables: Sequence, carries: list,
             lanes: np.ndarray, *, chunk: int, budget: int,
             sweep: bool, missing=None) -> list:
        """One chunk on every shard that holds an active lane (``lanes``:
        the global carry lanes still running), each enqueued on its own
        stream; the sweep regime runs each shard's active lanes alone, in
        shard-local indices, its lane check counted into the shard's
        counter of ``missing`` (:meth:`lane_flags`) when there is one."""
        L = carries[0].row.shape[0]
        owner = lanes // L
        for t in range(self.n):
            local = lanes[owner == t] % L
            if not local.size:
                continue
            kw = {}
            if sweep:
                kw["lanes"] = local
                if missing is not None:
                    kw["missing"] = missing[t]
            with self.on(t):
                carries[t] = step(tables[t], carries[t], chunk=chunk,
                                  budget=budget, **kw)
        return carries

    def lane_flags(self) -> list:
        """One int32 ``[1]`` counter a shard, on its device, zero: the
        RUNNING lanes the sweep launches' lane lists left out
        (``stepper_sweep``'s ``missing``), read with each round's status
        (:meth:`read_status`)."""
        out = []
        for t, dev in enumerate(self.torch_devices):
            with self.on(t):
                out.append(torch.zeros(1, dtype=torch.int32, device=dev))
        return out

    def read_status(self, carries: list, flags=None) -> "StatusRead":
        """Start the round's one status read: every shard's ``dsi`` (and
        its lane-check counter, ``flags``) copied into one buffer on the
        first device, that buffer copied into pinned host memory without
        blocking, and an event recorded after it.  Work enqueued later (a
        speculative chunk) is not waited for: :meth:`StatusRead.wait`
        waits on the event alone."""
        L = carries[0].row.shape[0]
        B = L * self.n
        n_flags = 0 if flags is None else len(flags)
        buf = torch.empty(5 * B + n_flags, dtype=torch.int32,
                          device=self.primary)
        planes = buf[:5 * B].view(5, B)
        for t, c in enumerate(carries):
            with self.on(t):
                planes[:, t * L:(t + 1) * L].copy_(c.dsi, non_blocking=True)
                if flags is not None:
                    buf[5 * B + t:5 * B + t + 1].copy_(flags[t],
                                                       non_blocking=True)
        if self.primary.type != "cuda":
            return StatusRead(buf, None, B)
        host = torch.empty(buf.shape, dtype=torch.int32, pin_memory=True)
        with torch.cuda.device(self.primary):
            host.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.primary))
        return StatusRead(host, done, B)

    def snapshot(self, carries: list, spares, lanes: np.ndarray) -> list:
        """Each shard's carry copied into its spare on the shard's stream,
        for a speculative chunk that must leave ``carries`` as they are
        (``spares``: the last call's result, or None; a spare is made
        when there is none).  A shard without an active lane (``lanes``:
        the global carry lanes still running) is not launched, so its
        spare is its carry itself."""
        L = carries[0].row.shape[0]
        busy = set((lanes // L).tolist())
        out = []
        for t, c in enumerate(carries):
            s = None if spares is None else spares[t]
            if t not in busy:
                out.append(c)
                continue
            with self.on(t):
                if s is None or s is c:
                    s = type(c)(*(torch.empty_like(p) for p in c))
                for dst, src in zip(s, c):
                    dst.copy_(src, non_blocking=True)
            out.append(s)
        return out

    def chosen(self, carries: list, lanes: np.ndarray,
               after: "StatusRead" = None) -> np.ndarray:
        """The ``chosen`` stacks of global carry lanes ``lanes``,
        ``[len(lanes), N + 1]``.  With ``after`` (the round's status read)
        on the card, each shard is read on a side stream that waits for
        that read's event alone, not behind work enqueued since (a
        speculative chunk on another carry)."""
        L = carries[0].row.shape[0]
        out = np.empty((len(lanes), carries[0].chosen.shape[0]), np.int32)
        for t in np.unique(lanes // L):
            sel = np.nonzero(lanes // L == t)[0]
            with self._reading(int(t), after):
                idx = torch.from_numpy(lanes[sel] % L).to(
                    self.torch_devices[t])
                out[sel] = carries[t].chosen[:, idx].T.cpu().numpy()
        return out

    def _reading(self, t: int, after):
        """Shard ``t``'s read context: its own stream, or, after a status
        read on the card, a side stream of its device ordered after that
        read's event."""
        dev = self.torch_devices[t]
        if after is None or after.event is None:
            return self.on(t)
        side = self._side.get(str(dev))
        if side is None:
            side = self._side[str(dev)] = torch.cuda.Stream(dev)
        side.wait_event(after.event)
        return torch.cuda.stream(side)

    # -- compaction ----------------------------------------------------
    def compact(self, compact: Callable, pad: Callable, carries: list,
                lanes: np.ndarray, bucket: int, slots: int):
        """The survivors (global carry lanes ``lanes``, ascending) as the
        first ``len(lanes)`` lanes of a bucket of ``bucket`` over the
        shards, memo ``slots`` a lane; ``pad(t, width, slots)`` makes the
        carry of a shard left with no lane.  Returns the new carries and
        the count of lanes that changed shard."""
        L_old = carries[0].row.shape[0]
        L = self.width(bucket)
        src, src_local = lanes // L_old, lanes % L_old
        dst = np.arange(len(lanes)) // L
        out: List = []
        for t in range(self.n):
            sel = np.nonzero(dst == t)[0]
            if not sel.size:
                with self.on(t):
                    out.append(pad(t, L, slots))
                continue
            froms = np.unique(src[sel])
            if froms.size == 1 and froms[0] == t:
                with self.on(t):
                    out.append(compact(carries[t], src_local[sel], L, slots))
                continue
            pieces = []
            for s in froms:
                loc = src_local[sel][src[sel] == s]
                with self.on(int(s)):
                    piece = take_lanes(carries[s], loc)
                    if self.torch_devices[s] != self.torch_devices[t]:
                        piece = type(piece)(*(p.to(self.torch_devices[t])
                                              for p in piece))
                pieces.append(piece)
            with self.on(t):
                staged = cat_lanes(pieces)
                if self.streams[t] is not None:
                    for p in pieces:
                        for x in p:
                            x.record_stream(self.streams[t])
                out.append(compact(staged, np.arange(sel.size), L, slots))
        return out, int((src != dst).sum())


class StatusRead:
    """A round's status read in flight (:meth:`LaneShards.read_status`):
    ``host`` the buffer the read lands in, ``event`` recorded after the
    copy (None on the CPU), ``width`` the global bucket."""

    def __init__(self, host: torch.Tensor, event, width: int):
        self.host, self.event, self.width = host, event, width

    def wait(self):
        """``(dsi, left_out)``: the ``[5, B]`` planes as numpy and the
        RUNNING lanes the round's lane lists left out (0 without lane
        checks), once the read has landed; nothing enqueued after the
        read is waited for."""
        if self.event is not None:
            self.event.synchronize()
        got = self.host.numpy().copy()
        B = self.width
        return got[:5 * B].reshape(5, B), int(got[5 * B:].sum())


def _lane_axes(c) -> tuple:
    """The lane axis of each ``StepperCarry`` plane: lane-last stacks,
    lane-major memo and rows, and ``states`` lane-major in the sweep
    regime (``[B, N+1, D]``)."""
    sweep = c.states.dim() == 3
    return (1, 1, 0 if sweep else 1, 1, 0, 0, 0)


def take_lanes(c, lanes: np.ndarray):
    """A carry of the given local lanes of ``c`` (every plane, contiguous:
    the kernels read them unchecked)."""
    idx = torch.from_numpy(np.asarray(lanes, np.int64)).to(c.row.device)
    return type(c)(*(p.index_select(ax, idx).contiguous()
                     for p, ax in zip(c, _lane_axes(c))))


def cat_lanes(pieces: Sequence):
    """One carry of the pieces' lanes, in order."""
    axes = _lane_axes(pieces[0])
    return type(pieces[0])(*(
        torch.cat([p[k] for p in pieces], dim=axes[k]).contiguous()
        for k in range(len(axes))))
