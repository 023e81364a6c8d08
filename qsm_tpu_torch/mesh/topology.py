"""Mesh construction and the lane-axis placement contract, in one place.

The counterpart of the JAX package's ``qsm_tpu/mesh/topology.py``.  The
checker scales the batch axis of the linearisation search over a mesh of
devices: histories, per-key sub-histories, shrink candidates and monitor
window re-checks are independent lanes, so the lanes are split into
contiguous blocks, one a device, the batch's read-only tables are
replicated, and no device talks to another inside a search.  The one
collective, the verdict gather at the end of a batch across processes,
stays outside the kernels.

**Soundness contract.**  Sharding is only a placement change: verdicts,
witnesses and each lane's carry (its iterations, its ``chosen`` stack, its
memo) are bit-identical at every mesh width, because each lane's search
depends only on its own carry and the bucket ladder it runs on.  Pinned by
``tests/test_torch_mesh.py`` (register, CAS, queue and kv per key at width
8 against width 1 and against the JAX package's sharded checker, lane by
lane), ``tests/test_torch_parallel.py`` (compactions that move lanes
across shards) and ``tests/test_torch_distributed.py`` (two processes
over one 2 x 4 mesh).

The port's own small types stand in for ``jax.sharding``: a :class:`Mesh`
is an array of :class:`MeshDevice` plus axis names, a
:class:`LaneSharding` a mesh plus a partition spec (one entry a dimension;
dim 0 is the lane axis).  Three kinds of device make a mesh:

* **a CUDA card** (``make_mesh`` over ``torch.cuda.device_count()``
  cards): ``make_mesh(n)`` never hands back fewer than ``n`` cards;
* **a logical host device** (``device="cpu"``): a shard of the lane axis
  that keeps its own carry and runs the kernels' plain versions, the
  counterpart of XLA's forced host platform device count.  A width is a
  choice on the host, so ``make_mesh(n, device="cpu")`` builds any ``n``;
  a mesh of unstated width is one logical host device;
* **a logical shard of one card** (:func:`card_shard_mesh` only): N
  shards of one card, each with its own CUDA stream.  It runs a sharded
  launch on a machine with one card, and so measures what the split
  costs, not how the search scales.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

#: The canonical name of the lane (history-batch) axis on 1-D meshes.
LANE_AXIS = "batch"


@dataclasses.dataclass(frozen=True)
class MeshDevice:
    """One device of a mesh: ``device`` is where the shard's tensors live,
    ``shard`` numbers a logical shard (None for a whole CUDA card),
    ``process`` is the rank that owns it, ``stream`` (logical shards of a
    card) the CUDA stream its launches go on."""

    device: torch.device
    shard: Optional[int] = None
    process: int = 0
    stream: object = dataclasses.field(default=None, compare=False,
                                       repr=False)

    def __str__(self) -> str:
        where = f"{self.device}" + ("" if self.shard is None
                                    else f"/{self.shard}")
        return where if self.process == 0 else f"{where}@rank{self.process}"


class Mesh:
    """A device array (object ``numpy`` array of :class:`MeshDevice`) with
    one name an axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = (devices.astype(object)
                        if isinstance(devices, np.ndarray)
                        else _object_array(list(devices)))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices.flat]}, "
                f"axis_names={self.axis_names}, shape={self.devices.shape})")


@dataclasses.dataclass(frozen=True)
class LaneSharding:
    """A mesh and a partition spec: ``spec[k]`` names the mesh axis (or a
    tuple of axes) dimension ``k`` is split over; ``()`` replicates."""

    mesh: Mesh
    spec: tuple

    @property
    def device_set(self) -> set:
        return set(self.mesh.devices.flat)


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------

def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def _platform(device) -> str:
    """"cpu" or "cuda" for an entry point's ``device`` argument (CUDA
    unless the caller asks for the CPU; no card raises)."""
    from ..ops.backend import resolve_device

    return resolve_device(device).type


def host_devices(n: Optional[int] = None, process: int = 0) -> list:
    """``n`` logical host devices (default one)."""
    n = 1 if n is None else int(n)
    return [MeshDevice(torch.device("cpu"), shard=i, process=process)
            for i in range(n)]


def local_devices(device=None, n: Optional[int] = None) -> list:
    """This process' devices of ``device``'s kind: every CUDA card (None
    or a CUDA device; raises ``BackendUnavailable`` without one), or
    ``n`` logical host devices for ``device="cpu"``."""
    if _platform(device) == "cpu":
        return host_devices(n, process=_rank())
    return [MeshDevice(torch.device("cuda", i), process=_rank())
            for i in range(torch.cuda.device_count())]


def card_shard_mesh(n_shards: int, device=None,
                    axis: str = LANE_AXIS) -> Mesh:
    """A 1-D lane mesh of ``n_shards`` logical shards of one CUDA card
    (default: the current card), each with a CUDA stream of its own.  The one way
    a sharded launch runs on a machine with one card: it measures the
    split's cost, not scaling."""
    from ..ops.backend import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"card_shard_mesh shards a CUDA card, not {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if n_shards < 1:
        raise ValueError(f"card_shard_mesh: {n_shards} shards")
    return Mesh([MeshDevice(dev, shard=i, process=_rank(),
                            stream=torch.cuda.Stream(dev))
                 for i in range(int(n_shards))], (axis,))


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device=None, timeout_s: float = 300.0) -> bool:
    """Multi-process entry: join ``torch.distributed`` when configured.

    Each host runs this same program; a 2-D mesh (:func:`make_mesh_2d`)
    then maps its ``host`` axis to the ranks and its lane axis to each
    rank's local devices.  The search never talks across processes: the
    verdict gather at the end of a batch (:func:`gather_lanes`) is the one
    collective.  The backend is ``gloo`` with ``device="cpu"`` and NCCL on
    the card (without one: ``BackendUnavailable``).

    Reads PyTorch's own ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE``
    / ``RANK`` when the arguments are omitted; returns False (a no-op)
    when no address is configured.  Explicit arguments win over the
    environment even when falsy: ``process_id=0`` is the coordinator's
    rank.  ``coordinator_address`` is ``host:port`` or ``tcp://host:port``.
    Returns True once this process is in a group (also when it already
    was)."""
    import datetime

    import torch.distributed as dist

    if coordinator_address is None:
        host = os.environ.get("MASTER_ADDR")
        if host:
            port = os.environ.get("MASTER_PORT", "29500")
            coordinator_address = f"{host}:{port}"
    if not coordinator_address:
        return False
    if dist.is_initialized():
        return True
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    backend = "gloo" if _platform(device) == "cpu" else "nccl"
    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = f"tcp://{addr}"
    dist.init_process_group(backend=backend, init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_mesh(n_devices: Optional[int] = None, axis: str = LANE_AXIS,
              device=None) -> Mesh:
    """A 1-D lane mesh over the first ``n_devices`` CUDA cards (all by
    default), or over ``n_devices`` logical host devices with
    ``device="cpu"``.  Asking for more cards than the machine has raises
    ``ValueError``: a mesh is never narrower than asked for."""
    if _platform(device) == "cpu":
        return Mesh(host_devices(n_devices, process=_rank()), (axis,))
    devs = local_devices(device)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def mesh_from_devices(devices: Sequence, axis: str = LANE_AXIS) -> Mesh:
    """A 1-D lane mesh over an explicit device list: the constructor a
    drain window needs, whose devices are the ones it was handed, never a
    count over the machine's.  Takes :class:`MeshDevice` objects, torch
    devices or their names ("cpu" is one logical host device, "cuda:i" a
    card), in order; an empty list and a device listed twice are refused
    (a mesh with one device twice would count its lanes twice)."""
    devs = [d if isinstance(d, MeshDevice) else _mesh_device(d)
            for d in devices]
    if not devs:
        raise ValueError("mesh_from_devices: empty device set "
                         "(a window with no probed devices has no mesh)")
    if len(set(devs)) != len(devs):
        raise ValueError("mesh_from_devices: duplicate devices")
    return Mesh(devs, (axis,))


def _mesh_device(d) -> MeshDevice:
    from ..ops.backend import resolve_device

    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return MeshDevice(dev, shard=0 if dev.type == "cpu" else None,
                      process=_rank())


def make_mesh_2d(n_hosts: int, per_host: int,
                 axes: Sequence[str] = ("host", LANE_AXIS),
                 device=None) -> Mesh:
    """A (host, device) mesh: dim 0 the hosts, dim 1 the devices within a
    host.  In a process group of more than one rank the hosts are the
    ranks (``n_hosts`` must equal the world size) and each row is that
    rank's first ``per_host`` local devices; in one process it lays this
    process' devices out in ``n_hosts`` rows."""
    need = n_hosts * per_host
    world = _world()
    if world > 1:
        if n_hosts != world:
            raise ValueError(f"a 2-D mesh over {world} ranks has {world} "
                             f"hosts, not {n_hosts}")
        cpu = _platform(device) == "cpu"
        have = per_host if cpu else torch.cuda.device_count()
        if have < per_host:
            raise ValueError(f"requested {n_hosts}x{per_host} devices, "
                             f"have {n_hosts}x{have}")
        rows = [[MeshDevice(torch.device("cpu"), shard=i, process=r) if cpu
                 else MeshDevice(torch.device("cuda", i), process=r)
                 for i in range(per_host)] for r in range(world)]
        return Mesh(_object_array(rows), tuple(axes))
    devs = (host_devices(need) if _platform(device) == "cpu"
            else local_devices(device))
    if len(devs) < need:
        raise ValueError(f"requested {n_hosts}x{per_host} devices, "
                         f"have {len(devs)}")
    return Mesh(_object_array(devs[:need]).reshape(n_hosts, per_host),
                tuple(axes))


def _object_array(rows: list) -> np.ndarray:
    """An object array of devices (a list, or a list of equal rows):
    ``numpy`` must not look inside a device."""
    nested = bool(rows) and isinstance(rows[0], list)
    flat = [d for r in rows for d in r] if nested else list(rows)
    arr = np.empty(len(flat), dtype=object)
    arr[:] = flat
    return arr.reshape(len(rows), len(rows[0])) if nested else arr


# ---------------------------------------------------------------------------
# Placement and identity
# ---------------------------------------------------------------------------

def batch_sharding(mesh: Mesh, axis: Optional[str] = None) -> LaneSharding:
    """Dim 0 (the lanes) over the mesh axis, or over all axes of a
    multi-axis (host, device) mesh: the batch divides into n_hosts x
    per_host blocks, hierarchically."""
    if axis is None and len(mesh.axis_names) > 1:
        return LaneSharding(mesh, (tuple(mesh.axis_names),))
    return LaneSharding(mesh, (axis or mesh.axis_names[0],))


def replicated_sharding(mesh: Mesh) -> LaneSharding:
    """Every device holds the whole array (the batch's tables)."""
    return LaneSharding(mesh, ())


def lane_sharding_of(sharding: LaneSharding) -> LaneSharding:
    """The lane-axis derivation: a sharding that places dim 0 of a
    lane-leading array as ``sharding`` places its dim 0, whatever its
    trailing dims name.  The carry and every kernel argument take it."""
    axis = sharding.spec[0] if sharding.spec else None
    return LaneSharding(sharding.mesh, (axis,))


def mesh_device_count(obj=None, device=None) -> int:
    """Devices under a :class:`Mesh`, a :class:`LaneSharding`, or None
    (this process' devices of ``device``'s kind).  The count every
    bucket-ladder identity carries (:func:`mesh_shape_key`) and every
    bucket divides by (``mesh/dispatch.py``)."""
    if obj is None:
        return len(local_devices(device))
    mesh = getattr(obj, "mesh", obj)
    return int(mesh.size)


def mesh_shape_key(sharding: Optional[LaneSharding]) -> tuple:
    """Hashable identity of a sharding's mesh shape: ``(device_count,
    axis_names...)``, or ``(1,)`` unsharded.  The count tells a 1-device
    ladder from an 8-device one, and the names a flat ("batch",) mesh
    from a ("host", "batch") one of equal size."""
    if sharding is None:
        return (1,)
    mesh = sharding.mesh
    return (mesh_device_count(mesh),) + tuple(mesh.axis_names)


def lane_devices(sharding: LaneSharding) -> list:
    """The devices of a lane sharding in lane order: block ``i`` of dim 0
    lives on ``lane_devices(s)[i]``.  A spec must split dim 0 over every
    mesh axis (a 1-D mesh, or a 2-D mesh over both axes)."""
    axis = sharding.spec[0] if sharding.spec else None
    names = (axis,) if isinstance(axis, str) else tuple(axis or ())
    if names != tuple(sharding.mesh.axis_names):
        raise ValueError(f"lanes split over {names or 'no axis'} of a mesh "
                         f"with axes {sharding.mesh.axis_names}: the lane "
                         f"axis must span every mesh axis")
    return list(sharding.mesh.devices.flat)


def gather_lanes(sharding: LaneSharding, n_lanes: int, local: dict
                 ) -> np.ndarray:
    """The verdict gather at the end of a batch: ``local`` maps each
    block index this process owns to its rows (numpy, block ``i`` holding
    lanes ``[i * n / size, (i + 1) * n / size)``); returns all
    ``n_lanes`` rows, exchanged across the process group when the mesh
    spans more than one process."""
    import torch.distributed as dist

    devs = lane_devices(sharding)
    if n_lanes % len(devs):
        raise ValueError(f"{n_lanes} lanes do not split into "
                         f"{len(devs)} equal blocks")
    blocks = dict(local)
    if _world() > 1:
        got = [None] * _world()
        dist.all_gather_object(got, {int(k): np.asarray(v).tolist()
                                     for k, v in local.items()})
        for part in got:
            blocks.update({int(k): np.asarray(v) for k, v in part.items()})
    missing = sorted(set(range(len(devs))) - set(blocks))
    if missing:
        raise ValueError(f"blocks {missing} of the lane axis were not "
                         f"gathered")
    return np.concatenate([np.asarray(blocks[i]) for i in range(len(devs))])
