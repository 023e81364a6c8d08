"""``qsm_tpu_torch.fleet`` — the multi-node serving tier.

The counterpart of the JAX package's ``qsm_tpu/fleet``, with its wire
documents, counters and span names.  The worker pool scales one host;
this package scales hosts while keeping the defining property
*survival*: nodes crash, wedge, partition and restart while verdicts
stay correct and available.

* ``router``     — :class:`FleetRouter`: the client protocol unchanged
  in front of N CheckServer nodes; consistent-hash routing by the
  verdict-cache identity, bounded exclude-and-re-dispatch on node loss,
  the router's own ladder as the last rung (the planned checker on the
  card unless ``device="cpu"``), SHED with the per-node health block; a
  node whose card failed is answered, never re-decided on the host;
* ``membership`` — :class:`Membership` / :class:`HashRing`: bounded
  health probes (``fleet-probe`` preset), one-way quarantine after
  repeated wedges, re-admission on sustained health, and the
  consistent-hash routing ring (the reference's ring, key for key);
* ``replog``     — :class:`SegmentedLog`: the append-only verdict
  bank generalized into content-fingerprinted segments that
  anti-entropy replicates node-to-node;
* ``lease``      — :class:`Lease`: the term+TTL record arbitrating which
  of N routers is the fleet's one active brain (router HA);
* ``gossip``     — :class:`GossipAgent`: node-to-node digest/pull/push
  anti-entropy with random peer fan-out, so banked verdicts keep
  converging with every router dead.

CLI: ``python -m qsm_tpu_torch fleet`` / ``stats --serve ROUTER
--fleet`` / ``soak``.
"""

from .gossip import GossipAgent
from .lease import Lease
from .membership import HashRing, Membership
from .replog import SegmentedLog, segment_fingerprint
from .router import (FleetRouter, NodeDead, NodeDeviceError, NodeFault,
                     NodeLink, NodePartitioned, NodeTimeout)

__all__ = [
    "FleetRouter", "GossipAgent", "HashRing", "Lease", "Membership",
    "NodeDead", "NodeDeviceError", "NodeFault", "NodeLink",
    "NodePartitioned", "NodeTimeout", "SegmentedLog",
    "segment_fingerprint",
]
