"""Message transports under the deterministic scheduler.

* :class:`InMemoryTransport`: messages move as Python objects (the
  default, and what ``transport=None`` means).
* :class:`TcpLoopbackTransport`: every captured send and every delivery
  crosses a real localhost TCP connection as a length-prefixed pickle
  frame, one persistent connection a process endpoint.

The scheduler still makes every ordering decision from its seeded RNG;
a transport only carries bytes, synchronously, over per-connection FIFO
streams.  So histories are bit-identical across transports, and the TCP
variant adds what memory cannot show: payloads must survive
serialization and really cross the socket layer.
"""

from __future__ import annotations

import pickle
import select
import socket
import struct
from typing import Dict, Tuple

from .scheduler import Message

_LEN = struct.Struct(">I")
STALL_S = 60.0  # a round trip that moves no byte for this long fails


class InMemoryTransport:
    """Messages move as Python objects."""

    name = "memory"

    def uplink(self, msg: Message) -> Message:
        """Carry a captured send from its source process to the pool."""
        return msg

    def downlink(self, msg: Message) -> Message:
        """Carry a chosen delivery from the pool to its destination."""
        return msg

    def close(self) -> None:
        pass


def _roundtrip(send_sock: socket.socket, recv_sock: socket.socket,
               msg: Message) -> Message:
    """Write one frame on ``send_sock`` and read it back off
    ``recv_sock``, interleaved by ``select``: both ends are driven by the
    one scheduler thread, so a blocking ``sendall`` of a frame larger
    than the loopback buffers would deadlock."""
    blob = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    out = memoryview(_LEN.pack(len(blob)) + blob)
    chunks = []
    got = 0
    need = None  # the inbound frame's size, once its header is in
    while out or need is None or got < _LEN.size + need:
        ws = [send_sock] if out else []
        rs, wr, _ = select.select([recv_sock], ws, [], STALL_S)
        if not rs and not wr:
            raise ConnectionError(
                f"transport round trip stalled ({STALL_S:.0f} s)")
        if wr:
            sent = send_sock.send(out[:65536])
            out = out[sent:]
        if rs:
            chunk = recv_sock.recv(65536)
            if not chunk:
                raise ConnectionError("transport peer closed mid-frame")
            chunks.append(chunk)
            got += len(chunk)
            if need is None and got >= _LEN.size:
                head = b"".join(chunks)
                (need,) = _LEN.unpack(head[:_LEN.size])
                chunks = [head]
    return pickle.loads(b"".join(chunks)[_LEN.size:])


class TcpLoopbackTransport:
    """Real localhost TCP under the deterministic scheduler.

    One listener (bound to port 0) plays the scheduler's end; each named
    process endpoint gets one persistent loopback connection, made at its
    first send or delivery.  ``uplink`` writes the captured send on the
    source's connection and reads it back off the accepted peer;
    ``downlink`` writes the chosen delivery on the destination's peer and
    reads it off the destination's connection.  ``close`` closes every
    socket."""

    name = "tcp"

    def __init__(self):
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(128)
        self.address = self._listener.getsockname()
        # endpoint name -> (process-side socket, scheduler-side socket)
        self._conns: Dict[str, Tuple[socket.socket, socket.socket]] = {}
        self.frames = 0  # frames carried over TCP

    def _conn(self, name: str) -> Tuple[socket.socket, socket.socket]:
        pair = self._conns.get(name)
        if pair is None:
            client = socket.create_connection(self.address)
            client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            broker, _ = self._listener.accept()
            broker.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            pair = (client, broker)
            self._conns[name] = pair
        return pair

    def uplink(self, msg: Message) -> Message:
        client, broker = self._conn(msg.src)
        self.frames += 1
        return _roundtrip(client, broker, msg)

    def downlink(self, msg: Message) -> Message:
        client, broker = self._conn(msg.dst)
        self.frames += 1
        return _roundtrip(broker, client, msg)

    def close(self) -> None:
        for pair in self._conns.values():
            for s in pair:
                try:
                    s.close()
                except OSError:
                    pass
        self._conns.clear()
        try:
            self._listener.close()
        except OSError:
            pass


def make_transport(kind: str):
    if kind == "memory":
        return InMemoryTransport()
    if kind == "tcp":
        return TcpLoopbackTransport()
    raise ValueError(f"unknown transport {kind!r}")
