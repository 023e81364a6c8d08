"""Length-prefixed JSON frames — the supervisor ⇄ worker pipe encoding.

The counterpart of the JAX package's ``qsm_tpu/serve/frames.py``.

4-byte big-endian length + UTF-8 JSON, shared by ``serve/worker.py``
(blocking worker-side reads) and ``serve/pool.py`` (deadline-bounded
supervisor-side reads).  Newline framing (the socket plane's choice,
serve/protocol.py) would be wrong here: a worker is trusted but
*killable*, and a length prefix makes a half-written frame from a
SIGKILLed worker detectable instead of silently mergeable with the
next one.

This module is deliberately import-light and OUTSIDE the package's
``__init__`` import graph on the worker side: ``python -m
qsm_tpu_torch.serve.worker`` must not find its own module pre-imported by
``qsm_tpu_torch.serve`` (runpy's double-import warning).

Frames are plain JSON dicts, so the schema is extensible by optional
keys: the trace plane (obs) adds an OPTIONAL ``trace`` field
to ``check`` frames — the trace ids of the micro-batch's request(s) —
which new workers echo in their response and old workers simply
ignore (a dict key nobody reads).  Version skew in either direction
stays harmless.
"""

from __future__ import annotations

import json
import struct
from typing import BinaryIO, Optional

HDR = struct.Struct(">I")
# sanity bound on a frame length read off the pipe: a supervisor/worker
# version skew or a torn frame must fail loudly, not allocate gigabytes
MAX_FRAME_BYTES = 256 * 1024 * 1024


def encode_frame(doc: dict) -> bytes:
    payload = json.dumps(doc).encode()
    return HDR.pack(len(payload)) + payload


def read_frame(stream: BinaryIO) -> Optional[dict]:
    """Blocking worker-side frame read; None on EOF (supervisor gone —
    the worker exits rather than linger orphaned).  The supervisor side
    never uses this: its reads are deadline-bounded (serve/pool.py)."""
    hdr = _read_exact(stream, HDR.size)
    if hdr is None:
        return None
    (n,) = HDR.unpack(hdr)
    if n > MAX_FRAME_BYTES:
        raise ValueError(f"frame length {n} exceeds {MAX_FRAME_BYTES}")
    payload = _read_exact(stream, n)
    if payload is None:
        return None
    return json.loads(payload)


def _read_exact(stream: BinaryIO, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            return None  # EOF mid-frame: the peer is gone
        buf += chunk
    return buf
