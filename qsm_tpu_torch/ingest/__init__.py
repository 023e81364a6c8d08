"""qsm_tpu_torch.ingest — foreign trace formats as first-class corpora.

The counterpart of the JAX package's ``qsm_tpu/ingest``, line for line.

Jepsen/Knossos- and porcupine-style event logs decode into the repo's
ONE history encoding (utils/report.py rows) and flow into ``check``,
``submit``, ``shrink``, bench and the monitor plane unchanged — the
OmniLink premise (PAPERS.md): validating UNMODIFIED systems' traces is
what makes a checker a production tool.  ``adapters.py`` owns the file
layouts (byte-stable round trips), ``specmap.py`` the per-model integer
packing, ``tail.py`` the live log→session stream (the ``monitor``
command).
"""

from .adapters import (FORMATS, emit_trace, parse_trace)
from .edn import EdnError
from .specmap import SPEC_MAPS, IngestError, spec_map_for
from .tail import EventTailer, tail_file

__all__ = [
    "FORMATS", "SPEC_MAPS", "parse_trace", "emit_trace",
    "spec_map_for", "IngestError", "EdnError", "EventTailer",
    "tail_file",
]
