"""Both packages' serving planes side by side, for the port's serve twins
(``tests/test_torch_serve*.py``, ``test_torch_devq.py``, the server-bound
cases of ``test_torch_obs.py`` / ``test_torch_monitor.py`` /
``test_torch_ingest.py``).

A :class:`Pkg` bundles what a serve test reaches in one package.  The
reference's server is its default ``CheckServer()`` (its host ladder: no
JAX is touched); the port's is ``CheckServer(device="cpu")``, and with
``engine="stepper"`` its engine is ``TorchStepper(device="cpu")``, the
device-engine path (BUDGET lanes resolved by the oracle)."""

from __future__ import annotations

import importlib
from types import SimpleNamespace

# ids, clocks and wall times differ between runs and packages
_VOLATILE_KEYS = ("trace", "seconds", "uptime_s", "ms", "span", "parent",
                  "ts", "id", "flight")


def _mods(root: str) -> SimpleNamespace:
    imp = importlib.import_module
    ns = SimpleNamespace(
        root=root,
        serve=imp(f"{root}.serve"),
        server=imp(f"{root}.serve.server"),
        protocol=imp(f"{root}.serve.protocol"),
        cache=imp(f"{root}.serve.cache"),
        registry=imp(f"{root}.models.registry"),
        backend=imp(f"{root}.ops.backend"),
        wg=imp(f"{root}.ops.wing_gong_cpu"),
        policy=imp(f"{root}.resilience.policy"),
        corpus=imp(f"{root}.utils.corpus"),
        cli=imp(f"{root}.utils.cli"),
        faults=imp(f"{root}.resilience.faults"),
    )
    return ns


class Pkg:
    """One package's serving plane, with the server built as the package
    builds it on the CPU."""

    def __init__(self, root: str, engine: str = "host"):
        self.root = root
        self.engine = engine
        self.m = _mods(root)
        self.port = root == "qsm_tpu_torch"
        self.MODELS = self.m.registry.MODELS
        self.make = self.m.registry.make
        self.Verdict = self.m.backend.Verdict
        self.verify_witness = self.m.backend.verify_witness
        self.WingGongCPU = self.m.wg.WingGongCPU
        self.CheckClient = self.m.serve.CheckClient
        self.VerdictCache = self.m.serve.VerdictCache
        self.Lane = self.m.serve.Lane
        self.MicroBatcher = self.m.serve.MicroBatcher
        self.AdmissionController = self.m.serve.AdmissionController
        self.VERDICT_NAMES = self.m.serve.VERDICT_NAMES
        self.fingerprint_key = self.m.cache.fingerprint_key
        self.history_to_rows = self.m.protocol.history_to_rows
        self.preset = self.m.policy.preset
        self.main = self.m.cli.main
        self.build_corpus = self.m.corpus.build_corpus

    def __repr__(self) -> str:
        return f"{self.root}:{self.engine}"

    @property
    def id(self) -> str:
        return "ref" if not self.port else f"port-{self.engine}"

    def server(self, **kw):
        """A ``CheckServer`` (not started)."""
        if self.port:
            kw.setdefault("device", "cpu")
            if self.engine == "stepper" and "engine_factory" not in kw:
                from qsm_tpu_torch.ops.stepper import TorchStepper

                kw["engine_factory"] = (
                    lambda s: TorchStepper(s, device="cpu"))
        return self.m.server.CheckServer(**kw)

    def corpus(self, family, n=10, pids=3, ops=8, prefix="serve"):
        entry = self.MODELS[family]
        spec = entry.make_spec()
        hists = self.build_corpus(
            spec, (entry.impls["atomic"], entry.impls["racy"]), n=n,
            n_pids=pids, max_ops=ops, seed_prefix=f"{prefix}_{family}")
        return spec, hists

    def names(self, verdicts):
        return [self.VERDICT_NAMES[int(v)] for v in verdicts]

    def rows(self, hists):
        return [self.history_to_rows(h) for h in hists]

    def reset_faults(self):
        self.m.faults._plane = None


REF = Pkg("qsm_tpu")
PORT = Pkg("qsm_tpu_torch")
PORT_STEPPER = Pkg("qsm_tpu_torch", engine="stepper")
PORTS = (PORT, PORT_STEPPER)


def strip(doc, drop=()):
    """A response without its volatile fields (ids, clocks, wall times)
    and those named in ``drop``."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k in _VOLATILE_KEYS or k in drop:
                continue
            out[k] = strip(v, drop)
        return out
    if isinstance(doc, list):
        return [strip(v, drop) for v in doc]
    return doc


def batches_shape(batches):
    """The batch stamps without their cost records."""
    return [{k: v for k, v in b.items() if k not in ("search", "batch")}
            for b in batches]

