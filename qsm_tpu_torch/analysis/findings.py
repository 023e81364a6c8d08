"""Structured findings + whitelist for the port's ``qsmlint`` static
analyzer (the counterpart of ``qsm_tpu/analysis/findings.py``).

Every pass emits :class:`Finding` records — ``{severity, rule_id,
location, message, fix_hint}`` — never prints.  Rendering (text for
humans, JSON for CI archival) and whitelist filtering live
here so the pass modules stay pure.

Severity policy (docs/ANALYSIS.md):

* ``error``   — would waste time on the card or produce a wrong verdict
  (spec parity divergence, state-bound violation, a launch plan past the
  card's shared memory or registers, per-call kernel rebuilds,
  nondeterminism feeding scheduler decisions).  Non-whitelisted errors
  fail ``python -m qsm_tpu_torch lint`` (exit 1).
* ``warning`` — suspicious but often legitimate (wall-clock reads in the
  scheduler plane used only for timing stats).  Reported, never fatal.
* ``info``    — notes (passes that ran vacuously, sampled coverage).

Whitelist format (default file: ``<repo>/.qsmlint-torch``, the
reference's format): one accepted finding per line, ``RULE_ID
location-prefix`` with ``#`` comments —

    # timing stats, not delivery decisions
    QSM-DET-TIME qsm_tpu_torch/sched/pool.py:_explore_one

A finding is whitelisted when its ``rule_id`` matches exactly and its
``location`` starts with the given prefix (``*`` matches any location).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITIES = (ERROR, WARNING, INFO)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer finding; ``location`` is ``path:line`` for AST passes
    and ``model:<family>`` / ``spec:<name>`` for semantic passes."""

    severity: str
    rule_id: str
    location: str
    message: str
    fix_hint: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(severity=d["severity"], rule_id=d["rule_id"],
                   location=d["location"], message=d["message"],
                   fix_hint=d.get("fix_hint", ""))


class Whitelist:
    """Accepted findings: exact rule_id + location prefix per entry."""

    def __init__(self, entries: Sequence[Tuple[str, str]] = (),
                 path: Optional[str] = None):
        self.entries = list(entries)
        self.path = path

    @classmethod
    def load(cls, path: str) -> "Whitelist":
        entries = []
        with open(path) as f:
            for ln in f:
                ln = ln.split("#", 1)[0].strip()
                if not ln:
                    continue
                parts = ln.split(None, 1)
                rule = parts[0]
                prefix = parts[1].strip() if len(parts) > 1 else "*"
                entries.append((rule, prefix))
        return cls(entries, path=path)

    def allows(self, finding: Finding) -> bool:
        for rule, prefix in self.entries:
            if finding.rule_id != rule:
                continue
            if prefix == "*" or finding.location.startswith(prefix):
                return True
        return False


def split_whitelisted(findings: Sequence[Finding],
                      whitelist: Optional[Whitelist]
                      ) -> Tuple[List[Finding], List[Finding]]:
    """(kept, whitelisted); severity ordering is preserved within each."""
    if whitelist is None:
        return list(findings), []
    kept, allowed = [], []
    for f in findings:
        (allowed if whitelist.allows(f) else kept).append(f)
    return kept, allowed


def sort_findings(findings: Sequence[Finding]) -> List[Finding]:
    rank = {s: i for i, s in enumerate(SEVERITIES)}
    return sorted(findings,
                  key=lambda f: (rank.get(f.severity, len(SEVERITIES)),
                                 f.rule_id, f.location))


def render_text(findings: Sequence[Finding],
                whitelisted: Sequence[Finding] = ()) -> str:
    """Human rendering: one line per finding plus a summary tail."""
    lines = []
    for f in sort_findings(findings):
        lines.append(f"{f.severity.upper():7s} {f.rule_id}  {f.location}")
        lines.append(f"        {f.message}")
        if f.fix_hint:
            lines.append(f"        fix: {f.fix_hint}")
    n_err = sum(1 for f in findings if f.severity == ERROR)
    n_warn = sum(1 for f in findings if f.severity == WARNING)
    lines.append(f"qsmlint: {n_err} error(s), {n_warn} warning(s), "
                 f"{len(findings) - n_err - n_warn} info, "
                 f"{len(whitelisted)} whitelisted")
    return "\n".join(lines)


def render_json(findings: Sequence[Finding],
                whitelisted: Sequence[Finding] = (),
                meta: Optional[Dict] = None) -> str:
    """One JSON document — the ``--json`` archive form (the reference's
    document, key for key)."""
    doc = {
        "tool": "qsmlint",
        "errors": sum(1 for f in findings if f.severity == ERROR),
        "warnings": sum(1 for f in findings if f.severity == WARNING),
        "findings": [f.to_dict() for f in sort_findings(findings)],
        "whitelisted": [f.to_dict() for f in sort_findings(whitelisted)],
    }
    if meta:
        doc.update(meta)
    return json.dumps(doc)


# SARIF 2.1.0 (``--sarif PATH``): the interchange form CI diff viewers
# annotate pull requests from.  Deterministic output — sorted keys, no
# timestamps — so a golden-file test can pin the exact document.  It is
# the reference's document except for the tool's name, which names the
# port.

SARIF_TOOL_NAME = "qsmlint-torch"

_SARIF_LEVEL = {ERROR: "error", WARNING: "warning", INFO: "note"}
_SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                 "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")


def _sarif_location(location: str) -> dict:
    """``path:Class.fn:line`` / ``path:line`` → uri + startLine;
    semantic locations (``model:cas``) become a bare uri."""
    parts = location.split(":")
    uri, line = parts[0], None
    if len(parts) > 1 and parts[-1].isdigit():
        line = int(parts[-1])
    if "/" not in uri and not uri.endswith(".py"):
        uri, line = location, None  # model:/fixture: pseudo-locations
    phys: Dict = {"artifactLocation": {"uri": uri}}
    if line is not None:
        phys["region"] = {"startLine": line}
    return {"physicalLocation": phys}


def _sarif_result(f: Finding, suppressed: bool) -> dict:
    text = f.message if not f.fix_hint else f"{f.message} (fix: {f.fix_hint})"
    res: Dict = {
        "ruleId": f.rule_id,
        "level": _SARIF_LEVEL.get(f.severity, "none"),
        "message": {"text": text},
        "locations": [_sarif_location(f.location)],
    }
    if suppressed:
        res["suppressions"] = [{
            "kind": "external",
            "justification": "accepted via the reviewed .qsmlint "
                             "whitelist (docs/ANALYSIS.md)"}]
    return res


def render_sarif(findings: Sequence[Finding],
                 whitelisted: Sequence[Finding] = (),
                 meta: Optional[Dict] = None) -> str:
    """One SARIF 2.1.0 document; whitelisted findings ride along as
    suppressed results so the CI viewer shows the reviewed claims too."""
    rules = sorted({f.rule_id
                    for f in list(findings) + list(whitelisted)})
    results = ([_sarif_result(f, False) for f in sort_findings(findings)]
               + [_sarif_result(f, True)
                  for f in sort_findings(whitelisted)])
    # no informationUri: SARIF 2.1.0 requires it to be an ABSOLUTE
    # URI and this repo has no canonical URL; the rule docs pointer
    # rides each rule's helpUri-free id (docs/ANALYSIS.md)
    driver: Dict = {
        "name": SARIF_TOOL_NAME,
        "rules": [{"id": r} for r in rules],
    }
    if meta and meta.get("version"):
        driver["version"] = str(meta["version"])
    doc = {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{"tool": {"driver": driver}, "results": results}],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
