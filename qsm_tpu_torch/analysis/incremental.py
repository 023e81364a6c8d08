"""Incremental lint plumbing: git-diff scoping and the on-disk
per-file result cache (the counterpart of
``qsm_tpu/analysis/incremental.py``).

The lint gate runs constantly — every CI lane, every ``--changed``
developer loop, every ``chip_smoke.py`` run — over a tree that is
almost entirely unchanged between runs.  Findings of the AST pass
families are a pure function of (file content, analyzer source), so
they are cacheable by content digest:

* :func:`changed_files` — the ``--changed [REF]`` scope: repo-relative
  paths touched since ``REF`` (``git diff --name-only`` plus untracked
  files), or None when git is unavailable (callers fall back to the
  full tree rather than guessing).  Both subprocess calls are bounded
  (the QSM-RES-SUBPROC discipline applies to the analyzer itself).
* :class:`LintCache` — a JSON document mapping cache keys (family id +
  file path + content sha256) to finding rows.  The whole cache is
  keyed on an **analyzer fingerprint** (digest over
  ``qsm_tpu_torch/analysis/*.py``): editing any pass invalidates
  everything, so a rule change can never serve stale verdicts.  Writes
  go through ``resilience.checkpoint.atomic_write_text`` — the
  artifact-write primitive every other on-disk state in the port uses.

The port's cache is its own file, ``.qsmlint-torch-cache.json`` at the
repo root: the reference's ``.qsmlint-cache.json`` is never read or
written here, so the two analyzers can run at once without racing on
one file.

Dynamic/semantic families (spec parity, the rebuild guard, the edge
launches) are NOT cached: their results depend on executed code, not
file bytes alone.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
from typing import Dict, List, Optional, Sequence, Set

from .findings import Finding

_CACHE_VERSION = 1
_GIT_TIMEOUT_S = 10.0


def default_cache_path(repo_root: str) -> str:
    return os.path.join(repo_root, ".qsmlint-torch-cache.json")


def changed_files(repo_root: str, ref: str = "HEAD"
                  ) -> Optional[Set[str]]:
    """Repo-relative paths changed since ``ref`` (worktree + index)
    plus untracked files; None when git cannot answer (not a repo, no
    git, bad ref) — the caller then lints the full tree."""
    out: Set[str] = set()
    for cmd in (["git", "diff", "--name-only", ref],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            r = subprocess.run(cmd, cwd=repo_root, capture_output=True,
                               text=True, timeout=_GIT_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if r.returncode != 0:
            return None
        out.update(ln.strip() for ln in r.stdout.splitlines()
                   if ln.strip())
    return out


def file_digest(path: str) -> str:
    """sha256 of the file bytes; empty string for an unreadable file
    (which therefore never cache-hits)."""
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return ""


def combined_digest(paths: Sequence[str]) -> str:
    """Order-insensitive digest over a file set (the whole-program
    family's cache unit: any member changing invalidates the set)."""
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(p.encode())
        h.update(file_digest(p).encode())
    return h.hexdigest()


def analyzer_fingerprint() -> str:
    """Digest over the analysis package sources: a rule edit must
    invalidate every cached verdict."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for name in sorted(os.listdir(pkg)):
        if name.endswith(".py"):
            h.update(name.encode())
            h.update(file_digest(os.path.join(pkg, name)).encode())
    return h.hexdigest()


class LintCache:
    """Content-keyed finding cache (see module docstring)."""

    def __init__(self, path: str):
        self.path = path
        self.hits = 0
        self.misses = 0
        self._dirty = False
        self._entries: Dict[str, List[dict]] = {}
        self._fingerprint = analyzer_fingerprint()
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return
        if (doc.get("version") == _CACHE_VERSION
                and doc.get("analyzer") == self._fingerprint
                and isinstance(doc.get("entries"), dict)):
            self._entries = doc["entries"]

    def get(self, key: str) -> Optional[List[Finding]]:
        rows = self._entries.get(key)
        if rows is None:
            self.misses += 1
            return None
        self.hits += 1
        try:
            return [Finding.from_dict(r) for r in rows]
        except (TypeError, KeyError):
            self.misses += 1
            self.hits -= 1
            return None

    def put(self, key: str, findings: Sequence[Finding]) -> None:
        # a new digest for the same (family, file) supersedes the old
        # one — without this the cache grows a dead row per edit,
        # forever (keys are "fid:rel:sha256"; sha has no colon)
        prefix = key.rsplit(":", 1)[0] + ":"
        for stale in [k for k in self._entries
                      if k.startswith(prefix) and k != key]:
            del self._entries[stale]
        self._entries[key] = [f.to_dict() for f in findings]
        self._dirty = True

    def save(self) -> None:
        if not self._dirty:
            return
        from ..resilience.checkpoint import atomic_write_text

        doc = {"version": _CACHE_VERSION,
               "analyzer": self._fingerprint,
               "entries": self._entries}
        try:
            atomic_write_text(self.path, json.dumps(doc) + "\n")
            self._dirty = False
        except OSError:
            pass  # an unwritable cache degrades to a slower lint

    def stats(self) -> dict:
        return {"path": self.path, "hits": self.hits,
                "misses": self.misses}
