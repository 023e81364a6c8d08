"""``qsm_tpu_torch.analysis`` — the port's ``qsmlint`` static analyzer
(the counterpart of ``qsm_tpu/analysis``).

Pass families that catch defects which would waste time on the card or
give a wrong verdict, before a long run starts, keyed by the reference's
family ids and rule ids wherever a rule carries over:

* spec soundness (``spec_passes``, a): step_py/step_torch parity,
  domain consistency, declared-bound soundness, precondition
  reachability, projections;
* kernel hazards (``kernel_passes``, b): step_torch dtypes, host reads
  inside a kernel-launching loop, per-call kernel rebuilds (the
  reference's retrace check), and every launch plan against one block's
  shared memory and one SM's registers (the reference's VMEM envelope),
  with each kernel's largest plan launched once on the card;
* scheduler determinism (``sched_passes``, c): nondeterminism sources
  outside the seeded RNG, torch's global generator among them;
* resilience (``resilience_passes``, d): bare CUDA initialisation or
  enumeration outside a watchdog, subprocess waits without a timeout,
  scattered probe-timeout literals;
* serve (``serve_passes``, e), pool (``pool_passes``, f), shrink
  (``shrink_passes``, h), monitor (``monitor_passes``, k), generation
  (``gen_passes``, m) and the device-work queue (``devq_passes``, o):
  unbounded loops, queues, worker lifecycles, session buffers and
  accumulators;
* race (``race_passes`` over ``callgraph``, g; whole-program):
  lock-order cycles, unguarded shared writes, thread lifecycles and
  leaked descriptors across the serving stack, the resilience plane,
  the kernel builds and the scripts that drive them on the card;
* obs (``obs_passes``, i): spans closed by a ``with``, bounded metric
  identity;
* fleet (``fleet_passes``, j): bounded re-dispatch with failed-node
  exclusion, term/expiry-gated lease promotion, seeded joins and
  migrated leaves;
* protocol (``protocol_model`` + ``protocol_passes``, l;
  whole-program): the port's wire contract extracted as its own
  committed artifact (``PROTOCOL_TORCH.json`` / ``PROTOCOL_TORCH.md``)
  and enforced — unhandled or caller-less ops, field drift,
  ``_send``-bypassing egress, non-idempotent ops on retry paths, SHED
  docs carrying verdict keys, artifact drift;
* mesh (``mesh_passes``, n): no literal device count or slot, no host
  read inside a function that places shards.

The semantic families (a, b) run on the card unless the caller asks for
the CPU.  Families are registered declaratively in ``engine.FAMILIES``
(id, scan set, runner); ``--family c`` selects by id, ``--changed``
scopes to git-touched modules, and per-file findings are cached on disk
by content digest in the port's own ``.qsmlint-torch-cache.json``
(``incremental.py``).  The accepted findings are the port's own
``.qsmlint-torch``.

Entry points: :func:`run_lint` (the engine), ``python -m qsm_tpu_torch
lint`` (the CLI gate), tests/test_torch_lint.py and ``chip_smoke.py``'s
phase 23.
"""

from .findings import (ERROR, INFO, WARNING, Finding, Whitelist,
                       render_json, render_sarif, render_text,
                       sort_findings, split_whitelisted)
from .engine import (DEFAULT_DEVQ_FILES, DEFAULT_GEN_FILES,
                     DEFAULT_OPS_FILES, DEFAULT_POOL_FILES,
                     DEFAULT_PROTOCOL_FILES, DEFAULT_RACE_FILES,
                     DEFAULT_RESILIENCE_FILES, DEFAULT_SCHED_FILES,
                     DEFAULT_SERVE_FILES, DEFAULT_SHRINK_FILES, FAMILIES,
                     Family, LintReport, default_whitelist_path, run_lint)

__all__ = [
    "ERROR", "WARNING", "INFO", "Finding", "Whitelist", "LintReport",
    "run_lint", "render_text", "render_json", "render_sarif",
    "sort_findings", "split_whitelisted", "default_whitelist_path",
    "FAMILIES", "Family",
    "DEFAULT_OPS_FILES", "DEFAULT_SCHED_FILES",
    "DEFAULT_RESILIENCE_FILES", "DEFAULT_SERVE_FILES",
    "DEFAULT_POOL_FILES", "DEFAULT_SHRINK_FILES", "DEFAULT_GEN_FILES",
    "DEFAULT_DEVQ_FILES", "DEFAULT_RACE_FILES", "DEFAULT_PROTOCOL_FILES",
]
