#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``qsm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --against OLD.cu   # also time an earlier kernel
    python3 chip_smoke.py --against-stepper OLD_DIR  # earlier stepper kernels
    python3 chip_smoke.py --against-sweep OLD.cu     # an earlier stepper_sweep
    python3 chip_smoke.py --against-draws OLD.cu     # an earlier threefry_draws
    python3 chip_smoke.py --ablate-sweep   # where a kv16 iteration's cycles go

Phases, in order; any failure exits non-zero and no result is printed:

1. device: the card's name and power limit (``nvidia-smi``), the torch
   device name and count;
2. build: ``nvcc`` compiles every kernel from the sources in the checkout,
   one process a source, all started together; the ``-Xptxas -v``
   register / stack / spill lines are printed (a spill fails the run),
   beside the launch plans of phase 3 (lanes per block, shared bytes,
   what is staged in shared memory); then ``g++`` builds the native host
   oracle (``native/wg.cpp``), which must build: its status and build
   time are printed;
3. kernel against plain: ``dfs_chunk`` on the headline CAS corpus' step
   tables (32 ops x 8 pids) with mid-search carries, at 4096 and 16384
   lanes, memo off and at 64 slots, and on random 64-state tables at 4096
   lanes (too large to stage: ``nxt`` read from global memory), after 1
   and 4 chunks of 1024 iterations: every output plane must be
   bit-identical to ``dfs_chunk_plain`` on the same CUDA tensors
   (tolerance 0, all integer).  Then the kernel is timed with CUDA events
   and the plain version once.  With ``--against OLD.cu`` (an earlier
   ``dfs_chunk.cu`` whose C entry takes 19 pointers, 7 ints and the
   stream, without a launch plan), that kernel is built too and timed in
   turns with this one (old, new, new, old) on the same inputs, after
   both are checked equal;
4. checker (main path of ``TorchGPU``): ``TorchGPU.check_histories`` on
   512 unique histories replicated to 4096 lanes; 0 verdict mismatches
   against the memo oracle wherever both decided; witnesses replay
   through ``verify_witness``; one more warm run under ``torch.profiler``
   gives the device's busy time and idle share;
5. property (main path of ``TorchGPU``): ``prop_concurrent`` at 8 pids x
   32 ops, 100 trials, seed 0 — racy CAS convicted with a shrunk
   counterexample, atomic CAS passed — and the same racy run through the
   CLI entry point;
6. stepper kernels against plain (each case's launch plan printed
   first): ``stepper_chunk`` on the queue
   headline's tables (48 ops x 8 pids, 512 unique histories at 4096
   lanes, one batch-shared op-vocabulary table staged in shared memory),
   memo off and at the port's slot count for that bucket, from a fresh and
   from a mid-search carry, after 1 and 3 chunks of 2048 iterations at
   full width, and from the mid-search carry after each of 4 on a lane
   sample (one lane of every unique history still running, carried to the
   CPU by ``compact_carry_plain`` and advanced there by the plain
   version); on
   CAS histories of 64 and 128 ops at 1024 lanes after 1 and 2 chunks; and
   on CAS histories over 256 values (32 ops, 1024 lanes), whose table is
   too large to stage and is read from device memory;
   ``compact_carry`` with the memo grown (4096 -> 256 lanes), kept,
   shrunk with collisions, from a carry without a memo and to one without;
   every plane bit-identical to the plain version (tolerance 0).  Then
   each kernel is timed with CUDA events and its plain version once.  With
   ``--against-stepper DIR`` (a directory holding earlier
   ``stepper_chunk.cu`` and ``compact_carry.cu`` whose C entries take the
   per-history ``[R, S, N]`` tables: 12 pointers, 8 ints and the stream;
   15 pointers, 7 ints and the stream), those kernels are built too and
   timed in turns with these (old, new, new, old) on the same inputs, the
   old stepper fed the per-history tables expanded from the vocabulary,
   after both are checked equal; each compaction is also timed by its C
   entry alone, outputs made beforehand, without the wrappers' host work;
7. queue checker (main path of ``TorchStepper``): ``check_histories`` on
   the 512 unique queue histories replicated to 4096 lanes, at the
   default budget; 0 verdict mismatches against the memo oracle,
   witnesses replayed, one warm run profiled (histories/s, device busy
   time and idle share, rounds, compactions, launches of each kernel);
8. queue property (main path of ``TorchStepper``): ``prop_concurrent`` at
   8 pids x 48 ops, 100 trials — racy queue convicted with a shrunk
   counterexample, atomic queue passed — and the racy run again through
   ``python -m qsm_tpu_torch run --model queue --backend stepper``;
9. sweep kernel against plain: ``stepper_sweep`` on a KV map of 16 keys
   (64 ops x 16 pids, 512 unique histories at 4096 lanes) memo off and at
   the port's slot count, and on queue and stack of capacity 8, txn(8, 8)
   and a random vector spec of 9 elements at 1024 lanes, each from a
   mid-search carry: launched as the main path launches it (the running
   lanes alone) and over every lane, every plane bit-identical to
   ``stepper_sweep_plain`` at full width after 1 and 2 chunks of 1024
   iterations (KV) or 1 (the others), and on a lane sample (as in phase
   6) after each of 4 chunks (KV) or 2; each case's plan and how its
   running lanes fall on blocks and SMs, time per launch in turns (every
   lane, the running lanes alone), cycles an iteration of the longest
   lane at the SM clock, plain time and bound, and with the memo the
   probes whose filter tag matched; ``compact_carry`` on the KV carry with
   its bound.  With ``--against-sweep OLD.cu`` (an earlier
   ``stepper_sweep.cu`` whose C entry takes 14 pointers, 15 ints and the
   stream, without a lane list), that kernel
   is built too, checked equal, and timed in turns with this one (old,
   new, new, old) on every case's mid-search carry.  With
   ``--ablate-sweep`` the kv16 kernel is also timed against the number of
   running lanes launched and, in turns, against ablation builds of its
   source (``SWEEP_ABLATIONS``), each checked to leave the search as it
   is;
10. kv16 checker (main path of the sweep regime): ``TorchStepper`` on the
   512 unique KV histories at 4096 lanes, cold, warm and profiled; 0
   verdict mismatches against the port's memo oracle run on each key's
   register sub-history (``PComp(spec)``), witnesses replayed;
11. kv16 property: ``prop_concurrent`` at 16 pids x 64 ops, racy
   convicted, atomic passed;
12. milestones: KV at its default size (16 pids x 64 ops, a 256-state
   shadow) through ``TorchStepper``'s table regime, and the ticket
   dispenser (4 pids x 24 ops) through ``TorchGPU`` and ``TorchStepper``:
   each checker against its oracle and ``prop_concurrent`` racy and
   atomic;
13. per-key decomposition (main path of ``PComp`` over ``TorchStepper``):
   the kv16 corpus, the KV milestone's, and the registry defaults of
   multireg and multicas (16 pids x 64 ops), each at 4096 lanes, cold,
   warm and profiled: no lane undecided, 0 mismatches against the memo
   oracle per key, the whole-history checker's verdicts wherever it
   decided (phases 10 and 12; for multireg and multicas ``TorchStepper``
   on the unique corpus, run before the path), 8 stitched witnesses
   replayed; the split timed alone, sub-histories, device batches,
   launches; then ``prop_concurrent`` on kv16 through it, racy
   convicted, atomic passed, nothing undecided;
14. hybrid plan (main path of ``HybridDevice``): the CAS and queue
   headlines at 4096 lanes, budget 2000, the native oracle as the tail:
   verdicts equal to the memo oracle's, nothing undecided, no degrade,
   the device deciding some; then ``CppOracle`` against the memo oracle
   on each headline's 512 unique histories, verdicts equal, both timed.

   After each case of phases 13 and 14 its launches are read, then its
   kernels are held against their plain versions on the path's own
   inputs, recorded as the path ran (``FirstInputs``): one chunk of
   ``stepper_chunk`` from its first batch's fresh carry (its tables,
   bucket, op count, slots, chunk and budget) at full width on the card
   against the plain version on a lane sample on the CPU, and its first
   compaction against ``compact_carry_plain`` at full width (tolerance
   0);
15. generation plane: (a) ``threefry_draws`` against its plain version
   on the card at seeds 0, 7, 17, 2**31, 2**32 + 5, -3 and 1,000,004 and
   every ``DRAW_SHAPES`` (one word, rows of 3, 17, 33 and 4097 words that
   take 4-byte stores, more units than the grid, the main path's 1024 x
   816, 4096 x 624, 4096 x 3120), every word equal; tables off a 16-byte boundary (4-byte stores); the known answers of
   the JAX package's ``_raw_draws_jax``; the SASS of the hot loop
   (``cuobjdump -sass``: instructions a word); the kernel timed (CUDA
   events, queued behind a spin of the card, and through the wrapper
   back to back) at the main path's 1024 x 816, 4096 x 624 and 4096 x
   3120 beside its bound and the floor its SASS sets at the SM clock,
   with its plan, the plain version once.
   With ``--against-draws OLD.cu`` (an earlier ``threefry_draws.cu``
   whose C entry takes out, seed, lanes, draws and the stream) that
   kernel is built too, its ptxas report and SASS printed beside this
   one's, both checked equal, and timed in turns (old, new, new, old) at
   the three shapes; (b)
   ``generate_batch(path="jax")`` on the card for rangeset, semaphore and
   register (the families of ``tools/bench_gen.py``) at 8 pids x 32 ops
   and 4096 lanes: the table equal to the plain version's, 256 histories
   equal to the ``device="cpu"`` call's, the draw, the copy to the host
   (``table_to_host``, through pinned memory, as ``gen/core.py`` copies)
   and the assembly timed apart (``GenStages``), then the copy alone in
   turns with a pageable ``.cpu()`` at 1024 x 816 and 4096 x 816,
   after the first pinned call of each size; (c) the main path:
   ``SteeringLoop(spec, HybridDevice(spec), batch=1024, seed=17,
   path="auto")`` for 4 rounds a family (the loop's construction, which
   pins the copy's host block, timed apart), each round's stages timed
   and printed with its report, the first family's last round profiled;
   then each round's verdicts equal to ``CppOracle``'s with nothing
   undecided, every flip re-checked by a fresh memo oracle (0 missed,
   in worker processes), 64 LINEARIZABLE witnesses of the best profile's
   batch replayed, ``save``/``load`` giving an equal pool, the path's
   tables and its first ``stepper_chunk`` batch and compaction held
   against the plain versions;
16. search plane: (a) the CAS headline at 4096 lanes through
   ``TorchStepper(spec)`` at its defaults ("hand") and through the
   planned checker ``build_backend(spec, plan_search(spec,
   profile_corpus(corpus, spec)))`` (the port's CUDA plan: ordering on,
   ``SegDC`` with the native middle enumerator), each warm, timed and
   profiled, with its lockstep iterations a history; the planned path's
   final segments start outside the initial state and its middles are
   enumerated natively; 8 LINEARIZABLE witnesses of the ordered
   ``TorchStepper`` replayed; then ``TorchGPU(ordering=True)`` on the
   same lanes, its witnesses replayed; (b) ``AutoDevice`` on the CAS
   headline, CAS 8 x 128 and queue 8 x 96 (``tests/test_longcontext.py``'s
   generators, 512 unique at 4096 lanes) and kv16 (per key, through a
   nested router), each beside a plain ``TorchStepper`` on the same
   batch (on the 512 unique alone when that would pass 60 s), with each
   route's time by the widest middle segment of a history; (c)
   ``RootSplit`` escalation over ``TorchStepper(budget=2000)`` on the CAS
   headline; (d) ``SegDC`` over ``TorchStepper`` in the sweep regime
   (queue and stack of capacity 8, 8 x 48, 1024 lanes), final segments
   from vector frontier states; (e) after each path its launches are
   read and its kernels held against their plain versions on its own
   first inputs (``FirstInputs``: the first one or two ``stepper_chunk``
   batches, the first compaction, the first ``stepper_sweep`` and
   ``dfs_chunk`` launches; tolerance 0); (f) ``python -m qsm_tpu_torch
   stats --model cas --planned`` (the CUDA plan's name in its document)
   and ``run --model cas --backend auto-stepper`` (racy CAS convicted).
   Every verdict equal to ``CppOracle``'s wherever both decided;
17. entry points, exploration and fuzzing: (a) the CAS headline's 4096
   lanes written as a ``histories`` trace file and decided by ``python -m
   qsm_tpu_torch check --backend stepper`` and ``--backend gpu``, each in
   a subprocess and again through the CLI's ``main`` in this process
   (whose launches count here): verdicts equal to ``CppOracle``'s, the
   exit code the verdicts imply; ``check --witness`` on one history,
   ``witness_verifies`` true; (b) ``explore_many`` over generated programs
   of register, cas, set and queue (2 pids x 5 ops), atomic and racy,
   enough programs that each union passes 4096 histories (the trees
   walked over one ``ExplorePool``), each union decided in one
   ``TorchStepper`` call and, for the scalar-table specs, one
   ``TorchGPU`` call: decided verdicts equal to ``CppOracle``'s on the
   union, every atomic tree verified, racy convicted wherever the host
   oracle convicts; host enumeration against the device check, one union
   warm and profiled; then ``explore --model failover --crash-sweep
   primary:1-15 --backend stepper`` (atomic: ``all_verified``; racy at
   ``primary:2``: convicted) and ``explore --programs 64 --workers 4``
   equal to the serial run apart from ``seconds``, in subprocesses; (c)
   ``fuzz_parity`` on the card: random scalar tables (8 specs x 512
   histories, 4 pids x 10 ops, arms memo, cpp, device, pallas, segdc,
   auto, hybrid) and random vector specs at ``vector_bounds=(7,) * 7``
   (4 x 256, 8 ops; memo, device, hybrid): 0 mismatches, the cpp arm
   native and the hybrid arm's tail used, time by arm; (d) after each
   in-process path its launches are read and its kernels held against
   their plain versions on its own first inputs (``FirstInputs``,
   tolerance 0); ``stepper_chunk``, ``compact_carry``, ``dfs_chunk`` and
   ``stepper_sweep`` each launched on the phase; (e) ``run --p-drop 0.05
   --save-regression`` (racy CAS convicted, every fault flag in the
   replay hint), ``replay --regression`` (bit-identical), and ``run
   --transport tcp --workers 2`` against the memory transport (the same
   counterexample), in subprocesses;
18. resilience and the history shrinker: (a) ``shrink_history`` on the
   first 8 violating histories of the CAS headline through
   ``TorchStepper(spec)``, through the planned checker
   (``build_backend(spec, plan_search(spec, profile_corpus([h], spec),
   platform="cuda"))``) and on the host default: every minimised history
   a VIOLATION by ``CppOracle``, every certificate verified
   (``verify_certificate``), every frontier batch one ``check_histories``
   call, and wherever the device left no lane undecided the history,
   rounds, ``lanes_checked`` and ``one_minimal`` of the host shrink;
   rounds, lanes, engine calls, memo hits and time by backend printed;
   then a kv16 violation through its plan (``PComp`` first; the first of
   the corpus whose certificate holds a stitched witness) and through
   ``HybridDevice`` (``TorchStepper`` over whole histories, the sweep
   regime, at budget 2000; ``PComp`` on the host for the rest), and the
   ``shrink
   --trace --certificate`` entry point in this process on the first
   headline violation (the planned checker on the card: the planned
   shrink's result, its certificate audited); (b) ``run
   --minimize --backend stepper`` on racy CAS 8 x 32 (100 trials, seed 0)
   in this process: convicted, the printed minimised history the
   shrinker's on the regression file's history, a VIOLATION by
   ``CppOracle``, the regression replayed, and ``--backend cpp`` printing
   the same; (c) ``FailoverBackend(TorchStepper)`` on the headline's 4096
   lanes under ``QSM_TPU_FAULTS=raise:dispatch@2`` from a side stream
   (verdicts exact, 1024 lanes on the card and 3072 on ``CppOracle``, one
   degrade; its first launch from the watchdog's thread on the caller's
   stream), under ``hang:dispatch@1`` (a 3 s hang, a 1 s watchdog: the
   degrade goes through the watchdog), the card's rule (a
   ``BackendUnavailable`` the plane did not inject raises out of the
   wrapper and ``prop_concurrent``), ``stats --failover --backend
   stepper`` (a resilience block of zeros), what the wrap costs a
   4-lane dispatch of the CAS and of the queue headline (in turns: bare, bare on a new thread a call and on
   one reused thread, wrapped with no watchdog, wrapped with a new
   watchdog thread a dispatch and wrapped as it ships, with the process'
   one watchdog worker; a fresh engine and its first dispatch, bare and
   wrapped;
   beside the watchdog's empty calls) and, in a subprocess, ``run
   --failover --backend stepper`` under ``raise:dispatch@3`` (convicted,
   one degrade in the log); (d) ``build_kernel``'s ``check_one`` on
   bench-corpus history #35 at budget 500,000, 4096 memo slots (FAILURE
   in under 50,000 iterations) and none (BUDGET at exactly 500,000): one
   ``stepper_chunk`` launch each, timed with CUDA events beside its bound,
   held against the plain version on the card (to completion with the
   memo, over the first 5,000 iterations without); each path's launches
   read and its first kernels held (``FirstInputs``);
19. observability, the streaming monitor and trace ingest: (a) 128
   unique histories each of the CAS headline (8 x 32), the queue
   headline (8 x 48) and kv16 (16 x 64, per key over the projected
   register spec) streamed as rows into ``MonitorSession``s of one
   ``SessionManager`` a family (one window engine a spec, on the card),
   8 rows a decide (16 for kv16): every final verdict equal to
   ``CppOracle``'s whole-history verdict, no flip on a history it calls
   LINEARIZABLE; window-engine calls, lanes a call, BUDGET lanes decided
   again on the host, s a decide, and the first 8 histories again under
   ``torch.profiler`` (idle share); (b) ``tools/bench_monitor.py``'s
   1000-event register stream, 20 rows a decide, on the card and with
   ``device="cpu"`` in turns (card, host, host, card), then replayed
   into a fresh session sharing the ``VerdictCache``: ``prefix_hits ==
   advances``; (c) ``python -m qsm_tpu_torch monitor`` in a subprocess
   on a Jepsen log of that stream (written by ``emit_trace``) with a
   third pid's read of a value never written seeded in its middle:
   exit 1, the flip's repro a VIOLATION by ``CppOracle`` whose
   certificate verifies, ``check`` of the ``--save`` file a VIOLATION;
   (d) ``ingest --check`` on the five goldens of ``tests/data/`` on the
   card, each equal to ``--device cpu``'s line, and ``--emit``
   byte-stable; (e) an ``Observability`` sink installed (``set_global``)
   around phase 18 (c)'s ``raise:dispatch@2`` failover on 4096 lanes:
   the trace log holds ``fault.hit`` and ``failover.degrade``, ``python
   -m qsm_tpu_torch trace '' --log`` renders them (exit 0), and the
   registry's exposition parses back to the counts recorded; each
   path's launches read and its first kernels held (``FirstInputs``);
20. the check server: (a) in-process ``CheckServer`` on the card
   (``flush_s=0.005``, ``max_lanes=64``), four concurrent
   ``CheckClient``s sending requests of 64 histories: the CAS headline
   (512 unique at 4096 lanes, witnesses of 64 lanes replayed), the queue
   headline (4096 lanes) and kv16 (512, split per key over the projected
   register spec); each pass's verdicts equal to ``CppOracle``'s
   (``PComp`` for kv16) and a second pass all cached; histories/s served
   against the same planned engine called directly on the same lanes,
   flushes, lanes a flush, padded lanes, BUDGET lanes resolved, request
   latency by verb (four served shrinks, two served sessions); kv16 again
   on a server with ``pcomp=False`` (``stepper_sweep``), the unique CAS
   histories on one with ``engine_factory`` ``TorchGPU`` (``dfs_chunk``),
   and the CAS pass at ``max_lanes=1024`` under ``torch.profiler``;
   (b) ``python -m qsm_tpu_torch serve --warm cas,queue,kv --replog-dir
   --devq-dir --trace-log --metrics-port 0`` in a subprocess (started
   beside (a)), its banner parsed, then ``submit`` (a subprocess),
   ``health``, ``stats --serve --watch`` (totals equal to ``/metrics``),
   ``shrink --addr`` (equal to the in-process planned shrink, its
   certificate verified), ``monitor --addr`` on phase 19's seeded Jepsen
   log (the flip of phase 19's subprocess), ``ingest --submit``, ``trace
   --addr`` and ``fuzz --addr`` (2 rounds of cas and queue, 0 wrong
   verdicts, exit 0) in this process, ``shutdown``; restarted on the same
   directories it answers the banked verdicts cached and takes (d)'s
   ``devq.drain_report``, its ``health`` then carrying
   ``window_utilization``; (c) under ``raise:serve@2`` one batch degrades
   with exact verdicts, and an engine on the card raising a real error
   answers ``ok: false``, nothing decided on the host; (d) one
   ``DeviceWorkQueue`` (an in-process server's, on (b)'s devq directory)
   banks an oversize check corpus, the planner's warm-up, a small-budget
   shrink round's undecided frontier and a monitor flip's re-check;
   ``DrainScheduler`` drains it on the card with a 10 s deadline: 0 wrong
   verdicts, every lane banked under its key, ``window_utilization``
   printed; a second drain handed the same items on the journal
   re-dispatches none.  Each in-process path's launches read and its
   first kernels held (``FirstInputs``).
21. the fleet tier: (a) two ``CheckServer`` nodes on the card (replogs,
   phase 20's widths) behind a ``FleetRouter`` in this process: the CAS
   and queue headlines (4096 lanes each) and kv16's 512 routed from four
   clients in requests of 64, every lane stamped with the node that
   decided it, both nodes deciding lanes, 0 verdicts off ``CppOracle``'s
   (``PComp`` for kv16), the paths' first kernels held against the plain
   versions, histories/s against phase 20's single server and the direct
   engine, the queue pass under ``torch.profiler`` (idle share), the
   router building no ladder; (b) the same CAS burst again with both
   nodes alive on the warm caches, then the busier node stopped mid-way
   through it: its lanes re-dispatched to the survivor, verdicts equal
   to (a)'s, the node loss's cost the second burst's time less the
   first's; then both nodes stopped: the router's ladder (the planned
   checker behind ``FailoverBackend``) decides the 4096 lanes in this
   process on the card (``stepper_chunk`` launched), the queue
   headline's unique histories on a ladder starved to budget 8 have
   their BUDGET lanes decided again on the exact host checker (verdicts
   ``CppOracle``'s), and a shrink and a session (its session rung) run
   through the router with no node alive; (c) two routers on one lease file (TTL 1 s), the active taken
   down without releasing it: the standby's takeover time, and a client
   on ``A,B`` getting (a)'s verdicts bit for bit; two nodes given each
   other as ``peers=`` converge their replogs with no router alive; (d)
   ``python -m qsm_tpu_torch fleet --nodes 2`` (spawned nodes, each its
   own CUDA context) with ``submit --addr ROUTER``, ``stats --serve
   ROUTER --fleet`` (each node ``device cuda`` with searches counted) and
   ``health --addr ROUTER``; ``soak --sessions 256`` (cut from its
   default 1000 for the run's time; started after (b)'s timings, it
   runs beside the starved ladder, (c) and (d)) must report ``gate_ok`` and its fuzz rounds must have drawn
   on the card;
22. the mesh: (a) ``make_mesh()`` spans ``torch.cuda.device_count()``
   cards; ``sharded_backend(spec, profile=...)`` at that width gives the
   CAS headline's 4096 verdicts of phase 16's planned engine (on one card
   the same plan and engine: an identity there, not a mesh check);
   ``make_mesh`` and ``CheckServer(mesh_devices=...).start()`` one card
   wider raise with the count; (b) a logical 4-shard mesh of ``cuda:0``
   (``card_shard_mesh(4)``, a stream a shard) under ``TorchStepper`` on
   the CAS and queue headlines and kv16 whole (4096 lanes, the sweep
   regime), and under ``PComp`` on kv16 per key: verdicts equal to 1
   device and 0 off ``CppOracle`` (``PComp`` over it for kv16), every
   lane's status, ``chosen`` and iterations equal to 1 device (kv16 per
   key: over the sub-histories of its 512 unique histories), 8 witnesses
   replayed, compactions and the lanes they moved across shards (more
   than 0 on the queue path), launches by shard, each shard's first
   ``stepper_chunk``, ``compact_carry`` and ``stepper_sweep`` inputs held
   against the plain versions (``ShardInputs``), and histories/s at 4
   shards against 1, the split's cost on one card.  ``--mesh-only`` runs
   phases 1, 2 and 22 alone and prints no result.
23. the static checks (``qsm_tpu_torch/analysis``): (a)
   ``run_lint(device="cuda")`` over families a-f, h, m and o with no
   unwhitelisted error or warning (each family's seconds and the rule
   counts printed); (b) family a's ``step_py`` / ``step_torch`` parity on
   the card for every registry model (states and tuples printed); (c) the
   rebuild guard's three backends (``TorchGPU`` and ``TorchStepper`` on
   CAS, ``TorchStepper``'s sweep regime on kv16) grow no compile, library
   load or cache after their warm call, and the seeded
   ``RebuildingTorchStepper`` is caught; (d) the SMEM/REGS pass over the
   five ptxas reports of phase 1's build and each kernel launched once at
   its largest admitted plan, bit-identical to its plain version; (e)
   ``python -m qsm_tpu_torch lint --json`` in a subprocess (started first,
   beside (a)-(d)) exits 0.  ``--lint-only`` runs phases 1, 2 and 23
   alone and prints no result.

The lane samples of phases 6, 9 and 13-22 advance in worker processes
(``sample_pool``, spawned at the start; a sample's lanes split among
them) while this process drives the card; each is compared after the
chunks it mirrors.  In phases 3, 6 and 9 the plain versions' chunks at
full width on the card, but the one each case times, run as CUDA graphs
of their own operations (``graphed_plain``): the host's launches are
their cost.

Each main path's launch counts are reset just before it and read just
after (``dfs_chunk`` over phases 4-5, ``stepper_chunk`` and
``compact_carry`` over phases 7-8, ``stepper_sweep`` and
``compact_carry`` over phases 10-11, each milestone's kernels over its
own path, each case of phases 13 and 14 over its own, and
``threefry_draws``, ``stepper_chunk`` and ``compact_carry`` over phase
15 (c), each path of phase 16 over its own, phase 17's in-process
paths over the phase, each path of phases 18, 19, 20, 21 and 22 over
its own, with phase 22's launches by shard as paths of their own, and
phase 23's (a)-(d) as the path "lint (phase 23)"; the
kernels record lists those of phases 7-8 under
``launches``
and every path's under ``launches_by_path``).  The second-to-last stdout line is the
kernels record, the last the device record.  Every number is printed
beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import math
import os
import random
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from qsm_tpu_torch import native
from qsm_tpu_torch.core.generator import generate_program as gen_program
from qsm_tpu_torch.core.history import bucket_for, encode_batch
from qsm_tpu_torch.core.property import PropertyConfig, prop_concurrent
from qsm_tpu_torch.gen import GenProfile, SteeringLoop, generate_batch
from qsm_tpu_torch.gen import core as gen_core
from qsm_tpu_torch.gen import steer as gen_steer
from qsm_tpu_torch.mesh.shards import cat_lanes, take_lanes
from qsm_tpu_torch.models.cas import AtomicCasSUT, CasSpec, RacyCasSUT
from qsm_tpu_torch.models.counter import (AtomicTicketSUT, RacyTicketSUT,
                                          TicketSpec)
from qsm_tpu_torch.models.kv import AtomicKvSUT, KvSpec, StaleCacheKvSUT
from qsm_tpu_torch.models.queue import (AtomicQueueSUT, QueueSpec,
                                        RacyTwoPhaseQueueSUT)
from qsm_tpu_torch.models.registry import MODELS, SutFactory
from qsm_tpu_torch.models.registry import make as make_model
from qsm_tpu_torch.models.stack import (AtomicStackSUT, RacyTwoPhaseStackSUT,
                                        StackSpec)
from qsm_tpu_torch.models.txn import (AtomicTxnSUT, TornCopyTxnSUT,
                                      TxnRegisterSpec)
from qsm_tpu_torch.ops import kernels
from qsm_tpu_torch.ops import gpu_backend as gpu_module
from qsm_tpu_torch.ops import stepper as stepper_module
from qsm_tpu_torch.ops.backend import (BackendUnavailable, Verdict,
                                       verify_witness)
from qsm_tpu_torch.ops.dfs_kernel import (MEMO_GLOBAL, MEMO_SHARED, RUNNING,
                                          SMEM_BLOCK_MAX,
                                          Carry, blocks_per_sm, dfs_chunk,
                                          dfs_chunk_plain, launch_plan)
from qsm_tpu_torch.ops.draws_kernel import (draws_plan, raw_draws,
                                            raw_draws_plain,
                                            reserve_host_table, seed_word,
                                            table_to_host, threefry_draws)
from qsm_tpu_torch.ops.gpu_backend import TorchGPU, fresh_carry, lane_tables
from qsm_tpu_torch.ops.host_contracts import flatten
from qsm_tpu_torch.ops.hybrid import HybridDevice
from qsm_tpu_torch.ops.pcomp import PComp, split_history
from qsm_tpu_torch.ops.rootsplit import RootSplit
from qsm_tpu_torch.ops.router import AutoDevice, _width
from qsm_tpu_torch.ops.scalarize import scalar_shadow
from qsm_tpu_torch.ops.segdc import SegDC, split_at_quiescent_cuts
from qsm_tpu_torch.ops.stepper import TorchStepper, default_slots
from qsm_tpu_torch.ops.stepper_kernel import (ITERS, STATUS, StepperCarry,
                                              build_kernel, compact_carry,
                                              compact_carry_plain,
                                              device_sms,
                                              fresh_stepper_carry, key_words,
                                              n_words, pack_words,
                                              stepper_blocks_per_sm,
                                              stepper_chunk,
                                              stepper_chunk_plain,
                                              stepper_launch_plan,
                                              stepper_tables, table_bytes)
from qsm_tpu_torch.ops.sweep_kernel import (fresh_sweep_carry, stepper_sweep,
                                            stepper_sweep_plain,
                                            sweep_launch_plan, sweep_model,
                                            sweep_tables)
from qsm_tpu_torch.ops.wing_gong_cpu import WingGongCPU
from qsm_tpu_torch.resilience import faults as faults_mod
from qsm_tpu_torch.resilience.failover import FailoverBackend
from qsm_tpu_torch.resilience.policy import Watchdog, preset, watchdog
from qsm_tpu_torch.search import (collect_search_stats, ordering_table,
                                  permute_history)
from qsm_tpu_torch.sched.systematic import explore_many
from qsm_tpu_torch.search.planner import (CUDA_PLAN, build_backend,
                                          plan_search, profile_corpus)
from qsm_tpu_torch.utils import cli
from qsm_tpu_torch.utils.corpus import build_corpus, random_lane_tables
from qsm_tpu_torch.utils.fuzz import (RandomVectorSpec, fuzz_parity,
                                      random_history)
from qsm_tpu_torch.shrink import (minimality_certificate, shrink_history,
                                  verify_certificate)
from qsm_tpu_torch.utils.interop import history_from_rows, history_to_rows
from qsm_tpu_torch.utils.report import format_history

N_PIDS, N_OPS = 8, 32          # the headline configuration
N_UNIQUE, DEVICE_BATCH = 512, 4096
CHUNK = TorchGPU.CHUNK
TOTAL_BUDGET = 552_000         # TorchGPU's default per-lane cap
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# peak for the kernel's 32-bit scalar ALU ops: the "float32 outside the
# tensor cores" rate of the H100 SXM data sheet (no int32 row is
# published); a generous peak keeps the bound a lower bound
SCALAR_OPS_PER_S = 67e12
RANDOM_STATES = 64             # the global-table case: nxt is not staged
Q_PIDS, Q_OPS = 8, 48          # the queue headline (the registry default)
STEP_CHUNK = 2048              # stepper iterations a launch in phase 6
COMPACT_TO = 256               # phase 6's compaction: 4096 lanes -> 256
WIDE_CAS_VALUES = 256          # phase 6's table too large to stage
KV_KEYS, KV_PIDS, KV_OPS = 16, 16, 64   # the sweep regime's KV headline
SWEEP_CHUNK = 1024             # stepper_sweep iterations a launch, phase 9
SWEEP_MID = 256                # plain iterations before phase 9's carries
SAMPLE_LANES = 192             # lanes of a sample held on the CPU
# chunks after which phases 3, 6 and 9 hold a kernel against its plain
# version: the plain loops are those phases' cost, cut from 8 to keep the
# whole run well inside its time limit
HELD_DFS_CHUNKS = 4            # phase 3: after the first and the last
HELD_SAMPLE_CHUNKS = 4         # phases 6 and 9: after each, on a sample
TICKET_PIDS, TICKET_OPS = 4, 24          # the ticket milestone


def ops_per_iteration(n_ops: int) -> int:
    """Integer ops of one DFS iteration, counted from the kernel source:
    the blocked-op sweep costs 5 per op (and, compare, select, shift, or),
    the rest of the iteration (candidate mask, first candidate, memo
    probe, stack update, status, budget) about 40."""
    return 5 * n_ops + 40


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def carry_bytes(c: Carry) -> int:
    return sum(t.numel() * t.element_size() for t in c)


def kernel_bound(tabs, c_in: Carry, c_out: Carry):
    """(bound_ms, bound_by, bytes, ops): each input read once, each
    output written once, against the iterations this run's data needed."""
    nbytes = (sum(t.numel() * t.element_size() for t in tabs)
              + carry_bytes(c_in) + carry_bytes(c_out))
    iters = int((c_out.dsi[2].long() - c_in.dsi[2].long()).sum())
    ops = iters * ops_per_iteration(tabs.nxt.shape[1])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def new_kernel(tabs, carry, cs) -> Carry:
    return dfs_chunk(tabs, carry, chunk=CHUNK, budget=TOTAL_BUDGET,
                     cache_slots=cs)


def time_kernel(tabs, carry, cs, launch=new_kernel, reps=20) -> float:
    """Mean ms per launch over ``reps`` warm launches of ``launch`` on the
    same inputs (CUDA events)."""
    for _ in range(3):
        launch(tabs, carry, cs)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        launch(tabs, carry, cs)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_plain(tabs, carry, cs) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dfs_chunk_plain(tabs, carry, chunk=CHUNK, budget=TOTAL_BUDGET,
                    cache_slots=cs)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


GRAPH_TRIPS = 64               # plain-version trips in one captured CUDA graph


def graphed_plain(fn, carry, chunk: int):
    """``chunk`` trips of a plain version on the card: ``fn(carry, chunk=,
    early_exit=)`` is the plain version bound to its tables and budget.
    Its cost is the host launching each trip's small operations, so the
    trips are captured once as a CUDA graph of ``GRAPH_TRIPS`` trips,
    without the early exit (a trip after every lane decided is a no-op),
    and the graph is replayed; the rest run as they are.  The same
    PyTorch operations on the same tensors: ``carry`` is advanced in
    place and returned.  The plain times this script reports are of
    plain runs, never of a graph."""
    def run(n, early_exit):
        out = fn(carry, chunk=n, early_exit=early_exit)
        for dst, src in zip(carry, out):
            if dst is not src:       # a plain version that returns anew
                dst.copy_(src)

    trips, rest = divmod(chunk, GRAPH_TRIPS)
    if trips:
        # a warm-up on a copy, off the capture: first-use work (tables
        # cached on the device) must not be captured
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(type(carry)(*(t.clone() for t in carry)), chunk=GRAPH_TRIPS,
               early_exit=False)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run(GRAPH_TRIPS, False)
        for _ in range(trips):
            graph.replay()
    if rest:
        run(rest, True)
    return carry


def profile_device(fn):
    """(wall_s, device_s, top) of ``fn()`` under ``torch.profiler``:
    ``device_s`` sums the CUDA kernels' own time (0.0 if the profiler saw
    none), ``top`` the three kernels that took most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kern.sort(key=lambda e: -e.self_device_time_total)
    top = [dict(name=e.key[:60], calls=e.count,
                device_s=e.self_device_time_total / 1e6) for e in kern[:3]]
    return wall, sum(e.self_device_time_total for e in kern) / 1e6, top


def plan_text(B, S, cs) -> str:
    p = launch_plan(B, N_OPS, S, cs)
    memo = {MEMO_SHARED: "memo in shared", MEMO_GLOBAL: "memo in global"
            }.get(p.memo, "memo off")
    return (f"B={B} S={S} slots={cs}: {p.lanes_per_block} lanes/block, grid "
            f"{p.grid}, {p.smem_bytes} shared bytes/block, "
            f"{blocks_per_sm(p)} blocks/SM; okw, stacks, succ in shared, "
            f"{memo}, nxt in {'shared' if p.stage_nxt else 'global'}")


def kernel_cases(spec, corpus, dev):
    """(name, B, tables, start states) of phase 3: the headline CAS tables
    at 4096 and 16384 lanes, and random 64-state tables at 4096."""
    for B in (4096, 16384):
        lanes = (corpus * math.ceil(B / len(corpus)))[:B]
        yield "cas", B, lane_tables(spec, lanes, N_OPS, B, dev), \
            np.zeros(B, np.int32)
    B = 4096
    starts = np.random.default_rng(0).integers(0, RANDOM_STATES, B)
    yield (f"random{RANDOM_STATES}", B,
           random_lane_tables(N_OPS, RANDOM_STATES, B, seed=0, device=dev),
           starts.astype(np.int32))


def phase_kernel(spec, corpus, dev, tag):
    """Phase 3: dfs_chunk against dfs_chunk_plain, then timings."""
    max_err = 0
    timings = []
    for name, B, tabs, starts in kernel_cases(spec, corpus, dev):
        for cs in (0, 64):
            fresh = fresh_carry(tabs.nreq, starts, N_OPS, cs)
            plain = functools.partial(dfs_chunk_plain, tabs,
                                      budget=TOTAL_BUDGET, cache_slots=cs)
            # mid-search: a quarter chunk in, the hard lanes still running
            mid = graphed_plain(plain, Carry(*(t.clone() for t in fresh)),
                                CHUNK // 4)
            running = int((mid.dsi[1] == RUNNING).sum())
            require(running > 0, "mid-search carry has no running lane")
            ck, cp = mid, Carry(*(t.clone() for t in mid))
            for i in range(HELD_DFS_CHUNKS):
                ck = dfs_chunk(tabs, ck, chunk=CHUNK, budget=TOTAL_BUDGET,
                               cache_slots=cs)
                graphed_plain(plain, cp, CHUNK)
                if i in (0, HELD_DFS_CHUNKS - 1):
                    torch.cuda.synchronize()
                    for plane, a, b in zip(Carry._fields, ck, cp):
                        err = int((a.long() - b.long()).abs().max())
                        max_err = max(max_err, err)
                        require(err == 0, f"dfs_chunk {plane} differs from "
                                f"plain on {name} at B={B} slots={cs} after "
                                f"{i + 1} chunk(s) (max abs err {err})")
            print(f"{tag} dfs_chunk == plain on {name} tables at B={B} "
                  f"slots={cs}: all 7 planes bit-identical after 1 and "
                  f"{HELD_DFS_CHUNKS} chunks ({running} lanes running at "
                  f"the start)",
                  flush=True)
            one = dfs_chunk(tabs, mid, chunk=CHUNK, budget=TOTAL_BUDGET,
                            cache_slots=cs)
            bound_ms, bound_by, nbytes, ops = kernel_bound(tabs, mid, one)
            ms = time_kernel(tabs, mid, cs)
            row = dict(tables=name, B=B, slots=cs, ms=ms, bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes, ops=ops,
                       running_lanes=running, tabs=tabs, mid=mid)
            if B == 4096:  # the plain version once, at the headline width
                row["plain_ms"] = time_plain(tabs, mid, cs)
            timings.append(row)
            print(f"{tag} dfs_chunk {name} B={B} slots={cs}: {ms:.4f} "
                  f"ms/launch "
                  f"of {CHUNK} iterations (bound {bound_ms:.6f} ms by "
                  f"{bound_by}: {nbytes} B, {ops} ops; plain "
                  f"{row.get('plain_ms', float('nan')):.1f} ms)",
                  flush=True)
    return max_err, timings


def old_kernel(src: Path):
    """A launcher for the earlier kernel at ``src``, built like this one,
    through its first C entry (19 pointers, 7 ints, the stream)."""
    lib = ctypes.CDLL(str(kernels.build("dfs_chunk_against", src=src)))
    fn = lib.dfs_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(tabs, carry, cs) -> Carry:
        S, N, B = tabs.nxt.shape
        out = Carry(*(torch.empty_like(t) for t in carry))
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in tabs),
                *(t.data_ptr() for t in carry),
                *(t.data_ptr() for t in out), B, N, S, carry.ck0.shape[0],
                cs, CHUNK, TOTAL_BUDGET, stream)
        require(rc == 0, f"the earlier kernel's launch failed ({rc})")
        return out
    return launch


def phase_against(src: Path, timings, tag):
    """The earlier kernel and this one in turns (old, new, new, old) on
    each phase-3 case's mid-search carry, after checking them equal."""
    old = old_kernel(src)
    for line in kernels.ptxas_report("dfs_chunk_against", src).splitlines():
        if any(k in line for k in ("registers", "stack frame")):
            print(f"  ptxas (earlier kernel): {line.strip()}")
    for row in timings:
        tabs, mid, cs = row["tabs"], row["mid"], row["slots"]
        a, b = old(tabs, mid, cs), new_kernel(tabs, mid, cs)
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(a, b)),
                f"the earlier kernel differs on {row['tables']} B={row['B']}")
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(time_kernel(
                tabs, mid, cs, launch=old if who == "old" else new_kernel))
        o, n = (sum(turns[k]) / 2 for k in ("old", "new"))
        row["old_ms"] = o
        print(f"{tag} earlier vs this dfs_chunk, {row['tables']} "
              f"B={row['B']} slots={cs} (old, new, new, old): "
              f"old {turns['old'][0]:.4f}/{turns['old'][1]:.4f} ms, new "
              f"{turns['new'][0]:.4f}/{turns['new'][1]:.4f} ms per launch; "
              f"old/new {o / n:.2f}x", flush=True)


def phase_checker(spec, corpus, tag):
    """Phase 4: the checker on the headline corpus."""
    g = TorchGPU(spec)
    device_corpus = (corpus * math.ceil(DEVICE_BATCH / len(corpus))
                     )[:DEVICE_BATCH]
    t0 = time.perf_counter()
    cold = g.check_histories(spec, device_corpus)
    cold_s = time.perf_counter() - t0
    launches0, cost0 = g.chunk_launches, g.lockstep_cost
    t0 = time.perf_counter()
    v = g.check_histories(spec, device_corpus)
    warm_s = time.perf_counter() - t0
    launches, cost = g.chunk_launches - launches0, g.lockstep_cost - cost0
    require(v.tolist() == cold.tolist(), "verdicts differ between runs")
    prof_wall, busy_s, top = profile_device(
        lambda: g.check_histories(spec, device_corpus))
    t0 = time.perf_counter()
    ov = WingGongCPU(memo=True).check_histories(spec, corpus)
    oracle_s = time.perf_counter() - t0
    uv = v[:len(corpus)]
    both = (uv != Verdict.BUDGET_EXCEEDED) & (ov != Verdict.BUDGET_EXCEEDED)
    mismatches = int(((uv != ov) & both).sum())
    require(mismatches == 0, f"{mismatches} verdict mismatches vs oracle")
    lin = [h for h, x in zip(corpus, uv) if x == Verdict.LINEARIZABLE][:32]
    for h in lin:
        wv, wit = g.check_witness(spec, h)
        require(wv == Verdict.LINEARIZABLE and verify_witness(spec, h, wit),
                "a LINEARIZABLE witness failed to replay")
    undecided = int((v == Verdict.BUDGET_EXCEEDED).sum())
    print(f"{tag} checker: {len(device_corpus)} histories ({len(corpus)} "
          f"unique) warm {warm_s:.3f} s = "
          f"{len(device_corpus) / warm_s:.1f} histories/s (cold "
          f"{cold_s:.3f} s); chunk_launches {launches}, lockstep_cost "
          f"{cost}, undecided {undecided}; vs memo oracle ({oracle_s:.2f} s "
          f"on the host): 0 mismatches "
          f"({int((uv == Verdict.LINEARIZABLE).sum())} linearizable, "
          f"{int((uv == Verdict.VIOLATION).sum())} violations); "
          f"{len(lin)} witnesses replayed", flush=True)
    idle = f"{1 - busy_s / prof_wall:.3f}" if busy_s else "not measured"
    print(f"{tag} checker profiled: wall {prof_wall:.3f} s, device busy "
          f"{busy_s:.3f} s, idle share {idle}; top kernels {top}",
          flush=True)
    return warm_s


def phase_property(spec, tag):
    """Phase 5: the property loop, racy convicted, atomic passed."""
    for impl, sut_cls, want_ok in (("racy", RacyCasSUT, False),
                                   ("atomic", AtomicCasSUT, True)):
        g = TorchGPU(spec)
        cfg = PropertyConfig(n_trials=100, n_pids=N_PIDS, max_ops=N_OPS,
                             seed=0)
        t0 = time.perf_counter()
        res = prop_concurrent(spec, sut_cls(spec), cfg, backend=g)
        dt = time.perf_counter() - t0
        require(res.ok == want_ok and res.undecided == 0,
                f"{impl} CAS: ok={res.ok} undecided={res.undecided}")
        what = ""
        if not want_ok:
            cx = res.counterexample
            require(cx is not None and cx.shrink_steps > 0
                    and len(cx.program) < N_OPS,
                    "racy CAS counterexample was not shrunk")
            what = (f", counterexample {len(cx.program)} ops after "
                    f"{cx.shrink_steps} shrink steps")
        print(f"{tag} property {impl} CAS {N_PIDS} pids x {N_OPS} ops: "
              f"ok={res.ok} after {res.trials_run} trials, "
              f"{res.histories_checked} histories, {dt:.2f} s, "
              f"{g.chunk_launches} chunk launches{what}", flush=True)
    rc = cli.main(["run", "--model", "cas", "--impl", "racy", "--backend",
                   "gpu", "--trials", "100", "--pids", str(N_PIDS),
                   "--ops", str(N_OPS)])
    require(rc == 1, f"the CLI did not convict racy CAS (rc {rc})")


def stepper_ops_per_iteration(n_ops: int, memo: bool) -> int:
    """Integer ops of one stepper iteration, counted from
    ``csrc/stepper_chunk.cu``: the blocked-op sweep costs 2W + 2 per op
    (W ands, W ors, a compare, a clear), the candidate words and the
    lowest one 3W + 4, the stack update, status and budget about 26; the
    memo's two hashes and the key compare 6 kw + 5 more."""
    w = n_words(n_ops)
    ops = n_ops * (2 * w + 2) + 3 * w + 30
    return ops + (6 * key_words(n_ops) + 5 if memo else 0)


def _tensor_bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def stepper_bound(tabs, c_in: StepperCarry, c_out: StepperCarry):
    """(bound_ms, bound_by, bytes, ops) of one ``stepper_chunk`` launch:
    every lane's stacks and counters read and written once, the
    predecessor words of the lanes that ran read once (the table entries
    an iteration reads are not counted: a lower bound), against the
    iterations this run's data needed."""
    ran = (c_out.dsi[2] - c_in.dsi[2]) > 0
    iters = int((c_out.dsi[2].long() - c_in.dsi[2].long()).sum())
    n = tabs.prec.shape[2]
    stacks = _tensor_bytes((c_in.taken, c_in.chosen, c_in.states, c_in.dsi,
                            c_in.row))
    nbytes = 2 * stacks + int(ran.sum()) * 4 * (
        tabs.prec.shape[1] * n + tabs.prec.shape[1] + 1)
    ops = iters * stepper_ops_per_iteration(n, c_in.occ.shape[1] > 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def compact_bound(c_in: StepperCarry, c_out: StepperCarry, m: int):
    """(bound_ms, bytes) of one ``compact_carry``: the ``m`` surviving
    lanes' planes and memo read once, the new carry written once; its few
    operations a word are far below the byte side."""
    B = c_in.row.shape[0]
    per_lane_in = _tensor_bytes(c_in) // B
    nbytes = m * (per_lane_in + 4) + _tensor_bytes(c_out)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


# the lane axis of each StepperCarry plane in the table regime
_LANE_AXIS = dict(taken=1, chosen=1, states=1, dsi=1, keys=0, occ=0, row=0)


def cat_carries(cs) -> StepperCarry:
    """Table-regime carries of one shape joined along the lane axis: one
    carry whose lanes evolve, lane by lane, as those of its parts (each
    lane has its own stacks, counters and memo; ``row`` names its
    history in the shared tables)."""
    return StepperCarry(*(torch.cat([getattr(c, f) for c in cs],
                                    dim=_LANE_AXIS[f])
                          for f in StepperCarry._fields))


def split_carry(c: StepperCarry, n: int):
    """The ``n`` equal parts :func:`cat_carries` joined."""
    B = c.row.shape[0] // n
    return [StepperCarry(*(getattr(c, f).narrow(_LANE_AXIS[f], k * B, B)
                           .contiguous() for f in StepperCarry._fields))
            for k in range(n)]


def clone_carry(c: StepperCarry) -> StepperCarry:
    return StepperCarry(*(t.clone() for t in c))


def queue_corpus():
    spec = QueueSpec()
    return spec, build_corpus(spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                              n=N_UNIQUE, n_pids=Q_PIDS, max_ops=Q_OPS,
                              seed_base=1000, seed_prefix="bench")


def _replicate(corpus, B):
    return (corpus * math.ceil(B / len(corpus)))[:B]


def stepper_inputs(spec, histories, n_ops, dev):
    kspec = scalar_shadow(spec) or spec
    enc = encode_batch(histories, kspec.initial_state(), max_ops=n_ops)
    tabs = stepper_tables(kspec, enc.ops[:, :, 1], enc.ops[:, :, 2],
                          enc.ops[:, :, 3], enc.valid, enc.precedes(), dev)
    return tabs, np.full(len(histories), int(enc.init_state[0]), np.int32)


def stepper_cases(q_spec, q_corpus, dev):
    """(name, B, tables, start states) of phase 6: the queue headline at
    4096 lanes; CAS histories of 64 and 128 ops at 1024; CAS histories of
    32 ops over 256 values at 1024, whose table is too large to stage."""
    B = DEVICE_BATCH
    tabs, starts = stepper_inputs(q_spec, _replicate(q_corpus, B), Q_OPS,
                                  dev)
    yield "queue48", B, tabs, starts
    for name, cas, n_ops in (
            ("cas64", CasSpec(), 64), ("cas128", CasSpec(), 128),
            (f"cas32v{WIDE_CAS_VALUES}", CasSpec(n_values=WIDE_CAS_VALUES),
             32)):
        hs = build_corpus(cas, (AtomicCasSUT, RacyCasSUT), n=256,
                          n_pids=N_PIDS, max_ops=n_ops, seed_base=1000,
                          seed_prefix="bench")
        tabs, starts = stepper_inputs(cas, _replicate(hs, 1024), n_ops, dev)
        yield name, 1024, tabs, starts


def stepper_plan_text(name, B, tabs) -> str:
    N = tabs.vocab.shape[1]
    S, V = tabs.vnxt.shape
    p = stepper_launch_plan(B, N, S, V, device_sms(tabs.vocab.device))
    return (f"{name} B={B} N={N} S={S} V={V}: {p.warps_per_block} warps "
            f"a block, grid {p.grid}, {p.smem_bytes} shared bytes a block, "
            f"{stepper_blocks_per_sm(p)} blocks/SM; step table "
            f"({table_bytes(S, V)} B) in "
            f"{'shared' if p.stage_tables else 'device'} memory")


def _compare(name, got, want):
    err = 0
    for plane, a, b in zip(StepperCarry._fields, got, want):
        e = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        err = max(err, e)
        require(e == 0, f"{name}: {plane} differs from plain (max abs err "
                f"{e})")
    return err


def time_launches(launch, inputs, reps: int) -> float:
    """Mean ms per launch of ``launch(x)`` over ``inputs`` (one each),
    CUDA events, after one warm launch on a spare input."""
    launch(inputs[0])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for x in inputs[1:reps + 1]:
        launch(x)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def new_stepper(tabs, c):
    return stepper_chunk(tabs, c, chunk=STEP_CHUNK, budget=TOTAL_BUDGET)


def time_stepper(tabs, mid, launch=new_stepper, reps=5) -> float:
    """ms per launch of a chunk from the mid-search carry, each launch on
    its own copy (the kernel updates the carry in place)."""
    copies = [clone_carry(mid) for _ in range(reps + 1)]
    return time_launches(lambda c: launch(tabs, c), copies, reps)


def phase_stepper(q_spec, q_corpus, dev, tag):
    """Phase 6: stepper_chunk and compact_carry against their plain
    versions, then timings and bounds.  Returns the largest error, the
    timing rows, and what ``--against-stepper`` times again."""
    max_err, rows, carries = 0, {}, {}
    for name, B, tabs, starts in stepper_cases(q_spec, q_corpus, dev):
        N = tabs.vocab.shape[1]
        print(f"  plan: {stepper_plan_text(name, B, tabs)}", flush=True)
        staged = stepper_launch_plan(B, N, *tabs.vnxt.shape,
                                     device_sms(dev)).stage_tables
        require(staged == (name != f"cas32v{WIDE_CAS_VALUES}"),
                f"{name}: the step table is staged where it should not be, "
                f"or the other way round")
        if name == "queue48":
            q_tabs = tabs
            cpu_tabs = type(tabs)(*(t.cpu() for t in tabs))
        for slots in (0, default_slots(B)):
            fresh = fresh_stepper_carry(tabs.nreq, np.arange(B), starts, B,
                                        N, slots)
            begins = {"fresh": fresh}
            if name == "queue48":
                # mid-search: 256 plain iterations in, the hard lanes
                # still running
                begins["mid"] = graphed_plain(
                    functools.partial(stepper_chunk_plain, tabs,
                                      budget=TOTAL_BUDGET),
                    clone_carry(fresh), 256)
            # the plain version's loop on the card is the phase's cost (its
            # host launching each trip's small operations): the CAS shapes
            # run 2 chunks at full width, the queue headline 3, and from
            # its mid-search carry 4 on a lane sample carried on the CPU.
            # Lanes are independent, so after the first chunk the queue's
            # fresh and mid-search carries advance as one carry of 2 x B
            # lanes (cat_carries): every plane of every lane is still
            # compared.  The chunk timed (the first from ``mid``) runs as
            # it is, the others as CUDA graphs (graphed_plain)
            plain = functools.partial(stepper_chunk_plain, tabs,
                                      budget=TOTAL_BUDGET)
            n_full = 3 if name == "queue48" else 2
            cks = {start: clone_carry(c0) for start, c0 in begins.items()}
            cps = {start: clone_carry(c0) for start, c0 in begins.items()}
            running = {start: int((c0.dsi[1] == RUNNING).sum())
                       for start, c0 in begins.items()}
            n_sample = HELD_SAMPLE_CHUNKS if "mid" in begins else 0
            if n_sample:
                # the sample advances in a worker process beside the
                # full-width loop below (once its timed chunk is done),
                # and is compared after it
                sample = LaneSample(begins["mid"], len(q_corpus),
                                    functools.partial(
                                        stepper_chunk_plain, cpu_tabs,
                                        chunk=STEP_CHUNK,
                                        budget=TOTAL_BUDGET))
            joint = len(begins) > 1
            for i in range(max(n_full, n_sample)):
                for start in begins:
                    new_stepper(tabs, cks[start])
                if i < n_full:
                    if i == 0 or not joint:
                        for start in begins:
                            if start != "mid" or i:
                                graphed_plain(plain, cps[start], STEP_CHUNK)
                                continue
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            plain(cps[start], chunk=STEP_CHUNK)
                            torch.cuda.synchronize()
                            # the plain version's time: its first chunk
                            # from the mid-search carry
                            plain_ms = (time.perf_counter() - t0) * 1e3
                    else:
                        both = graphed_plain(
                            plain, cat_carries([cps[k] for k in begins]),
                            STEP_CHUNK)
                        cps = dict(zip(begins, split_carry(both,
                                                           len(begins))))
                if i == 0 and n_sample:
                    sample.start(n_sample)
                if i in (0, n_full - 1):
                    torch.cuda.synchronize()
                    for start in begins:
                        max_err = max(max_err, _compare(
                            f"stepper_chunk {name} B={B} slots={slots} "
                            f"{start} chunk {i + 1}", cks[start],
                            cps[start]))
                if i < n_sample:
                    sample.keep(cks["mid"])
            if n_sample:
                max_err = max(max_err, sample.check(
                    f"stepper_chunk {name} slots={slots} mid lane sample"))
            for start in begins:
                what = (f"; on a sample of {len(sample.lanes)} lanes "
                        f"({sample.unique} unique histories) after each of "
                        f"{n_sample}" if start == "mid" else "")
                print(f"{tag} stepper_chunk == plain on {name} B={B} "
                      f"slots={slots} from a {start} carry "
                      f"({running[start]} lanes running): all 7 planes "
                      f"bit-identical after 1 and {n_full} chunks of "
                      f"{STEP_CHUNK} at full width"
                      + (f" (chunks 2-{n_full} of the plain version on the "
                         f"fresh and mid carries joined, "
                         f"{len(begins) * B} lanes)" if joint else "")
                      + f"{what}; {int((cks[start].dsi[1] == RUNNING).sum())}"
                      f" still running", flush=True)
                carries[(name, slots, start)] = cks[start]
            if name != "queue48":
                continue
            mid = begins["mid"]
            ms = time_stepper(tabs, mid)
            one = new_stepper(tabs, clone_carry(mid))
            bound_ms, bound_by, nbytes, ops = stepper_bound(tabs, mid, one)
            # plain_ms: the comparison's first plain chunk from ``mid``
            rows[slots] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, mid=mid)
            print(f"{tag} stepper_chunk {name} B={B} slots={slots}: "
                  f"{ms:.4f} ms/launch of {STEP_CHUNK} iterations from the "
                  f"mid-search carry (bound {bound_ms:.6f} ms by {bound_by}: "
                  f"{nbytes} B, {ops} ops; plain {plain_ms:.1f} ms)",
                  flush=True)

    # compact_carry out of the queue headline's carries after 3 chunks,
    # running lanes first: (label, old slots, new bucket, new slots)
    big = default_slots(DEVICE_BATCH)
    comp = {}
    for label, old, to, slots in (
            ("grown", big, COMPACT_TO, default_slots(COMPACT_TO)),
            ("kept", big, DEVICE_BATCH // 4, big),
            ("shrunk", big, COMPACT_TO, big // 32),
            ("from no memo", 0, COMPACT_TO, default_slots(COMPACT_TO)),
            ("to no memo", big, COMPACT_TO, 0)):
        c = carries[("queue48", old, "mid")]
        status = c.dsi[1].cpu().numpy()
        order = np.argsort(status != RUNNING, kind="stable")  # running first
        lanes = order[:to]
        got = compact_carry(c, lanes, to, slots)
        want = compact_carry_plain(c, lanes, to, slots)
        torch.cuda.synchronize()
        max_err = max(max_err, _compare(
            f"compact_carry {label}: {old} -> {slots} slots", got, want))
        filled = int((got.occ == 1).sum())
        if label == "shrunk":
            had = int((c.occ[torch.from_numpy(lanes).to(dev)] == 1).sum())
            require(0 < filled < had, f"the shrunk memo kept {filled} of "
                    f"{had} entries: no collision was exercised")
        reps = 10
        ms = time_launches(lambda x: compact_carry(c, lanes, to, slots),
                           [None] * (reps + 1), reps)
        bound_ms, nbytes = compact_bound(c, got, len(lanes))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compact_carry_plain(c, lanes, to, slots)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        comp[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by="bytes", args=(c, lanes, to, slots))
        print(f"{tag} compact_carry == plain, memo {label}: "
              f"{c.row.shape[0]} -> {to} lanes, {old} -> {slots} slots "
              f"({filled} memo entries after): all 7 planes bit-identical; "
              f"{ms:.4f} ms/launch (bound {bound_ms:.6f} ms by bytes: "
              f"{nbytes} B; plain {plain_ms:.1f} ms)", flush=True)
    return max_err, rows, comp, q_tabs


def per_history_tables(tabs):
    """The per-history ``[R, S, N]`` next states and ``[R, S, W]`` packed
    ok words that the earlier stepper kernel reads, expanded from the
    vocabulary (op j of row r is entry ``vocab[r, j]``)."""
    voc = tabs.vocab.long()
    nxt = tabs.vnxt[:, voc].permute(1, 0, 2).contiguous()
    bits = (tabs.vok[:, voc >> 5].to(torch.int64) >> (voc & 31)) & 1
    words = pack_words(bits.permute(1, 0, 2) == 1)            # [R, S, W]
    okw = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return nxt, okw.to(torch.int32).contiguous()


def old_stepper_kernels(src_dir: Path):
    """Launchers for the earlier ``stepper_chunk.cu`` and
    ``compact_carry.cu`` in ``src_dir``, built like these."""
    P, I = ctypes.c_void_p, ctypes.c_int
    step = ctypes.CDLL(str(kernels.build(
        "stepper_chunk_against", src=src_dir / "stepper_chunk.cu"))
                       ).stepper_chunk_launch
    step.argtypes = [P] * 12 + [I] * 8 + [P]
    comp = ctypes.CDLL(str(kernels.build(
        "compact_carry_against", src=src_dir / "compact_carry.cu"))
                       ).compact_carry_launch
    comp.argtypes = [P] * 15 + [I] * 7 + [P]

    def old_step(rtabs, c):
        R, S, N = rtabs[0].shape
        rc = step(*(t.data_ptr() for t in rtabs), c.row.data_ptr(),
                  *(t.data_ptr() for t in c[:6]), c.row.shape[0], R, N, S,
                  n_words(N), c.occ.shape[1], STEP_CHUNK, TOTAL_BUDGET,
                  torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"the earlier stepper_chunk failed ({rc})")
        return c

    def old_compact_raw(c, idx, out):
        rc = comp(*(t.data_ptr() for t in c), idx.data_ptr(),
                  *(t.data_ptr() for t in out), c.row.shape[0],
                  out.row.shape[0], idx.shape[0], c.taken.shape[0],
                  key_words(c.taken.shape[0]), c.occ.shape[1],
                  out.occ.shape[1], torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"the earlier compact_carry failed ({rc})")
        return out

    def old_compact(c, lanes, to, slots):
        idx = torch.from_numpy(np.asarray(lanes, np.int32)).to(c.row.device)
        return old_compact_raw(c, idx, compact_outputs(c, to, slots))
    return old_step, old_compact, old_compact_raw


def compact_outputs(c: StepperCarry, to: int, slots: int) -> StepperCarry:
    N, dev = c.taken.shape[0], c.row.device
    return StepperCarry(*(torch.empty(s, dtype=torch.int32, device=dev)
                          for s in ((N, to), (N + 1, to), (N + 1, to),
                                    (5, to), (to, slots, key_words(N)),
                                    (to, slots), (to,))))


def new_compact_raw(c, idx, out, win):
    """This ``compact_carry``'s C entry alone: the lanes on the card, the
    outputs and the re-hash scratch made beforehand, no host checks."""
    rc = kernels.compact_carry_lib().compact_carry_launch(
        *(t.data_ptr() for t in c), idx.data_ptr(),
        *(t.data_ptr() for t in out), win.data_ptr(), c.row.shape[0],
        out.row.shape[0], idx.shape[0], c.taken.shape[0], 0,
        key_words(c.taken.shape[0]), c.occ.shape[1], out.occ.shape[1],
        device_sms(c.row.device), torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"compact_carry's C entry failed ({rc})")
    return out


def phase_against_stepper(src_dir: Path, q_tabs, rows, comp, tag):
    """The earlier stepper kernels and these in turns (old, new, new, old)
    on phase 6's queue inputs, after checking them equal."""
    old_step, old_compact, old_compact_raw = old_stepper_kernels(src_dir)
    for name in ("stepper_chunk_against", "compact_carry_against"):
        src = src_dir / f"{name.split('_against')[0]}.cu"
        for line in kernels.ptxas_report(name, src).splitlines():
            if any(k in line for k in ("registers", "stack frame")):
                print(f"  ptxas (earlier {name}): {line.strip()}")
    rtabs = (*per_history_tables(q_tabs), q_tabs.prec, q_tabs.valid,
             q_tabs.nreq)
    print(f"{tag} earlier stepper_chunk fed per-history tables of "
          f"{sum(t.numel() * 4 for t in rtabs[:2])} B, expanded from a "
          f"{q_tabs.vnxt.numel() * 4 + q_tabs.vok.numel() * 4} B "
          f"vocabulary table", flush=True)
    for slots, row in rows.items():
        mid = row["mid"]
        a = old_step(rtabs, clone_carry(mid))
        b = new_stepper(q_tabs, clone_carry(mid))
        torch.cuda.synchronize()
        _compare(f"earlier stepper_chunk vs this, slots={slots}", a, b)
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(time_stepper(
                rtabs if who == "old" else q_tabs, mid,
                launch=old_step if who == "old" else new_stepper))
        o, n = (sum(turns[k]) / 2 for k in ("old", "new"))
        print(f"{tag} earlier vs this stepper_chunk, queue48 B={DEVICE_BATCH}"
              f" slots={slots} (old, new, new, old): old "
              f"{turns['old'][0]:.4f}/{turns['old'][1]:.4f} ms, new "
              f"{turns['new'][0]:.4f}/{turns['new'][1]:.4f} ms per launch; "
              f"old/new {o / n:.2f}x", flush=True)
    del rtabs
    for label, row in comp.items():
        c, lanes, to, slots = row["args"]
        a = old_compact(c, lanes, to, slots)
        b = compact_carry(c, lanes, to, slots)
        torch.cuda.synchronize()
        _compare(f"earlier compact_carry vs this, memo {label}", a, b)
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            fn = old_compact if who == "old" else compact_carry
            turns[who].append(time_launches(
                lambda x: fn(c, lanes, to, slots), [None] * 11, 10))
        o, n = (sum(turns[k]) / 2 for k in ("old", "new"))
        print(f"{tag} earlier vs this compact_carry, memo {label} "
              f"({c.row.shape[0]} -> {to} lanes, {c.occ.shape[1]} -> "
              f"{slots} slots) (old, new, new, old): old "
              f"{turns['old'][0]:.4f}/{turns['old'][1]:.4f} ms, new "
              f"{turns['new'][0]:.4f}/{turns['new'][1]:.4f} ms per launch; "
              f"old/new {o / n:.2f}x", flush=True)
        # the C entries alone: the wrappers' host work (argument checks,
        # the lanes' copy to the card, allocations) left out
        idx = torch.from_numpy(np.asarray(lanes, np.int32)).to(c.row.device)
        out = compact_outputs(c, to, slots)
        win = torch.empty(max(len(lanes) * slots, 1), dtype=torch.int32,
                          device=c.row.device)
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(time_launches(
                (lambda x: old_compact_raw(c, idx, out)) if who == "old"
                else (lambda x: new_compact_raw(c, idx, out, win)),
                [None] * 11, 10))
        o, n = (sum(turns[k]) / 2 for k in ("old", "new"))
        print(f"{tag} earlier vs this compact_carry's C entry alone, memo "
              f"{label} (old, new, new, old): old "
              f"{turns['old'][0]:.4f}/{turns['old'][1]:.4f} ms, new "
              f"{turns['new'][0]:.4f}/{turns['new'][1]:.4f} ms per launch; "
              f"old/new {o / n:.2f}x", flush=True)


def phase_queue_checker(spec, corpus, tag):
    """Phase 7: TorchStepper on the queue headline corpus."""
    t = TorchStepper(spec)
    device_corpus = _replicate(corpus, DEVICE_BATCH)
    t0 = time.perf_counter()
    cold = t.check_histories(spec, device_corpus)
    cold_s = time.perf_counter() - t0
    before = (t.rounds_run, t.compactions, t.lockstep_cost,
              stepper_chunk.launches, compact_carry.launches)
    t0 = time.perf_counter()
    v = t.check_histories(spec, device_corpus)
    warm_s = time.perf_counter() - t0
    rounds, compactions, cost, n_step, n_comp = (
        a - b for a, b in zip((t.rounds_run, t.compactions, t.lockstep_cost,
                               stepper_chunk.launches,
                               compact_carry.launches), before))
    require(v.tolist() == cold.tolist(), "verdicts differ between runs")
    prof_wall, busy_s, top = profile_device(
        lambda: t.check_histories(spec, device_corpus))
    t0 = time.perf_counter()
    ov = WingGongCPU(memo=True).check_histories(spec, corpus)
    oracle_s = time.perf_counter() - t0
    uv = v[:len(corpus)]
    both = (uv != Verdict.BUDGET_EXCEEDED) & (ov != Verdict.BUDGET_EXCEEDED)
    mismatches = int(((uv != ov) & both).sum())
    require(mismatches == 0, f"{mismatches} queue verdict mismatches vs "
            f"the oracle")
    lin = [h for h, x in zip(corpus, uv) if x == Verdict.LINEARIZABLE][:32]
    for h in lin:
        wv, wit = t.check_witness(spec, h)
        require(wv == Verdict.LINEARIZABLE and verify_witness(spec, h, wit),
                "a LINEARIZABLE queue witness failed to replay")
    undecided = int((v == Verdict.BUDGET_EXCEEDED).sum())
    print(f"{tag} queue checker: {len(device_corpus)} histories "
          f"({len(corpus)} unique, {Q_PIDS} pids x {Q_OPS} ops) warm "
          f"{warm_s:.3f} s = {len(device_corpus) / warm_s:.1f} histories/s "
          f"(cold {cold_s:.3f} s); rounds {rounds}, compactions "
          f"{compactions}, stepper_chunk launches {n_step}, compact_carry "
          f"launches {n_comp}, lockstep_cost {cost}, undecided {undecided}; "
          f"vs memo oracle ({oracle_s:.2f} s on the host): 0 mismatches "
          f"({int((uv == Verdict.LINEARIZABLE).sum())} linearizable, "
          f"{int((uv == Verdict.VIOLATION).sum())} violations, "
          f"{int(both.sum())} decided by both); {len(lin)} witnesses "
          f"replayed", flush=True)
    idle = f"{1 - busy_s / prof_wall:.3f}" if busy_s else "not measured"
    print(f"{tag} queue checker profiled: wall {prof_wall:.3f} s, device "
          f"busy {busy_s:.3f} s, idle share {idle}; top kernels {top}",
          flush=True)
    # the batch's set-up stages, timed alone on the same 4096 histories
    t0 = time.perf_counter()
    flatten(spec, device_corpus, None, t.max_expansions)
    t_flat = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = encode_batch(device_corpus, t.kspec.initial_state(), max_ops=Q_OPS)
    prec = enc.precedes()
    t_enc = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stepper_tables(t.kspec, enc.ops[:, :, 1], enc.ops[:, :, 2],
                   enc.ops[:, :, 3], enc.valid, prec, t.device)
    torch.cuda.synchronize()
    t_tab = time.perf_counter() - t0
    print(f"{tag} queue batch set-up alone: host contracts (domain check, "
          f"pending expansion) {t_flat:.3f} s, encoding and precedence "
          f"{t_enc:.3f} s (host), step tables {t_tab:.3f} s (built on the "
          f"card, synchronised)", flush=True)
    return warm_s


def phase_queue_property(spec, tag):
    """Phase 8: the property loop on the queue, racy convicted, atomic
    passed, then the CLI."""
    for impl, sut_cls, want_ok in (("racy", RacyTwoPhaseQueueSUT, False),
                                   ("atomic", AtomicQueueSUT, True)):
        t = TorchStepper(spec)
        cfg = PropertyConfig(n_trials=100, n_pids=Q_PIDS, max_ops=Q_OPS,
                             seed=0)
        t0 = time.perf_counter()
        res = prop_concurrent(spec, sut_cls(spec), cfg, backend=t)
        dt = time.perf_counter() - t0
        require(res.ok == want_ok and res.undecided == 0,
                f"{impl} queue: ok={res.ok} undecided={res.undecided}")
        what = ""
        if not want_ok:
            cx = res.counterexample
            require(cx is not None and cx.shrink_steps > 0
                    and len(cx.program) < Q_OPS,
                    "racy queue counterexample was not shrunk")
            what = (f", counterexample {len(cx.program)} ops after "
                    f"{cx.shrink_steps} shrink steps")
        print(f"{tag} property {impl} queue {Q_PIDS} pids x {Q_OPS} ops: "
              f"ok={res.ok} after {res.trials_run} trials, "
              f"{res.histories_checked} histories, {dt:.2f} s, "
              f"{t.rounds_run} chunk rounds{what}", flush=True)
    rc = cli.main(["run", "--model", "queue", "--impl", "racy",
                   "--backend", "stepper", "--trials", "100", "--pids",
                   str(Q_PIDS), "--ops", str(Q_OPS)])
    require(rc == 1, f"the CLI did not convict racy queue (rc {rc})")
    print(f"{tag} CLI (the entry point of python -m qsm_tpu_torch run "
          f"--model queue --backend stepper): racy queue rc 1", flush=True)


# ---------------------------------------------------------------------------
# The sweep regime (stepper_sweep) and the registry's milestones
# ---------------------------------------------------------------------------

def sweep_cases(kv_spec, kv_corpus, dev):
    """(name, spec, B, N, tables, start states, unique histories) of the
    sweep phase: KV of 16 keys at 4096 lanes of 64 ops; queue and stack of
    capacity 8, txn(8, 8) and a random vector spec of 9 elements at 1024
    lanes.  Lane i holds unique history i % unique."""
    tabs, starts = sweep_inputs(kv_spec, _replicate(kv_corpus, DEVICE_BATCH),
                                KV_OPS, dev)
    yield "kv16", kv_spec, DEVICE_BATCH, KV_OPS, tabs, starts, len(kv_corpus)
    for name, spec, suts, n_ops in (
            ("queue8", QueueSpec(capacity=8),
             (AtomicQueueSUT, RacyTwoPhaseQueueSUT), 48),
            ("stack8", StackSpec(capacity=8),
             (AtomicStackSUT, RacyTwoPhaseStackSUT), 48),
            ("txn8", TxnRegisterSpec(8, 8), (AtomicTxnSUT, TornCopyTxnSUT),
             32),
            ("random9", RandomVectorSpec(5, bounds=(4,) * 9), None, 48)):
        if suts is None:
            rng = random.Random("chip-smoke")
            hs = [random_history(spec, rng, 6, 40) for _ in range(256)]
        else:
            hs = build_corpus(spec, suts, n=256, n_pids=N_PIDS,
                              max_ops=n_ops, seed_base=1000,
                              seed_prefix="bench")
        tabs, starts = sweep_inputs(spec, _replicate(hs, 1024), n_ops, dev)
        yield name, spec, 1024, n_ops, tabs, starts, len(hs)


class LaneSample:
    """A seeded sample of a card carry's RUNNING lanes, held on the CPU:
    one lane of every unique history still running (``row % n_unique``
    names it), then others up to ``size`` lanes.  Lanes are independent
    (each has its own stacks, counters and memo), so the sample, moved by
    ``compact_carry_plain`` at the same slot count and advanced by the
    plain version on the CPU, evolves exactly as those lanes do in the
    card's carry."""

    def __init__(self, carry: StepperCarry, n_unique: int, plain, seed=0,
                 size=SAMPLE_LANES):
        rng = np.random.default_rng(seed)
        status = carry.dsi[1].cpu().numpy()
        rows = carry.row.cpu().numpy()
        order = rng.permutation(np.flatnonzero(status == RUNNING))
        _, first = np.unique(rows[order] % n_unique, return_index=True)
        rest = rng.permutation(np.setdiff1d(order, order[first]))
        self.unique = len(first)
        self.lanes = np.sort(np.concatenate(
            [order[first], rest[:max(size - len(first), 0)]]))
        self.plain = plain
        self.carry = self._cut(carry)

    def _cut(self, carry: StepperCarry) -> StepperCarry:
        c = compact_carry_plain(carry, self.lanes, len(self.lanes),
                                carry.occ.shape[1])
        return StepperCarry(*(t.cpu() for t in c))

    def step_and_check(self, carry: StepperCarry, what: str) -> int:
        """One chunk of the plain version on the sample, then the sampled
        lanes of ``carry`` (the card's, after the same chunk) compared
        plane by plane; the largest error (0, or this raises)."""
        self.start(1)
        self.keep(carry)
        return self.check(what)

    def start(self, n: int) -> None:
        """Advance the sample ``n`` chunks in the worker processes
        (:func:`sample_pool`), its lanes split among them (lanes are
        independent), while this process drives the card."""
        parts = np.array_split(np.arange(len(self.lanes)), SAMPLE_WORKERS)
        self._futures = [
            sample_pool().submit(_advance_sample, self.plain,
                                 take_lanes(self.carry, part), n)
            for part in parts if len(part)]
        self._card = []

    def keep(self, carry: StepperCarry) -> None:
        """The sampled lanes of ``carry``, the card's after its next
        chunk, kept to be compared by :meth:`check`."""
        torch.cuda.synchronize()
        self._card.append(self._cut(carry))

    def check(self, what: str) -> int:
        """Each kept card snapshot against the worker's sample after the
        same chunk, plane by plane; the largest error (0, or this
        raises)."""
        parts = [f.result(timeout=SAMPLE_TIMEOUT_S) for f in self._futures]
        mine = [cat_lanes(chunk) for chunk in zip(*parts)]
        require(len(mine) == len(self._card), f"{what}: {len(self._card)} "
                f"card chunks kept against {len(mine)} sample chunks")
        err = 0
        for i, (card, cpu) in enumerate(zip(self._card, mine)):
            err = max(err, _compare(f"{what}, chunk {i + 1}" if len(mine) > 1
                                    else what, card, cpu))
        self.carry = mine[-1]
        return err


SAMPLE_WORKERS = 4             # processes advancing lane samples
SAMPLE_TIMEOUT_S = 900.0
_SAMPLE_POOL = None


def sample_pool():
    """The worker processes that run the plain versions on lane samples
    on the CPU while this process drives the card (spawned once, on first
    use; :func:`close_sample_pool` stops them)."""
    global _SAMPLE_POOL
    if _SAMPLE_POOL is None:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        _SAMPLE_POOL = ProcessPoolExecutor(
            SAMPLE_WORKERS, initializer=_sample_worker_init,
            mp_context=multiprocessing.get_context("spawn"))
    return _SAMPLE_POOL


def close_sample_pool():
    global _SAMPLE_POOL
    if _SAMPLE_POOL is not None:
        _SAMPLE_POOL.shutdown(wait=True, cancel_futures=True)
        _SAMPLE_POOL = None


def _sample_worker_init():
    # a sample's lanes are split over every worker: the host's cores
    # shared among them
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // SAMPLE_WORKERS))


def _advance_sample(plain, carry: StepperCarry, n: int) -> list:
    """In a worker: ``n`` chunks of ``plain`` on a CPU sample carry, a
    copy of the carry after each."""
    out = []
    for _ in range(n):
        plain(carry)
        out.append(StepperCarry(*(t.clone() for t in carry)))
    return out


def sweep_ops_per_iteration(n_ops: int, dim: int, memo: bool) -> int:
    """Integer ops of one sweep iteration, as counted from the first
    version of ``csrc/stepper_sweep.cu`` and kept, so that every version
    divides by one yardstick: the blocked-op sweep 2W + 2 an op and the postcondition
    about 8 (the kind's branch, a clamped index, a load, a compare), the
    candidate words and the lowest one 3W + 4, the child 3 a state word,
    the stack update, status and budget about 26; with the memo the two
    hashes and the key compare 6 kw + 5 more."""
    w = n_words(n_ops)
    ops = n_ops * (2 * w + 10) + 3 * w + 30 + 3 * dim
    return ops + (6 * (w + dim) + 5 if memo else 0)


def sweep_bound(tabs, c_in: StepperCarry, c_out: StepperCarry):
    """(bound_ms, bound_by, bytes, ops) of one ``stepper_sweep`` launch:
    every lane's stacks and counters read and written once, the ops and
    predecessor words of the lanes that ran read once, against the
    iterations this run's data needed."""
    ran = (c_out.dsi[2] - c_in.dsi[2]) > 0
    iters = int((c_out.dsi[2].long() - c_in.dsi[2].long()).sum())
    n = tabs.cmd.shape[1]
    w = tabs.prec.shape[1]
    stacks = _tensor_bytes((c_in.taken, c_in.chosen, c_in.states, c_in.dsi,
                            c_in.row))
    nbytes = 2 * stacks + int(ran.sum()) * 4 * (3 * n + w * n + w + 1)
    ops = iters * sweep_ops_per_iteration(n, c_in.states.shape[2],
                                          c_in.occ.shape[1] > 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def kv16_corpus():
    spec = KvSpec(n_keys=KV_KEYS, n_values=4)
    return spec, build_corpus(spec, (AtomicKvSUT, StaleCacheKvSUT),
                              n=N_UNIQUE, n_pids=KV_PIDS, max_ops=KV_OPS,
                              seed_base=1000, seed_prefix="bench")


def sweep_inputs(spec, histories, n_ops, dev):
    enc = encode_batch(histories, spec.initial_state(), max_ops=n_ops)
    tabs = sweep_tables(enc.ops[:, :, 1], enc.ops[:, :, 2],
                        enc.ops[:, :, 3], enc.valid, enc.precedes(), dev)
    return tabs, np.tile(np.asarray(enc.init_state, np.int32),
                         (len(histories), 1))


def running_lanes(c: StepperCarry) -> np.ndarray:
    return np.flatnonzero(c.dsi[1].cpu().numpy() == RUNNING)


def new_sweep(model, tabs, c, lanes=None):
    return stepper_sweep(model, tabs, c, chunk=SWEEP_CHUNK,
                         budget=TOTAL_BUDGET, lanes=lanes)


def main_sweep(model, tabs, c):
    """A launch as the sweep regime's main path makes it
    (``TorchStepper._run_device``): the running lanes alone."""
    return new_sweep(model, tabs, c, lanes=running_lanes(c))


def sweep_raw(model, tabs, c, lanes=None, stats=None, fn=None):
    """This ``stepper_sweep``'s C entry alone (``lanes`` an int32 tensor on
    the card, or None for every lane), for timing: no host checks, no
    host sync between launches; ``fn`` another build's entry."""
    R, N = tabs.cmd.shape
    B, D, slots = c.row.shape[0], c.states.shape[2], c.occ.shape[1]
    L = B if lanes is None else lanes.numel()
    plan = sweep_launch_plan(L, N, D, slots, device_sms(c.row.device))
    fn = fn or kernels.stepper_sweep_lib().stepper_sweep_launch
    rc = fn(
        *(t.data_ptr() for t in tabs), model.data.data_ptr(),
        c.row.data_ptr(), *(t.data_ptr() for t in c[:6]),
        None if lanes is None else lanes.data_ptr(),
        None if stats is None else stats.data_ptr(), B, R, N, n_words(N), D,
        slots, SWEEP_CHUNK, TOTAL_BUDGET, model.kind, *model.params, L,
        *(int(x) for x in plan), torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"stepper_sweep's C entry failed ({rc})")
    return c


def old_sweep_kernel(src: Path):
    """A launcher for an earlier ``stepper_sweep.cu`` (the first version's
    C entry: 14 pointers, 15 ints with its own launch plan, the stream),
    built like this one."""
    fn = ctypes.CDLL(str(kernels.build("stepper_sweep_against", src=src))
                     ).stepper_sweep_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 15 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(model, tabs, c):
        R, N = tabs.cmd.shape
        B, D, slots = c.row.shape[0], c.states.shape[2], c.occ.shape[1]
        W = n_words(N)
        per_warp = 4 * ((N + 1) * (D + 1) + D + W * (W + 3) * 32)
        wpb = max(1, min(16, SMEM_BLOCK_MAX // per_warp,
                         -(-B // device_sms(c.row.device))))
        rc = fn(*(t.data_ptr() for t in tabs), model.data.data_ptr(),
                c.row.data_ptr(), *(t.data_ptr() for t in c[:6]), B, R, N,
                W, D, slots, SWEEP_CHUNK, TOTAL_BUDGET, model.kind,
                *model.params, wpb, -(-B // wpb), wpb * per_warp,
                torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"the earlier stepper_sweep failed ({rc})")
        return c
    return launch


def sm_clock_mhz() -> float:
    """The SM clock now (``nvidia-smi --query-gpu=clocks.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60,
        check=True).stdout.split()
    return float(out[0])


def load_text(mid: StepperCarry, N: int, D: int, slots: int, sms: int,
              listed: bool) -> str:
    """How the running lanes fall on blocks and SMs under the launch plan
    (all B lanes, or the running lanes alone), per SM as if block i runs
    on SM i mod sms in the first wave (the order in which blocks are
    handed out is the hardware's; this reads the plan, not the card)."""
    run = (mid.dsi[1] == RUNNING).cpu().numpy().astype(np.int64)
    if listed:
        run = np.ones(int(run.sum()), np.int64)
    p = sweep_launch_plan(len(run), N, D, slots, sms)
    blocks = np.add.reduceat(run, np.arange(0, len(run), p.warps_per_block))
    per_sm = np.bincount(np.arange(len(blocks)) % sms, weights=blocks,
                         minlength=sms)
    return (f"{'running lanes alone' if listed else 'all lanes'}: "
            f"{p.warps_per_block} warps a block, grid {p.grid}; running "
            f"warps a block mean {blocks.mean():.2f}, max {blocks.max()}; "
            f"an SM mean {per_sm.mean():.2f}, max {per_sm.max():.0f}, min "
            f"{per_sm.min():.0f}")


def time_sweep(launch, mid, reps=5) -> float:
    """ms per launch of ``launch(c)`` from the mid-search carry, each
    launch on its own copy (the kernels update the carry in place)."""
    return time_launches(launch, [clone_carry(mid) for _ in range(reps + 1)],
                         reps)


def phase_sweep(kv_spec, kv_corpus, dev, tag, against=None):
    """Phase 9: stepper_sweep against stepper_sweep_plain on every case,
    at full width after the first chunks and on a lane sample after every
    chunk, then timings, bounds, cycles an iteration; compact_carry on the
    KV carry.  With ``against`` (an earlier stepper_sweep.cu) that kernel
    is checked equal and timed in turns.  Returns the largest error of
    each kernel and the headline row."""
    max_err, comp_err, head = 0, 0, None
    sms = device_sms(dev)
    old = old_sweep_kernel(against) if against is not None else None
    if old is not None:
        for line in kernels.ptxas_report("stepper_sweep_against",
                                         against).splitlines():
            if any(k in line for k in ("registers", "stack frame")):
                print(f"  ptxas (earlier stepper_sweep): {line.strip()}")
    for name, spec, B, N, tabs, starts, n_unique in sweep_cases(
            kv_spec, kv_corpus, dev):
        t_case = time.perf_counter()
        D = spec.STATE_DIM
        model = sweep_model(spec, dev)
        cpu_tabs = type(tabs)(*(t.cpu() for t in tabs))
        for slots in ((0, default_slots(B, D)) if name == "kv16"
                      else (default_slots(B, D),)):
            p = sweep_launch_plan(B, N, D, slots, sms)
            print(f"  plan: {name} B={B} N={N} D={D} slots={slots} kind "
                  f"{model.kind}: {p.warps_per_block} warps a block, grid "
                  f"{p.grid}, {p.smem_bytes} shared bytes a block",
                  flush=True)
            fresh = fresh_sweep_carry(tabs.nreq, np.arange(B), starts, B, N,
                                      slots)
            # mid-search: SWEEP_MID plain iterations in
            plain = functools.partial(stepper_sweep_plain, spec, tabs,
                                      budget=TOTAL_BUDGET)
            mid = graphed_plain(plain, clone_carry(fresh), SWEEP_MID)
            run_mid = running_lanes(mid)
            running = len(run_mid)
            require(running > 0, f"{name}: no lane running mid-search")
            for listed in (False, True):
                print(f"  load of the {name} slots={slots} mid-search carry, "
                      f"{load_text(mid, N, D, slots, sms, listed)}",
                      flush=True)
            # full width: the kernel as the main path launches it (the
            # running lanes alone) and over every lane, against the plain
            # version on the card; the first plain chunk is its time
            n_full = 2 if name == "kv16" else 1
            ck, cf, cp = (clone_carry(mid) for _ in range(3))
            sample = LaneSample(mid, n_unique, functools.partial(
                stepper_sweep_plain, spec, cpu_tabs, chunk=SWEEP_CHUNK,
                budget=TOTAL_BUDGET))
            n_sample = HELD_SAMPLE_CHUNKS if name == "kv16" else 2
            for i in range(max(n_full, n_sample)):
                main_sweep(model, tabs, ck)
                if i < n_full:
                    new_sweep(model, tabs, cf)
                    # the first plain chunk runs as it is, and is timed;
                    # the second as a CUDA graph (graphed_plain)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if i == 0:
                        plain(cp, chunk=SWEEP_CHUNK)
                    else:
                        graphed_plain(plain, cp, SWEEP_CHUNK)
                    torch.cuda.synchronize()
                    if i == 0:
                        plain_ms = (time.perf_counter() - t0) * 1e3
                    for label, c in (("running lanes", ck), ("all lanes",
                                                             cf)):
                        max_err = max(max_err, _compare(
                            f"stepper_sweep {name} B={B} slots={slots} "
                            f"{label} chunk {i + 1}", c, cp))
                if i == 0:
                    # the sample advances in a worker process beside the
                    # rest of the loop (after the timed chunk), and is
                    # compared after it
                    sample.start(n_sample)
                if i < n_sample:
                    sample.keep(ck)
            max_err = max(max_err, sample.check(
                f"stepper_sweep {name} slots={slots} lane sample"))
            # timings through the C entry, in turns: every lane, the
            # running lanes alone
            lanes_t = torch.from_numpy(run_mid.astype(np.int32)).to(dev)
            turns = {"all": [], "running": []}
            for who in ("all", "running", "running", "all"):
                turns[who].append(time_sweep(
                    lambda c: sweep_raw(model, tabs, c,
                                        lanes_t if who == "running"
                                        else None), mid))
            mhz = sm_clock_mhz()
            ms = sum(turns["running"]) / 2
            ms_all = sum(turns["all"]) / 2
            one = sweep_raw(model, tabs, clone_carry(mid), lanes_t)
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            sweep_raw(model, tabs, clone_carry(mid), lanes_t, stats)
            probes, passes = (int(x) for x in stats.cpu())
            hits = int((one.dsi[3] - mid.dsi[3]).sum())
            longest = int((one.dsi[2] - mid.dsi[2]).max())
            bound_ms, bound_by, nbytes, ops = sweep_bound(tabs, mid, one)
            cycles = ms * 1e-3 * mhz * 1e6 / max(longest, 1)
            filt = (f"; memo probes {probes}, tag matched {passes} "
                    f"({passes / max(probes, 1):.4f}), hits {hits}"
                    if slots else "")
            print(f"{tag} stepper_sweep == plain on {name} B={B} N={N} D={D}"
                  f" slots={slots} from a mid-search carry ({running} lanes "
                  f"running): all 7 planes bit-identical after "
                  f"{' and '.join(str(k + 1) for k in range(n_full))} "
                  f"chunk(s) of {SWEEP_CHUNK} at full width (running lanes "
                  f"alone and all lanes), and on a sample of "
                  f"{len(sample.lanes)} lanes ({sample.unique} unique "
                  f"histories) after each of {n_sample}; {ms:.4f} ms/launch "
                  f"running lanes alone, {ms_all:.4f} all lanes (in turns: "
                  f"all {turns['all'][0]:.4f}/{turns['all'][1]:.4f}, running"
                  f" {turns['running'][0]:.4f}/{turns['running'][1]:.4f}); "
                  f"longest lane {longest} iterations, {cycles:.0f} cycles an"
                  f" iteration at {mhz:.0f} MHz (bound {bound_ms:.6f} ms by "
                  f"{bound_by}: {nbytes} B, {ops} ops; plain {plain_ms:.1f} "
                  f"ms){filt}; {int((ck.dsi[1] == RUNNING).sum())} still "
                  f"running; case {time.perf_counter() - t_case:.1f} s",
                  flush=True)
            if old is not None:
                a = old(model, tabs, clone_carry(mid))
                b = sweep_raw(model, tabs, clone_carry(mid), lanes_t)
                torch.cuda.synchronize()
                _compare(f"earlier stepper_sweep vs this, {name} "
                         f"slots={slots}", a, b)
                turns = {"old": [], "new": []}
                for who in ("old", "new", "new", "old"):
                    turns[who].append(time_sweep(
                        (lambda c: old(model, tabs, c)) if who == "old" else
                        (lambda c: sweep_raw(model, tabs, c, lanes_t)), mid))
                o, n = (sum(turns[k]) / 2 for k in ("old", "new"))
                print(f"{tag} earlier vs this stepper_sweep, {name} B={B} "
                      f"slots={slots} (old, new, new, old): old "
                      f"{turns['old'][0]:.4f}/{turns['old'][1]:.4f} ms, new "
                      f"{turns['new'][0]:.4f}/{turns['new'][1]:.4f} ms per "
                      f"launch; old/new {o / n:.2f}x", flush=True)
            if name == "kv16" and slots:
                head = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
                kv_carry = cf
    # compact_carry on the KV carry: 4096 -> 256 lanes, the memo grown
    status = kv_carry.dsi[1].cpu().numpy()
    lanes = np.argsort(status != RUNNING, kind="stable")[:COMPACT_TO]
    slots = default_slots(COMPACT_TO, KV_KEYS)
    got = compact_carry(kv_carry, lanes, COMPACT_TO, slots)
    want = compact_carry_plain(kv_carry, lanes, COMPACT_TO, slots)
    torch.cuda.synchronize()
    comp_err = _compare("compact_carry of the kv16 sweep carry", got, want)
    ms = time_launches(lambda x: compact_carry(kv_carry, lanes, COMPACT_TO,
                                               slots), [None] * 11, 10)
    bound_ms, nbytes = compact_bound(kv_carry, got, len(lanes))
    print(f"{tag} compact_carry == plain on the kv16 sweep carry: "
          f"{DEVICE_BATCH} -> {COMPACT_TO} lanes, "
          f"{kv_carry.occ.shape[1]} -> {slots} slots "
          f"({int((got.occ == 1).sum())} memo entries after): all 7 planes "
          f"bit-identical; {ms:.4f} ms/launch (bound {bound_ms:.6f} ms by "
          f"bytes: {nbytes} B)", flush=True)
    return max_err, comp_err, head


# Ablation builds of stepper_sweep.cu: (name, text replaced, replacement).
# Each keeps the search exactly as it is (the same carries), so a time
# difference is the cost of what the variant adds or takes away.
SWEEP_ABLATIONS = (
    # one more dependent hash on every probe (p2 is 0 for KV: the hash
    # result is unchanged, the compiler cannot know)
    ("extra hash", "        h = mix_words<DH>(h, child, D);\n",
     "        h = mix_words<DH>(h, child, D);\n"
     "        h ^= mix_words<DH>(h, child, D) & static_cast<uint32_t>(a.p2);\n"),
    # one more dependent device-memory load before every key compare
    # (occupancy is 0 or 1: the offset is 0, the compiler cannot know)
    ("extra load",
     "          const int32_t* key = keys + static_cast<size_t>(sl) * kw;\n"
     "          bool eq",
     "          const int32_t* key = keys + static_cast<size_t>(sl) * kw +\n"
     "                               (occ[sl] & 0x40000000);\n"
     "          bool eq"),
    # the hash loop of a width without its own instantiation, at D = 16
    ("hash loop", "    case 16: return stepper_sweep_kernel<W, true, K, 16>;\n",
     ""),
)


def phase_sweep_ablation(kv_spec, kv_corpus, dev, tag):
    """``--ablate-sweep``: where a kv16 iteration's cycles go.  The
    kernel's time against the number of running lanes launched (1 to ~16
    warps an SM: a chain's latency, then the SM's issue), and each
    ablation build in turns with this one (this, variant, variant, this)
    at 1 warp an SM and at every running lane, memo off and on."""
    src = kernels.CSRC_DIR / "stepper_sweep.cu"
    text = src.read_text()
    out = kernels.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    launchers = {}
    for name, old, new in SWEEP_ABLATIONS:
        require(text.count(old) == 1, f"ablation '{name}': the source no "
                f"longer has its text")
        path = out / f"stepper_sweep_{name.replace(' ', '_')}.cu"
        path.write_text(text.replace(old, new))
        launchers[name] = path
    with ThreadPoolExecutor(len(launchers)) as pool:
        libs = dict(zip(launchers, pool.map(
            lambda kv: kernels.build(f"sweep_{kv[0].replace(' ', '_')}",
                                     src=kv[1]), launchers.items())))
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).stepper_sweep_launch
        fn.argtypes = list(kernels.stepper_sweep_lib(
        ).stepper_sweep_launch.argtypes)
        fn.restype = ctypes.c_int
        fns[name] = fn
    fns["this"] = kernels.stepper_sweep_lib().stepper_sweep_launch
    tabs, starts = sweep_inputs(kv_spec, _replicate(kv_corpus, DEVICE_BATCH),
                                KV_OPS, dev)
    model = sweep_model(kv_spec, dev)
    for slots in (0, default_slots(DEVICE_BATCH, KV_KEYS)):
        fresh = fresh_sweep_carry(tabs.nreq, np.arange(DEVICE_BATCH), starts,
                                  DEVICE_BATCH, KV_OPS, slots)
        mid = stepper_sweep_plain(kv_spec, tabs, fresh, chunk=SWEEP_MID,
                                  budget=TOTAL_BUDGET)
        run = running_lanes(mid)
        sms = device_sms(dev)
        for L in sorted({sms, 4 * sms, 8 * sms, len(run)}):
            lanes_t = torch.from_numpy(np.sort(np.random.default_rng(
                0).permutation(run)[:L]).astype(np.int32)).to(dev)
            ms = time_sweep(lambda c: sweep_raw(model, tabs, c, lanes_t),
                            mid)
            mhz = sm_clock_mhz()
            print(f"{tag} ablation kv16 slots={slots}: {L} running lanes "
                  f"({L / sms:.2f} warps an SM): {ms:.4f} ms/launch, "
                  f"{ms * 1e-3 * mhz * 1e6 / SWEEP_CHUNK:.0f} cycles an "
                  f"iteration at {mhz:.0f} MHz", flush=True)
            if L not in (sms, len(run)):
                continue
            want = sweep_raw(model, tabs, clone_carry(mid), lanes_t)
            for name in fns:
                if name == "this" or (not slots and name != "hash loop"):
                    continue
                got = sweep_raw(model, tabs, clone_carry(mid), lanes_t,
                                fn=fns[name])
                require(all(torch.equal(x, y) for x, y in zip(got, want)),
                        f"ablation '{name}' changed the search")
                turns = {"this": [], name: []}
                for who in ("this", name, name, "this"):
                    turns[who].append(time_sweep(
                        lambda c: sweep_raw(model, tabs, c, lanes_t,
                                            fn=fns[who]), mid))
                a, b = (sum(turns[k]) / 2 for k in ("this", name))
                mhz = sm_clock_mhz()
                cyc = (b - a) * 1e-3 * mhz * 1e6 / SWEEP_CHUNK
                print(f"{tag} ablation kv16 slots={slots} L={L}, '{name}' "
                      f"(this, variant, variant, this): this {a:.4f} ms, "
                      f"variant {b:.4f} ms: {cyc:+.0f} cycles an iteration "
                      f"at {mhz:.0f} MHz", flush=True)


# what check_corpus reports of a warm run, where a backend or the device
# engine inside it keeps the counter: the device driver's rounds; the
# stepper's device batches (each its own encoding and tables); the
# per-key split (sub-histories, the longest, host time of split, fold and
# stitch); the hybrid plan's division of the work
RUN_COUNTERS = ("rounds_run", "compactions", "chunk_launches",
                "device_batches", "subs_produced", "max_sub_len",
                "recombine_s", "device_decided", "tail_histories",
                "degradations")


def engine_of(backend):
    """The device engine inside a combinator (the per-key split's inner
    backend, the hybrid plan's device), or the backend itself."""
    if isinstance(backend, PComp):
        return backend.inner
    if isinstance(backend, HybridDevice):
        return backend.device
    return backend


def check_corpus(name, backend, spec, corpus, oracle, tag, witnesses=32):
    """``backend.check_histories`` on ``corpus`` replicated to 4096 lanes,
    cold and warm, then profiled; 0 verdict mismatches against ``oracle``
    wherever both decided; up to ``witnesses`` LINEARIZABLE witnesses
    replayed.  Returns the warm verdicts, the oracle's and both times."""
    device_corpus = _replicate(corpus, DEVICE_BATCH)
    t0 = time.perf_counter()
    cold = backend.check_histories(spec, device_corpus)
    cold_s = time.perf_counter() - t0
    objs = [backend] + ([engine_of(backend)]
                        if engine_of(backend) is not backend else [])
    counters = [(o, k) for o in objs for k in RUN_COUNTERS
                if hasattr(o, k)]
    before = [getattr(o, k) for o, k in counters]
    t0 = time.perf_counter()
    v = backend.check_histories(spec, device_corpus)
    warm_s = time.perf_counter() - t0
    after = ", ".join(
        f"{k} {getattr(o, k)}" if k == "max_sub_len"
        else f"{k} {getattr(o, k) - b:.3f}" if k == "recombine_s"
        else f"{k} {getattr(o, k) - b}"
        for (o, k), b in zip(counters, before))
    require(v.tolist() == cold.tolist(), f"{name}: verdicts differ between "
            f"runs")
    prof_wall, busy_s, top = profile_device(
        lambda: backend.check_histories(spec, device_corpus))
    t0 = time.perf_counter()
    ov = oracle.check_histories(spec, corpus)
    oracle_s = time.perf_counter() - t0
    uv = v[:len(corpus)]
    both = (uv != Verdict.BUDGET_EXCEEDED) & (ov != Verdict.BUDGET_EXCEEDED)
    mismatches = int(((uv != ov) & both).sum())
    require(mismatches == 0, f"{name}: {mismatches} verdict mismatches vs "
            f"the oracle")
    lin = [h for h, x in zip(corpus, uv)
           if x == Verdict.LINEARIZABLE][:witnesses]
    for h in lin:
        wv, wit = backend.check_witness(spec, h)
        require(wv == Verdict.LINEARIZABLE and verify_witness(spec, h, wit),
                f"{name}: a LINEARIZABLE witness failed to replay")
    idle = f"{1 - busy_s / prof_wall:.3f}" if busy_s else "not measured"
    print(f"{tag} {name} checker: {len(device_corpus)} histories "
          f"({len(corpus)} unique) warm {warm_s:.3f} s = "
          f"{len(device_corpus) / warm_s:.1f} histories/s (cold "
          f"{cold_s:.3f} s); {after}; undecided "
          f"{int((v == Verdict.BUDGET_EXCEEDED).sum())}; vs oracle "
          f"({oracle_s:.2f} s on the host): 0 mismatches "
          f"({int((uv == Verdict.LINEARIZABLE).sum())} linearizable, "
          f"{int((uv == Verdict.VIOLATION).sum())} violations, "
          f"{int(both.sum())} decided by both; the oracle: "
          f"{int((ov == Verdict.VIOLATION).sum())} violations); {len(lin)} "
          f"witnesses replayed; profiled: wall {prof_wall:.3f} s, device "
          f"busy {busy_s:.3f} s, idle share {idle}; top kernels {top}",
          flush=True)
    return dict(v=v, ov=ov, warm_s=warm_s, oracle_s=oracle_s)


def check_property(name, make_backend, spec, suts, cfg, tag, oracle=None,
                   all_decided=False):
    """``prop_concurrent``: the racy SUT convicted, the atomic one
    passed, nothing undecided on the atomic run (on both with
    ``all_decided``)."""
    for impl, sut, want_ok in (("racy", suts[1], False),
                               ("atomic", suts[0], True)):
        backend = make_backend()
        t0 = time.perf_counter()
        res = prop_concurrent(spec, sut, PropertyConfig(**cfg),
                              backend=backend, oracle=oracle)
        dt = time.perf_counter() - t0
        require(res.ok == want_ok, f"{name} {impl}: ok={res.ok}")
        require((not want_ok and not all_decided) or res.undecided == 0,
                f"{name} {impl}: {res.undecided} undecided")
        what = ""
        if not want_ok:
            cx = res.counterexample
            what = (f", counterexample {len(cx.program)} ops after "
                    f"{cx.shrink_steps} shrink steps")
        print(f"{tag} property {impl} {name} {cfg['n_pids']} pids x "
              f"{cfg['max_ops']} ops ({type(backend).__name__}): "
              f"ok={res.ok} after {res.trials_run} trials, "
              f"{res.histories_checked} histories, undecided "
              f"{res.undecided}, {dt:.2f} s{what}", flush=True)


def phase_kv16(spec, corpus, tag):
    """Phases 10-11 (main path of the sweep regime): TorchStepper on the
    kv16 corpus, then prop_concurrent on kv16.  Returns the checker's
    verdicts."""
    t = TorchStepper(spec)
    require(t.regime == "sweep", f"kv16 took the {t.regime} regime")
    oracle = PComp(spec)  # the memo oracle on each key's sub-history
    v = check_corpus("kv16", t, spec, corpus, oracle, tag)["v"]
    # the batch's set-up stages, timed alone on the same 4096 histories
    device_corpus = _replicate(corpus, DEVICE_BATCH)
    t0 = time.perf_counter()
    flatten(spec, device_corpus, None, t.max_expansions, uses_table=False)
    t_flat = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = encode_batch(device_corpus, spec.initial_state(), max_ops=KV_OPS)
    prec = enc.precedes()
    t_enc = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep_tables(enc.ops[:, :, 1], enc.ops[:, :, 2], enc.ops[:, :, 3],
                 enc.valid, prec, t.device)
    torch.cuda.synchronize()
    t_tab = time.perf_counter() - t0
    print(f"{tag} kv16 batch set-up alone: host contracts {t_flat:.3f} s, "
          f"encoding and precedence {t_enc:.3f} s (host), sweep tables "
          f"{t_tab:.3f} s (to the card, synchronised)", flush=True)
    check_property("kv16", lambda: TorchStepper(spec), spec,
                   (AtomicKvSUT(spec), StaleCacheKvSUT(spec)),
                   dict(n_trials=30, n_pids=KV_PIDS, max_ops=KV_OPS, seed=0),
                   tag, oracle=oracle)
    return v


def kv4_corpus():
    """The KV milestone: the registry's KV default, 4 keys."""
    spec = KvSpec()
    return spec, build_corpus(spec, (AtomicKvSUT, StaleCacheKvSUT),
                              n=N_UNIQUE, n_pids=KV_PIDS, max_ops=KV_OPS,
                              seed_base=1000, seed_prefix="bench")


def phase_milestones(tag):
    """Phase 12: the two milestone configurations the port could not
    check before: KV at its default size (4 keys, a 256-state shadow)
    through TorchStepper's table regime; the ticket dispenser through
    TorchGPU and TorchStepper.  Each kernel's launches are counted over
    its path alone.  Returns the KV milestone checker's verdicts."""
    spec, corpus = kv4_corpus()
    oracle = PComp(spec)
    stepper_chunk.launches = compact_carry.launches = 0
    t = TorchStepper(spec)
    require(t.regime == "table" and t.kspec.n_packed == 256,
            "KV at its default size is not on the table regime's shadow")
    kv4_v = check_corpus("kv (4 keys)", t, spec, corpus, oracle, tag)["v"]
    check_property("kv (4 keys)", lambda: TorchStepper(spec), spec,
                   (AtomicKvSUT(spec), StaleCacheKvSUT(spec)),
                   dict(n_trials=40, n_pids=KV_PIDS, max_ops=KV_OPS,
                        seed=13), tag, oracle=oracle)
    print(f"{tag} path of the KV milestone: {stepper_chunk.launches} "
          f"stepper_chunk, {compact_carry.launches} compact_carry launches",
          flush=True)
    require(stepper_chunk.launches > 0, "the KV milestone launched no "
            "stepper_chunk")
    tspec = TicketSpec()
    corpus = build_corpus(tspec, (lambda s: AtomicTicketSUT(),
                                  lambda s: RacyTicketSUT()), n=N_UNIQUE,
                          n_pids=TICKET_PIDS, max_ops=TICKET_OPS,
                          seed_base=1000, seed_prefix="bench")
    suts = (AtomicTicketSUT(), RacyTicketSUT())
    cfg = dict(n_trials=60, n_pids=TICKET_PIDS, max_ops=TICKET_OPS, seed=99)
    for label, make, counter in (("TorchGPU", TorchGPU, dfs_chunk),
                                 ("TorchStepper", TorchStepper,
                                  stepper_chunk)):
        counter.launches = 0
        check_corpus(f"ticket via {label}", make(tspec), tspec, corpus,
                     WingGongCPU(memo=True), tag)
        check_property(f"ticket via {label}", lambda: make(tspec), tspec,
                       suts, cfg, tag)
        print(f"{tag} path of the ticket milestone through {label}: "
              f"{counter.launches} {counter.__name__} launches", flush=True)
        require(counter.launches > 0, f"the ticket milestone launched no "
                f"{counter.__name__} through {label}")
    return kv4_v


def registry_corpus(model):
    """A registry model at its default spec and size."""
    entry = MODELS[model]
    spec = entry.make_spec()
    return spec, build_corpus(
        spec, (entry.impls["atomic"], entry.impls["racy"]), n=N_UNIQUE,
        n_pids=entry.default_pids, max_ops=entry.default_ops,
        seed_base=1000, seed_prefix="bench")


def path_launches(name, tag, counters):
    """Print the launches of each kernel in ``counters`` since they were
    set to 0, and require one of the first."""
    print(f"{tag} path of {name}: " + ", ".join(
        f"{c.launches} {c.__name__}" for c in counters) + " launches",
        flush=True)
    require(counters[0].launches > 0,
            f"{name} launched no {counters[0].__name__}")
    return {c.__name__: c.launches for c in counters}


class FirstInputs:
    """Inside ``with``: the inputs of the first ``stepper_chunk`` launch of
    each of the first ``keep`` device batches, of the first
    ``compact_carry``, of the first ``stepper_sweep`` and of the first
    ``dfs_chunk`` that the device backends run, cloned before the launch,
    so that a path's own shapes (its tables, bucket, op count, slots,
    start states and chunk) can be held against the plain versions after
    the path's launches are read.  The backends' module names are swapped
    for pass-through functions: each launch is still counted once, by
    the wrapper it reaches."""

    def __init__(self, keep=1):
        self.keep = keep
        self.steps = []  # (tables, fresh carry, kwargs) a device batch
        self.comp = self.sweep = self.dfs = None

    @property
    def step(self):
        return self.steps[0] if self.steps else None

    def _step(self, tabs, carry, **kw):
        # a device batch builds its own tables: a new tables object is a
        # new batch (the kept ones stay alive, so identity is safe)
        if len(self.steps) < self.keep and all(
                t is not tabs for t, _, _ in self.steps):
            self.steps.append((tabs, clone_carry(carry), kw))
        return stepper_chunk(tabs, carry, **kw)

    def _comp(self, carry, lanes, bucket, slots):
        if self.comp is None:
            self.comp = (clone_carry(carry), np.array(lanes), bucket, slots)
        return compact_carry(carry, lanes, bucket, slots)

    def _sweep(self, model, tabs, carry, **kw):
        if self.sweep is None:
            self.sweep = (model, tabs, clone_carry(carry), dict(kw))
        return stepper_sweep(model, tabs, carry, **kw)

    def _dfs(self, tabs, carry, **kw):
        if self.dfs is None:
            self.dfs = (tabs, Carry(*(t.clone() for t in carry)), kw)
        return dfs_chunk(tabs, carry, **kw)

    def __enter__(self):
        stepper_module.stepper_chunk = self._step
        stepper_module.compact_carry = self._comp
        stepper_module.stepper_sweep = self._sweep
        gpu_module.dfs_chunk = self._dfs
        return self

    def __exit__(self, *exc):
        stepper_module.stepper_chunk = stepper_chunk
        stepper_module.compact_carry = compact_carry
        stepper_module.stepper_sweep = stepper_sweep
        gpu_module.dfs_chunk = dfs_chunk


def hold_path_kernels(name, first, tag, spec=None):
    """The kernels of a path against their plain versions, on the path's
    own inputs (``first``, a :class:`FirstInputs`): see
    :func:`hold_start`.  Called after the path's launches are read.
    Returns the largest error."""
    return hold_start(name, first, tag, spec)()


def hold_start(name, first, tag, spec=None, sample_lanes=SAMPLE_LANES):
    """Start holding a path's kernels against their plain versions, on
    the path's own inputs (``first``, a :class:`FirstInputs`): one chunk
    of ``stepper_chunk`` from each kept batch's fresh carry at full width
    on the card, the plain version on a lane sample on the CPU (as in
    phase 6, in a worker process), all 7 planes of the sample compared;
    the path's first compaction against ``compact_carry_plain`` at full
    width; its first ``stepper_sweep`` launch (lanes as the path listed
    them) against ``stepper_sweep_plain`` of ``spec`` on a lane sample;
    its first ``dfs_chunk`` launch against ``dfs_chunk_plain`` at full
    width on the card.  A sample holds up to ``sample_lanes`` running
    lanes.  The card's side runs now; returns a function that
    waits for the samples, compares and prints, and returns the largest
    error."""
    err = 0
    pending = []   # (sample, what, line printed once it holds)
    for i, (tabs, c0, kw) in enumerate(first.steps):
        B, N, slots = c0.row.shape[0], tabs.vocab.shape[1], c0.occ.shape[1]
        cpu_tabs = type(tabs)(*(t.cpu() for t in tabs))
        sample = LaneSample(c0, min(sample_lanes, B), functools.partial(
            stepper_chunk_plain, cpu_tabs, **kw), size=sample_lanes)
        sample.start(1)
        ck = clone_carry(c0)
        stepper_chunk(tabs, ck, **kw)
        sample.keep(ck)
        pending.append((
            sample, f"stepper_chunk on the path of {name}, batch {i + 1}",
            f"{tag} stepper_chunk == plain on the path of {name}: its "
            f"batch {i + 1}, B={B} N={N} slots={slots}, from the fresh "
            f"carry, one chunk of {kw['chunk']} at budget {kw['budget']}: "
            f"all 7 planes bit-identical on a sample of "
            f"{len(sample.lanes)} lanes; "
            f"{int((ck.dsi[1] == RUNNING).sum())} of {B} still running"))
    if first.comp is not None:
        c, lanes, to, new_slots = first.comp
        got = compact_carry(c, lanes, to, new_slots)
        want = compact_carry_plain(c, lanes, to, new_slots)
        torch.cuda.synchronize()
        err = max(err, _compare(f"compact_carry on the path of {name}",
                                got, want))
        print(f"{tag} compact_carry == plain on the path of {name}: its "
              f"first compaction, {c.row.shape[0]} -> {to} lanes, "
              f"{c.occ.shape[1]} -> {new_slots} slots: all 7 planes "
              f"bit-identical at full width", flush=True)
    elif first.steps:
        print(f"{tag} compact_carry on the path of {name}: the path made "
              f"no compaction", flush=True)
    if first.sweep is not None:
        require(spec is not None, f"{name}: stepper_sweep ran; hold it "
                f"with the path's spec")
        model, tabs, c0, kw = first.sweep
        B, D = c0.row.shape[0], c0.states.shape[2]
        cpu_tabs = type(tabs)(*(t.cpu() for t in tabs))
        sample = LaneSample(c0, min(sample_lanes, B), functools.partial(
            stepper_sweep_plain, spec, cpu_tabs, chunk=kw["chunk"],
            budget=kw["budget"]), size=sample_lanes)
        sample.start(1)
        ck = clone_carry(c0)
        stepper_sweep(model, tabs, ck, **kw)
        sample.keep(ck)
        starts = c0.states[:, 0].cpu().numpy()
        init = np.asarray(spec.initial_state(), np.int32)
        pending.append((
            sample, f"stepper_sweep on the path of {name}",
            f"{tag} stepper_sweep == plain on the path of {name}: its "
            f"first launch, B={B} N={tabs.cmd.shape[1]} D={D} slots="
            f"{c0.occ.shape[1]}, {int((starts != init).any(1).sum())} "
            f"lanes starting outside the initial state, "
            f"{0 if kw.get('lanes') is None else len(kw['lanes'])} lanes "
            f"listed, one chunk of {kw['chunk']}: all 7 planes "
            f"bit-identical on a sample of {len(sample.lanes)} lanes"))
    if first.dfs is not None:
        tabs, c0, kw = first.dfs
        got = dfs_chunk(tabs, Carry(*(t.clone() for t in c0)), **kw)
        want = dfs_chunk_plain(tabs, Carry(*(t.clone() for t in c0)), **kw)
        torch.cuda.synchronize()
        for plane, a, b in zip(Carry._fields, got, want):
            e = int((a.long() - b.long()).abs().max())
            err = max(err, e)
            require(e == 0, f"dfs_chunk on the path of {name}: {plane} "
                    f"differs from plain (max abs err {e})")
        print(f"{tag} dfs_chunk == plain on the path of {name}: its first "
              f"launch, B={c0.dsi.shape[1]} N={tabs.nxt.shape[1]}, one chunk "
              f"of {kw['chunk']}: all 7 planes bit-identical at full width",
              flush=True)

    def finish():
        out = err
        for sample, what, line in pending:
            out = max(out, sample.check(what))
            print(line, flush=True)
        return out
    return finish


def phase_pcomp(cases, tag):
    """Phase 13: per-key decomposition on the card.  ``cases``: (name,
    spec, unique corpus, the whole-history checker's verdicts from an
    earlier phase, or None: then ``TorchStepper``'s on the unique corpus,
    run before the path's counts are reset).  Each corpus goes through
    ``PComp(spec, TorchStepper)`` at 4096 lanes: no lane undecided, 0
    mismatches against the memo oracle per key, the whole-history
    verdicts wherever that checker decided (it shares no split or fold
    with the path), a sample of stitched witnesses replayed; the first
    case's property run too.  Each case is its own main path; its
    kernels are then held against their plain versions on its own first
    inputs.  Returns the launches of each and the largest error."""
    launches, err = {}, 0
    for i, (name, spec, corpus, whole) in enumerate(cases):
        if whole is None:
            whole = TorchStepper(spec).check_histories(spec, corpus)
        stepper_chunk.launches = compact_carry.launches = 0
        pc = PComp(spec, lambda p: TorchStepper(p))
        require(pc.inner.regime == "table",
                f"{name}: the sub-histories are not on the table regime")
        with FirstInputs() as first:
            r = check_corpus(f"{name} per key", pc, spec, corpus,
                             PComp(spec), tag, witnesses=8)
        v = r["v"]
        und = int((v == Verdict.BUDGET_EXCEEDED).sum())
        require(und == 0, f"{name} per key: {und} lanes undecided")
        decided = whole != Verdict.BUDGET_EXCEEDED
        require(decided.any(), f"{name}: the whole-history checker "
                f"decided nothing to compare with")
        require((v[:len(whole)][decided] == whole[decided]).all(),
                f"{name} per key: verdicts differ from the whole-history "
                f"checker's")
        agree = (f"; equal to the whole-history checker's on its "
                 f"{int(decided.sum())} decided of {len(whole)} lanes, "
                 f"decides its {int((~decided).sum())} undecided ones")
        device_corpus = _replicate(corpus, DEVICE_BATCH)
        t0 = time.perf_counter()
        subs = [split_history(spec, h) for h in device_corpus]
        split_s = time.perf_counter() - t0
        print(f"{tag} {name} per key: {len(v)} lanes, 0 undecided{agree}; "
              f"a batch splits into {sum(map(len, subs))} sub-histories "
              f"(the longest {max(len(x) for d in subs for x in d.values())}"
              f" ops) in {split_s:.3f} s on the host, split alone; over all "
              f"runs {pc.subs_produced} sub-histories, "
              f"{pc.inner.device_batches} device batches of the inner "
              f"TorchStepper", flush=True)
        if i == 0:
            suts = tuple(MODELS["kv"].impls[k](spec)
                         for k in ("atomic", "racy"))
            check_property(f"{name} per key",
                           lambda: PComp(spec, lambda p: TorchStepper(p)),
                           spec, suts, dict(n_trials=30, n_pids=KV_PIDS,
                                            max_ops=KV_OPS, seed=0),
                           tag, oracle=PComp(spec), all_decided=True)
        launches[name] = path_launches(f"{name} per key", tag,
                                       (stepper_chunk, compact_carry))
        err = max(err, hold_path_kernels(f"{name} per key", first, tag))
    return launches, err


def phase_hybrid(cases, tag):
    """Phase 14: the hybrid plan on the card, and the native host oracle
    against the memo oracle.  ``cases``: (name, spec, unique corpus, a
    time to set beside, its label).  Each corpus goes through
    ``HybridDevice(spec)`` (budget 2000) at 4096 lanes: verdicts equal to
    the memo oracle's, no lane undecided, no degrade, the device deciding
    some; then ``CppOracle`` and the memo oracle on the unique corpus,
    verdicts equal.  Each case is its own main path; its kernels are then
    held against their plain versions on its own first inputs.  Returns
    the launches of each and the largest error."""
    launches, err = {}, 0
    for name, spec, corpus, beside, label in cases:
        stepper_chunk.launches = compact_carry.launches = 0
        hb = HybridDevice(spec)
        require(isinstance(hb.tail, native.CppOracle),
                f"{name}: the hybrid tail is {hb.tail.name}, not the "
                f"native oracle")
        with FirstInputs() as first:
            r = check_corpus(f"{name} hybrid", hb, spec, corpus,
                             WingGongCPU(memo=True), tag)
        v = r["v"]
        und = int((v == Verdict.BUDGET_EXCEEDED).sum())
        require(und == 0, f"{name} hybrid: {und} lanes undecided")
        require(hb.degradations == 0, f"{name} hybrid: degraded "
                f"({hb.last_error})")
        require(hb.device_decided > 0, f"{name} hybrid: the device "
                f"decided nothing")
        print(f"{tag} {name} hybrid: warm {r['warm_s']:.3f} s for "
              f"{len(v)} lanes (beside {label} {beside:.3f} s), 0 "
              f"undecided; over all its runs the device decided "
              f"{hb.device_decided}, the native tail {hb.tail_histories}",
              flush=True)
        launches[name] = path_launches(f"{name} hybrid", tag,
                                       (stepper_chunk, compact_carry))
        err = max(err, hold_path_kernels(f"{name} hybrid", first, tag))
        cpp = native.CppOracle(spec)
        t0 = time.perf_counter()
        cv = cpp.check_histories(spec, corpus)
        cpp_s = time.perf_counter() - t0
        require(cv.tolist() == r["ov"].tolist(),
                f"{name}: CppOracle and the memo oracle disagree")
        print(f"{tag} {name} host oracles on {len(corpus)} unique "
              f"histories: CppOracle {cpp_s:.3f} s ({cpp.native_histories} "
              f"native, {cpp.fallback_histories} to the fallback), "
              f"WingGongCPU(memo=True) {r['oracle_s']:.3f} s, equal "
              f"verdicts", flush=True)
    return launches, err


# ---------------------------------------------------------------------------
# Phase 15: the generation plane
# ---------------------------------------------------------------------------

GEN_FAMILIES = ("rangeset", "semaphore", "register")  # tools/bench_gen.py
GEN_PIDS, GEN_OPS = 8, 32      # bench_gen's larger geometry
GEN_LANES, GEN_SAMPLE = 4096, 256
GEN_BATCH, GEN_ROUNDS, GEN_SEED = 1024, 4, 17
GEN_WITNESSES = 64
DRAW_SEEDS = (0, 7, 17, 2**31, 2**32 + 5, -3, 1_000_004)
# one word; rows that are not a multiple of the kernel's 16-word unit or
# of 4 (4-byte stores); more units than the grid (65537 x 3); the main
# path's 1024 x 816; the timed shapes
DRAW_SHAPES = ((1, 1), (5, 3), (33, 17), (9, 33), (3, 4097), (65537, 3),
               (1024, 816), (4096, 624), (4096, 3120))
# timed: the main path's shape (GEN_BATCH x _n_draws(GEN_OPS)) first
DRAW_TIMED = ((1024, 816), (4096, 624), (4096, 3120))
DRAW_WORDS_A_UNIT = 16         # csrc/threefry_draws.cu's G
# the known answers of the JAX package's _raw_draws_jax, taken on the CPU
KNOWN_DRAW_ROWS = (
    (7, (3, 5), {0: [3725328165, 2389352394, 1291398195, 1428036129,
                     4260943734]}),
    (-3, (2, 3), {0: [2585318788, 4151447820, 471961339],
                  1: [2707064578, 2513172215, 3288622452]}),
    (2**32 + 5, (2, 3), {0: [2839113055, 3758129494, 1086722469],
                         1: [359975681, 984463424, 482527479]}))
KNOWN_DRAW_17 = dict(head=[2639664804, 3479077941, 2518621796, 1267003793],
                     tail=[1348504043, 1475632984, 2031686271, 3777973134],
                     xor=3671365389, sum=4283564019)
# integer operations a word, counted from the first version of
# csrc/threefry_draws.cu (kept, so that the bound stays comparable across
# versions): 20 rounds of add, rotate, xor; 12 key injections (adds); the
# output xor; the row index, address and loop (3)
THREEFRY_OPS_PER_WORD = 20 * 3 + 12 + 1 + 3
# thread-instructions an SM issues a clock (4 schedulers, a warp each),
# and 32-bit integer add / shift / logic, or multiply-add, results a clock
# an SM (the CUDA C++ Programming Guide's arithmetic-throughput table,
# compute capability 9.0), for the SASS floors
ISSUE_PER_CLOCK_SM, INT_PER_CLOCK_SM = 128, 64


def draws_bound(n_lanes: int, n_draws: int):
    """(bound_ms, bound_by): the table written once, one threefry a
    word."""
    words = n_lanes * n_draws
    t_bytes = words * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = words * THREEFRY_OPS_PER_WORD / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def draws_c_entry(lib: Path, first_version=False):
    """``launch(out, seed)`` through a built ``threefry_draws`` library's
    C entry alone, uncounted: this source's (the SM count among its
    arguments), or with ``first_version`` the first version's (out,
    seed, lanes, draws, stream)."""
    fn = ctypes.CDLL(str(lib)).threefry_draws_launch
    sizes = [ctypes.c_longlong] * 2
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32, *sizes,
                   *([] if first_version else [ctypes.c_int]),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(out, seed):
        sms = [] if first_version else [device_sms(out.device)]
        rc = fn(out.data_ptr(), seed_word(seed), *out.shape, *sms,
                torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"{lib.name} failed ({rc})")
        return out
    return launch


def time_queued(launch, out, seed=GEN_SEED, reps=100) -> float:
    """ms per launch of ``launch(out, seed)``, CUDA events, the launches
    queued behind a spin of the card long enough for the host to enqueue
    them all (checked; the spin doubles until it is), so that the host's
    launch time cannot starve the card: the card's time alone, launch
    gaps included."""
    launch(out, seed)
    torch.cuda.synchronize()
    spin = 20_000_000  # cycles: ~10 ms at 1980 MHz
    while True:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(spin)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            launch(out, seed)
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        spin *= 2


def time_draws(n_lanes: int, n_draws: int, dev, reps=50):
    """(kernel ms per launch queued (``time_queued``), ms per launch
    through the wrapper back to back (``time_launches``, as the other
    kernels are timed: the host's launch rate at small shapes), the
    plain version's ms once, synchronised) on the table of seed 17."""
    out = torch.empty((n_lanes, n_draws), dtype=torch.int32, device=dev)
    launches = threefry_draws.launches
    ms = time_queued(threefry_draws, out)
    unqueued = time_launches(lambda o: threefry_draws(o, GEN_SEED),
                             [out] * (reps + 1), reps)
    threefry_draws.launches = launches  # timing launches are not the path's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw_draws_plain(GEN_SEED, n_lanes, n_draws, device=dev)
    torch.cuda.synchronize()
    return ms, unqueued, (time.perf_counter() - t0) * 1e3


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_functions(lib: Path) -> dict:
    """``{function: [(address, opcode, operands)]}`` from ``cuobjdump
    -sass`` on a built library, or {} when the toolkit has no
    cuobjdump."""
    tool = Path(kernels.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    text = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return parse_sass(text)


def parse_sass(text: str) -> dict:
    """``{function: [(address, opcode, operands)]}`` of ``cuobjdump
    -sass`` text."""
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = _SASS_LINE.search(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(3),
                            m.group(4).strip()))
    return funcs


def hot_loop(instrs):
    """The instructions of a function's innermost loop with the most
    funnel shifts (the rotations): the body from a backward branch's
    target to the branch."""
    loops = []
    for addr, op, args in instrs:
        m = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if not any(a <= c and d <= b and (c, d) != (a, b)
                        for c, d in loops)]
    bodies = [[x for x in instrs if a <= x[0] <= b] for a, b in inner]
    return max(bodies, key=lambda body: sum(op.startswith("SHF")
                                            for _, op, _ in body),
               default=[])


# SASS opcodes by the pipe that retires them: the ALU pipe (logic,
# shifts, adds, compares) and the FMA pipe's integer multiply-add, which
# nvcc also uses for plain adds (IMAD.IADD) and moves
ALU_OPS = frozenset(("LOP3", "SHF", "IADD3", "ISETP", "LEA", "SEL", "VIADD",
                     "PRMT", "IMNMX", "VIMNMX", "PLOP3", "FLO", "POPC",
                     "IABS", "BMSK", "SGXT"))


def sass_per_word(lib: Path, words_a_trip=None) -> dict:
    """For each kernel function of ``lib``: ``{name: (instructions of
    its hot loop, funnel shifts there, words a trip, (instructions, ALU
    instructions, IMAD instructions) a word, top opcodes)}``.
    ``words_a_trip`` None: one word a 20 rotations (one threefry a word,
    the lane key outside the loop)."""
    rows = {}
    for name, instrs in sass_functions(lib).items():
        body = hot_loop(instrs)
        if not body:
            continue
        rot = sum(op.startswith("SHF") for _, op, _ in body)
        words = words_a_trip or max(1, rot // 20)
        ops = {}
        for _, op, _ in body:
            key = op.split(".")[0]
            ops[key] = ops.get(key, 0) + 1
        alu = sum(n for k, n in ops.items() if k in ALU_OPS)
        per_word = (len(body) / words, alu / words, ops.get("IMAD", 0) /
                    words)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
        rows[name] = (len(body), rot, words, per_word, top)
    return rows


def print_sass(lib: Path, what: str, tag, words_a_trip=None) -> dict:
    """Print :func:`sass_per_word`'s rows; returns ``{name: (instructions,
    ALU, IMAD) a word}`` ({} without cuobjdump)."""
    rows = sass_per_word(lib, words_a_trip)
    if not rows:
        print(f"{tag} SASS of {what}: not measured (no cuobjdump)",
              flush=True)
    for name, (n, rot, words, per_word, top) in rows.items():
        print(f"{tag} SASS {what} {name}: hot loop {n} instructions, "
              f"{rot} funnel shifts, {words} words a trip: "
              f"{per_word[0]:.2f} instructions a word ({per_word[1]:.2f} "
              f"ALU, {per_word[2]:.2f} IMAD); top {top}", flush=True)
    return {name: row[3] for name, row in rows.items()}


def instantiation(plan) -> str:
    """The mangled name's part that tells ``threefry_draws_kernel<V>`` of
    ``plan`` from the other store width."""
    return f"threefry_draws_kernelILi{4 if plan.vector else 1}E"


def sass_floor_ms(words: int, per_word, mhz: float, sms: int):
    """(floor ms, what sets it) of ``words`` at ``per_word`` =
    (instructions, ALU, IMAD) a word: the largest of the issue floor
    (``ISSUE_PER_CLOCK_SM``) and the ALU and FMA pipes' floors
    (``INT_PER_CLOCK_SM`` each)."""
    hz = mhz * 1e6 * sms
    return max((words * per_word[0] / (ISSUE_PER_CLOCK_SM * hz) * 1e3,
                "issue"),
               (words * per_word[1] / (INT_PER_CLOCK_SM * hz) * 1e3,
                "ALU pipe"),
               (words * per_word[2] / (INT_PER_CLOCK_SM * hz) * 1e3,
                "IMAD pipe"))


def phase_draws(dev, tag):
    """Phase 15 (a): ``threefry_draws`` against its plain version on the
    card at every seed and shape (tolerance 0) and on misaligned tables
    (4-byte stores), the known answers of the JAX package's table, then the kernel timed at the
    shapes of ``DRAW_TIMED`` beside its bound and its SASS floor.  Returns
    the largest error and the timing rows."""
    launches = threefry_draws.launches
    for seed in DRAW_SEEDS:
        for shape in DRAW_SHAPES:
            got = raw_draws(seed, *shape, device=dev)
            want = raw_draws_plain(seed, *shape, device=dev)
            require(torch.equal(got, want), f"threefry_draws differs from "
                    f"plain at seed {seed}, {shape}")
    for shape in ((64, 816), (5, 3120), (3, 4)):
        n = shape[0] * shape[1]
        buf = torch.full((n + 4,), 12345, dtype=torch.int32, device=dev)
        out = buf[1:1 + n].view(shape)
        require(not draws_plan(out).vector, f"{shape} misaligned: the plan "
                f"still takes 16-byte stores")
        threefry_draws(out, 11)
        require(torch.equal(out, raw_draws_plain(11, *shape, device=dev))
                and int(buf[0]) == 12345 and int(buf[-3:].ne(12345).sum())
                == 0, f"threefry_draws on a misaligned {shape} table "
                f"differs from plain")
    for seed, shape, rows in KNOWN_DRAW_ROWS:
        t = table_to_host(raw_draws(seed, *shape, device=dev))
        for i, row in rows.items():
            require(t[i].tolist() == row, f"threefry_draws: seed {seed} row "
                    f"{i} is not the JAX package's")
    t = table_to_host(raw_draws(GEN_SEED, 4096, 3120, device=dev))
    require(t[0, :4].tolist() == KNOWN_DRAW_17["head"]
            and t[4095, -4:].tolist() == KNOWN_DRAW_17["tail"]
            and int(np.bitwise_xor.reduce(t.ravel())) == KNOWN_DRAW_17["xor"]
            and int(t.astype(np.uint64).sum() % 2**32)
            == KNOWN_DRAW_17["sum"],
            "threefry_draws: seed 17 at 4096 x 3120 is not the JAX "
            "package's table")
    threefry_draws.launches = launches
    print(f"{tag} threefry_draws == plain: seeds {list(DRAW_SEEDS)} x "
          f"shapes {list(DRAW_SHAPES)}, every word bit-identical; misaligned "
          f"tables (4-byte stores) equal; known answers of _raw_draws_jax "
          f"equal (seed 17, 4096 x 3120: XOR {KNOWN_DRAW_17['xor']}, sum "
          f"{KNOWN_DRAW_17['sum']})", flush=True)
    sass = print_sass(kernels.library_path("threefry_draws"),
                      "threefry_draws", tag, DRAW_WORDS_A_UNIT)
    rows = {}
    sms = device_sms(dev)
    for shape in DRAW_TIMED:
        ms, unqueued, plain_ms = time_draws(*shape, dev)
        mhz = sm_clock_mhz()
        bound_ms, by = draws_bound(*shape)
        rows[shape] = dict(ms=ms, wrapper_ms=unqueued, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=by)
        p = draws_plan(torch.empty(shape, dtype=torch.int32, device=dev))
        per_word = next((w for name, w in sass.items()
                         if instantiation(p) in name), None)
        floor = ("not measured" if per_word is None else
                 "{:.6f} ms by the {}".format(*sass_floor_ms(
                     shape[0] * shape[1], per_word, mhz, sms)))
        print(f"{tag} threefry_draws {shape[0]} x {shape[1]}: {ms:.6f} ms "
              f"a launch queued ({unqueued:.6f} through the wrapper back "
              f"to back), bound {bound_ms:.6f} ms by {by} "
              f"({ms / bound_ms:.2f}x); SASS floor at {mhz:.0f} MHz: "
              f"{floor}; plan {p._asdict()}; plain {plain_ms:.3f} ms",
              flush=True)
    return 0, rows


def phase_against_draws(src: Path, dev, tag):
    """``--against-draws``: an earlier ``threefry_draws.cu`` (the first
    version's C entry: out, seed, lanes, draws, stream) built as its own library, its
    ``-Xptxas -v`` report and SASS beside this source's, both checked
    equal to the plain version at every ``DRAW_TIMED`` shape, then timed
    in turns (old, new, new, old; ``time_queued``) beside
    ``draws_bound``.  Returns ``{shape: {who: ms}}``."""
    old_lib = kernels.build("threefry_draws_against", src=src)
    for who, name, path in (("earlier", "threefry_draws_against", src),
                            ("this", "threefry_draws",
                             kernels.CSRC_DIR / "threefry_draws.cu")):
        for line in kernels.library_path(name, path).with_suffix(
                ".ptxas.txt").read_text().splitlines():
            if any(k in line for k in ("registers", "stack frame",
                                       "Compiling entry")):
                print(f"  ptxas ({who} threefry_draws): {line.strip()}")
    print_sass(old_lib, "the earlier threefry_draws", tag)
    print_sass(kernels.library_path("threefry_draws"), "threefry_draws",
               tag, DRAW_WORDS_A_UNIT)
    old = draws_c_entry(old_lib, first_version=True)
    new = draws_c_entry(kernels.library_path("threefry_draws"))
    result = {}
    for shape in DRAW_TIMED:
        want = raw_draws_plain(GEN_SEED, *shape, device=dev)
        for who, launch in (("old", old), ("new", new)):
            got = launch(torch.empty_like(want), GEN_SEED)
            require(torch.equal(got, want), f"{who} threefry_draws differs "
                    f"from plain at {shape}")
        out = torch.empty_like(want)
        bound_ms, by = draws_bound(*shape)
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(time_queued(old if who == "old" else new,
                                          out))
        print(f"{tag} threefry_draws in turns at {shape[0]} x {shape[1]} "
              f"(bound {bound_ms:.6f} ms by {by}): old "
              f"{turns['old'][0]:.6f} / {turns['old'][1]:.6f} ms, new "
              f"{turns['new'][0]:.6f} / {turns['new'][1]:.6f} ms: "
              f"{sum(turns['old']) / sum(turns['new']):.2f}x; new "
              f"{min(turns['new']) / bound_ms:.2f}x its bound", flush=True)
        result[shape] = turns
    return result


class GenStages:
    """Inside ``with``: ``gen/core.py``'s device table swapped for a
    pass-through that makes the same two calls (``raw_draws`` on the
    card, then ``table_to_host``, the copy through pinned memory) with a
    synchronise between them, so that the draw and the copy are timed
    apart.  Each launch is still counted once, by the wrapper it reaches.
    ``calls`` keeps (seed, lanes, draws, the card's table) of each
    call."""

    def __init__(self):
        self.draw_s = self.copy_s = 0.0
        self.calls = []

    def _device_table(self, seed, n_lanes, n_draws, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tab = raw_draws(seed, n_lanes, n_draws, device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = table_to_host(tab)
        self.copy_s += time.perf_counter() - t1
        self.draw_s += t1 - t0
        self.calls.append((seed, n_lanes, n_draws, tab))
        return host

    def __enter__(self):
        gen_core._raw_draws_device = self._device_table
        return self

    def __exit__(self, *exc):
        gen_core._raw_draws_device = _DEVICE_TABLE


_DEVICE_TABLE = gen_core._raw_draws_device


def phase_generate(dev, tag):
    """Phase 15 (b): ``generate_batch(path="jax")`` on the card for each
    family at 8 pids x 32 ops and 4096 lanes: the card's table equal to
    the plain version's, the first 256 histories equal to the
    ``device="cpu"`` call's; the draw, the copy and the assembly timed
    apart; then the copy alone in turns with a pageable one
    (``time_copies``)."""
    profile = GenProfile(n_pids=GEN_PIDS, n_ops=GEN_OPS)
    for fam in GEN_FAMILIES:
        spec = MODELS[fam].make_spec()
        with GenStages() as st:
            t0 = time.perf_counter()
            hs = generate_batch(spec, profile, GEN_SEED, GEN_LANES,
                                path="jax")
            total = time.perf_counter() - t0
        (seed, lanes, draws, tab), = st.calls
        require(torch.equal(tab, raw_draws_plain(seed, lanes, draws,
                                                 device=dev)),
                f"{fam}: the card's table differs from the plain version's")
        cpu = generate_batch(spec, profile, GEN_SEED, GEN_SAMPLE,
                             path="jax", device="cpu")
        require([h.fingerprint() for h in hs[:GEN_SAMPLE]]
                == [h.fingerprint() for h in cpu],
                f"{fam}: histories differ from the device='cpu' call's")
        ops = sum(len(h) for h in hs)
        print(f"{tag} generate_batch {fam} {GEN_LANES} x ({GEN_PIDS} pids x "
              f"{GEN_OPS} ops, {draws} draws a lane): draw "
              f"{st.draw_s * 1e3:.3f} ms, copy to the host "
              f"{st.copy_s * 1e3:.3f} ms, assembly "
              f"{total - st.draw_s - st.copy_s:.3f} s ({ops} ops); table "
              f"bit-identical to plain, {GEN_SAMPLE} histories equal to "
              f"device='cpu'", flush=True)
    time_copies(dev, tag)


def time_copies(dev, tag, reps=20):
    """The table's trip to the host in turns (pageable, pinned, pinned,
    pageable; ms a call over ``reps`` calls, host clock, each call
    synchronised): a pageable copy (``.cpu()``, as the first version of
    ``gen/core.py`` copied) and
    ``table_to_host``'s through pinned memory, at the steering loop's
    1024 x 816 and ``generate_batch``'s 4096 x 816; first the time of
    the first pinned call of each size (the allocator pins a new block
    then; 4096 x 816 was pinned already in phase 15 (b))."""
    for shape in ((GEN_BATCH, gen_core._n_draws(GEN_OPS)),
                  (GEN_LANES, gen_core._n_draws(GEN_OPS))):
        tab = raw_draws(GEN_SEED, *shape, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = table_to_host(tab)
        first_ms = (time.perf_counter() - t0) * 1e3
        require(np.array_equal(first, tab.cpu().numpy().view(np.uint32)),
                f"table_to_host at {shape} differs from the table")
        del first
        calls = {"pageable": lambda: tab.cpu().numpy(),
                 "pinned": lambda: table_to_host(tab)}
        turns = {"pageable": [], "pinned": []}
        for who in ("pageable", "pinned", "pinned", "pageable"):
            t0 = time.perf_counter()
            for _ in range(reps):
                calls[who]()
            turns[who].append((time.perf_counter() - t0) / reps * 1e3)
        print(f"{tag} copy to the host in turns at {shape[0]} x {shape[1]} "
              f"({tab.numel() * 4} bytes): pageable .cpu() "
              f"{turns['pageable'][0]:.3f} / {turns['pageable'][1]:.3f} "
              f"ms, pinned table_to_host {turns['pinned'][0]:.3f} / "
              f"{turns['pinned'][1]:.3f} ms "
              f"({sum(turns['pageable']) / sum(turns['pinned']):.2f}x); "
              f"its first pinned call {first_ms:.3f} ms", flush=True)


def host_allocs():
    """Blocks the caching host allocator has pinned so far, or None where
    this torch does not count them."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return None if stats is None else stats().get("num_host_alloc")


def _audit_flip(item):
    """A flip re-checked by a fresh memo oracle (in a worker process)."""
    fam, h = item
    spec = MODELS[fam].make_spec()
    return int(WingGongCPU(memo=True).check_histories(spec, [h])[0])


def steer_family(fam, tag, profile_round):
    """``GEN_ROUNDS`` rounds of ``SteeringLoop(spec, HybridDevice(spec),
    path="auto")``, each round's stages timed: the draw and the copy
    (``GenStages``), the assembly, the check, ``profile_corpus``.  With
    ``profile_round`` the last round runs under ``torch.profiler``."""
    spec = MODELS[fam].make_spec()
    hb = HybridDevice(spec)
    rounds, flips = [], []
    check = hb.check_histories

    def timed_check(spec_, hs):
        lanes, tail = hb.device.device_histories, hb.tail_histories
        t0 = time.perf_counter()
        v = check(spec_, hs)
        rounds[-1].update(hists=hs, v=np.asarray(v),
                          check_s=time.perf_counter() - t0,
                          lanes=hb.device.device_histories - lanes,
                          tail=hb.tail_histories - tail)
        return v

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            rounds[-1][name] = time.perf_counter() - t0
            return out
        return run

    def timed_reserve(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reserve_host_table(*a)
        reserve.append(time.perf_counter() - t0)

    hb.check_histories = timed_check
    reserve = []
    gen_steer.reserve_host_table = timed_reserve
    try:
        loop = SteeringLoop(spec, hb, profile=GenProfile(n_pids=GEN_PIDS,
                                                         n_ops=GEN_OPS),
                            batch=GEN_BATCH, seed=GEN_SEED, path="auto",
                            on_flip=lambda s, p, h: flips.append((fam, h)))
    finally:
        gen_steer.reserve_host_table = reserve_host_table
    require(len(reserve) == 1, f"{fam}: SteeringLoop on the card did not "
            f"pin its copy's host block once ({len(reserve)})")
    gen_steer.generate_batch = timed("gen_s", generate_batch)
    gen_steer.profile_corpus = timed("profile_s", profile_corpus)
    prof = None
    allocs = host_allocs()
    try:
        with GenStages() as st:
            for r in range(GEN_ROUNDS):
                rounds.append({})
                d0, c0 = st.draw_s, st.copy_s
                t0 = time.perf_counter()
                if profile_round and r == GEN_ROUNDS - 1:
                    box = []
                    prof = profile_device(lambda: box.append(loop.round()))
                    report = box[0]
                else:
                    report = loop.round()
                rounds[-1].update(report=report,
                                  round_s=time.perf_counter() - t0,
                                  draw_s=st.draw_s - d0,
                                  copy_s=st.copy_s - c0)
    finally:
        gen_steer.generate_batch = generate_batch
        gen_steer.profile_corpus = profile_corpus
    pinned = None if allocs is None else host_allocs() - allocs
    return spec, hb, loop, rounds, flips, prof, st.calls, (reserve[0],
                                                           pinned)


def phase_steer(dev, tag):
    """Phase 15 (c), the main path of the generation plane: the steering
    loop over the hybrid plan on the card for each family.  Its launches
    are read just after the loops; then each round's verdicts are held
    against ``CppOracle``'s (nothing undecided), every flip is re-checked
    by a fresh memo oracle (0 missed), 64 LINEARIZABLE witnesses of the
    best profile's batch are replayed, ``save``/``load`` gives an equal
    pool, and the path's kernels are held against their plain versions
    on its own inputs.  Returns (launches, largest error)."""
    # the pinned blocks of phases (a)-(b) given back, so that the first
    # loop's construction pins its block as in a fresh process
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()
    allocs = host_allocs()
    threefry_draws.launches = 0
    stepper_chunk.launches = compact_carry.launches = 0
    runs = []
    with FirstInputs() as first:
        for i, fam in enumerate(GEN_FAMILIES):
            runs.append((fam, *steer_family(fam, tag, profile_round=i == 0)))
    launches = path_launches("the generation plane", tag,
                             (threefry_draws, stepper_chunk, compact_carry))
    print(f"{tag} steer: host cache emptied before the loops: "
          f"{empty is not None}; blocks pinned over the {len(GEN_FAMILIES)} loops (their "
          f"constructions and rounds): "
          f"{'not counted' if allocs is None else host_allocs() - allocs}",
          flush=True)
    want = len(GEN_FAMILIES) * GEN_ROUNDS
    require(launches["threefry_draws"] == want, f"the generation plane "
            f"launched threefry_draws {launches['threefry_draws']} times, "
            f"not once a round ({want})")
    require(launches["stepper_chunk"] > 0, "the generation plane launched "
            "no stepper_chunk")
    all_flips, tables = [], []
    for fam, spec, hb, loop, rounds, flips, prof, calls, pins in runs:
        tables += calls
        print(f"{tag} steer {fam}: the loop's construction reserved the "
              f"copy's host block ({GEN_BATCH} x "
              f"{gen_core._n_draws(GEN_OPS)}) in {pins[0] * 1e3:.3f} ms; "
              f"over its {len(rounds)} rounds draw "
              f"{sum(r['draw_s'] for r in rounds) * 1e3:.3f} ms + copy "
              f"{sum(r['copy_s'] for r in rounds) * 1e3:.3f} ms, blocks "
              f"pinned {'not counted' if pins[1] is None else pins[1]}",
              flush=True)
        cpp = native.CppOracle(spec)
        for r, rec in enumerate(rounds):
            v = rec["v"]
            require(not (v == Verdict.BUDGET_EXCEEDED).any(),
                    f"{fam} round {r}: lanes undecided")
            require(v.tolist() == cpp.check_histories(
                spec, rec["hists"]).tolist(),
                f"{fam} round {r}: verdicts differ from CppOracle's")
            rep = rec["report"]
            assembly = rec["gen_s"] - rec["draw_s"] - rec["copy_s"]
            print(f"{tag} steer {fam} round {r}: {json.dumps(rep)}; round "
                  f"{rec['round_s']:.3f} s = draw "
                  f"{rec['draw_s'] * 1e3:.3f} ms + copy "
                  f"{rec['copy_s'] * 1e3:.3f} ms + assembly {assembly:.3f} "
                  f"s + check {rec['check_s']:.3f} s + profile_corpus "
                  f"{rec['profile_s'] * 1e3:.1f} ms; the check ran "
                  f"{rec['lanes']} device lanes (pending ops expanded) and "
                  f"sent {rec['tail']} histories to the native tail; "
                  f"verdicts equal to CppOracle's, 0 undecided", flush=True)
        if prof is not None:
            wall, busy, top = prof
            print(f"{tag} steer {fam} profiled round: wall {wall:.3f} s, "
                  f"device busy {busy:.6f} s, idle share "
                  f"{1 - busy / wall:.4f}; top kernels {top}", flush=True)
        best = loop.pool.best()
        batch = next((rec["hists"], rec["v"]) for rec in rounds
                     if rec["report"]["seed"] == best.seed) \
            if any(rec["report"]["seed"] == best.seed for rec in rounds) \
            else None
        if batch is None:  # the starting entry: regenerate its batch
            hs = generate_batch(spec, best.profile, best.seed, GEN_BATCH,
                                path="auto")
            batch = (hs, cpp.check_histories(spec, hs))
        lin = [h for h, x in zip(*batch)
               if x == Verdict.LINEARIZABLE][:GEN_WITNESSES]
        from_tail = 0
        for h in lin:
            wv, wit = hb.check_witness(spec, h)
            if wv == Verdict.LINEARIZABLE and wit is None:
                # a history with pending ops: the device search gives no
                # witness (as JaxTPU's), the host tail does
                wv, wit = hb.tail.check_witness(spec, h)
                from_tail += 1
            require(wv == Verdict.LINEARIZABLE
                    and verify_witness(spec, h, wit),
                    f"{fam}: a LINEARIZABLE witness failed to replay")
        ckpt = kernels.BUILD_DIR / f"steer_{fam}.json"
        loop.save(str(ckpt))
        back = SteeringLoop(spec, native.CppOracle(spec), path="py")
        require(back.load(str(ckpt)) and back.pool.to_dict()
                == loop.pool.to_dict() and back.stats.to_compact()
                == loop.stats.to_compact(),
                f"{fam}: save/load did not give an equal pool")
        ckpt.unlink()
        st = loop.search_stats()
        print(f"{tag} steer {fam}: best {json.dumps(best.to_dict())}; "
              f"{len(lin)} witnesses of its batch replayed ({from_tail} "
              f"from the host tail: pending ops); save/load "
              f"equal; search stats {json.dumps(st.to_compact())}; over "
              f"its rounds the device decided {hb.device_decided}, the "
              f"native tail {hb.tail_histories}", flush=True)
        all_flips += flips
    t0 = time.perf_counter()
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            max_workers=min(8, multiprocessing.cpu_count()),
            mp_context=multiprocessing.get_context("fork")) as pool:
        audit = list(pool.map(_audit_flip, all_flips, chunksize=16))
    missed = sum(v != int(Verdict.VIOLATION) for v in audit)
    require(missed == 0, f"{missed} flips a fresh memo oracle does not "
            f"call VIOLATION")
    print(f"{tag} flip audit: {len(all_flips)} flips re-checked by a fresh "
          f"memo oracle each, 0 missed ({time.perf_counter() - t0:.2f} s, "
          f"worker processes)", flush=True)
    # the path's own tables, each against the plain version on the card
    for seed, lanes, draws, tab in tables:
        require(torch.equal(tab, raw_draws_plain(seed, lanes, draws,
                                                 device=dev)),
                f"threefry_draws on the path (seed {seed}, {lanes} x "
                f"{draws}) differs from plain")
    print(f"{tag} threefry_draws == plain on the path of the generation "
          f"plane: its {len(tables)} tables "
          f"({sorted({(l, d) for _, l, d, _ in tables})}), every word "
          f"bit-identical", flush=True)
    err = hold_path_kernels("the generation plane", first, tag)
    return launches, err


# ---------------------------------------------------------------------------
# Phase 16: the search plane
# ---------------------------------------------------------------------------

LONG_PIDS = 8                  # tests/test_longcontext.py's generators
CAS_LONG_OPS, QUEUE_LONG_OPS = 128, 96
SEARCH_WITNESSES = 8
PLAIN_CAP_S = 60.0             # (b): the plain 128-op batch's time cap
SWEEP_SEGDC = (("queue8", QueueSpec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT)),
               ("stack8", StackSpec, (AtomicStackSUT, RacyTwoPhaseStackSUT)))


def long_corpora():
    """(b)'s long corpora, as ``tests/test_longcontext.py`` generates
    them: CAS at 8 pids x 128 ops (``seed_base=2000``, ``"long128"``),
    the queue at 8 x 96 (``seed_base=1000``, ``"long"``), 512 unique
    each."""
    cas = CasSpec()
    q = QueueSpec()
    return (("CAS 8x128", cas, build_corpus(
                cas, (AtomicCasSUT, RacyCasSUT), n=N_UNIQUE,
                n_pids=LONG_PIDS, max_ops=CAS_LONG_OPS, seed_base=2000,
                seed_prefix="long128")),
            ("queue 8x96", q, build_corpus(
                q, (AtomicQueueSUT, RacyTwoPhaseQueueSUT), n=N_UNIQUE,
                n_pids=LONG_PIDS, max_ops=QUEUE_LONG_OPS, seed_base=1000,
                seed_prefix="long")))


def against_cpp(name, v, ov):
    """Lane ``i`` of ``v`` holds unique history ``i % len(ov)``: 0
    mismatches against ``CppOracle``'s verdicts ``ov`` wherever both
    decided.  Returns (decided by both, undecided lanes)."""
    ref = np.asarray(ov)[np.arange(len(v)) % len(ov)]
    both = (v != Verdict.BUDGET_EXCEEDED) & (ref != Verdict.BUDGET_EXCEEDED)
    bad = int(((v != ref) & both).sum())
    require(bad == 0, f"{name}: {bad} verdict mismatches against "
            f"CppOracle")
    return int(both.sum()), int((v == Verdict.BUDGET_EXCEEDED).sum())


def timed_check(backend, spec, lanes):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = np.asarray(backend.check_histories(spec, lanes))
    torch.cuda.synchronize()
    return v, time.perf_counter() - t0


def widest_middle(h) -> int:
    """The widest middle segment of ``h`` (0: no cut)."""
    return max((_width(seg) for seg in split_at_quiescent_cuts(h)[:-1]),
               default=0)


def routes_by_width(name, spec, corpus, cap, tag):
    """Each route's time on ``corpus``'s histories grouped by their
    widest middle segment (0: no cut, plain only): a fresh
    ``TorchStepper`` and ``SegDC`` over it, one group after another.  The
    numbers a retune of ``AutoDevice``'s width caps on the card needs."""
    groups = {}
    for h in corpus:
        groups.setdefault(widest_middle(h), []).append(h)
    n = {"plain": 0, "segdc": 0}
    route_s = {"plain": 0.0, "segdc": 0.0}
    segdc_as_plain_s = 0.0  # the plain stepper on the segdc route's lot
    for w in sorted(groups):
        hs = groups[w]
        t = TorchStepper(spec)
        _, plain_s = timed_check(t, spec, hs)
        seg_s = float("nan")
        if w:
            _, seg_s = timed_check(SegDC(spec, make_inner=lambda q: t),
                                   spec, hs)
        route = "segdc" if 0 < w <= cap else "plain"
        n[route] += len(hs)
        if route == "segdc":
            route_s[route] += seg_s
            segdc_as_plain_s += plain_s
        else:
            route_s[route] += plain_s
        print(f"{tag} {name} widest middle {w}: {len(hs)} histories "
              f"(routed {route}), plain {plain_s:.4f} s, segdc "
              f"{seg_s:.4f} s", flush=True)
    print(f"{tag} {name} by route, the {len(corpus)} unique one group after "
          f"another: plain route {n['plain']} histories "
          f"{route_s['plain']:.4f} s; segdc route {n['segdc']} histories "
          f"{route_s['segdc']:.4f} s (the plain stepper on them "
          f"{segdc_as_plain_s:.4f} s)", flush=True)


def planned_host_stages(spec, lanes, oracle):
    """The host stages of the planned CAS path, timed apart on its lanes
    as ``SegDC`` and the ordered ``TorchStepper`` run them: the cut scan
    of every lane, the native end-state enumeration of every middle
    segment (the frontier threaded as ``SegDC`` threads it), and the
    selectivity permutation of every lane.  Returns seconds each."""
    t0 = time.perf_counter()
    segs = [split_at_quiescent_cuts(h) for h in lanes]
    t1 = time.perf_counter()
    init = {tuple(int(v) for v in spec.initial_state())}
    for ss in segs:
        frontier = init
        for seg in ss[:-1]:
            frontier = oracle.end_states(spec, seg, frontier)
            if not frontier:
                break
    t2 = time.perf_counter()
    table = ordering_table(spec)
    for h in lanes:
        permute_history(h, table.permutation(h))
    return t1 - t0, t2 - t1, time.perf_counter() - t2


def phase_search(spec, corpus, kv_spec, kv_corpus, tag):
    """Phase 16: the search plane on the card.  (a) the CAS headline at
    4096 lanes through ``TorchStepper(spec)`` ("hand") and the planned
    checker ``build_backend(spec, plan_search(spec, profile))``, and
    through ``TorchGPU(spec, ordering=True)``; (b) ``AutoDevice`` on the
    CAS headline, CAS 8 x 128, queue 8 x 96 and kv16 (per key through the
    nested router), each beside a plain ``TorchStepper``; (c)
    ``RootSplit`` escalation over a starved ``TorchStepper``; (d)
    ``SegDC`` over ``TorchStepper`` in the sweep regime (queue and stack
    of capacity 8); each path's kernels then held against their plain
    versions on its own first inputs (e); (f) the ``stats --planned`` and
    ``run --backend auto-stepper`` entry points.  Every verdict equal to
    ``CppOracle``'s wherever both decided.  Returns the launches of each
    path and the largest error."""
    launches, err = {}, 0
    counters = (stepper_chunk, compact_carry, stepper_sweep)

    def reset():
        for c in counters + (dfs_chunk,):
            c.launches = 0

    cpp_v = native.CppOracle(spec).check_histories(spec, corpus)
    lanes = _replicate(corpus, DEVICE_BATCH)

    # (a) hand against planned
    reset()
    hand = TorchStepper(spec)
    with FirstInputs() as first:
        v_hand, cold_s = timed_check(hand, spec, lanes)
        v_hand, hand_s = timed_check(hand, spec, lanes)
        h_wall, h_busy, _ = profile_device(
            lambda: hand.check_histories(spec, lanes))
    both, und = against_cpp("CAS hand", v_hand, cpp_v)
    iph_hand = hand.search_stats().iters_per_history
    launches["CAS hand (16a)"] = path_launches("the CAS headline, hand",
                                               tag, counters)
    err = max(err, hold_path_kernels("the CAS headline, hand", first, tag))
    print(f"{tag} 16a CAS hand: TorchStepper(spec) at its defaults, warm "
          f"{hand_s:.4f} s = {len(lanes) / hand_s:.1f} histories/s (cold "
          f"{cold_s:.4f} s), {iph_hand:.1f} lockstep iterations a history, "
          f"undecided {und}, {both} lanes decided by both against "
          f"CppOracle, 0 mismatches; profiled: wall {h_wall:.4f} s, device "
          f"busy {h_busy:.4f} s, idle share {1 - h_busy / h_wall:.4f}",
          flush=True)

    profile = profile_corpus(corpus, spec)
    plan = plan_search(spec, profile)
    require(plan.name == CUDA_PLAN, f"plan_search chose {plan.name}")
    print(f"{tag} 16a plan: {json.dumps(plan.describe())}", flush=True)
    reset()
    planned = build_backend(spec, plan)
    seg = planned if isinstance(planned, SegDC) else None
    require(seg is not None and isinstance(seg.oracle, native.CppOracle),
            "the planned CAS checker is not SegDC over TorchStepper with "
            "the native middle enumerator")
    with FirstInputs(keep=2) as first:
        v_plan, cold_s = timed_check(planned, spec, lanes)
        v_plan, plan_s = timed_check(planned, spec, lanes)
        p_wall, p_busy, _ = profile_device(
            lambda: planned.check_histories(spec, lanes))
    both, und = against_cpp("CAS planned", v_plan, cpp_v)
    st = collect_search_stats(planned)
    launches["CAS planned (16a)"] = path_launches("the CAS headline, "
                                                  "planned", tag, counters)
    require(seg.segments_native > 0, "no middle segment was enumerated "
            "natively on CAS")
    require(seg.final_states_device > 0, "no final segment reached the "
            "device")
    fin = first.steps[0][1]
    init = int(spec.initial_state()[0])
    outside = int((fin.states[0] != init).sum())
    require(outside > 0, "the first batch of the planned path has no lane "
            "starting outside the initial state")
    err = max(err, hold_path_kernels("the CAS headline, planned", first,
                                     tag))
    runs = 3
    print(f"{tag} 16a CAS planned ({plan.name}): warm {plan_s:.4f} s = "
          f"{len(lanes) / plan_s:.1f} histories/s (cold {cold_s:.4f} s), "
          f"{st.iters_per_history:.1f} lockstep iterations a history "
          f"(hand : planned {iph_hand / st.iters_per_history:.2f}), "
          f"undecided {und}, {both} decided by both against CppOracle, 0 "
          f"mismatches; over its {runs} runs {seg.segments_split} histories "
          f"cut into {seg.segments_total} segments, "
          f"{seg.final_states_device} final-segment lanes on the device "
          f"(its first batch: {outside} of {fin.row.shape[0]} lanes "
          f"starting outside the initial state), {seg.segments_native} "
          f"middle segments enumerated natively, {seg.middle_nodes} middle "
          f"nodes; profiled: wall {p_wall:.4f} s, device busy "
          f"{p_busy:.4f} s, idle share {1 - p_busy / p_wall:.4f}",
          flush=True)
    cut_s, mid_s, perm_s = planned_host_stages(spec, lanes, seg.oracle)
    print(f"{tag} 16a CAS planned, host stages timed apart on its "
          f"{len(lanes)} lanes: cut scan {cut_s:.4f} s, native middles "
          f"{mid_s:.4f} s, selectivity permutation {perm_s:.4f} s",
          flush=True)
    inner = seg.inner
    require(inner.search_stats().ordering, "the planned stepper is not "
            "ordered")
    lin = [h for h, x in zip(corpus, v_plan[:len(corpus)])
           if x == Verdict.LINEARIZABLE][:SEARCH_WITNESSES]
    for h in lin:
        wv, wit = inner.check_witness(spec, h)
        require(wv == Verdict.LINEARIZABLE and verify_witness(spec, h, wit),
                "an ordered witness failed to replay")
    print(f"{tag} 16a {len(lin)} LINEARIZABLE witnesses of the ordered "
          f"TorchStepper replayed through verify_witness", flush=True)

    reset()
    gpu = TorchGPU(spec, ordering=True)
    with FirstInputs() as first:
        v_gpu, gpu_s = timed_check(gpu, spec, lanes)
    both, und = against_cpp("CAS ordered TorchGPU", v_gpu, cpp_v)
    launches["CAS ordered TorchGPU (16a)"] = path_launches(
        "the CAS headline, ordered TorchGPU", tag, (dfs_chunk,))
    for h in lin:
        wv, wit = gpu.check_witness(spec, h)
        require(wv != Verdict.LINEARIZABLE or verify_witness(spec, h, wit),
                "an ordered TorchGPU witness failed to replay")
    err = max(err, hold_path_kernels("the CAS headline, ordered TorchGPU",
                                     first, tag))
    print(f"{tag} 16a CAS through TorchGPU(ordering=True): {gpu_s:.4f} s "
          f"(one run), undecided {und}, {both} decided by both, 0 "
          f"mismatches, witnesses replayed", flush=True)

    # (b) per-history routing
    cases = [("CAS headline", spec, corpus)] + list(long_corpora()) + [
        ("kv16", kv_spec, kv_corpus)]
    for name, sp, cs in cases:
        ov = native.CppOracle(sp).check_histories(sp, cs)
        lanes_b = _replicate(cs, DEVICE_BATCH)
        reset()
        auto = AutoDevice(sp)
        with FirstInputs() as first:
            v, auto_s = timed_check(auto, sp, lanes_b)
        both, und = against_cpp(f"{name} auto", v, ov)
        launches[f"{name} auto (16b)"] = path_launches(
            f"{name}, auto", tag, counters)
        err = max(err, hold_path_kernels(f"{name}, auto", first, tag, sp))
        router = auto.pcomp.inner if auto.pcomp is not None else auto
        pv, plain_s = timed_check(TorchStepper(sp), sp, cs)
        what = f"{len(cs)} unique alone"
        if plain_s * DEVICE_BATCH / len(cs) <= PLAIN_CAP_S:
            pv, plain_s = timed_check(TorchStepper(sp), sp, lanes_b)
            what = f"{len(lanes_b)} lanes"
        _, plain_und = against_cpp(f"{name} plain", pv, ov)
        print(f"{tag} 16b {name} auto ({auto.name}): {len(lanes_b)} lanes "
              f"in {auto_s:.4f} s (one run), routed plain "
              f"{router.routed_plain} / segdc {router.routed_segdc}"
              + (" (sub-histories of the per-key split)"
                 if auto.pcomp is not None else "")
              + f", undecided {und}, {both} decided by both against "
              f"CppOracle, 0 mismatches; plain TorchStepper on {what}: "
              f"{plain_s:.4f} s, undecided {plain_und}, 0 mismatches",
              flush=True)
        if auto.pcomp is None:
            cap = (auto.NATIVE_WIDTH_CAP if auto._native_mid
                   else auto.WIDTH_CAP)
            routes_by_width(name, sp, cs, cap, tag)

    # (c) root splitting, escalation: the inner pass alone first, for its
    # undecided lanes, then the path (its whole pass and the children)
    starve = dict(budget=2000, mid_budget=0, rescue_budget=0)
    inner_v = np.asarray(TorchStepper(spec, **starve).check_histories(
        spec, lanes))
    reset()
    rs = RootSplit(spec, TorchStepper(spec, **starve))
    with FirstInputs(keep=2) as first:
        v_rs, rs_s = timed_check(rs, spec, lanes)
    both, und = against_cpp("CAS rootsplit", v_rs, cpp_v)
    launches["CAS rootsplit (16c)"] = path_launches("the CAS headline, "
                                                    "rootsplit", tag,
                                                    counters)
    err = max(err, hold_path_kernels("the CAS headline, rootsplit", first,
                                     tag))
    print(f"{tag} 16c CAS RootSplit over TorchStepper(budget=2000, no mid "
          f"or rescue budget): the inner pass leaves "
          f"{int((inner_v == Verdict.BUDGET_EXCEEDED).sum())} lanes "
          f"undecided; {rs.split_histories} split into "
          f"{rs.children_checked} children; {und} lanes still undecided "
          f"after ({rs_s:.4f} s, one run); {both} decided by both against "
          f"CppOracle, 0 mismatches", flush=True)

    # (d) SegDC over TorchStepper in the sweep regime
    for name, make_spec, suts in SWEEP_SEGDC:
        sp = make_spec(capacity=8)
        cs = build_corpus(sp, suts, n=256, n_pids=N_PIDS, max_ops=Q_OPS,
                          seed_base=1000, seed_prefix="bench")
        ov = native.CppOracle(sp).check_histories(sp, cs)
        lanes_d = _replicate(cs, 1024)
        reset()
        sd = SegDC(sp, make_inner=lambda q: TorchStepper(q))
        require(sd.inner.regime == "sweep" and sd.device_final,
                f"{name}: SegDC's finals are not on the sweep regime")
        with FirstInputs() as first:
            v, sd_s = timed_check(sd, sp, lanes_d)
        both, und = against_cpp(f"{name} segdc", v, ov)
        launches[f"{name} segdc sweep (16d)"] = path_launches(
            f"{name}, segdc over the sweep", tag,
            (stepper_sweep, compact_carry))
        require(sd.final_states_device > 0, f"{name}: no final-segment "
                f"lane reached the sweep")
        err = max(err, hold_path_kernels(f"{name}, segdc over the sweep",
                                         first, tag, sp))
        print(f"{tag} 16d {name} SegDC over TorchStepper (sweep regime): "
              f"{len(lanes_d)} lanes in {sd_s:.4f} s (one run), "
              f"{sd.segments_split} cut, {sd.final_states_device} "
              f"final-segment lanes sent to stepper_sweep, "
              f"{sd.segments_native} middles native, undecided {und}, "
              f"{both} decided by both against CppOracle, 0 mismatches",
              flush=True)

    # (f) the entry points
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "qsm_tpu_torch", "stats", "--model", "cas",
         "--planned"], capture_output=True, text=True, timeout=600)
    require(out.returncode == 0, f"stats --planned exited "
            f"{out.returncode}: {out.stderr[-400:]}")
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    require(doc["plan_for_corpus"]["name"] == CUDA_PLAN
            and doc["search_stats"]["plan"] == CUDA_PLAN,
            f"stats --planned ran plan {doc['plan_for_corpus']['name']}")
    print(f"{tag} 16f python -m qsm_tpu_torch stats --model cas --planned: "
          f"backend {doc['backend']} on {doc['device']}, "
          f"{doc['histories']} histories in {doc['seconds']} s, undecided "
          f"{doc['undecided']}, iters/history "
          f"{doc['search_stats']['iters_per_history']:.1f} "
          f"({time.perf_counter() - t0:.1f} s with start-up)", flush=True)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "qsm_tpu_torch", "run", "--model", "cas",
         "--backend", "auto-stepper", "--trials", "30"],
        capture_output=True, text=True, timeout=600)
    require(out.returncode == 1 and "FAIL" in out.stdout,
            f"run --backend auto-stepper did not convict racy CAS "
            f"(rc {out.returncode}): {out.stdout[-400:]}{out.stderr[-400:]}")
    print(f"{tag} 16f python -m qsm_tpu_torch run --model cas --backend "
          f"auto-stepper: rc 1, {out.stdout.splitlines()[0]} "
          f"({time.perf_counter() - t0:.1f} s with start-up)", flush=True)
    return launches, err


# ---------------------------------------------------------------------------
# Phase 17: the entry points, systematic exploration and fuzzing
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent
EXPLORE_PIDS, EXPLORE_OPS = 2, 5
EXPLORE_UNION = 4096           # histories a union batch reaches, at least
# (family, impl) -> (programs: seeds 0..n-1, the fewest whose union
# passes EXPLORE_UNION; whether the walk prunes).  The walks are
# deterministic, so the counts are fixed; at 2 x 5 the unpruned walk is
# the cheaper one on the host, except for the racy set, where it passes
# EXPLORE_MAX_SCHEDULES on some trees (the history sets are equal either
# way).
EXPLORE_PLAN = {
    ("register", "atomic"): (577, False), ("register", "racy"): (1153, False),
    ("cas", "atomic"): (537, False), ("cas", "racy"): (511, False),
    ("set", "atomic"): (920, False), ("set", "racy"): (889, True),
    ("queue", "atomic"): (565, False), ("queue", "racy"): (524, False),
}
EXPLORE_MAX_SCHEDULES = 10_000
FUZZ_SCALAR = dict(n_specs=8, hists_per_spec=512, n_pids=4, n_ops=10,
                   p_pending=0.1, seed=17,
                   backends=("memo", "cpp", "device", "pallas", "segdc",
                             "auto", "hybrid"))
FUZZ_VECTOR = dict(n_specs=4, hists_per_spec=256, n_ops=8, p_pending=0.1,
                   seed=17, vector_bounds=(7,) * 7,
                   backends=("memo", "device", "hybrid"))
CLI_TIMEOUT_S = 600
KILL_WAIT_S = 30.0             # bound of the wait on a killed child


def cli_proc(*argv, env=None):
    """``python -m qsm_tpu_torch ARGV`` started from the checkout's root,
    ``env`` added to this process' environment; collected by
    :func:`cli_result`."""
    return subprocess.Popen(
        [sys.executable, "-m", "qsm_tpu_torch", *map(str, argv)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=None if env is None else {**os.environ, **env})


def reap(proc):
    """Kill ``proc`` and wait for it, bounded: a child's own children can
    hold its pipes open past its death."""
    proc.kill()
    try:
        proc.communicate(timeout=KILL_WAIT_S)
    except subprocess.TimeoutExpired:
        pass


def cli_result(proc, what):
    """(rc, stdout lines) of a :func:`cli_proc`; killed past its time."""
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        reap(proc)
        raise RuntimeError(f"chip_smoke: {what} ran past "
                           f"{CLI_TIMEOUT_S} s")
    if proc.returncode not in (0, 1, 2):
        raise RuntimeError(f"chip_smoke: {what} exited {proc.returncode}: "
                           f"{err[-600:]}")
    return proc.returncode, out.strip().splitlines()


def cli_inproc(*argv):
    """(rc, stdout lines) of the CLI's ``main`` run in this process, so
    that its kernel launches count here (stderr discarded)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main([str(a) for a in argv])
    return rc, out.getvalue().strip().splitlines()


def drop_seconds(lines):
    docs = [json.loads(x) for x in lines]
    for d in docs:
        d.pop("seconds", None)
    return docs


class UnionRecorder:
    """The backend handed to ``explore_many``: keeps the union of the
    trees it is asked to decide and decides it with ``inner`` in one
    call, timed to the card's completion."""

    def __init__(self, inner):
        self.inner = inner
        self.union, self.verdicts, self.check_s = [], None, 0.0

    def check_histories(self, spec, histories):
        self.union = list(histories)
        self.verdicts, self.check_s = timed_check(self.inner, spec,
                                                  self.union)
        return self.verdicts


def explore_family(fam, pool, tag):
    """(b) for one family: ``explore_many`` over the family's atomic and
    racy programs (2 pids x 5 ops), each union decided in one
    ``TorchStepper`` call (and ``TorchGPU``'s, for a scalar-table spec),
    every decided verdict equal to ``CppOracle``'s on the same union,
    every atomic tree verified, racy convicted wherever the host oracle
    convicts.  Returns (unions, {impl: (host s, device s, histories)})."""
    spec, _ = make_model(fam, "atomic")
    gpu_ok = (spec.STATE_DIM == 1
              and spec.scalar_state_bound(EXPLORE_OPS) is not None)
    unions, times = {}, {}
    for impl in ("atomic", "racy"):
        n, prune = EXPLORE_PLAN[(fam, impl)]
        progs = [gen_program(spec, seed=s, n_pids=EXPLORE_PIDS,
                             max_ops=EXPLORE_OPS) for s in range(n)]
        rec = UnionRecorder(TorchStepper(spec))
        t0 = time.perf_counter()
        res = explore_many(SutFactory(fam, impl), progs, spec, backend=rec,
                           max_schedules=EXPLORE_MAX_SCHEDULES, prune=prune,
                           pool=pool)
        wall = time.perf_counter() - t0
        union = rec.union
        require(len(union) >= EXPLORE_UNION, f"{fam}/{impl}: a union of "
                f"{len(union)} histories, under {EXPLORE_UNION}")
        v = rec.verdicts
        ov = native.CppOracle(spec).check_histories(spec, union)
        both, und = against_cpp(f"{fam}/{impl} union (TorchStepper)", v, ov)
        gpu_text = ""
        if gpu_ok:
            gv, gpu_s = timed_check(TorchGPU(spec), spec, union)
            gboth, gund = against_cpp(f"{fam}/{impl} union (TorchGPU)", gv,
                                      ov)
            gpu_text = (f"; TorchGPU {gpu_s:.4f} s, {gboth} decided by both, "
                        f"{gund} undecided")
        # per program: the host oracle's conviction against the card's
        at = 0
        convicted = agree = 0
        for r in res:
            cpu_vio = bool((ov[at:at + r.distinct_histories]
                            == Verdict.VIOLATION).any())
            at += r.distinct_histories
            require(r.exhausted, f"{fam}/{impl}: a tree past "
                    f"{EXPLORE_MAX_SCHEDULES} schedules")
            if impl == "atomic":
                require(r.verified, f"{fam}/atomic: a tree not verified "
                        f"({r.violations} violations, {r.undecided} "
                        f"undecided)")
            else:
                convicted += cpu_vio
                if r.undecided == 0 or r.violations:
                    require((r.violations > 0) == cpu_vio,
                            f"{fam}/racy: the card and the host oracle "
                            f"disagree on a program's conviction")
                    agree += 1
        times[impl] = (wall - rec.check_s, rec.check_s, len(union))
        unions[impl] = union
        print(f"{tag} 17b explore_many {fam}/{impl}: {n} programs "
              f"({'pruned' if prune else 'unpruned'} walks), union of "
              f"{len(union)} histories from "
              f"{sum(r.schedules_run for r in res)} schedules; host "
              f"enumeration {wall - rec.check_s:.3f} s, one TorchStepper "
              f"call {rec.check_s:.4f} s = "
              f"{len(union) / rec.check_s:,.1f} histories/s, undecided "
              f"{und}, {both} decided by both against CppOracle"
              f"{gpu_text}; "
              + (f"{len(res)} trees verified" if impl == "atomic" else
                 f"{sum(r.violations > 0 for r in res)} programs convicted "
                 f"({convicted} by the host oracle, {agree} compared)"),
              flush=True)
    return unions, times


def phase_entry(spec, corpus, tag):
    """Phase 17: the entry points, exploration and fuzzing on the card;
    see the module docstring.  Returns (launches of each path, largest
    error of the kernels held on the paths)."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p17_"))
    lanes = _replicate(corpus, DEVICE_BATCH)
    trace = tmp / "headline.json"
    trace.write_text(json.dumps({"model": "cas", "histories": [
        history_to_rows(h) for h in lanes]}))
    reg = tmp / "regression.json"
    # the subprocesses run beside the in-process paths: the longest (the
    # crash sweep, one core for 15 trees) and the checks now, the rest
    # once the exploration pool is done with the host's cores
    procs = {
        "crash sweep atomic": cli_proc(
            "explore", "--model", "failover", "--impl", "atomic", "--pids",
            2, "--ops", 4, "--seed", 9, "--crash-sweep", "primary:1-15",
            "--backend", "stepper"),
        "crash sweep racy": cli_proc(
            "explore", "--model", "failover", "--impl", "racy", "--pids",
            2, "--ops", 4, "--seed", 9, "--crash-sweep", "primary:2-2",
            "--backend", "stepper"),
        "check stepper": cli_proc("check", "--trace", trace, "--backend",
                                  "stepper"),
        "check gpu": cli_proc("check", "--trace", trace, "--backend",
                              "gpu"),
    }
    later = {
        "explore workers": lambda: cli_proc(
            "explore", "--model", "set", "--impl", "racy", "--pids", 2,
            "--ops", 5, "--programs", 64, "--workers", 4, "--backend",
            "stepper"),
        "explore serial": lambda: cli_proc(
            "explore", "--model", "set", "--impl", "racy", "--pids", 2,
            "--ops", 5, "--programs", 64, "--backend", "stepper"),
        "run faults": lambda: cli_proc(
            "run", "--model", "cas", "--impl", "racy", "--backend",
            "stepper", "--trials", 30, "--p-drop", 0.05,
            "--save-regression", reg),
        "run tcp": lambda: cli_proc(
            "run", "--model", "cas", "--impl", "racy", "--backend",
            "stepper", "--trials", 30, "--transport", "tcp", "--workers",
            2),
        "run memory": lambda: cli_proc(
            "run", "--model", "cas", "--impl", "racy", "--backend",
            "stepper", "--trials", 30),
    }
    from qsm_tpu_torch.sched.pool import ExplorePool

    # the host's cores but two: the crash sweep's and this process's
    pool = ExplorePool(n_workers=max(2, min(6, (os.cpu_count() or 4) - 2)))
    launches, err = {}, 0
    counters = (stepper_chunk, compact_carry, stepper_sweep, dfs_chunk)

    def reset():
        for c in counters:
            c.launches = 0

    total = dict.fromkeys((c.__name__ for c in counters), 0)

    def read(name, first, path_spec=None):
        nonlocal err
        got = {c.__name__: c.launches for c in counters}
        print(f"{tag} path of {name}: " + ", ".join(
            f"{n} {k}" for k, n in got.items()) + " launches", flush=True)
        for k, n in got.items():
            total[k] += n
        launches[name] = got
        err = max(err, hold_path_kernels(name, first, tag, path_spec))

    try:
        # (a) check in this process too: the same command, its launches
        # counted and held here
        cpp_v = native.CppOracle(spec).check_histories(spec, corpus)
        names = ("VIOLATION", "LINEARIZABLE", "BUDGET_EXCEEDED")
        want = [names[int(x)] for x in cpp_v[np.arange(len(lanes))
                                             % len(corpus)]]
        for backend in ("stepper", "gpu"):
            reset()
            with FirstInputs() as first:
                t0 = time.perf_counter()
                rc, out = cli_inproc("check", "--trace", trace,
                                     "--backend", backend)
                dt = time.perf_counter() - t0
            doc = json.loads(out[-1])
            require(doc["verdicts"] == want, f"check --backend {backend}: "
                    f"verdicts differ from CppOracle's")
            require(rc == (1 if doc["violations"] else
                           2 if doc["undecided"] else 0),
                    f"check --backend {backend}: exit {rc}")
            read(f"check --backend {backend} (17a)", first)
            print(f"{tag} 17a check --trace (4096 headline lanes) "
                  f"--backend {backend} in this process: rc {rc}, "
                  f"{doc['violations']} violations, {doc['undecided']} "
                  f"undecided after the host resolution, verdicts equal to "
                  f"CppOracle's ({dt:.3f} s with the trace's decoding)",
                  flush=True)
        lin = next(h for h, x in zip(corpus, cpp_v)
                   if x == Verdict.LINEARIZABLE)
        single = tmp / "single.json"
        single.write_text(json.dumps({"model": "cas",
                                      "history": history_to_rows(lin)}))
        rc, out = cli_inproc("check", "--trace", single, "--witness")
        doc = json.loads(out[-1])
        require(rc == 0 and doc["witness_verifies"] is True,
                f"check --witness: rc {rc}, {doc}")
        print(f"{tag} 17a check --witness on one {doc['ops']}-op headline "
              f"history: {doc['verdict']}, witness_verifies "
              f"{doc['witness_verifies']}", flush=True)

        # (b) exploration unions, through the card
        reset()
        union_times = {}
        profiled = None
        with FirstInputs(keep=len(EXPLORE_PLAN)) as first:
            for fam in ("register", "cas", "set", "queue"):
                unions, union_times[fam] = explore_family(fam, pool, tag)
                if fam == "cas":
                    profiled = unions["racy"]
        read("exploration unions (17b)", first)
        fam_spec = make_model("cas", "racy")[0]
        warm = TorchStepper(fam_spec)
        _, warm_s = timed_check(warm, fam_spec, profiled)
        p_wall, p_busy, top = profile_device(
            lambda: warm.check_histories(fam_spec, profiled))
        host_s = sum(t[0] for ts in union_times.values()
                     for t in ts.values())
        dev_s = sum(t[1] for ts in union_times.values()
                    for t in ts.values())
        n_hist = sum(t[2] for ts in union_times.values()
                     for t in ts.values())
        pool.close()
        procs.update((k, start()) for k, start in later.items())
        print(f"{tag} 17b the eight unions: {n_hist} histories, host "
              f"enumeration {host_s:.3f} s (over the pool's "
              f"{pool.n_workers} workers) against {dev_s:.4f} s of device "
              f"check; the cas/racy union warm {warm_s:.4f} s = "
              f"{len(profiled) / warm_s:,.1f} histories/s, profiled "
              f"{p_wall:.4f} s, device busy {p_busy:.6f} s, idle share "
              f"{1 - p_busy / p_wall:.4f}; top {top}", flush=True)

        # (c) fuzz_parity on the card
        fuzz_launches = {}
        for name, kw in (("scalar", FUZZ_SCALAR), ("vector", FUZZ_VECTOR)):
            reset()
            arm_s = {}
            with FirstInputs() as first:
                t0 = time.perf_counter()
                rep = fuzz_parity(timings=arm_s, **kw)
                dt = time.perf_counter() - t0
            require(rep.ok, f"fuzz {name}: mismatches {rep.mismatches[:8]}")
            require(rep.hybrid_tail_histories > 0, f"fuzz {name}: the "
                    f"hybrid arm's host tail decided nothing")
            if "cpp" in kw["backends"]:
                require(rep.cpp_native_histories > 0, f"fuzz {name}: the "
                        f"cpp arm decided nothing natively")
            vspec = (RandomVectorSpec(kw["seed"] * 1_000_003,
                                      bounds=kw["vector_bounds"])
                     if name == "vector" else None)
            read(f"fuzz_parity {name} (17c)", first, vspec)
            fuzz_launches[name] = launches[f"fuzz_parity {name} (17c)"]
            print(f"{tag} 17c fuzz_parity {name}: {rep.specs} specs x "
                  f"{kw['hists_per_spec']} histories, arms "
                  f"{','.join(kw['backends'])}: 0 mismatches, "
                  f"{rep.linearizable} linearizable, {rep.violations} "
                  f"violations, {rep.budget_exceeded} undecided by the "
                  f"oracle, cpp native {rep.cpp_native_histories}, hybrid "
                  f"tail {rep.hybrid_tail_histories}; {dt:.3f} s, by arm "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in arm_s.items()),
                  flush=True)
        for k in ("stepper_chunk", "compact_carry", "dfs_chunk",
                  "stepper_sweep"):
            require(total[k] > 0, f"phase 17 launched no {k}")

        # (a), (b), (e) in subprocesses, collected now
        for backend in ("stepper", "gpu"):
            rc, out = cli_result(procs[f"check {backend}"],
                                 f"check --backend {backend}")
            doc = json.loads(out[-1])
            require(doc["verdicts"] == want and rc == (
                1 if doc["violations"] else 2 if doc["undecided"] else 0),
                f"python -m qsm_tpu_torch check --backend {backend}: rc "
                f"{rc}, verdicts equal: {doc['verdicts'] == want}")
            print(f"{tag} 17a python -m qsm_tpu_torch check --trace "
                  f"(4096 lanes) --backend {backend}: rc {rc}, verdicts "
                  f"equal to CppOracle's", flush=True)
        rc, out = cli_result(procs["crash sweep atomic"], "crash sweep")
        docs = [json.loads(x) for x in out]
        require(rc == 0 and docs[-1]["all_verified"] is True
                and len(docs) == 16, f"explore --crash-sweep primary:1-15 "
                f"(atomic failover): rc {rc}, {docs[-1]}")
        print(f"{tag} 17b python -m qsm_tpu_torch explore --model failover "
              f"--impl atomic --crash-sweep primary:1-15 --backend stepper: "
              f"rc 0, all_verified true over "
              f"{sum(d['schedules_run'] for d in docs[:-1])} schedules, "
              f"{sum(d['distinct_histories'] for d in docs[:-1])} histories "
              f"({docs[-1]['seconds']} s)", flush=True)
        rc, out = cli_result(procs["crash sweep racy"], "racy crash sweep")
        doc = json.loads(out[0])
        require(rc == 1 and doc["violations"] > 0,
                f"explore (racy failover, primary:2): rc {rc}, {doc}")
        print(f"{tag} 17b ... --impl racy (AsyncReplFailoverSUT) "
              f"--crash-sweep primary:2-2: rc 1, {doc['violations']} "
              f"violating histories, e.g. {doc['violating_schedule']}",
              flush=True)
        rc_w, out_w = cli_result(procs["explore workers"], "explore workers")
        rc_s, out_s = cli_result(procs["explore serial"], "explore serial")
        require(rc_w == rc_s and drop_seconds(out_w) == drop_seconds(out_s),
                "explore --programs 64 --workers 4 differs from the serial "
                "run")
        summary = json.loads(out_w[-1])
        print(f"{tag} 17b explore --model set --impl racy --programs 64 "
              f"--workers 4 --backend stepper: {len(out_w)} lines equal to "
              f"the serial run's apart from seconds (rc {rc_w}, "
              f"{summary['total_violations']} violations; "
              f"{summary['seconds']} s against "
              f"{json.loads(out_s[-1])['seconds']} s serial)", flush=True)
        rc, out = cli_result(procs["run faults"], "run --p-drop")
        hint = next((x for x in out if x.startswith("replay:")), "")
        require(rc == 1 and "FAIL" in out[0] and all(
            f in hint for f in ("--p-drop 0.05", "--p-duplicate 0.0",
                                "--p-delay 0.0", "--delay-steps 3")),
            f"run --p-drop 0.05: rc {rc}, hint {hint!r}")
        print(f"{tag} 17e run --model cas --impl racy --backend stepper "
              f"--p-drop 0.05: rc 1, {out[0]}; {hint}", flush=True)
        rc, out = cli_result(cli_proc("replay", "--regression", reg),
                             "replay --regression")
        require(rc == 1 and "history reproduced bit-identically: True"
                in out, f"replay --regression: rc {rc}, {out[:3]}")
        print(f"{tag} 17e replay --regression: rc 1, history reproduced "
              f"bit-identically", flush=True)
        rc_t, out_t = cli_result(procs["run tcp"], "run --transport tcp")
        rc_m, out_m = cli_result(procs["run memory"], "run (memory)")
        require(rc_t == rc_m == 1 and out_t[1:] == out_m[1:],
                "run --transport tcp --workers 2 differs from the memory "
                "transport's")
        print(f"{tag} 17e run --transport tcp --workers 2 --backend "
              f"stepper: rc 1, the memory transport's counterexample and "
              f"replay key: {out_t[1]}", flush=True)
    finally:
        pool.close()
        for p in procs.values():
            if p.poll() is None:
                reap(p)
    dt = time.perf_counter() - t_phase
    print(f"{tag} phase 17 launches: " + ", ".join(
        f"{n} {k}" for k, n in total.items()) + f"; {dt:.1f} s", flush=True)
    return total, err


# ---------------------------------------------------------------------------
# Phase 18: resilience and the history shrinker on the card
# ---------------------------------------------------------------------------

SHRINK_HISTORIES = 8           # (a): violating headline histories shrunk
HANG_S = 3.0                   # (c) 2: the injected hang ...
HANG_TIMEOUT_S = 1.0           # ... and the watchdog's shorter bound
CHECK_ONE_BUDGET = 500_000     # (d): tests/test_cache.py's budget and memo
CHECK_ONE_SLOTS = 4096
CHECK_ONE_PLAIN = 5_000        # (d): iterations the memo-less plain version
# runs against the kernel (its loop takes a trip of small launches an
# iteration: the whole budget would take minutes)


class CountedBackend:
    """A backend's ``check_histories`` with its calls and its BUDGET
    verdicts counted (``inner`` keeps its search record reachable)."""

    def __init__(self, inner):
        self.inner = inner
        self.name = getattr(inner, "name", type(inner).__name__)
        self.calls = self.budget_lanes = 0

    def check_histories(self, spec, histories):
        v = np.asarray(self.inner.check_histories(spec, histories))
        self.calls += 1
        self.budget_lanes += int((v == Verdict.BUDGET_EXCEEDED).sum())
        return v


class FaultEnv:
    """Inside ``with``: ``QSM_TPU_FAULTS`` (and the hang's length) set and
    the port's fault plane parsed afresh; restored after."""

    def __init__(self, rules, hang_s=None):
        self.set = {faults_mod.ENV_VAR: rules}
        if hang_s is not None:
            self.set[faults_mod.HANG_VAR] = str(hang_s)

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.set}
        os.environ.update(self.set)
        faults_mod._plane = None
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults_mod._plane = None


class LaunchOrigin:
    """Inside ``with``: the thread and the CUDA stream of the first
    ``stepper_chunk`` launch a ``TorchStepper`` makes."""

    def __init__(self, dev):
        self.dev, self.thread, self.stream = dev, None, None

    def _step(self, *a, **kw):
        if self.thread is None:
            self.thread = threading.get_ident()
            self.stream = torch.cuda.current_stream(self.dev).cuda_stream
        return self.inner(*a, **kw)

    def __enter__(self):
        self.inner = stepper_module.stepper_chunk
        stepper_module.stepper_chunk = self._step
        return self

    def __exit__(self, *exc):
        stepper_module.stepper_chunk = self.inner


WRAP_LANES = 4                 # (c): a property batch (4 schedules a trial)
WRAP_REPS = 50


def wrap_cost(spec, lanes) -> dict:
    """ms a dispatch of ``lanes`` through ``TorchStepper``: bare, bare on
    a new thread a call (``watchdog``) and on one reused worker
    (``Watchdog``), and inside ``FailoverBackend`` with no watchdog
    (``timeout_s=None``), with a new watchdog thread a dispatch (as the
    wrapper's first build ran) and as it ships (the process' one worker
    for every wrapper); in
    turns, forward then backward, each the mean of both; with them what a
    property run pays once (a fresh engine and its first dispatch, bare
    and wrapped); beside ``kernels.build_all()`` once built and empty
    calls on a new thread, on one that sets the caller's stream, and on
    the reused worker."""
    timeout = preset("dispatch").timeout_s
    bare = TorchStepper(spec)
    worker = Watchdog("wrap_cost")
    inline = FailoverBackend(spec, TorchStepper(spec),
                             policy=preset("dispatch").with_(timeout_s=None))
    per_call = FailoverBackend(spec, TorchStepper(spec))
    per_call.watchdog = functools.partial(watchdog, label="wrap_cost")
    shipped = FailoverBackend(spec, TorchStepper(spec))
    stream = torch.cuda.current_stream()

    def on_stream():
        with torch.cuda.stream(stream):
            return None

    def ms_a_call(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WRAP_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / WRAP_REPS

    def dispatch(eng):
        return lambda: eng.check_histories(spec, lanes)

    variants = {
        "bare": dispatch(bare),
        "bare on a new thread a call": lambda: watchdog(
            dispatch(bare), timeout),
        "bare on one reused thread": lambda: worker(dispatch(bare),
                                                    timeout),
        "wrapped, no watchdog": dispatch(inline),
        "wrapped, a new watchdog thread a dispatch": dispatch(per_call),
        "wrapped as shipped (the process' one watchdog worker)":
            dispatch(shipped),
    }
    # what a property run pays once: its engine, built fresh, and the
    # engine's first dispatch (the wrapper's worker thread starts there)
    variants["a fresh TorchStepper and its first dispatch"] = \
        lambda: TorchStepper(spec).check_histories(spec, lanes)
    variants["a fresh FailoverBackend(TorchStepper) and its first "
             "dispatch"] = lambda: FailoverBackend(
                 spec, TorchStepper(spec)).check_histories(spec, lanes)
    for fn in variants.values():
        fn()  # warm: the tables' bucket, the worker threads
    out = {k: [] for k in variants}
    for name in [*variants, *reversed(variants)]:
        out[name].append(ms_a_call(variants[name]))
    return {**{k: sum(v) / len(v) for k, v in out.items()},
            "kernels.build_all() with every kernel built": ms_a_call(
                kernels.build_all),
            "watchdog of an empty call": ms_a_call(
                lambda: watchdog(lambda: None, timeout)),
            "... that sets the caller's stream": ms_a_call(
                lambda: watchdog(on_stream, timeout)),
            "the reused worker's empty call": ms_a_call(
                lambda: worker(lambda: None, timeout))}


def shrink_on_card(name, spec, h, backend, cpp, tag):
    """``shrink_history`` of ``h`` through ``backend`` (None: the host
    default), timed to the card's completion; the minimised history a
    VIOLATION by ``cpp`` and its certificate verified.  Returns (result,
    seconds, the counted backend or None)."""
    rec = CountedBackend(backend) if backend is not None else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = shrink_history(spec, h, backend=rec, certificate=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(res.ok and res.complete, f"{name}: shrink not complete: "
            f"{res.why}")
    require(int(cpp.check_histories(spec, [res.history])[0])
            == Verdict.VIOLATION, f"{name}: the minimised history is not "
            f"a VIOLATION by CppOracle")
    cert = minimality_certificate(spec, res.history)
    audit = verify_certificate(spec, res.history, cert)
    require(audit["one_minimal_proved"] and audit["violation_reconfirmed"],
            f"{name}: the certificate does not verify: {audit}")
    if rec is not None:
        require(rec.calls == res.engine_calls, f"{name}: {rec.calls} "
                f"backend calls for {res.engine_calls} frontier batches")
    return res, dt, rec


def same_shrink(name, res, host, rec):
    """Where the device left no lane undecided, the result equals the
    host shrink's; returns whether it was compared."""
    if rec.budget_lanes or res.undecided_neighbors:
        return False
    got = (history_to_rows(res.history), res.rounds, res.lanes_checked,
           res.one_minimal)
    want = (history_to_rows(host.history), host.rounds, host.lanes_checked,
            host.one_minimal)
    require(got == want, f"{name}: the shrink differs from the host's: "
            f"{got[1:]} against {want[1:]}")
    return True


def phase_resilience(spec, corpus, kv_spec, kv_corpus, dev, tag):
    """Phase 18: resilience and the history shrinker on the card; see the
    module docstring.  Returns (launches of each path, largest error of
    the kernels held on the paths, the check_one record)."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p18_"))
    log = tmp / "failover.jsonl"
    # (c) 4 in a subprocess, beside the in-process paths
    proc = cli_proc("run", "--model", "cas", "--impl", "racy", "--backend",
                    "stepper", "--failover", "--trials", 100, "--pids",
                    N_PIDS, "--ops", N_OPS, "--log", log,
                    env={faults_mod.ENV_VAR: "raise:dispatch@3"})
    counters = (stepper_chunk, compact_carry, stepper_sweep)
    launches, err = {}, 0

    def reset():
        for c in counters:
            c.launches = 0

    def read(name, first, path_spec=None):
        nonlocal err
        got = {c.__name__: c.launches for c in counters}
        print(f"{tag} path of {name}: " + ", ".join(
            f"{n} {k}" for k, n in got.items()) + " launches", flush=True)
        require(got["stepper_chunk"] + got["stepper_sweep"] > 0,
                f"{name} launched no stepper kernel")
        launches[name] = got
        if first is not None:
            err = max(err, hold_path_kernels(name, first, tag, path_spec))

    cpp = native.CppOracle(spec)
    try:
        # (a) the shrinker on the card: 8 violating headline histories
        t_a = time.perf_counter()
        cpp_v = cpp.check_histories(spec, corpus)
        vio = [h for h, x in zip(corpus, cpp_v)
               if x == Verdict.VIOLATION][:SHRINK_HISTORIES]
        require(len(vio) == SHRINK_HISTORIES, "too few violating headline "
                "histories")
        rows, times, compared = [], {}, 0
        for i, h in enumerate(vio):
            host, t_host, _ = shrink_on_card("host", spec, h, None, cpp, tag)
            times["host"] = times.get("host", 0.0) + t_host
            reset()
            # the first history's path is read and held: its batch 1 is
            # the input history, its batch 2 the first frontier
            with (FirstInputs(keep=2) if i == 0
                  else contextlib.nullcontext()) as first:
                st_res, t_st, st_rec = shrink_on_card(
                    "TorchStepper", spec, h, TorchStepper(spec), cpp, tag)
            times["TorchStepper"] = times.get("TorchStepper", 0.0) + t_st
            if i == 0:
                read("the shrinker over TorchStepper (18a)", first)
            plan = plan_search(spec, profile_corpus([h], spec),
                               platform="cuda")
            reset()
            pl_res, t_pl, pl_rec = shrink_on_card(
                "planned", spec, h, build_backend(spec, plan), cpp, tag)
            times["planned"] = times.get("planned", 0.0) + t_pl
            if i == 0:
                read(f"the shrinker over the planned checker ({plan.name},"
                     f" decompose={plan.decompose}) (18a)", None)
            for name, res, rec in (("TorchStepper", st_res, st_rec),
                                   ("planned", pl_res, pl_rec)):
                compared += same_shrink(f"history {i} {name}", res, host,
                                        rec)
            rows.append((len(h), host, st_res, pl_res))
        for i, (n, host, st_res, pl_res) in enumerate(rows):
            print(f"{tag} 18a shrink of headline violation {i} ({n} ops): "
                  + "; ".join(
                      f"{name} {r.final_ops} ops, {r.rounds} rounds, "
                      f"{r.lanes_checked} lanes, {r.engine_calls} engine "
                      f"calls, {r.memo_hits} memo hits, undecided "
                      f"neighbours {r.undecided_neighbors}"
                      for name, r in (("host", host),
                                      ("TorchStepper", st_res),
                                      ("planned", pl_res))), flush=True)
        print(f"{tag} 18a {SHRINK_HISTORIES} headline shrinks: every "
              f"minimised history a VIOLATION by CppOracle, every "
              f"certificate verified, {compared} of "
              f"{2 * SHRINK_HISTORIES} device shrinks equal to the host's "
              f"(the rest left a lane undecided); time by backend "
              + ", ".join(f"{k} {v:.3f} s" for k, v in times.items()),
              flush=True)
        # one kv16 violation through the plan (per key first)
        # the first violation with a linearizable neighbour whose split
        # pays: its certificate then holds a stitched witness
        kv_v = PComp(kv_spec).check_histories(kv_spec, kv_corpus)
        t0 = time.perf_counter()
        for tried, kv_h in enumerate(
                h for h, x in zip(kv_corpus, kv_v) if x == Verdict.VIOLATION):
            cert = minimality_certificate(kv_spec, kv_h)
            stitched = [r for r in cert if r.get("stitched")]
            if stitched or tried == 15:
                break
        t_cert = time.perf_counter() - t0
        require(stitched, "kv16: no stitched witness in the certificates "
                "of the first 16 violations")
        kv_cpp = native.CppOracle(kv_spec)
        kv_host, t_kvh, _ = shrink_on_card("kv16 host", kv_spec, kv_h, None,
                                           kv_cpp, tag)
        kv_plan = plan_search(kv_spec, profile_corpus([kv_h], kv_spec),
                              platform="cuda")
        require(kv_plan.decompose_keys, f"kv16: the plan does not split "
                f"per key: {kv_plan.why}")
        kv_backend = build_backend(kv_spec, kv_plan)
        reset()
        with FirstInputs() as first:
            kv_res, t_kv, kv_rec = shrink_on_card(
                "kv16 planned", kv_spec, kv_h, kv_backend, kv_cpp, tag)
        read(f"the kv16 shrinker over {kv_backend.name} (18a)", first,
             kv_backend.projected)
        kv_same = same_shrink("kv16 planned", kv_res, kv_host, kv_rec)
        n = len(kv_h.ops)
        for r in cert:
            if not r.get("undecided"):
                require(verify_witness(kv_spec, kv_h.subhistory(
                    [i for i in range(n) if i != r["drop"]]),
                    [tuple(p) for p in r["witness"]]),
                    f"kv16: the witness of drop {r['drop']} fails")
        print(f"{tag} 18a kv16 violation ({n} ops) through "
              f"{kv_backend.name}: {kv_res.final_ops} ops after "
              f"{kv_res.rounds} rounds, {kv_res.lanes_checked} lanes, "
              f"{kv_res.engine_calls} engine calls, {kv_res.memo_hits} memo "
              f"hits, {t_kv:.3f} s (host {t_kvh:.3f} s; equal to the "
              f"host's: {kv_same}); the input's certificate: "
              f"{len(stitched)} of {len(cert)} neighbours stitched, "
              f"{sum(not r.get('undecided') for r in cert)} witnesses "
              f"replayed (violation {tried + 1} of the corpus; the "
              f"certificates {t_cert:.3f} s on the host)", flush=True)
        # the same violation through the hybrid plan: TorchStepper over
        # whole histories (kv16 has no scalar state bound: the sweep
        # regime) at the plan's 2000-iteration budget, the per-key host
        # checker taking the lanes it leaves (whole kv16 violations of 60
        # ops outlast even TorchStepper's 552,000 iterations)
        hy = HybridDevice(kv_spec, tail=PComp(kv_spec))
        reset()
        with FirstInputs() as first:
            sw_res, t_sw, sw_rec = shrink_on_card(
                "kv16 hybrid", kv_spec, kv_h, hy, kv_cpp, tag)
        name = ("the kv16 shrinker over HybridDevice (the sweep regime, a "
                "per-key tail) (18a)")
        read(name, first, kv_spec)
        require(launches[name]["stepper_sweep"] > 0,
                f"{name} launched no stepper_sweep")
        sw_same = same_shrink("kv16 hybrid", sw_res, kv_host, sw_rec)
        print(f"{tag} 18a the same kv16 violation through HybridDevice "
              f"(TorchStepper's sweep regime at budget 2000, PComp's host "
              f"tail): {sw_res.final_ops} ops after {sw_res.rounds} rounds, "
              f"{sw_res.lanes_checked} lanes, {sw_res.engine_calls} engine "
              f"calls, {sw_res.memo_hits} memo hits; {hy.device_decided} "
              f"lanes decided on the card, {hy.tail_histories} by the tail; "
              f"{t_sw:.3f} s (equal to the host's: {sw_same})", flush=True)
        # the shrink entry point, on the card by default (the planned
        # checker), on the first headline violation
        trace = tmp / "shrink_trace.json"
        trace.write_text(json.dumps({"model": "cas",
                                     "spec_kwargs": spec.spec_kwargs(),
                                     "history": history_to_rows(vio[0])}))
        reset()
        t0 = time.perf_counter()
        with FirstInputs() as first:
            rc_sh, out_sh = cli_inproc("shrink", "--trace", trace,
                                       "--certificate")
        t_sh = time.perf_counter() - t0
        read("shrink --trace --certificate (18a)", first)
        doc_sh = json.loads(out_sh[-1])
        audit = doc_sh.get("certificate_audit") or {}
        require(rc_sh == 0 and doc_sh["verdict"] == "VIOLATION"
                and audit.get("one_minimal_proved")
                and audit.get("violation_reconfirmed"),
                f"shrink --certificate: rc {rc_sh}, {doc_sh.get('why')}, "
                f"audit {audit}")
        pl0 = rows[0][3]
        got = (doc_sh["history"], doc_sh["rounds"], doc_sh["lanes"],
               doc_sh["engine_calls"], doc_sh["one_minimal"])
        want = (json.loads(json.dumps(history_to_rows(pl0.history))),
                pl0.rounds, pl0.lanes_checked, pl0.engine_calls,
                pl0.one_minimal)
        require(got == want, f"shrink --certificate differs from the "
                f"planned shrink: {got[1:]} against {want[1:]}")
        require(int(cpp.check_histories(spec, [history_from_rows(
            doc_sh["history"])])[0]) == Verdict.VIOLATION,
            "shrink --certificate: the minimised history is not a "
            "VIOLATION by CppOracle")
        print(f"{tag} 18a python -m qsm_tpu_torch shrink --trace "
              f"--certificate (headline violation 0, {len(vio[0])} ops): rc "
              f"0, {doc_sh['final_ops']} ops after {doc_sh['rounds']} "
              f"rounds, {doc_sh['lanes']} lanes, {doc_sh['engine_calls']} "
              f"engine calls, the certificate audited, equal to the planned "
              f"shrink; {t_sh:.3f} s; (a) took "
              f"{time.perf_counter() - t_a:.1f} s", flush=True)

        # (b) run --minimize --backend stepper, in this process
        t_b = time.perf_counter()
        reg = tmp / "minimize.json"
        args = ("run", "--model", "cas", "--impl", "racy", "--trials", 100,
                "--pids", N_PIDS, "--ops", N_OPS, "--seed", 0,
                "--minimize")
        reset()
        with FirstInputs() as first:
            rc, out = cli_inproc(*args, "--backend", "stepper",
                                 "--save-regression", reg)
        read("run --minimize --backend stepper (18b)", first)
        require(rc == 1 and out[0].startswith("FAIL: cas/racy"),
                f"run --minimize: rc {rc}, {out[:1]}")
        at = next(i for i, x in enumerate(out)
                  if x.startswith("history-minimized to"))
        n_min = int(re.search(r"to (\d+) op", out[at]).group(1))
        doc = json.loads(reg.read_text())
        shrunk = history_from_rows(doc["history"])
        again = shrink_history(spec, shrunk, backend=TorchStepper(spec),
                               certificate=False)
        lines = format_history(spec, again.history).splitlines()
        require(n_min == len(again.history) <= len(shrunk)
                and out[at + 1:at + 1 + len(lines)] == lines,
                "run --minimize: the printed minimised history is not the "
                "shrinker's on the regression's history")
        require(int(cpp.check_histories(spec, [again.history])[0])
                == Verdict.VIOLATION, "run --minimize: the minimised "
                "history is not a VIOLATION by CppOracle")
        rc_r, out_r = cli_inproc("replay", "--regression", reg)
        require(rc_r == 1 and "history reproduced bit-identically: True"
                in out_r, f"replay --regression: rc {rc_r}")
        rc_c, out_c = cli_inproc(*args, "--backend", "cpp")
        require(rc_c == 1 and out_c == [x for x in out if not x.startswith(
            "regression saved")], "run --minimize --backend cpp prints "
            "another counterexample or minimised history")
        print(f"{tag} 18b run --model cas --impl racy --minimize --backend "
              f"stepper ({N_PIDS} x {N_OPS}, 100 trials, seed 0): rc 1, "
              f"{out[1]} "
              f"minimised to {n_min} ops from {len(shrunk)} (a VIOLATION "
              f"by CppOracle, equal to the shrinker's on the regression's "
              f"history), replay --regression bit-identical; --backend "
              f"cpp prints the same counterexample and minimised history; "
              f"(b) took {time.perf_counter() - t_b:.1f} s", flush=True)

        # (c) failover on the headline's 4096 lanes
        t_c = time.perf_counter()
        lanes = _replicate(corpus, DEVICE_BATCH)
        want = cpp.check_histories(spec, lanes)
        clean_v, clean_s = timed_check(TorchStepper(spec), spec, lanes)
        decided = clean_v != Verdict.BUDGET_EXCEEDED
        require((clean_v == want)[decided].all(), "the clean run differs "
                "from CppOracle")
        side = torch.cuda.Stream(dev)
        reset()
        with FirstInputs() as first, LaunchOrigin(dev) as origin, \
                FaultEnv("raise:dispatch@2"):
            fo = FailoverBackend(spec, TorchStepper(spec))
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                v = fo.check_histories(spec, lanes)
            torch.cuda.synchronize()
            t_fo = time.perf_counter() - t0
        read("FailoverBackend(TorchStepper) under raise:dispatch@2 (18c)",
             first)
        r = fo.resilience()
        require(v.tolist() == want.tolist(), "failover: verdicts differ "
                "from the clean run's")
        split = (fo.DISPATCH_LANES, len(lanes) - fo.DISPATCH_LANES)
        require((r["device_histories"], r["fallback_histories"],
                 r["degradations"], r["fallback_engine"])
                == (*split, 1, native.CppOracle.name),
                f"failover under raise:dispatch@2: {r}")
        require(origin.thread != threading.get_ident()
                and origin.stream == side.cuda_stream,
                "failover: the guarded launch ran outside the watchdog's "
                "thread or off the caller's stream")
        print(f"{tag} 18c FailoverBackend(TorchStepper) on {len(lanes)} "
              f"headline lanes, QSM_TPU_FAULTS=raise:dispatch@2: verdicts "
              f"equal to "
              f"the clean run's ({clean_s:.3f} s clean); device "
              f"{r['device_histories']}, fallback "
              f"{r['fallback_histories']} ({r['fallback_engine']}), "
              f"degradations {r['degradations']}, retries {r['retries']}; "
              f"{t_fo:.3f} s; the first launch from the watchdog's thread "
              f"on the caller's stream", flush=True)
        with FaultEnv("hang:dispatch@1", hang_s=HANG_S):
            fo = FailoverBackend(spec, TorchStepper(spec),
                                 policy=preset("dispatch").with_(
                                     timeout_s=HANG_TIMEOUT_S))
            t0 = time.perf_counter()
            v = fo.check_histories(spec, lanes)
            t_hang = time.perf_counter() - t0
        require(v.tolist() == want.tolist() and fo.degraded
                and fo.last_error.startswith("InjectedHang"),
                f"failover under hang:dispatch@1: {fo.resilience()}")
        print(f"{tag} 18c ... hang:dispatch@1 (hang {HANG_S} s, watchdog "
              f"{HANG_TIMEOUT_S} s): degraded through the watchdog "
              f"({fo.last_error[:60]}...), retries {fo.retries}, verdicts "
              f"exact, {t_hang:.3f} s", flush=True)
        st = TorchStepper(spec)

        def lost(*a, **kw):
            raise BackendUnavailable("raised by the smoke test, not by "
                                     "the fault plane")

        st._run_device = lost
        fo = FailoverBackend(spec, st)
        for what, call in (
                ("FailoverBackend", lambda: fo.check_histories(spec,
                                                               lanes[:64])),
                ("prop_concurrent", lambda: prop_concurrent(
                    spec, RacyCasSUT(spec),
                    PropertyConfig(n_trials=2, n_pids=2, max_ops=6),
                    backend=st))):
            try:
                call()
            except BackendUnavailable:
                continue
            raise RuntimeError(f"chip_smoke: a real BackendUnavailable did "
                               f"not raise out of {what}")
        require(not fo.degraded and fo.degradations == 0,
                "the card's rule: a real error was degraded")
        print(f"{tag} 18c the card's rule: a BackendUnavailable the plane "
              f"did not inject raises out of FailoverBackend and "
              f"prop_concurrent, no degrade recorded", flush=True)
        q_spec = QueueSpec()
        for what, w_spec, w_lanes in (
                ("CAS headline", spec, lanes[:WRAP_LANES]),
                ("queue headline", q_spec, build_corpus(
                    q_spec, (AtomicQueueSUT, RacyTwoPhaseQueueSUT),
                    n=WRAP_LANES, n_pids=Q_PIDS, max_ops=Q_OPS,
                    seed_base=1000, seed_prefix="bench"))):
            wrap_ms = wrap_cost(w_spec, w_lanes)
            print(f"{tag} 18c what the wrap costs a dispatch of "
                  f"{WRAP_LANES} {what} lanes ({WRAP_REPS} dispatches a "
                  f"turn, host clock to the card's completion, in turns "
                  f"forward and backward): " + ", ".join(
                      f"{k} {v:.4f} ms" for k, v in wrap_ms.items()),
                  flush=True)
        reset()
        with FirstInputs() as first:
            rc_s, out_s = cli_inproc("stats", "--model", "cas", "--backend",
                                     "stepper", "--failover")
        read("stats --failover --backend stepper (18c)", first)
        sdoc = json.loads(out_s[-1])
        res_block = sdoc["resilience"]
        require(rc_s == 0 and res_block["degradations"] == 0
                and res_block["retries"] == 0
                and res_block["fallback_histories"] == 0
                and res_block["fallback_engine"] is None
                and res_block["device_histories"] == sdoc["histories"],
                f"stats --failover: {res_block}")
        print(f"{tag} 18c stats --model cas --backend stepper --failover: "
              f"backend {sdoc['backend']}, resilience {res_block}",
              flush=True)
        rc_p, out_p = cli_result(proc, "run --failover")
        rec = [json.loads(x) for x in log.read_text().splitlines()][-1]
        require(rc_p == 1 and out_p[0].startswith("FAIL: cas/racy")
                and rec["timings"].get("resilience_degradations") == 1,
                f"run --failover under raise:dispatch@3: rc {rc_p}, "
                f"timings {rec['timings']}")
        print(f"{tag} 18c python -m qsm_tpu_torch run --failover --backend "
              f"stepper, QSM_TPU_FAULTS=raise:dispatch@3: rc 1 ({out_p[1]}),"
              f" the log's resilience_degradations 1; (c) took "
              f"{time.perf_counter() - t_c:.1f} s", flush=True)

        # (d) check_one on bench-corpus history #35
        h35 = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=36,
                           n_pids=8, max_ops=32, seed_base=1000,
                           seed_prefix="bench")[35]
        n35 = bucket_for(len(h35))
        enc = encode_batch([h35], spec.initial_state(), max_ops=n35)
        planes = (enc.ops[:, :, 1], enc.ops[:, :, 2], enc.ops[:, :, 3],
                  enc.valid, enc.precedes())
        check_one_rec = {}
        for slots, want_status in ((CHECK_ONE_SLOTS, 2), (0, 3)):
            reset()
            s, it = build_kernel(spec, n35, CHECK_ONE_BUDGET,
                                 cache_slots=slots)(*planes, enc.init_state)
            read(f"check_one, {slots} slots (18d)", None)
            require(stepper_chunk.launches == 1, "check_one: not one launch")
            tabs = stepper_tables(spec, *planes, dev)
            fresh = fresh_stepper_carry(
                tabs.nreq, np.arange(1),
                np.full(1, int(enc.init_state[0]), np.int32), 1, n35, slots)
            out_c = stepper_chunk(tabs, clone_carry(fresh),
                                  chunk=CHECK_ONE_BUDGET,
                                  budget=CHECK_ONE_BUDGET)
            run = CHECK_ONE_BUDGET if slots else CHECK_ONE_PLAIN
            ker = (out_c if slots else stepper_chunk(
                tabs, clone_carry(fresh), chunk=run,
                budget=CHECK_ONE_BUDGET))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = stepper_chunk_plain(tabs, clone_carry(fresh), chunk=run,
                                        budget=CHECK_ONE_BUDGET)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max(err, _compare(f"check_one ({slots} slots)", ker, plain))
            status, iters = int(out_c.dsi[STATUS, 0]), int(out_c.dsi[ITERS, 0])
            require((int(s[0]), int(it[0])) == (status, iters),
                    "check_one differs from the same launch by hand")
            require(status == want_status and (
                iters < 50_000 if slots else iters == CHECK_ONE_BUDGET),
                f"check_one ({slots} slots): status {status}, {iters} "
                f"iterations")
            ms = time_launches(
                lambda c: stepper_chunk(tabs, c, chunk=CHECK_ONE_BUDGET,
                                        budget=CHECK_ONE_BUDGET),
                [clone_carry(fresh) for _ in range(4)], 3)
            bound_ms, bound_by, _, _ = stepper_bound(tabs, fresh, out_c)
            plain_iters = int(plain.dsi[ITERS, 0])
            # ms and plain_ms cover different iteration counts without
            # the memo: the per-iteration times are on one basis
            check_one_rec[f"slots_{slots}"] = dict(
                status=status, iters=iters, ms=ms, plain_ms=plain_ms,
                plain_iters=plain_iters, ms_per_iter=ms / iters,
                plain_ms_per_iter=plain_ms / plain_iters,
                bound_ms=bound_ms, bound_by=bound_by)
            print(f"{tag} 18d check_one on bench history #35 ({len(h35)} "
                  f"ops), budget {CHECK_ONE_BUDGET}, {slots} slots: one "
                  f"stepper_chunk launch, status {status}, {iters} "
                  f"iterations, {ms:.4f} ms a launch (CUDA events) against "
                  f"its bound {bound_ms:.6f} ms ({bound_by}), "
                  f"{ms / iters * 1e3:.4f} us an iteration; the plain "
                  f"version on the card over {plain_iters} iterations: all "
                  f"7 planes bit-identical, {plain_ms:.1f} ms, "
                  f"{plain_ms / plain_iters * 1e3:.1f} us an iteration",
                  flush=True)
    finally:
        if proc.poll() is None:
            reap(proc)
    total = {c.__name__: sum(x[c.__name__] for x in launches.values())
             for c in counters}
    dt = time.perf_counter() - t_phase
    print(f"{tag} phase 18 launches: " + ", ".join(
        f"{n} {k}" for k, n in total.items()) + f"; {dt:.1f} s", flush=True)
    return launches, err, check_one_rec


# ---------------------------------------------------------------------------
# Phase 19: observability, the streaming monitor and trace ingest
# ---------------------------------------------------------------------------

MONITOR_UNIQUE = 128           # (a): unique histories a family
MONITOR_CHUNK = {"CAS headline": 8, "queue headline": 8, "kv16": 16}
MONITOR_PROFILED = 8           # (a): histories streamed again, profiled
STREAM_EVENTS, STREAM_CHUNK = 1000, 20   # (b): tools/bench_monitor.py:52-53
STREAM_BAD_READ = 4            # (c): a read of a value the stream never
# writes (it writes 1-3; the register spec's values are 0-4)
GOLDENS = (("golden_jepsen_register.edn", "jepsen", "register"),
           ("golden_porcupine_kv.edn", "porcupine", "kv"),
           ("golden_jepsen_rangeset.edn", "jepsen", "rangeset"),
           ("golden_jepsen_semaphore.edn", "jepsen", "semaphore"),
           ("golden_porcupine_txn.edn", "porcupine", "txn"))


def monitor_stream_rows(n_ops: int):
    """``tools/bench_monitor.py:52-77``'s register stream: mostly
    sequential, with one overlapping pair of pids every 8 ops."""
    rows = []
    t = 0
    for i in range(n_ops):
        val = (i % 3) + 1
        if i % 8 == 7:
            rows.append([0, 1, val, 0, t, t + 3])
            rows.append([1, 0, 0, val, t + 1, t + 2])
            t += 4
        else:
            cmd = 1 if i % 2 == 0 else 0
            arg = val if cmd == 1 else 0
            resp = 0
            if cmd == 0:
                resp = next((r[2] for r in reversed(rows) if r[1] == 1), 0)
            rows.append([0, cmd, arg, resp, t, t + 1])
            t += 2
    return rows


def seeded_stream(rows):
    """``rows`` with a third pid's read of a value never written inserted
    at the first quiescent point past the middle (later rows shifted):
    a violation in the middle of the stream that shrinks to that one
    op."""
    at = next(i for i in range(len(rows) // 2, len(rows))
              if rows[i][4] > max(r[5] for r in rows[:i]))
    t = rows[at][4]
    return (rows[:at] + [[2, 0, 0, STREAM_BAD_READ, t, t + 1]]
            + [[p, c, a, r, i + 2, o + 2] for p, c, a, r, i, o in rows[at:]])


def stream_into(session, rows, chunk):
    """``rows`` appended ``chunk`` at a time, a decide after each, then
    closed; (final verdict, decides, verdicts before the close)."""
    seen = []
    for i in range(0, len(rows), chunk):
        session.append(rows[i:i + chunk])
        seen.append(session.decide())
    return session.close(), len(seen), seen


def phase_monitor(spec, corpus, q_spec, q_corpus, kv_spec, kv_corpus, dev,
                  tag):
    """Phase 19: observability, the streaming monitor and trace ingest on
    the card; see the module docstring.  Returns (launches of each path,
    largest error of the kernels held on the paths, the record)."""
    import tempfile

    from qsm_tpu_torch import obs
    from qsm_tpu_torch.core.spec import projection_report
    from qsm_tpu_torch.ingest import emit_trace
    from qsm_tpu_torch.monitor import MonitorSession, SessionManager
    from qsm_tpu_torch.serve.cache import VerdictCache
    from qsm_tpu_torch.utils.report import \
        history_from_rows as canonical_rows

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p19_"))
    reg_spec, _ = make_model("register", "atomic")
    # (c) in a subprocess, beside the in-process paths: the stream with a
    # violation seeded in its middle, as a Jepsen log the port wrote
    stream = monitor_stream_rows(STREAM_EVENTS // 2)
    seeded = seeded_stream(stream)
    edn = tmp / "stream.edn"
    edn.write_text(emit_trace("jepsen", canonical_rows(seeded), "register",
                              reg_spec))
    saved = tmp / "flip.json"
    t_c0 = time.perf_counter()
    proc = cli_proc("monitor", edn, "--format", "jepsen", "--spec",
                    "register", "--save", saved)
    counters = (stepper_chunk, compact_carry, stepper_sweep)
    launches, err, record = {}, 0, {}

    def reset():
        for c in counters:
            c.launches = 0

    def read(name, first, path_spec=None, need=True):
        nonlocal err
        got = {c.__name__: c.launches for c in counters}
        print(f"{tag} path of {name}: " + ", ".join(
            f"{n} {k}" for k, n in got.items()) + " launches", flush=True)
        require(not need or got["stepper_chunk"] + got["stepper_sweep"] > 0,
                f"{name} launched no stepper kernel")
        launches[name] = got
        if first is not None:
            err = max(err, hold_path_kernels(name, first, tag, path_spec))

    try:
        # (a) monitor parity at the headline shapes, a SessionManager a
        # family (one window engine a spec, on the card)
        t_a = time.perf_counter()
        fams = []
        for name, fspec, hists in (
                ("CAS headline", spec, corpus[:MONITOR_UNIQUE]),
                ("queue headline", q_spec, q_corpus[:MONITOR_UNIQUE]),
                ("kv16", kv_spec, kv_corpus[:MONITOR_UNIQUE])):
            proj = (None if projection_report(fspec)
                    else fspec.projected_spec())
            want = native.CppOracle(fspec).check_histories(fspec, hists)
            mgr = SessionManager(max_sessions=len(hists) + 1)
            chunk = MONITOR_CHUNK[name]
            bad_final = bad_flip = decides = 0
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with FirstInputs() as first:
                for k, h in enumerate(hists):
                    s, _ = mgr.open(f"m{k}", fspec, proj)
                    v, n, seen = stream_into(s, history_to_rows(h), chunk)
                    mgr.close(s.sid)
                    decides += n
                    bad_final += v != int(want[k])
                    bad_flip += (int(want[k]) == Verdict.LINEARIZABLE
                                 and Verdict.VIOLATION in seen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            path = f"the monitor, {name} (19a)"
            read(path, first, proj or fspec)
            require(launches[path]["stepper_chunk"] > 0,
                    f"{path} launched no stepper_chunk")
            require(bad_final == 0 and bad_flip == 0,
                    f"{name}: {bad_final} final verdicts differ from "
                    f"CppOracle's, {bad_flip} flips on a linearizable "
                    f"history")
            st = mgr.engines.stats()
            # a steady window: the first histories again, profiled
            wall, dev_s, top = profile_device(lambda: [stream_into(
                mgr.open(f"p{k}", fspec, proj)[0], history_to_rows(h),
                chunk) for k, h in enumerate(hists[:MONITOR_PROFILED])])
            rec = dict(histories=len(hists), decides=decides, seconds=dt,
                       s_per_decide=dt / decides, calls=st["calls"],
                       lanes=st["lanes"],
                       lanes_per_call=st["lanes"] / max(1, st["calls"]),
                       redecided=st["redecided"],
                       host_windows=st["host_windows"],
                       window_s=st["seconds"],
                       violations=int((want == Verdict.VIOLATION).sum()),
                       idle_share=1 - dev_s / wall if wall else None,
                       profiled_wall_s=wall, profiled_device_s=dev_s)
            record[name] = rec
            fams.append((name, mgr))
            print(f"{tag} 19a monitor parity, {name}: {len(hists)} "
                  f"histories streamed {chunk} rows a decide, {decides} "
                  f"decides in {dt:.3f} s ({dt / decides * 1e3:.3f} ms a "
                  f"decide), 0 final verdicts off CppOracle's "
                  f"({rec['violations']} violations), 0 flips on a "
                  f"linearizable history; window engine: {st['calls']} "
                  f"calls, {st['lanes']} lanes ({rec['lanes_per_call']:.2f} "
                  f"a call), {st['redecided']} BUDGET lanes decided again "
                  f"on the host, {st['host_windows']} windows over the op "
                  f"cap, {st['seconds']:.3f} s in the engine; "
                  f"{MONITOR_PROFILED} histories again under the profiler: "
                  f"{wall:.3f} s wall, {dev_s:.4f} s on the device, idle "
                  f"{rec['idle_share']:.4f}; top {top}", flush=True)
        print(f"{tag} 19a took {time.perf_counter() - t_a:.1f} s",
              flush=True)

        # (b) the 1000-event register stream, on the card and on the host
        # in turns, then replayed into a session sharing the bank
        t_b = time.perf_counter()
        times = {"card": [], "host": []}
        for where in ("card", "host", "host", "card"):
            reset()
            s = MonitorSession("stream", reg_spec,
                               device="cpu" if where == "host" else None)
            with (FirstInputs() if where == "card" and not times["card"]
                  else contextlib.nullcontext()) as first:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                v, n, _ = stream_into(s, stream, STREAM_CHUNK)
                torch.cuda.synchronize()
                times[where].append(time.perf_counter() - t0)
            require(v == Verdict.LINEARIZABLE, f"the stream on the {where}: "
                    f"verdict {v}")
            if where == "card" and first is not None:
                read("the 1000-event stream on the card (19b)", first)
            counters_of = s.counters()
        bank = VerdictCache(max_entries=65_536)
        s1 = MonitorSession("s1", reg_spec, bank=bank)
        stream_into(s1, stream, STREAM_CHUNK)
        s2 = MonitorSession("s2", reg_spec, bank=bank)
        v2, _, _ = stream_into(s2, stream, STREAM_CHUNK)
        c1, c2 = s1.counters(), s2.counters()
        require(v2 == Verdict.LINEARIZABLE and c2["advances"] ==
                c1["advances"] > 0 and c2["prefix_hits"] == c2["advances"],
                f"the banked replay: {c1} then {c2}")
        record["stream"] = dict(events=STREAM_EVENTS, rows=len(stream),
                                decides=n, card_s=times["card"],
                                host_s=times["host"], counters=counters_of,
                                replay=c2)
        print(f"{tag} 19b the {STREAM_EVENTS}-event register stream "
              f"({len(stream)} rows, {STREAM_CHUNK} a decide, {n} decides): "
              f"card " + " / ".join(f"{x:.4f}" for x in times["card"])
              + " s, host loop " + " / ".join(
                  f"{x:.4f}" for x in times["host"]) + " s (turns card, "
              f"host, host, card); counters {counters_of}; replayed into a "
              f"session sharing the bank: prefix_hits {c2['prefix_hits']} "
              f"== advances {c2['advances']}; (b) took "
              f"{time.perf_counter() - t_b:.1f} s", flush=True)

        # (d) ingest --check on the goldens, on the card and --device cpu
        t_d = time.perf_counter()
        data = REPO / "tests" / "data"
        verdicts = []
        reset()
        for fname, fmt, model in GOLDENS:
            base = ("ingest", data / fname, "--format", fmt, "--spec", model)
            rc, out = cli_inproc(*base, "--check")
            rc_h, out_h = cli_inproc(*base, "--check", "--device", "cpu")
            require((rc, out[-1:]) == (rc_h, out_h[-1:]),
                    f"ingest --check {fname}: card rc {rc} {out[-1:]}, "
                    f"--device cpu rc {rc_h} {out_h[-1:]}")
            emitted = tmp / f"emit_{fname}"
            require(cli_inproc(*base, "--emit", "--out", emitted)[0] == 0
                    and emitted.read_bytes() == (data / fname).read_bytes(),
                    f"ingest --emit {fname} is not byte-stable")
            verdicts.append(f"{fname} {json.loads(out[-1])['verdict']} "
                            f"(rc {rc})")
        read("ingest --check on the goldens (19d)", None, need=False)
        print(f"{tag} 19d ingest --check on the card, equal to --device "
              f"cpu: " + ", ".join(verdicts) + f"; --emit byte-stable on "
              f"all {len(GOLDENS)}; (d) took "
              f"{time.perf_counter() - t_d:.1f} s", flush=True)

        # (e) observability: a sink installed, phase 18 (c)'s failover
        t_e = time.perf_counter()
        log, fdir = tmp / "obs.jsonl", tmp / "flight"
        bundle = obs.Observability(trace_log=str(log), flight_dir=str(fdir))
        events = bundle.metrics.counter("qsm_smoke_events_total",
                                        "events the sink received")
        bundle.tracer.add_hook(lambda d: events.inc(1, name=d["name"]))
        for name, r in record.items():
            if "calls" in r:
                fam = name.split()[0].lower()
                for key in ("calls", "lanes", "redecided"):
                    bundle.metrics.counter(
                        f"qsm_monitor_window_{key}_total").inc(
                            r[key], family=fam)
        lanes = _replicate(corpus, DEVICE_BATCH)
        want = native.CppOracle(spec).check_histories(spec, lanes)
        obs.set_global(bundle)
        reset()
        try:
            with FirstInputs() as first, FaultEnv("raise:dispatch@2"):
                fo = FailoverBackend(spec, TorchStepper(spec))
                v = fo.check_histories(spec, lanes)
        finally:
            obs.set_global(None)
            bundle.close()
        read("FailoverBackend(TorchStepper) under raise:dispatch@2, a sink "
             "installed (19e)", first)
        require(v.tolist() == want.tolist() and fo.degradations == 1,
                f"failover with a sink: {fo.resilience()}")
        names = [e["name"] for e in obs.load_events(str(log))]
        require("fault.hit" in names and "failover.degrade" in names,
                f"the trace log holds {names}")
        dumps = sorted(p.name for p in fdir.glob("FLIGHT_*.json"))
        rc_t, out_t = cli_result(cli_proc("trace", "", "--log", log),
                                 "trace")
        text = "\n".join(out_t)
        require(rc_t == 0 and "fault.hit" in text
                and "failover.degrade" in text,
                f"trace --log: rc {rc_t}, {out_t[:4]}")
        vals = obs.parse_exposition(bundle.metrics.render())
        seen = {n: names.count(n) for n in set(names)}
        got = {n: vals.get(f'qsm_smoke_events_total{{name="{n}"}}')
               for n in seen}
        for name, r in record.items():
            if "calls" in r:
                fam = name.split()[0].lower()
                for key in ("calls", "lanes", "redecided"):
                    k = f'qsm_monitor_window_{key}_total{{family="{fam}"}}'
                    require(vals.get(k) == r[key], f"exposition {k}: "
                            f"{vals.get(k)} against {r[key]}")
        require(got == seen, f"the exposition's event counts {got} against "
                f"the log's {seen}")
        record["obs"] = dict(events=seen, dumps=dumps)
        print(f"{tag} 19e a sink installed (set_global), FailoverBackend("
              f"TorchStepper) on {len(lanes)} headline lanes under "
              f"raise:dispatch@2: verdicts exact, the trace log holds "
              f"{seen}, flight dumps {dumps}; python -m qsm_tpu_torch trace "
              f"'' --log: rc 0, the tree:\n" + text + "\n"
              f"{tag} 19e the registry's exposition parses back to the "
              f"counts recorded (events by name, the monitor's window "
              f"calls, lanes and re-decides by family); (e) took "
              f"{time.perf_counter() - t_e:.1f} s", flush=True)

        # (c) the monitor subcommand's result
        rc, out = cli_result(proc, "monitor")
        t_c = time.perf_counter() - t_c0
        lines = [json.loads(x) for x in out]
        flip, final = lines[0], lines[-1]
        require(rc == 1 and flip.get("event") == "session.flip"
                and final["verdict"] == "VIOLATION",
                f"monitor: rc {rc}, {out[:1]} ... {out[-1:]}")
        repro = history_from_rows(flip["repro"])
        require(int(native.CppOracle(reg_spec).check_histories(
            reg_spec, [repro])[0]) == Verdict.VIOLATION,
            "monitor: the flip's repro is not a VIOLATION by CppOracle")
        audit = verify_certificate(reg_spec, repro, flip["certificate"])
        require(audit["one_minimal_proved"]
                and audit["violation_reconfirmed"],
                f"monitor: the flip's certificate: {audit}")
        rc_s, out_s = cli_inproc("check", "--trace", saved)
        require(rc_s == 1 and json.loads(out_s[-1])["verdict"]
                == "VIOLATION", f"check --trace of the saved repro: rc "
                f"{rc_s}")
        record["monitor_cli"] = dict(seconds=t_c, flip={
            k: flip[k] for k in ("initial_ops", "final_ops",
                                 "one_minimal", "complete")},
            final=final)
        print(f"{tag} 19c python -m qsm_tpu_torch monitor on a Jepsen log "
              f"of the stream ({len(seeded)} ops, a read of "
              f"{STREAM_BAD_READ} seeded at op "
              f"{next(i for i, r in enumerate(seeded) if r[0] == 2)}): rc "
              f"1, the flip shrunk from {flip['initial_ops']} to "
              f"{flip['final_ops']} ops (one_minimal {flip['one_minimal']}),"
              f" a VIOLATION by CppOracle, its certificate verified; "
              f"check --trace of --save: VIOLATION; final line {final}; "
              f"{t_c:.1f} s in its subprocess", flush=True)
    finally:
        if proc.poll() is None:
            reap(proc)
    total = {c.__name__: sum(x[c.__name__] for x in launches.values())
             for c in counters}
    dt = time.perf_counter() - t_phase
    record["seconds"] = dt
    print(f"{tag} phase 19 record: {json.dumps(record)}", flush=True)
    print(f"{tag} phase 19 launches: " + ", ".join(
        f"{n} {k}" for k, n in total.items()) + f"; {dt:.1f} s", flush=True)
    return launches, err, record


SERVE_LANES = 64               # (a): histories a request; the reference's
# max_lanes, the flush width
SERVE_CLIENTS = 4              # (a): concurrent clients a pass
SERVE_WIDE = 1024              # (a): the CAS pass again at this flush width
SERVE_DEPTH = 4096             # (a): admission depth (the batcher's: twice)
SERVE_CACHE = 65_536           # (a): verdict-cache entries
SERVE_WITNESSES = 64           # (a): lanes whose witnesses are replayed
DRAIN_WINDOW_S = 10.0          # (d): the drain's deadline
DRAIN_BUDGET = 8               # (d): the shrink round's budget (undecided)
FUZZ_ROUNDS = 2                # (b): fuzz --addr rounds a model


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))] if xs \
        else None


class ServedPass:
    """One corpus through a server: ``SERVE_CLIENTS`` concurrent
    ``CheckClient``s, each sending its share of ``SERVE_LANES``-history
    requests; the responses in corpus order, each request's latency."""

    def __init__(self, address, model, hists, spec_kwargs=None,
                 witness_of=()):
        from qsm_tpu_torch.serve import CheckClient

        reqs = [hists[i:i + SERVE_LANES]
                for i in range(0, len(hists), SERVE_LANES)]
        self.reqs = reqs
        self.docs = [None] * len(reqs)
        self.latency = []
        lock = threading.Lock()

        def client(k):
            with CheckClient(address, timeout_s=600) as c:
                for j in range(k, len(reqs), SERVE_CLIENTS):
                    t0 = time.perf_counter()
                    doc = c.check(model, reqs[j], spec_kwargs=spec_kwargs,
                                  deadline_s=600,
                                  witness=j in witness_of)
                    dt = time.perf_counter() - t0
                    with lock:
                        self.latency.append(dt)
                    self.docs[j] = doc

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_CLIENTS) as ex:
            list(ex.map(client, range(SERVE_CLIENTS)))
        self.seconds = time.perf_counter() - t0
        bad = [d or {} for d in self.docs if not (d or {}).get("ok")]
        if bad:
            require(False, f"{model}: a served request failed: "
                    f"{bad[0].get('error') or bad[0]}")
        self.verdicts = np.array(
            [Verdict[v] for d in self.docs for v in d["verdicts"]])
        self.cached = [c for d in self.docs for c in d["cached"]]
        self.batches = {b["batch"]: b for d in self.docs
                        for b in d["batches"]}


def served_paths(srv):
    """The server's flush accounting so far (a pass reads it before and
    after)."""
    st = srv.stats()
    return dict(batches=st["batcher"]["batches"], lanes=st["batcher"]["lanes"],
                padded=st["padded_lanes"],
                budget_resolved=st["budget_resolved"],
                serve_faults=st["serve_faults"])


def phase_serve(spec, corpus, q_spec, q_corpus, kv_spec, kv_corpus, mon_rec,
                tag, device=None):
    """Phase 20: the check server on the card; see the module docstring.
    Returns (launches of each path, largest error of the kernels held on
    the paths, the record).  ``device`` is the servers' (the card when
    None)."""
    import tempfile
    import urllib.request

    from qsm_tpu_torch import obs
    from qsm_tpu_torch.devq import (DeviceWorkQueue, DrainScheduler,
                                    global_devq, set_global_devq)
    from qsm_tpu_torch.ingest import emit_trace
    from qsm_tpu_torch.monitor import MonitorSession
    from qsm_tpu_torch.serve import CheckClient, CheckServer, SessionHandle
    from qsm_tpu_torch.serve.cache import VerdictCache
    from qsm_tpu_torch.utils.report import \
        history_from_rows as canonical_rows

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p20_"))
    d1, d2, tlog = tmp / "replog", tmp / "devq", tmp / "trace.jsonl"
    dev_args = [] if device is None else ["--device", str(device)]
    serve_argv = ("serve", "--port", 0, "--warm", "cas,queue,kv",
                  "--replog-dir", d1, "--devq-dir", d2, "--trace-log", tlog,
                  "--metrics-port", 0, *dev_args)
    # (b)'s server starts in a subprocess beside (a)
    server_proc = cli_proc(*serve_argv)
    counters = (stepper_chunk, compact_carry, stepper_sweep, dfs_chunk,
                threefry_draws)
    launches, err, record = {}, 0, {}
    kv_kw = kv_spec.spec_kwargs()

    def reset():
        for c in counters:
            c.launches = 0

    def read(name, first, path_spec=None, need=("stepper_chunk",)):
        nonlocal err
        got = {c.__name__: c.launches for c in counters}
        print(f"{tag} path of {name}: " + ", ".join(
            f"{n} {k}" for k, n in got.items()) + " launches", flush=True)
        for k in need:
            require(got[k] > 0, f"{name} launched no {k}")
        launches[name] = got
        if first is not None:
            err = max(err, hold_path_kernels(name, first, tag, path_spec))

    def banner(proc, what):
        line = proc.stdout.readline()
        require(line.startswith("{"), f"{what}: no banner: {line!r} "
                f"{proc.stderr.read()[-600:] if proc.poll() is not None else ''}")
        return json.loads(line)

    def stop_server(proc, addr, what):
        if proc.poll() is None and addr:
            try:
                with CheckClient(addr, timeout_s=30) as c:
                    c.shutdown()
            except (OSError, ConnectionError):
                pass
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise RuntimeError(f"chip_smoke: {what} did not stop")

    addr1 = addr2 = None
    proc2 = None
    try:
        # (a) the in-process server on the card
        t_a = time.perf_counter()
        cpp = native.CppOracle(spec)
        q_cpp = native.CppOracle(q_spec)
        lanes = _replicate(corpus, DEVICE_BATCH)
        q_lanes = _replicate(q_corpus, DEVICE_BATCH)
        want = cpp.check_histories(spec, lanes)
        q_want = q_cpp.check_histories(q_spec, q_lanes)
        kv_want = PComp(kv_spec).check_histories(kv_spec, kv_corpus)
        # the witness sample: the first request's SERVE_WITNESSES lanes
        witness_req = set(range(SERVE_WITNESSES // SERVE_LANES))
        lat = {"check": [], "shrink": [], "session": []}
        rec_a = {}
        # a kv16 request of 64 histories is ~1000 per-key sub-lanes: the
        # batcher's bound (twice the admission depth) must hold the four
        # clients' requests at once, or it sheds them, and the cache must
        # hold every sub-history's row beside the whole histories', or
        # the second pass misses what the LRU evicted
        srv = CheckServer(flush_s=0.005, max_lanes=SERVE_LANES,
                          queue_depth=SERVE_DEPTH, cache_entries=SERVE_CACHE,
                          device=device).start()
        try:
            # warm, as `serve --warm` does: a pass times serving, not the
            # engines' construction
            t0 = time.perf_counter()
            for model, kw in (("cas", None), ("queue", None), ("kv", kv_kw),
                              ("register", None)):
                srv.warm(model, kw)
            torch.cuda.synchronize()
            rec_a["warm_s"] = time.perf_counter() - t0
            for name, model, s_, hs, w, kw in (
                    ("CAS headline", "cas", spec, lanes, want, None),
                    ("queue headline", "queue", q_spec, q_lanes, q_want,
                     None),
                    ("kv16 per key", "kv", kv_spec, kv_corpus, kv_want,
                     kv_kw)):
                reset()
                before = served_paths(srv)
                with FirstInputs() as first:
                    p = ServedPass(srv.address, model, hs, kw,
                                   witness_of=witness_req
                                   if model == "cas" else ())
                after = served_paths(srv)
                # a kv16 history whose split does not pay is checked
                # whole: its lanes take the sweep regime of kv16's spec
                read(f"the server, {name} (20a)", first, s_)
                off = int((p.verdicts != np.asarray(w)).sum())
                require(off == 0, f"served {name}: {off} verdicts off "
                        f"CppOracle's")
                lat["check"] += p.latency
                again = ServedPass(srv.address, model, hs, kw)
                require(all(again.cached) and
                        (again.verdicts == p.verdicts).all(),
                        f"served {name}: the second pass answered "
                        f"{len(again.cached) - sum(again.cached)} lanes "
                        f"uncached")
                flushes = after["batches"] - before["batches"]
                rec_a[name] = dict(
                    lanes=len(hs), requests=len(p.docs), seconds=p.seconds,
                    histories_per_s=len(hs) / p.seconds,
                    flushes=flushes,
                    lanes_a_flush=(after["lanes"] - before["lanes"])
                    / max(flushes, 1),
                    padded=after["padded"] - before["padded"],
                    budget_resolved=after["budget_resolved"]
                    - before["budget_resolved"],
                    cached_pass_s=again.seconds,
                    p50_ms=_pct(p.latency, 0.5) * 1e3,
                    p99_ms=_pct(p.latency, 0.99) * 1e3)
                if model == "cas":
                    d = p.docs[0]
                    n_ok = 0
                    for h, v, wit in zip(hs[:SERVE_WITNESSES],
                                         d["verdicts"], d["witnesses"]):
                        if v == "LINEARIZABLE":
                            require(wit is not None and verify_witness(
                                s_, h, [tuple(x) for x in wit]),
                                "served CAS: a witness does not replay")
                            n_ok += 1
                    rec_a[name]["witnesses_replayed"] = n_ok
                r = rec_a[name]
                print(f"{tag} 20a served {name}: {r['lanes']} lanes in "
                      f"{r['requests']} requests of {SERVE_LANES} from "
                      f"{SERVE_CLIENTS} clients, {r['seconds']:.3f} s = "
                      f"{r['histories_per_s']:.1f} histories/s; "
                      f"{r['flushes']} flushes, {r['lanes_a_flush']:.2f} "
                      f"lanes a flush, {r['padded']} padded lanes; "
                      f"{r['budget_resolved']} BUDGET lanes resolved by the "
                      f"oracle; request p50 {r['p50_ms']:.2f} ms, p99 "
                      f"{r['p99_ms']:.2f} ms; 0 verdicts off CppOracle's"
                      + (f"; {r['witnesses_replayed']} witnesses of "
                         f"{SERVE_WITNESSES} lanes replayed"
                         if "witnesses_replayed" in r else "")
                      + f"; the second pass all cached in "
                      f"{again.seconds:.3f} s", flush=True)
            # the same engine called directly on the same lanes
            for name, s_, hs in (("CAS headline", spec, lanes),
                                 ("queue headline", q_spec, q_lanes)):
                eng = FailoverBackend(s_, build_backend(
                    s_, plan_search(s_, platform="cuda"), device=device))
                eng.check_histories(s_, hs[:SERVE_LANES])   # warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                v = np.asarray(eng.check_histories(s_, hs))
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                rec_a[name]["direct_s"] = dt
                rec_a[name]["direct_histories_per_s"] = len(hs) / dt
                rec_a[name]["direct_undecided"] = int(
                    (v == Verdict.BUDGET_EXCEEDED).sum())
                print(f"{tag} 20a the same engine called directly on "
                      f"{name}'s {len(hs)} lanes in one call: {dt:.3f} s = "
                      f"{len(hs) / dt:.1f} histories/s "
                      f"({rec_a[name]['direct_undecided']} undecided, "
                      f"unresolved) against "
                      f"{rec_a[name]['histories_per_s']:.1f} served",
                      flush=True)
            # a served shrink and a served session, on the card
            vio = [h for h, x in zip(corpus, cpp.check_histories(
                spec, corpus)) if x == Verdict.VIOLATION]
            with CheckClient(srv.address, timeout_s=600) as c:
                for h in vio[:4]:
                    t0 = time.perf_counter()
                    r = c.shrink("cas", h, certificate=True, deadline_s=600)
                    lat["shrink"].append(time.perf_counter() - t0)
                    require(r["ok"] and r["complete"], f"served shrink: {r}")
                stream = history_to_rows(vio[0])
                for rep in range(2):
                    sess = SessionHandle(c, "cas")
                    for i in range(0, len(stream), 8):
                        t0 = time.perf_counter()
                        sess.append(stream[i:i + 8])
                        lat["session"].append(time.perf_counter() - t0)
                    require(sess.close()["verdict"] == "VIOLATION",
                            "served session: the violation was not found")
            st = srv.stats()
            rec_a["latency_ms"] = {
                k: dict(n=len(v), p50=_pct(v, 0.5) * 1e3,
                        p99=_pct(v, 0.99) * 1e3)
                for k, v in lat.items() if v}
            print(f"{tag} 20a request latency by verb (client side): "
                  + "; ".join(f"{k} n={x['n']} p50 {x['p50']:.2f} ms p99 "
                              f"{x['p99']:.2f} ms"
                              for k, x in rec_a["latency_ms"].items())
                  + f"; server: {st['requests']} requests, "
                  f"{st['batcher']['batches']} flushes, mean occupancy "
                  f"{st['batcher']['mean_occupancy']}, padded lanes "
                  f"{st['padded_lanes']}, BUDGET resolved "
                  f"{st['budget_resolved']}, device errors "
                  f"{st['device_errors']}", flush=True)
        finally:
            srv.stop()
        # kv16 with pcomp=False: whole histories, the sweep regime
        srv = CheckServer(flush_s=0.005, max_lanes=SERVE_LANES, pcomp=False,
                          device=device).start()
        try:
            reset()
            before = served_paths(srv)
            with FirstInputs() as first:
                p = ServedPass(srv.address, "kv", kv_corpus, kv_kw)
            after = served_paths(srv)
            read("the server, kv16 whole (pcomp=False) (20a)", first,
                 kv_spec, need=("stepper_sweep",))
            off = int((p.verdicts != np.asarray(kv_want)).sum())
            require(off == 0, f"served kv16 whole: {off} verdicts off")
            rec_a["kv16 whole"] = dict(
                lanes=len(kv_corpus), seconds=p.seconds,
                histories_per_s=len(kv_corpus) / p.seconds,
                flushes=after["batches"] - before["batches"],
                budget_resolved=after["budget_resolved"]
                - before["budget_resolved"])
            print(f"{tag} 20a served kv16 whole (pcomp=False): "
                  f"{len(kv_corpus)} lanes, {p.seconds:.3f} s, "
                  f"{rec_a['kv16 whole']['flushes']} flushes, "
                  f"{rec_a['kv16 whole']['budget_resolved']} BUDGET lanes "
                  f"resolved by the host oracle; 0 verdicts off", flush=True)
        finally:
            srv.stop()
        # the CAS headline's unique histories through TorchGPU (dfs_chunk)
        srv = CheckServer(flush_s=0.005, max_lanes=SERVE_LANES,
                          engine_factory=lambda s: TorchGPU(s, device=device),
                          device=device).start()
        try:
            reset()
            with FirstInputs() as first:
                p = ServedPass(srv.address, "cas", corpus)
            read("the server over TorchGPU, CAS headline (20a)", first,
                 spec, need=("dfs_chunk",))
            off = int((p.verdicts != cpp.check_histories(spec, corpus)
                       ).sum())
            require(off == 0, f"served over TorchGPU: {off} verdicts off")
            st = srv.stats()
            rec_a["CAS over TorchGPU"] = dict(
                lanes=len(corpus), seconds=p.seconds,
                budget_resolved=st["budget_resolved"])
            print(f"{tag} 20a served over TorchGPU: {len(corpus)} lanes, "
                  f"{p.seconds:.3f} s, {st['budget_resolved']} BUDGET lanes "
                  f"resolved by the oracle; 0 verdicts off", flush=True)
        finally:
            srv.stop()
        # the CAS pass at a flush width of SERVE_WIDE, profiled
        srv = CheckServer(flush_s=0.005, max_lanes=SERVE_WIDE,
                          device=device).start()
        try:
            reset()
            box = {}
            with FirstInputs() as first:
                wall, dev_s, top = profile_device(
                    lambda: box.setdefault("p", ServedPass(
                        srv.address, "cas", lanes)))
            read(f"the server at max_lanes={SERVE_WIDE}, CAS headline "
                 f"(20a)", first, spec)
            p = box["p"]
            require((p.verdicts == np.asarray(want)).all(),
                    f"served at {SERVE_WIDE}: verdicts off")
            st = srv.stats()
            rec_a[f"CAS at {SERVE_WIDE}"] = dict(
                seconds=p.seconds, histories_per_s=len(lanes) / p.seconds,
                flushes=st["batcher"]["batches"],
                lanes_a_flush=st["batcher"]["lanes"]
                / max(1, st["batcher"]["batches"]),
                padded=st["padded_lanes"],
                idle_share=1 - dev_s / wall if wall else None,
                profiled_wall_s=wall, profiled_device_s=dev_s)
            r = rec_a[f"CAS at {SERVE_WIDE}"]
            print(f"{tag} 20a served CAS headline at max_lanes="
                  f"{SERVE_WIDE}: {p.seconds:.3f} s = "
                  f"{r['histories_per_s']:.1f} histories/s, {r['flushes']} "
                  f"flushes, {r['lanes_a_flush']:.2f} lanes a flush, "
                  f"{r['padded']} padded lanes; under the profiler "
                  f"{wall:.3f} s wall, {dev_s:.4f} s on the device, idle "
                  f"{r['idle_share']:.4f}; top {top}", flush=True)
        finally:
            srv.stop()
        record["a"] = rec_a
        print(f"{tag} 20a took {time.perf_counter() - t_a:.1f} s",
              flush=True)

        # (c) the card's rule in the server
        t_c = time.perf_counter()
        hs = lanes[:4 * SERVE_LANES]
        srv = CheckServer(flush_s=0.005, max_lanes=SERVE_LANES,
                          device=device).start()
        try:
            reset()
            # the rule fires on the 2nd dispatch and every later one: the
            # first request's batch runs on the card, the second's degrade
            with FaultEnv("raise:serve@2"), \
                    CheckClient(srv.address, timeout_s=120) as c:
                r1 = c.check("cas", hs[:SERVE_LANES])
                r2 = c.check("cas", hs[SERVE_LANES:2 * SERVE_LANES])
            read("the server under raise:serve@2 (20c)", None)
            st = srv.stats()
            got = [Verdict[v] for r in (r1, r2) for v in r["verdicts"]]
            n_deg = sum(bool(b.get("degraded")) for b in r2["batches"])
            require(r1["ok"] and r2["ok"]
                    and got == list(want[:2 * SERVE_LANES])
                    and not any(b.get("degraded") for b in r1["batches"])
                    and n_deg == len(r2["batches"])
                    == st["serve_faults"] and st["device_errors"] == 0,
                    f"raise:serve@2: serve_faults {st['serve_faults']}, "
                    f"{n_deg} of {len(r2['batches'])} batches degraded")
        finally:
            srv.stop()

        class _RealError:
            name = "card_error_stub"

            def __init__(self, s):
                self.device = torch.device("cuda", 0)
                self.calls = 0

            def check_histories(self, s, histories):
                self.calls += 1
                if torch.cuda.is_available():
                    torch.zeros(len(histories), device=self.device)
                raise RuntimeError("CUDA error: an illegal memory access "
                                   "was encountered (a stub)")

        stubs = []
        srv = CheckServer(flush_s=0.005, max_lanes=SERVE_LANES,
                          device=device,
                          engine_factory=lambda s: stubs.append(
                              _RealError(s)) or stubs[-1]).start()
        try:
            with CheckClient(srv.address, timeout_s=60) as c:
                bad = c.check("cas", hs[:SERVE_LANES])
            st = srv.stats()
            require(not bad["ok"] and bad["error"].startswith(
                "RuntimeError: CUDA error") and st["device_errors"] == 1
                and st["budget_resolved"] == 0
                and st["cache"]["entries"] == 0,
                f"the card's rule: {bad} {st['device_errors']}")
        finally:
            srv.stop()
        record["c"] = dict(injected_serve_faults=n_deg,
                           real_error=bad["error"][:80])
        print(f"{tag} 20c under raise:serve@2 the second request's "
              f"{n_deg} batch(es) degraded to the host ladder, the first's "
              f"ran on the card, verdicts exact, serve_faults {n_deg}; a real "
              f"(non-injected) RuntimeError of an engine on the card "
              f"answered ok: false ({bad['error'][:60]}...), counted in "
              f"device_errors, nothing decided on the host or banked; (c) "
              f"took {time.perf_counter() - t_c:.1f} s", flush=True)

        # (b) the server as users start it
        t_b = time.perf_counter()
        b1 = banner(server_proc, "serve")
        addr1 = b1["serving"]
        req = tmp / "req.json"
        req.write_text(json.dumps({"model": "cas", "histories": [
            history_to_rows(h) for h in corpus[:SERVE_LANES]]}))
        submit = cli_proc("submit", "--addr", addr1, "--trace", req)
        rc_h, out_h = cli_inproc("health", "--addr", addr1)
        require(rc_h == 0 and json.loads(out_h[-1])["status"] == "ok",
                f"health: rc {rc_h} {out_h[-1:]}")
        rc_s, out_s = cli_result(submit, "submit")
        sub = json.loads(out_s[-1])
        n_vio = sum(v == "VIOLATION" for v in sub["verdicts"])
        require(rc_s == (1 if n_vio else 0) and sub["ok"]
                and [Verdict[v] for v in sub["verdicts"]]
                == cpp.check_histories(spec, corpus[:SERVE_LANES]).tolist(),
                f"submit: rc {rc_s}")
        rc_w, out_w = cli_inproc("stats", "--serve", addr1, "--watch",
                                 "--watch-count", 1)
        frame = "\n".join(out_w)
        vals = obs.parse_exposition(urllib.request.urlopen(
            f"http://{b1['metrics']}/metrics", timeout=30).read().decode())
        m = re.search(r"requests (\d+)\s+histories (\d+)", frame)
        require(rc_w == 0 and m is not None
                and int(m.group(1)) == vals["qsm_serve_requests_total"]
                and int(m.group(2)) == vals["qsm_serve_histories_total"],
                f"stats --watch against /metrics: {m and m.groups()} "
                f"{vals.get('qsm_serve_requests_total')}")
        # shrink --addr: equal to the in-process planned shrink
        vio0 = vio[0]
        shr = tmp / "shrink.json"
        shr.write_text(json.dumps({"model": "cas",
                                   "history": history_to_rows(vio0)}))
        t0 = time.perf_counter()
        rc_k, out_k = cli_inproc("shrink", "--trace", shr, "--addr", addr1,
                                 "--certificate")
        t_shrink = time.perf_counter() - t0
        sk = json.loads(out_k[-1])
        plan = plan_search(spec, profile_corpus([vio0], spec),
                           platform="cuda")
        t0 = time.perf_counter()
        inproc = shrink_history(spec, vio0, backend=build_backend(
            spec, plan, device=device), certificate=False)
        t_inproc = time.perf_counter() - t0
        require(rc_k == 0 and sk["one_minimal"] and sk["history"]
                == history_to_rows(inproc.history)
                and sk["rounds"] == inproc.rounds
                and verify_certificate(spec, history_from_rows(
                    sk["history"]), sk["certificate"])["one_minimal_proved"],
                f"shrink --addr: rc {rc_k}, {sk.get('final_ops')} ops "
                f"against {inproc.final_ops}")
        # monitor --addr: phase 19's seeded Jepsen log, and a stream an
        # eighth as long
        reg_spec, _ = make_model("register", "atomic")
        flips = {}
        for label, events in (("phase 19's log", STREAM_EVENTS),
                              ("a short stream", STREAM_EVENTS // 8)):
            seeded = seeded_stream(monitor_stream_rows(events // 2))
            edn = tmp / f"stream_{events}.edn"
            edn.write_text(emit_trace("jepsen", canonical_rows(seeded),
                                      "register", reg_spec))
            argv = ("monitor", edn, "--format", "jepsen", "--spec",
                    "register")
            t0 = time.perf_counter()
            rc_m, out_m = cli_inproc(*argv, "--addr", addr1)
            t_mon = time.perf_counter() - t0
            served = [json.loads(x) for x in out_m]
            fl = next(x for x in served if x.get("event") == "session.flip")
            require(rc_m == 1 and served[-1]["verdict"] == "VIOLATION",
                    f"monitor --addr {label}: rc {rc_m}")
            if events == STREAM_EVENTS:
                # the reference's server answers a flip whose window is
                # past the largest op bucket (128) unminimised: its input
                # check is undecided (bucket_for raises in the dispatch)
                want_flip = ((mon_rec or {}).get("monitor_cli")
                             or {}).get("flip")
                require(fl["initial_ops"] > 128
                        and fl["final_ops"] == fl["initial_ops"]
                        and (want_flip is None or fl["initial_ops"]
                             == want_flip["initial_ops"]),
                        f"monitor --addr {label}: the flip {fl['initial_ops']}"
                        f" -> {fl['final_ops']} ({fl.get('why')})")
            else:
                rc_l, out_l = cli_inproc(*argv, *dev_args)
                local = next(json.loads(x) for x in out_l
                             if json.loads(x).get("event") == "session.flip")
                require(rc_l == 1 and fl["one_minimal"]
                        and fl["repro"] == local["repro"]
                        and fl["final_ops"] == local["final_ops"] == 1
                        and verify_certificate(reg_spec, history_from_rows(
                            fl["repro"]), fl["certificate"])[
                                "one_minimal_proved"],
                        f"monitor --addr {label}: the flip "
                        f"{fl['initial_ops']} -> {fl['final_ops']} against "
                        f"{local['initial_ops']} -> {local['final_ops']} in "
                        f"process")
            flips[label] = dict(initial_ops=fl["initial_ops"],
                                final_ops=fl["final_ops"],
                                one_minimal=fl["one_minimal"], seconds=t_mon)
        # ingest --submit, trace --addr, fuzz --addr
        data = REPO / "tests" / "data"
        rc_i, out_i = cli_inproc("ingest", data / "golden_porcupine_kv.edn",
                                 "--format", "porcupine", "--spec", "kv",
                                 "--submit", addr1)
        require(rc_i == 1 and json.loads(out_i[-1])["verdicts"]
                == ["VIOLATION"], f"ingest --submit: rc {rc_i}")
        rc_t, out_t = cli_inproc("trace", sub["trace"], "--addr", addr1)
        require(rc_t == 0 and any("request" in x for x in out_t),
                f"trace --addr: rc {rc_t} {out_t[:2]}")
        reset()
        t0 = time.perf_counter()
        rc_f, out_f = cli_inproc("fuzz", "--addr", addr1, "--models",
                                 "cas,queue", "--rounds", FUZZ_ROUNDS,
                                 "--seed", 20, *dev_args)
        t_fuzz = time.perf_counter() - t0
        fz = json.loads(out_f[-1])
        read("fuzz --addr (20b)", None, need=("threefry_draws",))
        require(rc_f == 0 and fz["wrong_verdicts_total"] == 0
                and fz["exit_code"] == 0,
                f"fuzz --addr: rc {rc_f}, wrong "
                f"{fz.get('wrong_verdicts_total')}")
        with CheckClient(addr1, timeout_s=60) as c:
            st1 = c.stats()["stats"]
        stop_server(server_proc, addr1, "serve")
        addr1 = None
        record["b"] = dict(
            submit_rc=rc_s, shrink_s=t_shrink, shrink_inproc_s=t_inproc,
            shrink=dict(initial_ops=sk["initial_ops"],
                        final_ops=sk["final_ops"], rounds=sk["rounds"]),
            monitor=flips,
            fuzz_s=t_fuzz, fuzz_seqs=fz["seqs_total"],
            fuzz_flips=fz["flips_total"],
            server_requests=st1["requests"], banked=st1["cache"]["entries"])
        print(f"{tag} 20b python -m qsm_tpu_torch serve (banner "
              f"{json.dumps(b1)}): submit rc {rc_s} ({n_vio} violations, "
              f"equal to CppOracle); health rc 0; stats --watch totals = "
              f"/metrics ({m.group(1)} requests, {m.group(2)} histories); "
              f"shrink --addr {sk['initial_ops']} -> {sk['final_ops']} ops "
              f"in {sk['rounds']} rounds, 1-minimal, certificate verified, "
              f"equal to the in-process planned shrink ({t_shrink:.3f} s "
              f"served, {t_inproc:.3f} s in process); monitor --addr: "
              + "; ".join(f"{k} flip {v['initial_ops']} -> "
                          f"{v['final_ops']} ops ({v['seconds']:.1f} s)"
                          for k, v in flips.items())
              + " (over 128 ops the served flip stays unminimised, as the "
              f"reference's server leaves it; the short stream's equals "
              f"the in-process monitor's); ingest --submit rc 1; trace "
              f"--addr rc 0 ({len(out_t)} lines); fuzz --addr cas,queue "
              f"{FUZZ_ROUNDS} rounds: {fz['seqs_total']} histories, "
              f"{fz['flips_total']} flips, 0 wrong verdicts, exit 0 "
              f"({t_fuzz:.1f} s); the server banked {st1['cache']['entries']}"
              f" verdicts in {d1.name}/", flush=True)

        # (d) the device-work queue: one queue on D2, four seams, a drain
        t_d = time.perf_counter()
        srv = CheckServer(flush_s=0.005, max_lanes=SERVE_LANES,
                          devq_dir=str(d2), device=device).start()
        try:
            q = srv.devq
            require(global_devq() is q, "the server did not install its "
                    "queue")
            # the admission seam (an oversize corpus) and, at the engine's
            # first build, the planner's warmup
            with CheckClient(srv.address, timeout_s=120) as c:
                require(c.check("queue", q_corpus[:SERVE_LANES])["ok"],
                        "devq: the oversize check failed")
            # a shrink round at a small budget leaves its frontier
            # undecided: the input decided at the default budget, the
            # rounds at DRAIN_BUDGET iterations
            engines = [TorchStepper(spec, device=device),
                       TorchStepper(spec, budget=DRAIN_BUDGET, mid_budget=0,
                                    rescue_budget=0, device=device)]

            class _Starved:
                calls = 0

                def check_histories(self, s_, hs_):
                    eng = engines[min(self.calls, 1)]
                    self.calls += 1
                    return eng.check_histories(s_, hs_)

            # the longest violation: its linearizable candidates need
            # more than DRAIN_BUDGET iterations
            res = shrink_history(spec, max(vio, key=len),
                                 backend=_Starved(), certificate=False)
            require(res.ok, f"devq: the starved shrink: {res.why}")
            # a monitor flip's re-check
            s = MonitorSession("devq", spec, device=device)
            v, _, _ = stream_into(s, history_to_rows(vio[2]), 4)
            require(v == Verdict.VIOLATION, "devq: no flip")
            planes = q.snapshot()["pending_by_plane"]
            # the planner's warm-up comes of a plan for the card
            require(set(planes) == {"check", "shrink", "monitor"} | (
                {"warmup"} if device is None else set()),
                f"devq: banked planes {planes}")
            items = q.pending_items()
            docs = [it.to_doc() for it in items]
            bank = VerdictCache(max_entries=65_536)
            journal = str(tmp / "drain_journal.jsonl")
            reset()
            with FirstInputs() as first:
                rep = DrainScheduler(q, cache=bank, window_s=DRAIN_WINDOW_S,
                                     journal_path=journal, window_id="w20",
                                     devices=None if device is None
                                     else [device]).drain()
            read("the drain (20d)", first, spec)
            require(rep["wrong_verdicts"] == 0 and rep["key_mismatches"] == 0
                    and rep["drained"] == len(items)
                    and not rep["deadline_stopped"],
                    f"drain: {json.dumps(rep)[:400]}")
            n_keys = 0
            for it in items:
                for key in it.lane_keys or []:
                    require(bank.get(key) is not None,
                            f"drain: {it.plane} lane not banked under "
                            f"its key")
                    n_keys += 1
            q2 = DeviceWorkQueue()
            for doc in docs:
                q2.put_doc(dict(doc))
            rep2 = DrainScheduler(q2, window_s=DRAIN_WINDOW_S,
                                  journal_path=journal, window_id="w20",
                                  resume=True,
                                  devices=None if device is None
                                  else [device]).drain()
            require(rep2["dispatched"] == [] and sorted(rep2["resumed"])
                    == sorted(rep["dispatched"]),
                    f"the second drain re-dispatched {rep2['dispatched']}")
        finally:
            srv.stop()
        require(global_devq() is None, "the queue outlived its server")
        record["d"] = dict(planes=planes, drained=rep["drained"],
                           banked_rows=rep["banked_rows"],
                           window_utilization=rep["window_utilization"],
                           elapsed_s=rep["elapsed_s"], busy_s=rep["busy_s"],
                           per_plane={k: {x: v[x] for x in (
                               "items", "lanes", "device_items",
                               "host_items", "device_s", "host_s")}
                               for k, v in rep["per_plane"].items()
                               if v["items"]})
        print(f"{tag} 20d one DeviceWorkQueue on {d2.name}/: banked "
              f"{planes}; DrainScheduler on the card, a {DRAIN_WINDOW_S:.0f}"
              f" s deadline: {rep['drained']} items, {rep['banked_rows']} "
              f"rows banked under their originating keys ({n_keys} lane "
              f"keys checked), 0 wrong verdicts, window_utilization "
              f"{rep['window_utilization']} ({rep['busy_s']} of "
              f"{rep['elapsed_s']} s); per plane "
              f"{json.dumps(record['d']['per_plane'])}; a second drain on "
              f"the journal re-dispatched 0 of {len(items)}; (d) took "
              f"{time.perf_counter() - t_d:.1f} s", flush=True)

        # (b) again: the restarted server serves the banked verdicts, and
        # takes (d)'s report
        t_r = time.perf_counter()
        proc2 = cli_proc(*serve_argv)
        b2 = banner(proc2, "serve (restart)")
        addr2 = b2["serving"]
        with CheckClient(addr2, timeout_s=120) as c:
            again = c.check("cas", corpus[:SERVE_LANES])
            require(again["ok"] and all(again["cached"]),
                    f"restart: {sum(again['cached'])} of "
                    f"{len(again['cached'])} cached")
            rows = [[k, e.verdict, None] for k, e in bank._od.items()]
            ack = c.devq_drain_report(
                report={k: rep[k] for k in ("window_id", "drained",
                                            "window_utilization")},
                rows=rows, done=rep["dispatched"])
            h2 = c.health()
        util = h2["devq"]["window_utilization"]
        require(ack["ok"] and ack["pending"] == 0 and util["samples"] == 1
                and util["value"] == rep["window_utilization"],
                f"drain_report / health: {ack} {util}")
        stop_server(proc2, addr2, "serve (restart)")
        addr2 = None
        print(f"{tag} 20b restarted on the same --replog-dir: "
              f"{len(again['cached'])} of {len(again['cached'])} lanes "
              f"cached; 20d devq.drain_report to it: {len(rows)} rows, "
              f"{ack['done'] if 'done' in ack else len(rep['dispatched'])} "
              f"done, pending {ack['pending']}; its health carries "
              f"window_utilization {util['value']} ({util['status']}); "
              f"{time.perf_counter() - t_r:.1f} s", flush=True)
    finally:
        for proc, addr, what in ((server_proc, addr1, "serve"),
                                 (proc2, addr2, "serve (restart)")):
            if proc is not None and proc.poll() is None:
                try:
                    stop_server(proc, addr, what)
                except RuntimeError:
                    pass
        set_global_devq(None)
    total = {c.__name__: sum(x[c.__name__] for x in launches.values())
             for c in counters}
    dt = time.perf_counter() - t_phase
    record["seconds"] = dt
    print(f"{tag} phase 20 record: {json.dumps(record)}", flush=True)
    print(f"{tag} phase 20 launches: " + ", ".join(
        f"{n} {k}" for k, n in total.items()) + f"; {dt:.1f} s", flush=True)
    return launches, err, record


FLEET_TTL_S = 1.0              # (c): the routers' lease TTL
# (d): the soak's sessions, cut from its default of 1000 to keep the run
# within its time (1000 sessions took 160.5 s of phase 21's time on the
# card; PERF.md)
FLEET_SOAK_SESSIONS = 256
FLEET_WAIT_S = 120.0           # (c), (d): bound of every wait on a condition


def _fleet_paths(nodes):
    """The nodes' flush accounting so far, summed (a pass reads it before
    and after)."""
    out = {}
    for srv in nodes:
        for k, v in served_paths(srv).items():
            out[k] = out.get(k, 0) + v
    return out


def _wait_until(cond, what, timeout_s=FLEET_WAIT_S, step_s=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(step_s)
    raise RuntimeError(f"chip_smoke: {what} within {timeout_s:.0f} s")


def phase_fleet(spec, corpus, q_spec, q_corpus, kv_spec, kv_corpus,
                serve_rec, tag, device=None):
    """Phase 21: the fleet tier on the card; see the module docstring.
    Returns (launches of each path, largest error of the kernels held on
    the paths, the record).  ``device`` is the nodes' and routers' (the
    card when None)."""
    import tempfile

    from qsm_tpu_torch.fleet import FleetRouter
    from qsm_tpu_torch.serve import CheckClient, CheckServer, SessionHandle
    from qsm_tpu_torch.serve.cache import fingerprint_key

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p21_"))
    dev_args = [] if device is None else ["--device", str(device)]
    counters = (stepper_chunk, compact_carry, stepper_sweep, dfs_chunk,
                threefry_draws)
    launches, err, record = {}, 0, {}
    kv_kw = kv_spec.spec_kwargs()
    ids = ("n0", "n1")

    def reset():
        for c in counters:
            c.launches = 0

    def read(name, first, path_spec=None, need=("stepper_chunk",)):
        nonlocal err
        got = {c.__name__: c.launches for c in counters}
        print(f"{tag} path of {name}: " + ", ".join(
            f"{n} {k}" for k, n in got.items()) + " launches", flush=True)
        for k in need:
            require(got[k] > 0, f"{name} launched no {k}")
        launches[name] = got
        if first is not None:
            err = max(err, hold_path_kernels(name, first, tag, path_spec))

    def node(i, replog, **kw):
        return CheckServer(node_id=ids[i], replog_dir=str(replog),
                           flush_s=0.005, max_lanes=SERVE_LANES,
                           queue_depth=SERVE_DEPTH,
                           cache_entries=SERVE_CACHE, device=device,
                           **kw).start()

    def stamped(p, what):
        """Every lane of every routed answer stamped with the node that
        decided it; the nodes that decided lanes."""
        used = set()
        for d, n in zip(p.docs, (len(x) for x in p.reqs)):
            require(sum(d["nodes"].values()) == n,
                    f"{what}: {n} lanes, stamps {d['nodes']}")
            used |= set(d["nodes"])
            for b in d["batches"]:
                require(b.get("node") in d["nodes"],
                        f"{what}: a batch stamped {b.get('node')!r}")
        return used

    cpp = native.CppOracle(spec)
    lanes = _replicate(corpus, DEVICE_BATCH)
    q_lanes = _replicate(q_corpus, DEVICE_BATCH)
    want = np.asarray(cpp.check_histories(spec, lanes))
    q_want = np.asarray(native.CppOracle(q_spec).check_histories(
        q_spec, q_lanes))
    kv_want = np.asarray(PComp(kv_spec).check_histories(kv_spec,
                                                         kv_corpus))
    replogs = [tmp / f"replog{i}" for i in range(2)]
    nodes, routers, procs = [], [], []
    try:
        # (a) two nodes and a router in this process, on the card
        t_a = time.perf_counter()
        rec_a = {}
        nodes = [node(i, replogs[i]) for i in range(2)]
        t0 = time.perf_counter()
        for srv in nodes:
            for model, kw in (("cas", None), ("queue", None),
                              ("kv", kv_kw), ("register", None)):
                srv.warm(model, kw)
        torch.cuda.synchronize()
        rec_a["warm_s"] = time.perf_counter() - t0
        router = FleetRouter([(s.node_id, s.address) for s in nodes],
                             anti_entropy_s=0.0, queue_depth=SERVE_DEPTH,
                             device=device).start()
        routers.append(router)
        for name, model, s_, hs, w, kw in (
                ("CAS headline", "cas", spec, lanes, want, None),
                ("queue headline", "queue", q_spec, q_lanes, q_want, None),
                ("kv16 per key", "kv", kv_spec, kv_corpus, kv_want,
                 kv_kw)):
            reset()
            before = _fleet_paths(nodes)
            box = {}
            with FirstInputs() as first:
                if model == "queue":
                    # the idle share of a routed pass (the other passes
                    # run without the profiler)
                    wall, dev_s, top = profile_device(
                        lambda: box.setdefault("p", ServedPass(
                            router.address, model, hs, kw)))
                else:
                    box["p"] = ServedPass(router.address, model, hs, kw)
            p = box["p"]
            after = _fleet_paths(nodes)
            read(f"the fleet, {name} (21a)", first, s_)
            off = int((p.verdicts != w).sum())
            require(off == 0, f"routed {name}: {off} verdicts off "
                    f"CppOracle's")
            used = stamped(p, f"routed {name}")
            require(used == set(ids), f"routed {name}: only {used} "
                    f"decided lanes")
            flushes = after["batches"] - before["batches"]
            single = serve_rec["a"].get(name, {})
            r = rec_a[name] = dict(
                lanes=len(hs), requests=len(p.docs), seconds=p.seconds,
                histories_per_s=len(hs) / p.seconds, flushes=flushes,
                lanes_a_flush=(after["lanes"] - before["lanes"])
                / max(flushes, 1),
                by_node={n: sum(d["nodes"].get(n, 0) for d in p.docs)
                         for n in ids},
                single_server_histories_per_s=single.get(
                    "histories_per_s"),
                direct_histories_per_s=single.get(
                    "direct_histories_per_s"),
                p50_ms=_pct(p.latency, 0.5) * 1e3,
                p99_ms=_pct(p.latency, 0.99) * 1e3)
            if model == "queue":
                r.update(idle_share=1 - dev_s / wall if wall else None,
                         profiled_wall_s=wall, profiled_device_s=dev_s,
                         under_profiler=True)
            print(f"{tag} 21a routed {name}: {r['lanes']} lanes in "
                  f"{r['requests']} requests of {SERVE_LANES} from "
                  f"{SERVE_CLIENTS} clients through the router to 2 nodes "
                  f"({r['by_node']}), {r['seconds']:.3f} s = "
                  f"{r['histories_per_s']:.1f} histories/s"
                  + (" (under the profiler)" if model == "queue" else "")
                  + f" against {r['single_server_histories_per_s']} from "
                  f"phase 20's single server and "
                  f"{r['direct_histories_per_s']} from the engine called "
                  f"directly; {flushes} flushes, {r['lanes_a_flush']:.2f} "
                  f"lanes a flush; p50 {r['p50_ms']:.2f} ms, p99 "
                  f"{r['p99_ms']:.2f} ms; every lane stamped, 0 verdicts "
                  f"off CppOracle's"
                  + (f"; idle {r['idle_share']:.4f} ({wall:.3f} s wall, "
                     f"{dev_s:.4f} s on the device; top {top})"
                     if model == "queue" else ""), flush=True)
        st = router.stats()
        require(st["ladder_lanes"] == 0 and st["device_errors"] == 0
                and not router._ladders,
                f"21a: the router decided lanes itself: {st['ladder_lanes']}")
        record["a"] = rec_a
        print(f"{tag} 21a took {time.perf_counter() - t_a:.1f} s; the "
              f"router built no ladder", flush=True)

        # (b) node loss mid-burst, then no node at all
        t_b = time.perf_counter()
        key_owner = [router.membership.node_for(fingerprint_key(spec, h))
                     for h in lanes]
        victim = max(ids, key=key_owner.count)
        vi = ids.index(victim)
        # the same burst with both nodes alive, on the caches (a) warmed:
        # the baseline that the burst with a node stopped is held against
        warm = ServedPass(router.address, "cas", lanes)
        require((warm.verdicts == want).all(), "21b warm burst: verdicts")
        st0 = router.stats()
        reset()
        # the victim's server stops at the router's third dispatch to it:
        # mid-burst, whatever the burst's pace, its socket gone before the
        # dispatch goes out
        link, box = router.links[victim], {}
        real_request = link.request

        def request(doc, timeout_s):
            if doc.get("op") == "check":
                box["calls"] = box.get("calls", 0) + 1
                if box["calls"] == 3:
                    box["t_kill"] = time.perf_counter()
                    nodes[vi].stop()
            return real_request(doc, timeout_s)

        link.request = request
        try:
            box["p"] = ServedPass(router.address, "cas", lanes)
        finally:
            link.request = real_request
        require("t_kill" in box, "21b: the burst never reached the victim")
        t_kill = box["t_kill"]
        p = box["p"]
        st1 = router.stats()
        read(f"the fleet, CAS burst with {victim} stopped (21b)", None)
        require((p.verdicts == want).all(), "21b: verdicts off (a)'s")
        survivor = ids[1 - vi]
        late = [d for d in p.docs if victim not in d["nodes"]]
        redis = st1["redispatches"] - st0["redispatches"]
        faults = st1["node_faults"] - st0["node_faults"]
        require(redis > 0 and faults > 0,
                f"21b: no lane re-dispatched ({redis}, {faults})")
        require(st1["ladder_lanes"] == 0, "21b: the survivor's lanes "
                "reached the ladder")
        rec_b = dict(victim=victim, seconds=p.seconds,
                     after_kill_s=time.perf_counter() - t_kill,
                     warm_burst_s=warm.seconds,
                     node_loss_s=p.seconds - warm.seconds,
                     redispatches=redis, node_faults=faults,
                     requests_on_survivor_only=len(late))
        print(f"{tag} 21b {victim} stopped mid-burst: the burst "
              f"{p.seconds:.3f} s ({rec_b['after_kill_s']:.3f} s after the "
              f"stop) against {warm.seconds:.3f} s for the same burst on "
              f"the same warm caches with both nodes alive: the node loss "
              f"cost {rec_b['node_loss_s']:.3f} s; {redis} re-dispatches, "
              f"{faults} node faults, {len(late)} requests decided on "
              f"{survivor} alone; verdicts equal (a)'s", flush=True)
        nodes[1 - vi].stop()
        for link in router.links.values():
            link.close_all()
        reset()
        with FirstInputs() as first:
            p = ServedPass(router.address, "cas", lanes)
        read("the router's ladder, every node gone (21b)", first, spec)
        require((p.verdicts == want).all(), "21b ladder: verdicts off")
        require(all(d["nodes"] == {"router": len(x)}
                    for d, x in zip(p.docs, p.reqs)),
                "21b ladder: a lane not decided by the router")
        (entry,) = router._ladders.values()
        require(device is not None
                or type(entry[1]).__name__ == "FailoverBackend",
                "21b: the ladder is not the planned checker")
        rec_b["ladder"] = dict(seconds=p.seconds,
                               histories_per_s=len(lanes) / p.seconds,
                               ladder_batches=router.stats()[
                                   "ladder_batches"])
        print(f"{tag} 21b the router's ladder on the card, no node alive: "
              f"{len(lanes)} lanes in {p.seconds:.3f} s = "
              f"{len(lanes) / p.seconds:.1f} histories/s, "
              f"{rec_b['ladder']['ladder_batches']} ladder batches "
              f"(FailoverBackend over the planned checker), "
              f"{router.ladder_resolved} BUDGET lanes resolved", flush=True)
        vio = [h for h, x in zip(corpus, cpp.check_histories(spec, corpus))
               if x == Verdict.VIOLATION]
        reset()
        with CheckClient(router.address, timeout_s=600) as c:
            t0 = time.perf_counter()
            r = c.shrink("cas", vio[0], deadline_s=600)
            shrink_s = time.perf_counter() - t0
            require(r["ok"] and r["verdict"] == "VIOLATION"
                    and r["node"] == router.node_id
                    and r["final_ops"] < r["initial_ops"],
                    f"21b ladder shrink: {json.dumps(r)[:300]}")
            stream = history_to_rows(vio[0])
            t0 = time.perf_counter()
            sess = SessionHandle(c, "cas")
            for i in range(0, len(stream), 8):
                out = sess.append(stream[i:i + 8])
                require(out.get("ok") and out.get("ladder"),
                        f"21b ladder session: {json.dumps(out)[:300]}")
            fin = sess.close()
            session_s = time.perf_counter() - t0
            require(fin["verdict"] == "VIOLATION" and fin.get("ladder"),
                    f"21b ladder session close: {json.dumps(fin)[:300]}")
        read("the router's ladder, shrink and a session (21b)", None)
        rec_b["ladder"].update(shrink_s=shrink_s,
                               shrink_ops=[r["initial_ops"],
                                           r["final_ops"]],
                               session_s=session_s)
        print(f"{tag} 21b with no node alive: a shrink on the router's "
              f"ladder {shrink_s:.3f} s ({r['initial_ops']} -> "
              f"{r['final_ops']} ops), a session of {len(stream)} events "
              f"on its session rung {session_s:.3f} s (VIOLATION)",
              flush=True)
        # (d)'s soak starts here and runs beside the rest of (b), (c)
        # and (d)'s fleet: its processes spend most of their time starting
        # on the card; (a)'s rates, (b)'s node loss, ladder, shrink and
        # session are timed before it
        t_soak = time.perf_counter()
        soak = cli_proc("soak", "--sessions", FLEET_SOAK_SESSIONS,
                        *dev_args)
        procs.append(soak)
        # a routed corpus whose lanes the ladder's planned checker leaves
        # undecided: the queue headline's unique histories on a queue
        # ladder built at DRAIN_BUDGET iterations with no mid or rescue
        # budget.  Its BUDGET lanes are decided again on the exact host
        # checker, as the server resolves its own.
        import qsm_tpu_torch.search.planner as planner

        real_build = planner.build_backend
        planner.build_backend = functools.partial(
            real_build, budget=DRAIN_BUDGET, mid_budget=0, rescue_budget=0)
        try:
            resolved0 = router.ladder_resolved
            reset()
            p = ServedPass(router.address, "queue", q_corpus)
        finally:
            planner.build_backend = real_build
        read("the router's ladder at a starved budget, queue (21b)", None)
        q_unique = np.asarray(native.CppOracle(q_spec).check_histories(
            q_spec, q_corpus))
        starved = router.ladder_resolved - resolved0
        require((p.verdicts == q_unique).all(),
                "21b starved ladder: verdicts off CppOracle's")
        require(starved > 0, "21b starved ladder: no BUDGET lane")
        rec_b["ladder"].update(starved_lanes=len(q_corpus),
                               starved_resolved=starved,
                               starved_s=p.seconds)
        print(f"{tag} 21b (beside the soak) the router's queue ladder at "
              f"budget {DRAIN_BUDGET} (no mid or rescue budget): "
              f"{len(q_corpus)} lanes in {p.seconds:.3f} s, {starved} BUDGET "
              f"lanes decided again on the exact host checker; 0 verdicts "
              f"off CppOracle's", flush=True)
        router.stop()
        record["b"] = rec_b
        print(f"{tag} 21b took {time.perf_counter() - t_b:.1f} s",
              flush=True)

        # (c) two routers on one lease; gossip with no router alive
        t_c = time.perf_counter()
        nodes = [node(i, replogs[i]) for i in range(2)]
        lease = str(tmp / "lease.json")
        ra, rb = (FleetRouter([(s.node_id, s.address) for s in nodes],
                              node_id=rid, lease_path=lease,
                              lease_ttl_s=FLEET_TTL_S, anti_entropy_s=0.0,
                              queue_depth=SERVE_DEPTH,
                              device=device).start()
                  for rid in ("rA", "rB"))
        routers += [ra, rb]
        require(ra.ha_role == "active" and rb.ha_role == "standby",
                f"21c roles {ra.ha_role} / {rb.ha_role}")
        # rA goes down without releasing its lease, as a SIGKILL would
        ra.lease = None
        t0 = time.perf_counter()
        ra.stop()
        _wait_until(lambda: rb.ha_role == "active",
                    "21c: the standby took no term")
        takeover_s = time.perf_counter() - t0
        reset()
        p = ServedPass(f"{ra.address},{rb.address}", "cas", lanes)
        require((p.verdicts == want).all() and all(
            d.get("term") == rb.term and d.get("node") == "rB"
            for d in p.docs), "21c: the client on A,B got other verdicts")
        read("the fleet behind the standby after the takeover (21c)", None,
             need=())
        rec_c = dict(takeover_s=takeover_s, ttl_s=FLEET_TTL_S,
                     term=rb.term, seconds=p.seconds,
                     cached=sum(p.cached), beside_soak=True)
        print(f"{tag} 21c (beside the soak) two routers on one lease (TTL "
              f"{FLEET_TTL_S} s): "
              f"rA down without releasing, rB active under term {rb.term} "
              f"after {takeover_s:.3f} s; a client on A,B: {len(lanes)} "
              f"lanes in {p.seconds:.3f} s, bit-identical to (a)'s, "
              f"{rec_c['cached']} cached (the nodes reloaded their "
              f"replogs)", flush=True)
        rb.stop()
        for srv in nodes:
            srv.stop()
        # gossip: two nodes on unix sockets named up front, each the
        # other's peer; each decides half the unique corpus, and their
        # replogs converge node to node
        socks = [str(tmp / f"g{i}.sock") for i in range(2)]
        nodes = [node(i, tmp / f"gossip{i}", unix_path=socks[i],
                      peers=[[ids[1 - i], socks[1 - i]]], gossip_s=0.2,
                      replog_seal_rows=1) for i in range(2)]
        reset()
        half = len(corpus) // 2
        for i, part in enumerate((corpus[:half], corpus[half:])):
            with CheckClient(socks[i], timeout_s=600) as c:
                d = c.check("cas", part, deadline_s=600)
                require(d["ok"], f"21c gossip node {i}: {d}")
        read("two gossiping nodes (21c)", None)
        for s in nodes:
            s.cache.flush()
        keys = [fingerprint_key(spec, h) for h in corpus]
        t0 = time.perf_counter()
        _wait_until(lambda: all(s.cache.get(k) is not None
                                for s in nodes for k in keys),
                    "21c: gossip did not converge", step_s=0.1)
        converge_s = time.perf_counter() - t0
        gst = [s.stats()["gossip"] for s in nodes]
        rec_c["gossip"] = dict(
            converge_s=converge_s, rows=len(keys),
            pulled=[g["segments_pulled"] for g in gst],
            pushed=[g["segments_pushed"] for g in gst],
            sweeps=[g["sweeps"] for g in gst])
        for i, s in enumerate(nodes):
            for k, v in zip(keys, cpp.check_histories(spec, corpus)):
                require(s.cache.get(k).verdict == int(v),
                        f"21c gossip: node {i} banked another verdict")
        print(f"{tag} 21c (beside the soak) gossip with no router alive: "
              f"{len(keys)} rows "
              f"on both nodes {converge_s:.3f} s after the last request "
              f"(beat 0.2 s, segments of 1 row); segments pulled "
              f"{rec_c['gossip']['pulled']}, pushed "
              f"{rec_c['gossip']['pushed']} in "
              f"{rec_c['gossip']['sweeps']} sweeps; every banked verdict "
              f"CppOracle's", flush=True)
        for srv in nodes:
            srv.stop()
        nodes = []
        record["c"] = rec_c
        print(f"{tag} 21c took {time.perf_counter() - t_c:.1f} s",
              flush=True)

        # (d) the CLI: `fleet --nodes 2` (spawned nodes on the card),
        # submit / stats --fleet / health through its router; the soak
        t_d = time.perf_counter()
        rec_d = {}
        fleet = cli_proc("fleet", "--nodes", 2, "--port", 0, "--warm",
                         "cas", "--anti-entropy-s", 0, "--replog-root",
                         tmp / "cli", *dev_args)
        procs.append(fleet)
        line = fleet.stdout.readline()
        require(line.startswith("{"), f"fleet: no banner {line!r} "
                f"{fleet.stderr.read()[-600:] if fleet.poll() is not None else ''}")
        banner = json.loads(line)
        addr = banner["fleet"]
        rec_d["fleet_up_s"] = time.perf_counter() - t_d
        trace = tmp / "cas_trace.json"
        trace.write_text(json.dumps({"model": "cas", "histories": [
            history_to_rows(h) for h in corpus]}))
        t0 = time.perf_counter()
        rc, out = cli_inproc("submit", "--addr", addr, "--trace", trace)
        rec_d["submit_s"] = time.perf_counter() - t0
        res = json.loads(out[-1])
        require(rc == 1 and res["ok"] and [Verdict[v] for v in
                                           res["verdicts"]]
                == list(cpp.check_histories(spec, corpus)),
                f"submit --addr ROUTER: rc {rc}")
        require(set(res["nodes"]) == {"n0", "n1"},
                f"submit: decided by {res['nodes']}")
        rc, text = cli_inproc("stats", "--serve", addr, "--fleet")
        rows = [x for x in text if x.strip().startswith(("n0 ", "n1 "))]
        require(rc == 0 and len(rows) == 2 and all(
            "[up]" in x and "device cuda" in x for x in rows)
            if device is None else rc == 0 and len(rows) == 2,
            f"stats --fleet: {text}")
        searched = [int(x.split("searched ")[1].split()[0]) for x in rows]
        require(all(n > 0 for n in searched),
                f"stats --fleet: searches {searched}")
        rc_h, _ = cli_inproc("health", "--addr", addr)
        require(rc_h == 0, f"health --addr ROUTER: exit {rc_h}")
        with CheckClient(addr, timeout_s=60) as c:
            c.shutdown()
        try:
            fleet.wait(timeout=120)
        except subprocess.TimeoutExpired:
            raise RuntimeError("chip_smoke: fleet did not stop")
        require(fleet.returncode == 0, f"fleet exited {fleet.returncode}")
        rec_d.update(searched=searched, stats_fleet=text)
        print(f"{tag} 21d (beside the soak) `fleet --nodes 2`: up in "
              f"{rec_d['fleet_up_s']:.1f}"
              f" s (two spawned nodes, each its own CUDA context); `submit "
              f"--addr ROUTER` {rec_d['submit_s']:.2f} s, {len(corpus)} "
              f"verdicts CppOracle's, decided by {res['nodes']}; `stats "
              f"--serve ROUTER --fleet`:", flush=True)
        for x in text:
            print(f"    {x}")
        print(f"{tag} 21d `health --addr ROUTER` exit 0; the fleet stopped "
              f"on shutdown", flush=True)
        rc, out = cli_result(soak, "soak")
        rep = json.loads(out[-1])
        rec_d["soak_s"] = time.perf_counter() - t_soak
        rec_d["soak"] = rep
        require(rc == 0 and rep["gate_ok"],
                f"soak: rc {rc}, gate {json.dumps(rep)[:600]}")
        # the soak's fuzz rounds draw their corpora in the soak's own
        # process: its report carries that process' launches
        require(device is not None or rep["fuzz"]["draw_launches"] > 0,
                "the soak's fuzz rounds launched no threefry_draws")
        print(f"{tag} 21d `soak --sessions {FLEET_SOAK_SESSIONS}` (started "
              f"after (b)'s timings, beside the rest of (b), (c) and the fleet "
              f"above) "
              f"{rec_d['soak_s']:.1f} s, gate_ok: "
              f"{json.dumps(rep)}", flush=True)
        record["d"] = rec_d
        print(f"{tag} 21d took {time.perf_counter() - t_d:.1f} s",
              flush=True)
    finally:
        for r in routers:
            r.stop()
        for srv in nodes:
            srv.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    total = {c.__name__: sum(x[c.__name__] for x in launches.values())
             for c in counters}
    dt = time.perf_counter() - t_phase
    record["seconds"] = dt
    print(f"{tag} phase 21 record: {json.dumps(record)}", flush=True)
    print(f"{tag} phase 21 launches: " + ", ".join(
        f"{n} {k}" for k, n in total.items()) + f"; {dt:.1f} s", flush=True)
    return launches, err, record


MESH_SHARDS = 4               # (b): logical shards of one card
MESH_SAMPLE_LANES = 48         # (b): running lanes a shard's sample holds


class ShardInputs(FirstInputs):
    """:class:`FirstInputs` by shard: the first ``stepper_chunk``,
    ``compact_carry`` and ``stepper_sweep`` inputs of each logical shard
    (known by the CUDA stream its launches go on), and each kernel's
    launches by shard, counted when the wrapper it reaches returns."""

    def __init__(self, mesh):
        super().__init__()
        self.shard_of = {d.stream.cuda_stream: i
                         for i, d in enumerate(mesh.devices.flat)}
        self.shards = [FirstInputs() for _ in self.shard_of]
        self.launches = {}

    def _here(self, kernel):
        i = self.shard_of[torch.cuda.current_stream().cuda_stream]
        return i, self.shards[i]

    def _count(self, kernel, i):
        by = self.launches.setdefault(kernel, [0] * len(self.shards))
        by[i] += 1

    def _step(self, tabs, carry, **kw):
        i, rec = self._here("stepper_chunk")
        if not rec.steps:
            rec.steps.append((tabs, clone_carry(carry), kw))
        out = stepper_chunk(tabs, carry, **kw)
        self._count("stepper_chunk", i)
        return out

    def _comp(self, carry, lanes, bucket, slots):
        i, rec = self._here("compact_carry")
        if rec.comp is None:
            rec.comp = (clone_carry(carry), np.array(lanes), bucket, slots)
        out = compact_carry(carry, lanes, bucket, slots)
        self._count("compact_carry", i)
        return out

    def _sweep(self, model, tabs, carry, **kw):
        i, rec = self._here("stepper_sweep")
        if rec.sweep is None:
            rec.sweep = (model, tabs, clone_carry(carry), dict(kw))
        out = stepper_sweep(model, tabs, carry, **kw)
        self._count("stepper_sweep", i)
        return out


def device_lanes(stepper, hs):
    """``_run_device`` on ``hs`` a device batch at a time (``MAX_BATCH``):
    every lane's status, ``chosen`` stack and iterations."""
    top = min(stepper.MAX_BATCH, stepper.batch_buckets[-1])
    status, chosen, iters = [], [], []
    for i in range(0, len(hs), top):
        st, ch = stepper._run_device(hs[i:i + top], collect_chosen=True)
        status.append(st)
        chosen.append(np.pad(ch, ((0, 0), (0, 129 - ch.shape[1])),
                             constant_values=-1))
        iters.append(stepper.last_iters.copy())
    return (np.concatenate(status), np.concatenate(chosen),
            np.concatenate(iters))


def phase_mesh(spec, corpus, q_spec, q_corpus, kv_spec, kv_corpus, tag):
    """Phase 22: the mesh on the card.  (a) ``make_mesh()`` spans every
    card; ``sharded_backend`` at that width decides the CAS headline as
    phase 16's planned engine does (on one card both are the same plan
    and engine, so this holds by identity there); a mesh or a server one
    card wider raises with the count.  (b) a logical 4-shard mesh of ``cuda:0``
    (``card_shard_mesh``) over the CAS headline, the queue headline, kv16
    whole (the sweep regime) and kv16 per key: verdicts, ``chosen`` and
    each lane's iterations equal to width 1, 0 verdicts off
    ``CppOracle``, compactions and the lanes they moved across shards,
    each shard's first kernels held against the plain versions, launches
    by shard, histories/s at 4 shards against 1.  Returns the launches of
    each path and the largest error."""
    from qsm_tpu_torch.mesh import (backend_sharding, batch_sharding,
                                    card_shard_mesh, make_mesh,
                                    mesh_shape_key, sharded_backend)
    from qsm_tpu_torch.serve import CheckServer

    launches, err = {}, 0
    counters = (stepper_chunk, compact_carry, stepper_sweep)

    def reset():
        for c in counters:
            c.launches = 0

    # (a) the machine's cards
    t_a = time.perf_counter()
    count = torch.cuda.device_count()
    mesh = make_mesh()
    require(mesh.size == count, f"make_mesh() spans {mesh.size} of "
            f"{count} cards")
    lanes = _replicate(corpus, DEVICE_BATCH)
    profile = profile_corpus(corpus, spec)
    planned = build_backend(spec, plan_search(spec, profile))
    v_plan = np.asarray(planned.check_histories(spec, lanes))
    reset()
    sb = sharded_backend(spec, profile=profile)
    v_mesh = np.asarray(sb.check_histories(spec, lanes))
    launches["CAS headline, make_mesh() (22a)"] = path_launches(
        f"sharded_backend over make_mesh() ({count} cards)", tag, counters)
    require(np.array_equal(v_plan, v_mesh), "sharded_backend over the "
            "machine's cards disagrees with phase 16's planned engine")
    for what, fn in (
            ("make_mesh", lambda: make_mesh(count + 1)),
            ("CheckServer.start", lambda: CheckServer(
                mesh_devices=count + 1).start())):
        try:
            fn()
        except ValueError as e:
            require(f"have {count}" in str(e), f"{what}({count + 1}) "
                    f"raised without the count: {e}")
            print(f"{tag} 22a {what} with {count + 1} devices raises: {e}",
                  flush=True)
        else:
            raise SystemExit(f"chip_smoke: {what} with {count + 1} devices "
                             f"did not raise")
    # at width 1 sharded_backend builds phase 16's plan and engine with no
    # sharding: the comparison is an identity there, and only a machine
    # of several cards makes it a check of the mesh
    same = (" (at width 1 the same plan and engine: an identity, not a "
            "mesh check)" if count == 1 else "")
    print(f"{tag} 22a make_mesh(): {count} card(s), "
          f"mesh_shape_key {mesh_shape_key(backend_sharding(sb))}; "
          f"sharded_backend's {len(lanes)} verdicts equal phase 16's "
          f"planned engine's{same}; {time.perf_counter() - t_a:.1f} s",
          flush=True)

    # (b) a logical 4-shard mesh of one card
    kv_subs = [s for h in kv_corpus
               for s in split_history(kv_spec, h).values()]
    # kv16 whole first: its shards' sweep samples, the longest on the
    # host, advance in the workers while the other paths run
    paths = (
        ("kv16 whole", kv_spec, kv_corpus, None),
        ("CAS headline", spec, corpus, None),
        ("queue headline", q_spec, q_corpus, None),
        ("kv16 per key", kv_spec, kv_corpus, kv_spec.projected_spec()))
    holds = []
    for name, pspec, unique, proj in paths:
        t_path = time.perf_counter()
        shards = card_shard_mesh(MESH_SHARDS)
        sharding = batch_sharding(shards)
        if proj is None:
            one = TorchStepper(pspec)
            four = TorchStepper(pspec, sharding=sharding)
            require((one.regime == "sweep") == (name == "kv16 whole"),
                    f"{name} took the {one.regime} regime")
            ov = (native.CppOracle(pspec).check_histories(pspec, unique)
                  if name != "kv16 whole" else
                  PComp(pspec, make_inner=native.CppOracle)
                  .check_histories(pspec, unique))
            engines = (one, four)
            lane_hs = _replicate(unique, DEVICE_BATCH)
            dev_hs = lane_hs
        else:
            engines = (PComp(pspec, make_inner=TorchStepper),
                       PComp(pspec, make_inner=lambda s: TorchStepper(
                           s, sharding=sharding)))
            one, four = (e.inner for e in engines)
            ov = (PComp(pspec, make_inner=native.CppOracle)
                  .check_histories(pspec, unique))
            lane_hs = _replicate(unique, DEVICE_BATCH)
            dev_hs = [x for x in kv_subs if x.n_pending == 0]
        times = []
        for e in engines:
            timed_check(e, pspec, lane_hs)          # cold: the build
            v, sec = timed_check(e, pspec, lane_hs)
            times.append((v, sec))
        (v1, s1), (v4, s4) = times
        require(np.array_equal(v1, v4), f"{name}: 4 shards decide other "
                f"verdicts than 1")
        both, und = against_cpp(f"{name}, 4 shards", v4, ov)
        st1, ch1, it1 = device_lanes(one, dev_hs)
        reset()
        crossed0, comp0 = four.lanes_crossed, four.compactions
        with ShardInputs(shards) as rec:
            st4, ch4, it4 = device_lanes(four, dev_hs)
        key = f"{name}, {MESH_SHARDS} logical shards (22b)"
        first_kernel = stepper_sweep if name == "kv16 whole" \
            else stepper_chunk
        launches[key] = path_launches(
            f"the {name} on {MESH_SHARDS} logical shards", tag,
            (first_kernel,) + tuple(c for c in counters
                                    if c is not first_kernel))
        for kernel, by in rec.launches.items():
            require(sum(by) == launches[key][kernel], f"{name}: {kernel} "
                    f"launches by shard {by} do not add up to "
                    f"{launches[key][kernel]}")
            for i, n in enumerate(by):
                launches.setdefault(f"{key} shard {i}", {})[kernel] = n
        require(np.array_equal(st1, st4) and np.array_equal(ch1, ch4)
                and np.array_equal(it1, it4), f"{name}: a lane's status, "
                f"chosen or iterations differ between 4 shards and 1")
        crossed = four.lanes_crossed - crossed0
        comps = four.compactions - comp0
        require(name != "queue headline" or crossed > 0,
                "the queue path moved no lane across shards")
        lin = [h for h, x in zip(unique, v4[:len(unique)])
               if x == Verdict.LINEARIZABLE][:8]
        for h in lin:
            wv, wit = engines[1].check_witness(pspec, h)
            require(wv == Verdict.LINEARIZABLE
                    and verify_witness(pspec, h, wit),
                    f"{name}: a 4-shard witness failed to replay")
        torch.cuda.synchronize()
        # every shard's samples advance at once, one worker each, and are
        # compared once every path has run
        holds += [hold_start(f"the {name}, shard {i} of {MESH_SHARDS}",
                             shard, tag, spec=proj or pspec,
                             sample_lanes=MESH_SAMPLE_LANES)
                  for i, shard in enumerate(rec.shards)]
        print(f"{tag} 22b {name} on {MESH_SHARDS} logical shards of "
              f"cuda:0: {len(lane_hs)} histories, {len(dev_hs)} device "
              f"lanes compared; verdicts, chosen and iterations of every "
              f"lane equal to 1 device; vs CppOracle {both} decided by "
              f"both, 0 off, undecided {und}; {comps} compactions moved "
              f"{crossed} lanes across shards; launches by shard "
              f"{json.dumps(rec.launches)}; {len(lin)} witnesses replayed; "
              f"1 device {s1:.4f} s = {len(lane_hs) / s1:.1f} histories/s, "
              f"{MESH_SHARDS} shards {s4:.4f} s = {len(lane_hs) / s4:.1f} "
              f"histories/s: the split costs {s4 / s1:.3f}x on one card; "
              f"{time.perf_counter() - t_path:.1f} s", flush=True)
    for finish in holds:
        err = max(err, finish())
    return launches, err


LINT_CLI_TIMEOUT_S = 300       # (e): the lint subprocess's bound


def phase_lint(tag, device=None):
    """Phase 23: the port's static checks on the card (``device``: cuda:0
    unless a rehearsal on the CPU asks for "cpu").  (e)'s subprocess
    (``python -m qsm_tpu_torch lint --json``) starts first and runs beside
    (a)-(d).  (a) ``run_lint(device="cuda")`` over families a-f, h, m, o:
    no unwhitelisted error or warning, each family's seconds and the rule
    counts printed; (b) family a's parity on the card, the states and
    tuples a model; (c) the rebuild guard's backends grew nothing after
    their warm call, and the seeded ``RebuildingTorchStepper`` (a library
    a call, built by ``nvcc``) is caught; (d) the SMEM/REGS pass over the
    five real ptxas reports (registers, stack, spills, the estimator's
    blocks an SM, the edge plan) and each edge plan launched again, bit
    for bit against its plain version; (e) the subprocess exits 0 with
    ``ok``.  The kernels' launches of (a)-(d) are the path's.  Returns
    (launches by kernel, the largest edge error)."""
    from collections import Counter

    from qsm_tpu_torch.analysis import FAMILIES, run_lint
    from qsm_tpu_torch.analysis.engine import _rebuild_corpora
    from qsm_tpu_torch.analysis.fixtures import RebuildingTorchStepper
    from qsm_tpu_torch.analysis.kernel_passes import (check_kernel_envelope,
                                                      check_rebuild,
                                                      launch_edge_plans)

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    proc = cli_proc("lint", "--json", *(("--device", "cpu")
                                        if dev.type == "cpu" else ()))
    counters = (dfs_chunk, stepper_chunk, compact_carry, stepper_sweep,
                threefry_draws)
    try:
        for c in counters:
            c.launches = 0
        # (a)
        t0 = time.perf_counter()
        rep = run_lint(device=dev, cache=False)
        bad = [f for f in rep.findings if f.severity != "info"]
        require(not bad, "lint on the card: " + "; ".join(
            f"{f.rule_id} {f.location}: {f.message}" for f in bad))
        rules = Counter(f.rule_id for f in rep.findings + rep.whitelisted)
        print(f"{tag} 23a run_lint on {rep.device}: families "
              f"{','.join(rep.families)} ({len(FAMILIES)} registered), "
              f"{len(rep.models)} models, 0 errors, 0 warnings, "
              f"{len(rep.findings)} info, {len(rep.whitelisted)} "
              f"whitelisted; {time.perf_counter() - t0:.2f} s; seconds by "
              f"family " + json.dumps({k: round(v, 3)
                                       for k, v in rep.passes.items()})
              + "; rules " + json.dumps(dict(sorted(rules.items()))),
              flush=True)
        # (b)
        require(sorted(rep.parity) == sorted(MODELS),
                f"parity ran on {sorted(rep.parity)}")
        for name, st in sorted(rep.parity.items()):
            require(st["device"] == str(dev), f"{name}: parity on "
                    f"{st['device']}")
        print(f"{tag} 23b parity step_py vs step_torch on {dev}: " + ", ".join(
            f"{n} {st['states']} states / {st['tuples']} tuples "
            f"{'exhaustive' if st['exhaustive'] else 'sampled'}"
            for n, st in sorted(rep.parity.items())), flush=True)
        # (c)
        for label, rec in rep.rebuild.items():
            require(rec["warm"] == rec["after"],
                    f"{label} grew after its warm call: {rec}")
        print(f"{tag} 23c rebuild guard: " + "; ".join(
            f"{label} {rec['after']}" for label, rec in
            rep.rebuild.items()) + " after the warm call and after, no "
            "growth", flush=True)
        t0 = time.perf_counter()
        cas = MODELS["cas"].make_spec()
        seeded = RebuildingTorchStepper(
            cas, budget=2_000, mid_budget=0, rescue_budget=0,
            chunk_schedule=(512,), device=dev)
        rec = {}
        found = check_rebuild(cas, seeded, _rebuild_corpora(MODELS["cas"],
                                                            cas),
                              "fixture:rebuilding_torch_stepper", rec)
        require([f.rule_id for f in found] == ["QSM-KERN-REBUILD"],
                f"the seeded rebuild was not caught: {found}")
        print(f"{tag} 23c seeded RebuildingTorchStepper caught on the card: "
              f"{found[0].message}; {time.perf_counter() - t0:.2f} s "
              f"(nvcc twice)", flush=True)
        # (d)
        t0 = time.perf_counter()
        specs = [(n, MODELS[n].make_spec(), f"model:{n}")
                 for n in sorted(MODELS)]
        found, rows = check_kernel_envelope(specs, sms=device_sms(dev))
        require(not found, f"SMEM/REGS findings: {found}")
        for r in rows:
            print(f"{tag} 23d {r['kernel']}: {r['entries']} entries, "
                  f"{r['registers']} registers, stack {r['stack']} B, "
                  f"spills {r['spills']} B; {r['plans']} plans, the edge "
                  f"{r['edge']} {r['edge_plan']}: {r['threads']} threads, "
                  f"{r['smem']} shared bytes a block, {r['blocks_per_sm']} "
                  f"blocks an SM (shared memory, warps and registers)",
                  flush=True)
        found, edges = launch_edge_plans(specs, dev)
        require(not found, f"edge launches: {found}")
        err = max(e["max_abs_err"] for e in edges)
        for e in edges:
            print(f"{tag} 23d edge launch of {e['kernel']} at {e['edge']} "
                  f"plan {e['plan']}: bit-identical to plain (max abs err "
                  f"{e['max_abs_err']})", flush=True)
        print(f"{tag} 23d {time.perf_counter() - t0:.2f} s", flush=True)
        launches = {c.__name__: c.launches for c in counters}
        print(f"{tag} path of lint (phase 23): " + ", ".join(
            f"{n} {k}" for k, n in launches.items()) + " launches",
            flush=True)
        for name, n in launches.items():
            require(n > 0, f"lint (phase 23) launched no {name}")
        # (e)
        rc, lines = cli_result(proc, "lint --json")
        doc = json.loads(lines[-1])
        require(rc == 0 and doc["ok"] and doc["errors"] == 0,
                f"lint --json exited {rc}: {lines[-1][:600]}")
        print(f"{tag} 23e python -m qsm_tpu_torch lint --json: rc 0, "
              f"device {doc['device']}, {doc['errors']} errors, "
              f"{doc['warnings']} warnings, {len(doc['whitelisted'])} "
              f"whitelisted, {doc['seconds']} s in its run", flush=True)
    finally:
        if proc.poll() is None:
            reap(proc)
    dt = time.perf_counter() - t_phase
    print(f"{tag} phase 23 took {dt:.1f} s (target 30 s)", flush=True)
    return launches, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="an earlier dfs_chunk.cu to time in turns with "
                         "this one")
    ap.add_argument("--against-stepper", type=Path, default=None,
                    help="a directory with an earlier stepper_chunk.cu and "
                         "compact_carry.cu to time in turns with these")
    ap.add_argument("--against-sweep", type=Path, default=None,
                    help="an earlier stepper_sweep.cu (a C entry of 14 "
                         "pointers, no lane list) to time in turns with "
                         "this one")
    ap.add_argument("--against-draws", type=Path, default=None,
                    help="an earlier threefry_draws.cu (the first "
                         "version's C entry: out, seed, lanes, draws, "
                         "stream) to time in turns with this one")
    ap.add_argument("--ablate-sweep", action="store_true",
                    help="after phase 9, time stepper_sweep against the "
                         "running lanes launched and against ablation "
                         "builds of its source (kv16)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run phases 1-2 and 22 alone (a check of the "
                         "mesh, not the contract's run: no result is "
                         "printed)")
    ap.add_argument("--lint-only", action="store_true",
                    help="run phases 1-2 and 23 alone (a check of the "
                         "static checks, not the contract's run: no "
                         "result is printed)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # the lane samples' worker processes start (and import) beside
    # phases 1-5
    pool = sample_pool()
    for _ in range(SAMPLE_WORKERS):
        pool.submit(os.getpid)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    tag = f"[{smi}]"
    dev = torch.device("cuda", 0)
    print(f"device: {kind} (count {count}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = kernels.build_all()
    print(f"{tag} build: {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc a source, in "
          f"parallel)")
    for name, lib in libs.items():
        for line in lib.with_suffix(".ptxas.txt").read_text().splitlines():
            if "Compiling entry" in line:
                print(f"  ptxas {name}: "
                      f"{line.split('_kernel')[-1].strip()}")
            elif any(k in line for k in ("registers", "stack frame")):
                print(f"  ptxas {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            require(m is None or m.groups() == ("0", "0"),
                    f"{name} spills: {line.strip()}")
    for B, S, cs in ((4096, 5, 64), (16384, 5, 64), (4096, 5, 0),
                     (4096, RANDOM_STATES, 64)):
        print(f"  plan: {plan_text(B, S, cs)}")
    # the native host oracle: g++ must be there (the CUDA toolkit needs a
    # host compiler), so the host ladder must not fall back to Python
    status = native.native_status()
    t0 = time.perf_counter()
    require(native.native_available(), f"the native host oracle did not "
            f"build: {native.native_error()}")
    print(f"{tag} native host oracle: {status} before, g++ build and load "
          f"{time.perf_counter() - t0:.2f} s, now {native.native_status()} "
          f"({native.library_path().name})", flush=True)

    spec = CasSpec()
    corpus = build_corpus(spec, (AtomicCasSUT, RacyCasSUT), n=N_UNIQUE,
                          n_pids=N_PIDS, max_ops=N_OPS, seed_base=1000,
                          seed_prefix="bench")
    if args.lint_only:
        lint_launches, lint_err = phase_lint(tag)
        print(f"{tag} --lint-only: launches {json.dumps(lint_launches)}; "
              f"largest error {lint_err}; no result", flush=True)
        return 0
    if args.mesh_only:
        t0 = time.perf_counter()
        mesh_launches, mesh_err = phase_mesh(spec, corpus, *queue_corpus(),
                                             *kv16_corpus(), tag)
        print(f"{tag} phase the mesh: {time.perf_counter() - t0:.1f} s; "
              f"launches {json.dumps(mesh_launches)}; largest error "
              f"{mesh_err}; --mesh-only: no result", flush=True)
        return 0
    t0 = time.perf_counter()
    max_err, timings = phase_kernel(spec, corpus, dev, tag)
    print(f"{tag} phase kernel-vs-plain: {time.perf_counter() - t0:.1f} s")
    if args.against is not None:
        phase_against(args.against, timings, tag)

    # TorchGPU's main path: launch counts from here to the end of phase 5
    dfs_chunk.launches = 0
    t0 = time.perf_counter()
    gpu_warm_s = phase_checker(spec, corpus, tag)
    phase_property(spec, tag)
    launches = dfs_chunk.launches
    print(f"{tag} main path of TorchGPU: {launches} dfs_chunk launches, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(launches > 0, "the main path launched no dfs_chunk kernel")

    q_spec, q_corpus = queue_corpus()
    t0 = time.perf_counter()
    step_err, step_rows, comp_rows, q_tabs = phase_stepper(
        q_spec, q_corpus, dev, tag)
    print(f"{tag} phase stepper kernels vs plain: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.against_stepper is not None:
        phase_against_stepper(args.against_stepper, q_tabs, step_rows,
                              comp_rows, tag)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    step = {k: step_rows[default_slots(DEVICE_BATCH)][k] for k in keys}
    comp = {k: comp_rows["grown"][k] for k in keys}
    del step_rows, comp_rows, q_tabs  # their carries: free the memory

    # TorchStepper's main path: launch counts from here to the end of
    # phase 8
    stepper_chunk.launches = compact_carry.launches = 0
    t0 = time.perf_counter()
    q_warm_s = phase_queue_checker(q_spec, q_corpus, tag)
    phase_queue_property(q_spec, tag)
    step_launches = stepper_chunk.launches
    comp_launches = compact_carry.launches
    print(f"{tag} main path of TorchStepper: {step_launches} stepper_chunk "
          f"launches, {comp_launches} compact_carry launches, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(step_launches > 0, "the main path launched no stepper_chunk")
    require(comp_launches > 0, "the main path launched no compact_carry")

    kv_spec, kv_corpus = kv16_corpus()
    t0 = time.perf_counter()
    sweep_err, sweep_comp_err, sweep = phase_sweep(kv_spec, kv_corpus, dev,
                                                   tag, args.against_sweep)
    print(f"{tag} phase stepper_sweep vs plain: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.ablate_sweep:
        phase_sweep_ablation(kv_spec, kv_corpus, dev, tag)
    # the sweep regime's main path: launch counts over phases 10-11
    stepper_sweep.launches = compact_carry.launches = 0
    t0 = time.perf_counter()
    sweep_v = phase_kv16(kv_spec, kv_corpus, tag)
    sweep_launches = stepper_sweep.launches
    print(f"{tag} main path of TorchStepper's sweep regime: "
          f"{sweep_launches} stepper_sweep launches, "
          f"{compact_carry.launches} compact_carry launches, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(sweep_launches > 0, "the sweep regime's main path launched no "
            "stepper_sweep")
    t0 = time.perf_counter()
    kv4_v = phase_milestones(tag)
    print(f"{tag} phase milestones: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    pcomp_launches, pcomp_err = phase_pcomp(
        [("kv16", kv_spec, kv_corpus, sweep_v),
         ("kv (4 keys)", *kv4_corpus(), kv4_v),
         ("multireg", *registry_corpus("multireg"), None),
         ("multicas", *registry_corpus("multicas"), None)], tag)
    print(f"{tag} phase per-key decomposition: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    hybrid_launches, hybrid_err = phase_hybrid(
        [("CAS headline", spec, corpus, gpu_warm_s, "TorchGPU"),
         ("queue headline", q_spec, q_corpus, q_warm_s, "TorchStepper")],
        tag)
    print(f"{tag} phase hybrid plan: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    draws_err, draw_rows = phase_draws(dev, tag)
    if args.against_draws is not None:
        phase_against_draws(args.against_draws, dev, tag)
    phase_generate(dev, tag)
    gen_launches, gen_err = phase_steer(dev, tag)
    print(f"{tag} phase generation plane: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    search_launches, search_err = phase_search(spec, corpus, kv_spec,
                                               kv_corpus, tag)
    print(f"{tag} phase search plane: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    entry_launches, entry_err = phase_entry(spec, corpus, tag)
    print(f"{tag} phase entry points, exploration and fuzzing: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    res_launches, res_err, check_one_rec = phase_resilience(
        spec, corpus, kv_spec, kv_corpus, dev, tag)
    print(f"{tag} phase resilience and the history shrinker: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    mon_launches, mon_err, mon_rec = phase_monitor(
        spec, corpus, q_spec, q_corpus, kv_spec, kv_corpus, dev, tag)
    print(f"{tag} phase observability, the monitor and ingest: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    serve_launches, serve_err, serve_rec = phase_serve(
        spec, corpus, q_spec, q_corpus, kv_spec, kv_corpus, mon_rec, tag)
    print(f"{tag} phase the check server: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    fleet_launches, fleet_err, _fleet_rec = phase_fleet(
        spec, corpus, q_spec, q_corpus, kv_spec, kv_corpus, serve_rec, tag)
    print(f"{tag} phase the fleet tier: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    mesh_launches, mesh_err = phase_mesh(spec, corpus, q_spec, q_corpus,
                                         kv_spec, kv_corpus, tag)
    print(f"{tag} phase the mesh: {time.perf_counter() - t0:.1f} s",
          flush=True)
    lint_launches, lint_err = phase_lint(tag)
    by_path = {"queue (phases 7-8)": {"stepper_chunk": step_launches,
                                      "compact_carry": comp_launches},
               **{f"{k} per key": x for k, x in pcomp_launches.items()},
               **{f"{k} hybrid": x for k, x in hybrid_launches.items()},
               "generation plane (phase 15)": gen_launches,
               **search_launches,
               "entry points (phase 17)": entry_launches,
               **res_launches, **mon_launches, **serve_launches,
               **fleet_launches, **mesh_launches,
               "lint (phase 23)": lint_launches}

    def paths_of(kernel):
        return {k: x[kernel] for k, x in by_path.items() if kernel in x}

    # phase 6 and the paths of phases 13-17, each on its own inputs
    step_err = max(step_err, pcomp_err, hybrid_err, gen_err, search_err,
                   entry_err, res_err, mon_err, serve_err, fleet_err,
                   mesh_err, lint_err)
    search_err = max(search_err, entry_err, res_err, mon_err, serve_err,
                     fleet_err, mesh_err, lint_err)
    draws_err = max(draws_err, lint_err)
    head = next(r for r in timings if r["tables"] == "cas"
                and r["B"] == 4096 and r["slots"] == 64)
    # how each "ms" was taken, so that lines of different versions compare
    back_to_back = "cuda events, launches back to back through the wrapper"
    kernels_line = {"kernels": [{
        "name": "dfs_chunk", "route": "cuda", "timing": back_to_back,
        "source": "qsm_tpu_torch/csrc/dfs_chunk.cu",
        "replaces": "qsm_tpu/ops/pallas_kernel.py:265 (build_pallas_chunk)",
        "launches": launches, "matches_plain": max(max_err, search_err) == 0,
        "max_abs_err": max(max_err, search_err), "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None,
        "launches_by_path": {"CAS headline (phases 4-5)": launches,
                             **paths_of("dfs_chunk")}}]}
    kernels_line["kernels"] += [{
        "name": "stepper_chunk", "route": "cuda", "timing": back_to_back,
        "source": "qsm_tpu_torch/csrc/stepper_chunk.cu",
        "replaces": "qsm_tpu/ops/jax_kernel.py:255 (build_stepper -> "
                    "run_one, table regime)",
        "launches": step_launches, "matches_plain": step_err == 0,
        "max_abs_err": step_err, **step, "library_ms": None,
        "launches_by_path": paths_of("stepper_chunk"),
        # build_kernel's check_one (the reference's jax_kernel.py:440):
        # one launch of the whole budget, on history #35
        "check_one": check_one_rec}, {
        "name": "compact_carry", "route": "cuda", "timing": back_to_back,
        "source": "qsm_tpu_torch/csrc/compact_carry.cu",
        "replaces": "qsm_tpu/ops/jax_kernel.py:736 (JaxTPU._compact_fn)",
        "launches": comp_launches,
        "matches_plain": max(step_err, sweep_comp_err) == 0,
        "max_abs_err": max(step_err, sweep_comp_err), **comp,
        "library_ms": None,
        "launches_by_path": paths_of("compact_carry")}, {
        "name": "stepper_sweep", "route": "cuda", "timing": back_to_back,
        "source": "qsm_tpu_torch/csrc/stepper_sweep.cu",
        "replaces": "qsm_tpu/ops/jax_kernel.py:303 (build_stepper -> "
                    "run_one, sweep regime)",
        "launches": sweep_launches,
        "matches_plain": max(sweep_err, search_err) == 0,
        "max_abs_err": max(sweep_err, search_err), **sweep,
        "library_ms": None,
        "launches_by_path": {"kv16 (phases 10-11)": sweep_launches,
                             **paths_of("stepper_sweep")}}, {
        "name": "threefry_draws", "route": "cuda",
        "timing": "cuda events, launches queued behind a spin of the card "
                  "(time_queued); wrapper_ms: back to back through the "
                  "wrapper",
        "source": "qsm_tpu_torch/csrc/threefry_draws.cu",
        "replaces": "qsm_tpu/gen/core.py:88 (_raw_draws_jax)",
        "launches": gen_launches["threefry_draws"],
        "matches_plain": draws_err == 0, "max_abs_err": draws_err,
        **draw_rows[(GEN_BATCH, gen_core._n_draws(GEN_OPS))],
        # torch's generators are Philox: no PyTorch call computes
        # threefry's bits
        "library_ms": None,
        "launches_by_path": {"generation plane (phase 15)":
                             gen_launches["threefry_draws"],
                             **paths_of("threefry_draws")}}]
    print(f"{tag} total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        close_sample_pool()
    sys.exit(rc)
