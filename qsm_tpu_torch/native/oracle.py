"""``CppOracle``: the native host checker (a ``LineariseBackend``).

Routing per history, as the JAX package's ``qsm_tpu/native/oracle.py``
routes it:

* a scalar spec with a declared state bound: the C++ search over the dense
  step table of the declared domains (``wg.cpp`` kind 0);
* a vector spec that declares a step function built into the C++ side
  (``Spec.native_kernel``: queue 1, KV map 2, stack 3): the same search
  with that step, total in the response like ``step_py``;
* everything else (other specs, out-of-domain args, histories over 128
  ops, no toolchain): the Python memo oracle, so verdicts are always
  available and always exact.

On the table path out-of-domain responses go to the Python oracle too:
the table covers the declared domains only.  The vector steps evaluate the
response directly and take any value, as the Python oracle does.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from ..core.history import History
from ..core.spec import Spec, compile_step_table
from ..ops.backend import Verdict
from ..ops.wing_gong_cpu import WingGongCPU

# the native checker's coverage cap: an unsigned __int128 taken mask, the
# encoder's largest bucket
NATIVE_MAX_OPS = 128
_MAX_OPS = NATIVE_MAX_OPS
_MAX_STATE = 64  # wg.cpp MAX_STATE


def _blockers2(prec: np.ndarray) -> np.ndarray:
    """Per-op precedence blockers as [n][2] little-endian uint64 words
    (the wg.cpp mask wire format): word w of blockers2[j] has bit b set
    iff op ``64*w + b`` strictly precedes op j.  Fully vectorized — the
    per-edge Python loop was 80% of the whole native check wall-clock."""
    n = prec.shape[0]
    # 2 words cover exactly NATIVE_MAX_OPS predecessors; a cap/routing
    # drift past that would silently drop precedence bits (admitting
    # illegal linearizations) — fail loudly instead.
    assert n <= _MAX_OPS, f"_blockers2: n={n} exceeds {_MAX_OPS}-op mask"
    out = np.zeros((n, 2), np.uint64)
    idx = np.arange(n)
    word = idx >> 6                              # word of predecessor i
    bit = np.uint64(1) << np.uint64(idx & 63)
    for w in range(2):
        rows = word == w
        if rows.any():
            contrib = np.where(prec[rows], bit[rows, None], np.uint64(0))
            out[:, w] = np.bitwise_or.reduce(contrib, axis=0)
    return out


class CppOracle:
    """Batched native Wing–Gong checker."""

    name = "cpp_oracle"

    def __init__(self, spec: Spec, node_budget: int = 50_000_000,
                 memo: bool = True,
                 fallback: Optional[WingGongCPU] = None):
        from . import get_lib

        self.spec = spec
        self.node_budget = node_budget
        self.memo = memo
        self.fallback = fallback or WingGongCPU(node_budget=node_budget,
                                                memo=memo)
        self._lib = get_lib()
        self._tables = {}  # state bound -> (trans, ok)
        self._vector_kernel = spec.native_kernel()
        if (self._vector_kernel is not None
                and spec.STATE_DIM > _MAX_STATE):
            self._vector_kernel = None  # larger than the C++ state cap
        self.nodes_explored = 0
        self.native_histories = 0
        self.fallback_histories = 0

    # ------------------------------------------------------------------
    def _uses_table(self) -> bool:
        return (self.spec.STATE_DIM == 1
                and self.spec.scalar_state_bound(1) is not None)

    def _ops_in_domain(self, ops) -> bool:
        """ONE copy of the native-routing domain rules (used by history
        routing and by end_states): args always in the declared domains;
        responses too on the table path (module docstring)."""
        table = self._uses_table()
        for o in ops:
            if not (0 <= o.cmd < self.spec.n_cmds
                    and 0 <= o.arg < self.spec.CMDS[o.cmd].n_args):
                return False  # out-of-domain arg: step contract undefined
            if table and not o.is_pending and not (
                    0 <= o.resp < self.spec.CMDS[o.cmd].n_resps):
                return False  # table path: stay exact
        return True

    def _dispatch(self, max_len: int, max_start: Optional[int] = None):
        """ONE copy of the table-vs-kernel selection: (kind, p0, p1,
        elem_bits, trans, ok, S, C, A, R) for the C++ calls, or None when
        this spec has no native route.  ``max_start`` sizes the scalar
        table past the from-initial bound when searches begin at frontier
        states (growth heuristic: +1 per step covers the counter/ticket
        family; anything that still escapes hits the in-kernel OOB guard
        and defers honestly — never a misread)."""
        if self._uses_table():
            bound = self.spec.scalar_state_bound(max(max_len, 1))
            if max_start is not None:
                bound = max(bound, max_start + 1 + max_len)
            trans, ok = self._table(bound)
            S, C, A, R = trans.shape
            return (0, 0, 0, 0, trans, ok, S, C, A, R)
        if self._vector_kernel is not None:
            kind, p0, p1 = self._vector_kernel
            return (kind, p0, p1, self._elem_bits(kind, p0, p1),
                    None, None, 0, 0, 0, 0)
        return None

    def can_enumerate(self) -> bool:
        """True when this spec has a native route at all (step table or
        vector kernel, library loaded) — i.e., :meth:`end_states` can
        ever answer non-None.  Callers choosing a middle-segment
        enumerator (``ops/segdc.py::default_middle_oracle``) probe this:
        a CppOracle that always falls back is strictly worse than the
        memoised Python oracle it would displace."""
        return self._lib is not None and self._dispatch(1) is not None

    def _native_ok(self, h: History) -> bool:
        if self._lib is None or len(h) > _MAX_OPS:
            return False
        if not self._uses_table() and self._vector_kernel is None:
            return False
        return self._ops_in_domain(h.ops)

    def _table(self, bound: int):
        # any cached table with rows >= bound serves (the kernel reads S
        # from the table itself); compile rounded up so a frontier that
        # grows by one per segment doesn't recompile per segment
        usable = [b for b in self._tables if b >= bound]
        if usable:
            return self._tables[min(usable)]
        bound = -(-bound // 32) * 32
        trans, ok = compile_step_table(self.spec, bound)
        # NOT clipped: a successor beyond the table is caught by the
        # in-kernel state_oob guard and deferred honestly — clipping
        # would silently misread a wrong row instead
        trans = np.ascontiguousarray(trans, np.int32)
        ok = np.ascontiguousarray(ok, np.uint8)
        self._tables[bound] = (trans, ok)
        return self._tables[bound]

    # ------------------------------------------------------------------
    def check_histories(self, spec: Spec, histories: Sequence[History],
                        init_states: Optional[Sequence] = None
                        ) -> np.ndarray:
        assert spec is self.spec, "CppOracle is bound to one spec"
        out = np.empty(len(histories), np.int8)
        native_idx: List[int] = []
        fb_idx: List[int] = []
        for i, h in enumerate(histories):
            (native_idx if self._native_ok(h) else fb_idx).append(i)

        if native_idx:
            self._run_native(histories, native_idx, init_states, out)
            self.native_histories += len(native_idx)
        for i in fb_idx:
            init = None if init_states is None else init_states[i]
            if init is None:
                out[i] = self.fallback.check_histories(
                    spec, [histories[i]])[0]
            else:
                out[i] = int(self.fallback.check_from(
                    spec, histories[i], np.asarray(init)))
            self.fallback_histories += 1
        return out

    def check_from(self, spec: Spec, history: History, init_state) -> Verdict:
        v = self.check_histories(spec, [history], init_states=[init_state])
        return Verdict(int(v[0]))

    def search_stats(self):
        """Host-search cost record (``search/stats.py``): native nodes
        plus whatever the Python fallback spent on histories outside the
        native domain, one sum."""
        from ..search.stats import SearchStats, collect_search_stats

        st = SearchStats(
            engine=self.name,
            histories=self.native_histories + self.fallback_histories,
            nodes_explored=self.nodes_explored,
        )
        return st.absorb(collect_search_stats(self.fallback))

    def check_witness(self, spec: Spec, history: History):
        """(verdict, witness) — delegated to the Python oracle: witness
        extraction is a debugging/audit path, and the fallback shares
        this backend's candidate order and budget config, so the verdict
        agrees with :meth:`check_histories` wherever both decide."""
        return self.fallback.check_witness(spec, history)

    # ------------------------------------------------------------------
    def end_states(self, spec: Spec, ops, starts, budget=None,
                   node_budget: Optional[int] = None,
                   max_out: int = 4096):
        """Distinct model states reachable by SOME complete linearization
        of ``ops`` (a pending-free segment) from any state in ``starts``:
        the native counterpart of the JAX package's
        ``ops/segdc.py::_end_states``.  Returns a set of int tuples,
        or None when this spec/segment can't run natively or the budget /
        output cap is hit (the caller then uses the Python path).

        ``budget``: a shared object with a ``left`` counter (a
        per-history node budget); nodes consumed natively are charged
        against it — including on failure, so a Python fallback resumes
        with the true remainder instead of double-spending."""
        assert spec is self.spec
        n = len(ops)
        if (self._lib is None or n == 0 or n > _MAX_OPS
                or any(o.is_pending for o in ops)
                or not self._ops_in_domain(ops)):
            return None
        starts = sorted({tuple(int(v) for v in s) for s in starts})
        disp = self._dispatch(n, max_start=(max(s[0] for s in starts)
                                            if self._uses_table() else None))
        if disp is None:
            return None
        kind, p0, p1, elem_bits, trans, ok, S, C, A, R = disp

        dim = spec.STATE_DIM
        # one construction site for precedence: the same History-based
        # vectorized path _run_native uses
        seg = History(sorted(ops, key=lambda o: o.invoke_time))
        cmd = np.asarray([o.cmd for o in seg.ops], np.int32)
        arg = np.asarray([o.arg for o in seg.ops], np.int32)
        resp = np.asarray([o.resp for o in seg.ops], np.int32)
        blockers = _blockers2(seg.precedes_matrix().astype(bool))
        inits = np.asarray(starts, np.int32).reshape(len(starts), dim)
        out = np.empty((max_out, dim), np.int32)
        if node_budget is None:
            node_budget = (budget.left if budget is not None
                           else self.node_budget)
        if node_budget <= 0:
            return None

        def p(a, ty):
            return (None if a is None
                    else a.ctypes.data_as(ctypes.POINTER(ty)))

        nodes_used = ctypes.c_longlong(0)
        got = self._lib.wg_end_states(
            n, p(cmd, ctypes.c_int32), p(arg, ctypes.c_int32),
            p(resp, ctypes.c_int32), p(blockers, ctypes.c_uint64),
            kind, dim, p0, p1, elem_bits,
            p(trans, ctypes.c_int32), p(ok, ctypes.c_uint8),
            S, C, A, R,
            p(inits, ctypes.c_int32), len(starts),
            node_budget, p(out, ctypes.c_int32), max_out,
            ctypes.byref(nodes_used))
        self.nodes_explored += int(nodes_used.value)
        if budget is not None:
            budget.left -= int(nodes_used.value)
        if got < 0:
            return None  # -1 budget, -2 output cap, -3 table escape
        return {tuple(int(v) for v in out[i]) for i in range(int(got))}

    # ------------------------------------------------------------------
    def _elem_bits(self, kind: int, p0: int, p1: int) -> int:
        """Bit width bounding any state element of a native vector kernel
        (lets the C++ memo pack the state into one 64-bit word instead of
        allocating a string key per DFS node).  0 = unknown, use strings."""
        if kind in (1, 3):  # queue/stack: [length <= cap, slots < n_values]
            return max(p0, p1 - 1).bit_length() or 1
        if kind == 2:    # kv: values < n_values
            return max(1, (p1 - 1).bit_length())
        return 0

    def _run_native(self, histories, idx, init_states, out) -> None:
        spec = self.spec
        dim = spec.STATE_DIM
        max_len = max(len(histories[i]) for i in idx)
        max_start = None
        if self._uses_table() and init_states is not None:
            # searches may start at frontier states past the from-initial
            # bound (segment-wise checking): size the table to cover them;
            # any still-escaping state hits the in-kernel OOB guard
            max_start = max(
                (int(np.asarray(init_states[i])[0])
                 for i in idx if init_states[i] is not None),
                default=0)
        kind, p0, p1, elem_bits, trans, ok, S, C, A, R = self._dispatch(
            max_len, max_start=max_start)

        total = sum(len(histories[i]) for i in idx)
        offsets = np.zeros(len(idx) + 1, np.int64)
        cmd = np.empty(total, np.int32)
        arg = np.empty(total, np.int32)
        resp = np.empty(total, np.int32)
        pending = np.empty(total, np.uint8)
        blockers = np.empty((total, 2), np.uint64)
        inits = np.empty((len(idx), dim), np.int32)
        default_init = np.asarray(spec.initial_state(), np.int32)
        pos = 0
        for k, i in enumerate(idx):
            h = histories[i]
            n = len(h)
            offsets[k + 1] = pos + n
            blockers[pos:pos + n] = _blockers2(
                h.precedes_matrix().astype(bool))
            for j, o in enumerate(h.ops):
                cmd[pos + j] = o.cmd
                arg[pos + j] = o.arg
                resp[pos + j] = 0 if o.is_pending else o.resp
                pending[pos + j] = 1 if o.is_pending else 0
            inits[k] = (default_init if init_states is None
                        or init_states[i] is None
                        else np.asarray(init_states[i], np.int32))
            pos += n

        n_resps = np.asarray([c.n_resps for c in spec.CMDS], np.int32)
        verdicts = np.empty(len(idx), np.int32)

        def p(a, ty):
            return (None if a is None
                    else a.ctypes.data_as(ctypes.POINTER(ty)))

        nodes = self._lib.wg_check_batch(
            len(idx), p(offsets, ctypes.c_int64),
            p(cmd, ctypes.c_int32), p(arg, ctypes.c_int32),
            p(resp, ctypes.c_int32), p(pending, ctypes.c_uint8),
            p(blockers, ctypes.c_uint64),
            kind, dim, p0, p1, elem_bits,
            p(trans, ctypes.c_int32), p(ok, ctypes.c_uint8),
            S, C, A, R, p(n_resps, ctypes.c_int32),
            p(inits, ctypes.c_int32),
            self.node_budget, 1 if self.memo else 0,
            p(verdicts, ctypes.c_int32))
        self.nodes_explored += int(nodes)
        for k, i in enumerate(idx):
            out[i] = verdicts[k]
