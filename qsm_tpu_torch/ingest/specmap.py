"""Spec maps — external operation vocabularies ↔ spec (cmd, arg, resp).

A format adapter (ingest/adapters.py) understands a FILE layout
(jepsen's ``:f``/``:value`` maps, porcupine's explicit ``:key`` field);
a spec map understands one MODEL's integer packing (core/spec.py
``CmdSig`` domains).  The split keeps both sides honest: adapters never
guess at arg packing, maps never guess at file syntax.

Each map speaks four verbs over ``(f, key, value)`` triples — ``key``
is the per-key component (None for unkeyed specs) and ``value`` the
payload:

* ``invoke_op(f, key, value) -> (cmd, arg)``
* ``resp_of(cmd, arg, value, failed) -> resp``
* ``render_invoke(cmd, arg) -> (f, key, value)``
* ``render_resp(cmd, arg, resp) -> (f, key, value, failed)``

Out-of-domain values are refused loudly (:class:`IngestError`): a trace
that does not fit the spec's declared domains is a spec-selection
mistake, not something to clamp quietly.
"""

from __future__ import annotations

from typing import Optional, Tuple


class IngestError(ValueError):
    """A trace event the selected spec cannot represent."""


def _int_in(v, bound: int, what: str) -> int:
    if not isinstance(v, int):
        raise IngestError(f"{what} must be an integer, got {v!r}")
    if not 0 <= v < bound:
        raise IngestError(f"{what} {v} outside spec domain [0, {bound})")
    return v


class RegisterMap:
    """``read``/``write`` over one register (models/register.py; the
    cas map extends it with ``cas [old new]``)."""

    READ, WRITE = 0, 1
    keyed = False

    def __init__(self, spec):
        self.spec = spec
        self.n_values = spec.CMDS[self.READ].n_resps

    def invoke_op(self, f: str, key, value) -> Tuple[int, int]:
        if f == "read":
            return self.READ, 0
        if f == "write":
            return self.WRITE, _int_in(value, self.n_values, "write value")
        raise IngestError(f"{self.spec.name}: unknown op :f :{f} "
                          "(read/write)")

    def resp_of(self, cmd: int, arg: int, value, failed: bool) -> int:
        if cmd == self.READ:
            if failed:
                raise IngestError("a read cannot :fail (it has no "
                                  "precondition); use :info for unknown")
            return _int_in(value, self.n_values, "read result")
        return 0

    def render_invoke(self, cmd: int, arg: int):
        if cmd == self.READ:
            return "read", None, None
        return "write", None, arg

    def render_resp(self, cmd: int, arg: int, resp: int):
        if cmd == self.READ:
            return "read", None, resp, False
        return "write", None, arg, False


class CasMap(RegisterMap):
    """register ops plus ``cas [old new]`` (models/cas.py: arg packs
    ``old * n_values + new``; resp 1 = swapped, 0 = precondition
    failed — jepsen's ``:fail`` line)."""

    CAS = 2

    def invoke_op(self, f: str, key, value) -> Tuple[int, int]:
        if f == "cas":
            if (not isinstance(value, (list, tuple)) or len(value) != 2):
                raise IngestError(f"cas value must be [old new], "
                                  f"got {value!r}")
            old = _int_in(value[0], self.n_values, "cas old")
            new = _int_in(value[1], self.n_values, "cas new")
            return self.CAS, old * self.n_values + new
        try:
            return super().invoke_op(f, key, value)
        except IngestError:
            raise IngestError(f"{self.spec.name}: unknown op :f :{f} "
                              "(read/write/cas)") from None

    def resp_of(self, cmd: int, arg: int, value, failed: bool) -> int:
        if cmd == self.CAS:
            return 0 if failed else 1
        return super().resp_of(cmd, arg, value, failed)

    def render_invoke(self, cmd: int, arg: int):
        if cmd == self.CAS:
            return "cas", None, [arg // self.n_values,
                                 arg % self.n_values]
        return super().render_invoke(cmd, arg)

    def render_resp(self, cmd: int, arg: int, resp: int):
        if cmd == self.CAS:
            return ("cas", None,
                    [arg // self.n_values, arg % self.n_values],
                    resp == 0)
        return super().render_resp(cmd, arg, resp)


class KvMap:
    """``get``/``put`` (aliases ``read``/``write``) over a keyed map
    (models/kv.py: put packs ``key * n_values + value``)."""

    GET, PUT = 0, 1
    keyed = True

    def __init__(self, spec):
        self.spec = spec
        self.n_keys = spec.CMDS[self.GET].n_args
        self.n_values = spec.CMDS[self.GET].n_resps

    def invoke_op(self, f: str, key, value) -> Tuple[int, int]:
        k = _int_in(key, self.n_keys, "key")
        if f in ("get", "read"):
            return self.GET, k
        if f in ("put", "write"):
            v = _int_in(value, self.n_values, "put value")
            return self.PUT, k * self.n_values + v
        raise IngestError(f"{self.spec.name}: unknown op :f :{f} "
                          "(get/put)")

    def resp_of(self, cmd: int, arg: int, value, failed: bool) -> int:
        if cmd == self.GET:
            if failed:
                raise IngestError("a get cannot :fail; use :info")
            return _int_in(value, self.n_values, "get result")
        return 0

    def render_invoke(self, cmd: int, arg: int):
        if cmd == self.GET:
            return "get", arg, None
        return "put", arg // self.n_values, arg % self.n_values

    def render_resp(self, cmd: int, arg: int, resp: int):
        if cmd == self.GET:
            return "get", arg, resp, False
        return "put", arg // self.n_values, arg % self.n_values, False


class RangeSetMap:
    """``add``/``remove``/``contains``/``count-below`` over a keyed set
    (models/rangeset.py).  The key is the set element; ``count-below``'s
    key may equal ``n_keys`` (count the whole set).  ``add``/``remove``
    ride jepsen's ``:fail`` convention (resp 0 = no-op), queries carry
    their result in ``:value``."""

    ADD, REMOVE, CONTAINS, COUNT_BELOW = 0, 1, 2, 3
    keyed = True

    def __init__(self, spec):
        self.spec = spec
        self.n_keys = spec.CMDS[self.ADD].n_args

    def invoke_op(self, f: str, key, value) -> Tuple[int, int]:
        if f in ("count-below", "count_below"):
            return self.COUNT_BELOW, _int_in(key, self.n_keys + 1,
                                             "count-below bound")
        k = _int_in(key, self.n_keys, "key")
        if f == "add":
            return self.ADD, k
        if f == "remove":
            return self.REMOVE, k
        if f == "contains":
            return self.CONTAINS, k
        raise IngestError(f"{self.spec.name}: unknown op :f :{f} "
                          "(add/remove/contains/count-below)")

    def resp_of(self, cmd: int, arg: int, value, failed: bool) -> int:
        if cmd in (self.ADD, self.REMOVE):
            return 0 if failed else 1
        if failed:
            raise IngestError("a query cannot :fail (no precondition); "
                              "use :info for unknown")
        if cmd == self.CONTAINS:
            return _int_in(value, 2, "contains result")
        return _int_in(value, self.n_keys + 1, "count-below result")

    def render_invoke(self, cmd: int, arg: int):
        f = ("add", "remove", "contains", "count-below")[cmd]
        return f, arg, None

    def render_resp(self, cmd: int, arg: int, resp: int):
        if cmd in (self.ADD, self.REMOVE):
            return (("add", "remove")[cmd], arg, None, resp == 0)
        f = "contains" if cmd == self.CONTAINS else "count-below"
        return f, arg, resp, False


class SemaphoreMap:
    """``acquire``/``release``/``available`` (models/lock.py).  Unkeyed
    and argless; acquire/release ride ``:fail`` for the refused case
    (resp 0), ``available`` carries its count in ``:value``."""

    ACQUIRE, RELEASE, AVAILABLE = 0, 1, 2
    keyed = False

    def __init__(self, spec):
        self.spec = spec
        self.permits = spec.CMDS[self.AVAILABLE].n_resps - 1

    def invoke_op(self, f: str, key, value) -> Tuple[int, int]:
        if f == "acquire":
            return self.ACQUIRE, 0
        if f == "release":
            return self.RELEASE, 0
        if f == "available":
            return self.AVAILABLE, 0
        raise IngestError(f"{self.spec.name}: unknown op :f :{f} "
                          "(acquire/release/available)")

    def resp_of(self, cmd: int, arg: int, value, failed: bool) -> int:
        if cmd == self.AVAILABLE:
            if failed:
                raise IngestError("available cannot :fail; use :info")
            return _int_in(value, self.permits + 1, "available count")
        return 0 if failed else 1

    def render_invoke(self, cmd: int, arg: int):
        return ("acquire", "release", "available")[cmd], None, None

    def render_resp(self, cmd: int, arg: int, resp: int):
        if cmd == self.AVAILABLE:
            return "available", None, resp, False
        return (("acquire", "release")[cmd], None, None, resp == 0)


class TxnMap:
    """``read``/``write``/``copy`` over keyed cells (models/txn.py).
    ``read cell``/``write cell v`` are the multi-register shape; ``copy``
    keys by its SOURCE cell and carries the destination in ``:value`` —
    mirroring the spec's (deliberately unsound) src-keyed projection, so
    an ingested trace round-trips through the same packing the refusal
    pins exercise."""

    READ, WRITE, COPY = 0, 1, 2
    keyed = True

    def __init__(self, spec):
        self.spec = spec
        self.n_cells = spec.n_cells
        self.n_values = spec.n_values

    def invoke_op(self, f: str, key, value) -> Tuple[int, int]:
        cell = _int_in(key, self.n_cells, "cell")
        if f == "read":
            return self.READ, cell
        if f == "write":
            v = _int_in(value, self.n_values, "write value")
            return self.WRITE, self.spec.write_arg(cell, v)
        if f == "copy":
            dst = _int_in(value, self.n_cells, "copy dst")
            if dst == cell:
                raise IngestError(f"copy src and dst must differ, "
                                  f"both {cell}")
            return self.COPY, self.spec.copy_arg(cell, dst)
        raise IngestError(f"{self.spec.name}: unknown op :f :{f} "
                          "(read/write/copy)")

    def resp_of(self, cmd: int, arg: int, value, failed: bool) -> int:
        if cmd == self.READ:
            if failed:
                raise IngestError("a read cannot :fail; use :info")
            return _int_in(value, self.n_values, "read result")
        return 0

    def render_invoke(self, cmd: int, arg: int):
        if cmd == self.READ:
            return "read", arg, None
        if cmd == self.WRITE:
            return "write", arg // self.n_values, arg % self.n_values
        src, dst = self.spec.copy_pair(arg)
        return "copy", src, dst

    def render_resp(self, cmd: int, arg: int, resp: int):
        if cmd == self.READ:
            return "read", arg, resp, False
        if cmd == self.WRITE:
            return ("write", arg // self.n_values,
                    arg % self.n_values, False)
        src, dst = self.spec.copy_pair(arg)
        return "copy", src, dst, False


# model name -> map factory; multireg/multicas reuse the kv shape?  No:
# their alphabets differ — only the externally-common vocabularies are
# mapped.  Unmapped models are refused with this table in the error.
SPEC_MAPS = {
    "register": RegisterMap,
    "cas": CasMap,
    "kv": KvMap,
    "rangeset": RangeSetMap,
    "semaphore": SemaphoreMap,
    "txn": TxnMap,
}


def spec_map_for(model: str, spec):
    factory = SPEC_MAPS.get(model)
    if factory is None:
        raise IngestError(
            f"no ingest spec map for model {model!r}; one of "
            f"{sorted(SPEC_MAPS)}")
    return factory(spec)
