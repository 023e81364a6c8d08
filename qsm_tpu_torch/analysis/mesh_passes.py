"""Mesh-dispatch passes (pass family *n*; the counterpart of
``qsm_tpu/analysis/mesh_passes.py``, in the port's form): the
sharded-substrate discipline.

The mesh substrate (qsm_tpu_torch/mesh/) has ONE contract: every
consumer rides a lane axis whose width is a *parameter* — the same
program must run on 1, 2 or 8 devices (cards, logical shards of one
card, logical host devices) with bit-identical verdicts
(``mesh/topology.py``'s soundness contract).  Two source-level defect
classes break that contract silently:

* ``QSM-MESH-HARDCODE`` (error) — a literal device count baked into a
  mesh constructor (``make_mesh(8)``, ``make_mesh_2d(2, 4)``,
  ``card_shard_mesh(4)``, ``Mesh(...)`` with an int-literal positional
  arg), or a literal device slot: indexing the device enumeration
  (``local_devices()[i]``, the reference's ``jax.devices()[i]``), a
  ``torch.device("cuda", 0)`` or a ``"cuda:0"`` string.  Either pins
  the program to one topology: the code "works" on the box it was
  written on and misshards — or runs every shard on one card — on
  every other machine.  Device counts and slots must be threaded (a
  parameter, ``mesh_device_count(...)``, the current card); the mesh
  helpers themselves (``mesh/topology.py``) build meshes from
  parameters only and scan clean under this rule.

* ``QSM-MESH-TRANSFER`` (error) — a host read (``.cpu()``,
  ``.item()``, ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize``,
  ``np.asarray`` / ``np.array`` of a tensor) in the SAME function that
  applies a sharding: places lanes or tables per shard, through a
  ``LaneShards`` method (``replicate`` / ``fresh`` / ``step`` /
  ``compact`` on a shard-named handle) or a per-shard ``.to(device)``
  of a tensor already on a device (an index uploaded from the host,
  ``torch.from_numpy(...).to(dev)``, places nothing).  Reading a shard
  back inside the function that places the shards waits for every
  shard's stream there: the sharded round keeps one shard's
  wall-clock while reporting an N-shard mesh.  Scope is the function:
  the sanctioned shape keeps placement and host reads in different
  functions (``mesh/shards.py``'s ``read_status`` and ``chosen``: one
  status read a round, after every shard's launch is enqueued).

Both rules are deliberately structural (AST only, no imports
executed): the parity *behaviour* is gated by tests/test_torch_mesh.py
and the card's sharded run; this family catches the shape of the
regression before any run.

Scan set: qsm_tpu_torch/mesh/ + the sharded consumers (ops/stepper.py,
search/planner.py, serve/batcher.py).
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from .astutil import attr_chain, call_name, parse_module, relpath_of
from .findings import ERROR, Finding

# constructors whose positional device-count arguments must be
# threaded, never literal
_MESH_CTORS = {"make_mesh", "make_mesh_2d", "card_shard_mesh", "Mesh"}

# callables returning the process's device list; subscripting their
# result pins a topology slot (``devices`` is the reference's
# ``jax.devices()``)
_DEVICE_ENUMS = {"local_devices", "devices"}

# the LaneShards methods that place lanes or tables per shard, reached
# through a shard-named handle (``shards.step(...)``,
# ``self._shards.replicate(...)``)
_SHARD_APPLY = {"replicate", "fresh", "step", "compact"}

# host reads: tensor methods, and numpy conversions of a tensor
_HOST_METHODS = {"cpu", "item", "tolist", "numpy"}
_NP_PULLS = {"asarray", "array"}
_NP_MODULES = {"np", "numpy"}

# torch calls that make a tensor from host data: ``.to(dev)`` of one is
# an upload, not a placement
_HOST_UPLOADS = {"from_numpy", "tensor", "as_tensor"}
# tensor methods: an expression ending in one of these is a tensor
_TENSOR_METHODS = {"to", "cpu", "cuda", "clone", "contiguous", "detach",
                   "index_select"}


def _functions(tree: ast.Module) -> Iterator[Tuple[str, ast.AST]]:
    """(qualified name, node) for every function, including methods —
    ``Cls.fn`` for methods, ``fn`` at module level, ``outer.inner``
    for nested defs."""
    def walk(node: ast.AST, prefix: str) -> Iterator[Tuple[str, ast.AST]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{prefix}{child.name}"
                yield name, child
                yield from walk(child, f"{name}.")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)
    yield from walk(tree, "")


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Nodes of ``fn``'s own body, nested function defs excluded — the
    transfer rule is function-scoped, and a nested def is its own
    scope (it is reported under its own qualified name)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


# -- QSM-MESH-HARDCODE --------------------------------------------------------

def _is_int_literal(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, int)
            and not isinstance(node.value, bool))


def _literal_mesh_ctor_arg(node: ast.AST) -> Optional[int]:
    """The first int-literal positional arg of a mesh constructor call,
    or None when the call is clean/not a mesh ctor."""
    if not (isinstance(node, ast.Call)
            and call_name(node) in _MESH_CTORS):
        return None
    for arg in node.args:
        if _is_int_literal(arg):
            return arg.value
    return None


def _literal_slot(node: ast.AST) -> Optional[str]:
    """How a node pins a device slot, or None: an index into the device
    enumeration, ``torch.device("cuda", <int>)``, a ``"cuda:<n>"``
    string."""
    if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Call)
            and call_name(node.value) in _DEVICE_ENUMS):
        return f"{'.'.join(attr_chain(node.value.func))}()[...]"
    if (isinstance(node, ast.Call) and call_name(node) == "device"
            and len(node.args) == 2 and _is_int_literal(node.args[1])
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cuda"):
        return f'torch.device("cuda", {node.args[1].value})'
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        kind, sep, idx = node.value.partition(":")
        if kind == "cuda" and sep and idx.isdigit():
            return repr(node.value)
    return None


# -- QSM-MESH-TRANSFER --------------------------------------------------------

def _is_upload(expr: ast.AST) -> bool:
    """``torch.from_numpy(x)`` / ``torch.tensor(x)``: host data made a
    tensor (its ``.to(dev)`` is an upload)."""
    return isinstance(expr, ast.Call) and call_name(expr) in _HOST_UPLOADS


def _is_dtype_cast(call: ast.Call) -> bool:
    """``x.to(torch.int32)`` / ``x.to(dtype=...)``: a cast, not a move."""
    if any(kw.arg == "dtype" for kw in call.keywords):
        return True
    chain = attr_chain(call.args[0]) if call.args else []
    return len(chain) == 2 and chain[0] == "torch"


def _sharding_apply(node: ast.AST) -> Optional[str]:
    """The spelled name of a sharding application, or None."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return None
    attr = node.func.attr
    chain = attr_chain(node.func.value)
    if attr in _SHARD_APPLY and chain and "shard" in chain[-1].lower():
        return f"{'.'.join(chain)}.{attr}"
    if (attr == "to" and node.args and not _is_upload(node.func.value)
            and not _is_dtype_cast(node)):
        return ".to(device)"
    return None


def _tensor_expr(node: ast.AST, tensors: Set[str]) -> bool:
    """Is this expression a tensor: a ``torch.*`` call, a tensor-method
    call, a subscript of one, or a name bound to one in the function."""
    if isinstance(node, ast.Subscript):
        return _tensor_expr(node.value, tensors)
    if isinstance(node, ast.Name):
        return node.id in tensors
    if isinstance(node, ast.Call):
        chain = attr_chain(node.func)
        if chain and chain[0] == "torch":
            return True
        return (isinstance(node.func, ast.Attribute)
                and node.func.attr in _TENSOR_METHODS)
    return False


def _tensor_names(fn: ast.AST) -> Set[str]:
    """Names the function binds to tensors (assignments, and loop or
    comprehension targets over a list of tensors), to a fixpoint."""
    tensors: Set[str] = set()
    lists: Set[str] = set()

    def is_list(expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in lists
        if isinstance(expr, (ast.ListComp, ast.GeneratorExp)):
            return _tensor_expr(expr.elt, tensors)
        if isinstance(expr, (ast.List, ast.Tuple)):
            return bool(expr.elts) and all(_tensor_expr(e, tensors)
                                           for e in expr.elts)
        return False

    changed = True
    while changed:
        changed = False
        for node in _own_nodes(fn):
            pairs: List[Tuple[ast.AST, ast.AST, bool]] = []
            if isinstance(node, ast.Assign):
                pairs = [(t, node.value, False) for t in node.targets]
            elif isinstance(node, (ast.For, ast.comprehension)):
                pairs = [(node.target, node.iter, True)]
            for tgt, value, over in pairs:
                if not isinstance(tgt, ast.Name):
                    continue
                if over:
                    hit, into = is_list(value), tensors
                elif _tensor_expr(value, tensors):
                    hit, into = True, tensors
                else:
                    hit, into = is_list(value), lists
                if hit and tgt.id not in into:
                    into.add(tgt.id)
                    changed = True
    return tensors


def _host_pull(node: ast.AST, tensors: Set[str]) -> Optional[str]:
    """The spelled name of a host read, or None."""
    if not isinstance(node, ast.Call):
        return None
    chain = attr_chain(node.func)
    if chain[-2:] == ["cuda", "synchronize"]:
        return ".".join(chain)
    if (len(chain) >= 2 and chain[0] in _NP_MODULES
            and chain[-1] in _NP_PULLS and node.args
            and _tensor_expr(node.args[0], tensors)):
        return ".".join(chain)
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in _HOST_METHODS and not node.args):
        return f".{node.func.attr}()"
    return None


def check_mesh_file(path: str, root: Optional[str] = None
                    ) -> List[Finding]:
    tree = parse_module(path)
    relpath = relpath_of(path, root)
    out: List[Finding] = []
    for fn_name, fn in _functions(tree):
        applies: List[Tuple[int, str]] = []
        pulls: List[Tuple[int, str]] = []
        tensors = _tensor_names(fn)
        for node in _own_nodes(fn):
            slot = _literal_slot(node)
            if slot is not None:
                out.append(Finding(
                    ERROR, "QSM-MESH-HARDCODE",
                    f"{relpath}:{fn_name}:{node.lineno}",
                    f"pins a device slot ({slot}) — the same program "
                    "runs every shard on that one device, or fails, on "
                    "any other machine",
                    "build placements through the qsm_tpu_torch.mesh "
                    "helpers (make_mesh / card_shard_mesh / "
                    "batch_sharding) and take the device as a "
                    "parameter (or the current card)"))
            n = _literal_mesh_ctor_arg(node)
            if n is not None:
                out.append(Finding(
                    ERROR, "QSM-MESH-HARDCODE",
                    f"{relpath}:{fn_name}:{node.lineno}",
                    f"hardcodes a device count ({n}) into a mesh "
                    "constructor — the lane axis width must be a "
                    "parameter or the program only runs on one "
                    "topology",
                    "thread the count (make_mesh(n_devices)) or derive "
                    "it (mesh_device_count())"))
            applied = _sharding_apply(node)
            if applied is not None:
                applies.append((node.lineno, applied))
            pull = _host_pull(node, tensors)
            if pull is not None:
                pulls.append((node.lineno, pull))
        if applies and pulls:
            a_line, a_name = min(applies)
            p_line, p_name = min(pulls)
            out.append(Finding(
                ERROR, "QSM-MESH-TRANSFER",
                f"{relpath}:{fn_name}:{p_line}",
                f"host read ({p_name}, line {p_line}) in the same "
                f"function that applies a sharding ({a_name}, line "
                f"{a_line}) — the sharded round waits for every "
                "shard's stream here, keeping one shard's wall-clock",
                "split the function: place the shards in one function "
                "and read the host copy in another, once a round "
                "(mesh/shards.py's read_status / chosen shape)"))
    return out
