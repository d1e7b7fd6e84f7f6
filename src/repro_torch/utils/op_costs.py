"""Counted work of a traced step — FLOPs, bytes accessed and live bytes of
every op PyTorch dispatches: the port's counterpart of XLA's
``cost_analysis()`` and ``memory_analysis()`` together with the JAX
package's ``utils/hlo.py``.

The reference's dry run compiles a step and reads XLA's analyses;
``repro/utils/hlo.py`` parses the compiled module's HLO text for the
bytes its collectives move (``repro/utils/roofline.py`` turns them into
seconds).  Eager PyTorch compiles nothing, so the port has no HLO text to
parse.  :class:`OpCounter` is a ``TorchDispatchMode`` instead: it sees
each op as the step dispatches it — on the card, on the CPU, or on the
``meta`` device, where nothing is allocated or computed, so a step at
production size traces on any host.  Each layer dispatches its own ops,
so nothing is counted once for a loop's many trips (XLA's scan bodies).

Counting rules (each op's work depends only on its shapes, so a step
counts the same on every device):

- **FLOPs.** Products (``aten::mm``, ``bmm``, ``addmm``, ...) follow
  ``torch.utils.flop_counter``'s formulas.  A pointwise op counts one
  FLOP an output element, a reduction one an input element, data
  movement none.
- **Bytes.** The operands' plus the results' ``nbytes``: an eager
  program is unfused, so this is what it moves.  Views (``view``,
  ``reshape`` without a copy, ``t``, ``transpose``, ``expand``,
  ``select``, ``slice``, ``unbind``: every op that mutates nothing and
  returns only its inputs' storage) count none, and ``empty`` writes
  nothing.  An op that overwrites its first operand without reading it
  (``copy_``, ``fill_``, ``zero_``) counts it once; a gather (``index``,
  ``index_select``, ``gather``, ``embedding``) reads only what it
  gathers, and an indexed write (``index_copy_``, ``index_put_``,
  ``index_add_``, ``scatter_``) writes only what it is given.
- **Hand-written kernels.** Their wrappers report the work of their
  grids through :func:`kernel_ran` at each call, on every device (the
  GEMM kernel 2·M·K·N FLOPs, flash by the blocks its grid visits; the
  bytes are each operand read once and the output written once, see
  ``kernels/flash_attention.flash_work``), and the plain version's ops
  run :func:`uncounted`, so nothing is counted twice.
- **The port's operators.** An operator of the ``repro_torch``
  namespace (the GEMM's dispatch, ``repro_torch::gemm``) counts nothing
  itself: the counter runs the operator's Python body
  (:func:`expand_under_counter`) under itself, so the ops it dispatches
  around the kernel (a padding, an alignment copy, a ``torch.matmul``
  where no kernel config fits) count as ops, and the kernel as its
  wrapper reports it.  The operator's work is thus counted once, and as it was
  counted before the dispatch was an operator.  A composite op reaching
  the counter inside such a body (which runs below autograd, where
  nothing has decomposed it) is decomposed under the counter, as
  autograd would have decomposed it outside.
- **Kinds.** Work is also summed by kind (:data:`KINDS`): the two
  kernels, library products, the products inside the attention
  functions (``models/common.py``, marked :func:`counted_as`
  ``attention``, with the gradients autograd derives from them), and
  the rest as ``elementwise``.
- **Live bytes.** Every storage an op (or a kernel) allocates under the
  counter is tracked until it is freed, by storage and not by tensor
  (views share storage), to a peak.  Tensors made before the counter
  started (params, optimizer state, a cache) are its inputs and are not
  in the peak.
- **Collectives.** :data:`COLLECTIVE_KINDS` and the reference's dict
  layout (``{kind: {count, operand_bytes, result_bytes},
  "total_operand_bytes"}``), read from ``_c10d_functional`` ops.  The
  port runs on one card and dispatches none, so the dict holds only the
  zero total.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = [
    "OpCounter",
    "KINDS",
    "expand_under_counter",
    "COLLECTIVE_KINDS",
    "kernel_ran",
    "uncounted",
    "counted_as",
]

KINDS = ("gemm_kernel", "flash_kernel", "matmul", "attention", "elementwise")

COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
#: ``_c10d_functional`` ops by the reference's collective kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_aten = torch.ops.aten
_ALLOC_ONLY = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
               _aten.new_empty_strided}
_WRITE_ONLY_SELF = {_aten.copy_, _aten.fill_, _aten.zero_}
_GATHERS = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding}
_INDEXED_WRITES = {_aten.index_copy_, _aten.index_put_, _aten.index_add_, _aten.scatter_,
                   _aten.scatter_add_, _aten.scatter_reduce_, _aten._index_put_impl_}
_REDUCTIONS = {_aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min,
               _aten.argmax, _aten.argmin, _aten.logsumexp, _aten._softmax,
               _aten._log_softmax, _aten._softmax_backward_data,
               _aten._log_softmax_backward_data, _aten.cumsum, _aten.topk, _aten.sort,
               _aten.norm, _aten.linalg_vector_norm, _aten.var_mean}

#: the counters in force, innermost last (kernel reports reach them all)
_ACTIVE: list["OpCounter"] = []
_SCOPE = threading.local()
#: the port's operators (``repro_torch::*`` overloads) -> the Python body a
#: counter runs in their place
_BODIES: dict = {}


def _numel(ts) -> int:
    return max((t.numel() for t in ts), default=0)


class OpCounter(TorchDispatchMode):
    """Counts the work of everything dispatched inside ``with OpCounter()
    as c:`` (see the module docstring): ``c.flops``, ``c.bytes``,
    ``c.by_kind``, ``c.kernel_launches`` (``(kind, dims)`` -> calls the
    kernel wrappers reported), ``c.peak_bytes`` (live bytes allocated
    inside, at their most) and ``c.collectives()``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_kind = {k: {"count": 0, "flops": 0, "bytes": 0} for k in KINDS}
        self.kernel_launches: collections.Counter = collections.Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._coll = {}
        self._storages: dict[int, weakref.ref] = {}
        self._suppress = 0
        self._in_body = 0  # inside a port operator's body
        self._memo: dict = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- results ----------------------------------------------------------------
    def collectives(self) -> dict:
        out = {k: dict(v) for k, v in self._coll.items()}
        out["total_operand_bytes"] = sum(v["operand_bytes"] for v in self._coll.values())
        return out

    # -- counting -----------------------------------------------------------------
    def add(self, kind: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        d = self.by_kind[kind]
        d["count"] += 1
        d["flops"] += flops
        d["bytes"] += nbytes

    def add_kernel(self, kind: str, dims: tuple, flops: int, nbytes: int,
                   out: torch.Tensor) -> None:
        """One call of a hand-written kernel's wrapper, reporting its grid's
        work; ``out`` is its result, tracked as the kernel's allocation."""
        self.kernel_launches[(kind, dims)] += 1
        self.add(kind + "_kernel", flops, nbytes)
        self._track(out)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = weakref.ref(st, functools.partial(self._freed, key, n))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed(self, key: int, n: int, _ref) -> None:
        self._storages.pop(key, None)
        self.live_bytes -= n

    @contextlib.contextmanager
    def _again(self):
        """This counter in force again inside its own handler (one entry
        in the counters in force all the same)."""
        TorchDispatchMode.__enter__(self)
        try:
            yield
        finally:
            TorchDispatchMode.__exit__(self, None, None, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        body = _BODIES.get(func)
        if body is None and self._in_body and _composite(func):
            body = func.decompose
        if body is not None:
            self._in_body += 1
            try:
                with self._again():
                    return body(*args, **kwargs)
            finally:
                self._in_body -= 1
        try:
            key = (func, _key(args), _key(kwargs))
        except _NoKey:
            key = None
        spec = self._memo.get(key) if key is not None else None
        ins = _flat(args, kwargs)
        if spec is not None:
            out = _rebuild(spec)
        else:
            out = func(*args, **kwargs)
            if key is not None and not _info(func)[1]:
                spec = _spec(out, ins)
                if spec is not None:
                    self._memo[key] = spec
        if not self._suppress:
            self._count(func, args, kwargs, ins, out)
        return out

    def _count(self, func, args, kwargs, ins, out) -> None:
        packet, mutable, rule, coll = _info(func)
        outs = _flat(out)
        in_st = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in in_st]
        for t in fresh:
            self._track(t)
        if coll is not None:
            self._collective(coll, ins, outs)
        if not fresh and not mutable:
            return  # a view (or an op that hands back its input): no work
        kind = "elementwise"
        if rule == "product":
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            kind = "attention" if _attention_product() else "matmul"
        elif rule == "pointwise":
            flops = _numel(outs)
        elif rule == "reduction":
            flops = _numel(ins[:1])
        else:
            flops = 0
        self.add(kind, flops, _bytes(packet, ins, outs))

    def _collective(self, kind: str, ins, outs) -> None:
        st = self._coll.setdefault(kind, {"count": 0, "operand_bytes": 0, "result_bytes": 0})
        st["count"] += 1
        st["operand_bytes"] += sum(t.nbytes for t in ins)
        st["result_bytes"] += sum(t.nbytes for t in outs)


_INFO: dict = {}
_COMPOSITE: dict = {}


def _composite(func) -> bool:
    """Whether an op overload has a ``CompositeImplicitAutograd`` kernel
    (one autograd would have decomposed), worked out once."""
    yes = _COMPOSITE.get(func)
    if yes is None:
        yes = _COMPOSITE[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
    return yes


def _info(func) -> tuple:
    """``(packet, mutates, flop rule, collective kind)`` of an op overload,
    worked out once."""
    info = _INFO.get(func)
    if info is None:
        packet = func._overloadpacket
        if packet in flop_registry:
            rule = "product"
        elif torch.Tag.pointwise in func.tags:
            rule = "pointwise"
        elif packet in _REDUCTIONS:
            rule = "reduction"
        else:
            rule = None
        coll = _COLLECTIVE_OPS.get(packet.__name__) if func.namespace == "_c10d_functional" \
            else None
        info = _INFO[func] = (packet, func._schema.is_mutable, rule, coll)
    return info


class _NoKey(Exception):
    pass


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
            torch.memory_format)


def _key(x):
    """A hashable key of an op's arguments when every tensor among them
    lies on ``meta``: a tensor by its type, shape and strides (what a
    fresh result's metadata follows), anything else by its type and
    value.  Raises ``_NoKey`` otherwise."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NoKey
        return (x.dtype, x.shape, x.stride())
    if isinstance(x, (list, tuple)):
        return tuple(_key(y) for y in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    if isinstance(x, _SCALARS):
        return (type(x), x)
    raise _NoKey


def _natural_nbytes(t: torch.Tensor) -> int:
    if t.numel() == 0:
        return 0
    return (1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))) * t.element_size()


def _spec(out, ins: list):
    """How to make ``out`` again without running its meta kernel — when
    every result is a fresh ``meta`` tensor of its own, in a storage
    ``torch.empty_strided`` would allocate; else None.  Meta kernels are
    mostly Python and slow, and a step repeats a few shapes many times:
    the trace reuses each op's result metadata for equal inputs."""
    outs = [out] if isinstance(out, torch.Tensor) else out
    if not isinstance(outs, (list, tuple)) or not outs or \
            not all(isinstance(t, torch.Tensor) and t.device.type == "meta" for t in outs):
        return None
    taken = {id(t.untyped_storage()) for t in ins}
    specs = []
    for t in outs:
        st = t.untyped_storage()
        if id(st) in taken or t.storage_offset() or st.nbytes() != _natural_nbytes(t):
            return None
        taken.add(id(st))
        specs.append((tuple(t.shape), t.stride(), t.dtype))
    return (isinstance(out, torch.Tensor), type(out), tuple(specs))


def _rebuild(spec):
    single, kind, specs = spec
    outs = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
            for shape, stride, dtype in specs]
    return outs[0] if single else kind(outs)


def _flat(*trees) -> list:
    """The tensors in an op's (nested) arguments or results."""
    out = []
    for x in trees:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_flat(*x))
        elif isinstance(x, dict):
            out.extend(_flat(*x.values()))
    return out


def _bytes(packet, ins: list, outs: list) -> int:
    if packet in _ALLOC_ONLY:
        return 0
    rest = sum(t.nbytes for t in ins[1:])
    if packet in _WRITE_ONLY_SELF:  # the first operand is written, never read
        return rest + ins[0].nbytes
    if packet in _GATHERS:  # indices read; the gathered elements read and written
        return rest + 2 * sum(t.nbytes for t in outs)
    if packet in _INDEXED_WRITES:  # indices and values read; the values written
        return rest + ins[-1].nbytes
    return sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)


# -- the kernels' reports ---------------------------------------------------------


def expand_under_counter(op, body) -> None:
    """Register ``body``, the Python function the port's operator ``op``
    (an overload) runs: a counter runs it under itself in the operator's
    place (see the module docstring)."""
    _BODIES[op] = body


def kernel_ran(kind: str, dims: tuple, flops: int, nbytes: int, out: torch.Tensor) -> None:
    """A hand-written kernel's wrapper ran (``kind`` ``gemm`` or ``flash``,
    ``dims`` its launch key) and did ``flops`` and ``nbytes`` of work into
    ``out``: reported to every counter in force, and nothing otherwise."""
    for c in _ACTIVE:
        c.add_kernel(kind, dims, flops, nbytes, out)


class uncounted:
    """Inside the block no counter counts or tracks anything: a kernel's
    plain version runs here, and its wrapper reports the kernel's work."""

    __slots__ = ("_on",)

    def __enter__(self):
        self._on = list(_ACTIVE)
        for c in self._on:
            c._suppress += 1

    def __exit__(self, *exc):
        for c in self._on:
            c._suppress -= 1


def _scope() -> list:
    stack = getattr(_SCOPE, "stack", None)
    if stack is None:
        stack = _SCOPE.stack = []
    return stack


def _attention_product() -> bool:
    """A product dispatched inside an attention function, or by autograd
    for the gradient of one (its node was tagged when the forward ran)."""
    if _scope():
        return True
    node = torch._C._current_autograd_node()
    return node is not None and node.metadata.get("op_kind") == "attention"


def _tag_graph(root, stop: set, kind: str) -> None:
    """Tag every autograd node from ``root`` back to (not into) the nodes
    in ``stop``: the graph one attention call recorded."""
    seen, todo = set(), [root]
    while todo:
        node = todo.pop()
        if node is None or node in stop or node in seen:
            continue
        seen.add(node)
        if not hasattr(node, "variable"):  # AccumulateGrad: a leaf
            node.metadata["op_kind"] = kind
            todo.extend(n for n, _ in node.next_functions)


def counted_as(kind: str):
    """Decorate a function whose products count as ``kind`` (``attention``):
    while a counter is in force, its products — and, through the autograd
    graph it records, their gradients — are summed under that kind."""

    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            stack = _scope()
            stack.append(kind)
            try:
                out = fn(*args, **kwargs)
            finally:
                stack.pop()
            if isinstance(out, torch.Tensor) and out.grad_fn is not None:
                stop = {t.grad_fn for t in _flat(args, kwargs) if t.grad_fn is not None}
                _tag_graph(out.grad_fn, stop, kind)
            return out

        return run

    return deco
