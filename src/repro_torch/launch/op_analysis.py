"""An op log of an eager PyTorch run, and its flops, bytes and collectives.

The port's counterpart of the JAX package's ``launch/hlo_analysis.py``.
PyTorch has no HLO to parse, so the input is an op log: :func:`record`
is a ``TorchDispatchMode`` that logs every aten op run under it (forward,
autograd's backward and remat's recomputation alike), with the shapes and
dtypes of its operands and results, on meta and real tensors alike.  The
port's two other kinds of work enter the log through hooks:
:func:`kernel` (the kernel routers of ``kernels/ops.py``: one entry for
each call of a hand-written kernel, whatever its route) and
:func:`note_collective` (``parallel/collectives.py``: one entry for each
collective over a mesh).

:func:`analyze_ops` reads a log into ``analyze_hlo``'s keys, each rule a
twin of the HLO walker's:

  * flops: ``torch.utils.flop_counter``'s formulas (mm, addmm, bmm,
    baddbmm, convolution, scaled-dot-product attention), where the walker
    counts ``dot``s;
  * HBM bytes: operands plus results of every op.  Eager PyTorch fuses
    nothing, so every op is an HBM boundary: more than XLA's fused count,
    and what the port really moves;
  * views and aliases (the schema says the output aliases an input and
    nothing is written): 0 bytes, as the walker's ``_ALIAS_OPS``;
  * in-place index updates (``index_put_``, ``index_add_``,
    ``index_copy_``, ``scatter*_``): the update and its indices, not the
    buffer, as the walker's ``_sliced_bytes``;
  * hand-written kernels: operands plus results, 0 flops, as a
    ``custom-call``;
  * collectives: each entry's per-device result bytes under the ring
    formula (all-reduce twice), as ``_collective``;
  * loops need no trip counts: eager runs every iteration.

The same recorder tracks peak live bytes, the twin of XLA's
``memory_analysis``: each storage an op makes adds its bytes when it is
made and gives them back when it dies (a weak reference on the storage),
so tensors autograd saves for the backward count while they live.
Storages made before the recorder started (parameters, inputs) are not
counted.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode_stack,
)
from torch.utils.flop_counter import flop_registry

__all__ = ["OpLog", "OpEntry", "record", "kernel", "note_collective",
           "analyze_ops", "active"]

# (shape, dtype) of one operand or result
Operand = Tuple[Tuple[int, ...], torch.dtype]


class OpEntry(NamedTuple):
    """One logged op.  ``kind`` is ``"aten"``, ``"kernel"`` or
    ``"collective"``; ``name`` the aten overload (``aten.mm.default``),
    the kernel's name or the collective's HLO name (``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all``).  ``view``: an
    aten op whose result aliases an operand and writes nothing;
    ``inplace``: one that writes an operand.  ``group`` is a collective's
    group size."""
    kind: str
    name: str
    flops: float
    operands: Tuple[Operand, ...]
    results: Tuple[Operand, ...]
    view: bool = False
    inplace: bool = False
    group: Optional[int] = None


def _nbytes(o: Operand) -> int:
    n = o[1].itemsize
    for d in o[0]:
        n *= d
    return n


@dataclasses.dataclass
class OpLog:
    """What :func:`record` saw: ``ops`` in order, ``peak_bytes`` (the most
    bytes of storages made under the recorder alive at once) and
    ``live_bytes`` (those still alive when it stopped).  ``results`` is
    for the caller (``core/engine.py::bucket_op_log`` keeps the bucket's
    answers there)."""
    ops: List[OpEntry] = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    live_bytes: int = 0
    results: Any = None

    def __len__(self) -> int:
        return len(self.ops)

    def counts(self, kind: Optional[str] = None) -> Dict[str, int]:
        """Entries by name (of ``kind`` only, when given)."""
        out: Dict[str, int] = {}
        for e in self.ops:
            if kind is None or e.kind == kind:
                out[e.name] = out.get(e.name, 0) + 1
        return out


# metadata queries that move no data (FlopCounterMode's list)
_META_OPS = {
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default, torch.ops.prim.layout.default,
    torch.ops.prim.device.default,
}

# in-place updates of a slice of their first operand: (update, indices)
_SLICED = {"index_put_", "_index_put_impl_", "index_add_", "index_copy_",
           "scatter_", "scatter_add_", "scatter_reduce_"}

# ops that allocate and write nothing
_NO_DATA = {"empty", "empty_strided", "new_empty", "new_empty_strided",
            "empty_like"}


def _tensors(args) -> list:
    """The tensors among ``args`` and in its lists and tuples, in order
    (an aten op's arguments nest no deeper)."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def active() -> Optional["_Recorder"]:
    """The innermost recorder on this thread's dispatch-mode stack, if
    any (autograd carries the stack into its backward threads)."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _Recorder):
            return mode
    return None


class _Recorder(TorchDispatchMode):
    def __init__(self, log: OpLog):
        super().__init__()
        self.log = log
        self.paused = 0
        self._live: Dict[int, Tuple[weakref.ref, int]] = {}
        self._names: Dict[Any, Tuple[str, bool, bool]] = {}
        self._interned: Dict[tuple, tuple] = {}
        self._whole: set = set()

    # ---------------------------------------------------------- storages
    def _died(self, key: int) -> None:
        ref = self._live.pop(key, None)
        if ref is not None:
            self.log.live_bytes -= ref[1]

    def track(self, tensors) -> None:
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = (weakref.ref(st, lambda _, k=key: self._died(k)),
                               n)
            log = self.log
            log.live_bytes += n
            if log.live_bytes > log.peak_bytes:
                log.peak_bytes = log.live_bytes

    # ---------------------------------------------------------- entries
    # A log repeats itself (every layer, microbatch and mesh coordinate
    # runs the same ops on the same shapes): equal operand lists and equal
    # entries are kept once, and the log holds references to them.
    def operands(self, tensors) -> Tuple[Operand, ...]:
        out = tuple((tuple(t.shape), t.dtype) for t in tensors
                    if isinstance(t, torch.Tensor))
        return self._interned.setdefault(out, out)

    def append(self, entry: OpEntry) -> None:
        self.log.ops.append(self._interned.setdefault(entry, entry))

    def _describe(self, func) -> Tuple[str, bool, bool]:
        got = self._names.get(func)
        if got is None:
            view = inplace = False
            for r in func._schema.returns:
                if r.alias_info is not None:
                    if r.alias_info.is_write:
                        inplace = True
                    else:
                        view = True
            got = (str(func), view and not inplace, inplace)
            self._names[func] = got
        return got

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused or func in _META_OPS:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func not in self._whole:
            # as FlopCounterMode: an op with a decomposition is logged as
            # the ops it decomposes into
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            self._whole.add(func)       # a property of the op, not the call
        out = func(*args, **kwargs)
        name, view, inplace = self._describe(func)
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        outs = _tensors((out,))
        self.append(OpEntry(
            "aten", name, flops,
            self.operands(_tensors(args) + _tensors(kwargs.values())),
            self.operands(outs), view, inplace))
        if not (view or inplace):
            self.track(outs)
        return out


@contextlib.contextmanager
def record() -> Iterator[OpLog]:
    """Log every aten op run on this thread inside the block (and the
    kernel and collective hooks' entries) into the :class:`OpLog` it
    yields."""
    log = OpLog()
    rec = _Recorder(log)
    try:
        with rec:
            yield log
    finally:
        rec._live.clear()


@contextlib.contextmanager
def kernel(name: str, *inputs: torch.Tensor) -> Iterator[list]:
    """One entry for a hand-written kernel's call: the block runs it (the
    kernel on a CUDA tensor, its plain version on a CPU one) and appends
    its result tensors to the list it yields.  The ops inside the block
    are not logged: the entry stands for them, with the inputs and results
    as its operands, 0 flops.  Nothing is logged without a recorder."""
    outs: list = []
    rec = active()
    if rec is None:
        yield outs
        return
    rec.paused += 1
    try:
        yield outs
    finally:
        rec.paused -= 1
    rec.append(OpEntry("kernel", name, 0.0, rec.operands(inputs),
                       rec.operands(outs)))
    rec.track(outs)


# the collective autograd's backward of each one amounts to
_TRANSPOSE = {"all-reduce": "all-reduce", "all-to-all": "all-to-all",
              "all-gather": "reduce-scatter", "reduce-scatter": "all-gather"}


def note_collective(op: str, source: torch.Tensor, result: torch.Tensor,
                    group: int) -> None:
    """One entry for a collective over a mesh: ``op`` its HLO name,
    ``source`` and ``result`` one device's block before and after it,
    ``group`` the peers a group.  When ``result`` takes part in autograd,
    its backward (the reverse copies between the blocks) is one more
    entry, the transposed collective, whose result is a block of the
    source's shape (``all-gather``'s is a ``reduce-scatter``, and
    ``reduce-scatter``'s an ``all-gather``), logged when the gradient
    reaches ``result``."""
    rec = active()
    if rec is None:
        return
    rec.append(OpEntry("collective", op, 0.0, (), rec.operands([result]),
                       group=group))
    if result.requires_grad:
        back = _TRANSPOSE[op]
        block = rec.operands([source])

        def hook(grad):
            bwd = active()
            if bwd is not None:
                bwd.append(OpEntry("collective", back, 0.0, (), block,
                                   group=group))
        result.register_hook(hook)


def _op_bytes(e: OpEntry) -> float:
    if e.kind == "collective" or e.view:
        return 0.0
    base = e.name.split(".")[1] if e.kind == "aten" else ""
    if base in _NO_DATA:
        return 0.0
    if base in _SLICED:
        # the first operand is the buffer; the last is the update, those
        # between are indices (a scalar-valued scatter has no update)
        rest = e.operands[1:]
        if base.startswith("scatter") and len(rest) == 1:
            return float(_nbytes(rest[0]))
        upd = _nbytes(rest[-1]) if rest else 0
        return 2.0 * upd + sum(_nbytes(o) for o in rest[:-1])
    ins = e.operands[1:] if base == "copy_" else e.operands
    return float(sum(map(_nbytes, ins)) + sum(map(_nbytes, e.results)))


NOTES = (
    "hbm bytes: operands plus results of every op; eager PyTorch fuses "
    "nothing, so every op is an HBM boundary (more than XLA's fused count)",
    "views and aliases (schema alias info, no write) count 0 bytes; "
    "in-place index updates count the update and indices only",
    "collectives: per-device result bytes under the ring formula "
    "(all-reduce 2x); the copies and adds that carry them out are logged "
    "as aten ops and counted in hbm bytes",
)


def analyze_ops(log: OpLog, default_group: int,
                n_devices: int = 1) -> Dict[str, object]:
    """``analyze_hlo``'s keys from an op log.  The log of a run over a
    mesh of logical shards holds every shard's work: ``n_devices`` divides
    its flops and HBM bytes (even sharding); collective entries are
    already per device.  ``default_group`` is the group of a collective
    entry that names none."""
    flops = hbm = 0.0
    coll_bytes: Dict[str, float] = {}
    coll_count: Dict[str, float] = {}
    for e in log.ops:
        if e.kind == "collective":
            g = e.group or default_group
            nbytes = sum(map(_nbytes, e.results))
            wire = nbytes * (g - 1) / max(1, g) * (
                2.0 if e.name == "all-reduce" else 1.0)
            coll_bytes[e.name] = coll_bytes.get(e.name, 0.0) + wire
            coll_count[e.name] = coll_count.get(e.name, 0.0) + 1
            continue
        flops += e.flops
        hbm += _op_bytes(e)
    notes = list(NOTES)
    if n_devices > 1:
        notes.append(f"flops and hbm bytes: the {n_devices} shards' total "
                     f"over {n_devices} (even sharding)")
    return {
        "flops_per_device": flops / n_devices,
        "hbm_bytes_per_device": hbm / n_devices,
        "collective_bytes_by_type": coll_bytes,
        "collective_count_by_type": coll_count,
        "wire_bytes_per_device": float(sum(coll_bytes.values())),
        "notes": notes,
    }
