"""Rules over the ops a step dispatches (DESIGN §16): the port's twin of
``repro/analysis/jaxpr_audit.py``.

The engine's performance contracts — no parameter-sized concatenate in the
hot step, state updated in place, one point-to-point send per live
schedule slot, the parameters' own dtype on the wire, no host read inside
a step — are each checked here against what a step really ran.  The port
has no jaxpr: ``StepTrace`` is a ``TorchDispatchMode`` that records every
op dispatched around one call of a step, the rules read that record.

What the dispatcher sees and what it does not:

* every aten op, the ``c10d`` collectives (``c10d.send``, ``c10d.recv_``,
  ``c10d.allreduce_``, ...) and what autograd's backward runs (the mode
  is part of the thread-local state the backward threads inherit), so a
  concatenate in a backward or in a checkpointed recompute is recorded;
* not the hand kernels, which are called through ``ctypes``: a trace
  records the delta of every kernel wrapper's ``launches`` counter over
  its window instead, so it names the kernels a step ran;
* not a host sync made outside an op (``torch.cuda.synchronize``, a
  stream's ``synchronize``): those are the AST lint's (``no-host-sync``),
  and on the card ``torch.cuda.set_sync_debug_mode("error")`` around the
  step catches the syncs inside ops that the trace cannot name.

Nothing here is keyed by ``id()``: outputs are remembered by their
storage's address (``untyped_storage().data_ptr()``) and, where a rule
must know whether one is still alive, by a weak reference to that
storage (a view of it keeps it alive; the caching allocator does not).
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .report import Finding, rule

__all__ = [
    "OpRecord", "StepTrace", "kernel_wrappers", "iter_ops", "count_op",
    "max_concat_elems", "fresh_outputs", "storage_ptrs",
    "aliased_param_bytes",
    "no_param_concat", "no_host_callback", "collective_count",
    "wire_dtype", "donation_honored", "HOST_READ_OPS", "CONCAT_OPS",
]

# ops that hand a device value to the host (the traced twin of the
# reference's HOST_CALLBACK_PRIMITIVES): a scalar read, a comparison whose
# answer is a Python bool, a nonzero whose size the host must learn
HOST_READ_OPS = frozenset({
    "aten._local_scalar_dense", "aten.item", "aten.is_nonzero",
    "aten.equal", "aten.nonzero",
})
COPY_OPS = frozenset({"aten.copy_", "aten._to_copy", "aten._copy_from"})
CONCAT_OPS = frozenset({"aten.cat", "aten._cat", "aten.stack",
                        "aten.concat", "aten.concatenate"})
SEND_OP = "c10d.send"


class OpRecord(NamedTuple):
    """One dispatched op.  ``outs``: (shape, dtype, device type) of each
    tensor output; ``wire``: for a ``c10d`` op, (dtype, element count) of
    each tensor it was given; ``host_read``: the op hands a value of the
    step's device to the host; ``ptrs``: the storage addresses of the
    tensor outputs (not part of the signature: they vary call to call)."""
    name: str
    outs: Tuple[Tuple[Tuple[int, ...], str, str], ...]
    wire: Tuple[Tuple[str, int], ...]
    host_read: bool
    ptrs: Tuple[int, ...]

    @property
    def packet(self) -> str:
        """The op's name without its overload (``aten.cat``)."""
        return self.name.rsplit(".", 1)[0]


def kernel_wrappers() -> dict:
    """Name -> wrapper of every hand kernel; each wrapper's ``launches``
    adds one where it launches its kernel."""
    from ..kernels import decode_attention, flash_attention, gossip_mix, reorth
    fns = (decode_attention.paged_decode_attention_fwd,
           gossip_mix.gossip_mix_update_flat, gossip_mix.gossip_mix_update,
           reorth.reorth_dots, reorth.reorth_axpy,
           flash_attention.flash_attention_fwd)
    return {f.__name__: f for f in fns}


_NAMES: dict = {}          # op overload -> "aten.cat.default"


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _ptr(t: torch.Tensor) -> int:
    """``t``'s storage address (views share their base's); 0 for a tensor
    with no storage of its own (meta, sparse)."""
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return 0


def storage_ptrs(tensors: Iterable[torch.Tensor]) -> set:
    """The storage addresses of ``tensors``."""
    return {_ptr(t) for t in tensors if isinstance(t, torch.Tensor)}


class StepTrace(TorchDispatchMode):
    """Record every op dispatched inside the ``with`` block.

    ``device``: the device the step runs on; a host read is an op of
    ``HOST_READ_OPS`` on a tensor of that device, or a copy from a non-CPU
    tensor into host memory that the host waits for (a non-blocking copy
    into pinned memory, the gloo transport's staging, is not one).  On the
    CPU every read of ``HOST_READ_OPS`` counts: the same code runs on the
    card.  ``watch_bytes``: fresh outputs (not written into an input) of
    at least that many bytes are also listed in ``large``, each with a
    weak reference to its storage, so ``fresh_outputs`` can count them
    and ``donation_honored`` can tell a temporary from a buffer that
    outlived the step.

    After the block: ``ops`` (``OpRecord`` list), ``launches`` (kernel
    name -> launches in the block, the nonzero ones), ``signature()``."""

    def __init__(self, device=None, watch_bytes: Optional[int] = None):
        super().__init__()
        self.device_type = torch.device(device or "cpu").type
        self.watch_bytes = watch_bytes
        self.ops: List[OpRecord] = []
        self.large: List[Tuple[str, int, int, StorageWeakRef]] = []
        self.launches: dict = {}

    def __enter__(self):
        self._kernels = kernel_wrappers()
        self._before = {k: f.launches for k, f in self._kernels.items()}
        return super().__enter__()

    def __exit__(self, exc_type, exc, tb):
        out = super().__exit__(exc_type, exc, tb)
        self.launches = {k: f.launches - self._before[k]
                         for k, f in self._kernels.items()
                         if f.launches != self._before[k]}
        return out

    def _host_read(self, packet, args, kwargs, outs) -> bool:
        if packet in HOST_READ_OPS:
            ins = _tensors((args, kwargs))
            return any(t.device.type == self.device_type for t in ins)
        if packet not in COPY_OPS:
            return False
        src = args[1] if packet == "aten.copy_" else args[0]
        if not isinstance(src, torch.Tensor) or src.device.type == "cpu":
            return False
        dst = [t for t in outs if t.device.type == "cpu"]
        if not dst:
            return False
        non_blocking = kwargs.get("non_blocking", False) or (
            packet == "aten.copy_" and len(args) > 2 and bool(args[2]))
        return not (non_blocking and all(t.is_pinned() for t in dst))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        result = func(*args, **kwargs)
        name = _NAMES.get(func)
        if name is None:
            name = _NAMES[func] = str(func)
        packet = name.rsplit(".", 1)[0]
        outs = ([result] if isinstance(result, torch.Tensor)
                else _tensors(result))
        wire = ()
        if func.namespace == "c10d":
            wire = tuple((_dtype(t), t.numel())
                         for t in _tensors((args, kwargs)))
        self.ops.append(OpRecord(
            name,
            tuple((tuple(t.shape), _dtype(t), t.device.type) for t in outs),
            wire, self._host_read(packet, args, kwargs, outs),
            tuple(_ptr(t) for t in outs)))
        if self.watch_bytes is not None:
            ins = None
            for t in outs:
                if _nbytes(t) < self.watch_bytes:
                    continue
                if ins is None:     # an in-place or out= op made nothing
                    ins = storage_ptrs(_tensors((args, kwargs)))
                ptr = _ptr(t)
                if ptr and ptr not in ins:      # 0: no storage to watch
                    self.large.append((name, _nbytes(t), ptr, StorageWeakRef(
                        t.untyped_storage())))
        return result

    def signature(self) -> tuple:
        """What a warm call must repeat: each op with its outputs' shapes,
        dtypes and devices (and a collective's wire), then the kernels
        launched."""
        return (tuple((o.name, o.outs, o.wire) for o in self.ops),
                tuple(sorted(self.launches.items())))


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

def iter_ops(trace: StepTrace):
    """Every recorded op of ``trace``, in dispatch order."""
    yield from trace.ops


def count_op(trace: StepTrace, name: str) -> int:
    """Ops named ``name``: a packet (``c10d.send``, any overload) or a full
    overload name (``aten.cat.default``)."""
    return sum(1 for o in trace.ops if name in (o.name, o.packet))


def max_concat_elems(trace: StepTrace) -> int:
    """Largest ``aten.cat`` / ``aten.stack`` output (in elements) in the
    trace; 0 for a trace with no op at all.

    The flat engine's contract is that this stays far below the parameter
    count inside a train step: a step stacks a handful of per-learner
    scalars and builds its small coefficient tables, but nothing
    parameter-sized — the flatten happened once, at init."""
    worst = 0
    for o in trace.ops:
        if o.packet in CONCAT_OPS:
            for shape, _, _ in o.outs:
                n = 1
                for d in shape:
                    n *= d
                worst = max(worst, n)
    return worst


def fresh_outputs(trace: StepTrace) -> dict:
    """The outputs of ``watch_bytes`` or more that the step made fresh
    (not written into an input), temporaries included: their count, their
    bytes and the count by op.  Each is a state-sized allocation a
    captured step would have to hold."""
    by_op: dict = {}
    for name, _, _, _ in trace.large:
        by_op[name] = by_op.get(name, 0) + 1
    return {"count": len(trace.large),
            "bytes": sum(n for _, n, _, _ in trace.large), "by_op": by_op}


# ---------------------------------------------------------------------------
# rules over a trace
# ---------------------------------------------------------------------------

@rule("no-param-concat",
      "no concatenate the step dispatches may reach the flat-engine bound "
      "(the per-step re-flatten the flat store removed must not come back)")
def no_param_concat(trace: StepTrace, *, bound: int,
                    target: str) -> List[Finding]:
    """Flag any concatenate output of ``bound`` elements or more (callers
    pass ``n_params // 100``, the reference's margin)."""
    worst = max_concat_elems(trace)
    if worst >= bound:
        return [Finding(
            "no-param-concat", target,
            f"concatenate of {worst} elems >= bound {bound} — a "
            "parameter-sized flatten is back in the hot step")]
    return []


@rule("no-host-callback",
      "a hot-loop step must not hand a device value to the host (a scalar "
      "read, a nonzero, a waited-for copy: a device->host sync per call)")
def no_host_callback(trace: StepTrace, *, target: str) -> List[Finding]:
    """Flag every op of the step that hands a device value to the host
    (``StepTrace``'s ``host_read``: a scalar read, ``nonzero`` without a
    size, a copy to host memory the host waits for)."""
    return [Finding("no-host-callback", target,
                    f"host read {o.name!r} (outputs {list(o.outs)}) inside "
                    "the hot step")
            for o in trace.ops if o.host_read]


@rule("collective-count",
      "point-to-point sends a step == the live GossipSchedule slots the "
      "rank takes part in (padding slots must cost nothing)")
def collective_count(trace: StepTrace, *, expected: int, target: str,
                     op: str = SEND_OP) -> List[Finding]:
    """Count this rank's dispatched sends (``op``) against the live slots
    it takes part in.  Too many (a per-leaf or padded-slot send) and too
    few (a silently skipped mix) are both findings."""
    got = count_op(trace, op)
    if got != expected:
        return [Finding(
            "collective-count", target,
            f"{got} {op!r} ops dispatched, the schedule's live slots take "
            f"{expected}")]
    return []


@rule("wire-dtype",
      "gossip collectives ship the params' own wire dtype — a bf16 model "
      "must not move f32 over the links")
def wire_dtype(trace: StepTrace, *, expected, target: str,
               op: str = SEND_OP) -> List[Finding]:
    want = str(expected).replace("torch.", "")
    size = torch.tensor([], dtype=expected).element_size()
    out = []
    for o in trace.ops:
        if o.packet != op and o.name != op:
            continue
        for dtype, numel in o.wire:
            if dtype != want:
                got = torch.tensor([], dtype=getattr(torch, dtype))
                out.append(Finding(
                    "wire-dtype", target,
                    f"{op} ships {dtype}, wire dtype is {want} — "
                    f"{got.element_size()}x{numel} B on the links instead "
                    f"of {size}x that"))
    return out


def aliased_param_bytes(state: Sequence[torch.Tensor], owned) -> int:
    """Bytes of the ``state`` tensors that live in storage the caller or
    the trainer owned before the step (``owned``: storage addresses, see
    ``storage_ptrs``): the state the step wrote in place."""
    return sum(_nbytes(t) for t in state if _ptr(t) in owned)


@rule("donation-honored",
      "a step writes its model-sized state in place: the stores it returns "
      "live in buffers owned before it, and none it makes outlives it")
def donation_honored(trace: StepTrace, state: Sequence[torch.Tensor],
                     owned, *, min_bytes: int, target: str
                     ) -> List[Finding]:
    """``state``: the step's state tensors after the call (parameter and
    momentum stores, a serve engine's K/V pools); ``owned``: the storage
    addresses the caller and the trainer held before it; ``min_bytes``:
    the state volume that must be written in place.  A shortfall, or an
    output of the trace's ``watch_bytes`` or more whose storage is still
    alive outside what was owned (a state-sized buffer made by the step and
    kept), means state is double-buffered.  Temporaries the step frees
    before it returns are not findings (eager PyTorch makes them on the
    card too); ``fresh_outputs`` counts them."""
    out = []
    got = aliased_param_bytes(state, owned)
    if got < min_bytes:
        fresh = storage_ptrs(t for t in state) - set(owned)
        makers = sorted({o.name for o in trace.ops
                         if fresh.intersection(o.ptrs)})
        out.append(Finding(
            "donation-honored", target,
            f"the step's state holds {got} B in owned buffers, expected >= "
            f"{min_bytes} B — the rest is fresh (made by {makers}): "
            "model-sized state is double-buffered"))
    for name, nbytes, ptr, ref in trace.large:
        if not ref.expired() and ptr not in owned:
            out.append(Finding(
                "donation-honored", target,
                f"{name} made a {nbytes} B buffer that outlives the step "
                "in memory nobody owned — model-sized state is "
                "double-buffered"))
    return out
