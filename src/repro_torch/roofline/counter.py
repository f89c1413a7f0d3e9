"""The counting mode: what one eager step does on a device, op by op.

:class:`OpCounter` is a ``TorchDispatchMode``. Run a step of the port under
it, on the meta device (shapes only, nothing allocated) or on a real one,
and it counts what that step dispatches to ``device``:

- ``flops``: by the dtype the product runs in, from
  ``torch.utils.flop_counter``'s formula registry (matrix products,
  convolutions, attention); elementwise ops count none, as there;
- ``bytes``: each op's operand and result bytes on ``device`` (an operand
  it mutates counts as read and written; 0-dim scalars count none), with
  views and metadata ops counted as zero: the unfused analogue of XLA's "bytes
  accessed", an upper bound on the step's traffic where a fused schedule
  would keep intermediates out of device memory;
- ``kernels``: the calls through ``kernels.ops`` that go to a kernel, each
  counted once, by its ``roofline.kernels`` model (its ``hbm_bytes`` into
  ``bytes``, its ``flops`` as float32); what runs inside such a call is not
  counted again, and on the meta device the call returns an empty output of
  the kernel's shape (:func:`kernel_call`);
- ``collectives``: each ``c10d`` op's kind, bytes and group size, as
  records for ``roofline.hlo.collective_stats``;
- none of the host's own work that a step marks (:func:`host_work`: the
  key derivation of ``utils.prng``), so a run on the CPU counts what a run
  on the card does;
- ``peak_bytes``: the high-water mark of the storages on ``device`` alive
  during the step (views share one), counting the ones :meth:`track` was
  given as alive from the start.

The same step on the meta device and on the card gives the same flops,
bytes and kernel counts: they follow from shapes alone.
"""
from __future__ import annotations

import collections
import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.hlo import record_collective

aten = torch.ops.aten

# ops that move no bytes of their own: allocation and metadata
_NO_TRAFFIC = {
    aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
    aten.detach.default, aten.alias.default, aten.lift_fresh.default,
    aten._local_scalar_dense.default, aten.set_.source_Storage_storage_offset,
    aten.resize_.default, aten.resize_as_.default,
}
# c10d ops that carry no data
_NO_WIRE = {"barrier", "monitored_barrier_"}


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors in nested lists, tuples and dicts (a loop, not a recursive
    closure: a closure that calls itself is a reference cycle, which would
    keep every tensor it saw alive until the garbage collector runs)."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts flops by dtype, bytes, kernel calls, collectives and the peak of
    live storages of the ops dispatched to ``device`` (see the module)."""

    def __init__(self, device="meta"):
        super().__init__()
        self.device = torch.device(device).type
        self.flops: collections.Counter = collections.Counter()
        self.bytes = 0
        self.kernels: collections.Counter = collections.Counter()
        self.collectives: list[dict] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._quiet = 0
        self._host = 0

    # ------------------------------------------------------------ storages --
    def _watch(self, t: torch.Tensor) -> None:
        if t.device.type != self.device:
            return
        st = t.untyped_storage()
        key, size = id(st), st.nbytes()
        old = self._live.get(key)
        if old == size:
            return
        if old is None:
            weakref.finalize(st, self._release, key).atexit = False
        self._live[key] = size
        self.live_bytes += size - (old or 0)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def track(self, *trees) -> int:
        """Count the storages of the tensors in ``trees`` (the step's inputs)
        as alive from now on; returns the live bytes."""
        for t in _tensors(trees):
            self._watch(t)
        return self.live_bytes

    # ------------------------------------------------------------- records --
    @property
    def total_flops(self) -> int:
        return sum(self.flops.values())

    def summary(self) -> dict:
        return {"flops": self.total_flops, "flops_by_dtype": dict(self.flops),
                "bytes": self.bytes, "kernels": dict(self.kernels),
                "peak_bytes": self.peak_bytes}

    def add_kernel(self, name: str, model) -> None:
        self.kernels[name] += 1
        self.bytes += model.hbm_bytes
        self.flops["float32"] += model.flops

    # ------------------------------------------------------------ dispatch --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._host:
            return func(*args, **kwargs)
        if not self._quiet and func.overloadpacket not in flop_registry:
            # an op that reaches the mode before its decomposition (matmul,
            # einsum, reshape under inference_mode) counts as the ops it
            # decomposes into, as under autograd
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._watch(t)
        if self._quiet:
            return out
        if func.namespace == "c10d":
            name = func.overloadpacket.__name__
            if name not in _NO_WIRE:
                self.collectives.append(record_collective(name, args))
            return out
        if func.overloadpacket in flop_registry:
            first = next(t for t in _tensors(args) if t.is_floating_point())
            self.flops[str(first.dtype).removeprefix("torch.")] += int(
                flop_registry[func.overloadpacket](*args, **kwargs, out_val=out))
        if func in _NO_TRAFFIC or func.is_view:
            return out
        ins = [t for t in _tensors((args, kwargs)) if self._counts(t)]
        if not func._schema.is_mutable and outs:
            # a reshape that returns its input's storage without being a view
            mine = {t.untyped_storage()._cdata for t in ins}
            if all(t.untyped_storage()._cdata in mine for t in outs):
                return out
        self.bytes += sum(_nbytes(t) for t in ins)
        self.bytes += sum(_nbytes(t) for t in outs if self._counts(t))
        return out

    def _counts(self, t: torch.Tensor) -> bool:
        """Whether ``t``'s bytes count: a tensor of one or more dimensions on
        ``device`` (a 0-dim operand is a scalar, which a step keeps on the
        host as often as on the device)."""
        return t.device.type == self.device and t.dim() > 0


def active() -> OpCounter | None:
    """The innermost :class:`OpCounter` in force, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


@contextlib.contextmanager
def kernel_call(name: str, model):
    """Around one call of a kernel through ``kernels.ops``: under an
    :class:`OpCounter` counts the call once by ``model()`` (a
    ``roofline.kernels`` model) and none of the ops inside it."""
    counter = active()
    if counter is None:
        yield
        return
    counter.add_kernel(name, model())
    counter._quiet += 1
    try:
        yield
    finally:
        counter._quiet -= 1


@contextlib.contextmanager
def host_work():
    """Around work on the host's own tensors inside a step (deriving a
    PRNG key): under an :class:`OpCounter` none of it counts, on any
    device."""
    counter = active()
    if counter is None:
        yield
        return
    counter._host += 1
    try:
        yield
    finally:
        counter._host -= 1
