"""The port's tracer: spans and counters in one place, and the device's
memory.

* :func:`span` marks a layer of the work under a path ``gens/<phase>/<layer>``
  (``gens/step/<phase>`` for the training step's own phases). Off, the
  default, it is one check and a shared object that does nothing. On, it
  records its path, its parent, its thread, its host start and end
  (``perf_counter_ns``) and its device start and end: pooled CUDA events on
  the current stream once CUDA is in use, the host clock before that.
  Each thread keeps its own stack of open spans; a span opened with none
  open on its thread (the K1 splat in autograd's backward thread) takes the
  open phase, the root span of another thread, as its parent. Finished
  spans go to a bounded log that :func:`records` reads; the device times
  are read there, which waits for each span's last event, so nothing on
  the traced path waits.
* While a torch profiler records, each span also opens
  ``record_function(<path>)``: its name sits on the profiler's timeline
  beside the kernels, and a reader of the trace can name the device's idle
  gaps by it.
* Spans are on inside :class:`recording` (``TrainStep(timing=True)`` and
  ``FinetuneStep(timing=True)``) and while a torch profiler records.
  Nothing else turns them on.
* :func:`backward_span` puts a span around a network's backward: it
  opens when the gradient reaches the network's outputs and closes when
  that of its first layer's weight is accumulated (the trained feature
  net's ``gens/backward/features``).
* :func:`count` adds to a counter of one registry. A count given as an
  int is a plain add (the kernels' launches, always on); one given as a
  0-d device tensor (a reduction, made only while :func:`enabled`) waits
  until :func:`counter` reads it.
* :func:`device_memory_stats` reads the caching allocator's usage of a
  CUDA device, and returns None for any other device.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

LOG_SIZE = 1 << 15

_on = 0                       # open recording blocks
_on_lock = threading.Lock()
_phase: Optional["Span"] = None   # the open root span
_local = threading.local()
_log: deque = deque(maxlen=LOG_SIZE)
_seq = itertools.count(1)
_events: List[torch.cuda.Event] = []   # free timing events
_counts: Dict[str, int] = {}
_pending: Dict[str, List[torch.Tensor]] = {}


class _Off:
    """What :func:`span` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def enabled() -> bool:
    """Whether spans record now."""
    return bool(_on) or _profiler._is_profiler_enabled


def span(path: str):
    """``with span("gens/render/sampler"):`` -- a no-op while spans are
    off."""
    if _on or _profiler._is_profiler_enabled:
        return Span(path)
    return _OFF


def _stack() -> List["Span"]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _event() -> torch.cuda.Event:
    try:
        return _events.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class Span:
    """One finished (or open) span. ``parent`` is the enclosing span or
    None for a root; ``seq`` orders finished spans; ``host_ms`` and
    ``device_ms`` are its durations on the two clocks."""

    __slots__ = ("path", "parent", "thread", "seq", "t0", "t1", "_ev0",
                 "_ev1", "_device_ms", "_rf")

    def __init__(self, path: str):
        self.path = path
        self.seq = 0
        self._device_ms = None

    def __enter__(self):
        global _phase
        stack = _stack()
        if stack:
            self.parent = stack[-1]
        else:
            self.parent = _phase
            if _phase is None:
                _phase = self
        self.thread = threading.get_ident()
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.path)
            self._rf.__enter__()
        self._ev0 = self._ev1 = None
        if torch.cuda.is_initialized():
            self._ev0 = _event()
            self._ev0.record()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _phase
        self.t1 = time.perf_counter_ns()
        if self._ev0 is not None:
            self._ev1 = _event()
            self._ev1.record()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _stack().pop()
        if _phase is self:
            _phase = None
        self.seq = next(_seq)
        _log.append(self)
        return False

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def device_ms(self) -> float:
        """Milliseconds between the span's device events (waits for the
        last one); the host clock's where it has none."""
        if self._device_ms is None:
            if self._ev0 is None:
                self._device_ms = self.host_ms
            else:
                self._ev1.synchronize()
                self._device_ms = self._ev0.elapsed_time(self._ev1)
                _events.extend((self._ev0, self._ev1))
                self._ev0 = self._ev1 = None
        return self._device_ms

    @property
    def root(self) -> "Span":
        r = self
        while r.parent is not None:
            r = r.parent
        return r


def records(since: int = 0) -> List[Span]:
    """The finished spans of the log (the newest ``LOG_SIZE``) whose
    ``seq`` is above ``since``, oldest first, their device times read."""
    out = [r for r in list(_log) if r.seq > since]
    for r in out:
        r.device_ms
    return out


class recording:
    """Spans on for the block (``on`` False: the block as it is);
    ``records()`` then gives the spans that finished inside it."""

    def __init__(self, on: bool = True):
        self.on = on
        self.first = self.last = 0

    def __enter__(self):
        global _on
        if self.on:
            with _on_lock:
                _on += 1
            self.first = next(_seq)
        return self

    def __exit__(self, *exc):
        global _on
        if self.on:
            self.last = next(_seq)
            with _on_lock:
                _on -= 1
        return False

    def records(self) -> List[Span]:
        return [r for r in records(self.first) if r.seq < self.last]


def span_ms(spans: List[Span]) -> Dict[str, float]:
    """Device milliseconds by key, summed: a phase of the step
    (``gens/step/<phase>``) under ``<phase>``, any other span under its
    path without ``gens/``."""
    out: Dict[str, float] = {}
    for r in spans:
        key = r.path[len("gens/"):]
        if key.startswith("step/"):
            key = key[len("step/"):]
        out[key] = out.get(key, 0.0) + r.device_ms
    return out


class _OpenOnGrad(torch.autograd.Function):
    """The identity on a network's outputs; its backward, which runs once
    the gradients of all of them have arrived, opens ``span``."""

    @staticmethod
    def forward(ctx, span_, *xs):
        ctx.span = span_
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *grads):
        ctx.span.__enter__()
        ctx.span = None
        return (None,) + grads


def backward_span(path: str, outputs, first_weight: torch.Tensor):
    """``outputs`` (a tuple of a network's outputs) unchanged while spans
    are off or no gradient reaches ``first_weight``. Else the same values
    through an identity whose backward opens a span ``path`` when the
    first gradient reaches the network's outputs; it closes when the
    gradient of ``first_weight``, the network's first layer and so the
    last that its backward reaches, is accumulated. Both ends run on the
    thread that runs the backward (on CUDA autograd's own)."""
    if not (enabled() and torch.is_grad_enabled()
            and first_weight.requires_grad):
        return outputs
    s = Span(path)
    handle = None

    def close(_):
        handle.remove()
        if s.seq == 0 and hasattr(s, "t0"):
            s.__exit__(None, None, None)

    handle = first_weight.register_post_accumulate_grad_hook(close)
    return _OpenOnGrad.apply(s, *outputs)


def count(name: str, n=1) -> None:
    """Add ``n`` (an int, or a 0-d device tensor read later) to the
    counter ``name``."""
    if isinstance(n, torch.Tensor):
        _pending.setdefault(name, []).append(n)
    else:
        _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    """The counter's total; device counts still waiting are read (a
    synchronization where there are any)."""
    pending = _pending.get(name)
    if pending:
        vals = pending[:]
        del pending[:len(vals)]
        _counts[name] = _counts.get(name, 0) + int(torch.stack(vals).sum())
    return _counts.get(name, 0)


def device_memory_stats(device="cuda") -> Optional[Dict[str, float]]:
    """Memory of a CUDA device in GiB: in use, peak in use (since the last
    ``torch.cuda.reset_peak_memory_stats``) and the device's total. None
    for a device that is not CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0)
        / 2 ** 30,
        "peak_bytes_gb": stats.get("allocated_bytes.all.peak", 0) / 2 ** 30,
        "bytes_limit_gb": torch.cuda.get_device_properties(
            device).total_memory / 2 ** 30,
    }
