"""Spans: named intervals of the program's work, always on, kept in a ring.

``with span('train.forward', device=True): ...`` records, for the thread
that drives the card:

* the name and the parent (the sequence number of the span that was open
  when this one began, or None);
* host start and end from ``time.perf_counter_ns()``;
* with ``device=True``, a CUDA event pair around the body on the stream
  that is current when the span begins, so its device time is the
  stream's time between them (idle while the stream waited for the host to
  launch included).  No events are recorded on the CPU (CUDA not
  initialised) or while the current stream is being captured into a CUDA
  graph;
* whether the profiler was on when it began.  While it is on, the span
  also opens ``torch.profiler.record_function(name)``, so it appears in the
  profiler's trace (``--profile`` writes it as a Chrome trace).

The records go into a fixed ring (:data:`RING`, 65,536 records) of
preallocated lists: a span makes no record object, only its context
manager, and the CUDA events of a ring slot are made on the slot's first
use and reused when the ring comes round.  Each record carries its
sequence number, so a reader knows which records were overwritten.
:func:`window` picks out the records of the last steps run with the
profiler off; :func:`to_trace_ns` lays a host stamp on the profiler's
clock (Unix-epoch nanoseconds).
"""

import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

RING_SIZE = 65536


def to_trace_ns(t_ns: int) -> int:
    """A ``perf_counter_ns`` stamp as Unix-epoch nanoseconds, the clock of the
    profiler's host events, by the two clocks' offset now: the wall clock is
    slewed against the monotonic one (about 0.1 ms in a quarter of an hour
    has been seen), so an offset read at import would drift."""
    return t_ns + (time.time_ns() - time.perf_counter_ns())


class Record(NamedTuple):
    seq: int
    name: str
    parent: Optional[int]        # seq of the enclosing span
    start_ns: int                # perf_counter_ns
    end_ns: Optional[int]        # None while the span is open
    profiled: bool
    device_ms: Optional[float]   # None without device stamps

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) * 1e-6


def _timing_event():
    return torch.cuda.Event(enable_timing=True)


_STREAMS = {}


def _current_stream():
    """The current CUDA stream, one ``torch.cuda.Stream`` kept per (device,
    handle): ``torch.cuda.current_stream()`` builds a new object each call,
    which costs more than an event record."""
    device = torch._C._cuda_getDevice()
    key = (device, torch._C._cuda_getCurrentRawStream(device))
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.current_stream()
    return stream


class Ring:
    """The records of the last ``size`` spans, in parallel preallocated lists
    indexed by ``seq % size``."""

    def __init__(self, size: int = RING_SIZE):
        self.size = size
        self.next_seq = 0
        self.open = None                 # seq of the innermost open span
        self.seqs = [-1] * size
        self.names = [None] * size
        self.parents = [None] * size
        self.starts = [0] * size
        self.ends = [None] * size
        self.profiled = [False] * size
        self.timed = [False] * size
        self.events = [None] * size      # (start, end) CUDA events of the slot

    def span(self, name: str, device: bool = False) -> '_Span':
        return _Span(self, name, device)

    def held(self) -> range:
        """The sequence numbers the ring holds, oldest first."""
        return range(max(0, self.next_seq - self.size), self.next_seq)

    def record(self, seq: int) -> Record:
        """The record ``seq`` (held by the ring); its device time waits for its
        end event."""
        i = seq % self.size
        device_ms = None
        if self.timed[i] and self.ends[i] is not None:
            start, end = self.events[i]
            end.synchronize()
            device_ms = start.elapsed_time(end)
        return Record(seq, self.names[i], self.parents[i], self.starts[i], self.ends[i],
                      self.profiled[i], device_ms)

    def window(self, marker: str, n: int):
        """The records of the last ``n`` steps run with the profiler off, each
        step opened by a ``marker`` span: from the first of the last ``n``
        ``marker`` records before the first profiled record (the first that
        follows an unprofiled ``marker`` record) up to that profiled record,
        or up to the newest record where none was profiled.  None where the
        ring no longer holds all ``n`` markers."""
        size, held = self.size, self.held()
        start = next((s for s in held if self.names[s % size] == marker
                      and not self.profiled[s % size]), held.stop)
        end = next((s for s in range(start, held.stop) if self.profiled[s % size]), held.stop)
        markers = [s for s in range(start, end) if self.names[s % size] == marker]
        if n <= 0 or len(markers) < n:
            return None
        return [self.record(s) for s in range(markers[-n], end)]


class _Span:
    __slots__ = ('ring', 'name', 'device', 'seq', 'parent', 'events', 'stream', 'profile_range',
                 'start_ns', 'end_ns')

    def __init__(self, ring, name, device):
        self.ring, self.name, self.device = ring, name, device

    def __enter__(self):
        ring = self.ring
        seq = self.seq = ring.next_seq
        ring.next_seq = seq + 1
        i = seq % ring.size
        self.parent, ring.open = ring.open, seq
        profiled = _profiler._is_profiler_enabled
        self.profile_range = None
        if profiled:
            self.profile_range = torch.profiler.record_function(self.name)
            self.profile_range.__enter__()
        self.events = None
        if (self.device and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            events = ring.events[i]
            if events is None:
                events = ring.events[i] = (_timing_event(), _timing_event())
            self.stream = _current_stream()
            events[0].record(self.stream)
            self.events = events
        ring.seqs[i], ring.names[i], ring.parents[i] = seq, self.name, self.parent
        ring.ends[i], ring.profiled[i], ring.timed[i] = None, profiled, self.events is not None
        self.start_ns = ring.starts[i] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        ring = self.ring
        i = self.seq % ring.size
        if ring.seqs[i] == self.seq:             # not overwritten while open
            if self.events is not None:
                self.events[1].record(self.stream)
            ring.ends[i] = self.end_ns
        ring.open = self.parent
        if self.profile_range is not None:
            self.profile_range.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        """Host seconds from start to end (after the span has closed)."""
        return (self.end_ns - self.start_ns) * 1e-9


RING = Ring()


def span(name: str, device: bool = False) -> _Span:
    """A span of :data:`RING` (the module docstring)."""
    return RING.span(name, device)


def window(marker: str, n: int):
    """:meth:`Ring.window` of :data:`RING`."""
    return RING.window(marker, n)
