"""Profiling for the port: the ``Phases`` collector, the span recorder,
``dump_summary`` (a verbatim copy of ``barcoder_tpu.utils.profiling``'s,
held equal to it by tests/test_torch_imports.py) and a ``torch.profiler``
device trace in place of the JAX package's ``jax.profiler`` one. The JAX
package's ``CompileStats`` listens to JAX compile events and has no
counterpart here.

``Phases`` sums a call's phases by name. ``span`` records every stage of
every call, always on, into one bounded in-memory ring: its name, its
start and end in ``time.time_ns()`` nanoseconds (the Unix-epoch clock that
``torch.profiler``'s trace stamps its events on, so a span lines up with
the device's idle gaps), its id, its parent's and its root's ids (one root
per entry-point call) and its thread. A span never waits on the device and
emits no profiler range: it starts and ends where the code already
waits."""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from dataclasses import asdict, dataclass, field

import torch

__all__ = ["Phases", "Span", "device_trace", "dump_spans", "dump_summary", "dropped",
           "span", "spans"]

RING = 1 << 16  # spans the recorder keeps; older ones are dropped and counted


@dataclass
class Phases:
    """Accumulates named phase timings and counters."""

    timings: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + (time.perf_counter() - t0)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def summary(self) -> dict:
        return {"timings_s": dict(self.timings), "counters": dict(self.counters)}


@dataclass(slots=True)
class Span:
    """One recorded stage; ``end_ns`` is None until it ends."""

    name: str
    start_ns: int
    end_ns: int | None
    id: int
    parent: int | None
    root: int
    thread: int


class Recorder:
    """The ring of ended spans, oldest first, and how many fell out of it."""

    def __init__(self, maxlen: int = RING):
        self.ring: collections.deque = collections.deque(maxlen=maxlen)
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, s: Span) -> None:
        with self._lock:
            if len(self.ring) == self.ring.maxlen:
                self.dropped += 1
            self.ring.append(s)

    def spans(self) -> list:
        with self._lock:
            return list(self.ring)


RECORDER = Recorder()
_ids = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar("barcoder_tpu_torch_span",
                                                          default=None)


@contextlib.contextmanager
def span(name: str, phases=None):
    """Record the enclosed stage as a span named ``name`` under the
    innermost open span of this context. With a collector (``phases=``)
    the stage is also its phase named by the span name's last part
    (``targets.scan`` → ``scan``); nothing but ``phase`` is called on it."""
    parent = _current.get()
    sid = next(_ids)
    s = Span(name, time.time_ns(), None, sid, parent.id if parent else None,
             parent.root if parent else sid, threading.get_ident())
    token = _current.set(s)
    try:
        if phases is None:
            yield s
        else:
            with phases.phase(name.rpartition(".")[2]):
                yield s
    finally:
        _current.reset(token)
        s.end_ns = time.time_ns()
        RECORDER.add(s)


def spans() -> list:
    """The recorder's ended spans, in the order they ended."""
    return RECORDER.spans()


def dropped() -> int:
    """How many spans fell out of the ring since the process started."""
    return RECORDER.dropped


def dump_spans(path: str, since_ns: int = 0) -> None:
    """The recorded spans that started at or after ``since_ns`` as JSON."""
    with open(path, "w") as fh:
        json.dump([asdict(s) for s in spans() if s.start_ns >= since_ns], fh, indent=2)


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """torch.profiler trace (CPU, plus CUDA when present) written to
    ``trace_dir/trace.json`` (Chrome trace format) when a directory is
    given; no-op otherwise."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def dump_summary(phases: Phases, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(phases.summary(), fh, indent=2)
