"""What the benchmark reads from ``torch.profiler``: the device's busy
intervals, the harness's own spans on the same clock, and from them the
busy time inside each request, the device operations that took the most
time and the longest idle gaps with what the host was doing in each.

Every device event counts (kernels, copies, sets), whatever its name; the
device-side shadows of the harness's spans do not, since they span gaps."""

from __future__ import annotations

import bisect
import contextlib

SPAN = "portbench."


def _events(prof):
    """(kind, name, start_ns, end_ns): kind "device" or "span"."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        dev = str(e.device_type()).endswith("CUDA")
        # a span's shadow on the device's timeline bears the span's name
        if dev != name.startswith(SPAN):
            out.append(("device" if dev else "span", name, e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return out


class Busy:
    """The merged, sorted union of (start, end) intervals, queried by
    range."""

    def __init__(self, intervals):
        merged = []
        for a, b in sorted(intervals):
            if merged and a <= merged[-1][1]:
                if b > merged[-1][1]:
                    merged[-1][1] = b
            else:
                merged.append([a, b])
        self.merged = merged
        self.starts = [a for a, _ in merged]

    def _within(self, a: int, b: int):
        k = max(bisect.bisect_right(self.starts, a) - 1, 0)
        while k < len(self.merged) and self.merged[k][0] < b:
            yield self.merged[k]
            k += 1

    def covered(self, a: int, b: int) -> int:
        """Length of [a, b) that the intervals cover."""
        return sum(max(0, min(e, b) - max(s, a)) for s, e in self._within(a, b))

    def gaps(self, a: int, b: int) -> list:
        """The parts of [a, b) that the intervals leave uncovered."""
        out, at = [], a
        for s, e in self._within(a, b):
            if e <= a:
                continue
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if at < b:
            out.append((at, b))
        return out


class Trace:
    """A profiled window read once: ``item`` spans (``portbench.request`` or
    ``portbench.sample``) in order, the device's merged busy intervals, and
    the harness's inner spans; an idle gap in none of those is put down to
    ``other``."""

    def __init__(self, prof, item: str, other: str):
        ev = _events(prof)
        spans = sorted((a, b, n[len(SPAN):]) for k, n, a, b in ev if k == "span")
        self.items = [(a, b) for a, b, n in spans if n == item]
        self.inner = [(a, b, n) for a, b, n in spans if n != item]
        self.inner_starts = [a for a, _, _ in self.inner]
        dev = [(a, b, n) for k, n, a, b in ev if k == "device"]
        self.busy = Busy((a, b) for a, b, _ in dev)
        lo = self.items[0][0] if self.items else 0
        hi = self.items[-1][1] if self.items else 0
        self.item_busy_s = [self.busy.covered(a, b) / 1e9 for a, b in self.items]
        # the window is the request time: what lies between two requests is
        # the harness preparing the next one
        self.window_s = sum(b - a for a, b in self.items) / 1e9
        self.busy_s = sum(self.item_busy_s)
        by_name = {}
        for a, b, n in dev:
            if b > lo and a < hi:
                by_name[n] = by_name.get(n, 0) + (min(b, hi) - max(a, lo))
        self.device_ops = [[n[:120], t / 1e9] for n, t in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
        # each idle stretch cut at the harness's spans, each piece put down to
        # the span it lies in, or to ``other`` outside every span
        pieces = [(g, name) for a, b in self.items for s, e, name in self._segments(a, b, other)
                  for g in self.busy.gaps(s, e)]
        pieces.sort(key=lambda p: p[0][0] - p[0][1])
        self.idle_gaps = [[name, (e - s) / 1e9] for (s, e), name in pieces[:10]]

    def _segments(self, a: int, b: int, other: str) -> list:
        """[a, b) cut into the inner spans inside it and what lies between."""
        out, at = [], a
        k = bisect.bisect_left(self.inner_starts, a)
        for s, e, name in self.inner[k:bisect.bisect_left(self.inner_starts, b, lo=k)]:
            if s > at:
                out.append((at, s, other))
            out.append((max(s, at), min(e, b), name))
            at = max(at, min(e, b))
        if at < b:
            out.append((at, b, other))
        return out


def annotate(on: bool, name: str):
    """A profiler span named ``portbench.<name>`` when tracing, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(SPAN + name)
