"""The program's own spans, read after the window: the spans of the
program's recorder (``barcoder_tpu_torch.utils.profiling``, taken from
``sys.modules`` as the harness takes the kernel's launch counts) that lie
inside one of the traced window's requests or samples. The recorder stamps
them with ``time.time_ns()``, the Unix-epoch clock of the profiler's trace,
so they line up with the trace's requests and idle gaps.

Nothing (``None``) when the run was not traced, when the program has no
recorder, or when the recorder's ring dropped a span that may lie in the
window: a sum over an incomplete window would read low."""

from __future__ import annotations

import bisect
import sys

RECORDER = "barcoder_tpu_torch.utils.profiling"


def window(run):
    """[(item index, span)] of every span inside an item of the traced
    window, or None."""
    tr = run.trace
    rec = sys.modules.get(RECORDER)
    if tr is None or not tr.items or not hasattr(rec, "spans"):
        return None
    spans = rec.spans()
    # the ring drops its oldest spans: a drop missed nothing of the window
    # only if every span it still holds ended before the window began
    if rec.dropped() and (not spans or spans[0].end_ns >= tr.items[0][0]):
        return None
    starts = [a for a, _ in tr.items]
    out = []
    for s in spans:
        k = bisect.bisect_right(starts, s.start_ns) - 1
        if k >= 0 and s.end_ns <= tr.items[k][1]:
            out.append((k, s))
    return out


def ms_per_item(run, name: str):
    """The spans named ``name`` summed per request of the window, in ms;
    None where the window holds none."""
    found = window(run) if run.unit == "request" else None
    if not found:
        return None
    picked = [s for _, s in found if s.name == name]
    if not picked:
        return None
    return sum(s.end_ns - s.start_ns for s in picked) / 1e6 / len(run.trace.items)


def ms_per_mread(run, name: str):
    """The spans named ``name`` summed over the window, in ms per million
    reads counted; None where the window holds none, or where the trace
    missed a sample whose reads the sum would count."""
    found = window(run) if run.unit == "sample" else None
    if found and len(run.trace.items) != len(run.items):
        return None
    reads = sum(it.work.get("reads", 0) for it in run.items)
    picked = [s for _, s in found or () if s.name == name]
    if not picked or not reads:
        return None
    return sum(s.end_ns - s.start_ns for s in picked) / 1e6 * 1e6 / reads

