"""Profiling for the port: the ``Phases`` collector and ``dump_summary``
(verbatim copies of ``barcoder_tpu.utils.profiling``'s, held equal to them
by tests/test_torch_imports.py), plus a ``torch.profiler`` device trace in
place of the JAX package's ``jax.profiler`` one. The JAX package's
``CompileStats`` listens to JAX compile events and has no counterpart here."""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import torch

__all__ = ["Phases", "device_trace", "dump_summary"]


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

    def rate(self, counter: str, phase: str) -> float | None:
        t = self.timings.get(phase)
        c = self.counters.get(counter)
        if not t or c is None:
            return None
        return c / t

    def summary(self) -> dict:
        out = {"timings_s": dict(self.timings), "counters": dict(self.counters)}
        rates = {}
        if "spacer_positions" in self.counters and "scan" in self.timings:
            rates["spacer_positions_per_s"] = self.rate("spacer_positions", "scan")
        if "reads" in self.counters and "count" in self.timings:
            rates["reads_per_s"] = self.rate("reads", "count")
        out["rates"] = rates
        return out

    def log(self, logger) -> None:
        logger.json(self.summary())


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
