"""Profiling for the port: the JAX-free ``Phases`` collector and
``dump_summary`` of ``barcoder_tpu.utils.profiling``, plus a
``torch.profiler`` device trace in place of the JAX package's
``jax.profiler`` one."""

from __future__ import annotations

import contextlib
import os

import torch

from barcoder_tpu.utils.profiling import Phases, dump_summary

__all__ = ["Phases", "device_trace", "dump_summary"]


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
