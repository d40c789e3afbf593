"""One run of one cell: set-up, the measured window, the check, the result.

The window serves requests (or count samples) of one client in a closed
loop until ``seconds`` of request time have passed; the request in flight
then completes and counts. Each request's wall is the host clock around the
program's entry point and a ``torch.cuda.synchronize()``. The next request
is prepared between two requests, off the clock. With ``trace`` the window
runs under ``torch.profiler`` and the per-layer metrics are reported; else
the end-to-end ones. After the window the device's peak memory over the
window is read, the program's state dropped, and what the program answered held against the
plain reference (``correct``)."""

from __future__ import annotations

import contextlib
import gc
import json
import sys
import time
import traceback
from dataclasses import dataclass, field

from . import spec, trace as tracing

FORBIDDEN = {"jax", "jaxlib", "flax", "barcoder_tpu"}


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


class Spans:
    """The collector handed to the program as ``phases``: the program's
    ``Phases`` interface (``phase``, ``count``, ``summary``) by duck typing,
    each phase also a profiler span when tracing."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.timings: dict = {}
        self.counters: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with tracing.annotate(self.traced, name):
                yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0

    def count(self, name: str, value) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def summary(self) -> dict:
        return {"timings_s": dict(self.timings), "counters": dict(self.counters), "rates": {}}


@dataclass
class Item:
    """One request (or sample) of the window."""

    wall_s: float
    spans: dict
    work: dict
    busy_s: float | None = None  # device busy time inside it, when traced


@dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    unit: str
    items: list = field(default_factory=list)
    trace: object = None  # trace.Trace when traced
    card: dict = field(default_factory=dict)


def card_info(device: str) -> dict:
    """The card's name, and its power limit and clocks as nvidia-smi reads
    them (a card below 700 W runs slower)."""
    if device != "cuda":
        return {"name": "cpu"}
    import subprocess

    import torch

    info = {"name": torch.cuda.get_device_name(0)}
    q = "power.limit,clocks.sm,clocks.max.sm"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30).stdout
        info.update(zip(q.split(","), (s.strip() for s in out.strip().split(","))))
    except (OSError, subprocess.SubprocessError) as e:
        info["nvidia-smi"] = repr(e)
    return info


def _launches() -> tuple:
    mod = sys.modules.get("barcoder_tpu_torch.ops.scan_hits")
    return getattr(mod, "launches", 0), getattr(mod, "matrix_launches", 0)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
        control: bool = False, t0: float | None = None, here=spec.HERE) -> dict:
    """One run of ``cell``; returns the result line's object. ``here`` is
    the folder whose ``drivers/`` and ``metrics/`` hold the cell's driver
    and readers."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    kind = cell.mix["kind"]
    cls = spec.driver(kind, here)
    if cell.chips not in cls.chips:
        raise ValueError(f"cell {cell.name} asks for {cell.chips} card(s); the {kind!r} "
                         f"driver runs on {list(cls.chips)}")
    driver = cls(cell.config, cell.mix, seed, device, cell.chips)
    card = card_info(device)
    log(f"cell {cell.name}, seed {seed}, {seconds} s, trace {int(traced)}; card {card}")
    try:
        driver.setup()
        sync()
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
            # the profiler can miss device events right as it starts
            torch.ones(1, device=device).add_(1)
            sync()
        if cuda:  # the peak reported is the window's, not set-up's
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        launched = _launches()
        items, failed, served, i = [], 0, 0.0, 0
        while served < seconds:
            item = driver.prepare(i)
            spans = Spans(traced)
            with tracing.annotate(traced, driver.unit):
                start = time.perf_counter()
                try:
                    result = driver.serve(item, spans)
                    sync()
                except Exception:
                    traceback.print_exc()
                    failed, result = failed + 1, None
                wall = time.perf_counter() - start
            served += wall
            items.append(Item(wall, dict(spans.timings),
                              driver.record(i, item, result, spans.counters)))
            i += 1
        tr = None
        if prof is not None:
            t_read = time.perf_counter()
            prof.__exit__(None, None, None)
            tr = tracing.Trace(prof, driver.unit, driver.other)
            del prof
            log(f"trace stopped and read in {time.perf_counter() - t_read:.1f} s")
            if len(tr.item_busy_s) == len(items):
                for it, b in zip(items, tr.item_busy_s):
                    it.busy_s = b
            else:
                log(f"the trace holds {len(tr.item_busy_s)} of {len(items)} {driver.unit}s")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        dense, site = (a - b for a, b in zip(_launches(), launched))
        walls = sorted(it.wall_s for it in items)
        log(f"{len(items)} {driver.unit}s in {served:.4f} s, {failed} failed; walls min "
            f"{walls[0]:.4f} median {walls[len(walls) // 2]:.4f} max {walls[-1]:.4f} s; "
            f"scan_hits launches {dense} ({site} in the site engine's matrix_rows mode)")
        driver.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        checks = driver.check(control)
    finally:
        getattr(driver, "close", lambda: None)()

    ctx = Run(setup_s=setup_s, unit=driver.unit, items=items, trace=tr, card=card)
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = spec.reader(m["name"], here)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": card["name"], "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    out = {"correct": failed == 0 and passed(checks), "attempted": len(items),
           "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    out["checks"] = checks
    return out


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["at_most"] if "at_most" in c else c["value"] >= c["at_least"]
               for c in checks.values())


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the run may not hold,
    compared whole (``barcoder_tpu_torch`` is not ``barcoder_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def main(args, t0: float) -> int:
    import torch

    c = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        log(f"cell {c.name} needs {c.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    result = run(c, args.seed, args.seconds, bool(args.trace), "cuda", args.control, t0)
    bad = forbidden_modules()
    if bad:
        log(f"the run imported {bad}: no result")
        return 3
    for name, chk in result["checks"].items():
        limit = f"at most {chk['at_most']}" if "at_most" in chk else f"at least {chk['at_least']}"
        log(f"check {name} {chk['value']} {limit}")
    print(json.dumps(result), flush=True)
    return 0
