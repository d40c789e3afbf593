"""The per-layer metrics read from the program's span recorder
(``portbench/spans.py``): a small traced run of every cell on the CPU
reports each of them that the cell lists, and nothing without a trace or
a recorder; and the program's spans name what the idle device waits on
inside an entry point. The targets and design cells route their scans
through the card engine's code path with its kernel's plain version, as
on the card."""

import sys
from dataclasses import dataclass

import pytest

from portbench import harness, spec
from portbench import spans as program_spans
from portbench import trace as tracing

from .conftest import CELLS, small_cell, small_run


def _engine_on_cpu(monkeypatch):
    from barcoder_tpu_torch.ops.cuda_scan import cuda_scan_contigs
    from barcoder_tpu_torch.pipeline import targets

    def scan_contigs(spacers, contigs, max_mismatches, pam, pam_direction, backend):
        return cuda_scan_contigs(spacers, contigs, max_mismatches, pam, pam_direction,
                                 P=2048, device="cpu")

    monkeypatch.setattr(targets, "scan_contigs", scan_contigs)


def _span_metrics(cell) -> list:
    """The cell's metrics whose readers read the recorder."""
    return [m["name"] for m in cell.per_layer
            if "from portbench import spans" in (spec.HERE / "metrics" /
                                                 f"{m['name']}.py").read_text()]


# the entry points' spans: the other spans split them
ROOTS = ("targets", "design", "count")


def unspanned(run) -> float:
    """The share of the device's idle time inside the program's root spans
    (their union: a ``targets`` inside a ``design`` counts once) that no
    other span of the program covers, in %."""
    found = program_spans.window(run)
    roots = tracing.Busy((s.start_ns, s.end_ns) for _, s in found if s.name in ROOTS)
    inner = tracing.Busy((s.start_ns, s.end_ns) for _, s in found if s.name not in ROOTS)
    idle = bare = 0
    for a, b in roots.merged:
        for s, e in run.trace.busy.gaps(a, b):
            idle += e - s
            bare += e - s - inner.covered(s, e)
    assert idle > 0
    return 100.0 * bare / idle


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_every_span_metric(name, monkeypatch):
    _engine_on_cpu(monkeypatch)
    runs = []

    @dataclass
    class Captured(harness.Run):
        def __post_init__(self):
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Captured)
    cell = small_cell(name)
    want = _span_metrics(cell)
    assert want
    r = small_run(name, seconds=1.0, traced=True, cell=cell)
    assert r["correct"]
    got = r["metrics"]
    assert set(want) <= set(got)
    for m in want:
        assert got[m]["value"] >= 0
    # the spans name most of the idle time inside an entry point even at
    # these sizes, where its fixed set-up weighs more than on the card
    (run,) = runs
    assert unspanned(run) < 25


@pytest.mark.parametrize("name", CELLS)
def test_nothing_to_read_untraced_or_without_a_recorder(name, monkeypatch):
    cell = small_cell(name)
    r = small_run(name, seconds=0.3, traced=False, cell=cell)
    assert not set(_span_metrics(cell)) & set(r["metrics"])
    # a program without the recorder, as before it had one
    rec = sys.modules[program_spans.RECORDER]
    monkeypatch.delattr(rec, "spans")
    r = small_run(name, seconds=0.3, traced=True, cell=cell)
    assert not set(_span_metrics(cell)) & set(r["metrics"])
