"""The port's span recorder (``utils/profiling.py``): ids, parents and
roots across nesting and threads, the ring's bound, the clock it shares
with ``torch.profiler``'s trace, and the spans that the three entry points
(``run_targets`` and its scan engine, ``run_design``, ``run_count``)
record, on the CPU. The program never emits a profiler range of its own."""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch

from barcoder_tpu_torch.core.genome import Genome, contig_from_record
from barcoder_tpu_torch.ops.cuda_scan import cuda_scan_contigs
from barcoder_tpu_torch.pipeline import design as port_design
from barcoder_tpu_torch.pipeline import heuristic_count as thc
from barcoder_tpu_torch.pipeline import targets as port_targets
from barcoder_tpu_torch.seqio.library import BarcodeLibrary
from barcoder_tpu_torch.utils import profiling
from barcoder_tpu_torch.utils.profiling import Phases, span

from .genomes import make_record, plant_guide, random_seq
from .test_heuristic_count import make_barcodes, make_reads, write_reads
from .test_torch_site import site_isolation  # noqa: F401  (autouse)

torch.set_num_threads(1)

TARGET_STAGES = ["prepare", "scan", "annotate", "assemble", "postprocess"]


def since(t0_ns: int) -> list:
    return [s for s in profiling.spans() if s.start_ns >= t0_ns]


def tree(recorded: list, root_name: str):
    """The one span named ``root_name`` among ``recorded`` and the names of
    its descendants, by parent id."""
    (root,) = [s for s in recorded if s.name == root_name and s.parent is None]
    kids = {}
    for s in recorded:
        kids.setdefault(s.parent, []).append(s)
    out, todo = [], [root.id]
    while todo:
        for s in kids.get(todo.pop(), []):
            assert s.root == root.id
            out.append(s)
            todo.append(s.id)
    return root, out


@pytest.fixture(scope="module")
def inputs():
    """A 12 kb circular genome (the port's own Genome) with planted guides
    on both strands, and a library of them plus a duplicate name and a
    non-targeting spacer."""
    rng = np.random.default_rng(11)
    rec = make_record(n=12_000, topology="circular", seed=11, n_genes=6)
    guides = [random_seq(20, rng) for _ in range(5)]
    for k, g in enumerate(guides[:4]):
        plant_guide(rec, g, 900 + 2500 * k, pam="TGG", strand="R" if k % 2 else "F")
    genome = Genome([contig_from_record(rec)], source="synthetic")
    entries = [(f"g{i}", g) for i, g in enumerate(guides)] + [("g0_dup", guides[0])]
    return genome, BarcodeLibrary(entries), guides


def _engine_on_cpu(monkeypatch):
    """The CUDA engine's code path with the kernel's plain version."""
    def scan_contigs(spacers, contigs, max_mismatches, pam, pam_direction, backend):
        return cuda_scan_contigs(spacers, contigs, max_mismatches, pam, pam_direction,
                                 P=2048, device="cpu")

    monkeypatch.setattr(port_targets, "scan_contigs", scan_contigs)


# -- the recorder --------------------------------------------------------------


def test_ids_parents_and_roots_nest():
    with span("a") as a:
        with span("a.b") as b:
            with span("a.b.c") as c:
                pass
        with span("a.d") as d:
            pass
    with span("e") as e:
        pass
    assert a.parent is None and a.root == a.id
    assert (b.parent, b.root) == (a.id, a.id)
    assert (c.parent, c.root) == (b.id, a.id)
    assert (d.parent, d.root) == (a.id, a.id)
    assert e.parent is None and e.root == e.id != a.id
    assert len({a.id, b.id, c.id, d.id, e.id}) == 5
    for s in (a, b, c, d, e):
        assert s.thread == threading.get_ident() and s.start_ns <= s.end_ns
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns
    # the ring holds them in the order they ended
    names = [s.name for s in profiling.spans()[-5:]]
    assert names == ["a.b.c", "a.b", "a.d", "a", "e"]


def test_a_thread_opens_its_own_root():
    seen = {}
    # the four threads are alive together, so none can reuse another's ident
    together = threading.Barrier(4, timeout=30)

    def work(k):
        with span(f"t{k}") as outer:
            together.wait()
            with span(f"t{k}.inner") as inner:
                seen[k] = (outer, inner)

    with span("main") as main:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for k, (outer, inner) in seen.items():
        # a new thread starts outside every span, whatever its starter had open
        assert outer.parent is None and outer.root == outer.id != main.id
        assert (inner.parent, inner.root) == (outer.id, outer.id)
        assert outer.thread == inner.thread != main.thread
    assert len({o.thread for o, _ in seen.values()}) == 4


def test_an_exception_closes_the_span_and_restores_its_parent():
    with span("outer") as outer:
        with pytest.raises(ValueError):
            with span("outer.failing") as failing:
                raise ValueError("boom")
        with span("outer.next") as after:
            pass
    assert failing.end_ns is not None and failing in profiling.spans()
    assert after.parent == outer.id
    with span("fresh") as fresh:
        pass
    assert fresh.parent is None


def test_the_collector_gets_the_span_names_last_part():
    phases = Phases()
    with span("targets.scan", phases) as s:
        time.sleep(0.002)
    assert list(phases.timings) == ["scan"] and phases.timings["scan"] >= 0.002
    assert s.end_ns - s.start_ns >= 2_000_000
    assert phases.summary() == {"timings_s": phases.timings, "counters": {}}
    assert not hasattr(phases, "rate") and not hasattr(phases, "log")


def test_the_ring_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder(maxlen=4))
    for k in range(10):
        with span(f"s{k}"):
            pass
    assert [s.name for s in profiling.spans()] == ["s6", "s7", "s8", "s9"]
    assert profiling.dropped() == 6


def test_dump_spans_writes_the_spans_since_a_start(tmp_path):
    with span("before"):
        pass
    t0 = time.time_ns()
    with span("call") as call:
        with span("call.stage") as stage:
            pass
    path = tmp_path / "spans.json"
    profiling.dump_spans(str(path), since_ns=t0)
    got = json.loads(path.read_text())
    assert [d["name"] for d in got] == ["call.stage", "call"]
    assert got[1] == {"name": "call", "start_ns": call.start_ns, "end_ns": call.end_ns,
                      "id": call.id, "parent": None, "root": call.id,
                      "thread": call.thread}
    assert got[0]["parent"] == call.id and got[0]["start_ns"] == stage.start_ns


def test_spans_share_the_profiler_clock():
    """A span and a profiler range opened at the same point start within
    1 ms: the span's ``time.time_ns()`` is the trace's clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    starts = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(5):
            with span(f"clock{k}") as s, record_function(f"probe.clock{k}"):
                torch.ones(64).sum()
            starts.append(s.start_ns)
    events = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe.clock")}
    assert len(events) == 5
    for k, start in enumerate(starts):
        assert abs(events[f"probe.clock{k}"] - start) < 1_000_000


# -- the entry points ---------------------------------------------------------


class Collector:
    """A collector with the ``Phases`` interface and nothing else."""

    def __init__(self):
        self.timings, self.counters = {}, {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0

    def count(self, name, value):
        self.counters[name] = self.counters.get(name, 0) + value

    def summary(self):
        return {"timings_s": dict(self.timings), "counters": dict(self.counters)}


@pytest.mark.parametrize("engine", ["torch", "cuda-engine-on-cpu"])
def test_run_targets_feeds_a_bare_collector_and_the_recorder(inputs, engine, monkeypatch):
    genome, library, _ = inputs
    if engine != "torch":
        _engine_on_cpu(monkeypatch)
    collector = Collector()
    t0 = time.time_ns()
    result = port_targets.run_targets(library, genome, "NGG", 1, backend="torch",
                                      phases=collector)
    assert sorted(collector.timings) == sorted(TARGET_STAGES)
    assert collector.counters["hits"] > 0
    assert result.stats["profile"] == collector.summary()
    root, inner = tree(since(t0), "targets")
    by_name = {}
    for s in inner:
        by_name.setdefault(s.name, []).append(s)
    assert {f"targets.{n}" for n in TARGET_STAGES} <= set(by_name)
    for n in TARGET_STAGES:
        for s in by_name[f"targets.{n}"]:
            assert s.parent == root.id and root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert by_name["targets.prepare"][0].end_ns <= by_name["targets.scan"][0].start_ns
    assert by_name["targets.scan"][-1].end_ns <= by_name["targets.assemble"][0].start_ns
    assert by_name["targets.assemble"][0].end_ns <= by_name["targets.postprocess"][0].start_ns
    scan_stages = {"scan.prep", "scan.phase1", "scan.phase2"}
    assert (scan_stages <= set(by_name)) == (engine != "torch")
    # a default run fills its own Phases, without the removed rates
    own = port_targets.run_targets(library, genome, "NGG", 1, backend="torch")
    assert set(own.stats["profile"]) == {"timings_s", "counters"}
    assert sorted(own.stats["profile"]["timings_s"]) == sorted(TARGET_STAGES)


@pytest.mark.parametrize("site_mode", ["always", "never"])
def test_the_scan_engine_records_prep_and_both_phases(inputs, site_mode):
    genome, _, guides = inputs
    t0 = time.time_ns()
    with span("caller") as caller:
        (hits,) = cuda_scan_contigs(guides, genome.contigs, 1, "NGG", P=2048, device="cpu",
                                    site_mode=site_mode)
    root, inner = tree(since(t0), "caller")
    assert root is caller and all(s.parent == caller.id for s in inner)
    names = [s.name for s in inner]
    assert sorted(set(names)) == ["scan.phase1", "scan.phase2", "scan.prep"]
    assert names.count("scan.phase1") == names.count("scan.phase2") == 1
    assert len(hits) >= 4
    # the library's prep and the engine's choice, and for the dense engine
    # the scan array's ship as a third
    assert names.count("scan.prep") == (2 if site_mode == "always" else 3)
    (p1,) = [s for s in inner if s.name == "scan.phase1"]
    (p2,) = [s for s in inner if s.name == "scan.phase2"]
    assert max(s.end_ns for s in inner if s.name == "scan.prep") <= p1.start_ns
    assert p1.end_ns <= p2.start_ns
    # the same scan again, from the caches: the same stages
    t1 = time.time_ns()
    cuda_scan_contigs(guides, genome.contigs, 1, "NGG", P=2048, device="cpu",
                      site_mode=site_mode)
    assert [s.name for s in since(t1)] == names


def test_a_pam_past_the_engine_records_no_scan_stage(inputs):
    """A PAM longer than the engine takes routes to the plain torch scan,
    which the engine's spans do not cover."""
    from barcoder_tpu_torch.ops.cuda_scan import MAX_PAM

    genome, _, guides = inputs
    t0 = time.time_ns()
    (hits,) = cuda_scan_contigs(guides, genome.contigs, 1, "N" * (MAX_PAM + 1),
                                P=2048, device="cpu")
    assert len(hits) >= 4
    assert not [s for s in since(t0) if s.name.startswith("scan.")]


def test_run_design_records_its_stages(monkeypatch):
    rec = make_record(n=6000, topology="circular", seed=3, n_genes=4)
    genome = Genome([contig_from_record(rec)], source="synthetic")
    _engine_on_cpu(monkeypatch)
    t0 = time.time_ns()
    final, tr, candidates = port_design.run_design(genome, "NGG", 20, backend="torch")
    root, inner = tree(since(t0), "design")
    assert len(candidates) >= len(final) > 0
    top = {s.name: s for s in inner if s.parent == root.id}
    assert sorted(top) == ["design.enumerate", "design.filter", "targets"]
    assert top["design.enumerate"].end_ns <= top["targets"].start_ns
    assert top["targets"].end_ns <= top["design.filter"].start_ns
    assert {"targets.scan", "scan.phase1", "scan.phase2"} <= {s.name for s in inner}
    # the targets stage's profile keeps its keys, its three old phases among them
    assert set(tr.stats["profile"]) == {"timings_s", "counters"}
    assert {"scan", "annotate", "postprocess"} <= set(tr.stats["profile"]["timings_s"])


def test_run_count_records_its_stages(tmp_path):
    barcodes = make_barcodes(n=30, seed=4)
    reads1, _, _ = make_reads(barcodes, n_reads=3000, seed=5, paired=False)
    f1 = tmp_path / "r1.fastq"
    write_reads(f1, reads1)
    t0 = time.time_ns()
    doc, undoc, total, _ = thc.run_count(set(barcodes), str(f1), chunk_size=1024,
                                         engine="device", device="cpu")
    root, inner = tree(since(t0), "count")
    assert total == 3000
    names = [s.name for s in inner]
    assert set(names) == {"count.discover", "count.read", "count.process", "count.drain"}
    assert all(s.parent == root.id for s in inner)
    # three chunks read and processed, and the read that found the end
    assert names.count("count.process") == 3 and names.count("count.read") == 4
    assert names[0] == "count.discover" and names[-1] == "count.drain"


def test_the_program_emits_no_profiler_event_of_its_own(inputs, monkeypatch, tmp_path):
    """Under torch.profiler, no event bears the name of a span the calls
    recorded: the spans stay out of the trace's busy time."""
    from torch.profiler import ProfilerActivity, profile

    genome, library, _ = inputs
    _engine_on_cpu(monkeypatch)
    barcodes = make_barcodes(n=20, seed=6)
    reads1, _, _ = make_reads(barcodes, n_reads=1500, seed=7, paired=False)
    f1 = tmp_path / "r1.fastq"
    write_reads(f1, reads1)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port_targets.run_targets(library, genome, "NGG", 2, backend="torch")
        port_design.run_design(genome, "NGG", 20, backend="torch")
        thc.run_count(set(barcodes), str(f1), chunk_size=512, engine="device", device="cpu")
    names = {s.name for s in since(t0)}
    assert {"targets", "design", "count", "scan.phase2", "count.process"} <= names
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert events and not events & names
