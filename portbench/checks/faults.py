"""The faults a cell can have, planted under the harness's timed path by
``plant(fault, kind, monkeypatch)``; a run with one planted has to come out
not correct. The CPU tests plant them at a small size, the card tests at
the cells' own. No cell spans cards, so none can leave the exchange between
them out."""

from portbench import spec


def state_unchanged(monkeypatch, kind: str) -> None:
    """Each call returns the previous call's answer (the first its own)."""
    driver = spec.driver(kind)
    orig, last = driver.serve, {}

    def stale(self, item, spans):
        fresh = orig(self, item, spans)
        prev, last["r"] = last.get("r"), fresh
        return fresh if prev is None else prev

    monkeypatch.setattr(driver, "serve", stale)


def half_library_left_out(monkeypatch, kind: str) -> None:
    """The scan sees the first half of the spacers only."""
    import barcoder_tpu_torch.pipeline.targets as targets

    orig = targets.scan_contigs

    def half(spacers, *a, **k):
        return orig(spacers[: len(spacers) // 2], *a, **k)

    monkeypatch.setattr(targets, "scan_contigs", half)


def hit_altered(monkeypatch, kind: str) -> None:
    """The first hit of the scan moves one base over."""
    import barcoder_tpu_torch.pipeline.targets as targets

    orig = targets.scan_contigs

    def altered(*a, **k):
        out = orig(*a, **k)
        for h in out:
            if len(h):
                h.pos = h.pos.copy()
                h.pos[0] = h.pos[0] - 1 if h.pos[0] else 1
                break
        return out

    monkeypatch.setattr(targets, "scan_contigs", altered)


def selected_guide_altered(monkeypatch, kind: str) -> None:
    """The first guide the design selects moves one base over."""
    import barcoder_tpu_torch.pipeline.design as design

    orig = design.apply_design_filters

    def altered(*a, **k):
        out = orig(*a, **k).copy()
        out.iloc[0, out.columns.get_loc("offset")] += 1
        return out

    monkeypatch.setattr(design, "apply_design_filters", altered)


def half_reads_left_out(monkeypatch, kind: str) -> None:
    """Each batch of reads is matched for its first half only."""
    from barcoder_tpu_torch.pipeline import heuristic_count as hc

    orig = hc.VectorCounter.process_matrices

    def half(self, m1, m2):
        cut = (lambda m: None if m is None else m[: len(m) // 2])
        return orig(self, cut(m1), cut(m2))

    monkeypatch.setattr(hc.VectorCounter, "process_matrices", half)


def count_altered(monkeypatch, kind: str) -> None:
    """One barcode's count is one too many where the counter reports it."""
    from barcoder_tpu_torch.pipeline import heuristic_count as hc

    orig = hc.CudaCounter.results

    def altered(self):
        doc, undoc = orig(self)
        doc[next(iter(doc))] += 1
        return doc, undoc

    monkeypatch.setattr(hc.CudaCounter, "results", altered)


FAULTS = {  # fault -> the traffic kinds that can have it
    "state_unchanged": ("targets", "design", "count"),
    "half_library_left_out": ("targets", "design"),
    "hit_altered": ("targets",),
    "selected_guide_altered": ("design",),
    "half_reads_left_out": ("count",),
    "count_altered": ("count",),
}


def plant(fault: str, kind: str, monkeypatch) -> None:
    assert kind in FAULTS[fault], (fault, kind)
    globals()[fault](monkeypatch, kind)


def failing(r: dict) -> bool:
    """The run finished every call and came out not correct."""
    return not r["correct"] and r["failed"] == 0
