"""Helpers of the benchmark's CPU tests: the manifest's cells cut to a size
the CPU runs in seconds, driven through the harness with the program's
plain torch paths (``backend="torch"``, the count engine's matching on the
CPU)."""

import copy

import pytest

from portbench import harness, spec

SEED = 2**31 + 977  # larger than 32 signed bits hold


def small_cell(name: str, bench: dict | None = None, **spec_kw) -> spec.Cell:
    c = spec.cell(name, bench, **spec_kw)
    cfg = copy.deepcopy(c.config)
    for ct in cfg["contigs"]:
        ct["length"] = max(3000, ct["length"] // 300)
        ct["genes"] = max(3, ct["genes"] // 300)
    cfg["library_size"] = 120
    mix = copy.deepcopy(c.mix)
    if mix["kind"] in ("targets", "design"):
        mix["check_share"] = 0.5
        if mix.get("genome") == "resident":
            mix["library"].update(size_median=48, size_min=16, size_max=160, deck=8, strata=4)
    else:
        mix.update(reads=12000, undocumented_pool=64)
    return spec.Cell(c.name, c.chips, cfg, mix, c.end_to_end, c.per_layer)


def small_run(name: str, seconds: float = 1.0, traced: bool = False, control: bool = False,
              seed: int = SEED, cell: spec.Cell | None = None, **kw) -> dict:
    return harness.run(cell or small_cell(name), seed, seconds, traced, device="cpu",
                       control=control, **kw)


@pytest.fixture(autouse=True)
def fresh_artifacts(tmp_path, monkeypatch):
    """A site-table store of the test's own, as each benchmark run has."""
    monkeypatch.setenv("BARCODER_TPU_ARTIFACTS", str(tmp_path / "artifacts"))


CELLS = [w["name"] for w in spec.manifest()["workloads"]]
# cells whose requests go through run_targets (design maps its candidates so)
TARGET_CELLS = [n for n in CELLS if spec.cell(n).mix["kind"] in ("targets", "design")]
COUNT_CELLS = [n for n in CELLS if spec.cell(n).mix["kind"] == "count"]
