"""BENCHMARK.json keeps to its contract, finds every file it names, and
takes a new cell with new files and entries alone."""

import json
import re
import shutil

import pytest

from portbench import spec

from .conftest import small_cell, small_run

BENCH = spec.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
TEXT = re.compile(r"[^\t\n\r]{1,200}\Z")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check with 24 cells fits its 43,200 seconds
    cells = 24
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and TEXT.match(entry["source"]) and TEXT.match(entry["why"])
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    conf = json.loads((spec.ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"] and "assumed" in conf
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert sum(c["file"] == entry["file"] for c in BENCH["configs"]) == 1


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workloads(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert all(NAME.match(entry[k]) for k in ("name", "config", "traffic"))
    assert TEXT.match(entry["why"]) and entry["chips"] in (1, 4)
    assert (spec.HERE / "traffic" / f"{entry['traffic']}.json").is_file()
    c = spec.cell(entry["name"])
    assert entry["chips"] in spec.driver(c.mix["kind"]).chips
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names


def test_pairs_and_names_are_unique_and_four_chip_cells_few():
    w = BENCH["workloads"]
    assert len({(x["config"], x["traffic"]) for x in w}) == len(w)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert sum(x["chips"] == 4 for x in w) <= max(1, len(w) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(m):
    assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer(m):
    assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert TEXT.match(m["layer"])
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m["workloads"]) <= set(moved.get("workloads", cells))


NEW_KIND = '''
from portbench import spec


class Driver(spec.driver("targets")):
    """targets requests, each at the mix's smallest budget"""

    def prepare(self, i):
        spacers, genome, contigs, v = super().prepare(i)
        return spacers, genome, contigs, min(self.mix["mismatches"])

    def record(self, i, item, result, counters):
        return dict(super().record(i, item, result, counters), v=item[3])
'''


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix of a new
    kind with its driver, a cell and a per-layer metric by new files and
    manifest entries; the harness runs the cell unchanged, with the new
    driver, and reports the new metric."""
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    old = small_cell("eco-targets-resident")
    (here / "configs" / "tiny-ngg20.json").write_text(
        json.dumps(dict(old.config, name="tiny-ngg20")))
    (here / "drivers" / "targets-least-v.py").write_text(NEW_KIND)
    (here / "traffic" / "resident-v2.json").write_text(
        json.dumps(dict(old.mix, kind="targets-least-v", mismatches=[1, 2])))
    (here / "metrics" / "targets.spacers.py").write_text(
        "def read(run):\n    return sum(it.work['spacers'] for it in run.items) / len(run.items)\n")
    (here / "metrics" / "targets.v.py").write_text(
        "def read(run):\n    return max(it.work['v'] for it in run.items)\n")
    bench["configs"].append({"name": "tiny-ngg20", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny-ngg20.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny-resident-v2", "config": "tiny-ngg20",
                               "traffic": "resident-v2", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "eco-targets-resident" in m["workloads"]:
            m["workloads"].append("tiny-resident-v2")
    for name, unit in (("targets.spacers", "spacers"), ("targets.v", "mismatches")):
        bench["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                   "source": "program_counter", "layer": "targets pipeline",
                                   "moves": "request_s", "workloads": ["tiny-resident-v2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("tiny-resident-v2", root=tmp_path, here=here)
    assert cell.mix["mismatches"] == [1, 2]
    assert {"targets.spacers", "targets.v"} <= {m["name"] for m in cell.per_layer}
    r = small_run("tiny-resident-v2", traced=True, cell=cell, here=here)
    assert r["correct"] and r["metrics"]["targets.spacers"]["value"] > 0
    assert r["metrics"]["targets.v"]["value"] == 1


def test_a_cell_on_more_cards_than_its_driver_runs_on_is_refused():
    """No driver yet spreads its work over cards: a four-card cell of an
    existing kind is refused before set-up, not run on one card and
    reported as four."""
    c = small_cell("eco-targets-resident")
    c.chips = 4
    with pytest.raises(ValueError, match="4 card"):
        small_run(c.name, cell=c)
