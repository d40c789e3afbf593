"""``correct`` comes out false when it should. The control (the reference
with one of the configuration's guarantees broken, put in the program's
place) fails each cell's check; so does a run of the harness whose timed
path is broken underneath, once for each fault the cell can have
(``faults.py``): a request that returns the previous answer (its state
unchanged), half of the batch left out, and an answer altered where it is
produced. The harness's look for a card is skipped (``device="cpu"``); the
rest of a run is the benchmark's own. ``test_portbench_card.py`` plants the
same faults at the cells' own size on the card."""

import pytest

from .conftest import COUNT_CELLS, TARGET_CELLS, small_cell, small_run
from .faults import failing, plant


def planted_run(name: str, fault: str, monkeypatch) -> dict:
    plant(fault, small_cell(name).mix["kind"], monkeypatch)
    return small_run(name)


@pytest.mark.parametrize("name", TARGET_CELLS + COUNT_CELLS)
def test_sound_run_is_correct_and_control_is_not(name):
    assert small_run(name)["correct"]
    # at this size a random genome holds almost no hit at exactly 1-3
    # mismatches, which the mapping control drops, so it shows on a v = 0
    # request: the resident deck's first is its 6th at this seed
    r = small_run(name, seconds=6.0, control=True)
    assert failing(r)
    assert next(v for k, v in r["checks"].items() if "at_most" in v)["value"] > 0


@pytest.mark.parametrize("name", TARGET_CELLS + COUNT_CELLS)
def test_state_unchanged_fails(name, monkeypatch):
    assert failing(planted_run(name, "state_unchanged", monkeypatch))


@pytest.mark.parametrize("name", TARGET_CELLS)
def test_half_the_library_left_out_fails(name, monkeypatch):
    assert failing(planted_run(name, "half_library_left_out", monkeypatch))


MAPPING_CELLS = [n for n in TARGET_CELLS if small_cell(n).mix["kind"] == "targets"]
DESIGN_CELLS = [n for n in TARGET_CELLS if small_cell(n).mix["kind"] == "design"]


@pytest.mark.parametrize("name", MAPPING_CELLS)
def test_hit_altered_where_produced_fails(name, monkeypatch):
    assert failing(planted_run(name, "hit_altered", monkeypatch))


@pytest.mark.parametrize("name", DESIGN_CELLS)
def test_selected_guide_altered_where_produced_fails(name, monkeypatch):
    assert failing(planted_run(name, "selected_guide_altered", monkeypatch))


@pytest.mark.parametrize("name", COUNT_CELLS)
def test_half_the_reads_left_out_fails(name, monkeypatch):
    assert failing(planted_run(name, "half_reads_left_out", monkeypatch))


@pytest.mark.parametrize("name", COUNT_CELLS)
def test_count_altered_where_produced_fails(name, monkeypatch):
    assert failing(planted_run(name, "count_altered", monkeypatch))
