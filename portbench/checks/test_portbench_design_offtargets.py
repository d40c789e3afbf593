"""``correct`` comes out false when it should in ``sco-design-offtargets``,
whose traffic kind ``design_offtargets`` the kind lists of
``test_portbench_faults.py`` and ``test_portbench_card.py`` do not name: the
sound run is correct and the control is not, and each fault a design can
have (``faults.py``: the previous answer returned, half of the candidates
left out of the scan, the first selected guide moved) planted under the
harness's timed path fails, on the CPU at a small size and with ``-m gpu``
at the cell's own size on the card (``-s`` prints each run's checks).

    python -m pytest -m gpu portbench/checks/test_portbench_design_offtargets.py -q -s
"""

import copy
import json

import pytest

from portbench import harness, spec

from . import faults
from .conftest import SEED

NAME = "sco-design-offtargets"
FAULTS = ("state_unchanged", "half_library_left_out", "selected_guide_altered")


def small_cell() -> spec.Cell:
    """The cell with its replicons cut to 1/300 (at least 3 kb; the
    repeats scale with the chromosome) and every design checked."""
    c = spec.cell(NAME)
    cfg, mix = copy.deepcopy(c.config), dict(c.mix, check_share=1.0)
    for ct in cfg["contigs"]:
        ct["length"] = max(3000, ct["length"] // 300)
        ct["genes"] = max(3, ct["genes"] // 300)
    return spec.Cell(c.name, c.chips, cfg, mix, c.end_to_end, c.per_layer)


def report(label: str, r: dict) -> None:
    print(f"{label}: attempted {r['attempted']} correct {r['correct']} "
          f"checks {json.dumps(r['checks'])}", flush=True)


def test_sound_run_is_correct_and_control_is_not():
    r = harness.run(small_cell(), SEED, 1.0, False, device="cpu")
    report("sound", r)
    assert r["correct"] and r["checks"]["requests_checked"]["value"] >= 1
    r = harness.run(small_cell(), SEED, 1.0, False, device="cpu", control=True)
    report("control", r)
    assert faults.failing(r)
    assert r["checks"]["offtarget_spacers_differing"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_fails(fault, monkeypatch):
    getattr(faults, fault)(monkeypatch, "design_offtargets")
    r = harness.run(small_cell(), SEED, 1.0, False, device="cpu")
    report(fault, r)
    assert faults.failing(r)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_fails_at_the_cells_size_on_the_card(fault, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    getattr(faults, fault)(monkeypatch, "design_offtargets")
    # one design in the window: a stale answer is the warm-up's
    r = harness.run(spec.cell(NAME), 2**31 + 307, 1.0, False, "cuda")
    report(f"fault {NAME} {fault}", r)
    assert faults.failing(r)
