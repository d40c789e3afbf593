"""On the card (``gpu`` marker; skips without one, decided inside the
test): every cell through the entry point as the benchmark runs it, a short
window with and without the trace, the result line complete and
``correct``; the control failing at the cell's own size; and each fault the
cell can have (``faults.py``), planted under the harness's timed path at the
cell's own size, failing too (``-s`` prints each run's checks).

    python -m pytest -m gpu portbench/checks -q -s
"""

import json
import subprocess
import sys

import pytest

from portbench import harness, spec

from .conftest import CELLS
from .faults import FAULTS, failing, plant


def run(name: str, seed: int, trace: int, *extra: str) -> tuple:
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name,
                          "--seed", str(seed), "--seconds", "3", "--trace", str(trace),
                          *extra], capture_output=True, text=True, cwd=spec.ROOT,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = spec.cell(name)
    for trace, metrics in ((0, c.end_to_end), (1, c.per_layer)):
        r, err = run(name, 2**31 + 101 + trace, trace)
        assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
        assert list(r)[-1] == "checks"
        assert r["device"]["platform"] == "gpu" and r["device"]["count"] == c.chips
        assert set(r["metrics"]) <= {m["name"] for m in metrics}
        if trace:
            assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
            assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(r["metrics"]) == {m["name"] for m in metrics}
        assert err.strip().splitlines()[-1].startswith("portbench: check ")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r, _ = run(name, 2**31 + 211, 0, "--control")
    assert not r["correct"] and r["failed"] == 0


# a stale answer shows in a window's first call (it returns the warm-up's
# answer) but in counting, whose warm-up counted the window's first sample
# too: its window holds two samples
FAULT_SECONDS = {"targets": 2.0, "design": 1.0, "count": 5.0}


@pytest.mark.gpu
@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f, kinds in FAULTS.items()
                                        if spec.cell(n).mix["kind"] in kinds])
def test_fault_fails_at_the_cells_size_on_the_card(name, fault, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = spec.cell(name)
    plant(fault, c.mix["kind"], monkeypatch)
    r = harness.run(c, 2**31 + 307, FAULT_SECONDS[c.mix["kind"]], False, "cuda")
    print(f"fault {name} {fault}: attempted {r['attempted']} correct {r['correct']} "
          f"checks {json.dumps(r['checks'])}", flush=True)
    assert failing(r)
