"""The port's scaling harness (barcoder_tpu_torch.parallel.scaling): the
mechanics of measure_scaling and its command line on meshes of 1, 2 and 8
CPU shards. Times taken here are CPU times of the plain torch versions and
mean nothing; the report says so (``fake_devices``)."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from barcoder_tpu.ops.oracle import oracle_scan
from barcoder_tpu_torch.parallel import scaling

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def report():
    return scaling.measure_scaling(n_bp=1 << 16, n_spacers=128, device_counts=[1, 2, 8],
                                   engine="both", repeats=1, single_chip=True)


def test_report_keys_and_flags(report):
    assert report["platform"] == "cpu" and report["fake_devices"] is True
    assert "NOT meaningful" in report["note"]
    assert report["genome_bp"] == 1 << 16 and report["spacers"] == 128
    assert report["single_chip"] == {"skipped": "no CUDA device (the kernel has no CPU mode)"}
    assert "sharded_vs_single_chip" not in report


@pytest.mark.parametrize("engine", ["flagship", "blockmax"])
def test_rates_and_efficiencies(report, engine):
    rows = report[engine]
    assert [r["devices"] for r in rows] == [1, 2, 8]
    positions = 2 * 128 * (1 << 16)
    base = rows[0]["spacer_positions_per_s"]
    for r in rows:
        assert r["seconds"] > 0
        assert r["spacer_positions_per_s"] == pytest.approx(positions / r["seconds"])
        assert r["per_device_rate"] == pytest.approx(r["spacer_positions_per_s"] / r["devices"])
        assert r["speedup"] == pytest.approx(r["spacer_positions_per_s"] / base)
        assert r["efficiency"] == pytest.approx(r["speedup"] / r["devices"])
        assert ("hits" in r) == (engine == "flagship")
        # CPU tensors take the plain versions: no kernel launches
        assert r["launches"] == {"scan_hits": 0, "scan_max": 0}


def test_flagship_hits_match_the_oracle(report):
    contig, spacers = scaling._make_workload(1 << 16, 128, 20)
    want = len(oracle_scan(spacers, contig, 1, pam="NGG"))
    assert want > 0  # the spacers are genome windows, some followed by NGG
    assert [r["hits"] for r in report["flagship"]] == [want] * 3


def test_command_line():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = scaling.main(["8192", "16", "--engine", "blockmax", "--devices", "1,2",
                           "--P", "1024"])
    got = json.loads(out.getvalue())
    assert rc == 0 and got["spacers"] == 16 and got["genome_bp"] == 8192
    assert [r["devices"] for r in got["blockmax"]] == [1, 2] and "flagship" not in got
    # one CPU device: the default mesh sizes are {1}
    assert [r["devices"] for r in scaling.measure_scaling(
        n_bp=4096, n_spacers=8, repeats=1)["flagship"]] == [1]
