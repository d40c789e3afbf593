"""The port's scaling harness (barcoder_tpu_torch.parallel.scaling): the
mechanics of measure_scaling and its command line on meshes of 1, 2 and 8
CPU shards, asked for explicitly (``devices=[cpu]``, ``--device cpu``):
without a card the harness does not fall back to the CPU. Times taken here
are CPU times of the plain torch versions and mean nothing; the report
says so (``fake_devices``)."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from barcoder_tpu.core.genome import Contig
from barcoder_tpu.ops.oracle import oracle_scan
from barcoder_tpu.ops.prep import enumerate_sites
from barcoder_tpu_torch.parallel import scaling

from .test_torch_site import site_isolation  # noqa: F401  (autouse)

torch.set_num_threads(1)
CPU = [torch.device("cpu")]


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    # the flagship NGG scan takes the site engine: its table goes to this
    # module's own artifact directory
    with pytest.MonkeyPatch.context() as m:
        m.setenv("BARCODER_TPU_ARTIFACTS", str(tmp_path_factory.mktemp("artifacts")))
        return scaling.measure_scaling(n_bp=1 << 16, n_spacers=128, device_counts=[1, 2, 8],
                                       engine="all", repeats=1, single_chip=True, devices=CPU)


def test_report_keys_and_flags(report):
    assert report["platform"] == "cpu" and report["fake_devices"] is True
    assert "NOT meaningful" in report["note"]
    assert report["genome_bp"] == 1 << 16 and report["spacers"] == 128
    assert report["single_chip"] == {"skipped": "no CUDA device (the kernel has no CPU mode)"}
    assert "sharded_vs_single_chip" not in report


def n_ngg_sites() -> int:
    """The workload's NGG sites on both strands, by the JAX package's own
    enumeration."""
    c, _ = scaling._make_workload(1 << 16, 128, 20)
    contig = Contig(id=c.id, length=c.length, codes=c.codes, seq=c.seq, topology=c.topology)
    return len(enumerate_sites(contig, 20, "NGG", "downstream")[0])


@pytest.mark.parametrize("engine", ["flagship", "dense", "blockmax"])
def test_rates_and_efficiencies(report, engine):
    rows = report[engine]
    assert [r["devices"] for r in rows] == [1, 2, 8]
    positions = 2 * 128 * (1 << 16)
    # each row names its engine and counts the pairs that engine scores
    path, pairs = {"flagship": ("site", 128 * n_ngg_sites()),
                   "dense": ("dense", positions),
                   "blockmax": ("block_max", positions // 2)}[engine]
    assert 0 < pairs <= positions
    base = rows[0]["spacer_positions_per_s"]
    for r in rows:
        assert r["seconds"] > 0
        assert r["path"] == path and r["pairs"] == pairs
        assert r["pairs_per_s"] == pytest.approx(pairs / r["seconds"])
        assert r["spacer_positions_per_s"] == pytest.approx(positions / r["seconds"])
        assert r["per_device_rate"] == pytest.approx(r["spacer_positions_per_s"] / r["devices"])
        assert r["speedup"] == pytest.approx(r["spacer_positions_per_s"] / base)
        assert r["efficiency"] == pytest.approx(r["speedup"] / r["devices"])
        assert ("hits" in r) == (engine != "blockmax")
        # CPU tensors take the plain versions: no kernel launches
        assert r["launches"] == {"scan_hits": 0, "phase2_hits": 0, "scan_max": 0}


def test_flagship_hits_match_the_oracle(report):
    contig, spacers = scaling._make_workload(1 << 16, 128, 20)
    want = len(oracle_scan(spacers, contig, 1, pam="NGG"))
    assert want > 0  # the spacers are genome windows, some followed by NGG
    assert [r["hits"] for r in report["flagship"]] == [want] * 3
    assert [r["hits"] for r in report["dense"]] == [want] * 3


def test_command_line():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = scaling.main(["8192", "16", "--engine", "blockmax", "--devices", "1,2",
                           "--P", "1024", "--device", "cpu"])
    got = json.loads(out.getvalue())
    assert rc == 0 and got["spacers"] == 16 and got["genome_bp"] == 8192
    assert [r["devices"] for r in got["blockmax"]] == [1, 2] and "flagship" not in got
    with pytest.raises(ValueError, match="unknown engine"):
        scaling.measure_scaling(n_bp=4096, n_spacers=8, engine="sites", devices=CPU)
    # one CPU device: the default mesh sizes are {1}
    assert [r["devices"] for r in scaling.measure_scaling(
        n_bp=4096, n_spacers=8, repeats=1, devices=CPU)["flagship"]] == [1]


def test_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        scaling.measure_scaling(n_bp=4096, n_spacers=8, repeats=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        scaling.main(["4096", "8"])


@pytest.mark.parametrize("workload", ["scan", "count"])
def test_multihost_harness_on_cpu_shards(workload):
    """measure_multihost with two worker processes of 2 CPU shards each
    (``--device cpu``): every process saw the same hits or counts, the scan
    equals this process's one-process sharded scan, and the owned reads
    cover the count's reads once. The walls mean nothing here."""
    from barcoder_tpu_torch.parallel.mesh import make_mesh
    from barcoder_tpu_torch.parallel.sharded_scan import sharded_scan

    r = scaling.measure_multihost(1 << 15, 64, 2, devices_per_process=2, P=1024, repeats=1,
                                  force_cpu=True, workload=workload, timeout_s=240)
    assert r["processes"] == 2 and r["global_devices"] == 4 and r["platform"] == "cpu"
    assert len(r["per_process_seconds"]) == 2 and "mechanics" in r["note"]
    if workload == "scan":
        contig, spacers = scaling._make_workload(1 << 15, 64, 20)
        want = sharded_scan(spacers, contig, 1, pam="NGG", mesh=make_mesh(devices=CPU * 4),
                            P=1024)
        assert r["hit_sets_identical"] and r["hits"] == len(want) > 0
    else:
        assert r["counts_identical"] and r["owned_covers_stream"]
        assert all(n > 0 for n in r["owned_reads"]) and sum(r["owned_reads"]) == r["reads"]
