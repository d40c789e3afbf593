"""The port's targets workload held against the JAX package's: the
``run_targets`` frames must be equal and the CLI stdout byte-equal to a
``barcoder_tpu`` run with ``backend="jax"``.

Every comparison is EXACT (frame equality with dtypes, byte equality of
the TSV/JSON text). The port runs on the CPU here, through its plain
``torch`` backend and through the CUDA engine's code path with the kernel's
plain version (``cuda_scan_contigs(device="cpu")``).
"""

import io

import numpy as np
import pandas as pd
import pytest
import torch

from barcoder_tpu.cli.targets import main as ref_cli
from barcoder_tpu.pipeline.targets import run_targets as ref_run_targets
from barcoder_tpu.pipeline.targets import write_output as ref_write_output
from barcoder_tpu.seqio.genbank import write_genbank
from barcoder_tpu.seqio.library import BarcodeLibrary
from barcoder_tpu_torch.cli.targets import main as port_cli
from barcoder_tpu_torch.ops.cuda_scan import cuda_scan_contigs
from barcoder_tpu_torch.pipeline import targets as port_targets

from .genomes import genome_from_records, make_record, plant_guide, random_seq
from .test_torch_site import site_isolation  # noqa: F401  (autouse)

torch.set_num_threads(1)


def mutate(seq, positions):
    s = list(seq)
    for p in positions:
        s[p] = {"A": "C", "C": "G", "G": "T", "T": "A"}[s[p]]
    return "".join(s)


def build_inputs(multi_contig: bool):
    """Records + library entries: planted guides on both strands, across the
    origin, with mismatched copies, a duplicate name, a spacer whose only
    site lacks the PAM, a non-targeting spacer, and (multi-contig) a second
    spacer length, a linear contig and a small plasmid with a guide across
    its origin."""
    rng = np.random.default_rng(5)
    main = make_record(n=12_000, topology="circular", seed=5, n_genes=8,
                       wrapped_gene=True)
    records = [main]
    guides = [random_seq(20, rng) for _ in range(6)]
    plant_guide(main, guides[0], 800, pam="CGG")
    plant_guide(main, guides[1], 1600, pam="TGG", strand="R")
    plant_guide(main, guides[2], 11_990, pam="AGG")  # wraps the origin
    plant_guide(main, mutate(guides[2], [4]), 5000, pam="GGG")
    plant_guide(main, mutate(guides[3], [1, 9]), 7000, pam="TGG", strand="R")
    plant_guide(main, guides[4], 9000)  # no PAM planted
    entries = [(f"g{i}", g) for i, g in enumerate(guides)]
    entries.append(("g0_dup", guides[0]))
    if multi_contig:
        lin = make_record(n=5000, topology="linear", seed=6, n_genes=4,
                          rec_id="LIN1.1")
        plasmid = make_record(n=900, topology="circular", seed=7, n_genes=2,
                              rec_id="PLS1.1")
        long_guides = [random_seq(24, rng) for _ in range(3)]
        plant_guide(lin, guides[0], 2500, pam="AGG", strand="R")
        plant_guide(lin, long_guides[0], 100, pam="TGG")
        plant_guide(plasmid, long_guides[1], 890, pam="CGG")  # wraps
        plant_guide(plasmid, guides[5], 300, pam="TGG")
        records += [lin, plasmid]
        entries += [(f"long{i}", g) for i, g in enumerate(long_guides)]
    return records, entries


CASES = [
    dict(pam="NGG", mismatches=0),
    dict(pam="NGG", mismatches=2),
    dict(pam="TTTN", mismatches=1, pam_direction="upstream"),
    dict(pam="NGG", mismatches=1, gene_window="upstream", insert_site=True),
    dict(pam="NGG", mismatches=3, max_sites=2),
]


def _engine_on_cpu(monkeypatch):
    """Route the port's pipeline through the CUDA engine's code path, with
    the kernel's plain version (CPU tensors), at a tile width that gives
    several tiles per contig."""
    def scan_contigs(spacers, contigs, max_mismatches, pam, pam_direction, backend):
        return cuda_scan_contigs(spacers, contigs, max_mismatches, pam, pam_direction,
                                 P=2048, device="cpu")

    monkeypatch.setattr(port_targets, "scan_contigs", scan_contigs)


@pytest.mark.parametrize("engine", ["torch", "cuda-engine-on-cpu"])
@pytest.mark.parametrize("multi_contig", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_run_targets_frames_equal(case, multi_contig, engine, monkeypatch):
    records, entries = build_inputs(multi_contig)
    genome = genome_from_records(records)
    lib = BarcodeLibrary(entries)
    kw = CASES[case]
    want = ref_run_targets(lib, genome, backend="jax", **kw)
    if engine != "torch":
        _engine_on_cpu(monkeypatch)
    got = port_targets.run_targets(lib, genome, backend="torch", **kw)
    pd.testing.assert_frame_equal(got.table, want.table)
    pd.testing.assert_frame_equal(got.results, want.results)
    strip = lambda s: {k: v for k, v in s.items() if k != "profile"}  # noqa: E731
    assert strip(got.stats) == strip(want.stats)
    a, b = io.StringIO(), io.StringIO()
    port_targets.write_output(got, a)
    ref_write_output(want, b)
    assert a.getvalue() == b.getvalue()
    if case == 0:
        assert (got.table["tar_start"] == 800).any()


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    records, entries = build_inputs(multi_contig=True)
    write_genbank(records, d / "genome.gb")
    with open(d / "lib.fasta", "w") as fh:
        fh.writelines(f">{name}\n{seq}\n" for name, seq in entries)
    return d


@pytest.mark.parametrize("extra", [[], ["--json"], ["--insert-site"],
                                   ["--pam_direction", "upstream"]])
def test_cli_stdout_byte_equal(cli_files, capsys, extra):
    d = cli_files
    args = [str(d / "lib.fasta"), str(d / "genome.gb"), "NGG", "2", *extra]
    assert ref_cli(args + ["--backend", "jax"]) == 0
    want = capsys.readouterr().out
    assert port_cli(args + ["--backend", "torch"]) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) > 3


def test_cli_profile_writes_trace(cli_files, tmp_path, capsys):
    d = cli_files
    prof = tmp_path / "prof"
    args = [str(d / "lib.fasta"), str(d / "genome.gb"), "NGG", "1",
            "--backend", "torch", "--profile", str(prof)]
    assert port_cli(args) == 0
    assert (prof / "trace.json").stat().st_size > 0
    assert "scan" in (prof / "phases.json").read_text()


def test_cuda_backend_raises_without_cuda(monkeypatch):
    """backend="cuda" never falls back: without a CUDA device it raises."""
    from barcoder_tpu_torch.ops import scan as port_scan

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    records, entries = build_inputs(multi_contig=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_scan.scan_contigs([s for _, s in entries[:2]],
                               genome_from_records(records).contigs, 0, "NGG",
                               backend="cuda")
    assert port_scan.resolve_backend("auto") == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_scan.resolve_backend("auto") == "cuda"


@pytest.mark.parametrize("backend", ["auto", "sharded"])
def test_auto_and_sharded_raise_without_cuda(cli_files, monkeypatch, capsys, backend):
    """auto (the default) and sharded need a card; neither carries on on the
    CPU, through the API or the CLI, and the error names the CPU backends."""
    from barcoder_tpu_torch.ops import scan as port_scan

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    records, entries = build_inputs(multi_contig=False)
    genome = genome_from_records(records)
    with pytest.raises(RuntimeError, match="--backend torch"):
        port_scan.scan_contigs([s for _, s in entries[:2]], genome.contigs, 0, "NGG",
                               backend=backend)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_targets.run_targets(BarcodeLibrary(entries), genome, "NGG", 1, backend=backend)
    args = [str(cli_files / "lib.fasta"), str(cli_files / "genome.gb"), "NGG", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli(args + ([] if backend == "auto" else ["--backend", backend]))
    assert capsys.readouterr().out == ""


def test_oracle_backend_frames_equal():
    records, entries = build_inputs(multi_contig=True)
    genome = genome_from_records(records)
    lib = BarcodeLibrary(entries)
    want = ref_run_targets(lib, genome, "NGG", 1, backend="jax")
    got = port_targets.run_targets(lib, genome, "NGG", 1, backend="oracle")
    pd.testing.assert_frame_equal(got.table, want.table)

