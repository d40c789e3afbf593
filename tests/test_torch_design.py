"""The port's design workload (barcoder_tpu_torch.pipeline.design, a copy
of the JAX package's, and its ``design`` CLI) held against the JAX
package's on the synthetic genomes of tests/test_design.py.

Every comparison is EXACT: frame equality with dtypes, and byte equality of
the CLI's stdout. The port's scan runs on the CPU: through its plain
``torch`` backend, and through the CUDA engine's code path (the kernel's
plain version) on its site and its dense engine, and through the sharded
site engine on a CPU mesh.
"""

import pandas as pd
import pytest
import torch

from barcoder_tpu.cli.design import main as ref_cli
from barcoder_tpu.pipeline import design as ref_design
from barcoder_tpu.seqio.genbank import write_genbank
from barcoder_tpu_torch.cli.design import main as port_cli
from barcoder_tpu_torch.ops.cuda_scan import cuda_scan_contigs
from barcoder_tpu_torch.parallel.mesh import make_mesh
from barcoder_tpu_torch.parallel.sharded_scan import sharded_scan_contigs
from barcoder_tpu_torch.pipeline import design as port_design
from barcoder_tpu_torch.pipeline import targets as port_targets

from .genomes import genome_from_records, make_record
from .test_torch_site import site_isolation  # noqa: F401  (autouse)

torch.set_num_threads(1)

ENGINES = ["torch", "cuda-sites-on-cpu", "cuda-dense-on-cpu", "sharded-sites-on-cpu"]


def _route(monkeypatch, engine):
    """Send the port's scan stage through one of its engines on the CPU."""
    if engine == "torch":
        return

    def scan_contigs(spacers, contigs, max_mismatches, pam, pam_direction, backend):
        if engine == "sharded-sites-on-cpu":
            return sharded_scan_contigs(spacers, contigs, max_mismatches, pam, pam_direction,
                                        mesh=make_mesh(devices=[torch.device("cpu")] * 4),
                                        P=1024, site_mode="always")
        return cuda_scan_contigs(spacers, contigs, max_mismatches, pam, pam_direction, P=1024,
                                 device="cpu",
                                 site_mode="always" if "sites" in engine else "never")

    monkeypatch.setattr(port_targets, "scan_contigs", scan_contigs)


def run_both(genome, pam, L, monkeypatch, engine, **opts):
    want, want_tr, want_cands = ref_design.run_design(
        genome, pam, L, ref_design.DesignOptions(**opts), backend="jax")
    _route(monkeypatch, engine)
    got, got_tr, got_cands = port_design.run_design(
        genome, pam, L, port_design.DesignOptions(**opts), backend="torch")
    assert got_cands == want_cands
    pd.testing.assert_frame_equal(got_tr.table, want_tr.table)
    pd.testing.assert_frame_equal(got, want)
    assert got.to_csv(sep="\t", index=False) == want.to_csv(sep="\t", index=False)
    return got, got_cands


@pytest.mark.parametrize("engine", ENGINES)
def test_end_to_end_frames_equal(monkeypatch, engine):
    rec = make_record(n=8000, topology="circular", seed=24, n_genes=6)
    final, cands = run_both(genome_from_records([rec]), "NGG", 20, monkeypatch, engine,
                            mismatches=1, omit_offtargets=True, keep_top=3)
    assert len(cands) > 200 and len(final) > 0
    assert (final.groupby("locus_tag")["spacer"].nunique() <= 3).all()


@pytest.mark.parametrize("engine", ["torch", "cuda-sites-on-cpu"])
def test_defaults_and_keep_top_frames_equal(monkeypatch, engine):
    rec = make_record(n=8000, topology="linear", seed=26, n_genes=5)
    final, _ = run_both(genome_from_records([rec]), "NGG", 20, monkeypatch, engine)
    assert len(final) > 0


@pytest.mark.parametrize("engine", ["torch", "cuda-sites-on-cpu"])
def test_tiling_frames_equal(monkeypatch, engine):
    rec = make_record(n=6000, topology="circular", seed=25, n_genes=3)
    final, _ = run_both(genome_from_records([rec]), "NGG", 20, monkeypatch, engine,
                        mismatches=0, omit_offtargets=True, keep_top=0, tile_size=50)
    for _, group in final.groupby("locus_tag"):
        offs = sorted(group["offset"].unique())
        assert all(b - a >= 50 for a, b in zip(offs, offs[1:]))


def test_upstream_pam_and_multi_contig_frames_equal(monkeypatch):
    recs = [make_record(n=5000, topology="circular", seed=27, n_genes=4),
            make_record(n=3000, topology="linear", seed=28, n_genes=2, rec_id="LIN2.1")]
    run_both(genome_from_records(recs), "TTTN", 20, monkeypatch, "cuda-sites-on-cpu",
             pam_direction="upstream", orientation="both", omit_intergenic=False)


def nan_offset_frame():
    """test_design.py's TestNaNOffsetGroups frame: a gene with real offsets
    and an unstranded one whose offsets are all NaN."""
    rows = [dict(spacer=f"G{i}", target="acgt", note="1 sites, 1 genes", sp_dir="F",
                 tar_dir="F", mismatches=0, locus_tag="LOK", offset=float(10 + 40 * i),
                 overlap=20, chr="c1", tar_start=100 + i, tar_end=120 + i) for i in range(4)]
    rows += [dict(spacer=f"N{i}", target="acgt", note="1 sites, 1 genes", sp_dir="F",
                  tar_dir=None, mismatches=0, locus_tag="LNAN", offset=float("nan"),
                  overlap=20, chr="c1", tar_start=500 + i, tar_end=520 + i) for i in range(3)]
    return pd.DataFrame(rows)


@pytest.mark.parametrize("opts", [
    dict(orientation="both", omit_intergenic=False, keep_top=0, tile_size=30, mismatches=0),
    dict(orientation="both", omit_intergenic=False, keep_top=2, mismatches=0),
])
def test_nan_offset_groups_frames_equal(opts):
    frame = nan_offset_frame()
    want = ref_design.apply_design_filters(frame.copy(), 20,
                                           ref_design.DesignOptions(**opts).resolve(20))
    got = port_design.apply_design_filters(frame.copy(), 20,
                                           port_design.DesignOptions(**opts).resolve(20))
    pd.testing.assert_frame_equal(got, want)
    assert not any(s.startswith("N") for s in got["spacer"])


@pytest.mark.parametrize("topology,L", [("circular", 20), ("linear", 20), ("circular", 40)])
def test_candidates_equal(topology, L):
    genome = genome_from_records([make_record(n=3000, topology=topology, seed=21)])
    got = port_design.find_candidate_guides(genome, L, "NGG")
    assert got == ref_design.find_candidate_guides(genome, L, "NGG") and len(got) > 20


@pytest.fixture(scope="module")
def genome_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_design_cli")
    write_genbank([make_record(n=7000, topology="circular", seed=24, n_genes=5,
                               wrapped_gene=True)], d / "genome.gb")
    return d / "genome.gb"


@pytest.mark.parametrize("extra", [[], ["--omit_offtargets", "--keep-top", "2"],
                                   ["--orientation", "both", "--mismatches", "0",
                                    "--tile_size", "40"]])
def test_cli_stdout_byte_equal(genome_file, capsys, tmp_path, extra):
    args = [str(genome_file), "NGG", "20", *extra]
    assert ref_cli(args + ["--backend", "jax", "--sgrna-out", str(tmp_path / "a.fa")]) == 0
    want = capsys.readouterr().out
    assert port_cli(args + ["--backend", "torch", "--sgrna-out", str(tmp_path / "b.fa")]) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) > 2
    assert (tmp_path / "a.fa").read_text() == (tmp_path / "b.fa").read_text()


@pytest.mark.parametrize("backend", ["auto", "sharded"])
def test_auto_and_sharded_raise_without_cuda(genome_file, monkeypatch, capsys, backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    genome = genome_from_records([make_record(n=3000, seed=24, n_genes=2)])
    with pytest.raises(RuntimeError, match="--backend torch"):
        port_design.run_design(genome, "NGG", 20, backend=backend)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli([str(genome_file), "NGG", "20"]
                 + ([] if backend == "auto" else ["--backend", backend]))
    assert capsys.readouterr().out == ""


def test_cli_missing_genome_exits_1(tmp_path, capsys):
    assert port_cli([str(tmp_path / "nope.gb"), "NGG", "20", "--backend", "torch"]) == 1
    assert capsys.readouterr().out == ""
