"""The port's class API (``barcoder_tpu_torch.api``, a copy of the JAX
package's) and its SAM writer and reader (``seqio/sam.py``) held against
the JAX package's on the cases of tests/test_api.py and tests/test_sam.py,
frame for frame: the port's ``ScanRunner`` with ``backend="torch"`` (and
the numpy oracle) against the JAX one with ``backend="jax"``.

Every comparison is EXACT (``pd.testing.assert_frame_equal``, or equal
text). A guide planted with its PAM gives ground truth that does not rest
on the ``ops/prep.py`` both packages share.
"""

import io
import re

import numpy as np
import pandas as pd
import pytest
import torch

import barcoder_tpu.api as japi
import barcoder_tpu.seqio.sam as jsam
import barcoder_tpu_torch.api as tapi
import barcoder_tpu_torch.seqio.sam as tsam
from barcoder_tpu.core.encode import revcomp

from .genomes import genome_from_records, make_record, plant_guide, random_seq

torch.set_num_threads(1)

BACKENDS = ["torch", "oracle"]


@pytest.fixture(scope="module")
def genome():
    rec = make_record(n=9000, topology="circular", seed=50, n_genes=6)
    return genome_from_records([rec])


@pytest.fixture(scope="module")
def planted():
    """A genome with one guide planted on each strand with an NGG PAM, and
    the guides: (genome, [(guide, start, strand)])."""
    rng = np.random.default_rng(52)
    rec = make_record(n=6000, topology="circular", seed=52, n_genes=4)
    g1, g2 = random_seq(20, rng), random_seq(20, rng)
    plant_guide(rec, g1, 1700, pam="AGG")
    plant_guide(rec, g2, 4100, pam="CGG", strand="R")
    return genome_from_records([rec]), [(g1, 1700, "+"), (g2, 4100, "-")]


def both(genome, backend, fn):
    """fn(runner) through the JAX package's ScanRunner and the port's."""
    with japi.ScanRunner(genome, backend="jax") as ref, \
            tapi.ScanRunner(genome, backend=backend) as port:
        return fn(ref), fn(port)


def frames_equal(got, want):
    pd.testing.assert_frame_equal(got.reset_index(drop=True), want.reset_index(drop=True))


@pytest.mark.parametrize("pam,direction,length", [
    ("GG", "downstream", 20), ("NGG", "downstream", 12), ("TTN", "upstream", 15),
    ("NGNC", "downstream", 20), ("", "downstream", 5),
])
def test_guide_finder_matches(genome, pam, direction, length):
    want = japi.GuideFinder(genome, pam, direction, length).find_guides_from_pam()
    got = tapi.GuideFinder(genome, pam, direction, length).find_guides_from_pam()
    assert got == want
    if pam:
        pat = re.compile(pam.replace("N", "[ATCG]"))
        assert len(got) == sum(len(pat.findall(s)) for c in genome.contigs
                               for s in (c.seq, revcomp(c.seq)))


def test_guide_finder_bad_direction_raises(genome):
    with pytest.raises(ValueError, match="Direction"):
        tapi.GuideFinder(genome, "GG", "sideways", 20)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("v", [0, 2])
def test_align_frames_match(planted, backend, v):
    """align at v mismatches with and without the PAM, on a list and on a
    set: the frames equal the JAX package's, and the planted guides map at
    0 mismatches on their strands."""
    genome, plants = planted
    rng = np.random.default_rng(53)
    contig = genome.contigs[0]
    guides = [g for g, *_ in plants] + [random_seq(20, rng), contig.seq[300:320],
                                        revcomp(contig.seq[2500:2520]), contig.seq[100:112]]
    for barcodes in (guides, set(guides)):
        for pam in ("", "NGG"):
            want, got = both(genome, backend,
                             lambda r: r.align(barcodes, num_mismatches=v, pam=pam))
            frames_equal(got, want)
    ngg, _ = both(genome, backend, lambda r: r.align(guides, num_mismatches=v, pam="NGG"))
    for guide, start, strand in plants:
        rows = ngg[(ngg.Barcode == guide) & (ngg.Start == start) & (ngg.Strand == strand)]
        assert (rows.Mismatches == 0).any() and rows.Mapped.all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_join_features_and_feature_frame_match(genome, backend):
    contig = genome.contigs[0]
    e = contig.locus_entries[0]
    guides = [contig.seq[s : s + 20] for s in (0, 1495, 1600, 2200, 8980)] + [
        contig.seq[e.start : e.start + 20]]
    want, got = both(genome, backend, lambda r: r.align(guides, join_features=True))
    frames_equal(got, want)
    assert (got.Type == "source").any() and (got.Locus_Tag == e.locus_tag).any()
    want, got = both(genome, backend, lambda r: r.feature_frame())
    frames_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_align_and_unmapped_join_keep_their_schema(genome, backend):
    for barcodes in ([], ["ACGT" * 5 + "ACGTA"]):
        want, got = both(genome, backend, lambda r: r.align(barcodes, join_features=True))
        assert list(got.columns) == list(want.columns)
        assert len(got) == len(want) == 0


@pytest.mark.parametrize("pam,direction", [("NN", "downstream"), ("NGG", "downstream"),
                                           ("TTTN", "upstream")])
def test_crispri_library_frames_match(genome, pam, direction):
    """Every frame of CRISPRiLibrary, on guides that include the minus
    strand, both edges of the contig and a gene boundary."""
    contig = genome.contigs[0]
    n = contig.length
    guides = [contig.seq[100:120], revcomp(contig.seq[300:320]), contig.seq[n - 20 :],
              revcomp(contig.seq[:20]), contig.seq[1495:1515], contig.seq[3010:3030]]
    want_df, got_df = both(genome, "torch", lambda r: r.align(guides, join_features=True))
    want = japi.CRISPRiLibrary(want_df, japi.PAMFinder(genome, pam, direction))
    got = tapi.CRISPRiLibrary(got_df, tapi.PAMFinder(genome, pam, direction))
    for name in ("targets_df", "source_unique_targets", "mapped_targets", "unique_targets",
                 "unambiguous_targets"):
        frames_equal(getattr(got, name), getattr(want, name))
    if pam == "NN":  # every window matches a permissive PAM
        assert len(got.mapped_targets) > 0


def test_pam_finder_strands_and_slices(genome):
    from types import SimpleNamespace

    for sym in ("fwd", "Forward", "+1", "rev", -1, "+", "-"):
        assert tapi.PAMFinder.get_strand(sym) == japi.PAMFinder.get_strand(sym)
    with pytest.raises(ValueError, match="Unrecognized"):
        tapi.PAMFinder.get_strand(".")
    chrom = genome.contigs[0].id
    pf, jpf = tapi.PAMFinder(genome, "NGG", "downstream"), japi.PAMFinder(genome, "NGG",
                                                                           "downstream")
    for start, strand in ((2, "-"), (40, "-"), (40, "+"), (8990, "+")):
        row = SimpleNamespace(Chromosome=chrom, Start=start, End=start + 20, Strand=strand)
        assert pf.get_pam_seq(row) == jpf.get_pam_seq(row)
        assert pf.pam_matches(pf.get_pam_seq(row)) == jpf.pam_matches(jpf.get_pam_seq(row))


# --- SAM (tests/test_sam.py) ----------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_sam_text_and_roundtrip_match(backend):
    rec = make_record(n=5000, topology="circular", seed=77, n_genes=3)
    genome = genome_from_records([rec])
    rng = np.random.default_rng(7)
    guides = [rec.seq[200:220], revcomp(rec.seq[900:920]), random_seq(20, rng)]
    want_df, got_df = both(genome, backend, lambda r: r.align(guides, num_mismatches=1))
    frames_equal(got_df, want_df)
    texts = []
    for sam, df in ((jsam, want_df), (tsam, got_df)):
        buf = io.StringIO()
        sam.write_sam(df, buf, seq_lens=genome.seq_lens)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    back = tsam.parse_sam(io.StringIO(texts[1]))
    frames_equal(back, jsam.parse_sam(io.StringIO(texts[0])))
    frames_equal(back[got_df.columns], got_df)


def test_sam_fields_bowtie_dialect():
    df = pd.DataFrame([
        dict(Chromosome="C1", Start=9, End=29, Mapped=True, Strand="+", Barcode="A" * 20,
             Mismatches=2),
        dict(Chromosome=None, Start=-1, End=-1, Mapped=False, Strand=".", Barcode="C" * 20,
             Mismatches=0),
    ])
    texts = []
    for sam in (jsam, tsam):
        buf = io.StringIO()
        sam.write_sam(df, buf, seq_lens={"C1": 100})
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    f = [line for line in texts[1].splitlines() if not line.startswith("@")][0].split("\t")
    assert f[1] == "0" and f[3] == "10" and f[11] == "NM:i:2"


@pytest.mark.parametrize("backend", BACKENDS)
def test_align_sam_path_export_matches(tmp_path, backend):
    rec = make_record(n=3000, topology="linear", seed=5, n_genes=2)
    genome = genome_from_records([rec])
    paths = iter([tmp_path / "jax.sam", tmp_path / "port.sam"])
    want, got = both(genome, backend, lambda r: r.align([rec.seq[50:70]], num_mismatches=0,
                                                        join_features=True,
                                                        sam_path=str(next(paths))))
    frames_equal(got, want)
    text = (tmp_path / "port.sam").read_text()
    assert text == (tmp_path / "jax.sam").read_text()
    back = tsam.parse_sam(text.splitlines())
    assert (back.Barcode == rec.seq[50:70]).all() and (back.Start == 50).any()


def test_scan_runner_defaults_to_the_card(genome, monkeypatch):
    """The default backend is ``auto``, the cuda engine: without a card it
    raises rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runner = tapi.ScanRunner(genome)
    assert runner.backend == "auto"
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        runner.align([genome.contigs[0].seq[100:120]])
