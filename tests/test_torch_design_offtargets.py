"""The benchmark's GC-skewed, repeat-bearing deployment (``sco-a32-ngg20``)
on the CPU: its generator (``portbench/gen_repeats.py``), the port's design
with ``omit_offtargets`` held to the benchmark's plain reference
(``portbench/reference/design_offtargets_ref.py``) and to the JAX package,
the design's counters, the reference's control, and linear contigs' ends.

The instances are the configuration cut to 24-240 kb, with its GC share, a
scaled terminal inverted repeat, scaled rRNA copies and a circular
plasmid."""

import copy
import json
import time

import numpy as np
import pandas as pd
import pytest
import torch

from barcoder_tpu.core.genome import Genome as RefGenome
from barcoder_tpu.core.genome import contig_from_record as ref_contig_from_record
from barcoder_tpu.pipeline import design as ref_design
from barcoder_tpu.seqio import genbank as ref_genbank
from barcoder_tpu_torch.pipeline import design as port_design
from barcoder_tpu_torch.pipeline import targets as port_targets
from barcoder_tpu_torch.seqio.library import BarcodeLibrary
from barcoder_tpu_torch.utils.profiling import spans
from portbench import gen, gen_repeats, harness, spec
from portbench.reference import design_offtargets_ref, design_ref, targets_ref
from portbench.workloads import program_genome

from .test_torch_design import _route
from .test_torch_site import site_isolation  # noqa: F401  (autouse)

torch.set_num_threads(1)

CONFIG = json.loads((spec.ROOT / "portbench/configs/sco-a32-ngg20.json").read_text())
SEEDS = [2**31 + 5, 2**33 + 17, 12345]
ENGINES = ["torch", "cuda-sites-on-cpu", "cuda-dense-on-cpu"]
L, PAM = 20, "NGG"


def scaled(chromosome: int, tir: int, block: int, copies: int, plasmids: tuple) -> dict:
    """The configuration with its replicons cut to the given lengths (the
    linear SCP1 and the circular SCP2), the terminal repeat to ``tir``, and
    ``copies`` rRNA blocks of ``block`` bases, half on each arm."""
    cfg = copy.deepcopy(CONFIG)
    chrom, scp1, scp2 = cfg["contigs"]
    chrom.update(length=chromosome, genes=max(3, chromosome // 1100))
    scp1.update(length=plasmids[0], genes=max(2, plasmids[0] // 1100))
    scp2.update(length=plasmids[1], genes=max(2, plasmids[1] // 1100))
    left = copies // 2
    starts = [chromosome * (k + 2) // (2 * left + 4) for k in range(left)]
    starts += [chromosome - s - block for s in starts[::-1]]
    cfg["repeats"].update(at_length=chromosome, terminal_inverted=tir, rrna_block=block,
                          rrna_starts=starts, rrna_strands=[-1] * left + [1] * (copies - left))
    return cfg


def gc_share(codes: np.ndarray) -> float:
    return float(np.isin(codes, (1, 2)).mean())


# -- the generator ------------------------------------------------------------


def test_the_configuration_places_its_repeats_inside_the_chromosome():
    rep = CONFIG["repeats"]
    (chrom,) = [c for c in CONFIG["contigs"] if c["id"] == rep["contig"]]
    n, t, b = chrom["length"], rep["terminal_inverted"], rep["rrna_block"]
    assert (n, t, b) == (rep["at_length"], 21653, 5000) and n == 8667507
    starts = rep["rrna_starts"]
    assert len(starts) == len(rep["rrna_strands"]) == 6 and starts == sorted(starts)
    assert t <= starts[0] and starts[-1] + b <= n - t
    assert all(b2 - b1 >= b for b1, b2 in zip(starts, starts[1:]))
    # three on each arm, each facing away from the middle
    assert [s + b / 2 < n / 2 for s in starts] == [True] * 3 + [False] * 3
    assert rep["rrna_strands"] == [-1] * 3 + [1] * 3
    (entry,) = [c for c in spec.manifest()["configs"] if c["name"] == CONFIG["name"]]
    assert entry["reduced"] == [] and entry["file"].endswith("sco-a32-ngg20.json")
    assert [c["topology"] for c in CONFIG["contigs"]] == ["linear", "linear", "circular"]


@pytest.mark.parametrize("seed", SEEDS)
def test_gen_repeats_plants_exact_repeats_at_the_gc_share(seed):
    cfg = scaled(240_000, 2_000, 1_000, 6, (24_000, 6_000))
    contigs = gen_repeats.make_genome(cfg, seed)
    chrom = contigs[0]
    rep = cfg["repeats"]
    t, b = rep["terminal_inverted"], rep["rrna_block"]
    assert np.array_equal(chrom.codes[-t:], targets_ref.revcomp_codes(chrom.codes[:t]))
    assert not np.array_equal(chrom.codes[:t], chrom.codes[t:2 * t])
    copies = [chrom.codes[s:s + b] if strand == 1 else
              targets_ref.revcomp_codes(chrom.codes[s:s + b])
              for s, strand in zip(rep["rrna_starts"], rep["rrna_strands"])]
    assert all(np.array_equal(c, copies[0]) for c in copies)
    everything = np.concatenate([c.codes for c in contigs])
    assert abs(gc_share(everything) - cfg["gc"]) <= 0.005
    assert abs(gc_share(chrom.codes) - cfg["gc"]) <= 0.005
    for c, want in zip(contigs, cfg["contigs"]):
        assert (c.id, c.length, c.circular) == (want["id"], want["length"],
                                                want["topology"] == "circular")
        assert len(c.genes) == want["genes"] and c.codes.max() <= 3
        assert all(0 <= g.start < c.length and 0 < g.end <= c.length for g in c.genes)
    assert not any(g.wraps for c in contigs if not c.circular for g in c.genes)
    (scp2,) = [c for c in contigs if c.circular]
    assert [g.wraps for g in scp2.genes] == [False] * (len(scp2.genes) - 1) + [True]
    assert [g.locus_tag for g in scp2.genes[:2]] == ["SCP2.1", "SCP2.2"]
    again = gen_repeats.make_genome(cfg, seed)
    other = gen_repeats.make_genome(cfg, seed + 1)
    assert all(a.codes.tobytes() == x.codes.tobytes() and a.genes == x.genes
               for a, x in zip(contigs, again))
    assert chrom.codes.tobytes() != other[0].codes.tobytes()


# -- the design with omit_offtargets ------------------------------------------


def ref_genome(contigs: list, organism: str) -> RefGenome:
    """The JAX package's Genome of the generator's contigs, built as
    ``portbench.workloads.program_genome`` builds the port's."""
    out = []
    for c in contigs:
        rec = ref_genbank.GenBankRecord(
            id=c.id, name=c.id.split(".")[0], description=organism, seq=c.ascii(),
            topology="circular" if c.circular else "linear", organism=organism)
        for g in c.genes:
            loc = (ref_genbank.CompoundLocation([ref_genbank.Location(g.start, c.length, g.strand),
                                                 ref_genbank.Location(0, g.end, g.strand)])
                   if g.wraps else ref_genbank.Location(g.start, g.end, g.strand))
            rec.features.append(ref_genbank.Feature(
                "gene", loc, {"locus_tag": [g.locus_tag], "gene": [g.gene] if g.gene else []}))
        out.append(ref_contig_from_record(rec))
    return RefGenome(out, source="portbench")


@pytest.fixture(scope="module")
def instance(tmp_path_factory):
    """A 36 kb instance (linear 24 kb chromosome with a 1 kb terminal
    repeat and three 600-bp rRNA copies, linear 6 kb SCP1, circular 6 kb
    SCP2), its reference design and the JAX package's (with a site-table
    store of its own)."""
    cfg = scaled(24_000, 1_000, 600, 3, (6_000, 6_000))
    contigs = gen.variant(gen_repeats.make_genome(cfg, SEEDS[0]), 0.001,
                          gen.rng(SEEDS[0], "variant", 0))
    table = design_offtargets_ref.mapped(contigs, L, PAM, "downstream")
    want = design_offtargets_ref.design_rows(table, L)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BARCODER_TPU_ARTIFACTS", str(tmp_path_factory.mktemp("artifacts")))
        jax_final, _, jax_cands = ref_design.run_design(
            ref_genome(contigs, cfg["organism"]), PAM, L,
            ref_design.DesignOptions(omit_offtargets=True), backend="jax")
    return cfg, contigs, table, want, (jax_final, jax_cands)


def site_counts(table: tuple) -> dict:
    sites = {}
    for d in table[1]:
        if d.get("chr") is not None:
            sites.setdefault(d["spacer"], set()).add((d["chr"], d["tar_start"], d["tar_end"]))
    return {sp: len(s) for sp, s in sites.items()}


@pytest.mark.parametrize("engine", ENGINES)
def test_design_with_omit_offtargets_matches_the_reference_and_the_jax_package(
        instance, engine, monkeypatch):
    cfg, contigs, table, (w_cols, w_rows, w_removed), (jax_final, jax_cands) = instance
    _route(monkeypatch, engine)
    final, tr, cands = port_design.run_design(
        program_genome(contigs, cfg["organism"]), PAM, L,
        port_design.DesignOptions(omit_offtargets=True), backend="torch")
    assert cands == jax_cands
    pd.testing.assert_frame_equal(final, jax_final)
    got = targets_ref.program_rows(final)
    assert targets_ref.rows_differing((w_cols, w_rows), got) == 0
    assert w_cols[-1] == "sites" and len(final) > 100
    # the repeats and the GC share reach the filter
    sites = site_counts(table)
    multi = sum(k > 1 for k in sites.values())
    assert w_removed > 20 and multi > w_removed
    counters = tr.stats["profile"]["counters"]
    assert counters["design.candidates"] == len(cands) == len(
        design_ref.candidates(contigs, L, PAM, "downstream"))
    assert counters["design.multisite_spacers"] == multi
    assert counters["design.offtarget_spacers_removed"] == w_removed
    assert (counters["scan.pairs"] > 0) == (engine != "torch")


def test_the_design_records_its_offtarget_step(instance, monkeypatch):
    cfg, contigs, *_ = instance
    _route(monkeypatch, "cuda-sites-on-cpu")
    t0 = time.time_ns()
    port_design.run_design(program_genome(contigs, cfg["organism"]), PAM, L,
                           port_design.DesignOptions(omit_offtargets=True), backend="torch")
    new = [s for s in spans() if s.start_ns >= t0]
    by_id = {s.id: s for s in new}
    (off,) = [s for s in new if s.name == "design.offtargets"]
    assert by_id[off.parent].name == "design.filter"
    assert by_id[by_id[off.parent].parent].name == "design"


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("v", [0, 1, 2])
def test_the_references_block_scan_finds_the_plain_scans_hits(instance, v, reverse):
    """``design_offtargets_ref.hits``, which ``mapped`` scans with, finds
    the hits of ``targets_ref.hits`` on every contig, blocks cut across the
    sites and spacers."""
    _, contigs, *_ = instance
    q = targets_ref.encode(design_ref.candidates(contigs, L, PAM, "downstream"))
    for c in contigs:
        args = (q, c.codes, c.circular, PAM, "downstream", v, "cpu")
        want = targets_ref.hits(*args, reverse=reverse)
        got = design_offtargets_ref.hits(*args, rows=700, block=900, reverse=reverse)
        assert sorted(zip(*map(list, got))) == sorted(zip(*map(list, want)))
        assert len(want[0]) >= len(q) // 20
    assert targets_ref.hits.__module__ == targets_ref.__name__  # swapped back


def test_the_control_without_the_offtarget_step_differs(instance):
    _, _, table, want, _ = instance
    *control, removed = design_offtargets_ref.design_rows(table, L, offtargets=False)
    assert removed == 0
    assert targets_ref.rows_differing(tuple(want[:2]), tuple(control)) > 0


def test_the_drivers_check_holds_the_removed_count_to_the_reference(instance, monkeypatch):
    """The benchmark's driver keeps each request's
    ``design.offtarget_spacers_removed``; its check reads one spacer too
    many as a fault, and the control (the off-target step left out) too."""
    cfg, contigs, _, want, _ = instance
    _route(monkeypatch, "cuda-sites-on-cpu")
    mix = json.loads((spec.HERE / "traffic/design-offtargets.json").read_text())
    driver = spec.driver(mix["kind"])(cfg, mix, SEEDS[0], "cpu", 1)
    driver.base = gen_repeats.make_genome(cfg, SEEDS[0])
    item = driver.prepare(0)
    assert all(np.array_equal(a.codes, b.codes) for a, b in zip(item[1], contigs))
    spans = harness.Spans()
    driver.record(0, item, driver.serve(item, spans), spans.counters)
    assert driver.removed == {0: want[2]}
    assert harness.passed(driver.check(False))
    assert not harness.passed(driver.check(True))
    driver.removed[0] += 1
    checks = driver.check(False)
    assert checks["offtarget_spacers_differing"]["value"] == 1
    assert checks["rows_differing"]["value"] == 0


# -- linear contigs' ends -------------------------------------------------------


def end_contig(circular: bool) -> gen.ContigData:
    """A 3 kb contig starting GG and ending CC: on a circular contig the
    windows at its last L + 2 bases have a forward NGG PAM across the
    origin, and the first bases a reverse one; on a linear one they have
    none. Ten genes, none across the origin."""
    g = gen.rng(SEEDS[1], "genome")
    codes = gen_repeats.bases(3000, CONFIG["gc"], g)
    codes[:2] = 2  # G G
    codes[-2:] = 1  # C C
    genes = gen_repeats.genes(3000, 10, "END", 0.88, False)
    return gen.ContigData("END.1", codes, circular, genes)


def wrap_spacers() -> list:
    """The spacers a circular reading gives at the windows whose PAM, or
    whose own bases, cross the origin."""
    c = end_contig(True)
    f, r = targets_ref.pam_sites(c.codes, True, L, PAM, "downstream")
    n = c.length
    f, r = f[f + L + 3 > n], r[r < 3]
    assert len(f) and len(r)
    w = np.concatenate([gen.windows(c, f, L), targets_ref.revcomp_codes(gen.windows(c, r, L))])
    return sorted({s.decode() for s in gen.ACGT[w].view(f"S{L}").ravel()})


@pytest.mark.parametrize("engine", ENGINES)
def test_no_hit_past_the_end_of_a_linear_contig(engine, monkeypatch):
    spacers = wrap_spacers()
    _route(monkeypatch, engine)
    lib = BarcodeLibrary.from_unique_list(spacers)
    for circular in (True, False):
        c = end_contig(circular)
        tr = port_targets.run_targets(lib, program_genome([c], "end"), PAM, 1, backend="torch")
        want = targets_ref.table_rows(spacers, [c], PAM, "downstream", 1)
        assert targets_ref.rows_differing(want, targets_ref.program_rows(tr.table)) == 0
        hit = tr.table[tr.table["tar_start"].notna()]
        fwd, rev = hit[hit["sp_dir"] == "F"], hit[hit["sp_dir"] == "R"]
        if circular:  # the wrap spacers do hit across the origin
            assert (fwd["tar_end"] > c.length - 3).any() or (fwd["tar_start"] < 0).any()
            assert (rev["tar_start"] < 3).any()
        else:  # and on a linear contig no window or PAM reads past an end
            assert ((hit["tar_start"] >= 0) & (hit["tar_end"] <= c.length)).all()
            assert (fwd["tar_end"] <= c.length - 3).all() and (rev["tar_start"] >= 3).all()
    linear = end_contig(False)
    cands = port_design.find_candidate_guides(program_genome([linear], "end"), L, PAM)
    assert sorted(cands) == design_ref.candidates([linear], L, PAM, "downstream")
    assert not set(spacers) & set(cands)
