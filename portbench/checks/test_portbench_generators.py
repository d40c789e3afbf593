"""The generators make the same inputs from the same seed, at the sizes the
configurations and mixes state, and every panel request gets a strain of
its own."""

import hashlib

import numpy as np
import pytest

from portbench import gen, spec
from portbench.reference import targets_ref

from .conftest import CELLS, SEED


def configs():
    bench = spec.manifest()
    return [spec.cell(w["name"], bench).config for w in bench["workloads"]]


@pytest.mark.parametrize("config", configs(), ids=lambda c: c["name"])
def test_genome_is_the_seeds_at_the_configured_sizes(config):
    a, b, c = (gen.make_genome(config, s) for s in (SEED, SEED, SEED + 1))
    for want, x, y, z in zip(config["contigs"], a, b, c):
        assert x.id == want["id"] and x.length == want["length"]
        assert len(x.genes) == want["genes"] + 1  # and one across the origin
        assert x.genes[-1].wraps and x.genes[-1].start == x.length - 120
        assert np.array_equal(x.codes, y.codes) and not np.array_equal(x.codes, z.codes)
        assert x.codes.max() <= 3


def test_panel_variants_never_repeat_and_keep_the_annotation():
    config = spec.cell("zmo-targets-panel").config
    base = gen.make_genome(config, SEED)
    seen = set()
    for i in range(12):
        v = gen.variant(base, 0.005, gen.rng(SEED, "variant", i))
        digest = hashlib.sha256(b"".join(c.codes.tobytes() for c in v)).hexdigest()
        assert digest not in seen
        seen.add(digest)
        for b, c in zip(base, v):
            assert (b.codes != c.codes).sum() == round(0.005 * b.length)
            assert c.genes is b.genes
    again = gen.variant(base, 0.005, gen.rng(SEED, "variant", 0))
    assert all(np.array_equal(a.codes, b.codes) for a, b in
               zip(again, gen.variant(base, 0.005, gen.rng(SEED, "variant", 0))))


def test_site_library_is_distinct_and_drawn_at_sites():
    config = spec.cell("eco-targets-resident").config
    contig = gen.make_contig("c", 20000, 10, "t", gen.rng(SEED, "genome"))
    per = gen.sites([contig], 20, config["pam"], "downstream")
    f, r = per[0]
    site_spacers = {s.tobytes() for s in gen.ACGT[gen.windows(contig, f, 20)]}
    site_spacers |= {s.tobytes() for s in
                     gen.ACGT[targets_ref.revcomp_codes(gen.windows(contig, r, 20))]}
    lib = gen.site_library([contig], per, 20, 300, 1.0, gen.rng(SEED, "library"))
    assert len(lib) == len(set(lib)) == 300
    assert all(s.encode() in site_spacers for s in lib)
    assert lib == gen.site_library([contig], per, 20, 300, 1.0, gen.rng(SEED, "library"))
    mixed = gen.site_library([contig], per, 20, 300, 0.5, gen.rng(SEED, "library", 1))
    share = np.mean([s.encode() in site_spacers for s in mixed])
    assert 0.35 < share < 0.65


def test_size_deck_is_the_same_work_for_every_seed():
    mix = spec.cell("eco-targets-resident").mix
    deck = gen.size_deck(mix["library"], mix["mismatches"])
    lib = mix["library"]
    assert len(deck) == lib["deck"]
    sizes = np.array([s for s, _ in deck])
    assert sizes.min() >= lib["size_min"] and sizes.max() <= lib["size_max"]
    assert abs(np.median(sizes) - lib["size_median"]) / lib["size_median"] < 0.1
    budgets = [v for _, v in deck]
    assert all(budgets.count(v) == len(deck) // len(mix["mismatches"])
               for v in mix["mismatches"])
    # a seed orders the deck; it does not change it, and every round of
    # `strata` requests takes one size from each run of neighbouring sizes
    k, strata = len(deck), lib["strata"]
    a, b = (gen.deck_order(k, strata, gen.rng(s, "deck", 0)) for s in (SEED, SEED + 1))
    assert sorted(a) == sorted(b) == list(range(k)) and list(a) != list(b)
    for r in range(0, k, strata):
        assert sorted(a[r:r + strata] // (k // strata)) == list(range(strata))


def test_count_sample_truth_recounts_from_its_reads():
    mix = spec.cell("eco-count").mix
    lib = ["".join(s) for s in np.random.default_rng(1).choice(list("ACGT"), (40, 20))]
    undoc = ["".join(s) for s in np.random.default_rng(2).choice(list("ACGT"), (8, 20))]
    small = dict(mix, reads=5000)
    w = np.ones(len(lib))
    s = gen.count_sample(lib, undoc, small, gen.rng(SEED, "reads", 2, 0), w)
    assert s.reads.shape == (5000, mix["read_len"])
    doc, und = {}, {}
    for row in s.reads:
        text = row.tobytes().decode()
        if "N" in text:
            continue
        bc = text[20:40]
        if bc in lib:
            doc[bc] = doc.get(bc, 0) + 1
        else:
            und[bc + "*"] = und.get(bc + "*", 0) + 1
        assert text.startswith(mix["prefix"] + mix["flank_left"])
        assert text[40:48] == mix["flank_right"]
    assert doc == s.doc and und == s.undoc
    assert sum(s.control_doc.values()) > sum(s.doc.values())
    again = gen.count_sample(lib, undoc, small, gen.rng(SEED, "reads", 2, 0), w)
    assert np.array_equal(again.reads, s.reads)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_its_files(name):
    c = spec.cell(name)
    assert c.config["name"] and c.mix["kind"] in ("targets", "count", "design")
