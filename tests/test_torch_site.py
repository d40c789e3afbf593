"""The port's site-compacted engine on one device (barcoder_tpu_torch.ops
.cuda_scan with ``site_mode``) held against the JAX package's
``pallas_scan_contigs`` (its Pallas matrix kernel in interpret mode) and the
numpy oracle, on the cases of tests/test_site_scan.py.

Every comparison is EXACT: equal sets of (spacer, position, strand,
mismatches) tuples, and bit-equal phase-1 counts on state carried over from
the JAX engine. The port runs on the CPU, where the kernel's wrapper takes
its plain torch version.

``site_isolation`` gives each test its own artifact directory and fresh
site caches and repeat counters, in both packages, so that a site table the
port stores on disk cannot promote a later test's first scan to the site
engine. The other port test files that reach the site engine import it.
"""

import numpy as np
import pytest
import torch

import barcoder_tpu.ops.pallas_scan as ps
from barcoder_tpu.core.genome import contig_from_record
from barcoder_tpu.ops.oracle import oracle_scan
from barcoder_tpu.ops.prep import enumerate_sites
from barcoder_tpu_torch.ops import cuda_scan as cs
from barcoder_tpu_torch.ops import scan_hits
from barcoder_tpu_torch.parallel import sharded_scan as port_ss

from .genomes import make_record, plant_guide, random_seq

torch.set_num_threads(1)


def _clear_site_state():
    for mod in (cs, ps):
        mod._SITE_DEV_CACHE.clear()
        mod._SITE_SEEN.clear()
    for cache in (port_ss._SITE_HOST_CACHE, port_ss._GENOME_SHARD_CACHE,
                  port_ss._Q_SHARD_CACHE):
        cache.clear()


@pytest.fixture(autouse=True)
def site_isolation(tmp_path, monkeypatch):
    monkeypatch.setenv("BARCODER_TPU_ARTIFACTS", str(tmp_path / "artifacts"))
    _clear_site_state()
    yield
    _clear_site_state()


def tuples(h):
    return set(zip(h.spacer_idx.tolist(), h.pos.tolist(), h.strand.tolist(),
                   h.mismatches.tolist()))


def both(guides, contigs, v, **kw):
    """(port, JAX) Hits tuples per contig, both with site_mode="always"."""
    port = cs.cuda_scan_contigs(guides, contigs, v, device="cpu", site_mode="always", **kw)
    jax = ps.pallas_scan_contigs(guides, contigs, v, interpret=True, site_mode="always", **kw)
    return [tuples(h) for h in port], [tuples(h) for h in jax]


def check(guides, contig, v, **kw):
    (port,), (jax,) = both(guides, [contig], v, **kw)
    kw.pop("P", None)
    want = tuples(oracle_scan(guides, contig, v, **kw))
    assert port == jax == want
    return want


@pytest.mark.parametrize("topology", ["circular", "linear"])
@pytest.mark.parametrize("v", [0, 1, 2, 3])
def test_site_engine_matches_jax_and_oracle(topology, v):
    rng = np.random.default_rng(23 + v)
    rec = make_record(n=3000, topology=topology, seed=23 + v)
    guides = [random_seq(20, rng) for _ in range(6)]
    for i, g in enumerate(guides):
        plant_guide(rec, g, 101 + i * 450, pam="TGG" if i % 3 else "AGG",
                    strand="F" if i % 2 else "R")
    before = scan_hits.launches
    hits = check(guides, contig_from_record(rec), v, pam="NGG", P=512)
    assert scan_hits.launches == before  # CPU tensors take the plain version
    assert {(i, 101 + i * 450, 0) for i in range(6)} <= {(s, p, m) for s, p, _, m in hits}


def test_upstream_pam_and_n_bases():
    rng = np.random.default_rng(31)
    rec = make_record(n=2500, topology="circular", seed=31)
    g = random_seq(20, rng)
    plant_guide(rec, g, 400, pam="TTN", pam_direction="upstream")
    plant_guide(rec, g, 1200, pam="TTA", pam_direction="upstream")
    s = list(rec.seq)
    s[1207] = "N"  # one N inside the 1200 site: reachable only at v >= 1
    s[7] = "N"  # near the origin
    rec.seq = "".join(s)
    contig = contig_from_record(rec)
    for v in (0, 1):
        hits = check([g], contig, v, pam="TTN", pam_direction="upstream", P=512)
        assert any(p == 400 for _, p, _, _ in hits)
        assert any(p == 1200 for _, p, _, _ in hits) == (v >= 1)


def test_L32_takes_one_launch_path():
    """4L == K leaves no spare G row; the site engine never folds a bias, so
    32-mers take the same single phase-1 call as 20-mers."""
    rng = np.random.default_rng(43)
    rec = make_record(n=2500, topology="circular", seed=43)
    guides = [random_seq(32, rng) for _ in range(3)]
    plant_guide(rec, guides[0], 700, pam="TGG")
    plant_guide(rec, guides[1], 1500, pam="AGG", strand="R")
    calls = []
    real = cs.site_indicator
    cs.site_indicator = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        hits = check(guides, contig_from_record(rec), 1, pam="NGG", P=512)
    finally:
        cs.site_indicator = real
    assert calls == [1]
    assert {(0, 700), (1, 1500)} <= {(s, p) for s, p, _, _ in hits}


def test_batched_phase2_matches_one_batch(monkeypatch):
    """Phase 2's reference in batches of one pair gives the Hits of one
    batch, which are those of both JAX phase-2 paths (the speculative
    one-fetch path, and the batched one that design-scale libraries
    take)."""
    rng = np.random.default_rng(59)
    rec = make_record(n=3500, topology="circular", seed=59)
    guides = [random_seq(20, rng) for _ in range(8)]
    for i, g in enumerate(guides):
        plant_guide(rec, g, 120 + i * 400, pam="AGG", strand="R" if i % 2 else "F")
    contig = contig_from_record(rec)
    kw = dict(pam="NGG", P=512, site_mode="always")
    one_batch = tuples(cs.cuda_scan(guides, contig, 2, device="cpu", **kw))
    jax_spec = tuples(ps.pallas_scan(guides, contig, 2, interpret=True, **kw))

    monkeypatch.setattr(scan_hits, "_phase2_batch", lambda BS_M, P2: 1)
    batched = tuples(cs.cuda_scan(guides, contig, 2, device="cpu", **kw))
    monkeypatch.setattr(ps, "_SITE_MODE_MIN_SPACERS", 1)  # the JAX batched path
    jax_batched = tuples(ps.pallas_scan(guides, contig, 2, interpret=True, **kw))
    want = tuples(oracle_scan(guides, contig, 2, pam="NGG"))
    assert one_batch == batched == jax_spec == jax_batched == want
    assert len(want) >= 8


def test_multi_contig():
    rng = np.random.default_rng(47)
    recs = [make_record(n=1500 + 400 * i, topology=t, seed=47 + i, rec_id=f"MC{i}.1")
            for i, t in enumerate(["circular", "linear", "circular"])]
    g = random_seq(20, rng)
    for i, rec in enumerate(recs):
        plant_guide(rec, g, 300 + 100 * i, pam="AGG", strand="R" if i == 1 else "F")
    contigs = [contig_from_record(r) for r in recs]
    port, jax = both([g], contigs + contigs[:1], 1, pam="NGG", P=512)
    assert port == jax
    for c, h in zip(contigs + contigs[:1], port):
        assert h == tuples(oracle_scan([g], c, 1, pam="NGG")), c.id
        assert h


def test_no_sites_and_bad_mode():
    rec = make_record(n=1200, topology="linear", seed=3)
    rec.seq = "A" * 1200  # no NGG anywhere
    contig = contig_from_record(rec)
    assert len(cs.cuda_scan(["A" * 20], contig, 3, "NGG", P=512, device="cpu",
                            site_mode="always")) == 0
    with pytest.raises(ValueError, match="site_mode"):
        cs.cuda_scan(["A" * 20], contig, 0, "NGG", device="cpu", site_mode="sites")


# --- the site_mode="auto" rules, against the JAX engine's choices ----------

def _engines(monkeypatch):
    """Record which engine each port and JAX contig scan takes."""
    taken = {"port": [], "jax": []}
    for name, mod in (("port", cs), ("jax", ps)):
        for cls, tag in (("_ScanJob", "dense"), ("_SiteScanJob", "sites")):
            real = getattr(mod, cls)

            def job(*a, _real=real, _tag=tag, _name=name, **k):
                taken[_name].append(_tag)
                return _real(*a, **k)

            monkeypatch.setattr(mod, cls, job)
    return taken


def _scan_both(guides, contig, v, pam, **kw):
    got = tuples(cs.cuda_scan(guides, contig, v, pam, P=512, device="cpu", **kw))
    want = tuples(ps.pallas_scan(guides, contig, v, pam, P=512, interpret=True, **kw))
    assert got == want == tuples(oracle_scan(guides, contig, v, pam))


def _repeat_case(seed):
    rng = np.random.default_rng(seed)
    rec = make_record(n=3000, topology="circular", seed=seed)
    guides = [random_seq(20, rng) for _ in range(4)]
    for i, g in enumerate(guides):
        plant_guide(rec, g, 150 + i * 600, pam="GGG")
    return rec, guides


def test_auto_promotes_the_second_scan(monkeypatch):
    """First auto scan of a (genome, PAM, L) key is dense; the second builds
    and caches the site table; the third reuses it without enumerating; a
    content change is a new key, dense again. The JAX engine chooses the
    same at every step."""
    rec, guides = _repeat_case(53)
    contig = contig_from_record(rec)
    taken = _engines(monkeypatch)
    enumerated = []
    real_enum = cs.enumerate_sites
    monkeypatch.setattr(cs, "enumerate_sites",
                        lambda *a, **k: enumerated.append(1) or real_enum(*a, **k))
    for _ in range(3):
        _scan_both(guides, contig, 1, "NGG")
    assert taken["port"] == taken["jax"] == ["dense", "sites", "sites"]
    assert len(enumerated) == 1 and len(cs._SITE_DEV_CACHE) == 1
    s = list(rec.seq)
    s[10] = "ACGT"[("ACGT".index(s[10]) + 1) % 4]
    rec.seq = "".join(s)
    _scan_both(guides, contig_from_record(rec), 1, "NGG")
    assert taken["port"] == taken["jax"] == ["dense", "sites", "sites", "dense"]
    # "never" is dense and counts nothing; "always" is sites from the start
    _scan_both(guides, contig_from_record(rec), 1, "NGA", site_mode="never")
    _scan_both(guides, contig_from_record(rec), 1, "NGA", site_mode="never")
    _scan_both(guides, contig_from_record(rec), 1, "NAG", site_mode="always")
    assert taken["port"] == taken["jax"] == ["dense", "sites", "sites", "dense"] + [
        "dense", "dense", "sites"]


def test_auto_keeps_all_n_pams_and_pamless_scans_dense(monkeypatch):
    rec, guides = _repeat_case(61)
    contig = contig_from_record(rec)
    taken = _engines(monkeypatch)
    for pam in ("N", "N", "NN", "", ""):
        _scan_both(guides, contig, 1, pam)
    _scan_both(guides, contig, 1, "N", site_mode="always")  # only "always" takes it
    assert taken["port"] == taken["jax"] == ["dense"] * 5 + ["sites"]


def test_auto_sites_artifact_promotes_the_first_scan(monkeypatch):
    """A "sites" artifact on disk (here the JAX engine's, from an "always"
    scan) sends the first auto scan of a fresh process to the site engine,
    which loads the table instead of enumerating it."""
    rec, guides = _repeat_case(67)
    contig = contig_from_record(rec)
    ps.pallas_scan(guides, contig, 1, "NGG", P=512, interpret=True, site_mode="always")
    ps._SITE_DEV_CACHE.clear()
    ps._SITE_SEEN.clear()
    taken = _engines(monkeypatch)
    monkeypatch.setattr(cs, "enumerate_sites", lambda *a, **k: pytest.fail("enumerated"))
    _scan_both(guides, contig, 1, "NGG")
    assert taken["port"] == taken["jax"] == ["sites"]


def test_auto_design_scale_library_takes_sites(monkeypatch):
    """The crossover: a library of S_pad >= _SITE_MODE_MIN_SPACERS takes the
    site engine on its first scan (lowered here so a small library crosses
    it in both engines)."""
    rec, guides = _repeat_case(71)
    contig = contig_from_record(rec)
    taken = _engines(monkeypatch)
    monkeypatch.setattr(cs, "_SITE_MODE_MIN_SPACERS", 128)
    monkeypatch.setattr(ps, "_SITE_MODE_MIN_SPACERS", 128)
    _scan_both(guides, contig, 1, "NGG")
    monkeypatch.setattr(cs, "_SITE_MODE_MIN_SPACERS", 1 << 30)
    monkeypatch.setattr(ps, "_SITE_MODE_MIN_SPACERS", 1 << 30)
    cs._SITE_DEV_CACHE.clear()
    ps._SITE_DEV_CACHE.clear()
    _scan_both(guides, contig_from_record(make_record(n=2000, seed=72)), 1, "NGG")
    assert taken["port"] == taken["jax"] == ["sites", "dense"]


# --- phase 1 on state carried over from the JAX engine ---------------------

@pytest.mark.parametrize("L,v", [(20, 3), (32, 1)])
def test_site_phase1_counts_bit_equal_on_jax_state(L, v):
    """The JAX engine's site-code matrix (_SiteTable.codes_lp) and forward
    one-hot rows (_QPrep.q_dev[STRAND_F]) as the port's tensors: the port's
    site indicator equals the JAX kernel's (interpret mode) bit for bit, and
    its pairs are the JAX phase1_matrix pairs."""
    import jax.numpy as jnp

    rng = np.random.default_rng(L + v)
    rec = make_record(n=6000, topology="circular", seed=L)
    guides = [random_seq(L, rng) for _ in range(300)]
    for i in range(0, 300, 30):
        plant_guide(rec, guides[i], 100 + 19 * i, pam="CGG", strand="F" if i % 60 else "R")
    contig = contig_from_record(rec)
    q_f = cs.spacer_matrix(guides)
    P, sub_width = 1024, 256
    prep = ps._QPrep(q_f, v, "NGG", "downstream", P, sub_width)
    table = ps._SiteTable(P, L, *enumerate_sites(contig, L, "NGG", "downstream"))
    codes_lp = np.asarray(table.codes_lp)
    n_tiles = table.n_sites_b // P
    tiles = jnp.asarray(codes_lp).astype(jnp.int32).reshape(-1, n_tiles, P).transpose(1, 0, 2)
    kw = dict(L=L, K=prep.K, P=P, SUB=prep.SUB, BS_M=prep.bs)
    want = np.asarray(ps.scan_block_hits(
        prep.thresh_dev, prep.q_dev[0], tiles, jnp.zeros((n_tiles, 1, P), jnp.float32),
        fold_bias=False, matrix_rows=True, interpret=True, **kw))
    st = cs.state_from_numpy(thresh=np.asarray(prep.thresh_dev), q_f=np.asarray(prep.q_dev[0]),
                             codes_lp=codes_lp)
    got = cs.site_indicator(st["codes_lp"], st["q_f"], st["thresh"], **kw)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert want.sum() > 0
    pairs, _vals, n_pairs = ps.phase1_matrix(
        table.codes_lp, prep.q_dev[0], prep.thresh_dev, n_sites_b=table.n_sites_b,
        pair_cap=1 << 14, interpret=True, **kw)
    port_pairs = cs.phase1_matrix(st["codes_lp"], st["q_f"], st["thresh"], **kw)
    assert np.array_equal(port_pairs.numpy(), np.asarray(pairs)[: int(n_pairs)])


@pytest.mark.parametrize("v", [0, 1, 2, 3])
def test_site_phase2_kernel_route_on_the_model(v):
    """The site engine's one phase-2 route (the pair list, the site codes
    at stride n_sites_b, n_sites, as the card gets them) with the kernel's
    reference on the CPU gives the oracle's Hits in Hits order."""
    rng = np.random.default_rng(71 + v)
    rec = make_record(n=5000, topology="circular", seed=71 + v)
    guides = [random_seq(20, rng) for _ in range(140)]
    for i in range(0, 140, 20):
        plant_guide(rec, guides[i], 150 + 31 * i, pam="TGG", strand="F" if i % 40 else "R")
    plant_guide(rec, guides[1], 4990, pam="AGG")  # across the origin
    contig = contig_from_record(rec)
    prep = cs._QPrep(cs.spacer_matrix(guides), v, "NGG", "downstream", 1024, 256, "cpu")
    job = cs._SiteScanJob(prep, cs._site_table_for(prep, contig, "always"))
    assert job.qc is prep.chunks("f") and prep.S_pad > prep.S
    got, want = job.collect(), oracle_scan(guides, contig, v, pam="NGG")
    for f in ("spacer_idx", "pos", "strand", "mismatches"):  # in Hits order
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (1, 4990, 0, 0) in tuples(got)


@pytest.mark.parametrize("site_mode", ["never", "always"])
def test_run_targets_reports_the_phase2_counters(monkeypatch, site_mode):
    """``scan.phase2_hits`` and ``scan.phase2_relaunches`` sit beside
    ``scan.pairs`` in run_targets' counters; on the CPU route every hit is
    counted and nothing relaunches."""
    from barcoder_tpu.core.genome import Genome
    from barcoder_tpu.seqio.library import BarcodeLibrary
    from barcoder_tpu_torch.pipeline import targets as port_targets

    def scan_contigs(spacers, contigs, max_mismatches, pam, pam_direction, backend):
        return cs.cuda_scan_contigs(spacers, contigs, max_mismatches, pam, pam_direction,
                                    P=1024, device="cpu", site_mode=site_mode)

    monkeypatch.setattr(port_targets, "scan_contigs", scan_contigs)
    rng = np.random.default_rng(73)
    rec = make_record(n=6000, seed=73)
    guides = [random_seq(20, rng) for _ in range(12)]
    for i, g in enumerate(guides):
        plant_guide(rec, g, 200 + 450 * i, pam="CGG", strand="R" if i % 2 else "F")
    tr = port_targets.run_targets(BarcodeLibrary([(f"g{i}", g) for i, g in enumerate(guides)]),
                                  Genome([contig_from_record(rec)], source="synthetic"), "NGG",
                                  1, backend="torch")
    counters = tr.stats["profile"]["counters"]
    assert counters["scan.phase2_relaunches"] == 0
    assert counters["scan.phase2_hits"] == counters["hits"] >= 12
    assert counters["scan.pairs"] > 0
