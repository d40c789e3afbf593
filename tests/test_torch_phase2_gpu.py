"""Phase 2 of the scan on the card: the kernel (``scan_hits.phase2_hits``,
``csrc/scan_hits.cu::phase2_hits_kernel``) against its plain torch
reference (``scan_hits.phase2_hits_reference``) on the same device inputs.
Each engine's job has one phase-2 route, ``collect``; run once as it is
and once with the reference in the kernel's place, it must give the same
Hits, as a multiset of (spacer_idx, pos, strand, mismatches) and in Hits
order. ``gpu``-marked: they skip without a card. This file imports no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_phase2_gpu.py
"""

from collections import Counter

import numpy as np
import pytest
import torch

from barcoder_tpu.core.genome import contig_from_record
from barcoder_tpu_torch.ops import cuda_scan as cs
from barcoder_tpu_torch.ops import scan_hits
from barcoder_tpu_torch.ops.prep import spacer_matrix

from .genomes import make_record, plant_guide, random_seq

torch.set_num_threads(1)

P = 2048


def multiset(h) -> Counter:
    return Counter(zip(h.spacer_idx.tolist(), h.pos.tolist(), h.strand.tolist(),
                       h.mismatches.tolist()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def site_isolation(tmp_path, monkeypatch):
    """Each test's own artifact directory and fresh site caches and repeat
    counters, so no test's site table promotes another's first scan."""
    from barcoder_tpu_torch.parallel import sharded_scan as ss

    monkeypatch.setenv("BARCODER_TPU_ARTIFACTS", str(tmp_path / "artifacts"))
    cs._SITE_DEV_CACHE.clear()
    cs._SITE_SEEN.clear()
    ss._SITE_HOST_CACHE.clear()


def planted(seed, *, n, L, pam_site, topology="circular", n_planted=12, n_random=0,
            across_origin=True):
    """A genome with guides planted on both strands (one across the origin
    of a circular contig), and a library of those guides, copies of them
    with 1-3 substitutions (hits at 1-3 mismatches) and random guides."""
    rng = np.random.default_rng(seed)
    rec = make_record(n=n, topology=topology, seed=seed)
    guides = [random_seq(L, rng) for _ in range(n_planted)]
    for i, g in enumerate(guides):
        pos = 200 + i * ((n - 600) // n_planted)
        if i == 0 and across_origin and topology == "circular":
            pos = n - L // 2
        plant_guide(rec, g, pos, pam=pam_site, strand="R" if i % 2 else "F")
    library = list(guides)
    for i, g in enumerate(guides):
        k = 1 + i % 3
        s = list(g)
        for at in rng.choice(L, k, replace=False):
            s[at] = "ACGT"[("ACGT".index(s[at]) + 1 + int(rng.integers(3))) % 4]
        library.append("".join(s))
    library += [random_seq(L, rng) for _ in range(n_random)]
    return contig_from_record(rec), library


def dense_job(library, contig, v, pam, device, *, P=P, sub_width=512):
    prep = cs._QPrep(spacer_matrix(library), v, pam, "downstream", P, sub_width, device)
    return prep, cs._ScanJob(prep, contig)


def site_job(library, contig, v, pam, device, *, P=P, sub_width=512):
    prep = cs._QPrep(spacer_matrix(library), v, pam, "downstream", P, sub_width, device)
    return prep, cs._SiteScanJob(prep, cs._site_table_for(prep, contig, "always"))


def reference_collect(job):
    """``job.collect()`` with ``phase2_hits_reference`` in the kernel's
    place: the reference on the job's own device tensors, through the same
    sort and decode."""
    kernel = cs.phase2_hits
    cs.phase2_hits = scan_hits.phase2_hits_reference
    try:
        return job.collect()
    finally:
        cs.phase2_hits = kernel


def assert_routes_agree(job, at_least=1):
    launches = scan_hits.phase2_launches
    kernel = job.collect()
    assert scan_hits.phase2_launches > launches
    reference = reference_collect(job)
    assert multiset(kernel) == multiset(reference)
    for f in ("spacer_idx", "pos", "strand", "mismatches"):  # both in Hits order
        assert np.array_equal(getattr(kernel, f), getattr(reference, f)), f
    assert len(reference) >= at_least
    return kernel


# --- the dense engine ----------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 1 << 20])
@pytest.mark.parametrize("v", [0, 1, 2, 3])
def test_dense_fused_L20_matches_plain(cuda, monkeypatch, v, batch):
    """Strand-fused L = 20 (one pair list, both strands' rows in one chunk
    buffer), a circular contig with a hit across the origin and 600 guides,
    so S is not a multiple of the block height and pad rows exist. The
    reference runs in batches of one pair or in one batch."""
    contig, library = planted(11 + v, n=40_000, L=20, pam_site="AGG", n_random=576)
    prep, job = dense_job(library, contig, v, "NGG", cuda)
    assert prep.fused and prep.S % prep.bs and prep.S_pad > prep.S
    monkeypatch.setattr(scan_hits, "_phase2_batch", lambda BS_M, P2: batch)
    got = assert_routes_agree(job, at_least=12)
    n = contig.length
    assert (0, n - 10, 0, 0) in multiset(got)  # across the origin


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["circular", "linear"])
@pytest.mark.parametrize("v", [0, 1, 2, 3])
def test_dense_additive_L32_matches_plain(cuda, v, topology):
    """L = 32 with NGNC: no spare G row, so phase 1 runs once a strand and
    the kernel takes the forward list, then the reverse one whose rows are
    the chunks' second half; a linear contig ends in out-of-bounds codes."""
    contig, library = planted(21 + v, n=30_000, L=32, pam_site="AGTC", topology=topology,
                              n_random=40)
    prep, job = dense_job(library, contig, v, "NGNC", cuda)
    assert not prep.fused and set(job.phase1) == {0, 1}
    assert_routes_agree(job, at_least=10)


@pytest.mark.gpu
def test_dense_wide_subtiles_matches_plain(cuda):
    """Subtiles of 1,024 columns: two thread blocks a pair."""
    contig, library = planted(31, n=40_000, L=20, pam_site="TGG", n_random=100)
    prep, job = dense_job(library, contig, 2, "NGG", cuda, P=4096, sub_width=1024)
    assert prep.P2 == 1024
    assert_routes_agree(job, at_least=12)


# --- the site engine -----------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("L,pam,site", [(20, "NGG", "CGG"), (32, "NGNC", "AGTC")])
@pytest.mark.parametrize("v", [0, 1, 2, 3])
def test_site_engine_matches_plain(cuda, v, L, pam, site):
    contig, library = planted(41 + v, n=50_000, L=L, pam_site=site, n_random=300)
    prep, job = site_job(library, contig, v, pam, cuda)
    assert prep.S % prep.bs
    got = assert_routes_agree(job, at_least=12)
    assert (0, contig.length - L // 2, 0, 0) in multiset(got)


@pytest.mark.gpu
def test_site_columns_past_n_valid_never_hit(cuda):
    """Columns at or past n_sites hold a planted spacer's codes here (the
    table pads them with N): the kernel leaves them out, as the reference
    does."""
    contig, library = planted(51, n=20_000, L=20, pam_site="TGG", n_random=50)
    prep, job = site_job(library, contig, 0, "NGG", cuda)
    tab = job.table
    codes = tab.codes_lp.clone()
    q = torch.from_numpy(spacer_matrix(library[:1])[0]).to(cuda)
    codes[:20, tab.n_sites:] = q[:, None]
    last = tab.n_sites // prep.P2  # the subtile holding the last sites
    n_sb = prep.S_pad // prep.bs
    pair = torch.tensor([last // prep.SUB * (-(-n_sb // 8) * 8) * prep.SUB + last % prep.SUB],
                        device=cuda)
    kw = dict(L=20, v=0, BS_M=prep.bs, P2=prep.P2, n_sb_pad8=-(-n_sb // 8) * 8, SUB=prep.SUB,
              S=prep.S, n_sub=tab.n_sites_b // prep.P2, code_stride=tab.n_sites_b,
              half_blocks=n_sb)
    qc = prep.chunks("f")
    want = scan_hits.phase2_hits_reference(qc, codes, pair, n_valid=tab.n_sites,
                                           **kw).cpu().numpy()
    got = scan_hits.phase2_hits(qc, codes, pair, n_valid=tab.n_sites, **kw).cpu().numpy()
    assert Counter(map(tuple, got.tolist())) == Counter(map(tuple, want.tolist()))
    assert (got[:, 1] < tab.n_sites).all()
    everything = scan_hits.phase2_hits(qc, codes, pair, **kw).cpu()  # no n_valid: they hit
    assert (everything[:, 1] >= tab.n_sites).sum() == (last + 1) * prep.P2 - tab.n_sites


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["dense", "site"])
def test_one_column_many_rows(cuda, engine):
    """300 guides within 0-2 mismatches of one planted site: one column hit
    by every row of a block, the warps' appends all at once."""
    rng = np.random.default_rng(61)
    rec = make_record(n=20_000, seed=61)
    g = random_seq(20, rng)
    plant_guide(rec, g, 5_000, pam="TGG")
    library = set()
    while len(library) < 300:
        s = list(g)
        for at in rng.choice(20, int(rng.integers(3)), replace=False):
            s[at] = "ACGT"[int(rng.integers(4))]
        library.add("".join(s))
    make = dense_job if engine == "dense" else site_job
    _prep, job = make(sorted(library), contig_from_record(rec), 2, "NGG", cuda)
    got = assert_routes_agree(job, at_least=300)
    assert sum(p == 5_000 for _, p, _, _ in multiset(got)) == 300


@pytest.mark.gpu
def test_a_full_buffer_relaunches_once(cuda, monkeypatch):
    """A capacity of one record: the kernel counts past it, phase2_hits
    relaunches once with room for every hit, and run_targets reports the
    relaunch in its counters."""
    from barcoder_tpu.core.genome import Genome
    from barcoder_tpu.seqio.library import BarcodeLibrary
    from barcoder_tpu_torch.pipeline.targets import run_targets

    contig, library = planted(71, n=30_000, L=20, pam_site="AGG", n_random=20)
    _prep, job = dense_job(library, contig, 2, "NGG", cuda)
    want = multiset(reference_collect(job))
    monkeypatch.setattr(scan_hits, "phase2_capacity", lambda n_pairs, S: 1)
    before = scan_hits.phase2_relaunches
    assert multiset(job.collect()) == want
    assert scan_hits.phase2_relaunches == before + 1
    tr = run_targets(BarcodeLibrary([(f"g{i}", s) for i, s in enumerate(library)]),
                     Genome([contig], source="synthetic"), "NGG", 2, backend="cuda")
    counters = tr.stats["profile"]["counters"]
    assert counters["scan.phase2_relaunches"] == 1
    assert counters["scan.phase2_hits"] == counters["hits"] == len(want)
