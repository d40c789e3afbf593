"""The port's dense scan engine (barcoder_tpu_torch.ops.cuda_scan with
``site_mode="never"``, on the CPU with the kernel's plain version) and its
plain torch scan held against
the JAX package: ``pallas_scan(..., interpret=True, site_mode="never")``,
``jax_scan`` and ``oracle_scan``.

Every comparison is EXACT: Hits are integer tables (spacer, position,
strand, mismatches), compared as sorted arrays. Planted guides give truth
that does not depend on the shared prep code. Cases follow test_scan.py,
test_spec_extract.py, test_mask_boundary.py and test_device_masks.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from barcoder_tpu.core.encode import encode
from barcoder_tpu.core.genome import Contig, contig_from_record
from barcoder_tpu.core.pam import pam_site_masks
from barcoder_tpu.ops import pallas_scan as ps
from barcoder_tpu.ops.oracle import oracle_scan
from barcoder_tpu.ops.ref_scan import jax_scan
from barcoder_tpu_torch.ops import cuda_scan as cs
from barcoder_tpu_torch.ops import scan_hits
from barcoder_tpu_torch.ops.oracle import oracle_scan as port_oracle_scan
from barcoder_tpu_torch.ops.prep import build_scan_array, spacer_matrix
from barcoder_tpu_torch.ops.ref_scan import torch_scan
from barcoder_tpu_torch.ops.scan_hits import phase2_hits_reference
from barcoder_tpu_torch.ops.types import STRAND_F, STRAND_R, Hits

from .genomes import make_record, plant_guide, random_seq
from .test_torch_site import site_isolation  # noqa: F401  (autouse)

torch.set_num_threads(1)

CPU = torch.device("cpu")
P = 512


def tuples(h: Hits):
    return set(zip(h.spacer_idx.tolist(), h.pos.tolist(), h.strand.tolist(),
                   h.mismatches.tolist()))


def assert_same(a: Hits, b: Hits):
    for f in ("spacer_idx", "pos", "strand", "mismatches"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def scan_all(spacers, contig, v, pam="", direction="downstream", pallas=True):
    """The port's engine and torch scan against the reference engines;
    returns the agreed Hits."""
    want = oracle_scan(spacers, contig, v, pam, direction)
    got = cs.cuda_scan(spacers, contig, v, pam, direction, P=P, device=CPU, site_mode="never")
    assert_same(got, want)
    assert_same(torch_scan(spacers, contig, v, pam, direction), want)
    assert_same(port_oracle_scan(spacers, contig, v, pam, direction), want)
    assert_same(jax_scan(spacers, contig, v, pam, direction), want)
    if pallas:
        assert_same(
            ps.pallas_scan(spacers, contig, v, pam, direction, P=P, interpret=True,
                           site_mode="never"),
            want,
        )
    return tuples(got)


def planted_case(seed, n=4000, topology="circular", L=20, n_guides=8, pam="TGG"):
    rng = np.random.default_rng(seed)
    rec = make_record(n=n, topology=topology, seed=seed)
    guides = [random_seq(L, rng) for _ in range(n_guides)]
    sites = []
    for i, g in enumerate(guides):
        pos, strand = 137 + i * ((n - 400) // n_guides), "F" if i % 2 else "R"
        plant_guide(rec, g, pos, pam=pam, strand=strand)
        sites.append((i, pos, STRAND_F if strand == "F" else STRAND_R))
    return rec, guides, sites


@pytest.mark.parametrize("topology", ["circular", "linear"])
def test_planted_guides_both_strands(topology):
    rec, guides, sites = planted_case(7, topology=topology)
    got = scan_all(guides, contig_from_record(rec), 2, "NGG")
    for i, pos, strand in sites:
        assert (i, pos, strand, 0) in got


def test_circular_wrap_and_n_at_origin():
    """A guide planted across the origin is found at its canonical start;
    an N at position 0 never matches (the JAX engine's scatter-max
    regression)."""
    rng = np.random.default_rng(17)
    g = random_seq(20, rng)
    rec = make_record(n=4000, topology="circular", seed=17)
    plant_guide(rec, g, 3990, pam="AGG")  # 10 bases before the origin
    plant_guide(rec, g, 1990, pam="CGG", strand="R")
    got = scan_all([g], contig_from_record(rec), 1, "NGG")
    assert (0, 3990, STRAND_F, 0) in got and (0, 1990, STRAND_R, 0) in got

    rec = make_record(n=4000, topology="circular", seed=18)
    plant_guide(rec, g, 600, pam="TGG")
    rec.seq = "N" + rec.seq[1:]
    probe = "A" + rec.seq[1:20]  # would match at 0 but for the N
    contig = contig_from_record(rec)
    got = scan_all([g, probe], contig, 0, "NGG")
    assert (0, 600, STRAND_F, 0) in got
    assert not any(si == 1 and p == 0 for si, p, _, _ in got)
    got_nopam = scan_all([g, probe], contig, 1, "")
    assert (1, 0, STRAND_F, 1) in got_nopam  # the N costs one mismatch


def test_linear_edges():
    rng = np.random.default_rng(23)
    rec = make_record(n=4000, topology="linear", seed=23)
    g = random_seq(20, rng)
    plant_guide(rec, g, 0, pam="CGG")  # first window
    plant_guide(rec, g, 4000 - 23, pam="TGG")  # last window with its PAM
    got = scan_all([g], contig_from_record(rec), 1, "NGG")
    assert (0, 0, STRAND_F, 0) in got and (0, 3977, STRAND_F, 0) in got
    # windows running past the end are never reported on a linear contig
    rec.seq = rec.seq[:3990] + g[:10]
    got = scan_all([g], contig_from_record(rec), 3, "")
    assert not any(p > 3980 for _, p, _, _ in got)


@pytest.mark.parametrize("topology", ["linear", "circular"])
def test_contig_shorter_than_spacer(topology):
    seq = "ACGTACGTAC"
    tiny = Contig(id="t", length=10, codes=encode(seq), seq=seq, topology=topology)
    assert len(cs.cuda_scan(["A" * 20], tiny, 1, "NGG", P=P, device=CPU, site_mode="never")) == 0
    scan_all(["A" * 20], tiny, 1, "NGG")


@pytest.mark.parametrize("pam,direction", [
    ("GG", "upstream"), ("GG", "downstream"), ("NG", "upstream"), ("NGG", "downstream"),
])
def test_circular_contig_shorter_than_max_pam(pam, direction):
    """An 8-bp circular contig: the PAM mask's left halo must wrap several
    times (modular gather, not a clamped slice)."""
    seq = "ACGTACGG"
    contig = Contig(id="tiny", length=8, codes=encode(seq), seq=seq, topology="circular")
    scan_all(["ACGT", "CGGA", "GTAC"], contig, 1, pam, direction)
    L, n_b = 4, 512
    scan = build_scan_array(contig, L)
    dev = torch.from_numpy(cs.prep_scan_padded(contig, scan, L, n_b, 32 + cs.MAX_PAM))
    host_f, host_r = pam_site_masks(contig, L, pam, direction)
    shift_f, pat_f, shift_r, pat_r = cs._pam_specs(pam, direction, L)
    for shift, pat, host in ((shift_f, pat_f, host_f), (shift_r, pat_r, host_r)):
        ok = cs._pam_ok_device(dev, 8, shift, cs._pat_arr(pat), n_starts_b=n_b, L=L,
                               circular=True)
        assert np.array_equal(ok.numpy()[:8], host[:8])


def test_upstream_pam():
    rng = np.random.default_rng(11)
    rec = make_record(n=4000, seed=11)
    g = random_seq(20, rng)
    plant_guide(rec, g, 800, pam="TTTC", pam_direction="upstream")
    plant_guide(rec, g, 2400, pam="TTTA", strand="R", pam_direction="upstream")
    got = scan_all([g], contig_from_record(rec), 0, "TTTN", "upstream")
    assert (0, 800, STRAND_F, 0) in got and (0, 2400, STRAND_R, 0) in got


def test_empty_library():
    contig = contig_from_record(make_record(n=3000, seed=70))
    assert len(cs.cuda_scan([], contig, 1, "NGG", P=P, device=CPU, site_mode="never")) == 0
    assert [len(h) for h in cs.cuda_scan_contigs([], [contig, contig], 1, "NGG", P=P,
                                                 device=CPU, site_mode="never")] == [0, 0]
    assert len(torch_scan([], contig, 1, "NGG")) == 0


def test_pam_longer_than_max_pam():
    """PAMs over MAX_PAM take the plain torch scan, as the JAX engine routes
    them to jax_scan."""
    rng = np.random.default_rng(61)
    rec = make_record(n=4000, seed=61)
    g = random_seq(20, rng)
    plant_guide(rec, g, 600, pam="AGGTGGCGGAGGA")
    pam = "NGGNGGNGGNGGN"
    assert len(pam) > cs.MAX_PAM
    got = scan_all([g], contig_from_record(rec), 1, pam)
    assert (0, 600, STRAND_F, 0) in got


def test_l32_per_strand_additive():
    """L = 32 leaves no spare G row (4L = K): phase 1 runs once per strand
    with the bias added after the product."""
    rec, guides, sites = planted_case(31, L=32, n_guides=4, pam="AGTC")
    got = scan_all(guides, contig_from_record(rec), 1, "NGNC")
    prep = cs._QPrep(spacer_matrix(guides), 1, "NGNC", "downstream", P, 512, CPU)
    assert not prep.fused
    for i, pos, strand in sites:
        assert (i, pos, strand, 0) in got


def test_spec_overflow_takes_batched_phase2(monkeypatch):
    """Phase 2's reference in batches of one pair gives the table of one
    batch."""
    rec, guides, sites = planted_case(9)
    contig = contig_from_record(rec)
    one_batch = scan_all(guides, contig, 2, "NGG")
    monkeypatch.setattr(scan_hits, "_phase2_batch", lambda BS_M, P2: 1)
    got = scan_all(guides, contig, 2, "NGG", pallas=False)
    assert got == one_batch
    for i, pos, strand in sites:
        assert (i, pos, strand, 0) in got


def test_dense_repeats_in_one_subtile(monkeypatch):
    """Many hits of one spacer in one subtile, with phase 2's reference in
    one batch and in batches of one pair."""
    rng = np.random.default_rng(19)
    rec = make_record(n=4000, seed=19)
    g = random_seq(20, rng)
    positions = list(range(1000, 1000 + 17 * 24, 24))
    for p in positions:
        plant_guide(rec, g, p, pam="TGG")
    contig = contig_from_record(rec)
    got = scan_all([g], contig, 0, "NGG")
    monkeypatch.setattr(scan_hits, "_phase2_batch", lambda BS_M, P2: 1)
    assert got == scan_all([g], contig, 0, "NGG", pallas=False)
    assert sum((0, p, STRAND_F, 0) in got for p in positions) >= 12


def test_multi_contig_shared_prep():
    """One library prep over several contigs; results in input order."""
    recs = [planted_case(s, n=n, topology=t)[0]
            for s, n, t in ((41, 4000, "circular"), (42, 3000, "linear"), (43, 1500, "circular"))]
    _, guides, _ = planted_case(41)
    contigs = [contig_from_record(r) for r in recs]
    got = cs.cuda_scan_contigs(guides, contigs, 2, "NGG", P=P, device=CPU, site_mode="never")
    for h, c in zip(got, contigs):
        assert_same(h, oracle_scan(guides, c, 2, "NGG"))


@pytest.mark.parametrize("v", [0, 1, 3])
def test_random_agreement_with_ns(v):
    rng = np.random.default_rng(42 + v)
    rec = make_record(n=4000, seed=42 + v)
    s = list(rec.seq)
    for i in rng.choice(4000, 40, replace=False):
        s[i] = "N"
    rec.seq = "".join(s)
    spacers = [rec.seq[p : p + 20].replace("N", "A")
               for p in rng.integers(0, 3900, 12)]
    scan_all(spacers, contig_from_record(rec), v, "NGG", pallas=(v == 1))


@pytest.mark.parametrize("topology", ["circular", "linear"])
@pytest.mark.parametrize("L", [20, 32])
@pytest.mark.parametrize("pam,direction", [
    ("NGG", "downstream"), ("NGNC", "downstream"), ("TTTNNNGGGCCC", "downstream"),
    ("TTTN", "upstream"), ("", "downstream"), ("CC", "upstream"),
])
def test_device_mask_and_tiles_match_jax(topology, L, pam, direction):
    """_pam_ok_device and _tiles_device_impl against the JAX functions on
    one scan array, and the mask against the host masks (every boundary
    position included)."""
    rec = make_record(n=1200, topology=topology, seed=5)
    rec.seq = "G" * 40 + rec.seq[40:-40] + "N" + "G" * 39
    contig = contig_from_record(rec)
    n = contig.length
    n_b = cs._geom_bucket(n, 256)
    scan = cs.prep_scan_padded(contig, build_scan_array(contig, L), L, n_b, 32 + cs.MAX_PAM)
    dev = torch.from_numpy(scan)
    host = pam_site_masks(contig, L, pam, direction)
    specs = cs._pam_specs(pam, direction, L)
    for (shift, pat), h in zip((specs[:2], specs[2:]), host):
        got = cs._pam_ok_device(dev, n, shift, cs._pat_arr(pat), n_starts_b=n_b, L=L,
                                circular=contig.circular).numpy()
        want = np.asarray(ps._pam_ok_device(
            jnp.asarray(scan), jnp.int32(n), jnp.int32(shift), jnp.asarray(cs._pat_arr(pat)),
            n_starts_b=n_b, L=L, circular=contig.circular,
        ))
        assert np.array_equal(got, want)
        assert np.array_equal(got[:n], h) and not got[n:].any()
    tiles = cs._tiles_device_impl(dev, n_starts=n_b, P=256, halo=32).numpy()
    want = np.asarray(ps._tiles_device_impl(jnp.asarray(scan), n_starts=n_b, P=256, halo=32))
    assert np.array_equal(tiles, want)


@pytest.mark.parametrize("L,pam", [(20, "NGG"), (32, "NGNC")])
def test_phase1_on_identical_state(L, pam):
    """state_from_numpy: the JAX engine's own prep state (one-hot rows,
    threshold, device scan array) fed to the port's phase 1 gives the JAX
    phase 1's (subtile, spacer-block) pairs, strand-fused (L = 20) and per
    strand (L = 32)."""
    rec, guides, _ = planted_case(3, L=L, n_guides=6, pam="AGG" if L == 20 else "AGTC")
    contig = contig_from_record(rec)
    q_f = spacer_matrix(guides)
    jprep = ps._QPrep(q_f, 2, pam, "downstream", P, 128)
    job = ps._ScanJob(jprep, contig, True)
    state = cs.state_from_numpy(
        thresh=np.asarray(jprep.thresh_dev), scan=np.asarray(job.scan_dev),
        q_all=None if jprep.q_all is None else np.asarray(jprep.q_all),
        q_f=np.asarray(jprep.q_dev[STRAND_F]), q_r=np.asarray(jprep.q_dev[STRAND_R]),
        device=CPU,
    )
    pat = {s: np.asarray(jprep.pat_dev[s]) for s in (STRAND_F, STRAND_R)}
    shift = {s: int(jprep.shift_dev[s]) for s in (STRAND_F, STRAND_R)}
    geo = dict(n_starts=job.n_starts_b, P=P, halo=jprep.halo, L=L, K=jprep.K,
               SUB=jprep.SUB, BS_M=jprep.bs, circular=True)
    if jprep.fused:
        keyed = {"fused": cs.phase1_fused(
            state["scan"], contig.length, state["q_all"], shift[STRAND_F], pat[STRAND_F],
            shift[STRAND_R], pat[STRAND_R], state["thresh"], **geo)}
    else:
        keyed = {s: cs.phase1_full(state["scan"], contig.length,
                                   state["q_f" if s == STRAND_F else "q_r"], shift[s],
                                   pat[s], state["thresh"], **geo)
                 for s in (STRAND_F, STRAND_R)}
    assert set(keyed) == set(job.futures)
    n_total = 0
    for key, pairs in keyed.items():
        j_pairs, _, j_n = (np.asarray(x) for x in job.futures[key])
        assert np.array_equal(pairs.numpy(), j_pairs[: int(j_n)])
        n_total += int(j_n)
    assert n_total > 0
    # the port's engine on this contig agrees with the JAX engine's Hits
    assert_same(cs.cuda_scan(guides, contig, 2, pam, P=P, sub_width=128, device=CPU,
                             site_mode="never"), job.collect())


@pytest.mark.parametrize("L,pam,site", [(20, "NGG", "AGG"), (32, "NGNC", "AGTC")])
def test_phase2_kernel_route_on_the_model(L, pam, site):
    """The dense engine's one phase-2 route (phase 1's pair lists, the PAM
    masks and the chunk buffer, as the card gets them) with the kernel's
    reference on the CPU gives the oracle's Hits in Hits order,
    strand-fused at L = 20 and per strand at L = 32, pad rows included."""
    rec, guides, sites = planted_case(61 + L, L=L, n_guides=6, pam=site)
    contig = contig_from_record(rec)
    library = guides + [random_seq(L, np.random.default_rng(L)) for _ in range(5)]
    prep = cs._QPrep(spacer_matrix(library), 2, pam, "downstream", P, 512, CPU)
    job = cs._ScanJob(prep, contig)
    assert job.qc is prep.chunks("fr") and prep.fused == (L == 20) and prep.S_pad > prep.S
    got = job.collect()
    assert_same(got, oracle_scan(library, contig, 2, pam))
    for i, pos, strand in sites:
        assert (i, pos, strand, 0) in tuples(got)


@pytest.mark.parametrize("site_mode", ["never", "always"])
def test_cpu_route_takes_the_plain_phase2(monkeypatch, site_mode):
    """On the CPU both engines' phase 2 goes through ``phase2_hits`` into
    its reference: no kernel is built or launched, the hits are counted and
    nothing relaunches."""
    from barcoder_tpu_torch.ops import nvcc

    def no_kernel(*args, **kwargs):
        raise AssertionError("the CPU route reached a kernel")

    calls = []

    def reference(*args, **kwargs):
        calls.append(args[0].device)
        return phase2_hits_reference(*args, **kwargs)

    monkeypatch.setattr(nvcc, "launcher", no_kernel)
    monkeypatch.setattr(scan_hits, "phase2_hits_reference", reference)
    rec, guides, sites = planted_case(67)
    contig = contig_from_record(rec)
    hits0, launches0 = cs.phase2_hit_count, scan_hits.phase2_launches
    relaunches0 = scan_hits.phase2_relaunches
    got = cs.cuda_scan(guides, contig, 2, "NGG", P=P, device=CPU, site_mode=site_mode)
    assert_same(got, oracle_scan(guides, contig, 2, "NGG"))
    assert calls == [CPU]
    assert cs.phase2_hit_count - hits0 == len(got) >= len(sites)
    assert scan_hits.phase2_launches == launches0
    assert scan_hits.phase2_relaunches == relaunches0
