"""The port's sharded site-compacted engine (barcoder_tpu_torch.parallel
.sharded_scan: ``_SiteScanRun``, ``sharded_scan_many``, the site path of
``sharded_scan_contigs``) held against the JAX package's ``sharded_scan``
with ``site_mode="always"`` (8 fake CPU devices) and the numpy oracle.

Every comparison is EXACT: equal sets of (spacer, position, strand,
mismatches) tuples. The port runs on meshes that repeat the CPU device: 1,
2 and 8 genome shards, and (library, genome) grids.
"""

import numpy as np
import pytest
import torch

import jax

import barcoder_tpu.parallel.sharded_scan as jax_ss
from barcoder_tpu.core.genome import contig_from_record
from barcoder_tpu.ops.oracle import oracle_scan
from barcoder_tpu.parallel import mesh as jax_mesh
from barcoder_tpu_torch.ops import cuda_scan as cs
from barcoder_tpu_torch.parallel import sharded_scan as ss
from barcoder_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

from .genomes import make_record, plant_guide, random_seq
from .test_torch_site import site_isolation  # noqa: F401  (autouse)

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def tuples(h):
    return set(zip(h.spacer_idx.tolist(), h.pos.tolist(), h.strand.tolist(),
                   h.mismatches.tolist()))


@pytest.fixture(scope="module")
def jax_mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 fake devices"
    return jax_mesh.make_mesh(8)


def port_meshes():
    return [make_mesh(devices=CPU8[:n]) for n in (1, 2, 8)] + [make_mesh_2d(2, 4, devices=CPU8)]


def check(spacers, contig, v, jax_mesh8, *, pam, meshes=None, **kw):
    """Port site engine on every mesh == JAX site engine == oracle."""
    want = tuples(oracle_scan(spacers, contig, v, pam=pam,
                              pam_direction=kw.get("pam_direction", "downstream")))
    assert tuples(jax_ss.sharded_scan(spacers, contig, v, pam=pam, mesh=jax_mesh8,
                                      site_mode="always", **kw)) == want
    for mesh in meshes or port_meshes():
        got = tuples(ss.sharded_scan(spacers, contig, v, pam=pam, mesh=mesh,
                                     site_mode="always", **kw))
        assert got == want, mesh.shape
    return want


@pytest.mark.parametrize("topology", ["circular", "linear"])
@pytest.mark.parametrize("v", [0, 2])
def test_site_engine_agreement(jax_mesh8, topology, v):
    rng = np.random.default_rng(v)
    rec = make_record(n=9000, topology=topology, seed=v)
    spacers = [random_seq(20, rng) for _ in range(5)]
    for i, s in enumerate(spacers):
        plant_guide(rec, s, 700 + 1500 * i, pam="TGG", strand="F" if i % 2 else "R")
    hits = check(spacers, contig_from_record(rec), v, jax_mesh8, pam="NGG", P=256)
    assert {(i, 700 + 1500 * i, 0) for i in range(5)} <= {h[:2] + (h[3],) for h in hits}


def test_upstream_pam_n_bases_and_subtiles(jax_mesh8):
    rng = np.random.default_rng(31)
    rec = make_record(n=6000, topology="circular", seed=31)
    g = random_seq(20, rng)
    plant_guide(rec, g, 400, pam="TTN", pam_direction="upstream")
    plant_guide(rec, g, 5990, pam="TTA", pam_direction="upstream")  # wraps
    s = list(rec.seq)
    s[402] = "N"
    rec.seq = "".join(s)
    hits = check([g], contig_from_record(rec), 1, jax_mesh8, pam="TTN",
                 pam_direction="upstream", P=512, sub_width=128)
    assert {400, 5990} <= {p for _, p, _, _ in hits}


def test_L32(jax_mesh8):
    rng = np.random.default_rng(5)
    rec = make_record(n=6000, topology="circular", seed=5)
    spacers = [random_seq(32, rng) for _ in range(4)]
    for i, s in enumerate(spacers):
        plant_guide(rec, s, 800 + 1200 * i, pam="TGG", strand="F" if i % 2 else "R")
    hits = check(spacers, contig_from_record(rec), 1, jax_mesh8, pam="NGG", P=256)
    assert {(i, 800 + 1200 * i) for i in range(4)} <= {h[:2] for h in hits}


@pytest.mark.parametrize("n_lib,n_gen", [(2, 4), (4, 2), (8, 1)])
def test_library_axis_sharding(n_lib, n_gen):
    # 300 spacers span 3 blocks of 128 rows: library shards hold unequal
    # real block counts, exercising the shard-local → global spacer map
    rng = np.random.default_rng(3)
    rec = make_record(n=6000, topology="circular", seed=3)
    spacers = [random_seq(20, rng) for _ in range(300)]
    for i in (0, 129, 257, 299):
        plant_guide(rec, spacers[i], 500 + 37 * i, pam="AGG", strand="F" if i % 2 else "R")
    hits = check(spacers, contig_from_record(rec), 1, jax_mesh.make_mesh_2d(n_lib, n_gen),
                 pam="NGG", P=256, meshes=[make_mesh_2d(n_lib, n_gen, devices=CPU8)])
    assert {0, 129, 257, 299} <= {s for s, *_ in hits}


def test_contigs_windowed_in_input_order(jax_mesh8):
    recs = [make_record(n=n, topology=t, seed=s)
            for n, t, s in ((5000, "circular", 1), (3000, "linear", 2), (700, "circular", 3))]
    rng = np.random.default_rng(4)
    guides = [random_seq(20, rng) for _ in range(6)]
    for i, g in enumerate(guides):
        plant_guide(recs[i % 3], g, 50 + 80 * i, pam="TGG")
    contigs = [contig_from_record(r) for r in recs]
    contigs = contigs + contigs[:1]
    want = [tuples(h) for h in jax_ss.sharded_scan_contigs(guides, contigs, 2, "NGG",
                                                           mesh=jax_mesh8, P=256)]
    for max_pending in (1, 4):
        got = ss.sharded_scan_contigs(guides, contigs, 2, "NGG", mesh=make_mesh(devices=CPU8[:2]),
                                      P=256, max_pending=max_pending)
        assert [tuples(h) for h in got] == want
    for h, c in zip(want, contigs):
        assert h == tuples(oracle_scan(guides, c, 2, "NGG"))


def test_want_sites_matches_jax():
    for pam in ("", "N", "NN", "NGG", "TTTN", "NGNC"):
        for mode in ("auto", "never", "always"):
            assert ss._want_sites(pam, mode) == jax_ss._want_sites(pam, mode), (pam, mode)
    with pytest.raises(ValueError, match="site_mode"):
        ss._want_sites("NGG", "sites")


def test_auto_takes_sites_for_informative_pams(monkeypatch):
    """Unlike the one-card engine, the sharded engine sends every scan with
    an informative PAM to the site engine on its first call."""
    runs = []
    real = ss._SiteScanRun
    monkeypatch.setattr(ss, "_SiteScanRun", lambda *a, **k: runs.append(a[3]) or real(*a, **k))
    contig = contig_from_record(make_record(n=3000, seed=8))
    mesh = make_mesh(devices=CPU8[:2])
    for pam, mode in (("NGG", "auto"), ("N", "auto"), ("", "always"), ("NGG", "never"),
                      ("N", "always")):
        got = ss.sharded_scan(["ACGTACGTACGTACGTACGT"], contig, 3, pam, mesh=mesh, P=256,
                              site_mode=mode)
        assert tuples(got) == tuples(oracle_scan(["ACGTACGTACGTACGTACGT"], contig, 3, pam))
    assert runs == ["NGG", "N"]


def test_shares_the_site_artifact_with_the_one_card_engine(monkeypatch):
    rng = np.random.default_rng(9)
    rec = make_record(n=4000, seed=9)
    g = random_seq(20, rng)
    plant_guide(rec, g, 900, pam="AGG")
    contig = contig_from_record(rec)
    want = tuples(cs.cuda_scan([g], contig, 1, "NGG", P=512, device="cpu", site_mode="always"))
    monkeypatch.setattr(cs, "enumerate_sites", lambda *a, **k: pytest.fail("enumerated"))
    got = tuples(ss.sharded_scan([g], contig, 1, "NGG", mesh=make_mesh(devices=CPU8[:4]), P=256))
    assert got == want and (0, 900, 0, 0) in got
    assert ss.serving_cache_stats()["site_host"]["misses"] == 1


# --- serving: sharded_scan_many ---------------------------------------------

def _serving_set(n_libs, per_lib, seed):
    rng = np.random.default_rng(seed)
    rec = make_record(n=9000, topology="circular", seed=seed)
    libs = []
    for k in range(n_libs):
        spacers = [random_seq(20, rng) for _ in range(per_lib)]
        plant_guide(rec, spacers[0], 400 + 1000 * k, pam="TGG")
        libs.append(spacers)
    return libs, contig_from_record(rec)


def test_many_equals_solo_scans_and_jax(jax_mesh8):
    libs, contig = _serving_set(5, 4, 9)
    jax_many = jax_ss.sharded_scan_many(libs, contig, 1, pam="NGG", mesh=jax_mesh8, P=256,
                                        max_pending=2)
    for mesh in (make_mesh(devices=CPU8[:2]), make_mesh_2d(2, 4, devices=CPU8)):
        many = ss.sharded_scan_many(libs, contig, 1, pam="NGG", mesh=mesh, P=256, max_pending=2)
        assert len(many) == len(libs)
        for spacers, hits, ref in zip(libs, many, jax_many):
            solo = tuples(ss.sharded_scan(spacers, contig, 1, pam="NGG", mesh=mesh, P=256))
            assert tuples(hits) == solo == tuples(ref)
    assert sum(len(tuples(h)) for h in jax_many) >= 5


def test_serving_cache_eviction(monkeypatch):
    """More libraries than the library-side cache holds: results stay exact
    through evictions, and a warm pass over a working set that fits is all
    hits, with no bytes built (the JAX test_parallel.py serving pin, on the
    port's cache counters)."""
    small = ss._ShardCache(max_entries=4)
    monkeypatch.setattr(ss, "_Q_SHARD_CACHE", small)
    libs, contig = _serving_set(8, 3, 21)
    kw = dict(mesh=make_mesh(devices=CPU8), P=256)
    pass1 = ss.sharded_scan_many(libs, contig, 1, pam="NGG", **kw)
    st1 = small.stats()
    assert st1["evictions"] > 0 and st1["entries"] <= 4
    for spacers, hits in zip(libs, pass1):
        assert tuples(hits) == tuples(ss.sharded_scan(spacers, contig, 1, pam="NGG", **kw))
    assert sum(len(tuples(h)) for h in pass1) >= 8
    small.reset_stats()
    pass3 = ss.sharded_scan_many(libs[-2:], contig, 1, pam="NGG", **kw)
    st3 = small.stats()
    assert st3["misses"] == 0 and st3["bytes_built"] == 0 and st3["hits"] > 0, st3
    for h, ref in zip(pass3, pass1[-2:]):
        assert tuples(h) == tuples(ref)
    stats = ss.serving_cache_stats(reset=True)
    assert set(stats) == {"genome", "q", "site_host"} and stats["genome"]["misses"] >= 1
    assert ss.serving_cache_stats()["genome"] == dict(stats["genome"], hits=0, misses=0,
                                                      evictions=0, bytes_built=0)


def test_many_requires_pam():
    rec = make_record(n=2000, seed=1)
    with pytest.raises(ValueError, match="PAM"):
        ss.sharded_scan_many([["A" * 20]], contig_from_record(rec), 0, pam="",
                             mesh=make_mesh(devices=CPU8[:2]))


def test_many_and_contigs_reject_oversized_spacers():
    contig = contig_from_record(make_record(n=2000, seed=3))
    mesh = make_mesh(devices=CPU8[:2])
    with pytest.raises(ValueError, match="up to 63"):
        ss.sharded_scan_many([["A" * 70]], contig, 0, pam="NGG", mesh=mesh)
    with pytest.raises(ValueError, match="up to 63"):
        ss.sharded_scan_contigs(["A" * 70], [contig], 0, pam="NGG", mesh=mesh)
    with pytest.raises(ValueError, match="up to 63"):
        ss.sharded_scan(["A" * 64], contig, 0, pam="NGG", mesh=mesh, site_mode="always")
