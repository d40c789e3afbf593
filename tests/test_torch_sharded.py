"""The port's sharded engine (barcoder_tpu_torch.parallel.sharded_scan)
held against the JAX package's sharded_scan (8 fake CPU devices, its pure-jnp
phase 1) and the numpy oracle, on the cases of tests/test_parallel.py. Both
engines send a scan with an informative PAM to their site engine under
``site_mode="auto"``, and every other scan to the dense engine.

Every comparison is EXACT: equal sets of (spacer, position, strand,
mismatches) tuples. Each case runs the port on meshes of 1, 2 and 8 CPU
shards (a mesh may repeat a device; the CPU stands in for the cards) and
keeps planted guides as independent ground truth, since the oracle shares
ops/prep with every engine. The JAX engine runs once per case on its
8-device mesh: its Hits do not depend on the mesh.

The poly-A genome (every position hits) takes the place of the JAX
capacity-retry test: the port has no capacities to overflow.
"""

import numpy as np
import pytest
import torch

import jax

from barcoder_tpu.core.genome import contig_from_record
from barcoder_tpu.ops.oracle import oracle_scan
from barcoder_tpu.parallel import mesh as jax_mesh
from barcoder_tpu.parallel.sharded_scan import sharded_scan as jax_sharded_scan
from barcoder_tpu_torch.ops import scan_hits
from barcoder_tpu_torch.parallel import sharded_scan as ss
from barcoder_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

from .genomes import make_record, plant_guide, random_seq
from .test_torch_site import site_isolation  # noqa: F401  (autouse)

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
SHARDS = (1, 2, 8)


def tuples(h):
    return set(zip(h.spacer_idx.tolist(), h.pos.tolist(), h.strand.tolist(),
                   h.mismatches.tolist()))


def port_mesh(n):
    return make_mesh(devices=CPU8[:n])


@pytest.fixture(scope="module")
def jax_mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 fake devices"
    return jax_mesh.make_mesh(8)


def check_all(spacers, contig, v, jax_mesh8, *, pam="", meshes=None, **kw):
    """Port on every mesh == JAX sharded_scan == oracle; returns the tuples."""
    want = tuples(oracle_scan(spacers, contig, v, pam=pam))
    assert tuples(jax_sharded_scan(spacers, contig, v, pam=pam, mesh=jax_mesh8, **kw)) == want
    for mesh in meshes or [port_mesh(n) for n in SHARDS]:
        got = tuples(ss.sharded_scan(spacers, contig, v, pam=pam, mesh=mesh, **kw))
        assert got == want, mesh.shape
    return want


@pytest.mark.parametrize("topology", ["circular", "linear"])
@pytest.mark.parametrize("site_mode", ["auto", "never"])
def test_agreement(jax_mesh8, topology, site_mode):
    rng = np.random.default_rng(0)
    rec = make_record(n=9000, topology=topology, seed=0)
    spacers = [random_seq(20, rng) for _ in range(5)]
    for i, s in enumerate(spacers):
        plant_guide(rec, s, 700 + 1500 * i, pam="TGG", strand="F" if i % 2 else "R")
    hits = check_all(spacers, contig_from_record(rec), 1, jax_mesh8, pam="NGG", P=256,
                     site_mode=site_mode)
    assert {(i, 700 + 1500 * i, 0) for i in range(5)} <= {h[:2] + (h[3],) for h in hits}


def test_device_boundary_hits(jax_mesh8):
    # planted exactly at the per-shard block boundaries: n=8192, P=256 →
    # B=1024 on 8 shards, B=4224 on 2
    rng = np.random.default_rng(1)
    rec = make_record(n=8192, topology="circular", seed=1)
    g = random_seq(20, rng)
    for p in [1024 - 10, 2048 - 1, 4096 - 19, 8192 - 5]:
        plant_guide(rec, g, p)
    hits = check_all([g], contig_from_record(rec), 0, jax_mesh8, P=256)
    assert {1014, 2047, 4077, 8187} <= {t[1] for t in hits}


@pytest.mark.parametrize("n,topology", [
    (8211, "linear"),    # n_starts = 8192: tail windows
    (8187, "circular"),  # wrap windows
    (8192, "linear"),    # exact multiple, tail band
    (8200, "circular"),
])
def test_boundary_band_geometries(jax_mesh8, n, topology):
    """A window in the band where the shard blocks end within L-1 of
    n_starts must read the real scan tail, not the ring halo."""
    rng = np.random.default_rng(n)
    rec = make_record(n=n, topology=topology, seed=n % 97)
    spacers = [random_seq(20, rng)]
    if topology == "linear":
        spacers.append(rec.seq[n - 20 :])  # the window ending at the tail
    else:
        spacers.append(rec.seq[n - 10 :] + rec.seq[:10])  # across the origin
    hits = check_all(spacers, contig_from_record(rec), 1, jax_mesh8, P=256,
                     site_mode="never")
    assert any(t[0] == 1 for t in hits), "planted tail/wrap spacer lost"


def test_origin_wrap_on_last_device(jax_mesh8):
    rng = np.random.default_rng(2)
    rec = make_record(n=8000, topology="circular", seed=2)
    g = random_seq(20, rng)
    plant_guide(rec, g, 7995)  # wraps the origin; the genome pads to 8192
    hits = check_all([g], contig_from_record(rec), 0, jax_mesh8, P=256)
    assert any(p == 7995 for _, p, _, _ in hits)


def test_L32_per_strand_path(jax_mesh8):
    # 32-mers leave no spare G row (4L == K): one additive launch per strand
    rng = np.random.default_rng(5)
    rec = make_record(n=6000, topology="circular", seed=5)
    spacers = [random_seq(32, rng) for _ in range(4)]
    for i, s in enumerate(spacers):
        plant_guide(rec, s, 800 + 1200 * i, pam="TGG", strand="F" if i % 2 else "R")
    before = scan_hits.launches
    hits = check_all(spacers, contig_from_record(rec), 1, jax_mesh8, pam="NGG", P=256)
    assert scan_hits.launches == before  # CPU shards run the plain version
    assert {(i, 800 + 1200 * i) for i in range(4)} <= {h[:2] for h in hits}


def test_subtile_decode(jax_mesh8):
    # SUB > 1 (sub_width < P): the (tile, subtile) → P2-grid decode
    rng = np.random.default_rng(7)
    rec = make_record(n=8192, topology="circular", seed=7)
    g = random_seq(20, rng)
    for p in [100, 1024 - 3, 3000, 8192 - 7]:
        plant_guide(rec, g, p)
    hits = check_all([g], contig_from_record(rec), 0, jax_mesh8, P=512, sub_width=128)
    assert {100, 1021, 3000, 8185} <= {t[1] for t in hits}


@pytest.mark.parametrize("n_lib,n_gen", [(2, 4), (4, 2), (8, 1)])
def test_library_axis_sharding(n_lib, n_gen):
    # 300 spacers span 3 blocks of 128 rows, so library shards hold unequal
    # real block counts and the shard-local → global spacer map is exercised
    rng = np.random.default_rng(3)
    rec = make_record(n=6000, topology="circular", seed=3)
    spacers = [random_seq(20, rng) for _ in range(300)]
    for i in (0, 129, 257, 299):  # spacers on several library shards
        plant_guide(rec, spacers[i], 500 + 37 * i, pam="AGG", strand="F" if i % 2 else "R")
    hits = check_all(
        spacers, contig_from_record(rec), 1, jax_mesh.make_mesh_2d(n_lib, n_gen), pam="NGG",
        P=256, meshes=[make_mesh_2d(n_lib, n_gen, devices=CPU8), port_mesh(1)],
    )
    assert {0, 129, 257, 299} <= {s for s, *_ in hits}


def test_allN_pam_agrees(jax_mesh8):
    """An all-wildcard PAM takes the dense path in both engines."""
    rng = np.random.default_rng(11)
    rec = make_record(n=6000, seed=11)
    spacers = [random_seq(20, rng) for _ in range(4)]
    plant_guide(rec, spacers[0], 1200, pam="ACA")
    hits = check_all(spacers, contig_from_record(rec), 1, jax_mesh8, pam="N", P=256)
    assert (0, 1200) in {h[:2] for h in hits}


def test_poly_a_every_position_hits(jax_mesh8):
    """Poly-A genome × poly-A spacer: every forward start hits (the reverse
    complement is poly-T), and the port has no capacity to overflow."""
    rec = make_record(n=4096, topology="linear", seed=6)
    rec.seq = "A" * 4096
    hits = check_all(["A" * 20], contig_from_record(rec), 0, jax_mesh8, P=256)
    assert len(hits) == 4096 - 20 + 1


def test_chunked_phase2_agrees(monkeypatch):
    """Phase 2's reference in many small batches gives the same Hits."""
    monkeypatch.setattr(scan_hits, "_phase2_batch", lambda BS_M, P2: 2)
    rng = np.random.default_rng(12)
    rec = make_record(n=9000, topology="circular", seed=12)
    spacers = [random_seq(20, rng) for _ in range(6)]
    for i, s in enumerate(spacers):
        plant_guide(rec, s, 600 + 1200 * i, pam="TGG", strand="F" if i % 2 else "R")
    contig = contig_from_record(rec)
    for pam in ("NGG", ""):
        want = tuples(oracle_scan(spacers, contig, 1, pam=pam))
        for n in SHARDS:
            assert tuples(ss.sharded_scan(spacers, contig, 1, pam=pam, mesh=port_mesh(n),
                                          P=256, sub_width=64)) == want
    rec2 = make_record(n=3000, topology="linear", seed=13)
    rec2.seq = "A" * 3000
    contig2 = contig_from_record(rec2)
    got = tuples(ss.sharded_scan(["A" * 20], contig2, 0, mesh=port_mesh(8), P=256))
    assert got == tuples(oracle_scan(["A" * 20], contig2, 0)) and len(got) == 2981


def test_repeat_scan_ships_nothing():
    """The content-keyed shard caches: a repeat scan over one mesh builds no
    state; another PAM builds its own genome-side state (the site codes of
    the site engine) and reuses the library's."""
    rng = np.random.default_rng(14)
    rec = make_record(n=5000, seed=14)
    spacers = [random_seq(20, rng) for _ in range(3)]
    plant_guide(rec, spacers[1], 900, pam="TGG")
    contig = contig_from_record(rec)
    mesh = port_mesh(2)
    first = tuples(ss.sharded_scan(spacers, contig, 1, pam="NGG", mesh=mesh, P=256))
    misses = (ss._GENOME_SHARD_CACHE.misses, ss._Q_SHARD_CACHE.misses)
    again = tuples(ss.sharded_scan(spacers, contig, 1, pam="NGG", mesh=mesh, P=256))
    assert first == again and (1, 900, 0, 0) in again
    assert (ss._GENOME_SHARD_CACHE.misses, ss._Q_SHARD_CACHE.misses) == misses
    ss.sharded_scan(spacers, contig, 1, pam="NAG", mesh=mesh, P=256)
    assert ss._GENOME_SHARD_CACHE.misses == misses[0] + 1  # the site codes only
    assert ss._Q_SHARD_CACHE.misses == misses[1]
    # the dense engine: its codes blocks do not depend on the PAM, its masks do
    ss.sharded_scan(spacers, contig, 1, pam="NGG", mesh=mesh, P=256, site_mode="never")
    misses = (ss._GENOME_SHARD_CACHE.misses, ss._Q_SHARD_CACHE.misses)
    ss.sharded_scan(spacers, contig, 1, pam="NAG", mesh=mesh, P=256, site_mode="never")
    assert ss._GENOME_SHARD_CACHE.misses == misses[0] + 1  # the masks only
    assert ss._Q_SHARD_CACHE.misses == misses[1]


def test_contigs_in_input_order():
    recs = [make_record(n=n, topology=t, seed=s)
            for n, t, s in ((5000, "circular", 1), (3000, "linear", 2), (700, "circular", 3))]
    rng = np.random.default_rng(4)
    guides = [random_seq(20, rng) for _ in range(6)]
    for i, g in enumerate(guides):
        plant_guide(recs[i % 3], g, 50 + 80 * i, pam="TGG")
    contigs = [contig_from_record(r) for r in recs]
    got = ss.sharded_scan_contigs(guides, contigs + contigs[:1], 2, "NGG", mesh=port_mesh(2),
                                  P=256)
    assert len(got) == 4
    for h, c in zip(got, contigs + contigs[:1]):
        assert tuples(h) == tuples(oracle_scan(guides, c, 2, "NGG"))


def test_empty_and_short_inputs():
    rec = make_record(n=3000, seed=5)
    contig = contig_from_record(rec)
    assert len(ss.sharded_scan([], contig, 1, "NGG", mesh=port_mesh(2), P=256)) == 0
    short = contig_from_record(make_record(n=15, topology="linear", seed=5))
    assert len(ss.sharded_scan(["A" * 20], short, 3, "", mesh=port_mesh(2), P=256)) == 0


def test_rejects_oversized_spacers():
    rec = make_record(n=2000, seed=2)
    with pytest.raises(ValueError, match="up to 63"):
        ss.sharded_scan(["A" * 64], contig_from_record(rec), 0, mesh=port_mesh(8), P=256)


def test_bad_sub_width_raises_upfront():
    contig = contig_from_record(make_record(n=4000, seed=4))
    for pam in ("", "NGG"):
        with pytest.raises(ValueError, match="sub_width"):
            ss.sharded_scan(["ACGTACGTACGTACGTACGT"], contig, 1, pam=pam,
                            mesh=port_mesh(8), P=2048, sub_width=600)


def test_site_mode_always_raises(jax_mesh8):
    """site_mode="always" takes the site engine, whose Hits equal the JAX
    site engine's and the dense engine's; without a PAM it stays dense, as
    in JAX; only an unknown site_mode raises."""
    rng = np.random.default_rng(8)
    rec = make_record(n=3000, seed=8)
    spacers = [random_seq(20, rng) for _ in range(3)]
    plant_guide(rec, spacers[0], 1100, pam="GGG", strand="R")
    contig = contig_from_record(rec)
    for pam in ("NGG", ""):
        want = check_all(spacers, contig, 2, jax_mesh8, pam=pam, P=256, site_mode="always")
        assert want == tuples(ss.sharded_scan(spacers, contig, 2, pam, mesh=port_mesh(2), P=256,
                                              site_mode="never"))
    assert (0, 1100, 1, 0) in check_all(spacers, contig, 0, jax_mesh8, pam="NGG", P=256,
                                        site_mode="always")
    with pytest.raises(ValueError, match="site_mode"):
        ss.sharded_scan(["A" * 20], contig, 0, "NGG", mesh=port_mesh(2), site_mode="sites")


def test_mesh_guards():
    """make_mesh must not truncate past the device count and make_mesh_2d
    must refuse a degenerate zero-genome grid, as in the JAX package."""
    n = len(CPU8)
    with pytest.raises(ValueError, match="devices"):
        make_mesh(n + 1, devices=CPU8)
    with pytest.raises(ValueError, match="devices"):
        make_mesh_2d(n * 2, devices=CPU8)
    with pytest.raises(ValueError, match="devices"):
        make_mesh_2d(9, devices=CPU8)
    assert make_mesh(n, devices=CPU8).shape == {"genome": n}
    assert make_mesh(3, devices=CPU8).shape == {"genome": 3}
    m = make_mesh_2d(3, devices=CPU8)
    assert m.shape == {"library": 3, "genome": 2} and m.repeats_a_device()
    assert ss._mesh_dims(port_mesh(8)) == (1, 8) and ss._mesh_dims(m) == (3, 2)
