"""The port's sharded block-max API and the sharded engine's state, held
against the JAX package (8 fake CPU devices).

* ``sharded_scan_block_max``: ``block_max`` and ``totals`` bit-equal to the
  JAX function's on 1, 2 and 8 genome shards and on a (2, 4) mesh, on a
  genome whose padded tail tiles are fully masked. There a tile's max
  depends on the codes its last columns read past the final block: the
  JAX ring hands the last shard shard 0's first codes, so the port must
  too (checked by showing that an N halo changes the answer).
* its per-shard tiles and bias live in the genome cache: a repeat call on
  the same arrays hits it and answers the same (still the JAX function's
  answer on 8 fake devices), a changed mask or codes array misses.
* ``shard_state``: the numpy state (codes blocks, ok masks, stacked fwd/rev
  Q one-hot) equals the arrays rebuilt with the JAX package's own prep
  functions and ``_host_onehot``, and the JAX phase 1 (the Pallas kernel in
  interpret mode) and the port's give the same indicator on that state.

Every comparison is EXACT.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from barcoder_tpu.core.genome import contig_from_record
from barcoder_tpu.ops.oracle import oracle_scan
from barcoder_tpu.ops.pallas_scan import (
    BS, MASK_BIAS, _cdiv, _tiles_device_impl, onehot_rows, scan_block_hits,
)
from barcoder_tpu.ops.prep import build_scan_array, revcomp_matrix, site_masks, spacer_matrix
from barcoder_tpu.parallel import mesh as jax_mesh
from barcoder_tpu.parallel.sharded_scan import _host_onehot
from barcoder_tpu.parallel.sharded_scan import sharded_scan_block_max as jax_block_max
from barcoder_tpu_torch.ops import scan_max
from barcoder_tpu_torch.parallel import sharded_scan as ss
from barcoder_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

from .genomes import make_record, plant_guide, random_seq

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
L, K, P = 20, 128, 256


@pytest.fixture(scope="module")
def workload():
    """A 5,000 bp circular genome (8 shards of 768 starts: the last four
    tiles lie wholly past n_starts) and 300 spacers (3 blocks; a 2-way
    library split pads a fourth block of zero rows), the first planted."""
    rng = np.random.default_rng(21)
    rec = make_record(n=5000, topology="circular", seed=21)
    spacers = [random_seq(L, rng) for _ in range(299)] + [rec.seq[:L]]
    plant_guide(rec, spacers[0], 1234, pam="TGG")
    contig = contig_from_record(rec)
    q_oh = np.zeros((_cdiv(len(spacers), BS) * BS, K), np.float32)
    q_oh[: len(spacers)] = onehot_rows(spacer_matrix(spacers), K)
    scan = build_scan_array(contig, L).astype(np.int32)
    return contig, spacers, q_oh, scan


def port_block_max(q_oh, scan, mask, mesh):
    return ss.sharded_scan_block_max(torch.from_numpy(q_oh).to(torch.bfloat16), scan, mask,
                                     mesh, L=L, K=K, P=P)


@pytest.mark.parametrize("mask_kind", ["ones", "pam"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 8), (2, 4)])
def test_block_max_matches_jax(workload, shape, mask_kind):
    contig, _, q_oh, scan = workload
    n_lib, n_gen = shape
    if mask_kind == "ones":
        mask = np.ones(contig.length, np.int32)
    else:
        mask = site_masks(contig, L, "NGG", "downstream")[0].astype(np.int32)
    if n_lib == 1:
        jm, pm = jax_mesh.make_mesh(n_gen), make_mesh(devices=CPU8[:n_gen])
    else:
        jm, pm = jax_mesh.make_mesh_2d(n_lib, n_gen), make_mesh_2d(n_lib, n_gen, devices=CPU8)
    want_max, want_totals = jax_block_max(jnp.asarray(q_oh, dtype=jnp.bfloat16), scan, mask,
                                          jm, L=L, K=K, P=P)
    before = scan_max.launches
    got_max, got_totals = port_block_max(q_oh, scan, mask, pm)
    assert scan_max.launches == before  # CPU shards run the plain version
    assert got_max.dtype == want_max.dtype and got_totals.dtype == want_totals.dtype
    assert got_max.shape == want_max.shape and np.array_equal(got_max, want_max)
    assert got_totals.shape == want_totals.shape and np.array_equal(got_totals, want_totals)
    # every block of rows, real or zero padding, has allowed columns
    assert (want_totals > 0).sum() == n_lib * ss._lib_layout(n_lib, len(q_oh))[2]
    tail = np.arange(len(want_max)) * P >= contig.length  # tiles wholly past n_starts
    assert (want_max[tail] < -16000).all() and tail.any() == (n_gen == 8)


def test_block_max_needs_the_ring_halo(workload):
    """On 8 shards the last shard's last tile reads shard 0's first codes
    (the JAX ring): with N codes in their place its maxima differ."""
    contig, _, q_oh, scan = workload
    mask = np.ones(contig.length, np.int32)
    got, _ = port_block_max(q_oh, scan, mask, make_mesh(devices=CPU8))
    B = _cdiv(contig.length + K // 4, 8 * P) * P
    tail = np.full(P + K // 4, 4, np.int32)  # the padded genome: N codes
    bias = torch.full((1, 1, P), MASK_BIAS)
    q = torch.from_numpy(q_oh).to(torch.bfloat16)
    n_halo = scan_max.scan_block_max_reference(q, torch.from_numpy(tail)[None, None], bias,
                                              L=L, K=K, P=P)
    ring = tail.copy()
    ring[P:] = scan[: K // 4]
    with_ring = scan_max.scan_block_max_reference(q, torch.from_numpy(ring)[None, None], bias,
                                                 L=L, K=K, P=P)
    assert 8 * B - P >= contig.length + L  # that tile lies wholly in the padding
    assert np.array_equal(got[-1], with_ring[0].numpy())
    assert not np.array_equal(got[-1], n_halo[0].numpy())


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
def test_block_max_cached_call_matches_jax(workload, shape):
    """The second call on the same (read-only) arrays builds and ships
    nothing, and still equals the JAX function on 8 fake devices."""
    contig, _, q_oh, scan = workload
    n_lib, n_gen = shape
    mask = site_masks(contig, L, "NGG", "downstream")[0].astype(np.int32)
    scan = scan.copy()
    for arr in (scan, mask):
        arr.setflags(write=False)
    if n_lib == 1:
        jm, pm = jax_mesh.make_mesh(n_gen), make_mesh(devices=CPU8[:n_gen])
    else:
        jm, pm = jax_mesh.make_mesh_2d(n_lib, n_gen), make_mesh_2d(n_lib, n_gen, devices=CPU8)
    ss._GENOME_SHARD_CACHE.clear()
    first = port_block_max(q_oh, scan, mask, pm)
    built = ss.serving_cache_stats()["genome"]
    assert (built["hits"], built["misses"], built["entries"]) == (0, 1, 1)
    assert built["bytes_built"] == built["bytes_resident"] > 0
    again = port_block_max(q_oh, scan, mask, pm)
    stats = ss.serving_cache_stats()["genome"]
    assert (stats["hits"], stats["misses"], stats["entries"]) == (1, 1, 1)
    assert stats["bytes_built"] == built["bytes_built"]
    want_max, want_totals = jax_block_max(jnp.asarray(q_oh, dtype=jnp.bfloat16), scan, mask,
                                          jm, L=L, K=K, P=P)
    for got_max, got_totals in (first, again):
        assert np.array_equal(got_max, want_max) and np.array_equal(got_totals, want_totals)


@pytest.mark.parametrize("changed", ["mask", "codes", "mesh", "tile"])
def test_block_max_cache_misses_on_change(workload, changed):
    """The key is the content of both arrays, the geometry and the mesh: a
    flipped mask entry, a changed code, another mesh or another tile width
    misses and gives the answer of a cold call; writable arrays are hashed
    on every call, so a change in place is seen too."""
    contig, _, q_oh, scan = workload
    mask = np.ones(contig.length, np.int32)
    scan = scan.copy()
    mesh, P_tile = make_mesh(devices=CPU8[:2]), P
    q = torch.from_numpy(q_oh).to(torch.bfloat16)
    ss._GENOME_SHARD_CACHE.clear()
    before = ss.sharded_scan_block_max(q, scan, mask, mesh, L=L, K=K, P=P_tile)
    if changed == "mask":
        mask[: contig.length // 2] = 0  # in place
    elif changed == "codes":
        scan[: contig.length // 2] = 4  # N
    elif changed == "mesh":
        mesh = make_mesh(devices=CPU8[:4])
    else:
        P_tile = 512
    got = ss.sharded_scan_block_max(q, scan, mask, mesh, L=L, K=K, P=P_tile)
    stats = ss.serving_cache_stats()["genome"]
    assert (stats["hits"], stats["misses"], stats["entries"]) == (0, 2, 2)
    ss._GENOME_SHARD_CACHE.clear()
    cold = ss.sharded_scan_block_max(q, scan, mask, mesh, L=L, K=K, P=P_tile)
    assert np.array_equal(got[0], cold[0]) and np.array_equal(got[1], cold[1])
    if changed in ("mask", "codes"):  # the first tiles lose their scores
        assert before[0][0].max() >= L // 2 and got[0][0].max() <= 0
    elif changed == "mesh":
        assert np.array_equal(got[0].max(axis=0), before[0].max(axis=0))


def jax_layout(spacers, contig, pam, n_lib, n_gen):
    """The JAX engine's host state, rebuilt line for line from
    barcoder_tpu/parallel/sharded_scan.py (:985-1034, :1122-1158) with the
    JAX package's own functions."""
    q_f = spacer_matrix(spacers)
    S, Ls = q_f.shape
    Kq = max(_cdiv(4 * Ls, 128) * 128, 128)
    halo = Kq // 4
    fused, fold = 4 * Ls + 2 <= Kq, 4 * Ls < Kq
    BS_M = 512 if S >= 2048 else (256 if S >= 512 else BS)
    n = contig.length
    scan_len = n + (Ls - 1) if (contig.circular and Ls > 1) else n
    n_starts = min(n, scan_len - Ls + 1)
    B = _cdiv(n_starts + halo, n_gen * P) * P
    total = n_gen * B
    scan = build_scan_array(contig, Ls)
    codes = np.full(total, 4, dtype=np.int8)
    codes[: min(len(scan), total)] = scan[: min(len(scan), total)]

    def blocked(mask):
        ok = np.zeros(total, dtype=np.int8)
        ok[:n_starts] = mask[:n_starts]
        return ok

    S_loc = _cdiv(S, n_lib * BS_M) * BS_M
    q_pad = np.full((n_lib * S_loc, Ls), 4, dtype=np.int8)
    q_pad[:S] = q_f
    mask_f, mask_r = site_masks(contig, Ls, pam, "downstream")
    if fused:
        q_host = np.empty((n_lib * 2 * S_loc, Kq), dtype=np.float32)
        q_f_oh = _host_onehot(q_pad, Kq, Ls, fold, 0)
        q_r_oh = _host_onehot(revcomp_matrix(q_pad), Kq, Ls, fold, 1)
        for i in range(n_lib):
            q_host[i * 2 * S_loc : i * 2 * S_loc + S_loc] = q_f_oh[i * S_loc : (i + 1) * S_loc]
            q_host[i * 2 * S_loc + S_loc : (i + 1) * 2 * S_loc] = q_r_oh[i * S_loc : (i + 1) * S_loc]
        jobs = [(q_host, np.stack([blocked(mask_f), blocked(mask_r)]))]
    else:
        jobs = [(_host_onehot(q_pad, Kq, Ls, fold, 0), blocked(mask_f)[None]),
                (_host_onehot(revcomp_matrix(q_pad), Kq, Ls, fold, 0), blocked(mask_r)[None])]
    oks = [np.ascontiguousarray(ok.reshape(-1, n_gen, B).transpose(1, 0, 2)) for _, ok in jobs]
    geom = dict(halo=halo, fold=fold, BS_M=BS_M, B=B, L=Ls, K=Kq, R=2 if fused else 1)
    return codes.reshape(n_gen, B), [q for q, _ in jobs], oks, geom


@pytest.mark.parametrize("Ls,shape", [(20, (2, 2)), (32, (1, 2))])
def test_state_and_phase1_match_jax(Ls, shape):
    rng = np.random.default_rng(Ls)
    rec = make_record(n=3000, topology="circular", seed=Ls)
    spacers = [random_seq(Ls, rng) for _ in range(150)]
    for i in (0, 149):
        plant_guide(rec, spacers[i], 400 + 2000 * (i > 0), pam="AGG", strand="R" if i else "F")
    contig = contig_from_record(rec)
    n_lib, n_gen = shape
    mesh = make_mesh_2d(n_lib, n_gen, devices=CPU8[:4])
    codes, qs, oks, geom = jax_layout(spacers, contig, "NGG", n_lib, n_gen)
    state = ss.shard_state(spacers, contig, "NGG", mesh=mesh, P=P)
    assert np.array_equal(state.codes, codes) and state.codes.dtype == np.int8
    assert len(state.q) == len(qs) == len(state.ok) == len(oks) == (1 if Ls == 20 else 2)
    for a, b in zip(state.q, qs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(state.ok, oks):
        assert a.dtype == b.dtype and np.array_equal(a, b)

    # both phase-1 paths on the same state: JAX's rebuilt arrays through
    # the port's *_from_numpy entry
    tensors = ss.shard_state_from_numpy(
        ss.ShardState(codes=codes, ok=oks, q=qs, strands=state.strands), mesh)
    g = ss._geometry(spacer_matrix(spacers).shape, contig, mesh, P, 512)
    v, halo = 1, geom["halo"]
    thresh = np.array([geom["L"] - v], np.float32)
    rows = qs[0].shape[0] // n_lib
    for ji, (q, ok) in enumerate(zip(qs, oks)):
        for li in range(n_lib):
            for d in range(n_gen):
                ext = np.concatenate([codes[d], codes[(d + 1) % n_gen][:halo]]).astype(np.int32)
                tiles = _tiles_device_impl(jnp.asarray(ext), n_starts=geom["B"], P=P, halo=halo)
                bias = np.where(ok[d] > 0, 0.0, MASK_BIAS).astype(np.float32)
                bias = bias.reshape(geom["R"], geom["B"] // P, P).transpose(1, 0, 2)
                want = np.asarray(scan_block_hits(
                    jnp.asarray(thresh), jnp.asarray(q[li * rows : (li + 1) * rows], jnp.bfloat16),
                    tiles, jnp.asarray(bias), L=geom["L"], K=geom["K"], P=P, SUB=g.SUB,
                    BS_M=geom["BS_M"], interpret=True, fold_bias=geom["fold"],
                ))
                got = ss._phase1(tensors.codes[li, d], tensors.ok[ji][li, d],
                                 tensors.q[ji][li, d], torch.from_numpy(thresh), g)
                assert np.array_equal(got.numpy(), want)
    hits = ss._run(tensors, g, mesh, v)
    want_hits = oracle_scan(spacers, contig, v, pam="NGG")
    for f in ("spacer_idx", "pos", "strand", "mismatches"):
        assert np.array_equal(getattr(hits, f), getattr(want_hits, f))
    assert {(0, 400), (149, 2400)} <= set(zip(hits.spacer_idx.tolist(), hits.pos.tolist()))
