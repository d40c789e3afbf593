"""Card-only tests of the PyTorch port (``gpu`` marker): the CUDA kernels
against their plain torch versions, and the CUDA engine and pipeline against
the port's CPU paths. They skip without a CUDA device.

This file imports no jax, so it also runs on a card machine without the
JAX package's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py configures jax). Every
comparison is EXACT: integer kernel outputs and Hits tables.

It also holds the kernel case generators that test_torch_scan_hits.py and
the experiment-kernel tests (test_torch_int8_bench.py,
test_torch_phase1_ablate.py, test_torch_phase1_bench.py) use for their CPU
comparisons against the Pallas kernels, and one test that runs everywhere:
the experiment entry points refuse to run without a card.
"""

import importlib

import numpy as np
import pytest
import torch

from barcoder_tpu.core.genome import contig_from_record
from barcoder_tpu_torch.experiments import (
    int8_inputs, int8_tensors, phase1_inputs, phase1_tensors, plant_hits,
)
from barcoder_tpu_torch.ops import colmax_mma, phase1_variants, scan_hits, scan_max
from barcoder_tpu_torch.ops.cuda_scan import (
    _QPrep, _ScanJob, cuda_scan, cuda_scan_contigs, onehot_rows,
)
from barcoder_tpu_torch.ops.oracle import oracle_scan
from barcoder_tpu_torch.ops.prep import spacer_matrix

from .genomes import make_record, plant_guide, random_seq

torch.set_num_threads(1)

K = 128
P = 512
BS_M = 128
N_TILES = 2
S_PAD = 320  # 2 full blocks of BS_M plus 64 tail rows that every kernel ignores
FOLD_ROWS = {"fold1": 1, "fold2": 2, "additive": 1}
# every (bias mode, L) the JAX wrapper accepts: fold needs 4L + R <= K
MODES = [
    (mode, L)
    for mode in ("fold1", "fold2", "additive")
    for L in (20, 24, 32)
    if mode == "additive" or 4 * L + FOLD_ROWS[mode] <= K
]


def make_case(L, mode, matrix_rows, seed, *, P=P, S_PAD=S_PAD, N_TILES=N_TILES):
    """numpy inputs for one kernel call: genome codes with N (4) and the
    out-of-bounds sentinel (5), spacers cut from the genome with 0-4
    substitutions (so scores cross the threshold), mixed bias-column
    patterns, and a random 0 / -16384 bias."""
    rng = np.random.default_rng(seed)
    halo = K // 4
    codes = rng.integers(0, 4, (N_TILES, 1, P + halo)).astype(np.int32)
    codes[rng.random(codes.shape) < 0.03] = 4
    codes[rng.random(codes.shape) < 0.01] = 5
    qc = np.empty((S_PAD, L), np.int8)
    for i in range(S_PAD):
        t, p = rng.integers(N_TILES), rng.integers(P)
        w = np.minimum(codes[t, 0, p : p + L], 4)
        k = rng.integers(0, 5)
        idx = rng.choice(L, k, replace=False)
        w[idx] = rng.integers(0, 5, k)
        qc[i] = w
    q = onehot_rows(qc, K)
    R = FOLD_ROWS[mode]
    if mode == "fold1":
        q[:, 4 * L] = rng.random(S_PAD) < 0.9  # a few rows carry no bias
    elif mode == "fold2":
        q[: S_PAD // 2, 4 * L] = 1
        q[S_PAD // 2 :, 4 * L + 1] = 1
        q[rng.random(S_PAD) < 0.05, 4 * L] = 1  # some rows carry both
    elif 4 * L < K:
        q[:, 4 * L] = 1  # additive mode must ignore a constant column
    if matrix_rows:
        l_pad = -(-L // 8) * 8
        tiles = rng.integers(0, 6, (N_TILES, l_pad, P)).astype(np.int32)
        for t in range(N_TILES):  # rows < L are the genome windows
            tiles[t, :L] = np.lib.stride_tricks.sliding_window_view(codes[t, 0], P)[:L]
    else:
        tiles = codes
    bias = np.where(rng.random((N_TILES, R, P)) < 0.3, 0.0, -16384.0).astype(np.float32)
    thresh = np.array([L - 3], np.float32)
    return thresh, q, np.ascontiguousarray(tiles), bias


def make_max_case(L, fold, n_blocks, seed, P=512, n_tiles=2, n_pad=40):
    """numpy inputs for one block-max kernel call: genome codes with N (4)
    and the out-of-bounds sentinel (5); n_blocks spacer blocks of 128 rows
    cut from the genome with 0-4 substitutions, the last ``n_pad`` of them
    zero padding rows (no constant bias column); a random 0 / -16384 bias
    with the last tile fully masked, as a padded tail tile is — there the
    padding rows' folded score (0) beats every real row's."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n_tiles, 1, P + K // 4)).astype(np.int32)
    codes[rng.random(codes.shape) < 0.03] = 4
    codes[rng.random(codes.shape) < 0.01] = 5
    S_pad = 128 * n_blocks
    qc = np.empty((S_pad, L), np.int8)
    for i in range(S_pad):
        t, p = rng.integers(n_tiles), rng.integers(P)
        w = np.minimum(codes[t, 0, p : p + L], 4)
        k = rng.integers(0, 5)
        idx = rng.choice(L, k, replace=False)
        w[idx] = rng.integers(0, 5, k)
        qc[i] = w
    q = onehot_rows(qc, K)
    if 4 * L < K:
        q[:, 4 * L] = 1  # the fold column; additive mode must ignore it
    q[S_pad - n_pad :] = 0
    bias = np.where(rng.random((n_tiles, 1, P)) < 0.5, 0.0, -16384.0).astype(np.float32)
    bias[-1] = -16384.0
    return q, codes, bias


def make_phase1_case(n_tiles, n_sblocks, *, L, P, BS_M, seed):
    """numpy inputs of the phase-1 experiment kernels at a small size: the
    scripts' generator (random spacers, random codes) with MASK_BIAS on 30%
    of the columns, and hits planted by ``plant_hits`` (genome windows as
    spacers, some rows with the second bias column 4L + 1)."""
    thresh, q, tiles, bias = phase1_inputs(n_tiles, n_sblocks, L=L, K=K, P=P, BS_M=BS_M,
                                           mask_share=0.3, seed=seed)
    plant_hits(q, tiles, L=L, P=P, seed=seed + 1)
    return thresh, q, tiles, bias


# (n_tiles, n_sblocks, P, BS_M, SUB, L): the TPU-like small case, the batched
# quirk (12 blocks), and odd sizes (a ragged 256-column chunk at P = 400, a
# spacer block of 64 + 16 rows, L = 31 filling K with 4L + 2 = 126 rows)
PHASE1_CASES = [(2, 8, 256, 16, 8, 20), (3, 12, 1024, 64, 8, 20), (3, 11, 400, 80, 8, 31)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("matrix_rows", [False, True])
@pytest.mark.parametrize("mode,L", MODES)
def test_cuda_kernel_matches_plain(cuda, mode, L, matrix_rows):
    """The CUDA kernel against its plain torch version on the card, bit-equal,
    in every mode; the launch counter counts kernel launches only."""
    thresh, q, tiles, bias = make_case(L, mode, matrix_rows, seed=L)
    args = (torch.from_numpy(thresh).to(cuda), torch.from_numpy(q).to(cuda, torch.bfloat16),
            torch.from_numpy(tiles).to(cuda), torch.from_numpy(bias).to(cuda))
    for SUB in (1, 4, 32):
        kw = dict(L=L, K=K, P=P, SUB=SUB, BS_M=BS_M, fold_bias=mode != "additive",
                  matrix_rows=matrix_rows)
        before = scan_hits.launches
        got = scan_hits.scan_block_hits(*args, **kw)
        assert scan_hits.launches == before + 1
        want = scan_hits.scan_block_hits_reference(*args, **kw)
        assert scan_hits.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want) and want.sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("matrix_rows", [False, True])
@pytest.mark.parametrize("mode,L", MODES)
def test_cuda_kernel_shapes_match_plain(cuda, mode, L, matrix_rows):
    """The int8 kernel against its plain version, bit-equal, at spacer
    blocks of 128, 256 and 512 rows and of 80 (padded to 128 by repeating a
    row), at a ragged P = 400 (the last 512-column block is 400 wide) and at
    P = 1024, with 1, 4 and 16 or 32 subtiles."""
    for BS_M, P_case, S_pad in ((128, 400, 400), (256, 1024, 800), (512, 400, 1100),
                                (80, 1024, 260)):
        thresh, q, tiles, bias = make_case(L, mode, matrix_rows, seed=BS_M + L, P=P_case,
                                           S_PAD=S_pad, N_TILES=3)
        args = (torch.from_numpy(thresh).to(cuda), torch.from_numpy(q).to(cuda, torch.bfloat16),
                torch.from_numpy(tiles).to(cuda), torch.from_numpy(bias).to(cuda))
        for SUB in (1, 4, 16 if P_case == 400 else 32):
            kw = dict(L=L, K=K, P=P_case, SUB=SUB, BS_M=BS_M, fold_bias=mode != "additive",
                      matrix_rows=matrix_rows)
            got = scan_hits.scan_block_hits(*args, **kw)
            want = scan_hits.scan_block_hits_reference(*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (BS_M, P_case, SUB)
            assert want.sum() > 0


@pytest.mark.gpu
def test_cuda_kernel_rejects_bad_inputs(cuda):
    """The wrapper checks type, contiguity and the kernel's limits and
    raises instead of launching."""
    thresh, q, tiles, bias = make_case(20, "fold1", False, seed=1)
    args = [torch.from_numpy(thresh).to(cuda), torch.from_numpy(q).to(cuda, torch.bfloat16),
            torch.from_numpy(tiles).to(cuda), torch.from_numpy(bias).to(cuda)]
    kw = dict(L=20, K=K, P=P, SUB=4, BS_M=BS_M, fold_bias=True)
    bad = list(args)
    bad[1] = args[1].float()
    with pytest.raises(ValueError, match="bfloat16"):
        scan_hits.scan_block_hits(*bad, **kw)
    bad = list(args)
    bad[2] = args[2].cpu()
    with pytest.raises(ValueError, match="tiles"):
        scan_hits.scan_block_hits(*bad, **kw)
    three_rows = torch.cat([args[3]] * 3, dim=1)  # the kernel folds at most 2 bias rows
    with pytest.raises(ValueError, match="at most 2 bias rows"):
        scan_hits.scan_block_hits(*args[:3], three_rows, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("fold,L", [(True, 20), (True, 24), (False, 20), (False, 24), (False, 32)])
def test_cuda_max_kernel_matches_plain(cuda, fold, L):
    """The block-max CUDA kernel against its plain torch version on the
    card, bit-equal, with and without fold, at SUB 1, 4 and 32 (subtiles
    of 512, 128 and 16 columns) and 1-3 spacer blocks."""
    for n_blocks, SUB in ((1, 1), (2, 4), (3, 32)):
        q, codes, bias = make_max_case(L, fold, n_blocks, seed=L + n_blocks)
        args = (torch.from_numpy(q).to(cuda, torch.bfloat16), torch.from_numpy(codes).to(cuda),
                torch.from_numpy(bias).to(cuda))
        kw = dict(L=L, K=K, P=P, SUB=SUB, fold_bias=fold)
        before = scan_max.launches
        got = scan_max.scan_block_max(*args, **kw)
        assert scan_max.launches == before + 1
        want = scan_max.scan_block_max_reference(*args, **kw)
        assert scan_max.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert (want[:, :, :n_blocks] > -16384).any() and (want[:, :, n_blocks:] == -16384).all()


@pytest.mark.gpu
def test_cuda_max_kernel_rejects_bad_inputs(cuda):
    q, codes, bias = make_max_case(20, True, 1, seed=1)
    args = [torch.from_numpy(q).to(cuda, torch.bfloat16), torch.from_numpy(codes).to(cuda),
            torch.from_numpy(bias).to(cuda)]
    kw = dict(L=20, K=K, P=P, SUB=4, fold_bias=True)
    bad = list(args)
    bad[0] = args[0].float()
    with pytest.raises(ValueError, match="bfloat16"):
        scan_max.scan_block_max(*bad, **kw)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError, match="tiles"):
        scan_max.scan_block_max(*bad, **kw)
    with pytest.raises(ValueError, match="spare G row"):
        scan_max.scan_block_max(*args, **dict(kw, L=32))


@pytest.mark.gpu
@pytest.mark.parametrize("L,pam,v", [(20, "NGG", 2), (32, "NGNC", 1), (20, "", 1)])
@pytest.mark.parametrize("topology", ["circular", "linear"])
def test_cuda_engine_matches_oracle(cuda, topology, L, pam, v):
    """The engine on the card (kernel phase 1, both phase-2 paths) against
    the numpy oracle, with planted guides as independent truth."""
    rng = np.random.default_rng(L + v)
    rec = make_record(n=20_000, topology=topology, seed=L + v)
    guides = [random_seq(L, rng) for _ in range(24)]
    for i, g in enumerate(guides):
        plant_guide(rec, g, 100 + 800 * i, pam="AGG" if L == 20 else "AGTC",
                    strand="F" if i % 2 else "R")
    contig = contig_from_record(rec)
    want = oracle_scan(guides, contig, v, pam)
    spec_overflow = _QPrep(spacer_matrix(guides), v, pam, "downstream", 512, 512, cuda)
    spec_overflow.spec_B = 1  # the batched per-strand phase 2
    for run in (lambda: cuda_scan(guides, contig, v, pam, P=512, device=cuda),
                lambda: cuda_scan(guides, contig, v, pam, P=16384, device=cuda),
                lambda: _ScanJob(spec_overflow, contig).collect()):
        before = scan_hits.launches
        got = run()
        assert scan_hits.launches > before
        for f in ("spacer_idx", "pos", "strand", "mismatches"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
    hits = set(zip(want.spacer_idx.tolist(), want.pos.tolist()))
    assert all((i, 100 + 800 * i) in hits for i in range(len(guides)))


@pytest.mark.gpu
@pytest.mark.parametrize("L,pam,v", [(20, "NGG", 2), (32, "NGNC", 1)])
def test_sharded_matches_cuda_engine(cuda, monkeypatch, L, pam, v):
    """The sharded engine on 1 and 4 shards of the card, and on every card
    where there are several (kernel phase 1 per shard), gives the
    one-device engine's Hits; the block-max API's kernel gives its plain
    version's block_max and totals."""
    from barcoder_tpu_torch.ops.cuda_scan import onehot_rows
    from barcoder_tpu_torch.ops.prep import build_scan_array, site_masks
    from barcoder_tpu_torch.parallel import sharded_scan as sharded_scan_mod
    from barcoder_tpu_torch.parallel.mesh import make_mesh
    from barcoder_tpu_torch.parallel.sharded_scan import sharded_scan, sharded_scan_block_max

    rng = np.random.default_rng(L + 7)
    rec = make_record(n=40_000, topology="circular", seed=L)
    guides = [random_seq(L, rng) for _ in range(300)]
    for i in range(0, 300, 25):
        plant_guide(rec, guides[i], 100 + 3000 * (i // 25), pam="AGG" if L == 20 else "AGTC",
                    strand="F" if i % 2 else "R")
    contig = contig_from_record(rec)
    want = cuda_scan(guides, contig, v, pam, device=cuda)
    assert {(i, 100 + 3000 * (i // 25)) for i in range(0, 300, 25)} <= set(
        zip(want.spacer_idx.tolist(), want.pos.tolist()))
    q = torch.from_numpy(onehot_rows(spacer_matrix(guides), K)).to(cuda, torch.bfloat16)
    scan = build_scan_array(contig, L).astype(np.int32)
    mask = site_masks(contig, L, pam, "downstream")[0].astype(np.int32)
    meshes = [make_mesh(devices=[cuda] * n) for n in (1, 4)]
    if torch.cuda.device_count() > 1:  # one shard per card
        meshes.append(make_mesh())
    for mesh in meshes:
        n = mesh.devices.size
        for P_tile in (512, 16384):
            before = scan_hits.launches
            got = sharded_scan(guides, contig, v, pam, mesh=mesh, P=P_tile)
            assert scan_hits.launches > before
            for f in ("spacer_idx", "pos", "strand", "mismatches"):
                assert np.array_equal(getattr(got, f), getattr(want, f)), (mesh.devices.tolist(), P_tile, f)
        before = scan_max.launches
        got_max, got_totals = sharded_scan_block_max(q, scan, mask, mesh, L=L, K=K, P=2048)
        assert scan_max.launches == before + n
        with monkeypatch.context() as m:  # the plain version on the same shards
            m.setattr(sharded_scan_mod, "scan_block_max", scan_max.scan_block_max_reference)
            want_max, want_totals = sharded_scan_block_max(q, scan, mask, mesh, L=L, K=K, P=2048)
        assert scan_max.launches == before + n
        assert np.array_equal(got_max, want_max) and np.array_equal(got_totals, want_totals)
        assert (want_max.max(axis=(0, 1))[:3] >= L - v).all()


@pytest.mark.gpu
def test_cuda_engine_multi_contig(cuda):
    recs = [make_record(n=n, topology=t, seed=s)
            for n, t, s in ((9000, "circular", 1), (4000, "linear", 2), (700, "circular", 3))]
    rng = np.random.default_rng(4)
    guides = [random_seq(20, rng) for _ in range(8)]
    for i, g in enumerate(guides):
        plant_guide(recs[i % 3], g, 50 + 80 * i, pam="TGG")
    contigs = [contig_from_record(r) for r in recs]
    got = cuda_scan_contigs(guides, contigs, 2, "NGG", P=2048, device=cuda)
    for h, c in zip(got, contigs):
        want = oracle_scan(guides, c, 2, "NGG")
        assert np.array_equal(h.pos, want.pos) and np.array_equal(h.mismatches, want.mismatches)


@pytest.mark.gpu
def test_cuda_pipeline_matches_cpu(cuda):
    """run_targets with backend="cuda" gives the frame of the oracle backend."""
    import pandas as pd

    from barcoder_tpu.core.genome import Genome
    from barcoder_tpu.seqio.library import BarcodeLibrary
    from barcoder_tpu_torch.pipeline.targets import run_targets

    rec = make_record(n=30_000, seed=9, n_genes=12, wrapped_gene=True)
    rng = np.random.default_rng(9)
    guides = [random_seq(20, rng) for _ in range(10)]
    for i, g in enumerate(guides):
        plant_guide(rec, g, 29_990 if i == 0 else 1000 + 2500 * i, pam="CGG",
                    strand="F" if i % 2 == 0 else "R")
    genome = Genome([contig_from_record(rec)], source="synthetic")
    lib = BarcodeLibrary([(f"g{i}", g) for i, g in enumerate(guides)] + [("n", "A" * 20)])
    want = run_targets(lib, genome, "NGG", 2, backend="oracle")
    got = run_targets(lib, genome, "NGG", 2, backend="cuda")
    pd.testing.assert_frame_equal(got.table, want.table)
    assert (got.table["tar_start"] == -10).any()  # the origin-wrapping plant


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("n_tiles,n_sblocks,BS_M,P", [(2, 3, 16, 256), (3, 5, 80, 400),
                                                     (1, 2, 512, 16384)])
def test_cuda_colmax_matches_plain(cuda, dtype, n_tiles, n_sblocks, BS_M, P):
    """The tensor-core column max against its plain version, bit-equal over
    every column, on 0/1 inputs and (int8) on the whole int8 range."""
    q, g = int8_inputs(n_tiles, n_sblocks, BS_M=BS_M, K=K, P=P, seed=P + BS_M)
    cases = [int8_tensors(q, g, dtype, cuda)]
    if dtype == torch.int8:
        rng = np.random.default_rng(P)
        cases.append(int8_tensors(rng.integers(-128, 128, q.shape).astype(np.int8),
                                  rng.integers(-128, 128, g.shape).astype(np.int8), dtype, cuda))
    out_dtype = colmax_mma.OUT_DTYPE[dtype]
    for qt, gt in cases:
        before = colmax_mma.launches
        got = colmax_mma.colmax(qt, gt, out_dtype, BS_M=BS_M)
        assert colmax_mma.launches == before + 1
        want = colmax_mma.colmax_reference(qt, gt, out_dtype, BS_M=BS_M)
        torch.cuda.synchronize()
        assert got.shape == (n_tiles, n_sblocks, P) and got.dtype == out_dtype
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n_tiles,n_sblocks,P,BS_M,SUB,L", PHASE1_CASES)
def test_cuda_phase1_variants_match_plain(cuda, n_tiles, n_sblocks, P, BS_M, SUB, L):
    """Every ablation (A-D) and epilogue (a-d) variant of the tensor-core
    phase-1 kernel against its plain version, bit-equal, in the kernel's
    full form; each launch counts once, on its own counter."""
    th, q, tiles, bias = phase1_tensors(
        *make_phase1_case(n_tiles, n_sblocks, L=L, P=P, BS_M=BS_M, seed=P + L), cuda)
    g_all = phase1_variants.build_g_all(tiles, bias, L=L, K=K, P=P)
    other_g = phase1_variants.build_g_all(tiles.roll(7, dims=2), bias, L=L, K=K, P=P)
    kw = dict(L=L, K=K, P=P, SUB=SUB, BS_M=BS_M)
    for variant in phase1_variants.ABLATE:
        for g in (g_all, other_g):
            before = dict(phase1_variants.launches)
            got = phase1_variants.ablate(variant, th, q, tiles, bias, g, **kw)
            assert phase1_variants.launches == dict(before, phase1_ablate=before["phase1_ablate"] + 1)
            want = phase1_variants.ablate_reference(variant, th, q, tiles, bias, g, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (variant, g is g_all)
            assert want.sum() > 0
    for variant in phase1_variants.BENCH:
        before = dict(phase1_variants.launches)
        got = phase1_variants.bench_full(variant, th, q, tiles, bias, **kw)
        assert phase1_variants.launches == dict(before, phase1_epilogue=before["phase1_epilogue"] + 1)
        want = phase1_variants.bench_full_reference(variant, th, q, tiles, bias, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), variant
        lanes = phase1_variants.bench(variant, th, q, tiles, bias, **kw)
        if variant in "ab":
            assert torch.equal(lanes, colmax_mma.tpu_lanes(want, SUB, torch.float32))
        assert (want > 0).any()


@pytest.mark.gpu
def test_cuda_experiment_kernels_reject_bad_inputs(cuda):
    th, q, tiles, bias = phase1_tensors(
        *make_phase1_case(2, 8, L=20, P=256, BS_M=16, seed=1), cuda)
    kw = dict(L=20, K=K, P=256, SUB=8, BS_M=16)
    with pytest.raises(ValueError, match="bfloat16"):
        phase1_variants.ablate("A", th, q.float(), tiles, bias, None, **kw)
    with pytest.raises(ValueError, match="tiles"):
        phase1_variants.bench_full("a", th, q, tiles.cpu(), bias, **kw)
    with pytest.raises(ValueError, match="g_all"):
        phase1_variants.ablate("B", th, q, tiles, bias, None, **kw)
    with pytest.raises(ValueError, match="BS_M % 16"):
        phase1_variants.ablate("C", th, q, tiles, bias, None, **dict(kw, BS_M=8))
    qi, gi = int8_tensors(*int8_inputs(1, 2, BS_M=16, K=K, P=256), torch.int8, cuda)
    with pytest.raises(ValueError, match="int32"):
        colmax_mma.colmax(qi, gi, torch.float32, BS_M=16)
    with pytest.raises(ValueError, match="P % 16"):
        colmax_mma.colmax(qi, gi[:, :, :200].contiguous(), torch.int32, BS_M=16)


@pytest.mark.parametrize("name", ["int8_bench", "phase1_ablate", "phase1_bench"])
def test_experiment_entry_points_need_cuda(monkeypatch, name):
    """Without a CUDA device the entry points raise SystemExit; nothing
    falls back to the CPU."""
    mod = importlib.import_module(f"barcoder_tpu_torch.experiments.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        mod.main([])
