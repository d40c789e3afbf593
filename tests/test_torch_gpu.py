"""Card-only tests of the PyTorch port (``gpu`` marker): the CUDA kernel
against its plain torch version, and the CUDA engine and pipeline against
the port's CPU paths. They skip without a CUDA device.

This file imports no jax, so it also runs on a card machine without the
JAX package's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py configures jax). Every
comparison is EXACT: integer kernel outputs and Hits tables.

It also holds the kernel case generator that test_torch_scan_hits.py uses
for its CPU comparisons against the Pallas kernel.
"""

import numpy as np
import pytest
import torch

from barcoder_tpu.core.genome import contig_from_record
from barcoder_tpu_torch.ops import scan_hits
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


def make_case(L, mode, matrix_rows, seed):
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
    with pytest.raises(ValueError, match="BS_M"):
        scan_hits.scan_block_hits(*args, **dict(kw, BS_M=4096))


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
