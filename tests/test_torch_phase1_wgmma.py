"""The phase-1 kernel's staging and epilogues (``csrc/phase1_mma.cu``)
modelled on the CPU and held against the plain versions (``ablate_reference``,
``bench_full_reference``) and the TPU kernels of ``experiments/phase1_ablate.py``
and ``experiments/phase1_bench.py`` (interpret mode, loaded from the unchanged
files as test_torch_int8_bench.py describes).

The model computes what the card kernel computes from the bytes it stages
alone: the built variants' G from ``phase1_variants.g_pieces`` (codes and
bias written straight into K-major bf16 pieces, k_eff(L) rows deep) and Q
cut to those k_eff(L) columns, the streamed variants' G through ``g_kmajor``
(the transpose of ``stage_g``) and all K = 128 columns of Q, Q through
``chunk_layout``; the product per 64-row chunk and 256-column warpgroup slice
and the max over a padded block (``staged_product``); then each epilogue as
the kernel runs it when a block ends: counts per block, counts batched over
8 blocks from a register of hit bits (a last group of fewer than 8 blocks is
never written), the column maxima, the hit bits.

Cases: P 256, 400 (a ragged slab) and 1,024 (two slabs); BS_M 16, 80 and 128
(padded to 64, 128 and 128 rows); 8 and 12 spacer blocks; L 20 and 31 (4L + 2
= 126 of K = 128; the built variants issue depth 96 and 128); bias values
that bf16 rounds and -0.0 (``round_bias``) beside MASK_BIAS; finite values in
Q's columns past the built variants' depth. Every comparison is EXACT, and
G's bits are compared as bits, so -0.0 counts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from barcoder_tpu_torch.experiments import phase1_tensors
from barcoder_tpu_torch.ops import colmax_mma, phase1_variants, scan_hits

from .test_torch_gpu import make_phase1_case
from .test_torch_int8_bench import K, g_kmajor, load_experiment, staged_colmax, staged_product
from .test_torch_phase1_ablate import MAKE_FN, load
from .test_torch_phase1_bench import MAKE_VARIANT

torch.set_num_threads(1)

# (n_tiles, n_sblocks, P, BS_M, SUB, L, rounded)
CASES = [(2, 8, 256, 16, 8, 20, False), (2, 12, 400, 80, 8, 31, True),
         (1, 12, 1024, 128, 8, 20, True), (2, 8, 400, 16, 16, 31, False)]
VARIANTS = list(phase1_variants.ABLATE) + list(phase1_variants.BENCH)


def kernel_epilogue(cmax: torch.Tensor, th: float, epi: str, SUB: int) -> torch.Tensor:
    """The epilogue as the kernel runs it, block by block, on the column
    maxima (n_tiles, n_sblocks, P)."""
    n_tiles, n_sb, P = cmax.shape
    if epi == "colmax":
        return cmax
    hit = cmax >= th
    if epi == "hit":
        return hit.to(torch.uint8)
    out = torch.zeros((n_tiles, -(-n_sb // 8) * 8, SUB))
    sub = torch.arange(P) // (P // SUB)
    bits = torch.zeros((n_tiles, 8, P), dtype=torch.bool)  # COUNT8's register
    for s in range(n_sb):
        if epi == "count":
            out[:, s].index_add_(1, sub, hit[:, s].float())
            continue
        bits[:, s % 8] = hit[:, s]
        if s % 8 == 7:
            for k in range(8):
                out[:, s - 7 + k].index_add_(1, sub, bits[:, k].float())
            bits[:] = False
    return out


def modelled(source, epi, th, q, tiles, bias, g_all, *, L, P, SUB, BS_M):
    """The kernel's output from its staged bytes."""
    if source == "streamed":
        cmax = staged_colmax(q, g_all, BS_M)
    else:  # Q cut to the depth the kernel issues, as the wrapper cuts it
        cmax = staged_product(q[:, : phase1_variants.k_eff(L)], lambda t, p0:
                              phase1_variants.g_pieces(tiles[t, 0], bias[t], L=L, P=P, p0=p0),
                              tiles.shape[0], P, BS_M)
    return kernel_epilogue(cmax, float(th[0]), epi, SUB)


def pallas(variant, thresh, q, tiles, g_tiles, bias, *, L, P, SUB, BS_M, n_tiles, n_sblocks):
    """The TPU kernel's output (interpret mode)."""
    if variant in phase1_variants.ABLATE:
        ns = load(L, P, SUB, BS_M, n_tiles, n_sblocks, q, tiles, bias)
        ns["g_all"] = ns["build_g_all"](jnp.asarray(g_tiles), ns["bias"])
        fn, _ = ns["make_fn"](**MAKE_FN[variant])
        return np.asarray(fn(jnp.asarray(thresh), ns["q_dev"], ns["tiles"], ns["bias"],
                             ns["g_all"]))
    ns = load_experiment("phase1_bench", dict(
        L=L, K=K, P=P, SUB=SUB, BS_M=BS_M, N_TILES=n_tiles, N_SB=n_sblocks,
        q_dev=jnp.asarray(q, jnp.bfloat16), tiles=jnp.asarray(tiles), bias=jnp.asarray(bias),
    ), defs=("make_variant",))
    return np.asarray(ns["make_variant"](**MAKE_VARIANT[variant])(jnp.asarray(thresh)))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n_tiles,n_sblocks,P,BS_M,SUB,L,rounded", CASES)
def test_staged_kernel_matches_plain_and_pallas(n_tiles, n_sblocks, P, BS_M, SUB, L, rounded,
                                                variant):
    thresh, q, tiles, bias = make_phase1_case(n_tiles, n_sblocks, L=L, P=P, BS_M=BS_M,
                                              seed=P + BS_M + L, rounded=rounded)
    g_tiles = np.roll(tiles, 7, axis=2)  # the codes behind the streamed G
    th, qt, tt, bt = phase1_tensors(thresh, q, tiles, bias, "cpu")
    g_all = phase1_variants.build_g_all(torch.from_numpy(g_tiles), bt, L=L, K=K, P=P)
    kw = dict(L=L, K=K, P=P, SUB=SUB, BS_M=BS_M)
    if variant in phase1_variants.ABLATE:
        source, epi = phase1_variants.ABLATE[variant]
        want = phase1_variants.ablate_reference(variant, th, qt, tt, bt, g_all, **kw)
    else:
        source, epi = "built", phase1_variants.BENCH[variant]
        want = phase1_variants.bench_full_reference(variant, th, qt, tt, bt, **kw)
    got = modelled(source, epi, th, qt, tt, bt, g_all, L=L, P=P, SUB=SUB, BS_M=BS_M)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if epi == "count8" and n_sblocks % 8:
        assert got[:, n_sblocks // 8 * 8 :].sum() == 0  # the last group, never written
    if epi in ("colmax", "hit"):
        got = colmax_mma.tpu_lanes(got, SUB, torch.float32)
    tpu = pallas(variant, thresh, q, tiles, g_tiles, bias, L=L, P=P, SUB=SUB, BS_M=BS_M,
                 n_tiles=n_tiles, n_sblocks=n_sblocks)
    assert np.array_equal(got.numpy(), tpu)
    if epi in ("count", "count8"):
        assert tpu.sum() > 0


@pytest.mark.parametrize("L,P,rounded", [(20, 256, True), (31, 400, True), (31, 1024, False)])
def test_g_pieces_are_build_g_all_staged(L, P, rounded):
    """The built G's pieces hold, bit for bit (-0.0 included), what
    ``stage_g`` makes of ``build_g_all``'s G: the one statement of the
    layout agrees with the streamed variants' G, bias rows and all."""
    _, _, tiles, bias = make_phase1_case(2, 8, L=L, P=P, BS_M=16, seed=L + P, rounded=rounded)
    tt, bt = torch.from_numpy(tiles), torch.from_numpy(bias)
    g = phase1_variants.build_g_all(tt, bt, L=L, K=K, P=P)
    depth = phase1_variants.k_eff(L)
    assert (g[:, depth:] == 0).all()  # the rows the built variants leave out
    for t in range(2):
        for p0 in range(0, P, 512):
            slab = torch.zeros((depth, 512), dtype=torch.bfloat16)
            slab[:, : min(512, P - p0)] = g[t, :depth, p0 : p0 + 512]
            built = phase1_variants.g_pieces(tt[t, 0], bt[t], L=L, P=P, p0=p0)
            assert torch.equal(built.view(torch.int16), g_kmajor(slab).view(torch.int16))
    assert (bias[:, 0] != 0).any()
    if rounded:
        assert np.signbit(bias[:, 0][bias[:, 0] == 0]).any()  # -0.0 in G row 4L
        assert (torch.from_numpy(bias).bfloat16().float().numpy() != bias).any()


def test_g_pieces_read_a_short_tile_as_n():
    """Codes at or past the tile's width read as N (no row set); columns
    past P are zero."""
    L, P = 20, 48
    codes = torch.zeros(P + L - 1, dtype=torch.int32)  # base A everywhere
    bias = torch.full((2, P), 3.0)
    pieces = phase1_variants.g_pieces(codes[: P + 4], bias, L=L, P=P, p0=0)
    g = pieces.view(torch.int16).permute(1, 0, 2).reshape(512, 96)  # column n's 96 rows
    one = 0x3F80
    assert (g[:P, 0] == one).all()  # base 0 of every column exists
    for j in range(1, L):  # base j of column p exists while p + j < P + 4
        assert torch.equal(g[:P, 4 * j] == one, torch.arange(P) + j < P + 4)
    assert (g[:P, 4 * L : 4 * L + 2] == 0x4040).all()  # bf16(3.0)
    assert (g[P:] == 0).all() and (g[:, 4 * L + 2 :] == 0).all()


@pytest.mark.parametrize("L", [1, 7, 8, 15, 20, 23, 24, 31])
def test_k_eff_covers_g_rows_in_four_depths(L):
    """The built variants' depth holds G's 4L + 2 nonzero rows, in whole
    pairs of bf16 k-steps (one of the kernel's four depths), and is the int8
    scan_hits kernel's depth with its 2 folded rows: at every L the two
    kernels of phase1_bench's comparison issue the same depth."""
    depth = phase1_variants.k_eff(L)
    assert depth in (32, 64, 96, 128) and 4 * L + 2 <= depth < 4 * L + 2 + 32
    assert depth == scan_hits.k_eff(L, 2, True)
    assert phase1_variants.g_pieces(torch.zeros(600, dtype=torch.int32), torch.zeros(2, 512),
                                    L=L, P=512, p0=0).shape == (depth // 8, 512, 8)


@pytest.mark.parametrize("variant", ["A", "C"] + list(phase1_variants.BENCH))
def test_built_variants_leave_out_q_past_their_depth(variant):
    """Finite values in Q's columns past k_eff(L) meet G's zero rows, so the
    kernel's cut Q gives the plain version's result on the whole Q."""
    n_tiles, n_sblocks, P, BS_M, SUB, L = 2, 8, 400, 80, 8, 20
    thresh, q, tiles, bias = make_phase1_case(n_tiles, n_sblocks, L=L, P=P, BS_M=BS_M,
                                              seed=5, rounded=True)
    depth = phase1_variants.k_eff(L)
    rng = np.random.default_rng(6)
    q[:, depth:] = rng.uniform(-4, 4, (q.shape[0], K - depth)).round(1)
    th, qt, tt, bt = phase1_tensors(thresh, q, tiles, bias, "cpu")
    kw = dict(L=L, K=K, P=P, SUB=SUB, BS_M=BS_M)
    if variant in phase1_variants.ABLATE:
        epi = phase1_variants.ABLATE[variant][1]
        want = phase1_variants.ablate_reference(variant, th, qt, tt, bt, None, **kw)
    else:
        epi = phase1_variants.BENCH[variant]
        want = phase1_variants.bench_full_reference(variant, th, qt, tt, bt, **kw)
    got = modelled("built", epi, th, qt, tt, bt, None, L=L, P=P, SUB=SUB, BS_M=BS_M)
    assert (qt[:, depth:] != 0).any() and torch.equal(got, want)
