"""The port's phase-1 epilogue variants (barcoder_tpu_torch.ops.
phase1_variants.bench) held against the TPU kernels of
``experiments/phase1_bench.py`` (``make_variant``, interpret mode), loaded
from the unchanged file as test_torch_int8_bench.py describes.

Variants, as the script's timing lines name them, all with G built in the
kernel: a the column maxima (lanes 0..SUB-1); b the hit bits (lanes
0..SUB-1); c hit counts batched over 8 spacer blocks; d counts per block.
The port's kernel form of a and b holds every column; its stored lanes are
compared here and the whole array against a numpy product. Every
comparison is EXACT.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from barcoder_tpu_torch.experiments import phase1_tensors
from barcoder_tpu_torch.ops import phase1_variants

from .test_torch_gpu import make_phase1_case
from .test_torch_int8_bench import K, load_experiment

torch.set_num_threads(1)

# phase1_bench.py:116-119
MAKE_VARIANT = {
    "a": dict(build_g=True, do_hit=False, do_seg=False),
    "b": dict(build_g=True, do_hit=True, do_seg=False),
    "c": dict(build_g=True, do_hit=True, do_seg=True, seg_batch=8),
    "d": dict(build_g=True, do_hit=True, do_seg=True, seg_batch=1),
}


@pytest.mark.parametrize("n_sblocks", [8, 12])
@pytest.mark.parametrize("variant", "abcd")
def test_bench_matches_pallas(variant, n_sblocks):
    n_tiles, L, P, SUB, BS_M = 3, 20, 256, 8, 16
    thresh, q, tiles, bias = make_phase1_case(n_tiles, n_sblocks, L=L, P=P, BS_M=BS_M,
                                              seed=100 + n_sblocks)
    ns = load_experiment("phase1_bench", dict(
        L=L, K=K, P=P, SUB=SUB, BS_M=BS_M, N_TILES=n_tiles, N_SB=n_sblocks,
        q_dev=jnp.asarray(q, jnp.bfloat16), tiles=jnp.asarray(tiles), bias=jnp.asarray(bias),
    ), defs=("make_variant",))
    want = np.asarray(ns["make_variant"](**MAKE_VARIANT[variant])(jnp.asarray(thresh)))

    args = phase1_tensors(thresh, q, tiles, bias, "cpu")
    kw = dict(L=L, K=K, P=P, SUB=SUB, BS_M=BS_M)
    before = dict(phase1_variants.launches)
    got = phase1_variants.bench(variant, *args, **kw)
    assert phase1_variants.launches == before  # CPU tensors never reach the kernel
    assert got.shape == want.shape == (n_tiles, 16 if n_sblocks == 12 else 8, SUB)
    assert np.array_equal(got.numpy(), want)
    assert want[:, n_sblocks:].sum() == 0
    if variant == "c" and n_sblocks == 12:
        assert want[:, 8:].sum() == 0  # the last group of 4 is never written
    if variant in "cd":
        assert want.sum() > 0

    full = phase1_variants.bench_full(variant, *args, **kw).numpy()
    if variant in "ab":  # every column, against a numpy product with G from the codes
        g = np.zeros((n_tiles, K, P), np.float32)
        for j in range(L):
            for b in range(4):
                g[:, 4 * j + b] = tiles[:, 0, j : j + P] == b
        g[:, 4 * L : 4 * L + 2] = bias
        cmax = np.einsum("rk,tkp->trp", q, g).reshape(n_tiles, n_sblocks, BS_M, P).max(axis=2)
        assert np.array_equal(full, cmax if variant == "a" else cmax >= thresh[0])
        assert full.shape == (n_tiles, n_sblocks, P)
        assert (cmax >= thresh[0]).any()
    else:
        assert np.array_equal(full, got.numpy())
