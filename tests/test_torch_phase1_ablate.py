"""The port's phase-1 ablations (barcoder_tpu_torch.ops.phase1_variants:
``ablate``, ``build_g_all``) held against the TPU kernels of
``experiments/phase1_ablate.py`` (``make_fn`` / ``make_kern``, interpret
mode), loaded from the unchanged file as test_torch_int8_bench.py describes.

Variants, as the script's timing lines name them: A G built in the kernel,
counts per step; B G streamed from ``g_all``, per step; C built, counts
batched over 8 spacer blocks; D streamed, batched. With 12 spacer blocks the
batched variants never write the last group of 4: its rows stay zero in
both versions. The streamed variants get a g_all built from other codes than
``tiles``, so each side shows that it reads g_all. Every comparison is EXACT.
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

# phase1_ablate.py:147-150
MAKE_FN = {"A": dict(stream_g=False, batched_seg=False), "B": dict(stream_g=True, batched_seg=False),
           "C": dict(stream_g=False, batched_seg=True), "D": dict(stream_g=True, batched_seg=True)}


def load(L, P, SUB, BS_M, n_tiles, n_sblocks, q, tiles, bias):
    return load_experiment("phase1_ablate", dict(
        L=L, K=K, P=P, SUB=SUB, BS_M=BS_M, N_TILES=n_tiles, N_SB=n_sblocks,
        q_dev=jnp.asarray(q, jnp.bfloat16), tiles=jnp.asarray(tiles), bias=jnp.asarray(bias),
    ), defs=("build_g_all", "make_kern", "make_fn"))


@pytest.mark.parametrize("n_sblocks", [8, 12])
@pytest.mark.parametrize("variant", "ABCD")
def test_ablate_matches_pallas(variant, n_sblocks):
    n_tiles, L, P, SUB, BS_M = 2, 20, 512, 8, 32
    thresh, q, tiles, bias = make_phase1_case(n_tiles, n_sblocks, L=L, P=P, BS_M=BS_M,
                                              seed=n_sblocks)
    g_tiles = np.roll(tiles, 7, axis=2)  # the codes behind the streamed G
    ns = load(L, P, SUB, BS_M, n_tiles, n_sblocks, q, tiles, bias)
    ns["g_all"] = ns["build_g_all"](jnp.asarray(g_tiles), ns["bias"])
    fn, _ = ns["make_fn"](**MAKE_FN[variant])
    want = np.asarray(fn(jnp.asarray(thresh), ns["q_dev"], ns["tiles"], ns["bias"], ns["g_all"]))

    th, qt, tt, bt = phase1_tensors(thresh, q, tiles, bias, "cpu")
    g_all = phase1_variants.build_g_all(torch.from_numpy(g_tiles), bt, L=L, K=K, P=P)
    before = dict(phase1_variants.launches)
    got = phase1_variants.ablate(variant, th, qt, tt, bt, g_all, L=L, K=K, P=P, SUB=SUB,
                                 BS_M=BS_M)
    assert phase1_variants.launches == before  # CPU tensors never reach the kernel
    assert got.shape == want.shape == (n_tiles, 16 if n_sblocks == 12 else 8, SUB)
    assert np.array_equal(got.numpy(), want)
    assert want[:, :8].sum() > 0
    if n_sblocks == 12:  # the last group: written per step, never when batched
        assert (want[:, 8:12].sum() == 0) == MAKE_FN[variant]["batched_seg"]
        assert want[:, 12:].sum() == 0


@pytest.mark.parametrize("L,P", [(20, 256), (31, 400)])
def test_build_g_all_matches_jax(L, P):
    n_tiles = 3
    _, _, tiles, bias = make_phase1_case(n_tiles, 8, L=L, P=P, BS_M=16, seed=L)
    ns = load(L, P, 8, 16, n_tiles, 8, np.zeros((128, K), np.float32), tiles, bias)
    want = np.asarray(ns["build_g_all"](ns["tiles"], ns["bias"]).astype(jnp.float32))
    got = phase1_variants.build_g_all(torch.from_numpy(tiles), torch.from_numpy(bias),
                                      L=L, K=K, P=P)
    assert got.dtype == torch.bfloat16 and got.shape == (n_tiles, K, P)
    assert np.array_equal(got.float().numpy(), want)
    assert (want[:, 4 * L] < 0).any()  # a masked column reaches the bias row


def test_streamed_variant_needs_g_all():
    thresh, q, tiles, bias = make_phase1_case(1, 8, L=20, P=256, BS_M=16, seed=5)
    args = phase1_tensors(thresh, q, tiles, bias, "cpu")
    with pytest.raises(ValueError, match="g_all"):
        phase1_variants.ablate("B", *args, None, L=20, K=K, P=256, SUB=8, BS_M=16)
