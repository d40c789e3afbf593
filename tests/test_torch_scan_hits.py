"""The port's phase-1 kernel module (barcoder_tpu_torch.ops.scan_hits) held
against the JAX package's Pallas kernel (scan_block_hits, interpret mode).

Every comparison is EXACT (bit-equal outputs): the scores are sums of 0/1
products, i.e. small integers, and the bias values 0 and -16384 are exact
in bf16 and f32, so no tolerance is needed.

On this host the port's wrapper takes its plain torch version (the inputs
lie on the CPU); the CUDA kernel is held against the same plain version on
the card by test_torch_gpu.py and by chip_smoke.py, on inputs from the same
case generator.

Modes covered (dense tiles here, matrix_rows tiles in
test_torch_scan_hits_matrix.py): fold 1 row / fold 2 rows / additive ×
L ∈ {20, 24, 32} × SUB ∈ {1, 4, 32}, at P = 512 with 2 tiles and 2 spacer
blocks. Left out because the JAX wrapper itself refuses them (fold needs
4L + R <= K = 128): L = 32 with fold 1 row and L = 32 with fold 2 rows;
test_refused_modes_raise checks that both wrappers refuse them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from barcoder_tpu.ops.pallas_scan import scan_block_hits as jax_scan_block_hits
from barcoder_tpu_torch.ops import scan_hits

from .test_torch_gpu import BS_M, K, MODES, N_TILES, P, make_case

torch.set_num_threads(1)


def run_both(L, mode, matrix_rows, SUB, seed):
    thresh, q, tiles, bias = make_case(L, mode, matrix_rows, seed)
    kw = dict(L=L, K=K, P=P, SUB=SUB, BS_M=BS_M, fold_bias=mode != "additive",
              matrix_rows=matrix_rows)
    want = np.asarray(jax_scan_block_hits(
        jnp.asarray(thresh), jnp.asarray(q, dtype=jnp.bfloat16),
        jnp.asarray(tiles), jnp.asarray(bias), interpret=True, **kw,
    ))
    got = scan_hits.scan_block_hits(
        torch.from_numpy(thresh), torch.from_numpy(q).to(torch.bfloat16),
        torch.from_numpy(tiles), torch.from_numpy(bias), **kw,
    )
    return want, got.numpy()


@pytest.mark.parametrize("SUB", [1, 4, 32])
@pytest.mark.parametrize("mode,L", MODES)
def test_matches_pallas_dense(mode, L, SUB):
    before = scan_hits.launches
    want, got = run_both(L, mode, False, SUB, seed=L * 100 + SUB)
    assert got.shape == want.shape == (N_TILES, 8, SUB)
    assert np.array_equal(got, want)
    assert want[:, 2:].sum() == 0  # pad rows n_sblocks..n_sb_pad8 are zero
    assert want.sum() > 0  # the case produces hits
    assert scan_hits.launches == before  # CPU tensors never reach the kernel


@pytest.mark.parametrize("L,R", [(32, 1), (32, 2)])
def test_refused_modes_raise(L, R):
    """fold without spare G rows, and several bias rows without fold, are
    refused by both wrappers."""
    q = np.zeros((BS_M, K), np.float32)
    tiles = np.zeros((1, 1, P + K // 4), np.int32)
    bias = np.zeros((1, R, P), np.float32)
    th = np.array([1.0], np.float32)
    for fold in (True, False) if R == 2 else (True,):
        kw = dict(L=L, K=K, P=P, SUB=1, BS_M=BS_M, fold_bias=fold)
        with pytest.raises(ValueError):
            jax_scan_block_hits(jnp.asarray(th), jnp.asarray(q, dtype=jnp.bfloat16),
                                jnp.asarray(tiles), jnp.asarray(bias),
                                interpret=True, **kw)
        with pytest.raises(ValueError):
            scan_hits.scan_block_hits(
                torch.from_numpy(th), torch.from_numpy(q).to(torch.bfloat16),
                torch.from_numpy(tiles), torch.from_numpy(bias), **kw,
            )


def test_short_code_window_raises():
    """The JAX G build clamps a window start past the tile; the port's
    refuses a tile narrower than P + L - 1 instead of reading other codes."""
    with pytest.raises(ValueError, match="window width"):
        scan_hits.build_g_onehot(torch.zeros(P + 5, dtype=torch.int32), L=20, K=K, P=P)
