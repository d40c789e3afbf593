"""The port's block-max kernel module (barcoder_tpu_torch.ops.scan_max) held
against the JAX package's Pallas kernel (scan_block_max, interpret mode) and
its pure-jnp twin (sharded_scan._fallback_block_max).

Every comparison is EXACT (bit-equal outputs): the scores are sums of 0/1
products, i.e. small integers, and the bias values 0 and -16384 are exact
in bf16 and f32, so no tolerance is needed.

On this host the port's wrapper takes its plain torch version (the inputs
lie on the CPU); the CUDA kernel is held against the same plain version on
the card by test_torch_gpu.py and chip_smoke.py, on inputs from the same
case generator (make_max_case: zero padding rows in the last spacer block,
the last tile fully masked).

Grid: fold on (L = 20, 24) and off (L = 20, 24, 32) × SUB ∈ {1, 4, 32} at
P = 512 with 2 tiles and 1-3 spacer blocks. Fold at L = 32 has no spare G
row; test_refused_modes_raise checks that both wrappers refuse it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from barcoder_tpu.ops.pallas_scan import scan_block_max as jax_scan_block_max
from barcoder_tpu.parallel.sharded_scan import _fallback_block_max
from barcoder_tpu_torch.ops import scan_max

from .test_torch_gpu import K, P, make_max_case

torch.set_num_threads(1)

MODES = [(True, 20), (True, 24), (False, 20), (False, 24), (False, 32)]


def port_block_max(q, codes, bias, **kw):
    return scan_max.scan_block_max(
        torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(codes),
        torch.from_numpy(bias), **kw,
    ).numpy()


@pytest.mark.parametrize("SUB", [1, 4, 32])
@pytest.mark.parametrize("fold,L", MODES)
def test_matches_pallas(fold, L, SUB):
    n_blocks = 1 + (L + SUB) % 3
    q, codes, bias = make_max_case(L, fold, n_blocks, seed=L * 100 + SUB)
    kw = dict(L=L, K=K, P=P, SUB=SUB, fold_bias=fold)
    want = np.asarray(jax_scan_block_max(
        jnp.asarray(q, dtype=jnp.bfloat16), jnp.asarray(codes), jnp.asarray(bias),
        interpret=True, **kw,
    ))
    before = scan_max.launches
    got = port_block_max(q, codes, bias, **kw)
    assert scan_max.launches == before  # CPU tensors never reach the kernel
    assert got.shape == want.shape == (2, SUB, 128)
    assert np.array_equal(got, want)
    assert (want[:, :, n_blocks:] == -16384).all()  # lanes past the blocks
    assert (want[0, :, :n_blocks] >= 0).any()  # allowed columns score
    # the fully masked tail tile: with fold the zero padding rows score 0
    # there, every real row about -16384
    tail = want[1, :, n_blocks - 1]
    assert (tail == 0).all() if fold else (tail < -16000).all()


@pytest.mark.parametrize("L", [20, 32])
def test_matches_jnp_fallback(L):
    """SUB = 1, additive: the contract of the JAX sharded engine's CPU twin."""
    q, codes, bias = make_max_case(L, False, 3, seed=7 + L)
    want = np.asarray(_fallback_block_max(
        jnp.asarray(q, dtype=jnp.bfloat16), jnp.asarray(codes), jnp.asarray(bias),
        L=L, K=K, P=P,
    ))
    got = port_block_max(q, codes, bias, L=L, K=K, P=P)
    assert np.array_equal(got, want)


def test_refused_modes_raise():
    """Fold without a spare G row (4L >= K) is refused by both wrappers."""
    q, codes, bias = make_max_case(32, False, 1, seed=3)
    kw = dict(L=32, K=K, P=P, SUB=1, fold_bias=True)
    with pytest.raises(ValueError, match="spare G row"):
        jax_scan_block_max(jnp.asarray(q, dtype=jnp.bfloat16), jnp.asarray(codes),
                           jnp.asarray(bias), interpret=True, **kw)
    with pytest.raises(ValueError, match="spare G row"):
        port_block_max(q, codes, bias, **kw)


@pytest.mark.parametrize("bad", ["sub", "bias_rows", "tile_width", "columns"])
def test_bad_shapes_raise(bad):
    """The port's wrapper refuses shapes the kernel cannot take."""
    q, codes, bias = make_max_case(20, True, 1, seed=4)
    kw = dict(L=20, K=K, P=P, SUB=4, fold_bias=True)
    if bad == "sub":
        kw["SUB"] = 3
    elif bad == "bias_rows":
        bias = np.concatenate([bias, bias], axis=1)
    elif bad == "tile_width":
        codes = codes[:, :, : P + 10]
    else:
        q = q[:, :64]
    with pytest.raises(ValueError):
        port_block_max(np.ascontiguousarray(q), np.ascontiguousarray(codes), bias, **kw)
