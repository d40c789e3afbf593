"""The arithmetic of the port's int8 block-max kernel (csrc/scan_max.cu), as a
plain torch / numpy model, held EXACTLY against the Pallas kernel
(``_scan_max_kernel`` through ``scan_block_max`` in interpret mode) and
against the kernel's plain version ``scan_block_max_reference``.

The model does what the kernel does, in the same number types:

* the row-group split of ``scan_max_units_kernel``: folded, a spacer block's
  rows with a nonzero column 4L (group 1; -0.0 counts as zero) and its rows
  without (group 0) become separate units of 128 rows, each group's rows in
  place and the other rows replaced by a repeat of one of the group's; a
  block of one group is one unit. Additive, a block is one unit;
* the units' rows cut to K_eff = 4L rounded up to 32 int8 columns, through
  the wgmma chunk layout (``chunk_layout``) and back;
* G as int8 one-hot rows only (``int8_g`` without fold): the bias is no row
  of the product;
* the product in int32 and the column max over each unit's rows;
* the bias added in f32 AFTER the max: bf16-rounded and only for group 1
  when folded, as it is when additive;
* the subtile maxima through order-preserving uint32 keys: a max per
  (256-column warpgroup slice, subtile, unit) reduced into a zeroed key
  array with an unsigned max (the kernel's atomicMax), decoded to f32, the
  untouched lanes set to MASK_BIAS.

Every comparison is bit-equal: the scores are small integers, and f32
addition of one bias value is monotone, so max-then-add equals add-then-max.
The CUDA kernel itself is held against the plain version on the card by
test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from barcoder_tpu.ops.pallas_scan import scan_block_max as jax_scan_block_max
from barcoder_tpu_torch.ops import scan_max
from barcoder_tpu_torch.ops.scan_hits import BS, MASK_BIAS, int8_g, q_chunks

from .test_torch_gpu import K, make_max_case

torch.set_num_threads(1)

BN, WG = 512, 256  # columns of a thread block and of one of its warpgroups
ODD_BIAS = np.array([0.3, -3.7, 1e-3, 2.0078125, -100.25], np.float32)


def units_model(q_onehot: torch.Tensor, n_sblocks: int, L: int, fold: bool):
    """[(spacer block, group, the unit's 128 source rows)]: the first units
    in block order, then the second units of the blocks holding both groups."""
    first, second = [], []
    r = torch.arange(BS)
    for s in range(n_sblocks):
        block = q_onehot[s * BS : (s + 1) * BS]
        flag = (block[:, 4 * L] != 0) if fold else torch.zeros(BS, dtype=torch.bool)
        n1 = int(flag.sum())
        g_first = int(n1 == BS)
        rep = {g: int(torch.nonzero(flag == bool(g))[0]) for g in (0, 1) if (flag == bool(g)).any()}
        first.append((s, g_first, s * BS + torch.where(flag == bool(g_first), r, rep[g_first])))
        if 0 < n1 < BS:
            second.append((s, 1, s * BS + torch.where(flag, r, rep[1])))
    return first + second


def order_key(v: np.ndarray) -> np.ndarray:
    b = v.astype(np.float32).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | np.uint32(0x80000000)).astype(np.uint32)


def from_key(k: np.ndarray) -> np.ndarray:
    bits = np.where(k & 0x80000000, k & np.uint32(0x7FFFFFFF), ~k).astype(np.uint32)
    return np.where(k == 0, np.float32(MASK_BIAS), bits.view(np.float32))


def int8_max_model(q_onehot, tiles, bias_tiles, *, L, K, P, SUB, fold_bias):
    n_sblocks = q_onehot.shape[0] // BS
    nsb_pad = max(-(-n_sblocks // 128) * 128, 128)
    K_eff = scan_max.k_eff(L)
    units = units_model(q_onehot, n_sblocks, L, fold_bias)
    rows = torch.cat([u[2] for u in units])
    qc = q_chunks(q_onehot[rows], len(units), BS, K_eff)
    q8 = qc.permute(0, 2, 3, 1, 4).reshape(len(units), BS, K_eff)  # back to rows
    P2 = P // SUB
    keys = np.zeros((tiles.shape[0], SUB, nsb_pad), np.uint32)
    for t in range(tiles.shape[0]):
        g = int8_g(tiles[t, 0].unfold(0, P, 1)[:L], bias_tiles[t], K_eff=K_eff, fold=False)
        bias = bias_tiles[t, 0]
        folded = bias.to(torch.bfloat16).to(torch.float32)
        for (s, group, _), q_unit in zip(units, q8):
            colmax = (q_unit.to(torch.int32) @ g.to(torch.int32)).amax(dim=0)
            if fold_bias:
                add = folded if group else torch.zeros_like(folded)
            else:
                add = bias
            key = order_key((colmax.to(torch.float32) + add).numpy())
            for p0 in range(0, P, WG):  # one atomic max per (warpgroup slice, subtile)
                sub = np.arange(p0, min(p0 + WG, P)) // P2
                for u in np.unique(sub):
                    keys[t, u, s] = max(keys[t, u, s], key[p0 : p0 + WG][sub == u].max())
    return from_key(keys)


def tensors(q, codes, bias):
    return (torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(codes),
            torch.from_numpy(bias))


def pallas(q, codes, bias, **kw):
    return np.asarray(jax_scan_block_max(jnp.asarray(q, dtype=jnp.bfloat16), jnp.asarray(codes),
                                         jnp.asarray(bias), interpret=True, **kw))


def check(q, codes, bias, **kw):
    """model == plain version == Pallas kernel, bit for bit."""
    args = tensors(q, codes, bias)
    want = scan_max.scan_block_max_reference(*args, **kw).numpy()
    got = int8_max_model(*args, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(pallas(q, codes, bias, **kw), want)
    return want


@pytest.mark.parametrize("SUB", [1, 4, 32])
@pytest.mark.parametrize("fold,L", [(True, 20), (True, 24), (False, 20), (False, 24), (False, 32)])
def test_model_matches_pallas_and_plain(fold, L, SUB):
    """The cases of test_torch_scan_max.py: the last spacer block holds 88
    real rows and 40 zero padding rows, so folded it is two units, split
    inside a 64-row chunk; the last tile is fully masked."""
    n_blocks = 1 + (L + SUB) % 3
    q, codes, bias = make_max_case(L, fold, n_blocks, seed=L * 100 + SUB)
    want = check(q, codes, bias, L=L, K=K, P=512, SUB=SUB, fold_bias=fold)
    tail = want[1, :, n_blocks - 1]
    assert (tail == 0).all() if fold else (tail < -16000).all()


@pytest.mark.parametrize("SUB", [1, 8])
@pytest.mark.parametrize("fold", [True, False])
def test_all_padding_block_and_negative_zero(fold, SUB):
    """168 padding rows: the last block is all padding (one unit of group 0),
    the one before it mixed. One padding row holds -0.0 in column 4L, which
    counts as zero, and one real row of the first block lacks the constant."""
    L = 20
    q, codes, bias = make_max_case(L, fold, 3, seed=11 + SUB, n_pad=168)
    q[-1, 4 * L] = -0.0
    q[5, 4 * L] = 0.0
    units = units_model(torch.from_numpy(q).to(torch.bfloat16), 3, L, fold)
    assert [(s, g) for s, g, _ in units] == (
        [(0, 0), (1, 0), (2, 0), (0, 1), (1, 1)] if fold else [(0, 0), (1, 0), (2, 0)])
    want = check(q, codes, bias, L=L, K=K, P=512, SUB=SUB, fold_bias=fold)
    if fold:  # on the masked tile only the padding rows score 0
        assert (want[1, :, 1:3] == 0).all()


@pytest.mark.parametrize("SUB", [1, 4, 25])
@pytest.mark.parametrize("fold,L", [(True, 20), (True, 24), (False, 20), (False, 32)])
def test_odd_bias_and_ragged_tile(fold, L, SUB):
    """Bias values that bf16 rounds, in both modes (the fold keeps the
    rounding, the additive mode adds the f32 value), at P = 1,200: three
    512-column blocks, the last 176 wide, and subtiles of 1,200, 300 and 48
    columns that straddle the blocks' and the warpgroups' edges."""
    q, codes, bias = make_max_case(L, fold, 2, seed=L + SUB, P=1200)
    rng = np.random.default_rng(L * SUB)
    odd = rng.random(bias.shape) < 0.15
    bias[odd] = rng.choice(ODD_BIAS, int(odd.sum()))
    want = check(q, codes, bias, L=L, K=K, P=1200, SUB=SUB, fold_bias=fold)
    assert not np.isin(want[:, :, :2], [0.0, MASK_BIAS]).all()  # odd values came through


def test_order_key_is_monotone_and_invertible():
    v = np.array([-np.inf, -16384.0, -100.25, -1e-3, -0.0, 0.0, 1e-3, 0.3, 20.0, np.inf],
                 np.float32)
    k = order_key(v)
    assert (np.diff(k.astype(np.int64)) >= 0).all() and (k != 0).all()
    assert np.array_equal(from_key(k).view(np.uint32), v.view(np.uint32))
    assert from_key(np.zeros(1, np.uint32))[0] == MASK_BIAS


@pytest.mark.parametrize("L,want", [(8, 32), (20, 96), (24, 96), (31, 128), (32, 128)])
def test_k_eff(L, want):
    assert scan_max.k_eff(L) == want
