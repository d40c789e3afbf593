"""The arithmetic of the port's int8 phase-1 kernel (csrc/scan_hits.cu), as a
plain torch model, held EXACTLY against the kernel's plain version
``scan_block_hits_reference`` (itself bit-equal to the Pallas kernel,
test_torch_scan_hits.py).

The model does what the kernel does, in the same number types:

* Q through the wrapper's own ``q_chunks`` (the one-hot rows cut to K_eff
  int8 columns, spacer blocks padded to a multiple of 64 rows by repeating a
  row, the wgmma chunk layout), read back as rows;
* G as int8 through the wrapper's ``int8_g``: the one-hot rows from the
  codes, and in the folded mode rows 4L + i set to -128 where bias row i is
  nonzero;
* the product in int32, the column max over each (padded) spacer block;
* the additive bias (no fold) added in f32 after the max;
* the threshold and the counts per subtile.

The CUDA kernel itself is held against the plain version on the card by
test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from barcoder_tpu_torch.ops import scan_hits
from barcoder_tpu_torch.ops.scan_hits import MASK_BIAS, bias_row, int8_g, k_eff, q_chunks

from .test_torch_gpu import FOLD_ROWS, K, MODES, N_TILES, P, make_case

torch.set_num_threads(1)


def int8_model(thresh, q_onehot, tiles, bias_tiles, *, L, K, P, SUB, BS_M, fold_bias,
               matrix_rows):
    R = bias_tiles.shape[1]
    K_eff = k_eff(L, R, fold_bias)
    n_sblocks = q_onehot.shape[0] // BS_M
    n_sb_pad8 = -(-n_sblocks // 8) * 8
    qc = q_chunks(q_onehot, n_sblocks, BS_M, K_eff)
    q8 = qc.permute(0, 2, 3, 1, 4).reshape(-1, K_eff)  # back to rows
    bs64 = q8.shape[0] // n_sblocks
    out = torch.zeros((tiles.shape[0], n_sb_pad8, SUB), dtype=torch.float32)
    for t in range(tiles.shape[0]):
        if matrix_rows:
            windows = tiles[t, :L, :P]
        else:
            windows = tiles[t, 0].unfold(0, P, 1)[:L]
        g = int8_g(windows, bias_tiles[t], K_eff=K_eff, fold=fold_bias)
        scores = q8.to(torch.int32) @ g.to(torch.int32)
        colmax = scores.reshape(n_sblocks, bs64, P).amax(dim=1)
        add = 0.0 if fold_bias else bias_tiles[t, 0][None, :]
        hit = colmax.to(torch.float32) + add >= thresh.reshape(-1)[0]
        out[t, :n_sblocks] = hit.reshape(n_sblocks, SUB, P // SUB).sum(dim=2).to(torch.float32)
    return out


@pytest.mark.parametrize("BS_M", [128, 256, 80])
@pytest.mark.parametrize("SUB", [1, 4, 32])
@pytest.mark.parametrize("matrix_rows", [False, True])
@pytest.mark.parametrize("mode,L", MODES)
def test_int8_model_matches_plain(mode, L, matrix_rows, SUB, BS_M):
    """Every bias mode and L the JAX wrapper accepts, dense and matrix_rows
    tiles, 1 to 32 subtiles, spacer blocks of 128 and 256 rows and of 80
    (padded to 128)."""
    thresh, q, tiles, bias = (torch.from_numpy(x) for x in make_case(
        L, mode, matrix_rows, seed=L * 10 + SUB + BS_M))
    q = q.to(torch.bfloat16)
    kw = dict(L=L, K=K, P=P, SUB=SUB, BS_M=BS_M, fold_bias=mode != "additive",
              matrix_rows=matrix_rows)
    want = scan_hits.scan_block_hits_reference(thresh, q, tiles, bias, **kw)
    got = int8_model(thresh, q, tiles, bias, **kw)
    assert got.shape == want.shape == (N_TILES, 8, SUB)
    assert torch.equal(got, want)
    assert want.sum() > 0


@pytest.mark.parametrize("mode", ["fold1", "fold2", "additive"])
@pytest.mark.parametrize("L", [8, 20, 24, 31, 32])
def test_k_eff(mode, L):
    """The depth covers the 4L one-hot rows and the folded bias rows, in
    whole k-steps of 32, and no more."""
    R = FOLD_ROWS[mode]
    fold = mode != "additive"
    want = {("fold1", 8): 64, ("fold2", 8): 64, ("additive", 8): 32,
            ("fold1", 20): 96, ("fold2", 20): 96, ("additive", 20): 96,
            ("fold1", 24): 128, ("fold2", 24): 128, ("additive", 24): 96,
            ("fold1", 31): 128, ("fold2", 31): 128, ("additive", 31): 128,
            ("fold1", 32): 160, ("fold2", 32): 160, ("additive", 32): 128}[mode, L]
    got = k_eff(L, R, fold)
    assert got == want
    assert got % 32 == 0 and 4 * L + (R if fold else 0) <= got < 4 * L + (R if fold else 0) + 32


def test_q_chunks_layout():
    """Chunk byte c * 1024 + g * 128 + r * 16 + b is row 8g + r, column
    16c + b of the chunk's 64 rows; a block of 80 rows ends with 48 copies
    of its last row."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(0, 2, (160, 128))).to(torch.bfloat16)
    qc = q_chunks(q, 2, 80, 96).reshape(-1)
    rows = q.to(torch.int8)[:, :96].reshape(2, 80, 96)
    for s in range(2):
        for r in range(128):
            i, rc = divmod(s * 128 + r, 64)
            for k in (0, 15, 16, 47, 95):
                off = i * 64 * 96 + (k // 16) * 1024 + (rc // 8) * 128 + (rc % 8) * 16 + k % 16
                assert qc[off] == rows[s, min(r, 79), k]


def test_bias_row_and_int8_g():
    """bias_row makes only the two bias values the kernel's fold is exact
    for; int8_g puts the one-hot rows (nothing for codes 4 and 5) over the
    folded rows, -128 where a bias row is nonzero, and folds nothing in the
    additive mode."""
    ok = torch.tensor([True, False, True, False])
    b = bias_row(ok)
    assert b.dtype == torch.float32 and b.tolist() == [0.0, MASK_BIAS, 0.0, MASK_BIAS]
    windows = torch.tensor([[0, 1, 4, 5], [3, 2, 1, 0]])  # L = 2, P = 4
    bias = torch.stack([b, bias_row(~ok)])
    g = int8_g(windows, bias, K_eff=32, fold=True)
    assert g.dtype == torch.int8 and g.shape == (32, 4)
    assert g[0:4].T.tolist() == [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]
    assert g[4:8].T.tolist() == [[0, 0, 0, 1], [0, 0, 1, 0], [0, 1, 0, 0], [1, 0, 0, 0]]
    assert g[8].tolist() == [0, -128, 0, -128] and g[9].tolist() == [-128, 0, -128, 0]
    assert not g[10:].any()
    additive = int8_g(windows, bias[:1], K_eff=32, fold=False)
    assert torch.equal(additive[:8], g[:8]) and not additive[8:].any()
