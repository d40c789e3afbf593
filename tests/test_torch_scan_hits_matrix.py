"""The port's phase-1 kernel module in ``matrix_rows`` mode (tiles of
independent site-window codes, column p holding its own L codes) held
against the JAX package's Pallas kernel in interpret mode.

Every comparison is EXACT (bit-equal outputs), for the reason given in
test_torch_scan_hits.py, whose case generator this file shares; the two
files split the interpret-mode compiles between test workers. Modes: fold 1
row / fold 2 rows / additive × L ∈ {20, 24, 32} × SUB ∈ {1, 4, 32}, less
the fold modes at L = 32 that the JAX wrapper refuses (4L + R > K).
"""

import numpy as np
import pytest
import torch

from barcoder_tpu_torch.ops import scan_hits

from .test_torch_gpu import MODES, N_TILES
from .test_torch_scan_hits import run_both

torch.set_num_threads(1)


@pytest.mark.parametrize("SUB", [1, 4, 32])
@pytest.mark.parametrize("mode,L", MODES)
def test_matches_pallas_matrix_rows(mode, L, SUB):
    before = scan_hits.launches
    want, got = run_both(L, mode, True, SUB, seed=L * 100 + SUB + 7)
    assert got.shape == want.shape == (N_TILES, 8, SUB)
    assert np.array_equal(got, want)
    assert want[:, 2:].sum() == 0
    assert want.sum() > 0
    assert scan_hits.launches == before
