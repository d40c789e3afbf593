"""Phase-1 block-max kernel: the port of
``barcoder_tpu/ops/pallas_scan.py::_scan_max_kernel`` / ``scan_block_max``.

The max-reduce generation of phase 1, which the hit-indicator kernel
(``scan_hits``) replaced; its only caller is the sharded block-max scan
(``parallel.sharded_scan.sharded_scan_block_max``) that the scaling harness
times beside the flagship engine.

:func:`scan_block_max` keeps the JAX wrapper's argument list, output layout
and ``ValueError``. A CUDA tensor launches the hand-written kernel in
``csrc/scan_max.cu`` (an int8 product on the tensor cores with ``wgmma``, on
the main loop it shares with ``scan_hits`` through ``csrc/wgmma_tile.cuh``;
built with ``nvcc`` for sm_90a at first use and loaded with ctypes, by
``nvcc.py``); a CPU tensor takes :func:`scan_block_max_reference`, the plain
torch version with the same contract. Nothing falls back: a kernel that does
not build or launch raises.

Both compute, for each (genome tile t, subtile u, spacer block s of BS = 128
rows), the largest biased score over the block's rows and the subtile's
columns. The scores are small integers and the bias values (0 and
MASK_BIAS) are exact in bf16, so both versions agree bit for bit with the
TPU kernel; the kernel adds the bias to the int32 column max in f32, after
the max and per row group (folded, only the rows with a nonzero column 4L
carry it), which keeps the TPU's bf16 rounding of any other folded bias
value too.
"""

from __future__ import annotations

import ctypes

import torch

from . import nvcc
from .scan_hits import BS, MASK_BIAS, _cdiv, build_g_onehot

# kernel launches since the counter was last reset (the smoke run resets it
# and checks that the main path went through the kernel)
launches = 0

_MAX_L = 32  # the kernel's deepest product: 4 k-steps of 32 int8 values


def _check(q_onehot, tiles, bias_tiles, *, L, K, P, SUB, fold_bias):
    if fold_bias and 4 * L >= K:
        raise ValueError(f"fold_bias needs a spare G row: 4L={4*L} >= K={K}")
    if q_onehot.shape[1] != K:
        raise ValueError(f"q_onehot has {q_onehot.shape[1]} columns, expected K={K}")
    if P % SUB:
        raise ValueError(f"SUB={SUB} must divide P={P}")
    if tiles.shape[1] != 1 or tiles.shape[2] < P + L - 1:
        raise ValueError(f"tiles {tuple(tiles.shape)} need (n, 1, >= P + L - 1)")
    if tuple(bias_tiles.shape) != (tiles.shape[0], 1, P):
        raise ValueError(f"bias_tiles {tuple(bias_tiles.shape)} need ({tiles.shape[0]}, 1, {P})")


def _nsb_pad(n_sblocks: int) -> int:
    return max(_cdiv(n_sblocks, 128) * 128, 128)


def scan_block_max_reference(q_onehot, tiles, bias_tiles, *, L, K, P, SUB=1,
                             fold_bias=False):
    """Plain torch version of the kernel (the contract of
    ``parallel/sharded_scan.py::_fallback_block_max``, with SUB and fold),
    one tile at a time so the (S_pad, P) score matrix stays bounded.
    Products of 0/1 values summed in float32 are exact integers."""
    _check(q_onehot, tiles, bias_tiles, L=L, K=K, P=P, SUB=SUB, fold_bias=fold_bias)
    n_sblocks = q_onehot.shape[0] // BS
    n_tiles = tiles.shape[0]
    out = torch.full((n_tiles, SUB, _nsb_pad(n_sblocks)), MASK_BIAS,
                     dtype=torch.float32, device=q_onehot.device)
    q = q_onehot[: n_sblocks * BS].to(torch.float32)
    for t in range(n_tiles):
        g = build_g_onehot(tiles[t, 0], L=L, K=K, P=P)
        bias = bias_tiles[t, 0].to(torch.float32)
        if fold_bias:
            # the TPU folds the bias into G row 4L as bf16; 0 and MASK_BIAS
            # are exact there, and the rounding is kept for any other value
            g[4 * L] = bias.to(torch.bfloat16).to(torch.float32)
            scores = q @ g
        else:
            scores = q @ g + bias[None, :]
        m = scores.reshape(n_sblocks, BS, SUB, P // SUB).amax(dim=(1, 3))
        out[t, :, :n_sblocks] = m.T
    return out


def scan_block_max(q_onehot, tiles, bias_tiles, *, L, K, P, SUB=1, fold_bias=False):
    """Phase 1 (block max), the JAX wrapper's contract.

    q_onehot (S_pad, K) bf16 one-hot rows (values 0 or 1), with a constant
    1 in column 4L when ``fold_bias`` (which needs 4L < K); tiles
    (n_tiles, 1, P + halo) int32 overlapped genome codes; bias_tiles
    (n_tiles, 1, P) f32 (0 where the site/PAM mask allows, MASK_BIAS where
    not). Returns (n_tiles, SUB, nsb_pad) f32: the max masked score per
    (subtile of P/SUB positions, spacer block of 128 rows), with nsb_pad =
    max(cdiv(n_sblocks, 128) * 128, 128) and the lanes >= n_sblocks at
    MASK_BIAS; a block holds a hit iff its max >= L - v."""
    if q_onehot.device.type == "cpu":
        return scan_block_max_reference(q_onehot, tiles, bias_tiles, L=L, K=K, P=P,
                                        SUB=SUB, fold_bias=fold_bias)
    if q_onehot.device.type != "cuda":
        raise ValueError(f"scan_block_max runs on cpu or cuda, not {q_onehot.device}")
    return _launch(q_onehot, tiles, bias_tiles, L=L, K=K, P=P, SUB=SUB,
                   fold_bias=fold_bias)


def k_eff(L: int) -> int:
    """The kernel's contraction depth: the 4L one-hot rows rounded up to the
    32 int8 values of one tensor-core k-step (96 at L = 20, 128 at L = 32).
    The folded bias is no row of it: it goes on after the max."""
    return _cdiv(4 * L, 32) * 32


def _launch(q_onehot, tiles, bias_tiles, *, L, K, P, SUB, fold_bias):
    global launches
    _check(q_onehot, tiles, bias_tiles, L=L, K=K, P=P, SUB=SUB, fold_bias=fold_bias)
    dev = q_onehot.device
    for name, x, dtype in (("q_onehot", q_onehot, torch.bfloat16),
                           ("tiles", tiles, torch.int32),
                           ("bias_tiles", bias_tiles, torch.float32)):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor on {dev}, got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )
    if L > _MAX_L:
        raise ValueError(f"the CUDA kernel takes L <= {_MAX_L} (4L <= 128); got L={L}")
    n_sblocks = q_onehot.shape[0] // BS
    nsb_pad = _nsb_pad(n_sblocks)
    n_tiles = tiles.shape[0]
    # the order-preserving keys of the maxima, decoded to f32 in place
    keys = torch.zeros((n_tiles, SUB, nsb_pad), dtype=torch.int32, device=dev)
    # the kernel's own scratch: the units' rows as int8 chunks (a block
    # holding both row groups is two units) and their block and group
    K_eff = k_eff(L)
    qc = torch.empty(((2 if fold_bias else 1) * n_sblocks * BS, K_eff), dtype=torch.uint8,
                     device=dev)
    meta = torch.zeros(1 + 2 * n_sblocks, dtype=torch.int32, device=dev)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = nvcc.launcher("scan_max", "scan_block_max_launch",
                           [vp] * 6 + [i32] * 8 + [i64, i32, vp])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            q_onehot.data_ptr(), qc.data_ptr(), meta.data_ptr(), tiles.data_ptr(),
            bias_tiles.data_ptr(), keys.data_ptr(), n_tiles, n_sblocks, nsb_pad, K,
            K_eff // 32, L, P, SUB, tiles.shape[2], int(bool(fold_bias)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"scan_max kernel launch failed with CUDA error {rc}")
    launches += 1
    return keys.view(torch.float32)
