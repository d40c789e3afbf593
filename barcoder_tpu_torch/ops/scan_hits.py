"""Phase-1 hit-indicator kernel: the port of
``barcoder_tpu/ops/pallas_scan.py::_scan_hits_kernel`` / ``scan_block_hits``.

:func:`scan_block_hits` keeps the JAX wrapper's argument list and output
layout. A CUDA tensor launches the hand-written kernel in
``csrc/scan_hits.cu`` (an int8 product on the tensor cores with ``wgmma``,
built with ``nvcc`` for sm_90a at first use and loaded with ctypes, by
``nvcc.py``); a CPU tensor takes :func:`scan_block_hits_reference`, the
plain torch version with the same contract. Nothing falls back: a kernel
that does not build or launch raises.

Both compute, for each (genome tile t, spacer block s), the number of
columns in each of SUB subtiles whose best biased score over the block's
rows reaches ``thresh``. The scores are small integers and the bias values
(0 and MASK_BIAS) are exact in bf16, so both versions agree bit for bit
with the TPU kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import nvcc

BS = 128  # default spacer block height (the TPU kernel's MXU M dim)
MASK_BIAS = -16384.0  # added to masked-out positions; far below any score

# kernel launches since the counter was last reset (the smoke run resets it
# and checks that the main path went through the kernel), and of those the
# launches in matrix_rows mode (the site engine's)
launches = 0
matrix_launches = 0

_MAX_K = 128  # the kernel's deepest product: 4 k-steps of 32 int8 values


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def build_g_onehot(g_flat: torch.Tensor, *, L: int, K: int, P: int) -> torch.Tensor:
    """codes (..., W) → one-hot G (..., K, P) float32 with layout row =
    4j + b (codes 4 = N and 5 = out of bounds give zero columns).

    Trap: the JAX version slices window j with ``dynamic_slice_in_dim``,
    which CLAMPS a start that would run past W; ``unfold`` here yields fewer
    windows instead. Every caller passes W >= P + L - 1, so neither case
    arises — and the check turns a short input into an error rather than a
    silently different G."""
    W = g_flat.shape[-1]
    if W < P + L - 1:
        raise ValueError(f"code window width {W} < P + L - 1 = {P + L - 1}")
    return _onehot_g(g_flat.unfold(-1, P, 1)[..., :L, :], K=K)


def _onehot_g(windows: torch.Tensor, *, K: int) -> torch.Tensor:
    """(..., L, P) window codes (column p's base j at [j, p]) → one-hot G
    (..., K, P) float32, rows 4L..K zero."""
    L, P = windows.shape[-2:]
    base = torch.arange(4, device=windows.device, dtype=windows.dtype)
    onehot = windows[..., :, None, :] == base[:, None]  # (..., L, 4, P)
    g4l = onehot.reshape(*windows.shape[:-2], 4 * L, P).to(torch.float32)
    if 4 * L < K:
        g4l = torch.nn.functional.pad(g4l, (0, 0, 0, K - 4 * L))
    return g4l


def bias_row(ok: torch.Tensor) -> torch.Tensor:
    """The bias of a PAM/site mask: 0 where ``ok``, MASK_BIAS elsewhere, f32.
    These are the two values the CUDA kernel's folded bias is exact for."""
    return torch.where(ok, 0.0, MASK_BIAS).to(torch.float32)


def int8_g(windows: torch.Tensor, bias: torch.Tensor, *, K_eff: int, fold: bool) -> torch.Tensor:
    """G as the CUDA kernel builds it, (..., K_eff, P) int8, from (..., L, P)
    window codes and the (..., R, P) bias: the one-hot rows 4j + b and,
    folded, rows 4L + i set to -128 where bias row i is nonzero (0
    elsewhere)."""
    L = windows.shape[-2]
    g = _onehot_g(windows, K=K_eff).to(torch.int8)
    if fold:
        R = bias.shape[-2]
        g[..., 4 * L : 4 * L + R, :] = torch.where(bias != 0, -128, 0).to(torch.int8)
    return g


def _check(q_onehot, tiles, bias_tiles, *, L, K, P, SUB, fold_bias, matrix_rows):
    bias_rows = bias_tiles.shape[1]
    if fold_bias and 4 * L + bias_rows > K:
        raise ValueError(
            f"fold_bias needs spare G rows: 4L+{bias_rows}={4*L+bias_rows} > K={K}"
        )
    if not fold_bias and bias_rows != 1:
        raise ValueError("multiple bias rows require fold_bias")
    if q_onehot.shape[1] != K:
        raise ValueError(f"q_onehot has {q_onehot.shape[1]} columns, expected K={K}")
    if P % SUB:
        raise ValueError(f"SUB={SUB} must divide P={P}")
    if matrix_rows:
        if tiles.shape[1] < L or tiles.shape[2] != P:
            raise ValueError(f"matrix_rows tiles {tuple(tiles.shape)} need (n, >= L, P)")
    elif tiles.shape[1] != 1 or tiles.shape[2] < P + L - 1:
        raise ValueError(f"tiles {tuple(tiles.shape)} need (n, 1, >= P + L - 1)")
    if bias_tiles.shape[0] != tiles.shape[0] or bias_tiles.shape[2] != P:
        raise ValueError(f"bias_tiles {tuple(bias_tiles.shape)} do not match tiles")


def scan_block_hits_reference(thresh, q_onehot, tiles, bias_tiles, *, L, K, P,
                              SUB=1, BS_M=BS, fold_bias=False, matrix_rows=False):
    """Plain torch version of the kernel (the contract of
    ``parallel/sharded_scan.py``'s exact-contract ``per_tile`` fallback),
    one tile at a time so the (S_pad, P) score matrix stays bounded.
    Products of 0/1 values summed in float32 are exact integers."""
    _check(q_onehot, tiles, bias_tiles, L=L, K=K, P=P, SUB=SUB, fold_bias=fold_bias,
           matrix_rows=matrix_rows)
    n_sblocks = q_onehot.shape[0] // BS_M
    n_sb_pad8 = _cdiv(n_sblocks, 8) * 8
    n_tiles = tiles.shape[0]
    bias_rows = bias_tiles.shape[1]
    out = torch.zeros((n_tiles, n_sb_pad8, SUB), dtype=torch.float32,
                      device=q_onehot.device)
    q = q_onehot[: n_sblocks * BS_M].to(torch.float32)
    th = thresh.reshape(-1)[0]
    for t in range(n_tiles):
        if matrix_rows:  # column p holds its own L codes
            g = _onehot_g(tiles[t, :L, :P], K=K)
        else:
            g = build_g_onehot(tiles[t, 0], L=L, K=K, P=P)
        bias = bias_tiles[t].to(torch.float32)
        if fold_bias:
            # the TPU folds the bias rows into G as bf16; 0 and MASK_BIAS
            # are exact there, and the rounding is kept for any other value
            g = g.clone()
            g[4 * L : 4 * L + bias_rows] = bias.to(torch.bfloat16).to(torch.float32)
            scores = q @ g
        else:
            scores = q @ g + bias[0][None, :]
        colmax = scores.reshape(n_sblocks, BS_M, P).amax(dim=1)
        hit = colmax >= th
        out[t, :n_sblocks] = hit.reshape(n_sblocks, SUB, P // SUB).sum(dim=2).to(torch.float32)
    return out


def scan_block_hits(thresh, q_onehot, tiles, bias_tiles, *, L, K, P, SUB=1,
                    BS_M=BS, fold_bias=False, matrix_rows=False):
    """Phase 1 (hit indicator), the JAX wrapper's contract.

    thresh f32 (1,) — a score >= thresh is a hit (callers pass L - v);
    q_onehot (S_pad, K) bf16 one-hot rows (values 0 or 1) with constant-1
    bias columns at 4L (+1) when ``fold_bias``; tiles (n_tiles, 1, P + halo)
    int32 overlapped genome codes, or with ``matrix_rows`` (n_tiles, >= L, P)
    independent window codes; bias_tiles (n_tiles, R, P) f32 (0 or
    MASK_BIAS). Returns (n_tiles, n_sb_pad8, SUB) f32 hit-column counts per
    (subtile, spacer block), with the block axis padded to a multiple of 8
    by zero rows. Raises, like the JAX wrapper, on fold without spare rows
    and on several bias rows without fold.

    The CUDA kernel computes in int8 and meets this contract bit for bit
    under two conditions, which every caller meets:

    * folded bias: each bias value is 0 or MASK_BIAS (callers build it with
      :func:`bias_row`), and thresh > -96 (the callers pass L - v >= 1). The
      kernel folds a nonzero bias in as -128 (:func:`int8_g`),
      so a masked row scores at most 32 - 128 where the TPU's scores at most
      32 - 16384; both stay below such a threshold, and unmasked rows score
      the same;
    * additive bias (no fold): any f32 value; it is added to the int32
      column max, and max_r(s_r + b) = max_r(s_r) + b.

    It takes at most 2 bias rows and 4L + the folded rows <= 128."""
    if q_onehot.device.type == "cpu":
        return scan_block_hits_reference(
            thresh, q_onehot, tiles, bias_tiles, L=L, K=K, P=P, SUB=SUB,
            BS_M=BS_M, fold_bias=fold_bias, matrix_rows=matrix_rows,
        )
    if q_onehot.device.type != "cuda":
        raise ValueError(f"scan_block_hits runs on cpu or cuda, not {q_onehot.device}")
    return _launch(thresh, q_onehot, tiles, bias_tiles, L=L, K=K, P=P, SUB=SUB,
                   BS_M=BS_M, fold_bias=fold_bias, matrix_rows=matrix_rows)


def k_eff(L: int, bias_rows: int, fold_bias: bool) -> int:
    """The kernel's contraction depth: the 4L one-hot rows plus the folded
    bias rows, rounded up to the 32 int8 values of one tensor-core k-step
    (96 for L = 20 with two folded rows, 128 for L = 24 and L = 32)."""
    return _cdiv(4 * L + (bias_rows if fold_bias else 0), 32) * 32


def chunk_layout(q: torch.Tensor, BS_M: int) -> torch.Tensor:
    """Rows as the wgmma kernels read them (``csrc/wgmma_tile.cuh``): q is
    (n_sblocks * BS_M, K) of 1- or 2-byte elements, K a multiple of 32 bytes.
    Each spacer block is padded to a multiple of 64 rows by repeating its
    last row (a repeated row leaves the block's column max as it is); every
    64-row chunk is laid out as (K bytes / 16, 8, 8, 16 bytes), the 8-row x
    16-byte core matrices of wgmma's K-major operand: core matrix (row
    group g, K piece c) at byte c * 1024 + g * 128 of its chunk."""
    K = q.shape[1]
    per = 16 // q.element_size()  # elements in a 16-byte K piece
    q = q.reshape(-1, BS_M, K)
    bs64 = _cdiv(BS_M, 64) * 64
    if bs64 != BS_M:
        q = torch.cat([q, q[:, -1:].expand(q.shape[0], bs64 - BS_M, K)], dim=1)
    return q.reshape(-1, 8, 8, K // per, per).permute(0, 3, 1, 2, 4).contiguous()


def q_chunks(q_onehot: torch.Tensor, n_sblocks: int, BS_M: int, K_eff: int) -> torch.Tensor:
    """Q as the int8 kernels read it: the first n_sblocks * BS_M one-hot rows
    cut (or zero-padded) to K_eff int8 columns (columns past K_eff meet zero
    G rows, on the TPU too, so they never change a score), in
    :func:`chunk_layout`."""
    q8 = q_onehot[: n_sblocks * BS_M, :K_eff].to(torch.int8)
    if q8.shape[1] < K_eff:
        q8 = torch.nn.functional.pad(q8, (0, K_eff - q8.shape[1]))
    return chunk_layout(q8, BS_M)


def _launch(thresh, q_onehot, tiles, bias_tiles, *, L, K, P, SUB, BS_M,
            fold_bias, matrix_rows):
    global launches, matrix_launches
    _check(q_onehot, tiles, bias_tiles, L=L, K=K, P=P, SUB=SUB, fold_bias=fold_bias,
           matrix_rows=matrix_rows)
    dev = q_onehot.device
    for name, x, dtype in (("thresh", thresh, torch.float32),
                           ("q_onehot", q_onehot, torch.bfloat16),
                           ("tiles", tiles, torch.int32),
                           ("bias_tiles", bias_tiles, torch.float32)):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor on {dev}, got "
                f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )
    bias_rows = bias_tiles.shape[1]
    K_eff = k_eff(L, bias_rows, fold_bias)
    if bias_rows > 2 or K_eff > _MAX_K:
        raise ValueError(
            f"the CUDA kernel takes at most 2 bias rows and 4L + folded rows <= {_MAX_K}; "
            f"got L={L}, {bias_rows} bias rows, fold_bias={fold_bias}"
        )
    n_sblocks = q_onehot.shape[0] // BS_M
    n_sb_pad8 = _cdiv(n_sblocks, 8) * 8
    n_tiles = tiles.shape[0]
    out = torch.zeros((n_tiles, n_sb_pad8, SUB), dtype=torch.float32, device=dev)
    if n_tiles == 0 or n_sblocks == 0:
        return out
    qc = q_chunks(q_onehot, n_sblocks, BS_M, K_eff)
    tile_stride = tiles.shape[1] * tiles.shape[2]
    code_stride = P if matrix_rows else 1
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = nvcc.launcher("scan_hits", "scan_block_hits_launch",
                           [vp] * 5 + [i32] * 8 + [i64, i64, i32, i32, vp])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            thresh.data_ptr(), qc.data_ptr(), tiles.data_ptr(),
            bias_tiles.data_ptr(), out.data_ptr(), n_tiles, n_sblocks,
            n_sb_pad8, K_eff // 32, L, P, SUB, BS_M, tile_stride, code_stride,
            bias_rows, int(bool(fold_bias)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"scan_hits kernel launch failed with CUDA error {rc}")
    launches += 1
    matrix_launches += bool(matrix_rows)
    return out
