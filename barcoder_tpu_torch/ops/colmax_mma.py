"""Column max of a 0/1 matrix product on the tensor cores: the port of
``experiments/int8_bench.py::kern``, the TPU microbenchmark that compared
int8 (int8 x int8 -> int32) with bf16 (bf16 x bf16 -> f32) on the MXU.

For Q (S, K) and G (n_tiles, K, P) of one type, both compute

    full[t, s, p] = max over the BS_M rows r of block s of (Q G[t])[s BS_M + r, p]

for every column. The TPU kernel stored only lanes 0..127 of each (t, s)
row into an output whose block axis is padded to a multiple of 8 by zero
rows; :func:`tpu_lanes` takes that slice from the full array, so the kernel
here does the whole product and a test can hold every column.

:func:`colmax` dispatches by device: a CUDA tensor launches the hand-written
kernel in ``csrc/colmax_mma.cu`` (``wgmma`` m64n256k32 s8 for int8,
m64n256k16 bf16 for bf16, on the main loop it shares with ``scan_hits``
through ``csrc/wgmma_tile.cuh``; built by ``nvcc.py``), a CPU tensor takes
:func:`colmax_reference`. Nothing falls back. The kernel reads Q as 64-row
chunks of wgmma core matrices, which the wrapper lays out inside every call
(:func:`scan_hits.chunk_layout`), and transposes G to K-major itself while
staging it.
"""

from __future__ import annotations

import ctypes

import torch

from . import nvcc
from .scan_hits import chunk_layout

K = 128  # the kernel's contraction depth
OUT_DTYPE = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
_LAUNCHER = {torch.int8: "colmax_int8_launch", torch.bfloat16: "colmax_bf16_launch"}

# kernel launches since the counter was last reset
launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check(q, g, out_dtype, BS_M):
    if q.dtype not in OUT_DTYPE or g.dtype != q.dtype:
        raise ValueError(f"q and g must both be int8 or both bfloat16, got {q.dtype}, {g.dtype}")
    if out_dtype != OUT_DTYPE[q.dtype]:
        raise ValueError(f"{q.dtype} accumulates into {OUT_DTYPE[q.dtype]}, not {out_dtype}")
    if q.dim() != 2 or g.dim() != 3 or q.shape[1] != g.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and g {tuple(g.shape)} need (S, K) and (n, K, P)")
    if BS_M <= 0:
        raise ValueError(f"BS_M must be positive, got {BS_M}")


def colmax_reference(q, g, out_dtype, *, BS_M: int):
    """Plain torch version: (n_tiles, S // BS_M, P) of ``out_dtype``, one
    tile at a time. The products are summed in float32, which is exact here:
    int8 sums stay below 2^21 in magnitude, and bf16 inputs are the 0/1
    matrices of the benchmark (also exact under TF32, whose mantissa holds
    every int8 and bf16 value)."""
    _check(q, g, out_dtype, BS_M)
    n_sblocks = q.shape[0] // BS_M
    n_tiles, _, P = g.shape
    out = torch.empty((n_tiles, n_sblocks, P), dtype=out_dtype, device=q.device)
    qf = q[: n_sblocks * BS_M].to(torch.float32)
    for t in range(n_tiles):
        scores = qf @ g[t].to(torch.float32)
        out[t] = scores.reshape(n_sblocks, BS_M, P).amax(dim=1).to(out_dtype)
    return out


def colmax(q, g, out_dtype, *, BS_M: int):
    """The full column maxima (n_tiles, S // BS_M, P): int8 inputs give
    int32, bf16 inputs float32."""
    if q.device.type == "cpu":
        return colmax_reference(q, g, out_dtype, BS_M=BS_M)
    if q.device.type != "cuda":
        raise ValueError(f"colmax runs on cpu or cuda, not {q.device}")
    return _launch(q, g, out_dtype, BS_M)


def tpu_lanes(full, lanes: int, dtype=None):
    """The TPU kernels' stored slice of a full (n_tiles, n_sblocks, P)
    result: lanes 0..lanes-1 of every (t, s) row, the block axis padded to a
    multiple of 8 with zero rows, in ``dtype`` (default: full's)."""
    n_tiles, n_sblocks, P = full.shape
    if P < lanes:
        raise ValueError(f"{P} columns hold no {lanes} lanes")
    out = torch.zeros((n_tiles, _cdiv(n_sblocks, 8) * 8, lanes), dtype=dtype or full.dtype,
                      device=full.device)
    out[:, :n_sblocks] = full[:, :, :lanes]
    return out


def _launch(q, g, out_dtype, BS_M):
    global launches
    _check(q, g, out_dtype, BS_M)
    dev = q.device
    for name, x in (("q", q), ("g", g)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}, got {x.device} "
                             f"(contiguous={x.is_contiguous()})")
    n_tiles, k, P = g.shape
    if k != K or P % 16 or BS_M % 16 or g.data_ptr() % 16:
        raise ValueError(f"the CUDA kernel takes K = {K}, P % 16 == 0, BS_M % 16 == 0 and a "
                         f"16-byte aligned g; got K={k}, P={P}, BS_M={BS_M}")
    n_sblocks = q.shape[0] // BS_M
    out = torch.empty((n_tiles, n_sblocks, P), dtype=out_dtype, device=dev)
    if n_tiles == 0 or n_sblocks == 0:
        return out
    qc = chunk_layout(q[: n_sblocks * BS_M], BS_M)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    launch = nvcc.launcher("colmax_mma", _LAUNCHER[q.dtype], [vp] * 3 + [i32] * 4 + [vp])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(qc.data_ptr(), g.data_ptr(), out.data_ptr(), n_tiles, n_sblocks, BS_M, P,
                    stream)
    if rc != 0:
        raise RuntimeError(f"colmax_mma kernel launch failed with CUDA error {rc}")
    launches += 1
    return out
