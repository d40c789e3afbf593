"""The phase-1 hit kernel's TPU ablations on the tensor cores: the ports of
``experiments/phase1_ablate.py::make_kern`` (variants A-D, :func:`ablate`)
and ``experiments/phase1_bench.py::make_variant`` (variants a-d,
:func:`bench`).

Every variant scores Q (S, K) bf16 one-hot spacer rows with a constant 1 in
column 4L against G (K, P) per genome tile: G[4j + b, p] = (code[p + j] ==
b), G[4L + i, p] = bf16(bias[i, p]) for the 2 bias rows, takes the max over
each spacer block's BS_M rows, and then:

==========  =================  ============================================
variant     G                  output, as the TPU kernel stored it
==========  =================  ============================================
ablate A    built per tile     hit-column counts per subtile, per block
ablate B    streamed (g_all)   the same
ablate C    built              the same, batched over 8 blocks
ablate D    streamed           the same, batched over 8 blocks
bench a     built              column maxima, lanes 0..SUB-1
bench b     built              hit bits (max >= thresh), lanes 0..SUB-1
bench c     built              counts, batched over 8 blocks
bench d     built              counts, per block
==========  =================  ============================================

Counts are (n_tiles, n_sb_pad8, SUB) float32 with zero pad rows, exactly
``scan_block_hits(fold_bias=True)`` with 2 bias rows, except that the
batched variants write a group of 8 blocks only at its eighth block: when
n_sblocks is not a multiple of 8 the last group's rows stay ZERO, a quirk
of the TPU kernels that both versions here keep. For bench a and b the
kernel writes every column ((n_tiles, n_sblocks, P), :func:`bench_full`)
and :func:`bench` takes the TPU's lanes.

A CUDA tensor launches ``csrc/phase1_mma.cu`` (bf16 ``wgmma`` on the main
loop of ``csrc/wgmma_tile.cuh``, which the other kernels share; built by
``nvcc.py``); a CPU tensor takes the plain version (:func:`ablate_reference`,
:func:`bench_full_reference`), built from
``scan_hits.scan_block_hits_reference`` and ``colmax_mma.colmax_reference``.
Nothing falls back. The kernel reads Q as 64-row chunks of wgmma core
matrices, which the wrapper lays out inside every call
(:func:`scan_hits.chunk_layout`), and builds G in shared memory in the layout
that :func:`g_pieces` states (or transposes ``g_all`` into it). The built
variants' G is zero past row 4L + 1, so their kernel issues only the depth
:func:`k_eff` and reads only Q's first k_eff(L) columns; the streamed ones
take any g_all and issue K = 128.

The two agree bit for bit for a finite Q whenever every partial sum of a
score is an exact f32, whatever the order of the sums: the one-hot scores
are small integers, and the bias rows hold bf16(bias), which holds 0 and
-16384 exactly and rounds any other value the same way on both sides; a
finite Q value past k_eff(L) meets a zero G row and adds 0.
"""

from __future__ import annotations

import ctypes

import torch

from . import colmax_mma, nvcc, scan_hits
from .scan_hits import chunk_layout

ABLATE = {"A": ("built", "count"), "B": ("streamed", "count"),
          "C": ("built", "count8"), "D": ("streamed", "count8")}
BENCH = {"a": "colmax", "b": "hit", "c": "count8", "d": "count"}
EPILOGUE = {"count": 0, "count8": 1, "colmax": 2, "hit": 3}

BN = 512  # columns of one thread block of the kernel

# kernel launches since the counters were last reset, per TPU kernel ported
launches = {"phase1_ablate": 0, "phase1_epilogue": 0}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k_eff(L: int) -> int:
    """The depth the built variants' kernel issues: G's 4L + 2 nonzero rows
    rounded up to 32 (two bf16 k-steps of 16, so the kernel has four depths,
    32 to 128; 96 at L = 20, the int8 ``scan_hits.k_eff`` there too)."""
    return _cdiv(4 * L + 2, 32) * 32


def build_g_all(tiles, bias, *, L: int, K: int, P: int):
    """The prebuilt G of the streamed variants (``phase1_ablate.py``'s
    ``build_g_all``, XLA there): (n_tiles, K, P) bfloat16 one-hot rows 4j + b
    of each tile's sliding code windows, the 2 bias rows at 4L, zero rows
    after. 320 tiles of 16,384 columns take 1.34 GB."""
    n_tiles, _, W = tiles.shape
    if W < P + L - 1 or bias.shape != (n_tiles, 2, P) or 4 * L + 2 > K:
        raise ValueError(f"tiles {tuple(tiles.shape)} and bias {tuple(bias.shape)} do not "
                         f"give a G of K={K}, P={P}, L={L}")
    windows = tiles[:, 0, :].unfold(-1, P, 1)[:, :L, :]  # (n_tiles, L, P)
    base = torch.arange(4, device=tiles.device, dtype=tiles.dtype)
    g = torch.zeros((n_tiles, K, P), dtype=torch.bfloat16, device=tiles.device)
    g[:, : 4 * L] = (windows[:, :, None, :] == base[:, None]).reshape(n_tiles, 4 * L, P)
    g[:, 4 * L : 4 * L + 2] = bias.to(torch.bfloat16)
    return g


def g_pieces(codes, bias, *, L: int, P: int, p0: int):
    """One thread block's G as the built variants write it to shared
    memory: columns p0 .. p0 + 511 of one tile, from its codes (W,) int32
    and bias (2, P) f32, as (k_eff(L) / 8, 512, 8) bfloat16 K-major pieces,
    [c, n, e] = G[8c + e, p0 + n]. Piece c holds bases j = 2c and 2c + 1,
    four rows each: 1.0 in row 4j + b where code[p + j] == b (a code at or
    past W reads as N and sets no row), bf16(bias[i, p]) in row 4L + i,
    zeros elsewhere and in every column >= P."""
    K, W = k_eff(L), codes.shape[-1]
    dev = codes.device
    p = p0 + torch.arange(BN, device=dev)
    j = torch.arange(K // 4, device=dev)[:, None]  # bases, (K / 4, 1)
    idx = p + j
    x = torch.where(idx < W, codes[idx.clamp(max=W - 1)], 4)
    one = (x[..., None] == torch.arange(4, device=dev)) & (j < L)[..., None]
    halves = torch.where(one, 0x3F80, 0).to(torch.int16)  # (K / 4, BN, 4) bf16 bits
    halves[L, :, :2] = bias[:, p.clamp(max=P - 1)].to(torch.bfloat16).view(torch.int16).T
    halves[:, p >= P] = 0
    return (halves.reshape(K // 8, 2, BN, 4).permute(0, 2, 1, 3).reshape(K // 8, BN, 8)
            .contiguous().view(torch.bfloat16))


def _counts(hit, SUB: int, batched: bool):
    """(n_tiles, n_sblocks, P) hit bits → the TPU's (n_tiles, n_sb_pad8, SUB)
    f32 counts; batched zeroes a last group of fewer than 8 blocks."""
    n_tiles, n_sblocks, P = hit.shape
    out = torch.zeros((n_tiles, _cdiv(n_sblocks, 8) * 8, SUB), dtype=torch.float32,
                      device=hit.device)
    out[:, :n_sblocks] = hit.reshape(n_tiles, n_sblocks, SUB, P // SUB).sum(dim=3)
    if batched:
        out[:, n_sblocks // 8 * 8 :] = 0
    return out


def _check(thresh, q, tiles, bias, g_all, *, source, L, K, P, SUB, BS_M):
    if q.dim() != 2 or q.shape[1] != K:
        raise ValueError(f"q {tuple(q.shape)} needs K={K} columns")
    if 4 * L + 2 > K or P % SUB or BS_M <= 0:
        raise ValueError(f"need 4L + 2 <= K, SUB | P and BS_M > 0; got L={L}, K={K}, P={P}, "
                         f"SUB={SUB}, BS_M={BS_M}")
    if thresh.numel() != 1:
        raise ValueError(f"thresh must hold one value, got {tuple(thresh.shape)}")
    if source == "streamed":
        if g_all is None or g_all.dim() != 3 or tuple(g_all.shape[1:]) != (K, P):
            raise ValueError(f"the streamed variants need g_all (n_tiles, {K}, {P})")
    elif (tiles.dim() != 3 or tiles.shape[1] != 1 or tiles.shape[2] < P + L - 1
          or tuple(bias.shape) != (tiles.shape[0], 2, P)):
        raise ValueError(f"tiles {tuple(tiles.shape)} and bias {tuple(bias.shape)} need "
                         f"(n, 1, >= P + L - 1) and (n, 2, P)")


def _counts_reference(thresh, q, tiles, bias, *, L, K, P, SUB, BS_M, batched):
    out = scan_hits.scan_block_hits_reference(thresh, q, tiles, bias, L=L, K=K, P=P, SUB=SUB,
                                              BS_M=BS_M, fold_bias=True)
    if batched:
        out[:, q.shape[0] // BS_M // 8 * 8 :] = 0
    return out


def ablate_reference(variant, thresh, q, tiles, bias, g_all, *, L, K, P, SUB, BS_M):
    """Plain torch version of ablation ``variant`` (A-D): the TPU kernel's
    (n_tiles, n_sb_pad8, SUB) counts. The built variants are
    ``scan_block_hits_reference``; the streamed ones score g_all itself."""
    source, epi = ABLATE[variant]
    _check(thresh, q, tiles, bias, g_all, source=source, L=L, K=K, P=P, SUB=SUB, BS_M=BS_M)
    if source == "built":
        return _counts_reference(thresh, q, tiles, bias, L=L, K=K, P=P, SUB=SUB, BS_M=BS_M,
                                 batched=epi == "count8")
    cmax = colmax_mma.colmax_reference(q, g_all, torch.float32, BS_M=BS_M)
    return _counts(cmax >= thresh.reshape(-1)[0], SUB, batched=epi == "count8")


def bench_full_reference(variant, thresh, q, tiles, bias, *, L, K, P, SUB, BS_M):
    """Plain torch version of epilogue ``variant`` (a-d) in the kernel's
    full form: counts for c and d, (n_tiles, n_sblocks, P) f32 column maxima
    for a, uint8 hit bits for b."""
    epi = BENCH[variant]
    _check(thresh, q, tiles, bias, None, source="built", L=L, K=K, P=P, SUB=SUB, BS_M=BS_M)
    if epi in ("count", "count8"):
        return _counts_reference(thresh, q, tiles, bias, L=L, K=K, P=P, SUB=SUB, BS_M=BS_M,
                                 batched=epi == "count8")
    g = build_g_all(tiles, bias, L=L, K=K, P=P)
    cmax = colmax_mma.colmax_reference(q, g, torch.float32, BS_M=BS_M)
    return cmax if epi == "colmax" else (cmax >= thresh.reshape(-1)[0]).to(torch.uint8)


def ablate(variant, thresh, q, tiles, bias, g_all, *, L, K, P, SUB, BS_M):
    """Ablation ``variant`` (A-D) of ``phase1_ablate.py``: (n_tiles,
    n_sb_pad8, SUB) f32 hit-column counts. The streamed variants read only
    g_all, the built ones only tiles and bias."""
    if q.device.type == "cpu":
        return ablate_reference(variant, thresh, q, tiles, bias, g_all, L=L, K=K, P=P,
                                SUB=SUB, BS_M=BS_M)
    source, epi = ABLATE[variant]
    return _launch("phase1_ablate", source, epi, thresh, q, tiles, bias, g_all, L=L, K=K, P=P,
                   SUB=SUB, BS_M=BS_M)


def bench_full(variant, thresh, q, tiles, bias, *, L, K, P, SUB, BS_M):
    """Epilogue ``variant`` (a-d) of ``phase1_bench.py`` in the kernel's
    full form (see :func:`bench_full_reference`)."""
    if q.device.type == "cpu":
        return bench_full_reference(variant, thresh, q, tiles, bias, L=L, K=K, P=P, SUB=SUB,
                                    BS_M=BS_M)
    return _launch("phase1_epilogue", "built", BENCH[variant], thresh, q, tiles, bias, None,
                   L=L, K=K, P=P, SUB=SUB, BS_M=BS_M)


def bench(variant, thresh, q, tiles, bias, *, L, K, P, SUB, BS_M):
    """Epilogue ``variant`` (a-d) as the TPU kernel stored it: (n_tiles,
    n_sb_pad8, SUB) f32 (lanes 0..SUB-1 of the column maxima or hit bits for
    a and b, counts for c and d)."""
    full = bench_full(variant, thresh, q, tiles, bias, L=L, K=K, P=P, SUB=SUB, BS_M=BS_M)
    if BENCH[variant] in ("colmax", "hit"):
        return colmax_mma.tpu_lanes(full, SUB, torch.float32)
    return full


def _launch(counter, source, epi, thresh, q, tiles, bias, g_all, *, L, K, P, SUB, BS_M):
    _check(thresh, q, tiles, bias, g_all, source=source, L=L, K=K, P=P, SUB=SUB, BS_M=BS_M)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the phase-1 variants run on cpu or cuda, not {dev}")
    named = [("thresh", thresh, torch.float32), ("q", q, torch.bfloat16)]
    if source == "streamed":
        named.append(("g_all", g_all, torch.bfloat16))
        n_tiles, tile_w = g_all.shape[0], 0
        g_ptrs = (None, None, g_all.data_ptr())
    else:
        named += [("tiles", tiles, torch.int32), ("bias", bias, torch.float32)]
        n_tiles, tile_w = tiles.shape[0], tiles.shape[2]
        g_ptrs = (tiles.data_ptr(), bias.data_ptr(), None)
    for name, x, dtype in named:
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}, got "
                             f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    n_blocks = n_tiles * _cdiv(P, BN)
    if K != colmax_mma.K or P % 16 or n_blocks >= 2**31:
        raise ValueError(f"the CUDA kernel takes K = {colmax_mma.K}, P % 16 == 0 and fewer "
                         f"than 2^31 thread blocks of {BN} columns; got K={K}, P={P}, "
                         f"{n_tiles} tiles")
    if source == "streamed" and g_all.data_ptr() % 16:
        raise ValueError("g_all must be 16-byte aligned")
    n_sblocks = q.shape[0] // BS_M
    n_sb_pad8 = _cdiv(n_sblocks, 8) * 8
    if epi in ("count", "count8"):
        out = torch.zeros((n_tiles, n_sb_pad8, SUB), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((n_tiles, n_sblocks, P), device=dev,
                          dtype=torch.float32 if epi == "colmax" else torch.uint8)
    if n_tiles == 0 or n_sblocks == 0:
        return out
    depth = K if source == "streamed" else k_eff(L)
    qc = chunk_layout(q[: n_sblocks * BS_M, :depth], BS_M)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    launch = nvcc.launcher("phase1_mma", "phase1_mma_launch",
                           [i32] * 3 + [vp] * 6 + [i32] * 8 + [vp])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(int(source == "streamed"), EPILOGUE[epi], depth // 16, thresh.data_ptr(),
                    qc.data_ptr(), *g_ptrs, out.data_ptr(), n_tiles, n_sblocks, n_sb_pad8,
                    BS_M, L, P, SUB, tile_w, stream)
    if rc != 0:
        raise RuntimeError(f"phase1_mma kernel launch failed with CUDA error {rc}")
    launches[counter] += 1
    return out
