"""Smoke run of the PyTorch port on one CUDA card: the quickest proof that
``barcoder_tpu_torch`` still builds, launches and answers on the GPU.

    python3 chip_smoke.py                  # from the repository root, one card
    python3 chip_smoke.py --profile DIR    # also profile steady requests

Phases (any failure is a non-zero exit; nothing is caught):

1. build every CUDA kernel from ``barcoder_tpu_torch/csrc/`` with nvcc for
   sm_90a, one nvcc process per source, started together;
2. hold the phase-1 hit kernel (``scan_hits``, int8 ``wgmma``) against its
   plain torch version on the card, bit-equal, at the main path's shapes
   (P = 16384, SUB = 32, BS_M = 512, K = 128, 8 tiles; L = 20 with 2 folded
   bias rows, L = 32 additive, L = 20 with 1 folded row), and time both;
   then at the 20-nt request's full shape (288 tiles, 20,480 rows, L = 20,
   2 folded rows): bit-equal to the plain version, timed beside it, beside
   its bound and beside ``torch._int_mm`` + ``amax`` of the same int8
   product (a yardstick the port never calls; its hit counts must agree),
   with the kernel's registers (ptxas; it may not spill);
2b. the same for the block-max kernel (``scan_max``, int8 ``wgmma``) at the
   scaling harness's shapes (P = 16384, K = 128, 8 tiles, 80 spacer blocks
   with 240 zero padding rows, so the last real block holds both row groups
   inside one 64-row chunk, the last tile fully masked; L = 20 additive
   SUB = 1, L = 20 folded SUB = 32 and, on the same inputs, SUB = 1, L = 32
   additive SUB = 1), at a ragged P = 12,000 with bias values that bf16
   rounds (folded SUB = 32, additive SUB = 1), and at the harness's full
   shape (281 tiles x 10,240 rows) beside its bound; its registers (ptxas;
   it may not spill);
3. drive the targets workload through ``run_targets(backend="cuda")`` on a
   4.6 Mb circular synthetic genome (~4,200 genes, one across the origin):
   a 9,984-spacer 20-nt library plus planted guides (NGG, v = 3), the same
   again (steady state), and a 32-nt library (NGNC, v = 1). Every planted
   guide must come back at 0 mismatches and the kernel must have launched.
   Request 1 (the first scan of the genome) takes the dense engine and
   launches the kernel once (both strands in one launch); request 2, the
   second scan of the same (genome, NGG, 20) key, is promoted to the
   site-compacted engine, as in the JAX package, and launches it once in
   its ``matrix_rows`` mode; request 3 is dense, two launches (one per
   strand); the engine each took is read from the site-table cache. Then
   request 1's library on the site and on the dense engine (``site_mode``
   "always" and "never"): both Hits equal the plain ``torch_scan`` on the
   card. The CLI answers once in a subprocess.
3b. the site phase: the kernel in ``matrix_rows`` mode at the shapes the
   site engine gives it, from the real site tables (36 tiles of 16,384 site
   columns): the 20-nt request (10,240 rows, K_eff 96) and the 32-nt
   library on its NGNC sites (K_eff 128), each bit-equal to its plain
   version, timed beside it, beside its bound and beside ``torch._int_mm``
   + ``amax`` of the same product.
5. the sharded path: request 1 through ``run_targets(backend="sharded")``
   (the site engine; the frame must equal the cuda backend's), then
   ``sharded_scan`` over request 1's library and genome on a 1-shard mesh
   and on a 4-shard mesh of the same card (and one shard per card on a
   machine with several): the site engine and, with ``site_mode="never"``,
   the dense one, Hits equal to the cuda backend's, every planted guide
   found; ``sharded_scan_many`` over 8 libraries of ~1,250 spacers drawn
   from request 1's, each equal to its solo scan; and
   ``sharded_scan_block_max`` on both meshes (block_max and totals equal to
   its plain version's on the card, and a second call on the same arrays
   takes its tiles and bias from the cache and answers the same); both
   kernels, and ``scan_hits`` in
   both modes, must have launched in that run. Steady walls of the cuda
   backend and the sharded meshes; then the scaling harness
   (``python -m barcoder_tpu_torch.parallel.scaling 4600000 10240 --engine
   all --single-chip``: the flagship on the site engine, the dense engine,
   the block max and the one-card engine) in a subprocess, its JSON printed
   on one line: the site, dense and one-card hit counts must agree, and
   every row it timed must have launched its kernel (the harness counts
   launches per row). Last, the harness's block-max workload in this
   process, with the launch count at 0 before it: block_max and totals
   equal to the plain version's, and every spacer scoring L at its own
   genome window.
5b. the design workload: ``python -m barcoder_tpu_torch design genome.gb
   NGG 20`` on the 4.6 Mb genome in a subprocess (its candidate count, from
   ``--sgrna-out``, must equal the enumeration's), then ``run_design`` in
   this process with the launch counts at 0 (the same TSV; the kernel must
   have launched in ``matrix_rows`` mode; every kept guide must be its own
   site's window at 0 mismatches), then the kernel at the design scan's
   full shape (36 tiles x 589,824 rows; its plain version and the
   ``torch._int_mm`` yardstick over 32,768-row chunks) and, on a 200 kb
   slice, the ``cuda`` backend's design frame (dense, then site-promoted)
   equal to the ``torch`` backend's.
6. the three experiment kernels (the ports of ``experiments/int8_bench.py``,
   ``phase1_ablate.py`` and ``phase1_bench.py``, all ``wgmma``) at their
   scripts' full shapes: the column max in int8 and bf16 (16 tiles x 40
   blocks x 512 rows x 16,384 columns, and a ragged 3 x 5 x 80 x 400 case),
   every phase-1 ablation (A-D) and epilogue (a-d) variant (bf16; 320 tiles
   x 40 blocks x 512 rows x 16,384 columns), each held bit-equal against
   its plain version and timed beside it, beside its bound (its share of
   it), with its registers (ptxas; no kernel may spill) and the
   ``scan_hits`` kernel's time on the same inputs; the phase-1 column max
   (variant a) also beside ``torch.mm`` into f32 + ``amax`` per tile on
   ``build_g_all``'s G (the bf16 column max's yardstick too; the count
   variants have none); every phase-1 variant again, bit-equal, at
   P = 12,000 with 12 blocks of 80 and of 24 rows, L = 31 and 20, and bias
   values that bf16 rounds and -0.0; then each entry point
   (``python -m barcoder_tpu_torch.experiments.<name>``) once in this
   process, with the launch counts at 0 before each: each must launch its
   kernel.

The kernels line gives each kernel's launches per path (``launches_by_path``,
each path's count taken from 0 just before it) and their sum, its time, its
plain version's time, its bound (the larger of its operations over the
card's tensor rate for their type and its bytes over the memory rate) and,
where one PyTorch call computes the same function, that call's time. The
operations are those the function needs: for ``scan_hits`` 2 per pair for
each of the 4L one-hot rows and each folded bias row; its
``issued_bound_ms`` is the same bound at the depth it issues (K_eff, a
multiple of wgmma's k-step of 32); for the phase-1 variants 2 bf16
operations per pair for each of G's 4L + 2 rows when G is built (issued:
``phase1_variants.k_eff``) and each of its K = 128 rows when it is
streamed. The
tensor rates are the card's own (``peaks`` in the line): its SM count x
the type's dense operations per SM per clock x its highest SM clock.

With ``--profile DIR``, a fourth phase times three steady-state runs of
the 20-nt request (the site engine, its table cached), the 32-nt request
and the 4.6 Mb design run, then runs each once under ``torch.profiler``:
it prints the phase timings, the device time summed over the CUDA-side
events (kernels and copies), the device busy share (that sum over the
profiled wall) and the largest device events, and writes each trace to
``DIR/trace_{L20,L32,design}.json``. It repeats the measurements behind
two settings: the dense/site crossover (walls of both engines, the site
table cached, loaded from disk and built, for request 1's library and
design-scale libraries of 65,536 to ~575k spacers), which sets
``_SITE_MODE_MIN_SPACERS``, and the steady 20-nt request on the cuda and
sharded backends alternated, which decides what ``auto`` takes. It then
does the same
for the scaling harness's workload through ``sharded_scan`` and
``sharded_scan_block_max``, on one card (and on 4 shards of it) and, on a
machine with several, on one shard per card, splitting each profiled call into each card's busy
time, the device idle share and the host's torch ops
(``DIR/trace_{flagship,block_max}_{1,N}.json``).

With ``--kernel-times``, it only times the kernels that share
``csrc/wgmma_tile.cuh`` (``kernel_times``, on the inputs of phases 2, 3b,
5b and 6) and prints one JSON line; a copy
of this script run from the root of another tree of the package times that
tree, which is how a change to the shared loop is held against its parent
(parent, change, change, parent, in one call).

Site tables are written to a fresh temporary ``BARCODER_TPU_ARTIFACTS``
directory, so a table left on the machine by an earlier run cannot change
which engine request 1 takes.

Prints the card's name and power limit, one JSON line of kernel results
(five kernels), and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from barcoder_tpu_torch.experiments import card_line, cuda_ms

N_GENOME = 4_600_000
N_GENES = 4200
N_SPACERS = 9_984  # the 20-nt library of request 1
N_SPACERS_32 = 1_024  # the 32-nt library of request 3
N_PLANTED = 48  # planted guides per library
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


# --- bounds ------------------------------------------------------------------

# Dense tensor-core operations per SM per clock on Hopper (sm_90). NVIDIA's
# data-sheet peaks for the H100 SXM (1,979 TOP/s int8, 989 TFLOP/s bf16) are
# these at 132 SMs and 1,830 MHz; the card runs its SMs up to 1,980 MHz, so
# the bounds take the card's own SM count and highest SM clock instead.
OPS_PER_SM_CLOCK = {"int8": 8192, "bf16": 4096}
PEAK_BYTES_PER_S = 3.35e12  # HBM3 of the H100 SXM (data sheet)
PEAKS: dict = {}  # filled by card_peaks() before any bound is taken


def card_peaks() -> dict:
    """The card's tensor rates: SMs x operations per SM per clock x the
    highest SM clock that nvidia-smi reports (``clocks.max.sm``)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(sm_clock_max_mhz=mhz, sms=sms, bytes_per_s=PEAK_BYTES_PER_S,
                **{f"{k}_ops_per_s": sms * n * mhz * 1e6 for k, n in OPS_PER_SM_CLOCK.items()})


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, kind: str, n_bytes: int) -> dict:
    """The least time the card could take: the larger of the operations
    over the card's tensor rate for their type (``PEAKS``) and the bytes
    (each input read once, each output written once) over the memory rate."""
    ops_ms = ops / PEAKS[f"{kind}_ops_per_s"] * 1e3
    bytes_ms = n_bytes / PEAKS["bytes_per_s"] * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ops=ops, bytes=n_bytes)


def hits_bound(L: int, bias_rows: int, fold: bool, pairs: int, n_bytes: int) -> dict:
    """The scan_hits kernel's bound: 2 operations per pair for each of the
    4L one-hot rows and each folded bias row the function needs (an added
    bias is one addition per column maximum, left out).
    ``issued_bound_ms`` is the same bound at the depth the kernel issues,
    K_eff, those rows rounded up to wgmma's k-step of 32."""
    from barcoder_tpu_torch.ops import scan_hits

    b = bound(2 * (4 * L + (bias_rows if fold else 0)) * pairs, "int8", n_bytes)
    b["issued_bound_ms"] = bound(2 * scan_hits.k_eff(L, bias_rows, fold) * pairs, "int8",
                                 n_bytes)["bound_ms"]
    return b


def phase1_bound(source: str, L: int, K: int, pairs: int, n_bytes: int) -> dict:
    """The phase-1 variants' bound: 2 bf16 operations per pair for each row
    of G the function needs, the 4L one-hot rows and the 2 bias rows when G
    is built, all K rows of a streamed g_all (any row may be nonzero).
    ``issued_bound_ms`` is the same at the depth the kernel issues
    (``phase1_variants.k_eff`` built, K streamed)."""
    from barcoder_tpu_torch.ops import phase1_variants

    need, issued = (K, K) if source == "streamed" else (4 * L + 2, phase1_variants.k_eff(L))
    b = bound(2 * need * pairs, "bf16", n_bytes)
    b["issued_bound_ms"] = bound(2 * issued * pairs, "bf16", n_bytes)["bound_ms"]
    return b


# --- phase 2 -----------------------------------------------------------------

def enqueue_ms(fn, reps: int = 5) -> float:
    """Mean host milliseconds a call of ``fn`` takes to enqueue its work
    (after a warm-up, no synchronization between calls). Where it is not
    below ``cuda_ms``'s time, that time is the host's, not the card's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def kernel_case(rng, *, L, fold_rows, S_pad, n_tiles=8, P=16384, SUB=32, BS_M=512, K=128):
    """Inputs at the main path's shapes: genome codes with N (4) and the
    out-of-bounds sentinel (5); spacers cut from the codes with 0-4
    substitutions; the engine's bias-column layout; a random 0/-16384 bias."""
    from barcoder_tpu_torch.ops.cuda_scan import onehot_rows

    halo = K // 4
    codes = rng.integers(0, 4, (n_tiles, 1, P + halo)).astype(np.int32)
    codes[rng.random(codes.shape) < 0.02] = 4
    codes[rng.random(codes.shape) < 0.005] = 5
    t = rng.integers(n_tiles, size=S_pad)
    p = rng.integers(P, size=S_pad)
    qc = np.minimum(codes[t, 0][np.arange(S_pad)[:, None], p[:, None] + np.arange(L)], 4)
    sub = rng.random(qc.shape) < 0.08
    qc[sub] = rng.integers(0, 5, int(sub.sum()))
    q = onehot_rows(qc.astype(np.int8), K)
    if fold_rows:
        q[: S_pad // 2, 4 * L] = 1
        q[S_pad // 2 :, 4 * L + fold_rows - 1] = 1
    R = max(fold_rows, 1)
    bias = np.where(rng.random((n_tiles, R, P)) < 0.1, 0.0, -16384.0).astype(np.float32)
    dev = torch.device("cuda")
    args = (
        torch.tensor([L - 3.0], device=dev),
        torch.from_numpy(q).to(dev, torch.bfloat16),
        torch.from_numpy(codes).to(dev),
        torch.from_numpy(bias).to(dev),
    )
    kw = dict(L=L, K=K, P=P, SUB=SUB, BS_M=BS_M, fold_bias=bool(fold_rows))
    return args, kw


def int_mm_library_ms(args, kw, got, *, rows: int = 1 << 15, reps: int = 2) -> float:
    """The yardstick: the kernel's int8 product and column max through
    ``torch._int_mm`` + ``amax``, one call per tile and chunk of at most
    ``rows`` rows (Q cut to K_eff; G with the folded bias as -128, as
    ``int8_g`` builds it; an additive bias added after the max). Its hit
    counts must equal the kernel's ``got``; returns its time."""
    from barcoder_tpu_torch.ops import scan_hits

    th, q, tiles, bias = args
    L, P, BS_M, SUB, fold = kw["L"], kw["P"], kw["BS_M"], kw["SUB"], kw["fold_bias"]
    k_eff = scan_hits.k_eff(L, bias.shape[1], fold)
    n_sb = q.shape[0] // BS_M
    q8 = q[: n_sb * BS_M, :k_eff].to(torch.int8).contiguous()
    windows = tiles[:, :L] if kw.get("matrix_rows") else tiles[:, 0].unfold(-1, P, 1)[:, :L]
    g8 = scan_hits.int8_g(windows, bias, K_eff=k_eff, fold=fold)
    step = max(rows // BS_M, 1) * BS_M

    def library():
        cols = []
        for t in range(g8.shape[0]):
            cm = torch.cat([torch._int_mm(q8[r0 : r0 + step], g8[t]).view(-1, BS_M, P)
                            .amax(dim=1) for r0 in range(0, q8.shape[0], step)])
            cols.append(cm if fold else cm + bias[t, 0])
        return torch.stack(cols)

    counts = (library() >= th[0]).reshape(-1, n_sb, SUB, P // SUB).sum(dim=3)
    if not torch.equal(counts.to(torch.float32), got[:, :n_sb]):
        raise AssertionError("torch._int_mm + amax disagrees with the kernel's counts")
    del counts
    return cuda_ms(library, reps=reps)


def phase2_kernel_vs_plain() -> dict:
    from barcoder_tpu_torch.ops import scan_hits

    rng = np.random.default_rng(SEED)
    cases = [
        ("L20_fold2", dict(L=20, fold_rows=2, S_pad=20480)),
        ("L32_additive", dict(L=32, fold_rows=0, S_pad=2048)),
        ("L20_fold1", dict(L=20, fold_rows=1, S_pad=10240)),
    ]
    results = {}
    for name, spec in cases:
        args, kw = kernel_case(rng, **spec)
        got = scan_hits.scan_block_hits(*args, **kw)
        want = scan_hits.scan_block_hits_reference(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"({int((got != want).sum())} entries)")
        err = float((got - want).abs().max())
        plain_ms = cuda_ms(lambda: scan_hits.scan_block_hits_reference(*args, **kw))
        ms = cuda_ms(lambda: scan_hits.scan_block_hits(*args, **kw))
        host_ms = enqueue_ms(lambda: scan_hits.scan_block_hits(*args, **kw))
        library_ms = int_mm_library_ms(args, kw, got, reps=5)
        pairs = args[1].shape[0] // kw["BS_M"] * kw["BS_M"] * args[2].shape[0] * kw["P"]
        results[name] = dict(
            max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms, library_ms=library_ms,
            hit_columns=float(want.sum()),
            pairs_per_s=pairs / (ms / 1e3), shape=dict(spec, n_tiles=args[2].shape[0]),
            **hits_bound(kw["L"], args[3].shape[1], kw["fold_bias"], pairs,
                         nbytes(*args, got)),
        )
        log(f"phase 2 {name}: bit-equal, max_abs_err {err}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, torch._int_mm + amax {library_ms:.4f} ms, "
            f"{pairs / (ms / 1e3):.4e} pairs/s, host enqueue {host_ms:.4f} ms a call")
    return results


def request_case():
    """The kernel's inputs at the 20-nt request's full dense shape (see
    :func:`phase2_request_shape`)."""
    return kernel_case(np.random.default_rng(SEED + 3), L=20, fold_rows=2, S_pad=20480,
                       n_tiles=288)


def phase2_request_shape() -> dict:
    """The kernel at the 20-nt request's full shape: 288 tiles of 16,384
    columns, 20,480 rows (both strands, 40 blocks of 512), L = 20 with 2
    folded rows, SUB = 32."""
    from barcoder_tpu_torch.ops import nvcc, scan_hits

    report = nvcc.ptxas_report("scan_hits")
    for r in report:
        log(f"phase 2 ptxas scan_hits: {r}")
        if r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"{r['function']} spills registers")
    args, kw = request_case()
    th, q, tiles, bias = args
    got = scan_hits.scan_block_hits(*args, **kw)
    want = scan_hits.scan_block_hits_reference(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"request shape: kernel disagrees with its plain version "
                             f"({int((got != want).sum())} entries)")
    err = float((got - want).abs().max())
    del want
    ms = cuda_ms(lambda: scan_hits.scan_block_hits(*args, **kw))
    plain_ms = cuda_ms(lambda: scan_hits.scan_block_hits_reference(*args, **kw), reps=2)

    L, P, BS_M, SUB = kw["L"], kw["P"], kw["BS_M"], kw["SUB"]
    k_eff = scan_hits.k_eff(L, bias.shape[1], True)
    n_sb = q.shape[0] // BS_M
    library_ms = int_mm_library_ms(args, kw, got, rows=q.shape[0])
    pairs = n_sb * BS_M * tiles.shape[0] * P
    b = hits_bound(L, bias.shape[1], True, pairs, nbytes(*args, got))
    regs = max(r["registers"] for r in report)
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               pairs_per_s=pairs / (ms / 1e3), bound_share=b["bound_ms"] / ms,
               hit_columns=float(got.sum()), registers=regs, k_eff=k_eff,
               shape=dict(n_tiles=tiles.shape[0], rows=q.shape[0], L=L, P=P, SUB=SUB,
                          BS_M=BS_M, fold_rows=2), **b)
    log(f"phase 2 request shape: bit-equal, max_abs_err {err}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch._int_mm + amax {library_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}), share {b['bound_ms'] / ms:.4f}, "
        f"{pairs / (ms / 1e3):.4e} pairs/s, {regs} registers, no spills")
    return out


# --- phase 2b ----------------------------------------------------------------

def max_kernel_case(rng, *, L, fold, SUB, S_pad=10_240, n_pad=240, n_tiles=8, P=16384,
                    K=128, odd_bias=False):
    """Block-max inputs at the harness's shapes: genome codes with N (4) and
    the out-of-bounds sentinel (5); spacers cut from the codes with 0-4
    substitutions, the last ``n_pad`` rows zero padding (no constant bias
    column; one of them -0.0 there), so that with 240 of them the last real
    block holds both row groups inside one 64-row chunk; a random 0/-16384
    bias with the last tile fully masked, where the folded padding rows'
    score (0) beats every real row's. ``odd_bias`` draws a tenth of the
    bias from values that bf16 rounds (the fold keeps the rounding)."""
    from barcoder_tpu_torch.ops.cuda_scan import onehot_rows

    codes = rng.integers(0, 4, (n_tiles, 1, P + K // 4)).astype(np.int32)
    codes[rng.random(codes.shape) < 0.02] = 4
    codes[rng.random(codes.shape) < 0.005] = 5
    t = rng.integers(n_tiles, size=S_pad)
    p = rng.integers(P, size=S_pad)
    qc = np.minimum(codes[t, 0][np.arange(S_pad)[:, None], p[:, None] + np.arange(L)], 4)
    sub = rng.random(qc.shape) < 0.08
    qc[sub] = rng.integers(0, 5, int(sub.sum()))
    q = onehot_rows(qc.astype(np.int8), K)
    if fold:
        q[:, 4 * L] = 1
    q[S_pad - n_pad :] = 0
    if fold and n_pad:
        q[S_pad - 1, 4 * L] = -0.0
    bias = np.where(rng.random((n_tiles, 1, P)) < 0.1, 0.0, -16384.0).astype(np.float32)
    if odd_bias:
        odd = rng.random(bias.shape) < 0.1
        bias[odd] = rng.choice(np.array([0.3, -3.7, 1e-3, 2.0078125, -100.25], np.float32),
                               int(odd.sum()))
    bias[-1] = -16384.0
    dev = torch.device("cuda")
    args = (torch.from_numpy(q).to(dev, torch.bfloat16), torch.from_numpy(codes).to(dev),
            torch.from_numpy(bias).to(dev))
    return args, dict(L=L, K=K, P=P, SUB=SUB, fold_bias=fold)


def phase2b_max_kernel_vs_plain() -> dict:
    """The block-max kernel against its plain version, bit-equal and timed:
    the three cases at the harness's tile shape; the folded inputs again at
    SUB = 1 (32 thread blocks feed one value; its maxima must be the
    SUB = 32 result's maxima over the subtiles); a ragged P (12,000: the
    last 512-column block is 224 wide) with bias values that bf16 rounds,
    folded at SUB = 32 (375-column subtiles: a warp's columns straddle two)
    and additive at SUB = 1; and the harness's full shape (281 tiles x
    10,240 rows), there beside scan_hits on the same inputs at 512- and
    128-row blocks."""
    from barcoder_tpu_torch.ops import nvcc, scan_hits, scan_max

    for r in nvcc.ptxas_report("scan_max"):
        log(f"phase 2b ptxas scan_max: {r}")
        if r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"{r['function']} spills registers")
    rng = np.random.default_rng(SEED + 2)
    cases = [
        ("L20_additive_SUB1", dict(L=20, fold=False, SUB=1)),
        ("L20_fold_SUB32", dict(L=20, fold=True, SUB=32)),
        ("L20_fold_SUB1", dict(L=20, fold=True, SUB=1)),
        ("L32_additive_SUB1", dict(L=32, fold=False, SUB=1)),
        ("L24_fold_SUB32_ragged", dict(L=24, fold=True, SUB=32, P=12_000, n_tiles=3,
                                       S_pad=1280, n_pad=100, odd_bias=True)),
        ("L20_additive_SUB1_ragged", dict(L=20, fold=False, SUB=1, P=12_000, n_tiles=3,
                                          S_pad=1280, n_pad=100, odd_bias=True)),
        ("harness_shape", dict(L=20, fold=False, SUB=1, n_tiles=281, n_pad=0)),
    ]
    results, outs, inputs = {}, {}, {}
    for name, spec in cases:
        if name == "L20_fold_SUB1":  # the same inputs as at SUB = 32
            args, kw = inputs["L20_fold_SUB32"][0], dict(inputs["L20_fold_SUB32"][1], SUB=1)
        else:
            args, kw = max_kernel_case(rng, **spec)
        inputs = {name: (args, kw)}
        got = scan_max.scan_block_max(*args, **kw)
        want = scan_max.scan_block_max_reference(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: block-max kernel disagrees with its plain "
                                 f"version ({int((got != want).sum())} entries)")
        err = float((got - want).abs().max())
        outs[name] = got
        big = name == "harness_shape"
        plain_ms = cuda_ms(lambda: scan_max.scan_block_max_reference(*args, **kw),
                           reps=1 if big else 5)
        ms = cuda_ms(lambda: scan_max.scan_block_max(*args, **kw))
        host_ms = enqueue_ms(lambda: scan_max.scan_block_max(*args, **kw))
        pairs = args[0].shape[0] // 128 * 128 * args[1].shape[0] * kw["P"]
        depth = 4 * kw["L"] + kw["fold_bias"]  # its 0/1 product's depth
        b = bound(2 * depth * pairs, "int8", nbytes(*args, got))
        results[name] = dict(max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                             pairs_per_s=pairs / (ms / 1e3), bound_share=b["bound_ms"] / ms,
                             shape=dict(spec, n_tiles=args[1].shape[0], P=kw["P"],
                                        S_pad=args[0].shape[0]), **b)
        log(f"phase 2b {name}: bit-equal, max_abs_err {err}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}), share "
            f"{b['bound_ms'] / ms:.4f}, {pairs / (ms / 1e3):.4e} pairs/s, host enqueue "
            f"{host_ms:.4f} ms a call")
        if big:
            # where its time goes: the same product through scan_hits, whose
            # lighter block end comes every 8 chunks at 512-row blocks and,
            # like scan_max's unit end, every 2 at 128-row blocks
            th = torch.tensor([kw["L"] - 3.0], device="cuda")
            for bs in (512, 128):
                hkw = dict(L=kw["L"], K=kw["K"], P=kw["P"], SUB=1, BS_M=bs, fold_bias=False)
                results[name][f"scan_hits_bs{bs}_ms"] = cuda_ms(
                    lambda: scan_hits.scan_block_hits(th, *args, **hkw))
            log(f"phase 2b {name}: scan_hits on the same inputs, "
                f"{results[name]['scan_hits_bs512_ms']:.4f} ms at 512-row blocks, "
                f"{results[name]['scan_hits_bs128_ms']:.4f} ms at 128-row blocks")
    if not torch.equal(outs["L20_fold_SUB1"][:, 0], outs["L20_fold_SUB32"].amax(dim=1)):
        raise AssertionError("SUB = 1 is not the max of the SUB = 32 subtiles")
    return results


# --- phase 3 -----------------------------------------------------------------

_COMP = str.maketrans("ACGTN", "TGCAN")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def plant_all(seq: bytearray, plants) -> None:
    """tests/genomes.py::plant_guide for many guides at once (that helper
    rebuilds the whole sequence string per plant): guide at [pos, pos+L) on
    the given strand with its PAM downstream, wrapping the origin."""
    n = len(seq)

    def put(s: str, at: int) -> None:
        for i, ch in enumerate(s):
            seq[(at + i) % n] = ord(ch)

    for guide, pos, strand, pam in plants:
        if strand == "F":
            put(guide, pos)
            put(pam, pos + len(guide))
        else:
            put(revcomp(guide), pos)
            put(revcomp(pam), pos - len(pam))


def strided_windows(seq: str, n: int, L: int, count: int) -> list[str]:
    """The library of bench.py: genome windows at strided positions."""
    out, pos = [], 0
    step = n // (count + 1)
    while len(out) < count:
        pos = (pos + step) % (n - L - 3)
        out.append(seq[pos : pos + L])
    return out


def random_seq(n: int, rng) -> str:
    from barcoder_tpu_torch.core.encode import decode

    return decode(rng.integers(0, 4, size=n).astype(np.int8))


def make_record(n: int, n_genes: int, seed: int, rec_id: str):
    """tests/genomes.py::make_record(wrapped_gene=True) on the port's own
    GenBank types: a random circular sequence, n_genes evenly spaced genes
    on alternating strands, and one gene across the origin."""
    from barcoder_tpu_torch.seqio.genbank import (
        CompoundLocation, Feature, GenBankRecord, Location,
    )

    rng = np.random.default_rng(seed)
    rec = GenBankRecord(id=rec_id, name=rec_id.split(".")[0],
                        description="synthetic circular test genome", seq=random_seq(n, rng),
                        topology="circular", organism="Testus syntheticus")
    gene_len = max(60, n // (n_genes * 2))
    for i in range(n_genes):
        start = (i * n) // n_genes
        loc = Location(start, min(start + gene_len, n), 1 if i % 2 == 0 else -1)
        rec.features.append(Feature("gene", loc, {"locus_tag": [f"TST_{i:04d}"],
                                                  "gene": [f"gen{i}"] if i % 3 == 0 else []}))
    loc = CompoundLocation([Location(n - 120, n, 1), Location(0, 80, 1)])
    rec.features.append(Feature("gene", loc, {"locus_tag": ["TST_WRAP"], "gene": ["wrp"]}))
    return rec


def build_inputs():
    from barcoder_tpu_torch.core.genome import Genome, contig_from_record
    from barcoder_tpu_torch.seqio.library import BarcodeLibrary

    t0 = time.perf_counter()
    rec = make_record(n=N_GENOME, n_genes=N_GENES, seed=SEED, rec_id="SMOKE0.1")
    rng = np.random.default_rng(SEED + 1)
    # planted sites spaced 2 kb apart, away from each other's windows; one
    # 20-mer wraps the origin
    slots = rng.permutation(np.arange(1, N_GENOME // 2000 - 1) * 2000)
    plants20 = [(random_seq(20, rng), int(slots[i]), "F" if i % 2 else "R",
                 random_seq(1, rng) + "GG") for i in range(N_PLANTED)]
    plants32 = [(random_seq(32, rng), int(slots[N_PLANTED + i]), "F" if i % 2 else "R",
                 random_seq(1, rng) + "G" + random_seq(1, rng) + "C")
                for i in range(N_PLANTED)]
    plants20[0] = (plants20[0][0], N_GENOME - 10, "F", "TGG")  # across the origin
    seq = bytearray(rec.seq, "ascii")
    plant_all(seq, plants20 + plants32)
    rec.seq = seq.decode("ascii")
    genome = Genome([contig_from_record(rec)], source="synthetic")
    lib20 = strided_windows(rec.seq, N_GENOME, 20, N_SPACERS) + [g for g, *_ in plants20]
    lib32 = strided_windows(rec.seq, N_GENOME, 32, N_SPACERS_32) + [g for g, *_ in plants32]
    libs = {
        20: BarcodeLibrary([(f"s{i}", s) for i, s in enumerate(lib20)]),
        32: BarcodeLibrary([(f"t{i}", s) for i, s in enumerate(lib32)]),
    }
    log(f"inputs: {N_GENOME} bp circular genome, {len(rec.features)} features, "
        f"libraries of {len(lib20)} x 20 nt and {len(lib32)} x 32 nt "
        f"({time.perf_counter() - t0:.2f} s)")
    return rec, genome, libs, {20: plants20, 32: plants32}


def check_planted(result, plants, n: int) -> None:
    res = result.results
    for guide, pos, strand, _pam in plants:
        # the pipeline reports an origin-wrapping site at a negative start
        start = pos - n if (pos + len(guide)) % n < pos % n else pos
        rows = res[(res["spacer"] == guide) & (res["tar_start"] == start)
                   & (res["sp_dir"] == strand)]
        if not (rows["mismatches"] == 0).any():
            raise AssertionError(f"planted guide {guide} at {pos} ({strand}) missing")


def phase3_main_path(rec, genome, libs, plants) -> dict:
    from barcoder_tpu_torch.ops import cuda_scan, scan_hits
    from barcoder_tpu_torch.pipeline.targets import run_targets, write_output

    # (name, library, PAM, v, planted guides, site tables cached after it)
    requests = [
        ("request1_L20_NGG_v3", libs[20], "NGG", 3, plants[20], 0),
        ("request2_L20_NGG_v3_steady", libs[20], "NGG", 3, plants[20], 1),
        ("request3_L32_NGNC_v1", libs[32], "NGNC", 1, plants[32], 1),
    ]
    cuda_scan._SITE_DEV_CACHE.clear()
    cuda_scan._SITE_SEEN.clear()
    out = {}
    per_request = {}
    for name, lib, pam, v, planted, tables in requests:
        scan_hits.launches = scan_hits.matrix_launches = 0
        t0 = time.perf_counter()
        result = run_targets(lib, genome, pam, v, backend="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_request[name] = (scan_hits.launches, scan_hits.matrix_launches)
        # the engine each request took, read from the site-table cache: the
        # second request of the (genome, NGG, 20) key builds the only table
        if len(cuda_scan._SITE_DEV_CACHE) != tables:
            raise AssertionError(f"{name}: {len(cuda_scan._SITE_DEV_CACHE)} site tables "
                                 f"cached, expected {tables}")
        check_planted(result, planted, genome.contigs[0].length)
        table = result.table
        if len(table) == 0 or "spacer" not in table.columns:
            raise AssertionError(f"{name}: empty or malformed table")
        sink = open(os.devnull, "w")
        write_output(result, sink)
        sink.close()
        prof = result.stats["profile"]
        engine = "site" if scan_hits.matrix_launches else "dense"
        out[name] = dict(wall_s=wall, rows=len(table), hits=prof["counters"]["hits"],
                         engine=engine, phases_s=prof["timings_s"])
        log(f"phase 3 {name}: {engine} engine, {wall:.4f} s, {len(table)} rows, "
            f"{prof['counters']['hits']} hits, phases {prof['timings_s']}")
    # (launches, of which in matrix_rows mode): a dense 20-nt request scores
    # both strands in one launch, a 32-nt one needs one per strand; the
    # promoted request 2 launches once in matrix_rows mode
    expect = {"request1_L20_NGG_v3": (1, 0), "request2_L20_NGG_v3_steady": (1, 1),
              "request3_L32_NGNC_v1": (2, 0)}
    if per_request != expect:
        raise AssertionError(f"scan_hits launches per request {per_request}, expected {expect}")
    log(f"phase 3: scan_hits launches (all, matrix_rows) per request: {per_request}")
    out["launches_dense"] = per_request["request1_L20_NGG_v3"][0] + per_request[
        "request3_L32_NGNC_v1"][0]
    out["launches_site"] = per_request["request2_L20_NGG_v3_steady"][0]
    out["launches_per_request"] = per_request
    return out


def planted_tuples(seqs, plants) -> set:
    index = {s: i for i, s in enumerate(seqs)}
    return {(index[g], pos, 0 if strand == "F" else 1, 0) for g, pos, strand, _ in plants}


def hit_tuples(h) -> set:
    return set(zip(h.spacer_idx.tolist(), h.pos.tolist(), h.strand.tolist(),
                   h.mismatches.tolist()))


def phase3_hits_vs_plain(genome, libs, plants) -> dict:
    """Request 1's library on the site engine and on the dense engine
    (``site_mode`` "always" and "never") against the plain torch scan, all
    on the card, on the library's unique sequences; every planted guide at
    0 mismatches."""
    from barcoder_tpu_torch.ops.cuda_scan import cuda_scan_contigs
    from barcoder_tpu_torch.ops.ref_scan import torch_scan

    seqs = list(dict.fromkeys(s for _, s in libs[20].entries))
    contig = genome.contigs[0]
    got, secs = {}, {}
    for mode in ("always", "never"):
        t0 = time.perf_counter()
        got[mode] = cuda_scan_contigs(seqs, [contig], 3, "NGG", site_mode=mode)[0]
        torch.cuda.synchronize()
        secs[mode] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = torch_scan(seqs, contig, 3, "NGG", device="cuda")
    torch_s = time.perf_counter() - t0
    for mode, hits in got.items():
        if not same_hits(hits, want):
            raise AssertionError(f"site_mode={mode!r} Hits differ from torch_scan's")
    if not planted_tuples(seqs, plants[20]) <= hit_tuples(want):
        raise AssertionError("a planted guide is missing from request 1's Hits")
    log(f"phase 3: site-engine Hits == dense-engine Hits == torch_scan Hits ({len(want)} "
        f"hits, every planted guide at 0 mismatches; site scan {secs['always']:.4f} s, "
        f"dense scan {secs['never']:.4f} s, torch_scan {torch_s:.4f} s)")
    return dict(hits=len(want), site_scan_s=secs["always"], dense_scan_s=secs["never"],
                torch_scan_s=torch_s), got["always"]


def plain_by_blocks(args, kw, rows: int):
    """The kernel's plain version over chunks of whole spacer blocks of at
    most ``rows`` rows (blocks are independent), so its (rows, P) score
    matrix stays bounded at design scale: the same function."""
    from barcoder_tpu_torch.ops import scan_hits

    th, q, tiles, bias = args
    BS_M = kw["BS_M"]
    n_sb = q.shape[0] // BS_M
    step = max(rows // BS_M, 1)
    parts = [scan_hits.scan_block_hits_reference(
                 th, q[b0 * BS_M : min(b0 + step, n_sb) * BS_M], tiles, bias, **kw)[
                 :, : min(step, n_sb - b0)]
             for b0 in range(0, n_sb, step)]
    out = torch.cat(parts, dim=1)
    return torch.nn.functional.pad(out, (0, 0, 0, -(-n_sb // 8) * 8 - n_sb))


def site_kernel_args(prep, table):
    """The kernel's arguments on the site path (``_SiteScanJob``): the site
    tiles, a zero bias and the forward one-hot rows."""
    from barcoder_tpu_torch.ops.cuda_scan import site_tiles

    tiles = site_tiles(table.codes_lp, prep.P)
    bias = torch.zeros((tiles.shape[0], 1, prep.P), dtype=torch.float32, device=tiles.device)
    kw = dict(L=prep.L, K=prep.K, P=prep.P, SUB=prep.SUB, BS_M=prep.bs, fold_bias=False,
              matrix_rows=True)
    return (prep.thresh_dev, prep.q_dev[0], tiles, bias), kw


def matrix_kernel_check(name: str, args, kw, *, rows: int, plain_reps: int = 2) -> dict:
    """The kernel in matrix_rows mode against its plain version (bit-equal),
    timed beside it, beside its bound and beside torch._int_mm + amax of the
    same int8 product (whose hit counts must agree)."""
    from barcoder_tpu_torch.ops import scan_hits

    th, q, tiles, bias = args
    L, P, BS_M, SUB = kw["L"], kw["P"], kw["BS_M"], kw["SUB"]
    got = scan_hits.scan_block_hits(*args, **kw)
    want = plain_by_blocks(args, kw, rows)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"({int((got != want).sum())} entries)")
    err = float((got - want).abs().max())
    del want
    ms = cuda_ms(lambda: scan_hits.scan_block_hits(*args, **kw))
    plain_ms = cuda_ms(lambda: plain_by_blocks(args, kw, rows), reps=plain_reps)
    k_eff = scan_hits.k_eff(L, 1, False)
    n_sb = q.shape[0] // BS_M
    library_ms = int_mm_library_ms(args, kw, got, rows=rows, reps=plain_reps)
    pairs = n_sb * BS_M * tiles.shape[0] * P
    b = hits_bound(L, 1, False, pairs, nbytes(*args, got))
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               pairs_per_s=pairs / (ms / 1e3), bound_share=b["bound_ms"] / ms,
               hit_columns=float(got.sum()), k_eff=k_eff,
               shape=dict(n_tiles=tiles.shape[0], rows=q.shape[0], L=L, P=P, SUB=SUB,
                          BS_M=BS_M, matrix_rows=True), **b)
    log(f"{name}: matrix_rows {tiles.shape[0]} tiles x {q.shape[0]} rows, L {L}, K_eff "
        f"{k_eff}: bit-equal, max_abs_err {err}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch._int_mm + amax {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}), share {b['bound_ms'] / ms:.4f}, {pairs / (ms / 1e3):.4e} pairs/s, "
        f"{float(got.sum()):.0f} hit columns")
    return out


def phase3b_site_kernel(genome, libs) -> dict:
    """The kernel in matrix_rows mode at the site engine's shapes on the
    4.6 Mb genome: request 1's library on its NGG sites (the table request
    2 cached) and the 32-nt library on its NGNC sites (a table built here,
    not cached, so later scans choose their engine as before)."""
    out = {}
    for name, L, pam, v in (("site_L20", 20, "NGG", 3), ("site_L32", 32, "NGNC", 1)):
        args, kw, n_sites = site_case(genome, libs, L, pam, v)
        out[name] = matrix_kernel_check(f"phase 3b {name} ({n_sites} sites)", args, kw,
                                        rows=1 << 15)
        out[name]["n_sites"] = n_sites
    return out


def site_case(genome, libs, L: int, pam: str, v: int):
    """The kernel's arguments in matrix_rows mode for library ``L`` on its
    ``pam`` sites of the genome, and the number of sites: at L = 20 the
    table the site engine caches, else a table built here and not cached."""
    from barcoder_tpu_torch.ops import cuda_scan
    from barcoder_tpu_torch.ops.prep import enumerate_sites, spacer_matrix

    contig = genome.contigs[0]
    dev = torch.device("cuda")
    seqs = list(dict.fromkeys(s for _, s in libs[L].entries))
    prep = cuda_scan._QPrep(spacer_matrix(seqs), v, pam, "downstream", cuda_scan.DEFAULT_P, 512,
                            dev)
    if L == 20:
        table = cuda_scan._site_table_for(prep, contig, "always")
    else:
        table = cuda_scan._SiteTable(prep.P, L, *enumerate_sites(contig, L, pam, "downstream"),
                                     dev)
    return *site_kernel_args(prep, table), table.n_sites


def design_case(genome, candidates):
    """The kernel's arguments at the design scan's shape: the candidate
    guides (NGG, 20 nt, v = 1) on their site table, and the number of sites."""
    from barcoder_tpu_torch.ops import cuda_scan
    from barcoder_tpu_torch.ops.prep import spacer_matrix

    prep = cuda_scan._get_prep(spacer_matrix(candidates), 1, "NGG", "downstream",
                               cuda_scan.DEFAULT_P, 512, torch.device("cuda"))
    table = cuda_scan._site_table_for(prep, genome.contigs[0], "always")
    return *site_kernel_args(prep, table), table.n_sites


def phase3_cli(rec) -> None:
    """The CLI (auto backend) in a subprocess on a 200 kb slice."""
    from barcoder_tpu_torch.seqio.genbank import GenBankRecord, write_genbank

    seq = rec.seq[:200_000]
    pos = seq.index("GG", 1021) - 21  # a forward NGG site
    guide = seq[pos : pos + 20]
    small = GenBankRecord(id="SLICE0.1", name="SLICE0", description="slice",
                          seq=seq, topology="circular", organism="x")
    with tempfile.TemporaryDirectory() as d:
        write_genbank([small], os.path.join(d, "g.gb"))
        with open(os.path.join(d, "lib.fasta"), "w") as fh:
            fh.write(f">p\n{guide}\n>n\n{'A' * 20}\n")
        proc = subprocess.run(
            [sys.executable, "-m", "barcoder_tpu_torch", "targets",
             os.path.join(d, "lib.fasta"), os.path.join(d, "g.gb"), "NGG", "0"],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    if proc.returncode != 0:
        raise AssertionError(f"CLI failed:\n{proc.stderr[-3000:]}")
    if not any(line.startswith(guide) and f"\t{pos}\t" in line
               for line in proc.stdout.splitlines()):
        raise AssertionError("CLI output lacks the planted guide")
    log("phase 3: CLI answered with the planted guide")


# --- phase 5 -----------------------------------------------------------------

def same_hits(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("spacer_idx", "pos", "strand", "mismatches"))


@contextlib.contextmanager
def plain_block_max():
    """sharded_scan_block_max with its kernel swapped for the plain torch
    version, on the same shards: the comparison side of the card check."""
    from barcoder_tpu_torch.ops import scan_max
    from barcoder_tpu_torch.parallel import sharded_scan

    kernel = sharded_scan.scan_block_max
    sharded_scan.scan_block_max = scan_max.scan_block_max_reference
    try:
        yield
    finally:
        sharded_scan.scan_block_max = kernel


def walls(fn, reps: int = 3) -> list:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def phase5_sharded(genome, libs, plants, cuda_hits) -> dict:
    """The sharded path on the card: run_targets(backend="sharded"),
    sharded_scan (site and dense engines), sharded_scan_many and
    sharded_scan_block_max on 1 and 4 shards of cuda:0, and on one shard
    per card where there are several."""
    import pandas as pd

    from barcoder_tpu_torch.ops import scan_hits, scan_max
    from barcoder_tpu_torch.ops.cuda_scan import cuda_scan_contigs, onehot_rows
    from barcoder_tpu_torch.ops.prep import build_scan_array, site_masks, spacer_matrix
    from barcoder_tpu_torch.ops.scan import scan_contigs
    from barcoder_tpu_torch.parallel.mesh import make_mesh
    from barcoder_tpu_torch.parallel.sharded_scan import (
        serving_cache_stats, sharded_scan, sharded_scan_block_max, sharded_scan_many,
    )
    from barcoder_tpu_torch.pipeline.targets import run_targets

    seqs = list(dict.fromkeys(s for _, s in libs[20].entries))
    contig = genome.contigs[0]
    dev = torch.device("cuda", 0)
    meshes = {"1": make_mesh(devices=[dev]), "4": make_mesh(devices=[dev] * 4)}
    if torch.cuda.device_count() > 1:
        meshes["cards"] = make_mesh()
    L, K, P = 20, 128, 16384
    q = torch.from_numpy(onehot_rows(spacer_matrix(seqs), K)).to(dev, torch.bfloat16)
    scan = build_scan_array(contig, L).astype(np.int32)
    mask = site_masks(contig, L, "NGG", "downstream")[0].astype(np.int32)
    for arr in (scan, mask):  # read-only: the cache key hashes them once
        arr.setflags(write=False)
    many_libs = [seqs[k::8] for k in range(8)]

    # the path, with every launch counter at 0 just before it
    scan_hits.launches = scan_hits.matrix_launches = 0
    scan_max.launches = 0
    t0 = time.perf_counter()
    result = run_targets(libs[20], genome, "NGG", 3, backend="sharded")
    torch.cuda.synchronize()
    targets_s = time.perf_counter() - t0
    hits, dense, many, block = {}, {}, {}, {}
    for n, mesh in meshes.items():
        hits[n] = sharded_scan(seqs, contig, 3, "NGG", mesh=mesh, P=P)
        dense[n] = sharded_scan(seqs, contig, 3, "NGG", mesh=mesh, P=P, site_mode="never")
        many[n] = sharded_scan_many(many_libs, contig, 3, "NGG", mesh=mesh, P=P)
        block[n] = sharded_scan_block_max(q, scan, mask, mesh, L=L, K=K, P=P)
    torch.cuda.synchronize()
    launches = {"scan_hits": scan_hits.launches, "scan_max": scan_max.launches}
    matrix = scan_hits.matrix_launches
    log(f"phase 5: launches on the sharded path {launches}, {matrix} of scan_hits in "
        f"matrix_rows mode; caches {json.dumps(serving_cache_stats())}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the sharded path never launched the {name} kernel")
    if matrix == 0 or matrix == launches["scan_hits"]:
        raise AssertionError("the sharded path did not launch scan_hits in both modes")

    check_planted(result, plants[20], contig.length)
    pd.testing.assert_frame_equal(result.table,
                                  run_targets(libs[20], genome, "NGG", 3, backend="cuda").table)
    planted = planted_tuples(seqs, plants[20])
    out = dict(launches=launches, matrix_launches=matrix, targets_sharded_s=targets_s,
               hits=len(cuda_hits))
    solo = [cuda_scan_contigs(lib, [contig], 3, "NGG", site_mode="always")[0]
            for lib in many_libs]
    max_err = 0.0
    for n in meshes:
        for engine, got in (("site", hits[n]), ("dense", dense[n])):
            if not same_hits(got, cuda_hits):
                raise AssertionError(f"sharded {engine} Hits on mesh {n} differ from the cuda "
                                     "backend's")
            if not planted <= hit_tuples(got):
                raise AssertionError(f"planted guides missing on mesh {n} ({engine})")
        for k, (got, want) in enumerate(zip(many[n], solo)):
            if not same_hits(got, want):
                raise AssertionError(f"sharded_scan_many library {k} on mesh {n} differs from "
                                     "its solo scan")
        with plain_block_max():
            want_max, want_totals = sharded_scan_block_max(q, scan, mask, meshes[n], L=L, K=K,
                                                           P=P)
        if not (np.array_equal(block[n][0], want_max)
                and np.array_equal(block[n][1], want_totals)):
            raise AssertionError(f"block max on mesh {n} differs from its plain version")
        block_max_cached(lambda: sharded_scan_block_max(q, scan, mask, meshes[n], L=L, K=K, P=P),
                         block[n], f"mesh {n}")
        max_err = max(max_err, float(np.abs(block[n][0] - want_max).max()))
        log(f"phase 5: mesh {n} ({meshes[n].devices.size} shards): site and dense Hits == "
            f"cuda Hits ({len(cuda_hits)}), planted found; sharded_scan_many 8 x "
            f"{len(many_libs[0])} == solo scans; block_max {block[n][0].shape} and totals "
            "== plain")
    out["block_max_err"] = max_err

    contig_list = [contig]
    out["walls_s"] = {
        "cuda": walls(lambda: scan_contigs(seqs, contig_list, 3, "NGG", backend="cuda")),
        "cuda_dense": walls(lambda: cuda_scan_contigs(seqs, contig_list, 3, "NGG",
                                                      site_mode="never")),
        **{f"sharded_{n}": walls(lambda m=m: sharded_scan(seqs, contig, 3, "NGG", mesh=m, P=P))
           for n, m in meshes.items()},
        **{f"sharded_dense_{n}": walls(lambda m=m: sharded_scan(seqs, contig, 3, "NGG", mesh=m,
                                                                P=P, site_mode="never"))
           for n, m in meshes.items()},
        **{f"many_8_{n}": walls(lambda m=m: sharded_scan_many(many_libs, contig, 3, "NGG",
                                                              mesh=m, P=P))
           for n, m in meshes.items()},
        **{f"block_max_{n}": walls(lambda m=m: sharded_scan_block_max(q, scan, mask, m, L=L,
                                                                      K=K, P=P))
           for n, m in meshes.items()},
    }
    with plain_block_max():
        out["walls_s"].update({f"block_max_plain_{n}": walls(lambda m=m: sharded_scan_block_max(
            q, scan, mask, m, L=L, K=K, P=P)) for n, m in meshes.items()})
    log(f"phase 5 steady walls (s): {out['walls_s']}")

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "barcoder_tpu_torch.parallel.scaling", "4600000", "10240",
         "--engine", "all", "--single-chip"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    if proc.returncode != 0:
        raise AssertionError(f"scaling harness failed:\n{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout)
    out["harness"] = report
    out["harness_s"] = time.perf_counter() - t0
    log(f"phase 5 harness ({out['harness_s']:.2f} s): {json.dumps(report)}")
    if len({r["hits"] for r in report["flagship"] + report["dense"]
            + [report["single_chip"]]}) != 1:
        raise AssertionError("harness: the site, dense and single-card hit counts differ")
    # each timed row went through its kernel (the harness counts launches)
    for rows, kernel in ((report["flagship"], "scan_hits"), (report["dense"], "scan_hits"),
                         (report["blockmax"], "scan_max"),
                         ([report["single_chip"]], "scan_hits")):
        for row in rows:
            if row["launches"][kernel] == 0:
                raise AssertionError(f"harness row {row} never launched the {kernel} kernel")
    out["harness_launches"] = {
        "scan_hits": sum(r["launches"]["scan_hits"] for r in
                         report["flagship"] + report["dense"] + [report["single_chip"]]),
        "scan_max": sum(r["launches"]["scan_max"] for r in report["blockmax"]),
    }
    out["harness_block_max"] = harness_block_max(meshes["1"], P)
    return out


def block_max_cached(call, first, what: str) -> None:
    """A repeat call of sharded_scan_block_max on the same arrays: its tiles
    and bias come from the genome cache (a hit, no miss, nothing built) and
    its results equal the first call's."""
    from barcoder_tpu_torch.parallel.sharded_scan import serving_cache_stats

    serving_cache_stats(reset=True)
    again = call()
    stats = serving_cache_stats()["genome"]
    if stats["hits"] != 1 or stats["misses"] or stats["bytes_built"]:
        raise AssertionError(f"block max on {what}: the repeat call missed the cache: {stats}")
    if not (np.array_equal(again[0], first[0]) and np.array_equal(again[1], first[1])):
        raise AssertionError(f"block max on {what}: the cached call answers differently")


def harness_block_max(mesh, P: int) -> dict:
    """The harness's block-max workload in this process: the kernel's
    block_max and totals against the plain version's on the same shards,
    and every spacer (a genome window) scoring L, an exact match, in its
    own block at its own window's tile."""
    from barcoder_tpu_torch.ops import scan_max
    from barcoder_tpu_torch.parallel.scaling import _make_workload, blockmax_inputs
    from barcoder_tpu_torch.parallel.sharded_scan import sharded_scan_block_max

    L = 20
    contig, spacers = _make_workload(N_GENOME, 10240, L)
    q, scan, mask, K = blockmax_inputs(contig, spacers, L, mesh.devices.ravel()[0])
    scan_max.launches = 0
    got_max, got_totals = sharded_scan_block_max(q, scan, mask, mesh, L=L, K=K, P=P)
    torch.cuda.synchronize()
    launches = scan_max.launches
    if launches == 0:
        raise AssertionError("the harness's block max never launched the scan_max kernel")
    with plain_block_max():
        want_max, want_totals = sharded_scan_block_max(q, scan, mask, mesh, L=L, K=K, P=P)
    if not (np.array_equal(got_max, want_max) and np.array_equal(got_totals, want_totals)):
        raise AssertionError("the harness's block max differs from its plain version")
    i = np.arange(len(spacers))
    if not (got_max[(64 + 11 * i) // P, 0, i // 128] == L).all():
        raise AssertionError("a harness spacer does not score L at its own window")
    block_max_cached(lambda: sharded_scan_block_max(q, scan, mask, mesh, L=L, K=K, P=P),
                     (got_max, got_totals), "the harness's workload")
    log(f"phase 5 harness block max: {got_max.shape} and totals == plain, "
        f"{len(spacers)} spacers score {L} at their windows, {launches} launches")
    return dict(launches=launches, max_abs_err=float(np.abs(got_max - want_max).max()))


# --- phase 5b ----------------------------------------------------------------

def check_design_guides(final, seq: str) -> None:
    """Every kept guide is the window of its own reported site at 0
    mismatches (a site across the origin is reported at a negative start)."""
    n = len(seq)
    ext = seq + seq[:64]
    for sp, start, end, sp_dir, mm in zip(final["spacer"], final["tar_start"],
                                          final["tar_end"], final["sp_dir"],
                                          final["mismatches"]):
        window = ext[int(start) % n : int(start) % n + len(sp)]
        if sp_dir == "R":
            window = revcomp(window)
        if int(mm) != 0 or int(end) - int(start) != len(sp) or window != sp:
            raise AssertionError(f"kept guide {sp} is not its site's window at "
                                 f"{start}..{end} ({sp_dir}, {mm} mismatches)")


def slice_genome(rec, n: int):
    """The first n bases of ``rec`` with the genes that lie inside them."""
    from barcoder_tpu_torch.core.genome import Genome, contig_from_record
    from barcoder_tpu_torch.seqio.genbank import GenBankRecord, Location

    small = GenBankRecord(id="SLICE0.1", name="SLICE0", description="slice", seq=rec.seq[:n],
                          topology="circular", organism="x",
                          features=[f for f in rec.features
                                    if isinstance(f.location, Location) and f.location.end <= n])
    return Genome([contig_from_record(small)], source="synthetic")


def phase5b_design(rec, genome) -> dict:
    """The design workload on the 4.6 Mb genome: the CLI in a subprocess,
    run_design in this process (the path, counts at 0 just before it), the
    kernel at the design scan's full shape, and the cuda backend's frame
    against the torch backend's on a 200 kb slice."""
    import pandas as pd

    from barcoder_tpu_torch.ops import scan_hits
    from barcoder_tpu_torch.pipeline.design import find_candidate_guides, run_design
    from barcoder_tpu_torch.seqio.genbank import write_genbank

    out = {}
    with tempfile.TemporaryDirectory() as d:
        gb, fa = os.path.join(d, "genome.gb"), os.path.join(d, "candidates.fa")
        write_genbank([rec], gb)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "barcoder_tpu_torch", "design", gb, "NGG", "20",
             "--sgrna-out", fa],
            capture_output=True, text=True, timeout=900,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        out["cli_wall_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"design CLI failed:\n{proc.stderr[-3000:]}")
        with open(fa) as fh:
            n_cli = sum(1 for line in fh if line.startswith(">"))
    t0 = time.perf_counter()
    candidates = find_candidate_guides(genome, 20, "NGG")
    out["enumerate_s"] = time.perf_counter() - t0
    if n_cli != len(candidates):
        raise AssertionError(f"the design CLI wrote {n_cli} candidates, the enumeration "
                             f"finds {len(candidates)}")
    log(f"phase 5b: design CLI ({out['cli_wall_s']:.2f} s): {n_cli} candidates, "
        f"{len(proc.stdout.splitlines()) - 1} guides kept")

    scan_hits.launches = scan_hits.matrix_launches = 0
    t0 = time.perf_counter()
    final, tr, cands = run_design(genome, "NGG", 20, backend="cuda")
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"], out["matrix_launches"] = scan_hits.launches, scan_hits.matrix_launches
    if out["matrix_launches"] == 0 or out["launches"] != out["matrix_launches"]:
        raise AssertionError(f"design launched scan_hits {out['launches']} times, "
                             f"{out['matrix_launches']} in matrix_rows mode")
    if final.to_csv(sep="\t", index=False, na_rep="None") != proc.stdout:
        raise AssertionError("the design CLI's TSV differs from run_design's frame")
    check_design_guides(final, rec.seq)
    if cands != candidates:
        raise AssertionError("run_design scanned other candidates than the enumeration's")
    out.update(candidates=len(cands), targets_rows=len(tr.table), kept=len(final),
               phases_s=tr.stats["profile"]["timings_s"])
    log(f"phase 5b: run_design ({out['wall_s']:.2f} s, enumeration {out['enumerate_s']:.2f} "
        f"s): {len(cands)} candidates, {len(tr.table)} target rows, {len(final)} kept, each "
        f"its own site at 0 mismatches; scan_hits launches {out['launches']} (matrix_rows "
        f"{out['matrix_launches']}); phases {out['phases_s']}")

    args, kw, n_sites = design_case(genome, candidates)
    out["kernel"] = matrix_kernel_check(f"phase 5b design_L20 ({n_sites} sites)", args, kw,
                                        rows=1 << 15, plain_reps=1)
    del args

    small = slice_genome(rec, 200_000)
    want, _, _ = run_design(small, "NGG", 20, backend="torch")
    for attempt in ("first (dense)", "second (site)"):
        scan_hits.matrix_launches = 0
        got, _, small_cands = run_design(small, "NGG", 20, backend="cuda")
        pd.testing.assert_frame_equal(got, want)
        if bool(scan_hits.matrix_launches) != attempt.startswith("second"):
            raise AssertionError(f"200 kb design, {attempt} call: wrong engine")
    log(f"phase 5b: 200 kb slice ({len(small_cands)} candidates): cuda design frame == "
        f"torch design frame, dense and site-promoted ({len(want)} guides kept)")
    out["slice_kept"] = len(want)
    return out


# --- phase 6 -----------------------------------------------------------------

def _registers(report, pattern: str):
    regs = [r["registers"] for r in report if pattern in r["function"]]
    return regs[0] if len(regs) == 1 else None


def _kernel_vs_plain(name: str, fn, plain, pairs: int, registers, **extra) -> dict:
    """Hold ``fn`` against ``plain`` (bit-equal) and time both."""
    got, want = fn(), plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    err = float((got.double() - want.double()).abs().max())
    del got, want
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain, reps=2)
    rate = pairs / (ms / 1e3)
    if "bound_ms" in extra:
        extra["share"] = extra["bound_ms"] / ms
    log(f"phase 6 {name}: bit-equal, max_abs_err {err}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, {rate:.4e} pairs/s, {registers} registers"
        + "".join(f", {k} {v:.4f}" if isinstance(v, float) else f", {k} {v}"
                  for k, v in extra.items()))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, pairs_per_s=rate,
                registers=registers, **extra)


def library_colmax_ms(q, g, BS_M: int, want) -> float:
    """The column max through one PyTorch product per tile (``torch._int_mm``
    in int8; in bf16 ``torch.mm`` into f32, as the kernels sum, so that no
    score is rounded to bf16) and ``amax``: checked equal to the kernel's
    ``want``, then timed."""
    n_sb, P = q.shape[0] // BS_M, g.shape[2]
    q = q[: n_sb * BS_M]

    def mm(a, b):
        if a.dtype == torch.int8:
            return torch._int_mm(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    def library():
        return [mm(q, g[t]).view(n_sb, BS_M, P).amax(dim=1) for t in range(g.shape[0])]

    if not torch.equal(torch.stack(library()).to(want.dtype), want):
        raise AssertionError(f"the {q.dtype} library column max disagrees with the kernel")
    return cuda_ms(library, reps=2)


def colmax_case(mode: str):
    """int8_bench's inputs at its script's shape in ``mode`` (int8 or
    bf16) on the card, and the kernel's output type."""
    from barcoder_tpu_torch.experiments import int8_bench as m
    from barcoder_tpu_torch.experiments import int8_inputs, int8_tensors
    from barcoder_tpu_torch.ops import colmax_mma

    q8, g8 = int8_inputs(m.N_TILES, m.N_SB, BS_M=m.BS_M, K=m.K, P=m.P, seed=SEED)
    q, g = int8_tensors(q8, g8, m.DTYPES[mode], torch.device("cuda"))
    return q, g, colmax_mma.OUT_DTYPE[m.DTYPES[mode]]


def phase1_case():
    """The phase-1 scripts' inputs at their shape on the card, with 30% of
    the columns masked and hits planted, so the epilogues count something;
    and the keyword arguments of the variants."""
    from barcoder_tpu_torch.experiments import phase1_ablate as a
    from barcoder_tpu_torch.experiments import phase1_inputs, phase1_tensors, plant_hits

    thresh, q, tiles, bias = phase1_inputs(a.N_TILES, a.N_SB, L=a.L, K=a.K, P=a.P, BS_M=a.BS_M,
                                           mask_share=0.3, seed=SEED)
    plant_hits(q, tiles, L=a.L, P=a.P, seed=SEED + 1)
    return (phase1_tensors(thresh, q, tiles, bias, torch.device("cuda")),
            dict(L=a.L, K=a.K, P=a.P, SUB=a.SUB, BS_M=a.BS_M))


def phase6_experiment_kernels() -> dict:
    """The three experiment kernels at their scripts' full shapes, every
    variant held bit-equal against its plain version and timed beside it;
    for the phase-1 variants also beside the scan_hits kernel on
    the same inputs (the scripts' random inputs with planted hits and 30%
    masked columns, so the epilogues count something)."""
    from barcoder_tpu_torch.experiments import int8_bench, int8_inputs, int8_tensors, phase1_ablate
    from barcoder_tpu_torch.ops import colmax_mma, nvcc, phase1_variants, scan_hits

    report = {n: nvcc.ptxas_report(n) for n in ("colmax_mma", "phase1_mma")}
    for name, rows in report.items():
        for r in rows:
            log(f"phase 6 ptxas {name}: {r}")
            if r["spill_stores"] or r["spill_loads"]:
                raise AssertionError(f"{r['function']} spills registers")
    dev = torch.device("cuda")
    out = {"colmax_mma": {}, "phase1_ablate": {}, "phase1_epilogue": {}}

    m = int8_bench
    pairs = m.N_TILES * m.N_SB * m.BS_M * m.P
    for mode, dtype in m.DTYPES.items():
        q, g, od = colmax_case(mode)
        out_bytes = m.N_TILES * m.N_SB * m.P * torch.empty((), dtype=od).element_size()
        out["colmax_mma"][mode] = _kernel_vs_plain(
            f"colmax_mma {mode}", lambda: colmax_mma.colmax(q, g, od, BS_M=m.BS_M),
            lambda: colmax_mma.colmax_reference(q, g, od, BS_M=m.BS_M), pairs,
            _registers(report["colmax_mma"], "S8" if mode == "int8" else "Bf16"),
            library_ms=library_colmax_ms(q, g, m.BS_M, colmax_mma.colmax(q, g, od, BS_M=m.BS_M)),
            **bound(2 * m.K * pairs, mode, nbytes(q, g) + out_bytes))
        # a ragged case: 80-row blocks (padded to 128), a 400-column tile
        qe, ge = int8_tensors(*int8_inputs(3, 5, BS_M=80, K=m.K, P=400, seed=SEED + 1), dtype,
                              dev)
        if not torch.equal(colmax_mma.colmax(qe, ge, od, BS_M=80),
                           colmax_mma.colmax_reference(qe, ge, od, BS_M=80)):
            raise AssertionError(f"colmax_mma {mode}: the ragged case disagrees with its plain "
                                 "version")
    del q, g, qe, ge

    a = phase1_ablate
    (th, q, tiles, bias), kw = phase1_case()
    pairs = a.N_TILES * a.N_SB * a.BS_M * a.P
    hits = scan_hits.scan_block_hits(th, q, tiles, bias, fold_bias=True, **kw)
    hits_ms = cuda_ms(lambda: scan_hits.scan_block_hits(th, q, tiles, bias, fold_bias=True,
                                                        **kw))
    hb = hits_bound(a.L, 2, True, pairs, nbytes(th, q, tiles, bias, hits))
    log(f"phase 6 scan_hits (int8 wgmma) at the same shapes: {hits_ms:.4f} ms, "
        f"{pairs / (hits_ms / 1e3):.4e} pairs/s, {int(hits.sum())} hit columns, bound "
        f"{hb['bound_ms']:.4f} ms ({hb['bound_by']}), share {hb['bound_ms'] / hits_ms:.4f}, "
        f"issued {hb['issued_bound_ms']:.4f} ms")
    if hits.sum() == 0:
        raise AssertionError("phase 6 inputs give no hits")
    g_all = phase1_variants.build_g_all(tiles, bias, L=a.L, K=a.K, P=a.P)
    # the column max's yardstick (variant a's function), on build_g_all's G
    # (the built variants' G)
    lib_ms = library_colmax_ms(q, g_all, a.BS_M,
                               phase1_variants.bench_full("a", th, q, tiles, bias, **kw))
    log(f"phase 6 phase-1 column max through torch.mm (bf16 -> f32) + amax: {lib_ms:.4f} ms")
    n_sb = q.shape[0] // a.BS_M
    out_bytes = {"count": nbytes(hits), "count8": nbytes(hits),
                 "colmax": a.N_TILES * n_sb * a.P * 4, "hit": a.N_TILES * n_sb * a.P}

    def regs(source, epi):
        ks = a.K // 16 if source == "streamed" else phase1_variants.k_eff(a.L) // 16
        return _registers(report["phase1_mma"], "phase1_mma_kernel<"
                          f"{str(source == 'streamed').lower()}, "
                          f"{phase1_variants.EPILOGUE[epi]}, {ks}>")

    def variant_bound(source, epi):
        g_in = (g_all,) if source == "streamed" else (tiles, bias)
        return phase1_bound(source, a.L, a.K, pairs,
                            nbytes(th, q, *g_in) + out_bytes[epi])

    for v, (source, epi) in phase1_variants.ABLATE.items():
        out["phase1_ablate"][v] = _kernel_vs_plain(
            f"phase1_ablate {v} ({source}, {epi})",
            lambda v=v: phase1_variants.ablate(v, th, q, tiles, bias, g_all, **kw),
            lambda v=v: phase1_variants.ablate_reference(v, th, q, tiles, bias, g_all, **kw),
            pairs, regs(source, epi), scan_hits_ms=hits_ms, library_ms=None,
            **variant_bound(source, epi))
    if not torch.equal(phase1_variants.ablate("A", th, q, tiles, bias, g_all, **kw), hits):
        raise AssertionError("phase1_ablate A disagrees with the scan_hits kernel")
    del g_all, hits
    for v, epi in phase1_variants.BENCH.items():
        out["phase1_epilogue"][v] = _kernel_vs_plain(
            f"phase1_epilogue {v} ({epi})",
            lambda v=v: phase1_variants.bench_full(v, th, q, tiles, bias, **kw),
            lambda v=v: phase1_variants.bench_full_reference(v, th, q, tiles, bias, **kw),
            pairs, regs("built", epi), scan_hits_ms=hits_ms,
            library_ms=lib_ms if v == "a" else None, **variant_bound("built", epi))
    del th, q, tiles, bias
    out["phase1_ragged"] = phase6_phase1_ragged()
    out["scan_hits_ms"] = hits_ms
    return out


def phase6_phase1_ragged() -> dict:
    """Every phase-1 variant bit-equal to its plain version off the
    scripts' shape: P = 12,000 (a ragged 512-column slab), 12 spacer blocks
    (the batched variants' unwritten last group of 4), blocks of 80 and 24
    rows (padded to 128 and 64), L = 31 (4L + 2 = 126 rows of K) and 20,
    bias values that bf16 rounds and -0.0 in G row 4L beside MASK_BIAS."""
    from barcoder_tpu_torch.experiments import (
        phase1_inputs, phase1_tensors, plant_hits, round_bias,
    )
    from barcoder_tpu_torch.ops import phase1_variants

    out = {}
    for i, (n_tiles, n_sb, P, BS_M, L) in enumerate(((3, 12, 12000, 80, 31),
                                                      (2, 12, 12000, 24, 20))):
        thresh, q, tiles, bias = phase1_inputs(n_tiles, n_sb, L=L, K=128, P=P, BS_M=BS_M,
                                               mask_share=0.3, seed=SEED + 10 + i)
        plant_hits(q, tiles, L=L, P=P, seed=SEED + 20 + i)
        round_bias(bias, seed=SEED + 30 + i)
        th, q, tiles, bias = phase1_tensors(thresh, q, tiles, bias, torch.device("cuda"))
        kw = dict(L=L, K=128, P=P, SUB=32, BS_M=BS_M)
        g_all = phase1_variants.build_g_all(tiles, bias, L=L, K=128, P=P)
        name = f"{n_tiles}x{n_sb}x{BS_M}x{P}_L{L}"
        for v in phase1_variants.ABLATE:
            got = phase1_variants.ablate(v, th, q, tiles, bias, g_all, **kw)
            want = phase1_variants.ablate_reference(v, th, q, tiles, bias, g_all, **kw)
            if not torch.equal(got, want) or want.sum() == 0:
                raise AssertionError(f"phase1_ablate {v}, {name}: kernel disagrees with its "
                                     "plain version (or counts nothing)")
        for v in phase1_variants.BENCH:
            got = phase1_variants.bench_full(v, th, q, tiles, bias, **kw)
            want = phase1_variants.bench_full_reference(v, th, q, tiles, bias, **kw)
            if not torch.equal(got, want):
                raise AssertionError(f"phase1_epilogue {v}, {name}: kernel disagrees with its "
                                     "plain version")
        out[name] = dict(max_abs_err=0.0, hit_columns=float(
            phase1_variants.bench_full("b", th, q, tiles, bias, **kw).sum()))
        log(f"phase 6 phase-1 ragged {name}: all 8 variants bit-equal, "
            f"{out[name]['hit_columns']:.0f} hit columns")
    return out


def phase6_entry_points() -> dict:
    """Each experiment entry point once, in this process, with the launch
    counts at 0 just before it: launches per kernel on each path."""
    from barcoder_tpu_torch.experiments import int8_bench, phase1_ablate, phase1_bench
    from barcoder_tpu_torch.ops import colmax_mma, phase1_variants, scan_hits

    by_path = {}
    for name, mod in (("int8_bench", int8_bench), ("phase1_ablate", phase1_ablate),
                      ("phase1_bench", phase1_bench)):
        colmax_mma.launches = 0
        phase1_variants.launches = dict.fromkeys(phase1_variants.launches, 0)
        scan_hits.launches = 0
        t0 = time.perf_counter()
        if mod.main([]) != 0:
            raise AssertionError(f"{name} failed")
        torch.cuda.synchronize()
        by_path[name] = {"colmax_mma": colmax_mma.launches, **phase1_variants.launches,
                         "scan_hits": scan_hits.launches}
        log(f"phase 6 {name} ({time.perf_counter() - t0:.2f} s): launches {by_path[name]}")
    for kernel, path in (("colmax_mma", "int8_bench"), ("phase1_ablate", "phase1_ablate"),
                         ("phase1_epilogue", "phase1_bench"), ("scan_hits", "phase1_bench")):
        if by_path[path][kernel] == 0:
            raise AssertionError(f"{path} never launched the {kernel} kernel")
    return by_path


# --- kernel times (--kernel-times) --------------------------------------------

def kernel_times(reps: int = 5) -> dict:
    """CUDA-event times (``cuda_ms``, mean of ``reps`` after a warm-up) of
    the kernels that share ``csrc/wgmma_tile.cuh``, with no checks, on the
    inputs the phases build (the same builders, so the same inputs):
    ``scan_hits`` at the 20-nt request's dense shape (``request_case``) and
    in ``matrix_rows`` mode at the site and design shapes of the 4.6 Mb
    genome (``site_case``, ``design_case``), ``colmax_mma`` in int8 and bf16
    (``colmax_case``) and every phase-1 variant (``phase1_case``). The
    builders use only what the package has had since its site engine, so
    one copy of this script times two trees of the package, each run from
    its own root: an A/B runs parent, change, change, parent in one call."""
    from barcoder_tpu_torch.experiments import int8_bench
    from barcoder_tpu_torch.ops import colmax_mma, phase1_variants, scan_hits
    from barcoder_tpu_torch.pipeline.design import find_candidate_guides

    out = {"scan_hits": {}, "colmax_mma": {}, "phase1": {}}
    args, kw = request_case()
    out["scan_hits"]["request"] = cuda_ms(lambda: scan_hits.scan_block_hits(*args, **kw), reps)
    del args
    _rec, genome, libs, _plants = build_inputs()
    for name, (args, kw, _) in (
            ("site", site_case(genome, libs, 20, "NGG", 3)),
            ("design", design_case(genome, find_candidate_guides(genome, 20, "NGG")))):
        out["scan_hits"][name] = cuda_ms(lambda: scan_hits.scan_block_hits(*args, **kw), reps)
    del args
    for mode in int8_bench.DTYPES:
        q, g, od = colmax_case(mode)
        out["colmax_mma"][mode] = cuda_ms(
            lambda: colmax_mma.colmax(q, g, od, BS_M=int8_bench.BS_M), reps)
    del q, g
    (th, q, tiles, bias), kw = phase1_case()
    g_all = phase1_variants.build_g_all(tiles, bias, L=kw["L"], K=kw["K"], P=kw["P"])
    for v in phase1_variants.ABLATE:
        out["phase1"][v] = cuda_ms(
            lambda v=v: phase1_variants.ablate(v, th, q, tiles, bias, g_all, **kw), reps)
    for v in phase1_variants.BENCH:
        out["phase1"][v] = cuda_ms(
            lambda v=v: phase1_variants.bench_full(v, th, q, tiles, bias, **kw), reps)
    return out


# --- phase 4 (--profile) -----------------------------------------------------

def phase4_profile(genome, libs, trace_dir: str, reps: int = 3) -> dict:
    """The steady 20-nt request (the site engine, table cached), the 32-nt
    request and the design run, each timed steady and profiled once."""
    from torch.profiler import ProfilerActivity, profile

    from barcoder_tpu_torch.pipeline.design import run_design
    from barcoder_tpu_torch.pipeline.targets import run_targets

    os.makedirs(trace_dir, exist_ok=True)
    out = {}
    for name, L, pam, v in (("L20", 20, "NGG", 3), ("L32", 32, "NGNC", 1),
                            ("design", 20, "NGG", 1)):
        def request():
            t0 = time.perf_counter()
            if name == "design":
                r = run_design(genome, pam, L, backend="cuda")[1]
            else:
                r = run_targets(libs[L], genome, pam, v, backend="cuda")
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        request()  # warm: library prep and scan array cached
        walls = [request()[1] for _ in range(reps)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            r, wall = request()
        # only the device-side events: a CPU op's self device time repeats
        # the time of the kernels it launched
        dev = sorted(
            ((e.key, e.self_device_time_total / 1e3, e.count)
             for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
            key=lambda d: -d[1],
        )
        dev_ms = sum(d[1] for d in dev)
        prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{name}.json"))
        out[name] = dict(
            steady_walls_s=walls, profiled_wall_s=wall, device_ms=dev_ms,
            busy_share=dev_ms / (wall * 1e3), phases_s=r.stats["profile"]["timings_s"],
            top=[dict(name=k[:110], ms=ms, count=n) for k, ms, n in dev[:12]],
        )
        log(f"phase 4 {name}: steady walls {walls} s; profiled {wall:.6f} s, "
            f"device {dev_ms:.4f} ms, busy share {dev_ms / (wall * 1e3):.4f}, "
            f"phases {r.stats['profile']['timings_s']}")
        for k, ms, n in dev[:12]:
            log(f"   {ms:10.4f} ms  x{n:5d}  {k[:110]}")
    return out


def crossover(contig, libraries: dict) -> dict:
    """Dense against site engine on the card for each library (name →
    spacers), the engine forced by ``site_mode``: walls of the dense engine
    (scan array and library prep cached), of the site engine with its table
    cached, with the table loaded from the on-disk artifact, and built from
    scratch (artifacts off: host enumeration, table build and ship). What
    sets ``_SITE_MODE_MIN_SPACERS``."""
    from barcoder_tpu_torch.ops import cuda_scan

    def scan(spacers, mode, drop_table=False):
        def run():
            if drop_table:
                cuda_scan._SITE_DEV_CACHE.clear()
            cuda_scan.cuda_scan_contigs(spacers, [contig], 1, "NGG", site_mode=mode)
        return run

    out = {}
    for name, spacers in libraries.items():
        reps = 2 if len(spacers) > 100_000 else 3
        row = {"dense": walls(scan(spacers, "never"), reps),
               "site_cached": walls(scan(spacers, "always"), reps),
               "site_from_artifact": walls(scan(spacers, "always", True), reps)}
        os.environ["BARCODER_TPU_NO_ARTIFACTS"] = "1"
        try:
            row["site_built"] = walls(scan(spacers, "always", True), reps)
        finally:
            del os.environ["BARCODER_TPU_NO_ARTIFACTS"]
        cuda_scan._site_table_for(cuda_scan._get_prep(
            cuda_scan.spacer_matrix(spacers), 1, "NGG", "downstream", cuda_scan.DEFAULT_P,
            512, torch.device("cuda")), contig, "always")  # cached again
        out[name] = row
        log(f"phase 4 crossover, {len(spacers)} spacers, v = 1 (walls, s): {row}")
    return out


def phase4_decisions(genome, libs) -> dict:
    """The measurements behind two settings, made again only when they are
    in question: the dense/site crossover walls on request 1's library and
    on design-scale libraries (``_SITE_MODE_MIN_SPACERS``), and the steady
    20-nt request end to end on the cuda and the sharded backend,
    alternated (which one ``auto`` takes)."""
    from barcoder_tpu_torch.pipeline.design import find_candidate_guides
    from barcoder_tpu_torch.pipeline.targets import run_targets

    cands = find_candidate_guides(genome, 20, "NGG")
    seqs20 = list(dict.fromkeys(s for _, s in libs[20].entries))
    out = {"crossover": crossover(genome.contigs[0], {
        "request_L20": seqs20, **{f"design_{n}": cands[:n] for n in (65_536, 98_304, 131_072)},
        "design": cands})}
    out["request_walls_s"] = {
        f"{b}_{i}": walls(lambda b=b: run_targets(libs[20], genome, "NGG", 3, backend=b))
        for i in range(2) for b in ("cuda", "sharded")}
    log(f"phase 4 steady 20-nt request walls (s): {out['request_walls_s']}")
    return out


def _union_ms(intervals) -> float:
    """Length of the union of (start, end) intervals in microseconds, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def device_and_host(prof, wall_s: float) -> dict:
    """One profiled call split into device and host time: each card's busy
    time (the union of its kernels and copies), the time any card was
    busy, the device idle share of the wall, the largest device events,
    and the host's top-level torch ops, whose sum left out of the wall is
    Python and numpy work outside torch."""
    def step(e) -> bool:  # the profiler's own span around a scheduled step
        return e is not None and (e.name if hasattr(e, "name") else e.key).startswith(
            "ProfilerStep")

    per_card, host = {}, {}
    for e in prof.events():
        if step(e):
            continue
        if str(e.device_type).endswith("CUDA"):
            per_card.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
        elif e.cpu_parent is None or step(e.cpu_parent):
            host[e.name] = host.get(e.name, 0.0) + e.cpu_time_total / 1e3
    any_ms = _union_ms([iv for ivs in per_card.values() for iv in ivs])
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
                  and not step(e)),
                 key=lambda d: -d[1])
    host_top = sorted(host.items(), key=lambda kv: -kv[1])
    return dict(
        card_busy_ms={f"cuda:{i}": _union_ms(ivs) for i, ivs in sorted(per_card.items())},
        any_card_busy_ms=any_ms,
        device_idle_share=1.0 - any_ms / (wall_s * 1e3),
        torch_ops_host_ms=sum(host.values()),
        outside_torch_host_ms=wall_s * 1e3 - sum(host.values()),
        top_device=[dict(name=k[:110], ms=ms, count=n) for k, ms, n in dev[:8]],
        top_host=[dict(name=k[:110], ms=ms) for k, ms in host_top[:8]],
    )


def phase4_profile_sharded(trace_dir: str, reps: int = 3) -> dict:
    """The scaling harness's workload (4.6 Mb random circular genome,
    10,240 genome windows, NGG, v = 1, P = 16,384) through the flagship
    sharded_scan and sharded_scan_block_max, on one card and, where there
    are several, on one shard per card: steady walls, then one call under
    torch.profiler split into device and host time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from barcoder_tpu_torch.parallel.mesh import make_mesh
    from barcoder_tpu_torch.parallel.scaling import _make_workload, blockmax_inputs
    from barcoder_tpu_torch.parallel.sharded_scan import sharded_scan, sharded_scan_block_max

    L, P = 20, 16384
    contig, spacers = _make_workload(N_GENOME, 10240, L)
    q, scan, mask, K = blockmax_inputs(contig, spacers, L, torch.device("cuda", 0))
    n_cards = torch.cuda.device_count()
    dev0 = torch.device("cuda", 0)
    meshes = {1: make_mesh(1),
              **({n_cards: make_mesh()} if n_cards > 1 else {"4x1": make_mesh(devices=[dev0] * 4)})}
    out = {}
    for n, mesh in meshes.items():
        calls = {
            f"flagship_{n}": lambda m=mesh: sharded_scan(spacers, contig, 1, pam="NGG",
                                                          mesh=m, P=P),
            f"block_max_{n}": lambda m=mesh: sharded_scan_block_max(q, scan, mask, m, L=L,
                                                                     K=K, P=P),
        }
        for name, fn in calls.items():
            steady = walls(fn, reps + 1)[1:]  # the first call builds the shard state
            # one call as the profiler's warm-up step, dropped from the trace:
            # device tracing misses kernels launched right as it starts, and
            # the cached block max launches its kernel first thing. A trace
            # that still holds no device event is taken again.
            for attempt in range(3):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1)) as prof:
                    fn()
                    torch.cuda.synchronize()
                    prof.step()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                split = device_and_host(prof, wall)
                if split["card_busy_ms"]:
                    break
            else:
                raise AssertionError(f"{name}: three traces without a device event")
            prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{name}.json"))
            out[name] = dict(steady_walls_s=steady, profiled_wall_s=wall, **split)
            r = out[name]
            log(f"phase 4 {name} (mesh {n}: cards, or shards x cards): steady walls {steady} "
                f"s; profiled {wall:.6f} s, card busy {r['card_busy_ms']} ms, any card "
                f"{r['any_card_busy_ms']:.4f} ms, device idle share "
                f"{r['device_idle_share']:.4f}, torch ops on the host "
                f"{r['torch_ops_host_ms']:.4f} ms, outside torch "
                f"{r['outside_torch_host_ms']:.4f} ms")
            for d in r["top_device"]:
                log(f"   device {d['ms']:10.4f} ms  x{d['count']:5d}  {d['name']}")
            for h in r["top_host"]:
                log(f"   host   {h['ms']:10.4f} ms  {h['name']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one CUDA card")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile steady requests; traces go to DIR")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only time the wgmma kernels (see kernel_times) and print one "
                         "JSON line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    # site tables of this run only: one left on disk by an earlier run would
    # send request 1 to the site engine
    artifacts = tempfile.TemporaryDirectory(prefix="chip_smoke_artifacts_")
    os.environ["BARCODER_TPU_ARTIFACTS"] = artifacts.name
    if args.kernel_times:
        import barcoder_tpu_torch

        log(card_line())
        log(json.dumps({"package": os.path.dirname(barcoder_tpu_torch.__file__),
                        "kernel_times_ms": kernel_times()}))
        artifacts.cleanup()
        return 0
    from barcoder_tpu_torch.ops import nvcc

    kind = torch.cuda.get_device_name(0)
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    PEAKS.update(card_peaks())
    log(f"bounds at: {json.dumps(PEAKS)}")

    t0 = time.perf_counter()
    libs_built = nvcc.build_libraries()
    build_s = time.perf_counter() - t0
    for name, lib_path in libs_built.items():
        log(f"phase 1: built {os.path.relpath(lib_path)}")
        log(lib_path.with_suffix(".log").read_text().strip())
    log(f"phase 1: built {len(libs_built)} kernels in {build_s:.2f} s")

    k = phase2_kernel_vs_plain()
    k_req = phase2_request_shape()
    k2b = phase2b_max_kernel_vs_plain()
    rec, genome, libs, plants = build_inputs()
    main_path = phase3_main_path(rec, genome, libs, plants)
    vs_plain, cuda_hits = phase3_hits_vs_plain(genome, libs, plants)
    site = phase3b_site_kernel(genome, libs)
    phase3_cli(rec)
    sharded = phase5_sharded(genome, libs, plants, cuda_hits)
    design = phase5b_design(rec, genome)
    experiments = phase6_experiment_kernels()
    entry_points = phase6_entry_points()
    prof = None
    if args.profile:
        prof = {"targets": phase4_profile(genome, libs, args.profile),
                "decisions": phase4_decisions(genome, libs),
                "sharded": phase4_profile_sharded(args.profile)}

    log(json.dumps({"build_s": build_s, "phase2": k, "phase2_request_shape": k_req,
                    "phase2b": k2b, "phase3": main_path,
                    "hits_vs_plain": vs_plain, "phase3b_site": site, "phase5": sharded,
                    "phase5b_design": design, "phase6": experiments,
                    "phase6_entry_points": entry_points, "profile": prof}))
    # launches per path, each path's counts taken from 0 just before it
    by_path = {
        "scan_hits": {"targets_cuda": main_path["launches_dense"],
                      "site": main_path["launches_site"],
                      "design": design["launches"],
                      "sharded": sharded["launches"]["scan_hits"],
                      "harness": sharded["harness_launches"]["scan_hits"],
                      "phase1_bench": entry_points["phase1_bench"]["scan_hits"]},
        "scan_max": {"sharded": sharded["launches"]["scan_max"],
                     "harness": sharded["harness_launches"]["scan_max"],
                     "harness_block_max": sharded["harness_block_max"]["launches"]},
        "colmax_mma": {"int8_bench": entry_points["int8_bench"]["colmax_mma"]},
        "phase1_ablate": {"phase1_ablate": entry_points["phase1_ablate"]["phase1_ablate"]},
        "phase1_epilogue": {"phase1_bench": entry_points["phase1_bench"]["phase1_epilogue"]},
    }

    def kernel(name, source, replaces, err, head, variants=None):
        row = {"name": name, "route": "cuda", "source": f"barcoder_tpu_torch/csrc/{source}",
               "replaces": replaces, "launches": sum(by_path[name].values()),
               "launches_by_path": by_path[name], "max_abs_err": err, "ms": head["ms"],
               "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
               "bound_by": head["bound_by"], "library_ms": head.get("library_ms")}
        if "issued_bound_ms" in head:
            row["issued_bound_ms"] = head["issued_bound_ms"]
        if variants:
            row["variants"] = {v: {key: r.get(key) for key in
                                   ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "issued_bound_ms", "share", "registers") if key in r}
                               for v, r in variants.items()}
        return row

    def worst(cases):
        return max(c["max_abs_err"] for c in cases.values())

    log(json.dumps({"kernels": [
        kernel("scan_hits", "scan_hits.cu", "barcoder_tpu/ops/pallas_scan.py:124",
               max(worst(k), worst(site), k_req["max_abs_err"], design["kernel"]["max_abs_err"]),
               k_req, {**k, "request_shape": k_req, **site, "design_L20": design["kernel"]}),
        kernel("scan_max", "scan_max.cu", "barcoder_tpu/ops/pallas_scan.py:77",
               max(worst(k2b), sharded["block_max_err"],
                   sharded["harness_block_max"]["max_abs_err"]), k2b["L20_additive_SUB1"],
               k2b),
        kernel("colmax_mma", "colmax_mma.cu", "experiments/int8_bench.py:14",
               worst(experiments["colmax_mma"]), experiments["colmax_mma"]["int8"],
               experiments["colmax_mma"]),
        kernel("phase1_ablate", "phase1_mma.cu", "experiments/phase1_ablate.py:45",
               worst(experiments["phase1_ablate"]), experiments["phase1_ablate"]["A"],
               experiments["phase1_ablate"]),
        kernel("phase1_epilogue", "phase1_mma.cu", "experiments/phase1_bench.py:48",
               worst(experiments["phase1_epilogue"]), experiments["phase1_epilogue"]["d"],
               experiments["phase1_epilogue"]),
    ], "peaks": PEAKS}))
    artifacts.cleanup()
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
