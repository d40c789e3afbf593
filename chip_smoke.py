"""Smoke run of the PyTorch port on one CUDA card: the quickest proof that
``barcoder_tpu_torch`` still builds, launches and answers on the GPU.

    python3 chip_smoke.py                  # from the repository root, one card
    python3 chip_smoke.py --profile DIR    # also profile steady requests

Phases (any failure is a non-zero exit; nothing is caught):

1. build every CUDA kernel from ``barcoder_tpu_torch/csrc/`` with nvcc for
   sm_90a, one nvcc process per source, started together;
2. hold the phase-1 hit kernel (``scan_hits``) against its plain torch
   version on the card, bit-equal, at the main path's shapes (P = 16384,
   SUB = 32, BS_M = 512, K = 128, 8 tiles; L = 20 with 2 folded bias rows,
   L = 32 additive, L = 20 with 1 folded row), and time both;
2b. the same for the block-max kernel (``scan_max``) at the scaling
   harness's shapes (P = 16384, K = 128, 8 tiles, 80 spacer blocks with
   zero padding rows, the last tile fully masked; L = 20 additive SUB = 1,
   L = 20 folded SUB = 32, L = 32 additive SUB = 1);
3. drive the targets workload through ``run_targets(backend="cuda")`` on a
   4.6 Mb circular synthetic genome (~4,200 genes, one across the origin):
   a 9,984-spacer 20-nt library plus planted guides (NGG, v = 3), the same
   again (steady state), and a 32-nt library (NGNC, v = 1). Every planted
   guide must come back at 0 mismatches, the kernel must have launched, and
   request 1's Hits must equal the plain ``torch_scan`` on the card; then
   the CLI answers once in a subprocess.
5. the sharded path: request 1 through ``run_targets(backend="sharded")``
   (the frame must equal the cuda backend's), then ``sharded_scan`` over
   request 1's library and genome on a 1-shard mesh and on a 4-shard mesh
   of the same card (Hits equal to the cuda backend's, every planted guide
   found) and ``sharded_scan_block_max`` on both meshes (block_max and
   totals equal to its plain version's on the card); both kernels must
   have launched in that run. Steady walls of the cuda backend and the two
   sharded meshes; then the scaling harness
   (``python -m barcoder_tpu_torch.parallel.scaling 4600000 10240 --engine
   both --single-chip``) in a subprocess, its JSON printed on one line:
   every row it timed must have launched its kernel (the harness counts
   launches per row). Last, the harness's block-max workload in this
   process, with the launch count at 0 before it: block_max and totals
   equal to the plain version's, and every spacer scoring L at its own
   genome window.
6. the three experiment kernels (the ports of ``experiments/int8_bench.py``,
   ``phase1_ablate.py`` and ``phase1_bench.py``) at their scripts' full
   shapes: the column max in int8 and bf16 (16 tiles x 40 blocks x 512
   rows x 16,384 columns), every phase-1 ablation (A-D) and epilogue (a-d)
   variant (320 tiles x 40 blocks x 512 rows x 16,384 columns), each held
   bit-equal against its plain version and timed beside it, with its
   registers (ptxas; no kernel may spill) and the popcount ``scan_hits``
   kernel's time on the same inputs; then each entry point
   (``python -m barcoder_tpu_torch.experiments.<name>``) once in this
   process, with the launch counts at 0 before each: each must launch its
   kernel.

The kernels line gives each kernel's launches per path (``launches_by_path``,
each path's count taken from 0 just before it) and their sum.

With ``--profile DIR``, a fourth phase times three steady-state runs of
the 20-nt and the 32-nt request, then runs each once under
``torch.profiler``: it prints the phase timings, the device time summed
over the CUDA-side events (kernels and copies), the device busy share
(that sum over the profiled wall) and the largest device events, and
writes each trace to ``DIR/trace_L{20,32}.json``. It then does the same
for the scaling harness's workload through ``sharded_scan`` and
``sharded_scan_block_max``, on one card and, on a machine with several,
on one shard per card, splitting each profiled call into each card's busy
time, the device idle share and the host's torch ops
(``DIR/trace_{flagship,block_max}_{1,N}.json``).

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


# --- phase 2 -----------------------------------------------------------------

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
        pairs = args[1].shape[0] // kw["BS_M"] * kw["BS_M"] * args[2].shape[0] * kw["P"]
        results[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, hit_columns=float(want.sum()),
            pairs_per_s=pairs / (ms / 1e3), shape=dict(spec, n_tiles=args[2].shape[0]),
        )
        log(f"phase 2 {name}: bit-equal, max_abs_err {err}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, {pairs / (ms / 1e3):.4e} pairs/s")
    return results


# --- phase 2b ----------------------------------------------------------------

def max_kernel_case(rng, *, L, fold, SUB, S_pad=10_240, n_pad=240, n_tiles=8, P=16384,
                    K=128):
    """Block-max inputs at the harness's shapes: genome codes with N (4) and
    the out-of-bounds sentinel (5); spacers cut from the codes with 0-4
    substitutions, the last ``n_pad`` rows zero padding (no constant bias
    column); a random 0/-16384 bias with the last tile fully masked, where
    the folded padding rows' score (0) beats every real row's."""
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
    bias = np.where(rng.random((n_tiles, 1, P)) < 0.1, 0.0, -16384.0).astype(np.float32)
    bias[-1] = -16384.0
    dev = torch.device("cuda")
    args = (torch.from_numpy(q).to(dev, torch.bfloat16), torch.from_numpy(codes).to(dev),
            torch.from_numpy(bias).to(dev))
    return args, dict(L=L, K=K, P=P, SUB=SUB, fold_bias=fold)


def phase2b_max_kernel_vs_plain() -> dict:
    from barcoder_tpu_torch.ops import scan_max

    rng = np.random.default_rng(SEED + 2)
    cases = [
        ("L20_additive_SUB1", dict(L=20, fold=False, SUB=1)),
        ("L20_fold_SUB32", dict(L=20, fold=True, SUB=32)),
        ("L32_additive_SUB1", dict(L=32, fold=False, SUB=1)),
    ]
    results = {}
    for name, spec in cases:
        args, kw = max_kernel_case(rng, **spec)
        got = scan_max.scan_block_max(*args, **kw)
        want = scan_max.scan_block_max_reference(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: block-max kernel disagrees with its plain "
                                 f"version ({int((got != want).sum())} entries)")
        err = float((got - want).abs().max())
        plain_ms = cuda_ms(lambda: scan_max.scan_block_max_reference(*args, **kw))
        ms = cuda_ms(lambda: scan_max.scan_block_max(*args, **kw))
        pairs = args[0].shape[0] // 128 * 128 * args[1].shape[0] * kw["P"]
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             pairs_per_s=pairs / (ms / 1e3), shape=dict(spec, n_tiles=8,
                                                                       S_pad=args[0].shape[0]))
        log(f"phase 2b {name}: bit-equal, max_abs_err {err}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, {pairs / (ms / 1e3):.4e} pairs/s")
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


def build_inputs():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from barcoder_tpu.core.genome import Genome, contig_from_record
    from barcoder_tpu.seqio.library import BarcodeLibrary
    from tests.genomes import make_record, random_seq

    t0 = time.perf_counter()
    rec = make_record(n=N_GENOME, n_genes=N_GENES, wrapped_gene=True, seed=SEED,
                      rec_id="SMOKE0.1")
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
    from barcoder_tpu_torch.ops import scan_hits
    from barcoder_tpu_torch.pipeline.targets import run_targets, write_output

    requests = [
        ("request1_L20_NGG_v3", libs[20], "NGG", 3, plants[20]),
        ("request2_L20_NGG_v3_steady", libs[20], "NGG", 3, plants[20]),
        ("request3_L32_NGNC_v1", libs[32], "NGNC", 1, plants[32]),
    ]
    out = {}
    scan_hits.launches = 0
    for name, lib, pam, v, planted in requests:
        t0 = time.perf_counter()
        result = run_targets(lib, genome, pam, v, backend="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_planted(result, planted, genome.contigs[0].length)
        table = result.table
        if len(table) == 0 or "spacer" not in table.columns:
            raise AssertionError(f"{name}: empty or malformed table")
        sink = open(os.devnull, "w")
        write_output(result, sink)
        sink.close()
        prof = result.stats["profile"]
        out[name] = dict(wall_s=wall, rows=len(table), hits=prof["counters"]["hits"],
                         phases_s=prof["timings_s"])
        log(f"phase 3 {name}: {wall:.4f} s, {len(table)} rows, "
            f"{prof['counters']['hits']} hits, phases {prof['timings_s']}")
    launches = scan_hits.launches
    if launches == 0:
        raise AssertionError("the main path never launched the scan_hits kernel")
    log(f"phase 3: scan_hits kernel launched {launches} times")
    out["launches"] = launches
    return out


def phase3_hits_vs_plain(genome, libs) -> dict:
    """Request 1's Hits from the cuda backend against the plain torch scan,
    both on the card, on the library's unique sequences."""
    from barcoder_tpu_torch.ops.ref_scan import torch_scan
    from barcoder_tpu_torch.ops.scan import scan_contigs

    seqs = list(dict.fromkeys(s for _, s in libs[20].entries))
    contig = genome.contigs[0]
    t0 = time.perf_counter()
    got = scan_contigs(seqs, [contig], 3, "NGG", backend="cuda")[0]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = torch_scan(seqs, contig, 3, "NGG", device="cuda")
    t2 = time.perf_counter()
    for f in ("spacer_idx", "pos", "strand", "mismatches"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"cuda Hits differ from torch_scan in {f}")
    log(f"phase 3: cuda Hits == torch_scan Hits ({len(got)} hits; cuda scan "
        f"{t1 - t0:.4f} s, torch_scan {t2 - t1:.4f} s)")
    return dict(hits=len(got), cuda_scan_s=t1 - t0, torch_scan_s=t2 - t1), got


def phase3_cli(rec) -> None:
    """The CLI (auto backend) in a subprocess on a 200 kb slice."""
    from barcoder_tpu.seqio.genbank import GenBankRecord, write_genbank

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
    sharded_scan and sharded_scan_block_max on 1 and 4 shards of cuda:0."""
    import pandas as pd

    from barcoder_tpu_torch.ops import scan_hits, scan_max
    from barcoder_tpu_torch.ops.cuda_scan import onehot_rows
    from barcoder_tpu_torch.ops.prep import build_scan_array, site_masks, spacer_matrix
    from barcoder_tpu_torch.ops.scan import scan_contigs
    from barcoder_tpu_torch.parallel.mesh import make_mesh
    from barcoder_tpu_torch.parallel.sharded_scan import sharded_scan, sharded_scan_block_max
    from barcoder_tpu_torch.pipeline.targets import run_targets

    seqs = list(dict.fromkeys(s for _, s in libs[20].entries))
    contig = genome.contigs[0]
    dev = torch.device("cuda", 0)
    meshes = {1: make_mesh(devices=[dev]), 4: make_mesh(devices=[dev] * 4)}
    L, K, P = 20, 128, 16384
    q = torch.from_numpy(onehot_rows(spacer_matrix(seqs), K)).to(dev, torch.bfloat16)
    scan = build_scan_array(contig, L).astype(np.int32)
    mask = site_masks(contig, L, "NGG", "downstream")[0].astype(np.int32)

    # the path, with every launch counter at 0 just before it
    scan_hits.launches = 0
    scan_max.launches = 0
    t0 = time.perf_counter()
    result = run_targets(libs[20], genome, "NGG", 3, backend="sharded")
    torch.cuda.synchronize()
    targets_s = time.perf_counter() - t0
    hits, block = {}, {}
    for n, mesh in meshes.items():
        hits[n] = sharded_scan(seqs, contig, 3, "NGG", mesh=mesh, P=P)
        block[n] = sharded_scan_block_max(q, scan, mask, mesh, L=L, K=K, P=P)
    torch.cuda.synchronize()
    launches = {"scan_hits": scan_hits.launches, "scan_max": scan_max.launches}
    log(f"phase 5: launches on the sharded path {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the sharded path never launched the {name} kernel")

    check_planted(result, plants[20], contig.length)
    pd.testing.assert_frame_equal(result.table,
                                  run_targets(libs[20], genome, "NGG", 3, backend="cuda").table)
    index = {s: i for i, s in enumerate(seqs)}
    planted = {(index[g], pos, 0 if strand == "F" else 1, 0) for g, pos, strand, _ in plants[20]}
    out = dict(launches=launches, targets_sharded_s=targets_s, hits=len(cuda_hits))
    max_err = 0.0
    for n in meshes:
        if not same_hits(hits[n], cuda_hits):
            raise AssertionError(f"sharded Hits on {n} shards differ from the cuda backend's")
        got = set(zip(hits[n].spacer_idx.tolist(), hits[n].pos.tolist(),
                      hits[n].strand.tolist(), hits[n].mismatches.tolist()))
        if not planted <= got:
            raise AssertionError(f"planted guides missing on {n} shards: {planted - got}")
        with plain_block_max():
            want_max, want_totals = sharded_scan_block_max(q, scan, mask, meshes[n], L=L, K=K,
                                                           P=P)
        if not (np.array_equal(block[n][0], want_max)
                and np.array_equal(block[n][1], want_totals)):
            raise AssertionError(f"block max on {n} shards differs from its plain version")
        max_err = max(max_err, float(np.abs(block[n][0] - want_max).max()))
        log(f"phase 5: {n} shard(s): Hits == cuda Hits ({len(cuda_hits)}), planted found; "
            f"block_max {block[n][0].shape} and totals == plain")
    out["block_max_err"] = max_err

    contig_list = [contig]
    out["walls_s"] = {
        "cuda": walls(lambda: scan_contigs(seqs, contig_list, 3, "NGG", backend="cuda")),
        **{f"sharded_{n}": walls(lambda m=m: sharded_scan(seqs, contig, 3, "NGG", mesh=m, P=P))
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
         "--engine", "both", "--single-chip"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    if proc.returncode != 0:
        raise AssertionError(f"scaling harness failed:\n{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout)
    out["harness"] = report
    out["harness_s"] = time.perf_counter() - t0
    log(f"phase 5 harness ({out['harness_s']:.2f} s): {json.dumps(report)}")
    if report["flagship"][0]["hits"] != report["single_chip"]["hits"]:
        raise AssertionError("harness: sharded and single-card hit counts differ")
    # each timed row went through its kernel (the harness counts launches)
    for rows, kernel in ((report["flagship"], "scan_hits"), (report["blockmax"], "scan_max"),
                         ([report["single_chip"]], "scan_hits")):
        for row in rows:
            if row["launches"][kernel] == 0:
                raise AssertionError(f"harness row {row} never launched the {kernel} kernel")
    out["harness_launches"] = {
        "scan_hits": sum(r["launches"]["scan_hits"]
                         for r in report["flagship"] + [report["single_chip"]]),
        "scan_max": sum(r["launches"]["scan_max"] for r in report["blockmax"]),
    }
    out["harness_block_max"] = harness_block_max(meshes[1], P)
    return out


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
    log(f"phase 5 harness block max: {got_max.shape} and totals == plain, "
        f"{len(spacers)} spacers score {L} at their windows, {launches} launches")
    return dict(launches=launches, max_abs_err=float(np.abs(got_max - want_max).max()))


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
    log(f"phase 6 {name}: bit-equal, max_abs_err {err}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, {rate:.4e} pairs/s, {registers} registers"
        + "".join(f", {k} {v:.4f}" for k, v in extra.items()))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, pairs_per_s=rate,
                registers=registers, **extra)


def phase6_experiment_kernels() -> dict:
    """The three experiment kernels at their scripts' full shapes, every
    variant held bit-equal against its plain version and timed beside it;
    for the phase-1 variants also beside the popcount scan_hits kernel on
    the same inputs (the scripts' random inputs with planted hits and 30%
    masked columns, so the epilogues count something)."""
    from barcoder_tpu_torch.experiments import (
        int8_bench, int8_inputs, int8_tensors, phase1_ablate, phase1_inputs, phase1_tensors,
        plant_hits,
    )
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
    q8, g8 = int8_inputs(m.N_TILES, m.N_SB, BS_M=m.BS_M, K=m.K, P=m.P, seed=SEED)
    pairs = m.N_TILES * m.N_SB * m.BS_M * m.P
    for mode, dtype in m.DTYPES.items():
        q, g = int8_tensors(q8, g8, dtype, dev)
        od = colmax_mma.OUT_DTYPE[dtype]
        out["colmax_mma"][mode] = _kernel_vs_plain(
            f"colmax_mma {mode}", lambda: colmax_mma.colmax(q, g, od, BS_M=m.BS_M),
            lambda: colmax_mma.colmax_reference(q, g, od, BS_M=m.BS_M), pairs,
            _registers(report["colmax_mma"], "S8" if mode == "int8" else "Bf16"))
    del q, g

    a = phase1_ablate
    thresh, q, tiles, bias = phase1_inputs(a.N_TILES, a.N_SB, L=a.L, K=a.K, P=a.P, BS_M=a.BS_M,
                                           mask_share=0.3, seed=SEED)
    plant_hits(q, tiles, L=a.L, P=a.P, seed=SEED + 1)
    th, q, tiles, bias = phase1_tensors(thresh, q, tiles, bias, dev)
    kw = dict(L=a.L, K=a.K, P=a.P, SUB=a.SUB, BS_M=a.BS_M)
    pairs = a.N_TILES * a.N_SB * a.BS_M * a.P
    popcount = scan_hits.scan_block_hits(th, q, tiles, bias, fold_bias=True, **kw)
    popcount_ms = cuda_ms(lambda: scan_hits.scan_block_hits(th, q, tiles, bias, fold_bias=True,
                                                            **kw))
    log(f"phase 6 scan_hits (popcount) at the same shapes: {popcount_ms:.4f} ms, "
        f"{pairs / (popcount_ms / 1e3):.4e} pairs/s, {int(popcount.sum())} hit columns")
    if popcount.sum() == 0:
        raise AssertionError("phase 6 inputs give no hits")
    g_all = phase1_variants.build_g_all(tiles, bias, L=a.L, K=a.K, P=a.P)
    for v, (source, epi) in phase1_variants.ABLATE.items():
        out["phase1_ablate"][v] = _kernel_vs_plain(
            f"phase1_ablate {v} ({source}, {epi})",
            lambda v=v: phase1_variants.ablate(v, th, q, tiles, bias, g_all, **kw),
            lambda v=v: phase1_variants.ablate_reference(v, th, q, tiles, bias, g_all, **kw),
            pairs, _registers(report["phase1_mma"], "phase1_mma_kernel<"
                              f"{str(source == 'streamed').lower()}, "
                              f"{phase1_variants.EPILOGUE[epi]}>"),
            popcount_ms=popcount_ms)
    if not torch.equal(phase1_variants.ablate("A", th, q, tiles, bias, g_all, **kw), popcount):
        raise AssertionError("phase1_ablate A disagrees with the popcount scan_hits kernel")
    del g_all, popcount
    for v, epi in phase1_variants.BENCH.items():
        out["phase1_epilogue"][v] = _kernel_vs_plain(
            f"phase1_epilogue {v} ({epi})",
            lambda v=v: phase1_variants.bench_full(v, th, q, tiles, bias, **kw),
            lambda v=v: phase1_variants.bench_full_reference(v, th, q, tiles, bias, **kw),
            pairs, _registers(report["phase1_mma"],
                              f"phase1_mma_kernel<false, {phase1_variants.EPILOGUE[epi]}>"),
            popcount_ms=popcount_ms)
    out["scan_hits_popcount_ms"] = popcount_ms
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


# --- phase 4 (--profile) -----------------------------------------------------

def phase4_profile(genome, libs, trace_dir: str, reps: int = 3) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from barcoder_tpu_torch.pipeline.targets import run_targets

    os.makedirs(trace_dir, exist_ok=True)
    out = {}
    for L, pam, v in ((20, "NGG", 3), (32, "NGNC", 1)):
        def request():
            t0 = time.perf_counter()
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
        prof.export_chrome_trace(os.path.join(trace_dir, f"trace_L{L}.json"))
        out[f"L{L}"] = dict(
            steady_walls_s=walls, profiled_wall_s=wall, device_ms=dev_ms,
            busy_share=dev_ms / (wall * 1e3), phases_s=r.stats["profile"]["timings_s"],
            top=[dict(name=k[:110], ms=ms, count=n) for k, ms, n in dev[:12]],
        )
        log(f"phase 4 L={L}: steady walls {walls} s; profiled {wall:.6f} s, "
            f"device {dev_ms:.4f} ms, busy share {dev_ms / (wall * 1e3):.4f}, "
            f"phases {r.stats['profile']['timings_s']}")
        for k, ms, n in dev[:12]:
            log(f"   {ms:10.4f} ms  x{n:5d}  {k[:110]}")
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
    per_card, host = {}, {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            per_card.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
        elif e.cpu_parent is None:
            host[e.name] = host.get(e.name, 0.0) + e.cpu_time_total / 1e3
    any_ms = _union_ms([iv for ivs in per_card.values() for iv in ivs])
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
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
    from torch.profiler import ProfilerActivity, profile

    from barcoder_tpu_torch.parallel.mesh import make_mesh
    from barcoder_tpu_torch.parallel.scaling import _make_workload, blockmax_inputs
    from barcoder_tpu_torch.parallel.sharded_scan import sharded_scan, sharded_scan_block_max

    L, P = 20, 16384
    contig, spacers = _make_workload(N_GENOME, 10240, L)
    q, scan, mask, K = blockmax_inputs(contig, spacers, L, torch.device("cuda", 0))
    n_cards = torch.cuda.device_count()
    meshes = {1: make_mesh(1), **({n_cards: make_mesh()} if n_cards > 1 else {})}
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
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{name}.json"))
            out[name] = dict(steady_walls_s=steady, profiled_wall_s=wall,
                             **device_and_host(prof, wall))
            r = out[name]
            log(f"phase 4 {name} ({n} card(s)): steady walls {steady} s; profiled "
                f"{wall:.6f} s, card busy {r['card_busy_ms']} ms, any card "
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    from barcoder_tpu_torch.ops import nvcc

    kind = torch.cuda.get_device_name(0)
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    t0 = time.perf_counter()
    libs_built = nvcc.build_libraries()
    build_s = time.perf_counter() - t0
    for name, lib_path in libs_built.items():
        log(f"phase 1: built {os.path.relpath(lib_path)}")
        log(lib_path.with_suffix(".log").read_text().strip())
    log(f"phase 1: built {len(libs_built)} kernels in {build_s:.2f} s")

    k = phase2_kernel_vs_plain()
    k2b = phase2b_max_kernel_vs_plain()
    rec, genome, libs, plants = build_inputs()
    main_path = phase3_main_path(rec, genome, libs, plants)
    vs_plain, cuda_hits = phase3_hits_vs_plain(genome, libs)
    phase3_cli(rec)
    sharded = phase5_sharded(genome, libs, plants, cuda_hits)
    experiments = phase6_experiment_kernels()
    entry_points = phase6_entry_points()
    prof = None
    if args.profile:
        prof = {"targets": phase4_profile(genome, libs, args.profile),
                "sharded": phase4_profile_sharded(args.profile)}

    log(json.dumps({"build_s": build_s, "phase2": k, "phase2b": k2b, "phase3": main_path,
                    "hits_vs_plain": vs_plain, "phase5": sharded, "phase6": experiments,
                    "phase6_entry_points": entry_points, "profile": prof}))
    # launches per path, each path's counts taken from 0 just before it
    by_path = {
        "scan_hits": {"targets_cuda": main_path["launches"],
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
               "plain_ms": head["plain_ms"]}
        if variants:
            row["variants"] = {v: {"ms": r["ms"], "plain_ms": r["plain_ms"]}
                               for v, r in variants.items()}
        return row

    def worst(cases):
        return max(c["max_abs_err"] for c in cases.values())

    log(json.dumps({"kernels": [
        kernel("scan_hits", "scan_hits.cu", "barcoder_tpu/ops/pallas_scan.py:124", worst(k),
               k["L20_fold2"]),
        kernel("scan_max", "scan_max.cu", "barcoder_tpu/ops/pallas_scan.py:77",
               max(worst(k2b), sharded["block_max_err"],
                   sharded["harness_block_max"]["max_abs_err"]), k2b["L20_additive_SUB1"]),
        kernel("colmax_mma", "colmax_mma.cu", "experiments/int8_bench.py:14",
               worst(experiments["colmax_mma"]), experiments["colmax_mma"]["int8"],
               experiments["colmax_mma"]),
        kernel("phase1_ablate", "phase1_mma.cu", "experiments/phase1_ablate.py:45",
               worst(experiments["phase1_ablate"]), experiments["phase1_ablate"]["A"],
               experiments["phase1_ablate"]),
        kernel("phase1_epilogue", "phase1_mma.cu", "experiments/phase1_bench.py:48",
               worst(experiments["phase1_epilogue"]), experiments["phase1_epilogue"]["d"],
               experiments["phase1_epilogue"]),
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
