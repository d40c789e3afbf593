"""Smoke run of the PyTorch port on one CUDA card: the quickest proof that
``barcoder_tpu_torch`` still builds, launches and answers on the GPU.

    python3 chip_smoke.py                  # from the repository root, one card
    python3 chip_smoke.py --profile DIR    # also profile steady requests

Phases (any failure is a non-zero exit; nothing is caught):

1. build the phase-1 CUDA kernel from ``barcoder_tpu_torch/csrc/`` with
   nvcc for sm_90a;
2. hold the kernel against its plain torch version on the card, bit-equal,
   at the main path's shapes (P = 16384, SUB = 32, BS_M = 512, K = 128, 8
   tiles; L = 20 with 2 folded bias rows, L = 32 additive, L = 20 with 1
   folded row), and time both;
3. drive the targets workload through ``run_targets(backend="cuda")`` on a
   4.6 Mb circular synthetic genome (~4,200 genes, one across the origin):
   a 9,984-spacer 20-nt library plus planted guides (NGG, v = 3), the same
   again (steady state), and a 32-nt library (NGNC, v = 1). Every planted
   guide must come back at 0 mismatches, the kernel must have launched, and
   request 1's Hits must equal the plain ``torch_scan`` on the card; then
   the CLI answers once in a subprocess.

With ``--profile DIR``, a fourth phase times three steady-state runs of
the 20-nt and the 32-nt request, then runs each once under
``torch.profiler``: it prints the phase timings, the device time summed
over the CUDA-side events (kernels and copies), the device busy share
(that sum over the profiled wall) and the largest device events, and
writes each trace to ``DIR/trace_L{20,32}.json``.

Prints the card's name and power limit, one JSON line of kernel results,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_GENOME = 4_600_000
N_GENES = 4200
N_SPACERS = 9_984  # the 20-nt library of request 1
N_SPACERS_32 = 1_024  # the 32-nt library of request 3
N_PLANTED = 48  # planted guides per library
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


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
    return dict(hits=len(got), cuda_scan_s=t1 - t0, torch_scan_s=t2 - t1)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one CUDA card")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile steady requests; traces go to DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    from barcoder_tpu_torch.ops import scan_hits

    kind = torch.cuda.get_device_name(0)
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    t0 = time.perf_counter()
    lib_path = scan_hits.build_library()
    build_s = time.perf_counter() - t0
    log(f"phase 1: built {os.path.relpath(lib_path)} in {build_s:.2f} s")
    log(lib_path.with_suffix(".log").read_text().strip())

    k = phase2_kernel_vs_plain()
    rec, genome, libs, plants = build_inputs()
    main_path = phase3_main_path(rec, genome, libs, plants)
    vs_plain = phase3_hits_vs_plain(genome, libs)
    phase3_cli(rec)
    prof = phase4_profile(genome, libs, args.profile) if args.profile else None

    head = k["L20_fold2"]
    log(json.dumps({"build_s": build_s, "phase2": k, "phase3": main_path,
                    "hits_vs_plain": vs_plain, "profile": prof}))
    log(json.dumps({"kernels": [{
        "name": "scan_hits",
        "route": "cuda",
        "source": "barcoder_tpu_torch/csrc/scan_hits.cu",
        "replaces": "barcoder_tpu/ops/pallas_scan.py:124",
        "launches": main_path["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in k.values()),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
