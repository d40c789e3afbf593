"""Multi-shard scaling harness: the port of
``barcoder_tpu/parallel/scaling.py`` (single host).

Times the sharded scan at mesh sizes 1..N and reports throughput and
efficiency against the one-shard run. A mesh of N shards takes N local
devices when there are that many, and otherwise repeats them (several
shards on one card, or on the CPU); the report then sets ``fake_devices``,
because shards that share a device say nothing about scaling, only about
the mechanics.

Engines:
  - ``flagship`` (default): the full ``sharded_scan`` path at its
    defaults — an NGG scan, so the site-compacted engine (the JAX
    harness's too): the hit indicator over each shard's PAM sites, per-shard
    pair compaction and phase 2.
  - ``dense``: the same call with ``site_mode="never"``, the dense engine
    (every genome position on both strands), which all-N and PAM-less
    scans take.
  - ``blockmax``: the previous-generation phase-1-only max-reduce path
    (``sharded_scan_block_max``, the ``scan_max`` kernel), kept for A/B.

``--engine both`` times ``flagship`` and ``blockmax``; ``all`` adds
``dense``. Each row names the engine it ran (``path``: ``site``, ``dense``
or ``block_max``) and the (spacer, position) pairs that engine scores
(``pairs``, ``pairs_per_s``): the site engine scores only the PAM sites,
so its ``spacer_positions_per_s`` (2 x spacers x genome bases over the
seconds, the same workload measure for every engine) is not its work.

Run: ``python -m barcoder_tpu_torch.parallel.scaling [n_bp] [n_spacers]
[--engine flagship|dense|blockmax|both|all] [--single-chip] [--P N]
[--devices 1,2] [--device cpu] [--processes K [--devices-per-process N]
[--workload scan|count] [--real-devices] [--repeats R]]``; prints one JSON
object. The shards go on the cards
unless ``--device cpu`` (or ``devices=`` in :func:`measure_scaling`) asks
for the CPU; without a card and without that, it raises.

``--single-chip`` also times the one-device engine (``ops.cuda_scan``) on
a card, so the sharded-vs-single gap is printed directly. Each timed row
reports ``launches``: how many times each CUDA kernel launched while it
was timed (warm-up calls included), so a row that ran the plain torch
version shows zeros.

Multi-process (:func:`measure_multihost`): ``--processes K`` spawns K
worker processes (``--mh-worker``) joined by ``parallel.multihost`` over a
localhost rendezvous, each driving ``--devices-per-process`` shards (its
cards, repeated; ``--real-devices`` names that default, ``--device cpu``
asks for CPU shards instead), and times the flagship ``sharded_scan`` over
the process-spanning mesh (``--workload scan``) or ``run_count`` with the
sharded engine over chunk ownership (``--workload count``). It checks that
every process returned the same hits or counts, and that the processes'
``owned_reads`` cover the reads once. On one machine the processes share
its cores and cards: the walls measure the mechanics, not cross-host
scaling, and the report's ``note`` says so.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..ops import scan_hits, scan_max
from .mesh import default_tile, local_devices, make_mesh


def _make_workload(n_bp: int, n_spacers: int, L: int):
    from ..core.encode import decode, encode
    from ..core.genome import Contig

    rng = np.random.default_rng(0)
    seq = decode(rng.integers(0, 4, size=n_bp).astype(np.int8))
    contig = Contig(
        id="SCALE0.1", length=n_bp, codes=encode(seq), seq=seq, topology="circular"
    )
    spacers = [seq[p : p + L] for p in range(64, 64 + n_spacers * 11, 11)][:n_spacers]
    return contig, spacers


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _best_of(fn, repeats):
    """Steady-state wall time: 2 warm calls (kernel build and caches), then
    best-of-N, each call ending in a device synchronise."""
    def timed():
        out = fn()
        _synchronize()
        return out

    timed()
    last = timed()
    dt = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        last = timed()
        dt = min(dt, time.perf_counter() - t0)
    return dt, last


def _time_sharded(contig, spacers, mesh, P, repeats, site_mode):
    from .sharded_scan import sharded_scan

    dt, hits = _best_of(
        lambda: sharded_scan(spacers, contig, 1, pam="NGG", mesh=mesh, P=P,
                             site_mode=site_mode),
        repeats,
    )
    return dt, len(hits)


def _pairs(path: str, contig, spacers, L: int) -> int:
    """The (spacer, genome position) pairs ``path`` scores: the NGG sites
    of both strands on the site engine, every position of both strands on
    the dense one, every forward position on the block-max one."""
    if path == "site":
        from .sharded_scan import _site_table_host

        (positions, _, _), _ = _site_table_host(contig, L, "NGG", "downstream")
        return len(spacers) * len(positions)
    return (2 if path == "dense" else 1) * len(spacers) * contig.length


def blockmax_inputs(contig, spacers, L: int, device):
    """The block-max engine's inputs for the harness's workload: (q_oh
    (S_pad, K) bf16 one-hot rows on ``device``, scan codes, an all-allowed
    start mask, K); the two numpy arrays read-only."""
    from ..ops.cuda_scan import onehot_rows
    from ..ops.prep import build_scan_array, spacer_matrix
    from ..ops.scan_hits import BS, _cdiv

    K = max(_cdiv(4 * L, 128) * 128, 128)
    q_f = spacer_matrix(spacers)
    S_pad = max(_cdiv(len(spacers), BS) * BS, BS)
    q_oh = np.zeros((S_pad, K), dtype=np.float32)
    q_oh[: len(spacers)] = onehot_rows(q_f, K)
    q_dev = torch.from_numpy(q_oh).to(device, torch.bfloat16)
    scan = build_scan_array(contig, L).astype(np.int32)
    mask = np.ones(contig.length, dtype=np.int32)
    # frozen: the engine's cache key hashes a read-only array once, not per call
    scan.setflags(write=False)
    mask.setflags(write=False)
    return q_dev, scan, mask, K


def _time_blockmax(contig, spacers, mesh, P, L, repeats):
    from .sharded_scan import sharded_scan_block_max

    q_dev, scan, mask, K = blockmax_inputs(contig, spacers, L, mesh.devices.ravel()[0])
    dt, _ = _best_of(
        lambda: sharded_scan_block_max(q_dev, scan, mask, mesh, L=L, K=K, P=P),
        repeats,
    )
    return dt, None


def _time_single_chip(contig, spacers, repeats):
    """The one-device engine on a card (both strands, full extraction), on
    its site engine, which its steady NGG scans take, as the flagship's do."""
    from ..ops.cuda_scan import cuda_scan

    dt, hits = _best_of(
        lambda: cuda_scan(spacers, contig, 1, pam="NGG", device="cuda", site_mode="always"),
        repeats,
    )
    return dt, len(hits)


def _path(engine: str) -> str:
    """The engine a harness engine runs: the flagship's NGG scan takes the
    site engine by ``sharded_scan``'s own rule."""
    from .sharded_scan import _want_sites

    if engine == "blockmax":
        return "block_max"
    return "site" if engine == "flagship" and _want_sites("NGG", "auto") else "dense"


def _launches() -> dict:
    return {"scan_hits": scan_hits.launches, "phase2_hits": scan_hits.phase2_launches,
            "scan_max": scan_max.launches}


def _launched_since(before: dict) -> dict:
    return {k: n - before[k] for k, n in _launches().items()}


def measure_scaling(
    n_bp: int = 1 << 21,
    n_spacers: int = 1024,
    L: int = 20,
    P: int | None = None,
    repeats: int = 3,
    device_counts=None,
    engine: str = "flagship",
    single_chip: bool = False,
    devices=None,
) -> dict:
    """Time ``engine`` ("flagship", "dense", "blockmax", "both" or "all")
    on meshes of ``device_counts`` shards over ``devices`` (default: the
    cards; a mesh larger than the pool repeats its devices)."""
    pool = local_devices() if devices is None else [torch.device(d) for d in devices]
    platform = pool[0].type
    if device_counts is None:
        device_counts = sorted({1, 2, len(pool)} & set(range(1, len(pool) + 1)))
    meshes = {nd: make_mesh(devices=[pool[i % len(pool)] for i in range(nd)])
              for nd in device_counts}
    if P is None:
        P = default_tile(meshes[device_counts[0]])

    contig, spacers = _make_workload(n_bp, n_spacers, L)
    positions = 2 * len(spacers) * n_bp  # both strands

    fake = platform == "cpu" or any(m.repeats_a_device() for m in meshes.values())
    engines = {"both": ["flagship", "blockmax"],
               "all": ["flagship", "dense", "blockmax"]}.get(engine, [engine])
    if not set(engines) <= {"flagship", "dense", "blockmax"}:
        raise ValueError(f"unknown engine {engine!r}")
    out = {
        "platform": platform,
        "device_kind": torch.cuda.get_device_name(0) if platform == "cuda" else "cpu",
        "genome_bp": n_bp,
        "spacers": len(spacers),
        "fake_devices": fake,
        "note": (
            "shards share a device (the CPU, or several shards of one card) — "
            "efficiency numbers are NOT meaningful, only the mechanics"
            if fake
            else "one card per shard"
        ),
    }
    for eng in engines:
        results = []
        base_rate = None
        path = _path(eng)
        for nd in device_counts:
            mesh = meshes[nd]
            before = _launches()
            if eng == "blockmax":
                dt, n_hits = _time_blockmax(contig, spacers, mesh, P, L, repeats)
            else:
                dt, n_hits = _time_sharded(contig, spacers, mesh, P, repeats,
                                           "never" if path == "dense" else "auto")
            rate = positions / dt
            pairs = _pairs(path, contig, spacers, L)
            if base_rate is None:
                base_rate = rate
            results.append(
                {
                    "devices": nd,
                    "path": path,
                    "seconds": dt,
                    "pairs": pairs,
                    "pairs_per_s": pairs / dt,
                    "spacer_positions_per_s": rate,
                    "per_device_rate": rate / nd,
                    "speedup": rate / base_rate,
                    "efficiency": rate / (base_rate * nd),
                    **({"hits": n_hits} if n_hits is not None else {}),
                    "launches": _launched_since(before),
                }
            )
        out[eng] = results
    if single_chip and platform != "cuda":
        # the one-device engine's kernel runs on a card only; timing its
        # plain CPU version would time the stand-in, not the engine
        out["single_chip"] = {"skipped": "no CUDA device (the kernel has no CPU mode)"}
    elif single_chip:
        before = _launches()
        dt, n_hits = _time_single_chip(contig, spacers, repeats)
        pairs = _pairs("site", contig, spacers, L)
        out["single_chip"] = {
            "path": "site",
            "seconds": dt,
            "pairs": pairs,
            "pairs_per_s": pairs / dt,
            "spacer_positions_per_s": positions / dt,
            "hits": n_hits,
            "launches": _launched_since(before),
        }
        if "flagship" in out:
            one_dev = out["flagship"][0]["per_device_rate"]
            out["sharded_vs_single_chip"] = one_dev / (positions / dt)
    return out


def _make_count_workload(d: str, n_reads: int = 200_000, n_barcodes: int = 2_000):
    """Deterministic counting inputs for the multi-process harness: a FASTQ
    of flank-anchored barcode reads and the barcode FASTA, written under d."""
    import os

    from ..core.encode import decode

    rng = np.random.default_rng(1)
    barcodes = sorted(
        {decode(rng.integers(0, 4, 20).astype(np.int8)) for _ in range(n_barcodes)}
    )
    pre, l_fl, r_fl, tail = "ACGTG", "GGTAGCT", "CTTAAGC", "TCCATGGA"
    fq = os.path.join(d, "count.fastq")
    with open(fq, "w") as fh:
        for i in rng.integers(0, len(barcodes), size=n_reads):
            r = pre + l_fl + barcodes[i] + r_fl + tail
            fh.write(f"@r\n{r}\n+\n{'I' * len(r)}\n")
    bc = os.path.join(d, "barcodes.fasta")
    with open(bc, "w") as fh:
        for i, b in enumerate(barcodes):
            fh.write(f">b{i}\n{b}\n")
    return fq, bc, n_reads


def measure_multihost(
    n_bp: int,
    n_spacers: int,
    n_processes: int,
    devices_per_process: int = 1,
    P: int | None = None,
    repeats: int = 3,
    force_cpu: bool = False,
    workload: str = "scan",
    timeout_s: float = 900.0,
) -> dict:
    """Multi-process mechanics and efficiency: spawn ``n_processes`` worker
    processes joined by ``parallel.multihost`` over a localhost rendezvous,
    time the flagship sharded scan (or the sharded count) over the
    process-spanning mesh in each, and check that every process observed
    the same result. A worker that fails or outlives ``timeout_s`` fails
    the call, and every worker is killed."""
    import os
    import sys
    import tempfile

    from .multihost import free_port, spawn_joined

    if workload not in ("scan", "count"):
        raise ValueError(f"unknown workload {workload!r}")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    d = tempfile.mkdtemp(prefix="scaling_mh_")
    extra: list[str] = ["--devices-per-process", str(devices_per_process),
                        "--repeats", str(repeats)]
    if P is not None:
        extra += ["--P", str(P)]
    if force_cpu:
        extra += ["--device", "cpu"]
    n_reads = None
    if workload == "count":
        fq, bc, n_reads = _make_count_workload(d)
        extra += ["--workload", "count", "--fastq", fq, "--barcodes", bc]
    outs = [os.path.join(d, f"p{pid}.json") for pid in range(n_processes)]
    port = free_port()
    runs = spawn_joined(
        [[sys.executable, "-m", "barcoder_tpu_torch.parallel.scaling", "--mh-worker", str(pid),
          str(n_processes), str(port), outs[pid], str(n_bp), str(n_spacers), *extra]
         for pid in range(n_processes)], [env] * n_processes, repo, timeout_s)
    for pid, (rc, stdout, stderr, _s) in enumerate(runs):
        if rc != 0:
            raise RuntimeError(f"multi-process worker {pid} failed (rc={rc}):"
                               f"\n{(stdout + stderr)[-3000:]}")
    results = []
    for o in outs:
        with open(o) as fh:
            results.append(json.load(fh))
    note = ("the processes share one machine's cores"
            + (" and cards" if not force_cpu else "")
            + ": the walls measure the mechanics, not cross-host scaling")
    common = {
        "workload": workload,
        "processes": n_processes,
        "devices_per_process": devices_per_process,
        "global_devices": results[0]["global_devices"],
        "platform": results[0]["platform"],
        "per_process_seconds": [r["seconds"] for r in results],
        "launches": [r["launches"] for r in results],
    }
    if workload == "count":
        owned = [r["owned_reads"] for r in results]
        return {
            **common,
            "reads": n_reads,
            "reads_per_s": [n_reads / r["seconds"] for r in results],
            "counts_identical": len({r["counts_digest"] for r in results}) == 1,
            # chunk ownership: disjoint per-process parse shares that cover
            # the stream once
            "owned_reads": owned,
            "owned_covers_stream": sum(owned) == n_reads,
            "note": note,
        }
    return {
        **common,
        "genome_bp": n_bp,
        "spacers": n_spacers,
        "hits": results[0]["hits"],
        "hit_sets_identical": len({r["hits_digest"] for r in results}) == 1,
        "note": note,
    }


def _mh_worker(pid, nproc, port, out_path, n_bp, n_spacers, P, repeats, devices_per_process,
               device=None, workload="scan", fastq=None, barcodes=None) -> int:
    """One multi-process worker: join the run, then time the scan over the
    process-spanning mesh (or the sharded count) and write a JSON report."""
    import hashlib

    from . import multihost

    if device == "cpu":
        multihost.initialize(f"localhost:{port}", nproc, pid)
        pool = [torch.device("cpu")]
    else:
        # each process takes its share of the cards, or a card in turn
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        ids = ([c for c in range(n_cards) if c % nproc == pid] or [pid % n_cards]
               if n_cards else None)
        multihost.initialize(f"localhost:{port}", nproc, pid, local_device_ids=ids)
        pool = local_devices()
    devices = [pool[i % len(pool)] for i in range(devices_per_process)]
    before = _launches()
    if workload == "count":
        # run_count over chunk ownership on the shared FASTQ: each
        # run samples and counts again (the production cold path)
        from ..pipeline.heuristic_count import run_count
        from ..seqio.fasta import read_barcode_fasta
        from .sharded_count import make_read_mesh

        bset = read_barcode_fasta(barcodes)
        mesh = make_read_mesh(devices=devices)
        dt, (doc, undoc, total, info) = _best_of(
            lambda: run_count(bset, fastq, engine="sharded", chunk_size=2**14, mesh=mesh),
            repeats)
        report = {"counts_digest": hashlib.blake2b(
                      repr((sorted(doc.items()), sorted(undoc.items()), total)).encode(),
                      digest_size=12).hexdigest(),
                  "owned_reads": info["owned_reads"]}
    else:
        from .sharded_scan import sharded_scan

        contig, spacers = _make_workload(n_bp, n_spacers, 20)
        mesh = make_mesh(devices=devices)
        P = P or default_tile(mesh)
        dt, hits = _best_of(
            lambda: sharded_scan(spacers, contig, 1, pam="NGG", mesh=mesh, P=P), repeats)
        tup = repr(sorted(zip(hits.spacer_idx.tolist(), hits.pos.tolist(),
                              hits.strand.tolist(), hits.mismatches.tolist()))).encode()
        report = {"hits": len(hits),
                  "hits_digest": hashlib.blake2b(tup, digest_size=12).hexdigest()}
    with open(out_path, "w") as fh:
        json.dump({"process": pid, "global_devices": int(mesh.devices.size),
                   "platform": devices[0].type, "seconds": dt,
                   "launches": _launched_since(before), **report}, fh)
    return 0


def _take(args: list, flag: str):
    """Remove ``flag VALUE`` from args and return VALUE (None if absent)."""
    if flag not in args:
        return None
    i = args.index(flag)
    value = args[i + 1]
    del args[i : i + 2]
    return value


def main(argv=None) -> int:
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    engine = _take(args, "--engine") or "flagship"
    P = _take(args, "--P")
    counts = _take(args, "--devices")
    device = _take(args, "--device")
    repeats = int(_take(args, "--repeats") or 3)
    workload = _take(args, "--workload") or "scan"
    fastq, barcodes = _take(args, "--fastq"), _take(args, "--barcodes")
    dpp = int(_take(args, "--devices-per-process") or 1)
    if "--real-devices" in args:  # the cards: the default, named
        if device == "cpu":
            raise SystemExit("--real-devices and --device cpu contradict each other")
        args.remove("--real-devices")
    if "--mh-worker" in args:
        i = args.index("--mh-worker")
        pid, nproc, port, out_path = args[i + 1 : i + 5]
        del args[i : i + 5]
        return _mh_worker(int(pid), int(nproc), port, out_path,
                          int(args[0]) if args else 1 << 21,
                          int(args[1]) if len(args) > 1 else 1024,
                          int(P) if P else None, repeats, dpp, device=device,
                          workload=workload, fastq=fastq, barcodes=barcodes)
    nproc = _take(args, "--processes")
    single = "--single-chip" in args
    if single:
        args.remove("--single-chip")
    n_bp = int(args[0]) if args else 1 << 21
    n_spacers = int(args[1]) if len(args) > 1 else 1024
    if nproc is not None:
        print(json.dumps(measure_multihost(
            n_bp, n_spacers, int(nproc), devices_per_process=dpp, P=int(P) if P else None,
            repeats=repeats, force_cpu=device == "cpu", workload=workload), indent=2))
        return 0
    print(
        json.dumps(
            measure_scaling(
                n_bp=n_bp, n_spacers=n_spacers, engine=engine, single_chip=single,
                P=int(P) if P else None,
                device_counts=[int(x) for x in counts.split(",")] if counts else None,
                devices=[device] if device else None,
            ),
            indent=2,
        )
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
